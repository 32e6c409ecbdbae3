"""GPT-2 family in PyTorch: the port of `ray_tpu/models/gpt2.py`.

Same configuration fields and presets as the JAX model, and the same
numerics: master weights in f32 cast to `compute_dtype` at each use,
LayerNorm in f32 (eps 1e-5), tanh-approximate GELU (jax.nn.gelu's default),
a head tied to `wte`, and the padded vocab tail masked to -1e30 in the loss.
Attention goes through `ops.attention.causal_attention`, which launches the
hand-written CUDA kernels on the card.

Where the JAX model stacks layers and scans over them, this one keeps a
`ModuleList` of blocks; `models/convert.py` maps between the two layouts.
Ring attention, pipeline meshes and MoE layers belong to later slices of the
port and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dropout: float = 0.0  # benchmarks run dropout-free; no dropout is applied
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # "full" | "dots" | "lite" as in the JAX model; all three recompute the
    # whole block in this port (selective policies are later work)
    remat_policy: str = "dots"
    # "auto" | "splash" | "flash": the CUDA kernels on the card; "xla": the
    # plain version.  On the CPU every name runs the plain version.
    attention_impl: str = "auto"
    # what the plain version's QK^T writes (f32 or bf16); the kernels ignore it
    attn_scores_dtype: Any = torch.float32
    use_ring_attention: bool = False
    # "auto" | "fused" | "naive"; auto takes naive while the f32 logits fit
    # in 4 GiB, as the JAX model does
    loss_impl: str = "auto"
    # sequence-chunk length of the fused loss; 0 = the JAX model's auto rule
    loss_chunk: int = 0
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)  # 50257 -> 50304

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def gpt2_124m(cls, **kw) -> "GPT2Config":
        return cls(n_layer=12, n_head=12, n_embd=768, **kw)

    @classmethod
    def gpt2_350m(cls, **kw) -> "GPT2Config":
        return cls(n_layer=24, n_head=16, n_embd=1024, **kw)

    @classmethod
    def gpt2_774m(cls, **kw) -> "GPT2Config":
        return cls(n_layer=36, n_head=20, n_embd=1280, **kw)

    @classmethod
    def gpt2_1p5b(cls, **kw) -> "GPT2Config":
        return cls(n_layer=48, n_head=25, n_embd=1600, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """CPU-testable toy."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("block_size", 64)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 2)
        kw.setdefault("n_embd", 64)
        return cls(**kw)

    def num_params(self) -> int:
        V, L, E = self.padded_vocab, self.n_layer, self.n_embd
        per_layer = 12 * E * E + 13 * E  # qkv+proj+mlp(4x) + biases + 2 ln
        return V * E + self.block_size * E + L * per_layer + 2 * E

    def flops_per_token(self) -> float:
        """Training FLOPs/token = 6N + 12*L*E*S (PaLM appendix / nanoGPT
        convention), N counting the tied wte once."""
        attn = 12 * self.n_layer * self.n_embd * self.block_size
        return 6.0 * self.num_params() + attn


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, cd: torch.dtype) -> torch.Tensor:
    """LayerNorm in f32 on f32 master weights, cast to the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, 1e-5).to(cd)


def _linear(x: torch.Tensor, lin: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(cd), lin.bias.to(cd))


class GPT2Block(nn.Module):
    """LN -> QKV -> causal attention -> projection, LN -> GELU MLP; both
    residual.  Linear weights are in nn.Linear's [out, in] layout."""

    def __init__(self, config: GPT2Config, device: torch.device):
        super().__init__()
        E, pd = config.n_embd, config.param_dtype
        self.config = config
        self.ln1 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=pd)
        self.qkv = nn.Linear(E, 3 * E, device=device, dtype=pd)
        self.proj = nn.Linear(E, E, device=device, dtype=pd)
        self.ln2 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=pd)
        self.mlp_in = nn.Linear(E, 4 * E, device=device, dtype=pd)
        self.mlp_out = nn.Linear(4 * E, E, device=device, dtype=pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        cd = cfg.compute_dtype
        B, S, E = x.shape
        H, D = cfg.n_head, cfg.head_dim
        h = _layer_norm(x, self.ln1, cd)
        q, k, v = _linear(h, self.qkv, cd).split(E, dim=-1)
        attn = causal_attention(
            q.reshape(B, S, H, D),
            k.reshape(B, S, H, D),
            v.reshape(B, S, H, D),
            impl=cfg.attention_impl,
            scores_dtype=cfg.attn_scores_dtype,
        )
        x = x + _linear(attn.reshape(B, S, E), self.proj, cd)
        h = _layer_norm(x, self.ln2, cd)
        h = F.gelu(_linear(h, self.mlp_in, cd), approximate="tanh")
        return x + _linear(h, self.mlp_out, cd)


class GPT2Model(nn.Module):
    """GPT-2 with f32 master weights on `device` (CUDA by default),
    initialised from `seed` as the JAX model is: N(0, 0.02), the residual
    projections N(0, 0.02/sqrt(2L)), zero biases, unit LayerNorm scales.
    The draws differ from JAX's; tests load JAX weights through
    `models/convert.py` instead."""

    def __init__(self, config: GPT2Config, *, device: Device = "cuda", seed: int = 0):
        super().__init__()
        if config.use_ring_attention:
            raise NotImplementedError("ring attention (sequence parallelism) is a later slice of the port")
        if config.moe_experts:
            raise NotImplementedError("MoE layers are a later slice of the port")
        dev = resolve_device(device)
        E, V, S, pd = config.n_embd, config.padded_vocab, config.block_size, config.param_dtype
        self.config = config
        self.wte = nn.Parameter(torch.empty(V, E, device=dev, dtype=pd))
        self.wpe = nn.Parameter(torch.empty(S, E, device=dev, dtype=pd))
        self.blocks = nn.ModuleList(GPT2Block(config, dev) for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(E, eps=1e-5, device=dev, dtype=pd)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.wte.device).manual_seed(seed)
        std = 0.02
        proj_std = std / math.sqrt(2 * self.config.n_layer)
        self.wte.normal_(0.0, std, generator=gen)
        self.wpe.normal_(0.0, std, generator=gen)
        for blk in self.blocks:
            for ln in (blk.ln1, blk.ln2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
            for lin, s in ((blk.qkv, std), (blk.proj, proj_std), (blk.mlp_in, std), (blk.mlp_out, proj_std)):
                lin.weight.normal_(0.0, s, generator=gen)
                lin.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    @staticmethod
    def _no_mesh(mesh) -> None:
        if mesh is not None:
            raise NotImplementedError("meshes (dp/fsdp/tp/pp/sp) are a later slice of the port")

    def _embed(self, tokens: torch.Tensor, wte_cd: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        return F.embedding(tokens, wte_cd) + self.wpe[:S].to(self.config.compute_dtype)[None]

    def _backbone(self, tokens: torch.Tensor, wte_cd: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self._embed(tokens, wte_cd)
        for blk in self.blocks:
            if cfg.remat:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return _layer_norm(x, self.ln_f, cfg.compute_dtype)

    def backbone(self, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """tokens [B, S] int64 -> final hidden states [B, S, E] in
        compute_dtype (post final layernorm, pre lm-head)."""
        self._no_mesh(mesh)
        return self._backbone(tokens, self.wte.to(self.config.compute_dtype))

    def forward(self, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, padded_vocab] in compute_dtype."""
        self._no_mesh(mesh)
        wte_cd = self.wte.to(self.config.compute_dtype)
        return self._backbone(tokens, wte_cd) @ wte_cd.T

    # the JAX model's name for the logits; it shadows nn.Module.apply(fn),
    # which nothing in the port calls on this model
    apply = forward

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
        """Mean next-token cross entropy; padded-vocab tail masked out.
        "auto" takes the naive full-logits loss while its f32 logits fit in
        4 GiB and the chunked fused loss beyond, as the JAX model does."""
        self._no_mesh(mesh)
        cfg = self.config
        impl = cfg.loss_impl
        B, S = tokens.shape
        if impl == "auto":
            impl = "naive" if B * S * cfg.padded_vocab * 4 <= (4 << 30) else "fused"
        wte_cd = self.wte.to(cfg.compute_dtype)
        x = self._backbone(tokens, wte_cd)
        if impl == "fused":
            chunk = cfg.loss_chunk or max(128, min(512, 8192 // max(1, B)))
            return fused_linear_cross_entropy(x, wte_cd, targets, cfg.vocab_size, chunk)
        if impl != "naive":
            raise ValueError(f"loss_impl must be auto, fused or naive; got {cfg.loss_impl!r}")
        logits = (x @ wte_cd.T).float()
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return F.cross_entropy(logits.reshape(B * S, -1), targets.reshape(B * S))
