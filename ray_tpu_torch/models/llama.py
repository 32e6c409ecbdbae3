"""Llama family in PyTorch: the port of `ray_tpu/models/llama.py`.

RMSNorm + RoPE + SwiGLU + grouped-query attention, with the JAX model's
configuration fields and presets and its numerics: RMSNorm in f32, RoPE on
interleaved even/odd pairs with f32 angles cast back, weights cast to
`compute_dtype` at each use, the padded vocab tail masked in the loss.

The parameters keep the JAX layout: matmul weights as `x @ W` ([in, out])
and the layers stacked on a leading [n_layers] axis, so
`models/convert.py` moves a JAX parameter pytree into `LlamaModel` leaf by
leaf.  Training and a whole-prompt forward (`apply`, `loss`) attend through
`ops.attention.causal_attention`, which launches the hand-written CUDA
kernels on the card (head dim 128: `attention_fwd_sm90_d128.cu` and its
backward).  The decode path (`decode_step`) attends with a masked f32
softmax over the contiguous KV cache, as the JAX model does: no TPU kernel
computes it there.

The paged programs of the continuous-batching engine (`init_pages`,
`decode_step_paged`, `prefill_chunk_paged`) keep the JAX model's page-table
contract: one pool pair [L, num_pages, page_size, KV, D], tables of
physical page ids with -1 for an unallocated page, attention over each
slot's gathered context with a -1e30 mask (`valid_ctx`).  The pool is
written in place.  The small integer inputs (tables, tokens, positions,
flags) arrive as host arrays, as the engine builds them; the write and
gather indices are derived from them on the host, so that rows to drop
(inactive slots, unallocated pages, a chunk's padding) are left out
before anything reaches the device, and cross in one copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.ops.attention import causal_attention


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # "auto" | "splash" | "flash": the CUDA kernels on the card; "xla": the
    # plain version.  On the CPU every name runs the plain version.  Only
    # apply and loss attend through it; decode_step attends over the cache.
    attention_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        return cls(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, hidden_dim=13824, **kw)

    @classmethod
    def llama_3b(cls, **kw) -> "LlamaConfig":
        """~3.3B llama-family config (head_dim 128)."""
        return cls(dim=3072, n_layers=26, n_heads=24, n_kv_heads=24, hidden_dim=8192, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 64)
        return cls(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128, **kw)

    def num_params(self) -> int:
        E, L, H = self.dim, self.n_layers, self.hidden_dim
        kv_dim = self.n_kv_heads * self.head_dim
        per_layer = 2 * E * E + 2 * E * kv_dim + 3 * E * H + 2 * E
        return int(self.padded_vocab * E * 2 + L * per_layer + E)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32; the result stays f32 (callers cast).

    The mean of squares is a mean of 64 means (each division by a power
    of two is exact), so the dim must be a multiple of 64.  With one long
    reduction a row, the rounding depended on how many rows the call held:
    in bf16 a sequence decoded alone (`generate` at B=1) and beside others
    (B=8, or the engine's slots and prefill chunks) drifted apart within
    5-20 tokens on the H100.  With two short ones the engine's tokens and
    generate's at B=1 and B=8 were equal there."""
    x32 = x.float()
    ms = (x32 * x32).unflatten(-1, (64, -1)).mean(-1).mean(-1, keepdim=True)
    return x32 * torch.rsqrt(ms + eps) * scale


def _rope_tables(positions: torch.Tensor, d: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the f32 rotation angles, [..., seq, 1, d/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x: [..., seq, heads, head_dim]; even/odd pairs rotate, in f32
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE as the JAX model's `_rope`: x [..., seq, heads, head_dim]."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


_LAYER_SHAPES = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class LlamaModel(nn.Module):
    """Llama with its parameters on `device` (CUDA by default), drawn from
    `seed` with the JAX model's shapes and stds: N(0, 0.02), the residual
    projections N(0, 0.02/sqrt(2L)), unit norm scales.  The draws differ
    from JAX's; tests load JAX weights through `models/convert.py`.

    Parameters: `tok_emb` [V, E], `out_head` [E, V], `final_norm` [E] and
    `layers.<name>` stacked [L, ...], names as in the JAX pytree."""

    def __init__(self, config: LlamaConfig, *, device: Device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        E, L, V, H = cfg.dim, cfg.n_layers, cfg.padded_vocab, cfg.hidden_dim
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        self.config = cfg

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, device=dev, dtype=cfg.param_dtype))

        self.tok_emb = empty(V, E)
        self.out_head = empty(E, V)
        self.final_norm = empty(E)
        shapes = {
            "attn_norm": (L, E), "ffn_norm": (L, E), "wq": (L, E, E), "wk": (L, E, kv_dim),
            "wv": (L, E, kv_dim), "wo": (L, E, E), "w_gate": (L, E, H), "w_up": (L, E, H), "w_down": (L, H, E),
        }
        self.layers = nn.ParameterDict({name: empty(*shapes[name]) for name in _LAYER_SHAPES})
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Fresh weights from a `torch.Generator` seeded `seed`, drawn in
        the JAX model's order (tok_emb, out_head, wq, wk, wv, wo, w_gate,
        w_up, w_down) straight in `param_dtype`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        std = 0.02
        proj_std = std / math.sqrt(2 * self.config.n_layers)
        self.tok_emb.normal_(0.0, std, generator=gen)
        self.out_head.normal_(0.0, std, generator=gen)
        self.final_norm.fill_(1.0)
        lay = self.layers
        lay["attn_norm"].fill_(1.0)
        lay["ffn_norm"].fill_(1.0)
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            lay[name].normal_(0.0, proj_std if name in ("wo", "w_down") else std, generator=gen)

    def _layer_params(self, li: int) -> Dict[str, torch.Tensor]:
        return {name: p[li] for name, p in self.layers.items()}

    # ------------------------------------------------------------- forward

    def _layer(self, x, lp, rope, kv_cache=None, cache_index=None, future=None):
        """One block.  x [B, S, E]; rope (cos, sin) for these positions.
        With `kv_cache` = (ck_all, cv_all, li) the step's K/V are written
        in place into layer li of the full [L, B, max_seq, KV, D] cache at
        `cache_index`, and attention runs over the cache with the cache
        positions where `future` is set masked out; without it, causal
        attention over x itself."""
        cfg = self.config
        cd = cfg.compute_dtype
        B, S, E = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        h = _rms_norm(x, lp["attn_norm"].float(), cfg.norm_eps).to(cd)
        q = (h @ lp["wq"].to(cd)).reshape(B, S, H, D)
        k = (h @ lp["wk"].to(cd)).reshape(B, S, KV, D)
        v = (h @ lp["wv"].to(cd)).reshape(B, S, KV, D)
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)

        if kv_cache is not None:
            # decode: one token-sized in-place write per layer into the
            # preallocated cache (no copy of the cache, per layer or per
            # step), then attention over this layer's whole cache slice
            ck_all, cv_all, li = kv_cache
            ck_all[li, :, cache_index:cache_index + S] = k
            cv_all[li, :, cache_index:cache_index + S] = v
            k, v = ck_all[li], cv_all[li]

        # grouped-query: repeat kv heads up to H
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        if kv_cache is None:
            attn = causal_attention(q, k, v, impl=cfg.attention_impl).reshape(B, S, E)
        else:
            # scores in the compute dtype, then f32 (JAX: einsum in cd,
            # .astype(f32)); f32 softmax; probabilities back to cd
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (D**-0.5)
            scores = scores.masked_fill(future, -1e30)
            probs = torch.softmax(scores, dim=-1).to(cd)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, E)
        x = x + attn @ lp["wo"].to(cd)

        h = _rms_norm(x, lp["ffn_norm"].float(), cfg.norm_eps).to(cd)
        gate = F.silu(h @ lp["w_gate"].to(cd))
        up = h @ lp["w_up"].to(cd)
        return x + (gate * up) @ lp["w_down"].to(cd)

    def _block(self, li: int, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        return self._layer(x, self._layer_params(li), (cos, sin))

    def forward(self, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """Train/prefill forward: tokens [B, S] -> logits [B, S,
        padded_vocab] in compute_dtype.  Each layer is recomputed in the
        backward (torch.utils.checkpoint) when `remat` is set."""
        if mesh is not None:
            raise NotImplementedError("meshes (fsdp/tp) are a later slice of the port (ROADMAP: multi-GPU)")
        cfg = self.config
        cd = cfg.compute_dtype
        S = tokens.shape[1]
        x = F.embedding(tokens, self.tok_emb.to(cd))
        cos, sin = _rope_tables(torch.arange(S, device=tokens.device), cfg.head_dim, cfg.rope_theta)
        for li in range(cfg.n_layers):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._block, li, x, cos, sin, use_reentrant=False)
            else:
                x = self._block(li, x, cos, sin)
        x = _rms_norm(x, self.final_norm.float(), cfg.norm_eps).to(cd)
        return x @ self.out_head.to(cd)

    # the JAX model's name for the logits; it shadows nn.Module.apply(fn),
    # which nothing in the port calls on this model
    apply = forward

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
        """Mean next-token cross entropy in f32; padded-vocab tail masked."""
        cfg = self.config
        logits = self.forward(tokens, mesh).float()
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    # -------------------------------------------------------------- decode

    def init_cache(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-layer fixed-shape KV cache: a [L, B, max_seq, KV, D] pair in
        compute_dtype, zeroed."""
        cfg = self.config
        shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
        return (
            torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
        )

    def decode_step(self, cache, tokens: torch.Tensor, position: int):
        """One token per sequence: tokens [B, 1], `position` the cache index
        it is written at.  Returns (logits [B, padded_vocab], cache); the
        cache is updated in place, one token-sized write per layer."""
        cfg = self.config
        cd = cfg.compute_dtype
        position = int(position)
        x = F.embedding(tokens, self.tok_emb.to(cd))  # [B, 1, E]
        dev = tokens.device
        # built on the device (torch.full, arange): a host tensor copied in
        # would synchronise the stream at every step
        rope = _rope_tables(torch.full((1,), position, device=dev), cfg.head_dim, cfg.rope_theta)
        future = torch.arange(cfg.max_seq_len, device=dev) > position  # the JAX mask's complement
        ck_all, cv_all = cache
        for li in range(cfg.n_layers):
            x = self._layer(x, self._layer_params(li), rope, (ck_all, cv_all, li), position, future)
        x = _rms_norm(x, self.final_norm.float(), cfg.norm_eps).to(cd)
        return (x @ self.out_head.to(cd))[:, 0, :], cache

    # -------------------------------------------------- paged decode (engine)

    def init_pages(self, num_pages: int, page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical KV page pool shared by every engine slot: a
        [L, num_pages, page_size, KV, D] pair in compute_dtype, zeroed."""
        cfg = self.config
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return (
            torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
        )

    def _paged_write(self, buf: torch.Tensor, li: int, write, vals: torch.Tensor) -> None:
        """Write the kept rows of `vals` [N, KV, D] into layer li of the
        pool, in place.  `write` = (rows, page, offset): the rows to keep
        and their targets; the others (the reference's out-of-range rows,
        dropped by its scatter) never reach the pool."""
        rows, wpage, woff = write
        buf[li, wpage, woff] = vals[rows].to(buf.dtype)

    def _paged_context(self, buf: torch.Tensor, li: int, gpage: torch.Tensor, goff: torch.Tensor) -> torch.Tensor:
        """A slot's logical context [*, T, KV, D] gathered from layer li
        (indices clipped into the pool; rows past a slot's context are
        masked by valid_ctx)."""
        return buf[li, gpage, goff]

    def _paged_attend(self, q, keys, vals, valid_ctx):
        """Masked attention over gathered paged context: q [B, S, H, D];
        keys/vals [B, T, KV, D]; valid_ctx [B, S, T] bool."""
        cfg = self.config
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if KV != H:
            keys = keys.repeat_interleave(H // KV, dim=2)
            vals = vals.repeat_interleave(H // KV, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, keys).float() * (D**-0.5)
        scores = scores.masked_fill(~valid_ctx[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.compute_dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vals)

    def _paged_layer(self, x, lp, li, rope, pages, write, gpage, goff, valid_ctx):
        """One block over the paged KV: write this step's K/V into the
        pool, gather each slot's logical context, attend.  x [B, S, E]
        (decode: B = slots, S = 1; prefill chunk: B = 1, S = chunk)."""
        cfg = self.config
        cd = cfg.compute_dtype
        B, S, E = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kp, vp = pages

        h = _rms_norm(x, lp["attn_norm"].float(), cfg.norm_eps).to(cd)
        q = (h @ lp["wq"].to(cd)).reshape(B, S, H, D)
        k = (h @ lp["wk"].to(cd)).reshape(B, S, KV, D)
        v = (h @ lp["wv"].to(cd)).reshape(B, S, KV, D)
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)

        self._paged_write(kp, li, write, k.reshape(-1, KV, D))
        self._paged_write(vp, li, write, v.reshape(-1, KV, D))
        keys = self._paged_context(kp, li, gpage, goff)
        vals = self._paged_context(vp, li, gpage, goff)
        if keys.dim() == 3:  # single-slot prefill: add the batch dim
            keys, vals = keys[None], vals[None]
        attn = self._paged_attend(q, keys, vals, valid_ctx).reshape(B, S, E)
        x = x + attn @ lp["wo"].to(cd)

        h = _rms_norm(x, lp["ffn_norm"].float(), cfg.norm_eps).to(cd)
        gate = F.silu(h @ lp["w_gate"].to(cd))
        up = h @ lp["w_up"].to(cd)
        return x + (gate * up) @ lp["w_down"].to(cd)

    def _sample_greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """argmax with the vocab padding masked to -inf (a padded id must
        never enter a sequence)."""
        cfg = self.config
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -torch.inf)
        return logits.argmax(-1)

    def _paged_run(self, pages, tokens, positions, write, gpage, goff, valid_ctx) -> torch.Tensor:
        """Embed, run every layer over the pool, final norm: [B, S, E]."""
        cfg = self.config
        cd = cfg.compute_dtype
        x = F.embedding(tokens, self.tok_emb).to(cd)
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for li in range(cfg.n_layers):
            x = self._paged_layer(x, self._layer_params(li), li, rope, pages, write, gpage, goff, valid_ctx)
        return _rms_norm(x, self.final_norm.float(), cfg.norm_eps).to(cd)

    @torch.no_grad()
    def decode_step_paged(self, pages, tables, tokens, positions, active, page_size: int):
        """One engine iteration: decode one token for every active slot.

        pages: (k_pages, v_pages) [L, NP, PS, KV, D] on the model's device,
        written in place; host arrays: tables [S, MP] (physical page per
        logical page, -1 unallocated), tokens [S] (the token each slot
        feeds), positions [S] (the cache index it is written at), active
        [S] bool.  Returns (the next tokens [S] on the device, greedy with
        the vocab padding masked, and the pool)."""
        tables = np.asarray(tables, np.int64)
        positions = np.asarray(positions, np.int64)
        active = np.asarray(active, bool)
        S, MP = tables.shape
        NP = pages[0].shape[1]
        T = MP * page_size
        # write target: one pool row per slot; inactive slots and table
        # misses are left out
        wpage = tables[np.arange(S), np.clip(positions // page_size, 0, MP - 1)]
        rows = np.flatnonzero(active & (wpage >= 0))
        # gather map: logical context index j -> (physical page, offset)
        j = np.arange(T)
        gpage = tables[:, j // page_size]
        valid_ctx = (gpage >= 0) & (j[None, :] <= positions[:, None]) & active[:, None]
        tok, pos, rows, wp, wo, gp, go, valid = _to_device(
            self.device, tokens, positions, rows, wpage[rows], positions[rows] % page_size,
            np.clip(gpage, 0, NP - 1), np.broadcast_to(j % page_size, (S, T)), valid_ctx[:, None, :],
        )
        x = self._paged_run(pages, tok[:, None], pos[:, None], (rows, wp, wo), gp, go, valid.bool())
        logits = (x @ self.out_head.to(self.config.compute_dtype))[:, 0, :]
        return self._sample_greedy(logits), pages

    @torch.no_grad()
    def prefill_chunk_paged(self, pages, table_row, tokens, start_pos, n_valid, page_size: int):
        """One chunk of one slot's prompt: write positions start_pos ..
        start_pos + n_valid - 1 into the pool and return the greedy next
        token after the chunk's last valid position (the request's first
        generated token on its final chunk), a device scalar, and the pool.

        Host arrays: tokens [C] (a tail chunk padded; the padding masked by
        n_valid), table_row [MP]; start_pos, n_valid ints.  C is fixed, so
        a prompt of any length runs as ceil(P / C) calls of one shape."""
        table_row = np.asarray(table_row, np.int64)
        C = len(tokens)
        (MP,) = table_row.shape
        NP = pages[0].shape[1]
        T = MP * page_size
        start_pos, n_valid = int(start_pos), int(n_valid)

        pos = start_pos + np.arange(C)
        valid_q = np.arange(C) < n_valid
        wpage = table_row[np.clip(pos // page_size, 0, MP - 1)]
        rows = np.flatnonzero(valid_q & (wpage >= 0))
        j = np.arange(T)
        gpage = table_row[j // page_size]
        # causal over the slot's logical context, chunk included (K/V land
        # in the pool before the gather)
        valid_ctx = (gpage[None, :] >= 0) & (j[None, :] <= pos[:, None]) & valid_q[:, None]
        tok, posd, rows, wp, wo, gp, go, valid = _to_device(
            self.device, tokens, pos, rows, wpage[rows], pos[rows] % page_size,
            np.clip(gpage, 0, NP - 1), j % page_size, valid_ctx[None],
        )
        x = self._paged_run(pages, tok[None], posd[None], (rows, wp, wo), gp, go, valid.bool())
        last = min(max(n_valid - 1, 0), C - 1)
        logits = x[0, last] @ self.out_head.to(self.config.compute_dtype)
        return self._sample_greedy(logits), pages


def _to_device(device: torch.device, *arrays) -> Tuple[torch.Tensor, ...]:
    """Host integer (or bool) arrays as int64 tensors on `device`, in one
    copy: concatenated, sent, split and reshaped."""
    arrays = [np.asarray(a) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.astype(np.int64).ravel() for a in arrays]))
    flat = flat.to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        out.append(flat[at : at + a.size].view(a.shape))
        at += a.size
    return tuple(out)
