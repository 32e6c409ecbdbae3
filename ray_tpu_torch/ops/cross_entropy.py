"""Fused linear-head cross entropy: the [B, S, V] logits are never held whole.

Port of `ray_tpu/ops/cross_entropy.py` as a plain-PyTorch
`torch.autograd.Function`.  The forward walks the sequence in chunks, turning
each [B, C, V] f32 logits block into logsumexp and label logit at once; the
backward recomputes each block, accumulates dW in f32, and casts dx and dW
back to the input types.  The chunk rule (`_num_chunks`) is the JAX op's.

It is no TPU kernel: XLA compiled the JAX version.  GPT2Model.loss selects it
("auto") only when the f32 logits would exceed 4 GiB.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _num_chunks(seq: int, chunk: int) -> Tuple[int, int]:
    """(number of chunks, adjusted chunk length): the chunk length is
    shrunk to the largest power of two <= `chunk` that divides `seq`."""
    if seq % chunk != 0:
        for c in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
            if c <= chunk and seq % c == 0:
                chunk = c
                break
    return seq // chunk, chunk


def _block_logits(x_c: torch.Tensor, w32: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """[B, C, E] block -> [B, C, V] f32 logits, padded vocab masked to -1e30.
    Inputs are upcast first, so bf16 products are exact and sums f32, as
    with the JAX op's preferred_element_type=float32."""
    logits = x_c.float() @ w32.T
    if valid_vocab < w32.shape[0]:
        pad = torch.arange(w32.shape[0], device=w32.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, valid_vocab: int, chunk: int):
        B, S, _ = x.shape
        n, chunk = _num_chunks(S, chunk)
        w32 = w.float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            logits = _block_logits(x[:, sl], w32, valid_vocab)
            lse = torch.logsumexp(logits, dim=-1)
            label = logits.gather(-1, targets[:, sl, None])[..., 0]
            total = total + (lse - label).sum()
        ctx.save_for_backward(x, w, targets)
        ctx.valid_vocab, ctx.chunk = valid_vocab, chunk
        return total / (B * S)

    @staticmethod
    def backward(ctx, g):
        x, w, targets = ctx.saved_tensors
        B, S, E = x.shape
        V = w.shape[0]
        n, chunk = _num_chunks(S, ctx.chunk)
        scale = g / (B * S)
        w32 = w.float()
        dw = torch.zeros((V, E), dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            x_c = x[:, sl]
            probs = torch.softmax(_block_logits(x_c, w32, ctx.valid_vocab), dim=-1)
            dlogits = probs.scatter_add(
                -1, targets[:, sl, None], torch.full_like(probs[..., :1], -1.0)
            )
            # cast once for the two matmuls; dW still accumulates in f32
            dlogits = (dlogits * scale).to(x.dtype)
            dx[:, sl] = dlogits @ w
            dw += torch.einsum("bcv,bce->ve", dlogits.float(), x_c.float())
        return dx, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(
    x: torch.Tensor,  # [B, S, E] activations
    w: torch.Tensor,  # [V, E] tied embedding / head weight
    targets: torch.Tensor,  # [B, S] int64
    valid_vocab: int,
    chunk: int = 128,
) -> torch.Tensor:
    """Mean next-token CE over all B*S tokens, f32 scalar."""
    return _FusedLinearCrossEntropy.apply(x, w, targets, valid_vocab, chunk)
