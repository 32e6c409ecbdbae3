"""The float32 Hopper kernels' algorithm, on the CPU.

`attention_fwd_sm90_f32.cu` and `attention_bwd_sm90_f32.cu` (route
"sm90_f32") run only on the card.  Here a tile-level PyTorch mirror of their
arithmetic is held against the port's plain version, against
`ray_tpu.ops.attention._xla_causal_attention` (forward and `jax.vjp`), and
against splash's forward and fused backward in Pallas interpret mode, at
head dims 64 and 128 and at a ragged S:

- every product in 3xTF32 (`_mm3`): each f32 operand split into hi, rounded
  to TF32 (10 mantissa bits, nearest, ties away: cvt.rna.tf32.f32), and lo =
  x - hi, read by the tensor core as its top 19 bits (`_tf32_trunc`);
  lo*hi + hi*lo + hi*hi summed in f32;
- the forward: 64-key tiles, base-2 online softmax, O += P V with P in f32;
- the backward: one key tile per CTA (128 keys at D=64, 64 at D=128), 64-row
  q tiles at and below its diagonal, P recomputed in base 2 from lse, dS = P
  (dP - di), dk and dv summed over the q tiles, and dq summed in f32 over the
  key tiles in ascending order, the kernel's fixed order.

Tolerances: 5e-5 absolute plus 1e-5 relative.  3xTF32 drops lo*lo and
lo's last 13 bits, about 2**-21 (5e-7) of each product.  dq reaches 15 in
magnitude at D=128 (hence the relative part); and where dS = dP - di
cancels (row 0, P = 1: exactly 0, as splash returns it) dq keeps 3xTF32's
rounding of dP (|dP| ~ 10), which measured 3.1e-5 absolute at D=128.  The
float32 references alone agree to 2e-5 (test_torch_attention_bwd_sm90.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _xla_causal_attention
from ray_tpu_torch.ops import attention as port

BN_FWD, BM_BWD = 64, 64  # the forward's key tile, the backward's q tile
KEY_TILE_BWD = {64: 128, 128: 64}  # the backward's keys a CTA at each head dim
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
ATOL, RTOL = 5e-5, 1e-5


def _tf32_round(x):
    """cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from 0."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32, accumulated in f32."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tiled_forward(qs, k, v):
    """The forward kernel's arithmetic on pre-scaled f32 q: (o [B,S,H,D],
    lse [B,H,S]).  Its warps stop at their last unmasked tile; a tile wholly
    masked for a row leaves that row's max, sum and O as they were, so the
    mirror runs every tile for every row."""
    B, S, H, D = qs.shape
    q, kk, vv = (t.transpose(1, 2) for t in (qs, k, v))  # [B, H, S, D]
    rows = torch.arange(S)
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    for col0 in range(0, S, BN_FWD):
        cols = torch.arange(col0, min(col0 + BN_FWD, S))
        s = _mm3(q, kk[:, :, cols].transpose(-1, -2)).masked_fill(cols[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * LOG2E)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * LOG2E - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm3(p, vv[:, :, cols])
        m = m_new
    return (acc / l[..., None]).transpose(1, 2), (m + torch.log2(l)) * LN2


def _tiled_backward(qs, k, v, o, lse, do):
    """The backward kernel's arithmetic on pre-scaled f32 q: (dq, dk, dv)."""
    B, S, H, D = qs.shape
    BN = KEY_TILE_BWD[D]
    q, kk, vv, dout = (t.transpose(1, 2) for t in (qs, k, v, do))  # [B, H, S, D]
    di = torch.einsum("bshd,bshd->bhs", do, o)  # the preprocess kernel
    dq = torch.zeros(B, H, S, D)
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    for col0 in range(0, S, BN):  # one CTA; ascending: dq's fixed order
        keys = torch.arange(col0, min(col0 + BN, S))
        acc_dk = torch.zeros(B, H, len(keys), D)
        acc_dv = torch.zeros(B, H, len(keys), D)
        for row0 in range(col0 - col0 % BM_BWD, S, BM_BWD):
            rows = torch.arange(row0, min(row0 + BM_BWD, S))
            s_t = _mm3(kk[:, :, keys], q[:, :, rows].transpose(-1, -2))  # S^T: [keys, q rows]
            p_t = torch.exp2(s_t * LOG2E - (lse[:, :, rows] * LOG2E)[:, :, None, :])
            p_t = p_t.masked_fill(keys[:, None] > rows[None, :], 0.0)
            dp_t = _mm3(vv[:, :, keys], dout[:, :, rows].transpose(-1, -2))
            ds_t = p_t * (dp_t - di[:, :, None, rows])
            acc_dv += _mm3(p_t, dout[:, :, rows])
            acc_dk += _mm3(ds_t, q[:, :, rows])
            dq[:, :, rows] += _mm3(ds_t.transpose(-1, -2), kk[:, :, keys])
        dk[:, :, keys] = acc_dk
        dv[:, :, keys] = acc_dv
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def _inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(4))
    return q * np.float32(D**-0.5), k, v, do  # splash's convention: q pre-scaled


def _mirror(qs, k, v, do):
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (qs, k, v, do))
    o, lse = _tiled_forward(qt, kt, vt)
    return o, lse, _tiled_backward(qt, kt, vt, o, lse, dot)


def _close(name, got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("S,D", [(256, 64), (200, 64), (256, 128), (136, 128)],
                         ids=["256", "200", "256-d128", "136-d128"])
def test_f32_mirror_matches_plain_and_jax(S, D):
    qs, k, v, do = _inputs(1, S, 2, D, seed=S + D)
    o, lse, grads = _mirror(qs, k, v, do)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qs, k, v)]
    plain = port.plain_causal_attention(*leaves, 1.0)
    plain_grads = torch.autograd.grad(plain, leaves, torch.from_numpy(do))
    jax_out, vjp = jax.vjp(lambda q, k, v: _xla_causal_attention(q, k, v, 1.0), *(jnp.asarray(a) for a in (qs, k, v)))
    scores = torch.einsum("bqhd,bkhd->bhqk", *(torch.from_numpy(a).double() for a in (qs, k)))
    lse_ref = torch.logsumexp(scores.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf), dim=-1)
    _close("out vs plain", o, plain.detach())
    _close("out vs jax", o, jax_out)
    _close("lse", lse, lse_ref.float())
    for name, g, p, j in zip(("dq", "dk", "dv"), grads, plain_grads, vjp(jnp.asarray(do))):
        _close(f"{name} vs plain", g, p)
        _close(f"{name} vs jax", g, j)


@pytest.mark.parametrize("D", [64, 128])
def test_f32_mirror_matches_interpret_mode_splash(D):
    """Splash's forward (with lse) and fused backward, run as
    test_torch_attention.py runs them: interpret mode, BlockSizes at 128,
    vmapped over batch, on the same pre-scaled q."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
        splash_attention_mask as smask,
    )

    B, S, H = 1, 256, 2
    mask = smask.MultiHeadMask([smask.CausalMask((S, S)) for _ in range(H)])
    bs = sk.BlockSizes(
        block_q=128, block_kv=128, block_kv_compute=128, block_q_dkv=128, block_kv_dkv=128,
        block_kv_dkv_compute=128, use_fused_bwd_kernel=True,
        k_layout=sk.QKVLayout.SEQ_MINOR, v_layout=sk.QKVLayout.SEQ_MINOR,
    )
    make = lambda res: sk.make_splash_mha(mask, block_sizes=bs, head_shards=1, q_seq_shards=1,  # noqa: E731
                                          save_residuals=res, interpret=True)
    fwd, kernel = make(True), make(False)
    qs, k, v, do = _inputs(B, S, H, D, seed=D)
    heads = lambda *ts: [jnp.asarray(t).transpose(0, 2, 1, 3) for t in ts]  # noqa: E731  [B,S,H,D] -> [B,H,S,D]
    out, (lse,) = jax.vmap(fwd)(*heads(qs, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jax.vmap(kernel)(q, k, v), *heads(qs, k, v))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(*heads(do))]
    o, lse_t, grads = _mirror(qs, k, v, do)
    _close("out", o, np.asarray(out).transpose(0, 2, 1, 3))
    _close("lse", lse_t, lse)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(name, g, w)


def test_f32_split_is_exact_and_drops_little():
    """hi + lo is x exactly; 3xTF32 is within 2**-20 relative of the f64
    product, where one pass of TF32 is not (the reason for the split)."""
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32)) for _ in range(2))
    hi = _tf32_round(a)
    assert torch.equal(hi + (a - hi), a)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max().item()
    err3 = (_mm3(a, b).double() - exact).abs().max().item() / scale
    err1 = (_tf32_round(a) @ _tf32_round(b) - exact).abs().max().item() / scale
    assert err3 < 2**-20 < err1, (err3, err1)
