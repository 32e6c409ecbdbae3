"""The Hopper forward kernel's algorithm and its dispatch, on the CPU.

`attention_fwd_sm90.cu` runs only on the card.  Here a tile-level PyTorch
mirror of its arithmetic (`_tiled_forward`: 128-row q tiles as two 64-row
warpgroups, 64-key tiles, base-2 online softmax, the causal mask only on
tiles that cross the diagonal, P rounded to the input dtype before P·V, lse
converted back to natural log) is held against the port's plain version,
against `ray_tpu.ops.attention._xla_causal_attention`, and against the
splash kernel in Pallas interpret mode.  A fake ctypes library then shows
that `attention_fwd` routes by (dtype, head_dim) alone, counts each launch
on the kernel it reached, declares every pointer `c_void_p`, and raises on
a non-zero return.

Tolerances: float32 1e-5 absolute (outputs and lse are O(1)-O(10); the
mirror sums in tiles and in base 2, the references in one pass in base e,
which moves a few f32 ulps).  bf16: 1e-2 absolute as in
test_torch_attention.py (two bf16 ulps at O(1): P and O are rounded to bf16
at different points) plus 2**-7 relative, one bf16 ulp of the value, for
the outputs above 2 in magnitude, where one ulp is already 0.0156.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _xla_causal_attention
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.tools import profile_train_step

BM, BN, WG = 128, 64, 64  # the kernel's q tile, key tile, warpgroup rows
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _tiled_forward(qs, k, v):
    """The kernel's arithmetic on pre-scaled q: (o [B,S,H,D], lse [B,H,S])."""
    B, S, H, D = qs.shape
    q32, k32, v32 = (t.float().transpose(1, 2) for t in (qs, k, v))  # [B, H, S, D]
    o = torch.zeros(B, H, S, D)
    lse = torch.zeros(B, H, S)
    for row0 in range(0, S, BM):
        n_kv = min(-(-S // BN), (row0 + BM - 1) // BN + 1)
        for wrow0 in (row0, row0 + WG):
            if wrow0 >= S:
                continue
            rows = torch.arange(wrow0, min(wrow0 + WG, S))
            m = torch.full((B, H, len(rows)), -math.inf)
            l = torch.zeros(B, H, len(rows))
            acc = torch.zeros(B, H, len(rows), D)
            for j in range(min(n_kv - 1, (wrow0 + WG - 1) // BN) + 1):
                cols = torch.arange(j * BN, min(j * BN + BN, S))
                s = q32[:, :, rows] @ k32[:, :, cols].transpose(-1, -2)
                if j * BN + BN - 1 > wrow0:  # the tile crosses the diagonal
                    s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
                m_new = torch.maximum(m, s.amax(-1) * LOG2E)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * LOG2E - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(qs.dtype).float() @ v32[:, :, cols]
                m = m_new
            o[:, :, rows] = acc / l[..., None]
            lse[:, :, rows] = (m + torch.log2(l)) * LN2
    return o.transpose(1, 2).to(qs.dtype), lse


def _inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(3)]


def _lse_reference(qs, k):
    S = qs.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.double(), k.double())
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    return torch.logsumexp(scores.masked_fill(~causal, -math.inf), dim=-1).float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(1024, 64), (1000, 64), (100, 64), (1024, 128)])
def test_tiled_mirror_matches_plain_and_jax(S, D, dtype):
    B, H = 1, 2
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    atol, rtol = (1e-5, 0) if dtype == "float32" else (1e-2, 2**-7)
    q, k, v = _inputs(B, S, H, D, seed=S + D)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    qs = qt * torch.tensor(D**-0.5, dtype=tdt)  # splash's convention: q pre-scaled in its dtype
    o, lse = _tiled_forward(qs, kt, vt)
    plain = port.plain_causal_attention(qs, kt, vt, 1.0)
    jax_out = _xla_causal_attention(*(jnp.asarray(np.asarray(t.float()), jdt) for t in (qs, kt, vt)), 1.0)
    np.testing.assert_allclose(o.float().numpy(), plain.float().numpy(), rtol=rtol, atol=atol, err_msg="vs plain")
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jax_out, np.float32), rtol=rtol, atol=atol,
                               err_msg="vs jax")
    np.testing.assert_allclose(lse.numpy(), _lse_reference(qs, kt).numpy(), rtol=0, atol=1e-5, err_msg="lse")


def test_tiled_mirror_matches_interpret_mode_splash():
    """Splash's forward with its residuals, run as test_torch_attention.py
    runs it (interpret mode, BlockSizes at 128, vmapped over batch)."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
        splash_attention_mask as smask,
    )

    B, S, H, D = 2, 256, 2, 64
    mask = smask.MultiHeadMask([smask.CausalMask((S, S)) for _ in range(H)])
    bs = sk.BlockSizes(
        block_q=128, block_kv=128, block_kv_compute=128, block_q_dkv=128, block_kv_dkv=128,
        block_kv_dkv_compute=128, use_fused_bwd_kernel=True,
        k_layout=sk.QKVLayout.SEQ_MINOR, v_layout=sk.QKVLayout.SEQ_MINOR,
    )
    kernel = sk.make_splash_mha(mask, block_sizes=bs, head_shards=1, q_seq_shards=1, save_residuals=True,
                                interpret=True)
    q, k, v = _inputs(B, S, H, D, seed=7)
    qs = q * np.float32(D**-0.5)
    out, (lse,) = jax.vmap(kernel)(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (qs, k, v)))
    o_t, lse_t = _tiled_forward(*(torch.from_numpy(a) for a in (qs, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(out).transpose(0, 2, 1, 3), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ dispatch


class _FakeLib:
    """Stands in for a built library: records each entry point's call and
    returns `ret`; takes argtypes/restype like a ctypes function."""

    def __init__(self, ret=0):
        self.calls, self.ret, self.fns = [], ret, {}

    def __getattr__(self, entry):
        if not entry.startswith("rtt_"):
            raise AttributeError(entry)
        if entry not in self.fns:
            lib = self

            def fn(*args):
                lib.calls.append((entry, args))
                return b"fake failure" if entry == "rtt_error_string" else lib.ret

            self.fns[entry] = fn
        return self.fns[entry]


@pytest.fixture
def fake_libs(monkeypatch):
    libs = {name: _FakeLib() for name in port._ENTRY_POINTS}
    monkeypatch.setattr(port, "_kernels", lambda name="causal_attention": libs[name])
    monkeypatch.setattr(port, "_stream", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(port, "LAUNCHES", dict.fromkeys(port.LAUNCHES, 0))
    return libs


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
                                     (torch.float32, 128)])
def test_forward_routes_by_dtype_and_head_dim(fake_libs, dtype, D):
    q = torch.zeros(2, 16, 3, D, dtype=dtype)
    o, lse = port.attention_fwd(q, q, q)
    route = port._FWD_ROUTES[(dtype, D)]
    assert route == ("sm90" if (dtype, D) == (torch.bfloat16, 64) else "wmma")
    name, entry, counter = port._FWD_KERNELS[route]
    (called, args), = [c for lib in fake_libs.values() for c in lib.calls]
    assert called == entry and fake_libs[name].calls
    assert args[:2] == (port._KERNEL_DTYPES[dtype], D) and args[7:10] == (2, 3, 16)  # dtype, D; B, H, S
    assert port.LAUNCHES == {**dict.fromkeys(port.LAUNCHES, 0), "causal_attention_fwd": 1, counter: 1}
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (2, 3, 16) and lse.dtype == torch.float32


def test_nonzero_return_raises_and_counts_nothing(fake_libs):
    fake_libs["attention_fwd_sm90"].ret = 700
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="causal_attention_fwd_sm90 kernel launch failed: fake failure"):
        port.attention_fwd(q, q, q)
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(port._ENTRY_POINTS))
def test_entry_points_declare_pointers_void_p(monkeypatch, name):
    class Fn:  # a ctypes function's settable attributes
        argtypes = restype = None

    lib = type("Lib", (), {e: Fn() for e in [*port._ENTRY_POINTS[name], "rtt_error_string"]})()
    monkeypatch.setattr(_build, "load", lambda n: lib)
    port._kernels.__wrapped__(name)
    for entry in port._ENTRY_POINTS[name]:
        fn = getattr(lib, entry)
        assert fn.restype is ctypes.c_int
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)) for t in fn.argtypes)
    fwd = [e for e in port._ENTRY_POINTS[name] if e.startswith("rtt_attn_fwd") and "occupancy" not in e]
    for entry in fwd:  # dtype, D, then q, k, v, o, lse pointers ... stream pointer last
        types = getattr(lib, entry).argtypes
        assert types[2:7] == [ctypes.c_void_p] * 5 and types[-1] is ctypes.c_void_p


def test_profiler_groups_both_forward_kernels():
    assert profile_train_step.group_of("attn_fwd_sm90_kernel(CUtensorMap_st, ...)").endswith("sm90)")
    assert profile_train_step.group_of("void attn_fwd_kernel<__nv_bfloat16, 128, 4>(...)").endswith("wmma)")
