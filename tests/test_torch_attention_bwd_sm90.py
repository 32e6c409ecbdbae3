"""The Hopper backward kernels' algorithm and their dispatch, on the CPU.

`attention_bwd_sm90.cu` (head dim 64) and `attention_bwd_sm90_d128.cu`
(head dim 128) run only on the card.  Here a tile-level PyTorch mirror of
their arithmetic (`_tiled_backward`: one key tile per CTA, of 64 keys at
D=64 and of 128 at D=128 split over two warpgroups of 64 keys; 64-row q
tiles at and below the diagonal, a warpgroup skipping a q tile wholly above
its keys; P recomputed in base 2 from lse, with S^T and dP^T summed over the
64-column halves of the head dim in turn at D=128; the causal mask only on
each warpgroup's diagonal tile, dS = P (dP - di), P and dS rounded to the
input dtype before their products, dk and dv summed per key tile, dq summed
in f32 over key tiles, one product over the CTA's keys each) is held against
the port's plain autograd, against `jax.vjp` of
`ray_tpu.ops.attention._xla_causal_attention`, and against splash's fused
backward in Pallas interpret mode at both head dims.  A fake ctypes library
then shows that `attention_bwd` routes by (dtype, head_dim) alone, counts
each launch on the kernel it reached, hands the sm90 kernels an f32 dq
accumulator of whole 64-row tiles, declares every pointer `c_void_p`, and
raises on a non-zero return.

Tolerances: float32 2e-5 absolute, as the gradients in
test_torch_attention.py (the mirror sums in tiles and in base 2, the
references in one pass in base e; gradients are O(1)).  bf16: the mirror,
plain torch and JAX each round P, dP or dS to bf16 at other points, and dq
reaches 16 in magnitude (a bf16 ulp of 0.125), so two bf16 versions differ
by more than the forward's 1e-2 + 2**-7 relative; each is held instead
against the float32 reference, by the rule chip_smoke.py holds the kernel
to (FlashAttention's): the mirror's max |error| at most twice the bf16
reference's, plus 1e-3.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _xla_causal_attention
from ray_tpu_torch.ops import _build
from test_torch_attention_sm90 import _scores, fake_libs  # noqa: F401  (fake_libs: the fake-library fixture)
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.tools import profile_train_step

BM = WG = 64  # the kernels' q tile and the keys of one warpgroup
KEY_TILE = {64: 64, 128: 128}  # the keys of one CTA at each head dim
LOG2E = 1.4426950408889634


def _forward_residuals(qs, k, v):
    """(o in the input dtype, lse [B,H,S] f32) of the causal forward on
    pre-scaled q, as the forward kernels return them."""
    S = qs.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.double(), k.double())
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    lse = torch.logsumexp(scores.masked_fill(~causal, -torch.inf), dim=-1).float()
    return port.plain_causal_attention(qs, k, v, 1.0), lse


def _tiled_backward(qs, k, v, o, lse, do):
    """The kernel's arithmetic on pre-scaled q: (dq, dk, dv) [B,S,H,D] in
    q's dtype."""
    B, S, H, D = qs.shape
    BN = KEY_TILE[D]
    q32, k32, v32, do32 = (t.float().transpose(1, 2) for t in (qs, k, v, do))  # [B, H, S, D]
    di = torch.einsum("bshd,bshd->bhs", do.float(), o.float())  # the preprocess kernel
    dq = torch.zeros(B, H, S, D)
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    for col0 in range(0, S, BN):  # one CTA
        groups = [torch.arange(k0, min(k0 + WG, S)) for k0 in range(col0, min(col0 + BN, S), WG)]
        acc_dk = [torch.zeros(B, H, len(keys), D) for keys in groups]
        acc_dv = [torch.zeros(B, H, len(keys), D) for keys in groups]
        for j, row0 in enumerate(range(col0, S, BM)):
            rows = torch.arange(row0, min(row0 + BM, S))
            ds_cta = []
            for w, keys in enumerate(groups):  # one consumer warpgroup
                if j < w:  # the q tile lies wholly above these keys: dS^T = 0
                    ds_cta.append(torch.zeros(B, H, len(keys), len(rows)))
                    continue
                s_t = _scores(k32[:, :, keys], q32[:, :, rows])  # S^T: [keys, q rows]
                p_t = torch.exp2(s_t * LOG2E - (lse[:, :, rows] * LOG2E)[:, :, None, :])
                if j == w:  # this warpgroup's diagonal tile
                    p_t = p_t.masked_fill(keys[:, None] > rows[None, :], 0.0)
                dp_t = _scores(v32[:, :, keys], do32[:, :, rows])
                ds_t = p_t * (dp_t - di[:, :, None, rows])
                p_r, ds_r = (t.to(qs.dtype).float() for t in (p_t, ds_t))
                acc_dv[w] += p_r @ do32[:, :, rows]
                acc_dk[w] += ds_r @ q32[:, :, rows]
                ds_cta.append(ds_r)
            # dQ = dS K over all the CTA's keys in one product
            cta_keys = torch.cat(groups)
            dq[:, :, rows] += torch.cat(ds_cta, dim=2).transpose(-1, -2) @ k32[:, :, cta_keys]
        for keys, gk, gv in zip(groups, acc_dk, acc_dv):
            dk[:, :, keys] = gk
            dv[:, :, keys] = gv
    return tuple(t.transpose(1, 2).to(qs.dtype) for t in (dq, dk, dv))


def _inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(4)]


def _reference_grads(qs, k, v, do, dtype):
    """(dq, dk, dv) of the port's plain version and of `jax.vjp` of
    `_xla_causal_attention`, both computed in `dtype` from the same values."""
    leaves = [t.detach().to(dtype, copy=True).requires_grad_() for t in (qs, k, v)]
    plain = torch.autograd.grad(port.plain_causal_attention(*leaves, 1.0), leaves, do.to(dtype))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(np.asarray(t.float()), jdt) for t in (qs, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: _xla_causal_attention(q, k, v, 1.0), jq, jk, jv)
    return [g.float() for g in plain], [torch.from_numpy(np.array(g, np.float32)) for g in vjp(jdo)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(1024, 64), (1000, 64), (100, 64), (1024, 128), (1000, 128), (100, 128)],
                         ids=["1024", "1000", "100", "1024-d128", "1000-d128", "100-d128"])
def test_tiled_mirror_matches_plain_and_jax(S, D, dtype):
    B, H = 1, 2
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, k, v, do = _inputs(B, S, H, D, seed=S + (D != 64))
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    qs = qt * torch.tensor(D**-0.5, dtype=tdt)  # splash's convention: q pre-scaled in its dtype
    got = [g.float() for g in _tiled_backward(qs, kt, vt, *_forward_residuals(qs, kt, vt), dot)]
    plain, jax_grads = _reference_grads(qs, kt, vt, dot, tdt)
    if tdt == torch.float32:
        for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jax_grads):
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=2e-5, err_msg=f"{name} vs plain")
            np.testing.assert_allclose(g.numpy(), j.numpy(), rtol=0, atol=2e-5, err_msg=f"{name} vs jax")
        return
    # bf16: each version's max |error| against the float32 reference on the
    # same bf16 values; the mirror's may be at most twice plain torch's and
    # JAX's in bf16, plus 1e-3 (chip_smoke.py's rule for the kernel)
    ref, _ = _reference_grads(qs, kt, vt, dot, torch.float32)
    for name, g, p, j, r in zip(("dq", "dk", "dv"), got, plain, jax_grads, ref):
        err, err_p, err_j = ((x - r).abs().max().item() for x in (g, p, j))
        assert err <= 2 * err_p + 1e-3, f"{name}: mirror {err:.3e}, plain bf16 {err_p:.3e}"
        assert err <= 2 * err_j + 1e-3, f"{name}: mirror {err:.3e}, jax bf16 {err_j:.3e}"


def _splash_backward_check(B, S, H, D, seed):
    """Splash's fused backward (dq, dk, dv from `_splash_attention_bwd_dkv`
    with use_fused_bwd_kernel=True), run as test_torch_attention.py runs it:
    interpret mode, BlockSizes at 128, vmapped over batch, on pre-scaled q,
    against the mirror."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
        splash_attention_mask as smask,
    )

    mask = smask.MultiHeadMask([smask.CausalMask((S, S)) for _ in range(H)])
    bs = sk.BlockSizes(
        block_q=128, block_kv=128, block_kv_compute=128, block_q_dkv=128, block_kv_dkv=128,
        block_kv_dkv_compute=128, use_fused_bwd_kernel=True,
        k_layout=sk.QKVLayout.SEQ_MINOR, v_layout=sk.QKVLayout.SEQ_MINOR,
    )
    kernel = sk.make_splash_mha(mask, block_sizes=bs, head_shards=1, q_seq_shards=1, interpret=True)
    q, k, v, do = _inputs(B, S, H, D, seed=seed)
    qs = q * np.float32(D**-0.5)

    def splash(q, k, v):  # [B, S, H, D] in and out, as the port's layout
        out = jax.vmap(kernel)(*(t.transpose(0, 2, 1, 3) for t in (q, k, v)))
        return out.transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(splash, *(jnp.asarray(a) for a in (qs, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (qs, k, v, do))
    got = _tiled_backward(qt, kt, vt, *_forward_residuals(qt, kt, vt), dot)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5, err_msg=name)


def test_tiled_mirror_matches_interpret_mode_splash():
    _splash_backward_check(2, 256, 2, 64, seed=11)


@pytest.mark.parametrize("S", [1024, 256])
def test_tiled_mirror_d128_matches_interpret_mode_splash(S):
    """At Llama's head dim: 128-key CTAs over two warpgroups, scores summed
    over the two 64-column halves.  Splash takes S only in multiples of its
    128-row blocks, so the ragged lengths are held against the plain and
    XLA versions alone."""
    _splash_backward_check(1, S, 2, 128, seed=S + 1)


# ------------------------------------------------------------------ dispatch


def _bwd_args(dtype, B=2, S=16, H=3, D=64):
    q = torch.zeros(B, S, H, D, dtype=dtype)
    return q, q, q, q, torch.zeros(B, H, S), q


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
                                     (torch.float32, 128)])
def test_backward_routes_by_dtype_and_head_dim(fake_libs, dtype, D):
    dq, dk, dv = port.attention_bwd(*_bwd_args(dtype, D=D))
    route = port._BWD_ROUTES[(dtype, D)]
    assert route == {(torch.bfloat16, 64): "sm90", (torch.bfloat16, 128): "sm90_d128"}.get((dtype, D), "sm90_f32")
    name, entry, counter = port._BWD_KERNELS[route]
    (called, args), = [c for lib in fake_libs.values() for c in lib.calls]
    assert called == entry and fake_libs[name].calls
    assert args[:2] == (port._KERNEL_DTYPES[dtype], D) and args[-5:-2] == (2, 3, 16)  # dtype, D; B, H, S
    assert port.LAUNCHES == {**dict.fromkeys(port.LAUNCHES, 0), "causal_attention_bwd": 1, counter: 1}
    for g in (dq, dk, dv):
        assert g.shape == (2, 16, 3, D) and g.dtype == dtype


@pytest.mark.parametrize("S,D", [(100, 64), (128, 64), (100, 128), (128, 128)],
                         ids=["100", "128", "100-d128", "128-d128"])
def test_sm90_backward_gets_whole_tile_dq_accumulator(fake_libs, monkeypatch, S, D):
    """The sm90 entry points are handed di [B,H,S] and an f32 dq accumulator
    [B, H, S rounded up to 64, D], so every 64-row tile is one contiguous
    block (16 KB at D=64, 32 KB at D=128) for the kernels' bulk
    reduce-adds."""
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(port.torch, "empty", recording_empty)
    port.attention_bwd(*_bwd_args(torch.bfloat16, B=2, S=S, H=3, D=D))
    (_, args), = fake_libs[port._BWD_KERNELS[port._BWD_ROUTES[(torch.bfloat16, D)]][0]].calls
    by_ptr = {t.data_ptr(): t for t in made}
    di, dq_acc = by_ptr[args[8]], by_ptr[args[9]]
    assert di.shape == (2, 3, S) and di.dtype == torch.float32
    assert dq_acc.shape == (2, 3, -(-S // 64) * 64, D) and dq_acc.dtype == torch.float32
    assert dq_acc.is_contiguous() and port.BWD_SM90_TILE == BM


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("S", [100, 128])
def test_sm90_backwards_get_one_semaphore_per_q_tile(fake_libs, monkeypatch, dtype, D, S):
    """Every routed backward is handed an int32 semaphore buffer of
    B * H * ceil(S / 64), one per (batch, head, 64-row q tile), which its
    entry point zeroes beside dq's f32 sum and its kernel uses to add dq in
    the order of the key tiles; the float32 one adds into dq itself and is
    handed no accumulator."""
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(port.torch, "empty", recording_empty)
    B, H = 2, 3
    dq, _, _ = port.attention_bwd(*_bwd_args(dtype, B=B, S=S, H=H, D=D))
    (_, args), = fake_libs[port._BWD_KERNELS[port._BWD_ROUTES[(dtype, D)]][0]].calls
    by_ptr = {t.data_ptr(): t for t in made}
    pointers = [by_ptr.get(a) for a in args[2:-5]]  # q .. dv
    sems = [t for t in pointers if t is not None and t.dtype == torch.int32]
    assert len(sems) == 1 and sems[0].shape == (B, H, -(-S // 64)) and sems[0].is_contiguous()
    sem_at = 2 + next(i for i, t in enumerate(pointers) if t is sems[0])
    if dtype == torch.float32:
        assert sem_at == 9 and by_ptr[args[sem_at + 1]] is dq  # ..., di, sem, dq, dk, dv
    else:
        assert sem_at == 10 and by_ptr[args[9]].shape == (B, H, -(-S // 64) * 64, D)  # ..., di, dq_acc, sem, dq


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_nonzero_return_raises_and_counts_nothing(fake_libs, dtype):
    name, _, counter = port._BWD_KERNELS[port._BWD_ROUTES[(dtype, 64)]]
    fake_libs[name].ret = 700
    with pytest.raises(RuntimeError, match=f"{counter} kernel launch failed: fake failure"):
        port.attention_bwd(*_bwd_args(dtype))
    assert not any(port.LAUNCHES.values())


def test_sm90_backward_entry_points_declare_pointers_void_p(monkeypatch):
    class Fn:  # a ctypes function's settable attributes
        argtypes = restype = None

    for name, entry in (("attention_bwd_sm90", "rtt_attn_bwd_sm90"), ("attention_bwd_sm90_d128", "rtt_attn_bwd_sm90_d128")):
        entries = port._ENTRY_POINTS[name]
        lib = type("Lib", (), {e: Fn() for e in [*entries, "rtt_error_string"]})()
        monkeypatch.setattr(_build, "load", lambda n: lib)
        port._kernels.__wrapped__(name)
        types = getattr(lib, entry).argtypes
        # dtype, D; q, k, v, o, do, lse, di, dq_acc, sem, dq, dk, dv; B, H, S; strides; stream
        assert types[:2] == [ctypes.c_int] * 2 and types[2:14] == [ctypes.c_void_p] * 12
        assert types[14:17] == [ctypes.c_int] * 3 and types[-1] is ctypes.c_void_p
        assert getattr(lib, f"{entry}_occupancy").argtypes == [ctypes.c_void_p] * 2
        assert getattr(lib, entry).restype is ctypes.c_int
    # float32: no dq accumulator (dq is its own f32 sum); the occupancy query takes the head dim
    lib = type("Lib", (), {e: Fn() for e in [*port._ENTRY_POINTS["attention_bwd_sm90_f32"], "rtt_error_string"]})()
    monkeypatch.setattr(_build, "load", lambda n: lib)
    port._kernels.__wrapped__("attention_bwd_sm90_f32")
    types = lib.rtt_attn_bwd_sm90_f32.argtypes
    assert types[:2] == [ctypes.c_int] * 2 and types[2:13] == [ctypes.c_void_p] * 11
    assert types[13:16] == [ctypes.c_int] * 3 and types[-1] is ctypes.c_void_p
    assert lib.rtt_attn_bwd_sm90_f32_occupancy.argtypes == [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def test_profiler_groups_backward_kernels():
    group = profile_train_step.group_of
    for name in ("attn_bwd_sm90_kernel(CUtensorMap_st, ...)", "attn_bwd_sm90_pre_kernel<64>(...)",
                 "attn_bwd_sm90_post_kernel<64, 64>(...)", "attn_bwd_sm90_d128_kernel(CUtensorMap_st, ...)",
                 "attn_bwd_sm90_pre_kernel<128>(...)", "attn_bwd_sm90_post_kernel<128, 64>(...)"):
        assert group(name) == "attention bwd (port kernel, sm90)"
    for name in ("void attn_bwd_sm90_f32_kernel<64>(CUtensorMap_st, ...)", "void attn_bwd_sm90_f32_pre_kernel<64>(...)"):
        assert group(name) == "attention bwd (port kernel, sm90)"
    assert group("void attn_bwd_kernel<__nv_bfloat16, 128, 8>(...)") == "attention bwd (port kernel, wmma)"
    assert group("attn_fwd_sm90_kernel(CUtensorMap_st, ...)").startswith("attention fwd")
