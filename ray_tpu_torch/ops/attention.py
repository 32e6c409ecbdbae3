"""Causal attention: hand-written CUDA kernels on the card, plain PyTorch on
the CPU.

Port of `ray_tpu/ops/attention.py`.  There, `impl="auto"` reaches the TPU
splash-attention kernels (forward, and a fused backward giving dq, dk, dv)
and `impl="flash"` the TPU flash-attention kernels.  Here every one of those
names launches the CUDA kernels on a CUDA tensor: for bfloat16 the forward
of `csrc/attention_fwd_sm90.cu` and the fused backward of
`csrc/attention_bwd_sm90.cu` (wgmma, TMA) at head dim 64, and their head-dim
128 forms `csrc/attention_fwd_sm90_d128.cu` and
`csrc/attention_bwd_sm90_d128.cu`; for float32 `csrc/attention_fwd_sm90_f32.cu`
and `csrc/attention_bwd_sm90_f32.cu` (3xTF32 on the tensor cores, TMA) at
both head dims; chosen by the tables `_FWD_ROUTES` and `_BWD_ROUTES`.  Every
backward adds dq in a fixed order, so a run's gradients are the same from
run to run, as the reference's are.  `csrc/causal_attention.cu` (WMMA) is
on no route: it is built and launched directly as the yardstick the other
kernels are timed against.  Only
`impl="xla"` names the plain version, the port of `_xla_causal_attention`.
On a CPU tensor every impl runs the plain version.  Every impl but "xla"
goes through one `torch.library` custom op, `ray_tpu_torch::causal_attention`
(`ATTENTION_OP`), returning (o, lse): a dispatcher op that a remat policy
can see, whose outputs the fused backward reads.

Layout: [batch, seq, heads, head_dim] in and out, as in the JAX package.
The kernels read q, k and v through their strides, so the views that come
out of the fused QKV projection need no copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

IMPLS = ("auto", "splash", "flash", "xla")
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The forward kernel for each (dtype, head_dim), chosen by type and shape
# alone: "sm90" is attention_fwd_sm90.cu, "sm90_d128" attention_fwd_sm90_d128.cu,
# "sm90_f32" attention_fwd_sm90_f32.cu.
_FWD_ROUTES = {
    (torch.bfloat16, 64): "sm90",
    (torch.bfloat16, 128): "sm90_d128",
    (torch.float32, 64): "sm90_f32",
    (torch.float32, 128): "sm90_f32",
}
# kernel -> (library under csrc/, entry point, launch counter); "wmma",
# causal_attention.cu's attn_fwd_kernel, is on no route: the yardstick
_FWD_KERNELS = {
    "sm90": ("attention_fwd_sm90", "rtt_attn_fwd_sm90", "causal_attention_fwd_sm90"),
    "sm90_d128": ("attention_fwd_sm90_d128", "rtt_attn_fwd_sm90_d128", "causal_attention_fwd_sm90_d128"),
    "sm90_f32": ("attention_fwd_sm90_f32", "rtt_attn_fwd_sm90_f32", "causal_attention_fwd_sm90_f32"),
    "wmma": ("causal_attention", "rtt_attn_fwd", "causal_attention_fwd_wmma"),
}
# The same for the fused backward: "sm90" is attention_bwd_sm90.cu,
# "sm90_d128" attention_bwd_sm90_d128.cu, "sm90_f32" attention_bwd_sm90_f32.cu;
# "wmma" (causal_attention.cu's attn_bwd_kernel, dq summed by atomics in no
# fixed order) is on no route.
_BWD_ROUTES = {
    (torch.bfloat16, 64): "sm90",
    (torch.bfloat16, 128): "sm90_d128",
    (torch.float32, 64): "sm90_f32",
    (torch.float32, 128): "sm90_f32",
}
_BWD_KERNELS = {
    "sm90": ("attention_bwd_sm90", "rtt_attn_bwd_sm90", "causal_attention_bwd_sm90"),
    "sm90_d128": ("attention_bwd_sm90_d128", "rtt_attn_bwd_sm90_d128", "causal_attention_bwd_sm90_d128"),
    "sm90_f32": ("attention_bwd_sm90_f32", "rtt_attn_bwd_sm90_f32", "causal_attention_bwd_sm90_f32"),
    "wmma": ("causal_attention", "rtt_attn_bwd", "causal_attention_bwd_wmma"),
}
# the sm90 backwards' q tile: their f32 dq accumulator holds whole tiles,
# and their dq adds are ordered by one int semaphore per (batch, head, tile)
BWD_SM90_TILE = 64

# Launches of each kernel since the last reset_launch_counts(): a run reads
# them to show that it went through the kernels.  "causal_attention_fwd"
# and "causal_attention_bwd" count every forward and backward launch, the
# others each kernel's.
LAUNCHES = {
    "causal_attention_fwd": 0,
    "causal_attention_fwd_sm90": 0,
    "causal_attention_fwd_sm90_d128": 0,
    "causal_attention_fwd_sm90_f32": 0,
    "causal_attention_fwd_wmma": 0,
    "causal_attention_bwd": 0,
    "causal_attention_bwd_sm90": 0,
    "causal_attention_bwd_sm90_d128": 0,
    "causal_attention_bwd_sm90_f32": 0,
    "causal_attention_bwd_wmma": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plain_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    scores_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch causal attention (port of `_xla_causal_attention`):
    scores in `scores_dtype`, a -1e30 mask, an f32 softmax cast back to q's
    dtype.  The reference the kernels are held against."""
    probs = torch.softmax(_plain_scores(q, k, sm_scale, scores_dtype).float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _plain_scores(q, k, sm_scale: float, scores_dtype: torch.dtype) -> torch.Tensor:
    """Scaled scores [B, H, S, S] in `scores_dtype`, the future masked to -1e30."""
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(scores_dtype), k.to(scores_dtype))
    scores = scores * torch.tensor(sm_scale, dtype=scores_dtype)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~mask, -1e30)


_P, _I, _STRIDES = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _STRIDES, _P]
# dtype, D; q, k, v, o, do, lse, di, dq_acc, sem, dq, dk, dv; B, H, S; strides; stream
_SM90_BWD_ARGTYPES = [_I, _I, *[_P] * 12, _I, _I, _I, _STRIDES, _P]
# dtype, D; q, k, v, o, do, lse, di, sem, dq, dk, dv; B, H, S; strides; stream
_F32_BWD_ARGTYPES = [_I, _I, *[_P] * 11, _I, _I, _I, _STRIDES, _P]
# library -> {entry point: argtypes}; every pointer and the stream are c_void_p
_ENTRY_POINTS = {
    "causal_attention": {
        "rtt_attn_fwd": _FWD_ARGTYPES,
        "rtt_attn_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _STRIDES, _P],
        "rtt_attn_occupancy": [_I, _I, _I, _P, _P],
    },
    "attention_fwd_sm90": {"rtt_attn_fwd_sm90": _FWD_ARGTYPES, "rtt_attn_fwd_sm90_occupancy": [_P, _P]},
    "attention_bwd_sm90": {"rtt_attn_bwd_sm90": _SM90_BWD_ARGTYPES, "rtt_attn_bwd_sm90_occupancy": [_P, _P]},
    "attention_fwd_sm90_d128": {
        "rtt_attn_fwd_sm90_d128": _FWD_ARGTYPES,
        "rtt_attn_fwd_sm90_d128_occupancy": [_P, _P],
    },
    "attention_bwd_sm90_d128": {
        "rtt_attn_bwd_sm90_d128": _SM90_BWD_ARGTYPES,
        "rtt_attn_bwd_sm90_d128_occupancy": [_P, _P],
    },
    "attention_fwd_sm90_f32": {"rtt_attn_fwd_sm90_f32": _FWD_ARGTYPES, "rtt_attn_fwd_sm90_f32_occupancy": [_I, _P, _P]},
    "attention_bwd_sm90_f32": {"rtt_attn_bwd_sm90_f32": _F32_BWD_ARGTYPES, "rtt_attn_bwd_sm90_f32_occupancy": [_I, _P, _P]},
}


@functools.lru_cache(maxsize=None)
def _kernels(name: str = "causal_attention") -> ctypes.CDLL:
    """The built library `csrc/<name>.cu`, its entry points declared."""
    lib = _build.load(name)
    for entry, argtypes in _ENTRY_POINTS[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.rtt_error_string.argtypes = [_I]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.rtt_error_string(err).decode()}")


def _contiguous_aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _vector_ready(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: last dim contiguous, base and batch/seq/head
    strides on 16-byte boundaries (the kernels load 16-byte vectors)."""
    es = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all((s * es) % 16 == 0 for s in x.stride()[:3]):
        return x
    return _contiguous_aligned(x)


def _qkv_strides(q, k, v):
    return (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch_fwd(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of `route` (a key of `_FWD_KERNELS`)."""
    name, entry, counter = _FWD_KERNELS[route]
    lib = _kernels(name)
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = getattr(lib, entry)(
        _KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, S, _qkv_strides(q, k, v), _stream(q.device),
    )
    _raise_on_error(lib, err, counter)
    LAUNCHES["causal_attention_fwd"] += 1
    LAUNCHES[counter] += 1
    return o, lse


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel that `_FWD_ROUTES` names for q's dtype and
    head dim, on pre-scaled q: (o [B,S,H,D] in q's dtype, lse [B,H,S] f32,
    the natural-log logsumexp of each row of scores).  q, k, v must already
    satisfy `_vector_ready`."""
    return _launch_fwd(_FWD_ROUTES[(q.dtype, q.shape[-1])], q, k, v)


def _launch_bwd(route: str, q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused backward kernel of `route` (a key of `_BWD_KERNELS`)."""
    name, entry, counter = _BWD_KERNELS[route]
    lib = _kernels(name)
    B, S, H, D = q.shape
    do = _contiguous_aligned(do)
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides, stream = _qkv_strides(q, k, v), _stream(q.device)
    if route != "wmma":
        # the sm90 entry points fill di and zero dq's f32 sum and the
        # semaphores (one int per (batch, head, 64-row tile)) that order its
        # adds.  bf16: the sum is an accumulator of whole 64-row tiles (rows
        # padded to a multiple of 64), each a contiguous block of D/8
        # 8-column blocks, cast to dq after; float32: dq itself.
        n_tiles = -(-S // BWD_SM90_TILE)
        di = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        sem = torch.empty((B, H, n_tiles), dtype=torch.int32, device=q.device)
        dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        o = _contiguous_aligned(o)
        if route == "sm90_f32":
            acc = ()
        else:
            dq_acc = torch.empty((B, H, n_tiles * BWD_SM90_TILE, D), dtype=torch.float32, device=q.device)
            acc = (dq_acc.data_ptr(),)
        err = getattr(lib, entry)(
            _KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), *acc, sem.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, S, strides, stream,
        )
    else:
        # di = rowsum(dO * O), computed outside the kernel as splash does;
        # dq summed in f32 by atomics across k/v tiles, then cast
        di = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
        dq_acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
        err = getattr(lib, entry)(
            _KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, S, strides, stream,
        )
    _raise_on_error(lib, err, counter)
    if route == "wmma":
        dq = dq_acc.to(q.dtype)
    LAUNCHES["causal_attention_bwd"] += 1
    LAUNCHES[counter] += 1
    return dq, dk, dv


def attention_bwd(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused backward kernel that `_BWD_ROUTES` names for q's
    dtype and head dim: (dq, dk, dv) in q's dtype for pre-scaled q, from the
    forward's o and lse and the upstream gradient do."""
    return _launch_bwd(_BWD_ROUTES[(q.dtype, q.shape[-1])], q, k, v, o, lse, do)


def _plain_fwd(q, k, v, sm_scale: float, scores_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: `plain_causal_attention`'s
    output and the natural-log logsumexp [B, H, S] f32 of its scaled, masked
    scores."""
    scores = _plain_scores(q, k, sm_scale, scores_dtype).float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), torch.logsumexp(scores, dim=-1)


@torch.library.custom_op("ray_tpu_torch::causal_attention", mutates_args=())
def _attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, scores_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention as one dispatcher op returning (o, lse), so that a
    remat policy can keep both outputs instead of re-running the forward
    kernel.  This body is the plain version (a CPU tensor); on a CUDA
    tensor the kernel registered below runs.  The backward
    (`_attention_backward`) is the fused kernel and never re-runs the
    forward."""
    return _plain_fwd(q, k, v, sm_scale, scores_dtype)


def _scaled(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    # splash's convention: q pre-scaled in its own dtype, lse of scaled scores
    return _vector_ready(q * torch.tensor(sm_scale, dtype=q.dtype))


@_attention_op.register_kernel("cuda")
def _attention_op_cuda(q, k, v, sm_scale, scores_dtype):
    return attention_fwd(_scaled(q, sm_scale), _vector_ready(k), _vector_ready(v))


@_attention_op.register_fake
def _attention_op_fake(q, k, v, sm_scale, scores_dtype):
    B, S, H, D = q.shape
    return q.new_empty((B, S, H, D)), q.new_empty((B, H, S), dtype=torch.float32)


def _attention_setup(ctx, inputs, output):
    q, k, v, sm_scale, scores_dtype = inputs
    ctx.sm_scale, ctx.scores_dtype = sm_scale, scores_dtype
    ctx.save_for_backward(q, k, v, *output)


def _attention_backward(ctx, do, _dlse):
    """The fused backward kernel from the saved (q, k, v, o, lse); q's
    pre-scale is redone (one elementwise pass) and its gradient scaled
    back, as autograd scaled it when the pre-scale sat outside the op.  On
    a CPU tensor, the plain version's gradients."""
    q, k, v, o, lse = ctx.saved_tensors
    if q.device.type == "cuda":
        dqs, dk, dv = attention_bwd(_scaled(q, ctx.sm_scale), _vector_ready(k), _vector_ready(v), o, lse, do)
        return dqs * torch.tensor(ctx.sm_scale, dtype=q.dtype), dk, dv, None, None
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = plain_causal_attention(*leaves, ctx.sm_scale, ctx.scores_dtype)
        return (*torch.autograd.grad(out, leaves, do), None, None)


_attention_op.register_autograd(_attention_backward, setup_context=_attention_setup)
# the op as the dispatcher (and a TorchDispatchMode) sees it
ATTENTION_OP = torch.ops.ray_tpu_torch.causal_attention.default


def _check_kernel_inputs(q, k, v) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape; got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"the attention kernels take bfloat16 or float32 q, k, v; got "
            f"{q.dtype}, {k.dtype}, {v.dtype} (impl='xla' runs the plain version)"
        )
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the attention kernels take head_dim in {KERNEL_HEAD_DIMS}; got "
            f"{q.shape[-1]} (impl='xla' runs the plain version)"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    scores_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Causal MHA.  q, k, v: [B, S, H, D] -> [B, S, H, D].

    impl: "auto" | "splash" | "flash" launch the CUDA kernels on a CUDA
    tensor; "xla" runs the plain version.  On a CPU tensor every impl runs
    the plain version.  `scores_dtype` applies to the plain version only.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "xla":
        return plain_causal_attention(q, k, v, sm_scale, scores_dtype)
    if q.device.type == "cuda":
        _check_kernel_inputs(q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"causal_attention runs on cuda or cpu tensors, not {q.device.type}")
    return _attention_op(q, k, v, float(sm_scale), scores_dtype)[0]
