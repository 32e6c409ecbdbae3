"""Causal attention: hand-written CUDA kernels on the card, plain PyTorch on
the CPU.

Port of `ray_tpu/ops/attention.py`.  There, `impl="auto"` reaches the TPU
splash-attention kernels (forward, and a fused backward giving dq, dk, dv)
and `impl="flash"` the TPU flash-attention kernels.  Here every one of those
names launches the CUDA kernels on a CUDA tensor: the forward of
`csrc/attention_fwd_sm90.cu` (wgmma, TMA) for bfloat16 at head dim 64, the
forward of `csrc/causal_attention.cu` for the other dtypes and head dims
(`_FWD_ROUTES`), and the fused backward of `csrc/causal_attention.cu`.  Only
`impl="xla"` names the plain version, the port of `_xla_causal_attention`.
On a CPU tensor every impl runs the plain version.

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
# alone: "sm90" is attention_fwd_sm90.cu, "wmma" causal_attention.cu's
# attn_fwd_kernel.
_FWD_ROUTES = {
    (torch.bfloat16, 64): "sm90",
    (torch.bfloat16, 128): "wmma",
    (torch.float32, 64): "wmma",
    (torch.float32, 128): "wmma",
}
# route -> (library under csrc/, entry point, launch counter)
_FWD_KERNELS = {
    "sm90": ("attention_fwd_sm90", "rtt_attn_fwd_sm90", "causal_attention_fwd_sm90"),
    "wmma": ("causal_attention", "rtt_attn_fwd", "causal_attention_fwd_wmma"),
}

# Launches of each kernel since the last reset_launch_counts(): a run reads
# them to show that it went through the kernels.  "causal_attention_fwd"
# counts every forward launch, the two after it each forward kernel's.
LAUNCHES = {
    "causal_attention_fwd": 0,
    "causal_attention_fwd_sm90": 0,
    "causal_attention_fwd_wmma": 0,
    "causal_attention_bwd": 0,
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
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(scores_dtype), k.to(scores_dtype))
    scores = scores * torch.tensor(sm_scale, dtype=scores_dtype)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


_P, _I, _STRIDES = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _STRIDES, _P]
# library -> {entry point: argtypes}; every pointer and the stream are c_void_p
_ENTRY_POINTS = {
    "causal_attention": {
        "rtt_attn_fwd": _FWD_ARGTYPES,
        "rtt_attn_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _STRIDES, _P],
    },
    "attention_fwd_sm90": {"rtt_attn_fwd_sm90": _FWD_ARGTYPES, "rtt_attn_fwd_sm90_occupancy": [_P, _P]},
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


def attention_bwd(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused backward kernel: (dq, dk, dv) for pre-scaled q.  dq
    is summed in f32 by atomics across k/v tiles, then cast to q's dtype."""
    lib = _kernels()
    B, S, H, D = q.shape
    do = _contiguous_aligned(do)
    # di = rowsum(dO * O), computed outside the kernel as splash does
    di = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    dq_acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = lib.rtt_attn_bwd(
        _KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, S, _qkv_strides(q, k, v), _stream(q.device),
    )
    _raise_on_error(lib, err, "causal_attention_bwd")
    LAUNCHES["causal_attention_bwd"] += 1
    return dq_acc.to(q.dtype), dk, dv


class _CausalAttention(torch.autograd.Function):
    """Kernel forward saving (q, k, v, o, lse), as splash names its
    residuals; the backward is the fused kernel and never re-runs the
    forward (a remat'ed layer recomputes the forward itself)."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = (_vector_ready(t) for t in (q, k, v))
        o, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return attention_bwd(*ctx.saved_tensors, do)


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
    if impl == "xla" or q.device.type == "cpu":
        return plain_causal_attention(q, k, v, sm_scale, scores_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention runs on cuda or cpu tensors, not {q.device.type}")
    _check_kernel_inputs(q, k, v)
    # splash's convention: q pre-scaled in its own dtype, lse of scaled scores
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    return _CausalAttention.apply(qs, k, v)
