#!/usr/bin/env python3
"""Drive ray_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases:
  1. the device: name, power limit; TF32 off for the references.
  2. build the CUDA kernels from ray_tpu_torch/ops/csrc (first use), one
     nvcc per source, all at once; print each kernel's registers and spills
     (ptxas) and the sm90 forward's shared memory and CTAs per SM.
  3. kernels: the causal-attention forwards (attention_fwd_sm90.cu for bf16
     at D=64, causal_attention.cu's attn_fwd_kernel for D=128 and float32)
     and the fused backward, through impl="splash" and impl="flash", held
     against the plain PyTorch version on the same inputs, at the main
     path's shape (strided q/k/v views of one QKV tensor), at D=128, at a
     ragged S, with q, k, v as head-major views, and with float32 inputs,
     each checked to have taken the forward that the routing table names;
     then timed at GPT-2 124M's shape (both forwards) beside the plain
     version and
     torch.nn.functional.scaled_dot_product_attention (timing only).
  4. the slice: GPT-2 124M training through make_train_step.  (a) one step
     at batch 2 with the kernels and with the plain attention, same weights
     and batch; (b) 2 warm-up + 10 timed steps at batch 18 on one repeated
     synthetic batch, with the launch counters reset just before and read
     just after; (c) every forward launch of (b) went through the sm90
     kernel.  (d) the D=128 path: one forward and backward through
     causal_attention at Llama's head dim, counters reset before and read
     after, which launches attn_fwd_kernel.
Then one JSON line on the kernels and, last, {"ok": true, "device": ...}.
Any failed check makes the script exit 1 without that last line.  It exits 2
when no CUDA device is present.

Tolerances (bf16 kernel checks), FlashAttention's own test rule: the kernel's
max |error| against the float32 reference may be at most twice the plain
version's run in bf16 on the same inputs, plus 1e-3.  Both round P and O to
bf16, at different points; dq's atomic f32 sums also vary in order from run
to run.  lse is f32 from the same bf16 products: 1e-4 absolute.  float32
inputs: 1e-4 absolute everywhere (same arithmetic, other summation order).
Slice (a): loss within 1e-3 and grad_norm within 1e-2 relative; kernel and
plain attention differ by at most about one bf16 rounding per element, which
the loss averages over 2048 tokens and the norm over 124M gradients.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SLICE_ATTN = (18, 1024, 12, 64)  # GPT-2 124M at bench batch 18: B, S, H, D
CHECK_SHAPES = [  # B, S, H, D
    (2, 1024, 12, 64),  # the main path's S, H, D
    (1, 1024, 24, 128),  # Llama's head dim
    (2, 1000, 12, 64),  # ragged S: tails masked in-kernel
    (1, 1000, 4, 128),
]
F32_CHECK_SHAPES = [(1, 300, 4, 64), (1, 200, 2, 128)]
D128_PATH = (1, 1024, 24, 128)  # B, S, H, D of path (d)
TPU_KERNELS = "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"
SOURCES = ("causal_attention", "attention_fwd_sm90")  # under ray_tpu_torch/ops/csrc/
FWD_COUNTERS = {"sm90": "causal_attention_fwd_sm90", "wmma": "causal_attention_fwd_wmma"}

FAILED = []


def check(name: str, ok: bool, detail: str) -> None:
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        FAILED.append(name)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv_views(B, S, H, D, dtype, gen, head_major=False):
    """q, k, v as the model hands them over: [B, S, H, D] views of one
    [B, S, 3*H*D] projection output (seq stride 3*H*D); or, head_major,
    [B, S, H, D] views of [B, H, S, D] tensors (head stride above seq
    stride)."""
    if head_major:
        qkv = torch.randn(3, B, H, S, D, device="cuda", generator=gen).to(dtype)
        return [t.transpose(1, 2) for t in qkv]
    qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=gen).to(dtype)
    return [t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1)]


def attention_errors(att, B, S, H, D, dtype, impl, seed, fwd_routes=(), head_major=False):
    """Max |error| of the kernel path (impl) and of the plain version run in
    `dtype`, both against the plain version in float32, for out, lse, dq, dk,
    dv; the forward kernels the kernel path launched (route -> count); and
    the out error of each forward kernel in `fwd_routes` launched directly
    on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = qkv_views(B, S, H, D, dtype, gen, head_major)
    do = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
    scale = D**-0.5

    def run(fn, cast):
        leaves = [t.detach().to(cast).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, do.to(cast))
        return [out.float(), *(g.float() for g in grads)]

    ref = run(lambda a, b, c: att.plain_causal_attention(a, b, c, scale), torch.float32)
    plain = run(lambda a, b, c: att.plain_causal_attention(a, b, c, scale), dtype)
    before = {r: att.LAUNCHES[c] for r, c in FWD_COUNTERS.items()}
    kern = run(lambda a, b, c: att.causal_attention(a, b, c, impl=impl), dtype)
    taken = {r: att.LAUNCHES[c] - before[r] for r, c in FWD_COUNTERS.items()}
    # lse straight from the forward kernel, on pre-scaled q and the strided k, v
    qs = (q * torch.tensor(scale, dtype=dtype)).contiguous()
    _, lse = att.attention_fwd(qs, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    lse_ref = torch.logsumexp(scores.masked_fill(~causal, -math.inf), dim=-1)
    torch.cuda.synchronize()
    names = ("out", "dq", "dk", "dv")
    err_k = {n: (a - r).abs().max().item() for n, a, r in zip(names, kern, ref)}
    err_p = {n: (a - r).abs().max().item() for n, a, r in zip(names, plain, ref)}
    err_k["lse"] = (lse - lse_ref).abs().max().item()
    fwd_err = {r: (att._launch_fwd(r, qs, k, v)[0].float() - ref[0]).abs().max().item() for r in fwd_routes}
    return err_k, err_p, taken, fwd_err


def check_route(att, taken, dtype, D, what):
    want = att._FWD_ROUTES[(dtype, D)]
    check(f"route {what}", taken == {r: int(r == want) for r in FWD_COUNTERS},
          f"forward launches {taken}, table names {want}")


def kernel_phase(att):
    for i, (B, S, H, D) in enumerate(CHECK_SHAPES):
        for impl in ("splash", "flash"):
            ek, ep, taken, _ = attention_errors(att, B, S, H, D, torch.bfloat16, impl, seed=10 + i)
            check_route(att, taken, torch.bfloat16, D, f"bf16 B={B} S={S} H={H} D={D} impl={impl}")
            for n in ("out", "dq", "dk", "dv"):
                tol = 2 * ep[n] + 1e-3
                check(f"bf16 {n} B={B} S={S} H={H} D={D} impl={impl}", ek[n] <= tol,
                      f"kernel {ek[n]:.3e} plain-bf16 {ep[n]:.3e} tol {tol:.3e}")
            check(f"bf16 lse B={B} S={S} H={H} D={D} impl={impl}", ek["lse"] <= 1e-4, f"{ek['lse']:.3e} tol 1e-4")
    # q, k, v as head-major views: the kernels take any batch/seq/head strides
    B, S, H, D = CHECK_SHAPES[2]
    ek, ep, taken, _ = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=4, head_major=True)
    check_route(att, taken, torch.bfloat16, D, f"bf16 head-major B={B} S={S} H={H} D={D}")
    for n in ("out", "dq", "dk", "dv"):
        tol = 2 * ep[n] + 1e-3
        check(f"bf16 head-major {n} B={B} S={S} H={H} D={D}", ek[n] <= tol,
              f"kernel {ek[n]:.3e} plain-bf16 {ep[n]:.3e} tol {tol:.3e}")
    check(f"bf16 head-major lse B={B} S={S} H={H} D={D}", ek["lse"] <= 1e-4, f"{ek['lse']:.3e} tol 1e-4")
    # the main path's exact shape; these are the errors reported per kernel
    B, S, H, D = SLICE_ATTN
    ek, ep, taken, fwd_err = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=1,
                                              fwd_routes=tuple(FWD_COUNTERS))
    check_route(att, taken, torch.bfloat16, D, f"bf16 B={B} S={S} H={H} D={D} impl=auto")
    for r, e in fwd_err.items():  # both forwards launched directly on the same inputs
        tol = 2 * ep["out"] + 1e-3
        check(f"bf16 out B={B} S={S} H={H} D={D} forward {r}", e <= tol, f"kernel {e:.3e} tol {tol:.3e}")
    for n in ("out", "dq", "dk", "dv"):
        tol = 2 * ep[n] + 1e-3
        check(f"bf16 {n} B={B} S={S} H={H} D={D} impl=auto", ek[n] <= tol,
              f"kernel {ek[n]:.3e} plain-bf16 {ep[n]:.3e} tol {tol:.3e}")
    check(f"bf16 lse B={B} S={S} H={H} D={D} impl=auto", ek["lse"] <= 1e-4, f"{ek['lse']:.3e} tol 1e-4")
    max_err = {FWD_COUNTERS[r]: e for r, e in fwd_err.items()}
    max_err["causal_attention_bwd"] = max(ek["dq"], ek["dk"], ek["dv"])
    for B, S, H, D in F32_CHECK_SHAPES:
        ek, _, taken, _ = attention_errors(att, B, S, H, D, torch.float32, "splash", seed=5)
        check_route(att, taken, torch.float32, D, f"f32 B={B} S={S} H={H} D={D}")
        for n, e in ek.items():
            check(f"f32 {n} B={B} S={S} H={H} D={D}", e <= 1e-4, f"{e:.3e} tol 1e-4")
    return max_err


def attention_bounds(B, S, H, D, elem=2):
    """Least time (ms) of the causal forward and backward on this card:
    operations over the bf16 peak vs bytes over HBM bandwidth.  Each input
    read once and each output written once; operations counted over the
    S(S+1)/2 causal (query, key) pairs."""
    pairs = B * H * S * (S + 1) / 2
    t = B * S * H * D * elem
    lse = B * H * S * 4
    fwd_flops, fwd_bytes = 4 * D * pairs, 4 * t + lse  # QK^T, PV; reads q,k,v, writes o, lse
    bwd_flops = 10 * D * pairs  # QK^T, dO V^T, P^T dO, dS^T Q, dS K
    bwd_bytes = 8 * t + lse  # reads q,k,v,o,dO,lse; writes dq,dk,dv
    out = {}
    for name, flops, nbytes in (("causal_attention_fwd", fwd_flops, fwd_bytes),
                                ("causal_attention_bwd", bwd_flops, bwd_bytes)):
        t_ops, t_bytes = flops / BF16_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def attention_flops(B, S, H, D):
    """FLOP of the causal forward: Q K^T and P V over the S(S+1)/2 pairs."""
    return 4 * D * B * H * S * (S + 1) / 2


def timing_phase(att):
    B, S, H, D = SLICE_ATTN
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv_views(B, S, H, D, torch.bfloat16, gen)
    do = torch.randn(B, S, H, D, device="cuda", generator=gen).bfloat16()
    qs = (q * torch.tensor(D**-0.5, dtype=torch.bfloat16)).contiguous()
    o, lse = att.attention_fwd(qs, k, v)
    times = {c: cuda_ms(lambda r=r: att._launch_fwd(r, qs, k, v)) for r, c in FWD_COUNTERS.items()}
    times["causal_attention_bwd"] = cuda_ms(lambda: att.attention_bwd(qs, k, v, o, lse, do))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = att.plain_causal_attention(*leaves, D**-0.5)
    plain_fwd = cuda_ms(lambda: att.plain_causal_attention(q, k, v, D**-0.5))
    plain = {c: plain_fwd for c in FWD_COUNTERS.values()}
    plain["causal_attention_bwd"] = cuda_ms(lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True))
    del plain_out
    # library yardstick: one PyTorch call computing the same function, [B,H,S,D]
    lq, lk, lv = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    ldo = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(lq, lk, lv, is_causal=True)
    lib_fwd = cuda_ms(lambda: sdpa(lq, lk, lv, is_causal=True))
    library = {c: lib_fwd for c in FWD_COUNTERS.values()}
    library["causal_attention_bwd"] = cuda_ms(
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), ldo, retain_graph=True))
    bound = attention_bounds(B, S, H, D)
    bounds = {c: bound["causal_attention_fwd"] for c in FWD_COUNTERS.values()}
    bounds["causal_attention_bwd"] = bound["causal_attention_bwd"]
    for name in times:
        print(f"time {name} B={B} S={S} H={H} D={D}: kernel {times[name]:.4f} ms, plain {plain[name]:.4f} ms, "
              f"sdpa {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}); "
              f"{bounds[name][0] / times[name]:.1%} of the bound, {times[name] / library[name]:.2f}x sdpa", flush=True)
    for c in FWD_COUNTERS.values():
        print(f"rate {c}: {attention_flops(B, S, H, D) / times[c] / 1e9:.1f} TFLOP/s "
              f"({attention_flops(B, S, H, D) / times[c] / 1e9 / (BF16_PEAK_FLOPS / 1e12):.1%} of the bf16 peak)",
              flush=True)
    return times, plain, library, bounds


def slice_phase(att, card):
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step, synthetic_batch

    cfg = GPT2Config.gpt2_124m()
    gen = torch.Generator(device="cuda").manual_seed(1)

    # (a) one step at batch 2 from identical weights: kernels vs plain attention
    tok, tgt = synthetic_batch(gen, 2, cfg.block_size, cfg.vocab_size)
    metrics = {}
    for impl in ("auto", "xla"):
        bundle = make_train_step(GPT2Model(dataclasses.replace(cfg, attention_impl=impl), seed=0))
        params, opt = bundle.init(0)
        _, _, m = bundle.step(params, opt, tok, tgt)
        metrics[impl] = (m["loss"].item(), m["grad_norm"].item())
        del bundle, params, opt
    (lk, gk), (lp, gp) = metrics["auto"], metrics["xla"]
    check("slice (a) loss kernel vs plain", abs(lk - lp) <= 1e-3 * abs(lp), f"{lk:.6f} vs {lp:.6f}")
    check("slice (a) grad_norm kernel vs plain", abs(gk - gp) <= 1e-2 * abs(gp), f"{gk:.6f} vs {gp:.6f}")

    # (b) the main path: 2 warm-up + 10 timed steps at bench batch 18
    batch, warmup, steps = 18, 2, 10
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    tok, tgt = synthetic_batch(gen, batch, cfg.block_size, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    losses = []
    for _ in range(warmup):
        params, opt, m = bundle.step(params, opt, tok, tgt)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = bundle.step(params, opt, tok, tgt)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(att.LAUNCHES)
    losses = [x.item() for x in losses]
    ms_step = dt / steps * 1e3
    tok_s = batch * cfg.block_size * steps / dt
    mfu = tok_s * cfg.flops_per_token() / BF16_PEAK_FLOPS
    print(f"slice GPT-2 124M B={batch} S={cfg.block_size} remat={cfg.remat} on {card}: "
          f"{ms_step:.2f} ms/step, {tok_s:.0f} tokens/s, model FLOP/s {100 * mfu:.2f}% of bf16 peak, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"slice losses {['%.4f' % x for x in losses]}", flush=True)
    total = warmup + steps
    per_fwd = 2 * cfg.n_layer if cfg.remat else cfg.n_layer  # remat re-runs each forward
    check("slice (b) losses finite", all(math.isfinite(x) for x in losses), f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    check("slice (b) loss falls", losses[-1] < losses[0], f"first {losses[0]:.4f} last {losses[-1]:.4f}")
    check("slice (c) forward launches", launches["causal_attention_fwd"] == per_fwd * total,
          f"{launches['causal_attention_fwd']} for {total} steps")
    check("slice (c) forward launches on the sm90 kernel",
          launches["causal_attention_fwd_sm90"] == per_fwd * total and launches["causal_attention_fwd_wmma"] == 0,
          f"sm90 {launches['causal_attention_fwd_sm90']}, wmma {launches['causal_attention_fwd_wmma']}")
    check("slice (c) backward launches", launches["causal_attention_bwd"] == cfg.n_layer * total,
          f"{launches['causal_attention_bwd']} for {total} steps")
    return launches


def d128_phase(att):
    """Path (d): causal attention at Llama's head dim through the entry point
    a model calls, forward and backward once; the launches it makes."""
    B, S, H, D = D128_PATH
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (t.detach().requires_grad_() for t in qkv_views(B, S, H, D, torch.bfloat16, gen))
    torch.cuda.synchronize()
    att.reset_launch_counts()
    out = att.causal_attention(q, k, v)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    check("path (d) D=128 launches", launches["causal_attention_fwd_wmma"] == 1
          and launches["causal_attention_fwd_sm90"] == 0 and launches["causal_attention_bwd"] == 1,
          f"{launches}")
    return launches


def build_phase(att):
    """Build every kernel source at once; print registers and spills per
    kernel (ptxas), and the sm90 forward's shared memory and CTAs per SM."""
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in SOURCES:
        report = _build.ptxas_report(name)
        for entry, body in re.findall(r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)", report, re.S):
            kernel = re.search(r"(attn_\w+?_kernel)", entry)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            tmpl = re.search(r"kernelI(\w+?)EEv", entry)
            print(f"ptxas {name}: {kernel.group(1) if kernel else entry}{'<' + tmpl.group(1) + '>' if tmpl else ''}: "
                  f"{regs.group(1) if regs else '?'} registers, spill stores {spill.group(1) if spill else '?'} B, "
                  f"spill loads {spill.group(2) if spill else '?'} B", flush=True)
            if "sm90" in entry:
                check("ptxas: sm90 forward spills nothing", bool(spill) and spill.groups() == ("0", "0"),
                      spill.group(0) if spill else "no spill line in the report")
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    lib = att._kernels("attention_fwd_sm90")
    err = lib.rtt_attn_fwd_sm90_occupancy(ctypes.byref(smem), ctypes.byref(ctas))
    check("sm90 forward occupancy query", err == 0, f"error {err}")
    print(f"occupancy attn_fwd_sm90_kernel: {smem.value} bytes of dynamic shared memory, "
          f"{ctas.value} CTAs (of 256 threads) per SM", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.ops import attention as att

    # 1. the device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    build_phase(att)

    # 3. kernels
    max_err = kernel_phase(att)
    times, plain, library, bounds = timing_phase(att)

    # 4. the slice, then path (d)
    launches = slice_phase(att, smi)
    launches["causal_attention_fwd_wmma"] = d128_phase(att)["causal_attention_fwd_wmma"]

    info = {  # name -> (source, replaces, status)
        "causal_attention_fwd_sm90": (
            "ray_tpu_torch/ops/csrc/attention_fwd_sm90.cu", f"{TPU_KERNELS}:1137",  # _splash_attention_forward
            "ported (wgmma, TMA); bf16 at D=64, the main path's forward; "
            "also serves impl='flash' (flash_attention.py:758)"),
        "causal_attention_fwd_wmma": (
            "ray_tpu_torch/ops/csrc/causal_attention.cu", f"{TPU_KERNELS}:1137",
            "ported (WMMA); bf16 at D=128 and float32, launches from path (d); "
            "timed and checked at the main path's shape beside the sm90 kernel"),
        "causal_attention_bwd": (
            "ray_tpu_torch/ops/csrc/causal_attention.cu", f"{TPU_KERNELS}:2196",  # _splash_attention_bwd_dkv, fused
            "ported; also serves impl='flash' (flash_attention.py:1121/1456)"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "status": status,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": times[name],
            "plain_ms": plain[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": library[name],
        }
        for name, (source, replaces, status) in info.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} check(s) failed: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
