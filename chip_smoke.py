#!/usr/bin/env python3
"""Drive ray_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases:
  1. the device: name, power limit; TF32 off for the references.
  2. build the CUDA kernels from ray_tpu_torch/ops/csrc (first use), one
     nvcc per source, all at once; print each kernel's registers and spills
     (ptxas), fail if an sm90 kernel (the float32 ones included) spills,
     and print the shared memory and CTAs per SM of the sm90 kernels (the
     float32 ones at D=64 and 128) and of the wmma kernels at bf16 D=128.
  3. kernels: the causal-attention forwards and fused backwards (for bf16
     attention_fwd_sm90.cu / attention_bwd_sm90.cu at D=64 and
     attention_fwd_sm90_d128.cu / attention_bwd_sm90_d128.cu at D=128, for
     float32 attention_fwd_sm90_f32.cu / attention_bwd_sm90_f32.cu, the
     "sm90_f32" route, also launched directly at F32_CHECK_SHAPES;
     causal_attention.cu's WMMA kernels are on no route, the in-run
     yardstick), through impl="splash" and impl="flash", held against
     the plain PyTorch version on the same inputs, at the main path's shape
     (strided q/k/v views of one QKV tensor), at D=128, at a ragged S, with
     q, k, v as head-major views at both head dims, and with float32
     inputs, each checked to have taken the forward and the backward that
     the routing tables name; the sm90_d128 and wmma kernels launched
     directly on the same D=128 inputs, and at the main path's shape the
     D=64 ones; every routed backward run twice on the same inputs, its dq,
     dk and dv required byte-equal (dq is added in the order of the key
     tiles); then the D=64 kernels timed at GPT-2 124M's shape beside
     the plain version and torch.nn.functional.scaled_dot_product_attention
     (timing only).
  4. the slice: GPT-2 124M training through make_train_step.  (a) one step
     at batch 2 with the kernels and with the plain attention, same weights
     and batch; (b) 2 warm-up + 10 timed steps at batch 18 on one repeated
     synthetic batch, with the launch counters reset just before and read
     just after; (c) every forward and backward launch of (b) went through
     the sm90 kernels, one forward per layer and step: GPT2Config's default
     remat policy "dots" keeps the attention op's outputs (full remat
     would run two).  (d) the D=128 path: one forward and backward through
     causal_attention at Llama's head dim, counters reset before and read
     after, all on the sm90_d128 kernels.
  5. (e) the product path: ray_tpu_torch.init starts a cluster (head,
     zygote, workers: separate processes) that must count one GPU; a
     TorchTrainer fit runs the same 2 + 10 steps of (b) from the same
     weights and batch in a GPU worker actor, which resets the launch
     counters before its steps, reads them after and reports once.  Checked:
     the worker is another process on this card with no jax or ray_tpu
     module loaded; 144 forward and 144 backward launches, all on the sm90
     kernels; its first loss within 1e-3 relative of (b)'s (same weights,
     same batch, same kernels: the forward is the same computation); the
     loss falls; its tokens/s at least 0.9 of (b)'s; a pool task sees
     CUDA_VISIBLE_DEVICES="" and resolve_device() raises there; and
     shutdown() leaves no process of its cluster (the head and all
     below it) behind.
  6. (f) Llama-2-7B (LlamaConfig.llama2_7b: full width and depth, bf16
     weights drawn from seed 0, max_seq_len 256), direct.  First the
     head-dim-128 kernels (the sm90_d128 route, and the wmma kernels as the
     in-run yardstick) at its prefill shape B=1 S=256 H=32 D=128 and at
     B=1 S=2048 (LlamaConfig's default max_seq_len): the route checked,
     both launched directly and checked against the plain version, then
     timed beside it and SDPA; the sm90_d128 kernels must beat the wmma
     ones in device time, by CUDA-graph replay of 20 launches (single
     launches at S=256 time the host).  Then the model on one S=256 prompt: apply
     with the kernels, apply with the plain attention in bf16 and in f32
     (the reference), and the prefill path (the teacher-forced loop of
     decode_step) in bf16 and f32; apply's launches (32 forwards, all
     sm90_d128) read with the counters reset just before.  loss forward and
     backward at full width with 2 layers on 257 tokens (so at S=256, the
     shape checked above), counters reset before and read after: 4
     forwards (remat) and 2 backwards, all sm90_d128, and loss and grad norm
     against the plain attention.  ShardedLLM.generate at B=1 and B=8 (P=1,
     32 new tokens): ms per step against the weight-bytes bound, decode ms
     per token after the first, peak memory; a torch.profiler run of the
     B=8 generate for the device's idle share of that run's wall (profiler
     overhead included) and the decode attention's (einsum, masked_fill,
     softmax over the cache) share.
  7. (g) the product path: ray_tpu_torch.init, serve.run(llm_deployment(
     "llama2_7b", ..., num_gpus=1)) -> handle -> controller -> a GPU replica
     -> @serve.batch -> ShardedLLM.  Checked: the replica is another process
     on this card, started as the port's worker, with no jax library
     mapped; one request returns (f)'s B=1 tokens (same seed, shapes and
     kernels), and 8 requests sent at once (one batch) return (f)'s B=8
     rows, each its own; at offered concurrency 4, 16 and 32 (4 x concurrency
     requests each) every request returns 32 tokens (tokens/s, p50, p99
     printed); summarize_workloads("serve") holds TTFT and TPOT; no process
     of the cluster is left after serve.shutdown() and shutdown().  Every
     cluster call carries a timeout, and every request its own
     (REQUEST_TIMEOUT_S): a stall prints the deployment's newest stage
     traces and fails the run.
  8. (h) the step DAG: first the float32 kernels (the sm90_f32 route,
     which float32 compute takes, and the wmma yardstick) at the attention
     of GPT-2 124M at batch 4, B=4 S=1024 H=12 D=64: routed and launched
     directly, checked against the float32 plain version, timed beside it
     and float32 SDPA, each against its bound (4 bytes an element; sm90_f32
     at 3xTF32 on the tensor cores, 494.7/3 TFLOP/s; wmma at the 67 TFLOP/s
     FP32 peak).  Then ray_tpu_torch.init
     and TorchTrainer(train_step_spec=make_lm_step_spec("gpt2_124m",
     batch=4, seq=1024, steps=12, checkpoint_every=6, learning_rate=3e-4))
     fit twice on one cluster: the eager per-step path, then
     TorchConfig(use_step_dag=True), the resident compiled DAG (dag_shard
     -> dag_step -> dag_fold on the GPU worker actor, gang-armed).  Adam at
     3e-4: at the spec's default 1e-2 GPT-2 124M diverges.  The spec's
     build makes the step deterministic on the card (torch's deterministic
     algorithms, a fixed cuBLAS workspace) and zeroes the worker's launch
     counters; its final snapshot (an eager call at the drained step-12
     boundary) reads them.  Checked for each run: the worker is another
     process on this card with no jax or ray_tpu module; it ran under
     torch's deterministic algorithms; 12 x 12 forward and 12 x 12 backward
     launches, all sm90_f32; the checkpoint at step 12 with
     Adam's count 12; losses finite (each step draws a fresh batch of random
     tokens, so the loss need not fall).  Across the runs: every loss
     bit-equal and the final weights byte-equal (the step is deterministic,
     as the reference's is: dq is added in a fixed order); the eager
     checkpoint's numpy leaves byte for byte as they were after its fit,
     read again after the DAG run put its own (their store blocks were
     freed by their owner meanwhile, and stay until the views go); no
     process left after shutdown().  Printed: ms/step of each run between
     step completions and their difference.
  9. (i) the continuous-batching engine (serve/engine/, no attention
     kernel on its path).  (i1) in this process: Llama-2-7B's full widths
     with 2 layers in float32 from seed 0, InferenceEngine over
     ShardedLLM.engine_programs on the card (8 slots, pages of 16, prefill
     chunks of 32, max_seq_len 256); 12 requests with prompts of 1 to 200
     tokens and 16 or 32 new tokens submitted at once must each equal
     ShardedLLM.generate of its prompt alone, with one input shape per
     program.  (i2) the product path: ray_tpu_torch.init,
     serve.run(engine_llm_deployment("llama2_7b", ...)) on a GPU replica
     (bf16 weights from seed 0, as (f) and (g); max_queue 32).  At offered
     concurrency 4, 16 and 32 (4 x concurrency requests each, every other
     one through stream_tokens, each drawing one of 8 prompts whose
     lengths the seed draws in 1..200): tokens/s, p50/p99, the streams'
     TTFT and TPOT, the pool's pages in use, beside (g)'s numbers; one SSE
     stream through the proxy; an overload burst that must answer 503
     with Retry-After; every request bounded as in (g); no process left.
     Then, with the replica gone, each prompt's direct generate: streamed
     frames must concatenate to the buffered result, and every request
     must equal the direct tokens or differ first where the direct path's
     top-2 logit gap, recomputed in float32, is within bf16's spacing at
     that logit (2**-7 x |logit|).  Equality is expected: the engine's
     matmuls (8 slots, 32-token chunks) round as generate's at B=1 do
     (cuBLAS on the card gives a row the same bits at 1, 8 and 32 rows),
     and models/llama.py's RMSNorm reduces in an order that does not
     depend on the row count either: generate at B=8 of one prompt must
     give its B=1 tokens in every row.  Then the decode program alone,
     profiled.
 10. (j) RLlib's on-policy family (no kernel of its own: the CNN runs on
     cuDNN, the heads on cuBLAS).  (j1) the PPO learner on the card
     against the same learner on the CPU: TorchPolicy with the nature CNN
     at 84x84x4, 3 actions, float32 with TF32 off, lr 3e-4, the same
     converted weights (a JAX-layout tree from a seed through
     rllib_params_from_jax), 800 rows of the env's frames,
     learn_on_loaded_batch with minibatch 200 and 2 epochs: the first
     minibatch's gradient within 1e-4 of its norm, the metrics within 1e-3
     relative, the learned action probabilities within 1e-3 and values
     within 2e-2 of the largest; the parameters' difference printed (see
     rllib_learner_phase); the learner's parameters on the card.  (j2)
     ray_tpu_torch.init, then PPO at bench_rllib.py's configuration
     (SyntheticPixelEnv, 2 rollout workers x 32 envs x 50 steps, 3200 rows
     an iteration, minibatch 800, 2 epochs, lr 1e-3, torch's default TF32
     for cuDNN), each worker granted and running RL_WORKER_CPUS threads:
     one warm-up and 5 timed iterations (env-steps/s; rollout, transfer,
     host-to-device and learning seconds an iteration), one iteration
     under torch.profiler (the device's idle share), and the learner-only
     rate (load_batch + learn_on_loaded_batch on a fixed batch, as
     bench_rllib.py).  Checked: losses finite; the rollout workers are
     other processes that see no card, run their granted threads and have
     no jax or ray_tpu module; the learner's parameters on the card.  (j3)
     IMPALA and APPO on the same env at 2 x 8 envs, 3 iterations of 4
     learner updates: every update on the card, the count reached, losses
     finite, no learner error; no process left after shutdown().  Every
     cluster call carries a timeout (RL_TIMEOUT_S).
 11. (k) RLlib's off-policy family (no kernel of its own: MLPs on cuBLAS,
     the nature CNN on cuDNN).  (k1) one update of each learner on the
     card against the same update on the CPU, float32 with TF32 off, the
     same converted weights (JAX-layout trees from seeds through
     rllib_params_from_jax) and the same injected noise: SAC at
     bench_rllib.py _bench_sac's shape (obs 3, action 1, hidden 128 x 128,
     batch 128), TD3 at its defaults (256 x 256, batch 256; step 0, where
     the actor and both targets move), DQN with the nature CNN on 84x84x4
     uint8 env frames, batch 64, PER weights.  Metrics within 1e-4
     relative; parameters within 1e-5 (DQN's, if an element sits in an
     Adam tie as in (j1), held by its Q-values on the batch within 1e-4 of
     the largest); the parameters on the card.  (k2) _bench_sac's loop
     (bench_rllib.py:196-237) with the learner on the card: PendulumEnv
     with 16 envs, 80 random warm-up steps, 500 iterations of acting plus
     4 updates of 128 rows (env-steps/s, grad updates/s, ms an update in
     the loop and alone, the last 10 episodes' mean reward, alpha), 20 more
     under torch.profiler (the device's idle share, kernels an iteration).
     Checked: losses finite, alpha > 0.  (k3) ray_tpu_torch.init, then
     SAC, TD3, DDPG (Pendulum, 8 envs a worker) and DQN (the pixel env,
     nature CNN) with 2 CPU rollout workers, 3 iterations of 16 updates
     each from the first iteration on: the update count reached, the
     learner on the card, losses finite, the workers other processes with
     no card, their granted threads and no jax or ray_tpu module; no
     process left after shutdown().  Every cluster call carries a timeout.
Each phase prints its wall seconds.  Then one JSON line on the kernels (the
D=64 kernels' launches from (b), error and times from phase 3; the
sm90_d128 kernels' launches from (f), error and times at the prefill shape
with the long shape's beside; the sm90_f32 kernels' launches from (h),
error and times at its attention; the wmma kernels, on no route, no
launches, their D=128 error and times from direct launches, with (h)'s
float32 ones beside) and, last, {"ok": true, "device": ...}.
Any failed check makes the script exit 1 without that last line, and an
exception in any phase ends it with a traceback.  It exits 2 when no CUDA
device is present.

Tolerances (bf16 kernel checks), FlashAttention's own test rule: the kernel's
max |error| against the float32 reference may be at most twice the plain
version's run in bf16 on the same inputs, plus 1e-3.  Both round P and O to
bf16, at different points; dq's atomic f32 sums also vary in order from run
to run.  lse is f32 from the same bf16 products: 1e-4 absolute.  float32
inputs: 1e-4 absolute everywhere (3xTF32 keeps float32's accuracy to about
2**-21 of each product; other summation order).
Slice (a): loss within 1e-3 and grad_norm within 1e-2 relative; kernel and
plain attention differ by at most about one bf16 rounding per element, which
the loss averages over 2048 tokens and the norm over 124M gradients.  (f)'s
2-layer loss: the same two rules.  (f)'s logits, against apply in f32 with
the plain attention: apply with the kernels, and the bf16 prefill path at
the last position, each within twice the plain bf16 apply's error there plus
1e-3 (the kernel rule; the prefill path rounds the scores to bf16 where the
plain version does not, which measured about as large as the plain
version's own error on a narrower config on the CPU); the f32 prefill path
within 2e-3 + 2e-3 |reference| (tests/test_llama.py's tolerance).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
FP32_PEAK_FLOPS = 67e12  # H100 SXM FP32 peak without tensor cores (NVIDIA data sheet)
TF32_PEAK_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)
# float32 products as 3xTF32 (three TF32 products each): the sm90_f32
# kernels' bound.  They issue mma.sync, whose own TF32 ceiling is lower and
# not measured here, so no share against this bound can exceed 100%.
F32_3XTF32_PEAK_FLOPS = TF32_PEAK_FLOPS / 3
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
SOURCES = ("causal_attention", "attention_fwd_sm90", "attention_bwd_sm90",  # under ray_tpu_torch/ops/csrc/
           "attention_fwd_sm90_d128", "attention_bwd_sm90_d128", "attention_fwd_sm90_f32", "attention_bwd_sm90_f32")
ROUTES = ("sm90", "sm90_d128", "sm90_f32", "wmma")  # wmma: on no route, the in-run yardstick
FWD_COUNTERS = {r: f"causal_attention_fwd_{r}" for r in ROUTES}
BWD_COUNTERS = {r: f"causal_attention_bwd_{r}" for r in ROUTES}
COUNTERS = (*FWD_COUNTERS.values(), *BWD_COUNTERS.values())
D128_ROUTES = ("sm90_d128", "wmma")  # the head-dim-128 kernel and its in-run yardstick, launched directly
F32_ROUTES = ("sm90_f32", "wmma")  # the float32 kernels and the same yardstick, launched directly
DETERMINISM_SHAPES = {"sm90": (4, 1024, 12, 64), "sm90_d128": (1, 2048, 32, 128), "sm90_f32": (4, 1024, 12, 64)}

FAILED = []


def check(name: str, ok: bool, detail: str) -> None:
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        FAILED.append(name)


@contextlib.contextmanager
def timed(phase: str):
    """Print a phase's wall seconds when it ends."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def attention_errors(att, B, S, H, D, dtype, impl, seed, direct=False, head_major=False, routes=("sm90", "wmma")):
    """Max |error| of the kernel path (impl) and of the plain version run in
    `dtype`, both against the plain version in float32, for out, lse, dq, dk,
    dv; the kernels the kernel path launched (counter -> count); and, with
    `direct`, the errors of the forward and backward kernels of `routes`
    launched directly on the same inputs (counter -> {name: error})."""
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
    before = {c: att.LAUNCHES[c] for c in COUNTERS}
    kern = run(lambda a, b, c: att.causal_attention(a, b, c, impl=impl), dtype)
    taken = {c: att.LAUNCHES[c] - before[c] for c in COUNTERS}
    # lse straight from the forward kernel, on pre-scaled q and the strided k, v
    qs = (q * torch.tensor(scale, dtype=dtype)).contiguous()
    o, lse = att.attention_fwd(qs, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    lse_ref = torch.logsumexp(scores.masked_fill(~causal, -math.inf), dim=-1)
    torch.cuda.synchronize()
    names = ("out", "dq", "dk", "dv")
    err_k = {n: (a - r).abs().max().item() for n, a, r in zip(names, kern, ref)}
    err_p = {n: (a - r).abs().max().item() for n, a, r in zip(names, plain, ref)}
    err_k["lse"] = (lse - lse_ref).abs().max().item()
    direct_err = {}
    if direct:
        for r in routes:
            direct_err[FWD_COUNTERS[r]] = {"out": (att._launch_fwd(r, qs, k, v)[0].float() - ref[0]).abs().max().item()}
        for r in routes:  # dq is the gradient of pre-scaled q: times scale (exact for a power of 2)
            c = BWD_COUNTERS[r]
            dq, dk, dv = att._launch_bwd(r, qs, k, v, o, lse, do)
            direct_err[c] = {n: (g.float() * f - want).abs().max().item()
                             for n, g, f, want in zip(("dq", "dk", "dv"), (dq, dk, dv), (scale, 1, 1), ref[1:])}
    torch.cuda.synchronize()
    return err_k, err_p, taken, direct_err


def check_route(att, taken, dtype, D, what):
    want = {FWD_COUNTERS[att._FWD_ROUTES[(dtype, D)]], BWD_COUNTERS[att._BWD_ROUTES[(dtype, D)]]}
    check(f"route {what}", taken == {c: int(c in want) for c in COUNTERS},
          f"launches {taken}, tables name {sorted(want)}")


def check_errors(what, ek, ep):
    """The kernel rule on the errors of one kernel path: out, dq, dk, dv
    within twice the plain bf16 version's error plus 1e-3, lse within 1e-4."""
    for n in ("out", "dq", "dk", "dv"):
        tol = 2 * ep[n] + 1e-3
        check(f"bf16 {n} {what}", ek[n] <= tol, f"kernel {ek[n]:.3e} plain-bf16 {ep[n]:.3e} tol {tol:.3e}")
    check(f"bf16 lse {what}", ek["lse"] <= 1e-4, f"{ek['lse']:.3e} tol 1e-4")


def check_direct(direct_err, ep, what):
    """The kernel rule on each kernel launched directly; its largest error."""
    for c, errs in direct_err.items():
        for n, e in errs.items():
            tol = 2 * ep[n] + 1e-3
            check(f"bf16 {n} {what} {c}", e <= tol, f"kernel {e:.3e} tol {tol:.3e}")
    return {c: max(errs.values()) for c, errs in direct_err.items()}


def kernel_phase(att):
    """The checks of phase 3; returns the errors of the D=64 kernels launched
    directly at the main path's shape, and the launches the float32 checks
    made (the wmma kernels' route), read with the counters reset before."""
    for i, (B, S, H, D) in enumerate(CHECK_SHAPES):
        for impl in ("splash", "flash"):
            ek, ep, taken, _ = attention_errors(att, B, S, H, D, torch.bfloat16, impl, seed=10 + i)
            check_route(att, taken, torch.bfloat16, D, f"bf16 B={B} S={S} H={H} D={D} impl={impl}")
            check_errors(f"B={B} S={S} H={H} D={D} impl={impl}", ek, ep)
    # q, k, v as head-major views: the kernels take any batch/seq/head strides
    for B, S, H, D in (CHECK_SHAPES[2], CHECK_SHAPES[3]):
        ek, ep, taken, _ = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=4, head_major=True)
        check_route(att, taken, torch.bfloat16, D, f"bf16 head-major B={B} S={S} H={H} D={D}")
        check_errors(f"head-major B={B} S={S} H={H} D={D}", ek, ep)
    # head dim 128: the sm90_d128 kernels and the wmma yardstick launched
    # directly on the same inputs
    B, S, H, D = CHECK_SHAPES[1]
    _, ep, _, direct_err = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=12, direct=True,
                                            routes=D128_ROUTES)
    check_direct(direct_err, ep, f"B={B} S={S} H={H} D={D}")
    # the main path's exact shape; these are the errors reported per kernel
    B, S, H, D = SLICE_ATTN
    ek, ep, taken, direct_err = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=1, direct=True)
    check_route(att, taken, torch.bfloat16, D, f"bf16 B={B} S={S} H={H} D={D} impl=auto")
    max_err = check_direct(direct_err, ep, f"B={B} S={S} H={H} D={D}")
    check_errors(f"B={B} S={S} H={H} D={D} impl=auto", ek, ep)
    for B, S, H, D in F32_CHECK_SHAPES:
        ek, _, taken, direct_err = attention_errors(att, B, S, H, D, torch.float32, "splash", seed=5, direct=True,
                                                    routes=("sm90_f32",))
        check_route(att, taken, torch.float32, D, f"f32 B={B} S={S} H={H} D={D}")
        for n, e in ek.items():
            check(f"f32 {n} B={B} S={S} H={H} D={D}", e <= 1e-4, f"{e:.3e} tol 1e-4")
        for c, errs in direct_err.items():
            for n, e in errs.items():
                check(f"f32 {n} B={B} S={S} H={H} D={D} {c}", e <= 1e-4, f"{e:.3e} tol 1e-4")
    return max_err


def determinism_phase(att):
    """Each routed backward twice on the same inputs: dq, dk and dv must be
    byte-equal, since every backward adds dq in the order of the key tiles
    (the reference's runs are bit-identical).  The wmma yardstick, whose dq
    sums by atomics in no fixed order, is run the same way for contrast."""
    for route, (B, S, H, D) in (*DETERMINISM_SHAPES.items(), ("wmma", DETERMINISM_SHAPES["sm90_f32"])):
        dtype = torch.bfloat16 if route in ("sm90", "sm90_d128") else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(9)
        q, k, v = qkv_views(B, S, H, D, dtype, gen)
        do = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
        qs = (q * torch.tensor(D**-0.5, dtype=dtype)).contiguous()
        o, lse = att._launch_fwd(route, qs, k, v)
        first = att._launch_bwd(route, qs, k, v, o, lse, do)
        second = att._launch_bwd(route, qs, k, v, o, lse, do)
        torch.cuda.synchronize()
        differ = {n: int((a.view(torch.uint8) != b.view(torch.uint8)).sum()) for n, a, b in zip(("dq", "dk", "dv"), first, second)}
        what = f"{route} backward twice, {str(dtype)[6:]} B={B} S={S} H={H} D={D}"
        if route == "wmma":
            print(f"determinism {what} (yardstick, atomics): bytes differing {differ}", flush=True)
        else:
            check(f"determinism {what}: dq, dk, dv byte-equal", not any(differ.values()), f"bytes differing {differ}")


def attention_bounds(B, S, H, D, elem=2, peak=BF16_PEAK_FLOPS):
    """Least time (ms) of the causal forward and backward on this card:
    operations over `peak` (the bf16 peak; float32's for the float32
    kernels) vs bytes over HBM bandwidth at `elem` bytes an element.  Each
    input read once and each output written once; operations counted over
    the S(S+1)/2 causal (query, key) pairs."""
    pairs = B * H * S * (S + 1) / 2
    t = B * S * H * D * elem
    lse = B * H * S * 4
    fwd_flops, fwd_bytes = 4 * D * pairs, 4 * t + lse  # QK^T, PV; reads q,k,v, writes o, lse
    bwd_flops = 10 * D * pairs  # QK^T, dO V^T, P^T dO, dS^T Q, dS K
    bwd_bytes = 8 * t + lse  # reads q,k,v,o,dO,lse; writes dq,dk,dv
    out = {}
    for name, flops, nbytes in (("causal_attention_fwd", fwd_flops, fwd_bytes),
                                ("causal_attention_bwd", bwd_flops, bwd_bytes)):
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def attention_flops(B, S, H, D, products=2):
    """FLOP of `products` causal products of depth D over the S(S+1)/2
    pairs: 2 for the forward (Q K^T, P V), 5 for the backward."""
    return 2 * products * D * B * H * S * (S + 1) / 2


def route_peak(route, dtype):
    """The peak FLOP/s of the units a kernel runs its products on: bf16
    tensor cores; for float32, 3xTF32 on the tensor cores (sm90_f32) or the
    FP32 CUDA cores (the wmma kernels' float32 path)."""
    if dtype != torch.float32:
        return BF16_PEAK_FLOPS
    return F32_3XTF32_PEAK_FLOPS if route == "sm90_f32" else FP32_PEAK_FLOPS


def graph_ms(fn, launches=20, replays=10):
    """Device ms of one call of `fn`: `launches` calls captured in one CUDA
    graph and replayed `replays` times between two events, so that the
    host's launch rate, which bounds a small shape's event timing, does not
    enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def timing_phase(att, shape=SLICE_ATTN, routes=("sm90", "wmma"), dtype=torch.bfloat16):
    """Kernel, plain-version and SDPA times (ms) of the forward and backward
    kernels of `routes` at `shape` (B, S, H, D) in `dtype`, and each
    kernel's bound (at the peak of the units it runs on, `route_peak`; 4
    bytes an element for float32)."""
    B, S, H, D = shape
    fwd_counters = {r: FWD_COUNTERS[r] for r in routes}
    bwd_counters = {r: BWD_COUNTERS[r] for r in routes}
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv_views(B, S, H, D, dtype, gen)
    do = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
    qs = (q * torch.tensor(D**-0.5, dtype=dtype)).contiguous()
    o, lse = att.attention_fwd(qs, k, v)
    times = {c: cuda_ms(lambda r=r: att._launch_fwd(r, qs, k, v)) for r, c in fwd_counters.items()}
    times.update({c: cuda_ms(lambda r=r: att._launch_bwd(r, qs, k, v, o, lse, do)) for r, c in bwd_counters.items()})
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = att.plain_causal_attention(*leaves, D**-0.5)
    plain_fwd = cuda_ms(lambda: att.plain_causal_attention(q, k, v, D**-0.5))
    plain = {c: plain_fwd for c in fwd_counters.values()}
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True))
    plain.update(dict.fromkeys(bwd_counters.values(), plain_bwd))
    del plain_out
    # library yardstick: one PyTorch call computing the same function, [B,H,S,D]
    lq, lk, lv = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    ldo = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(lq, lk, lv, is_causal=True)
    lib_fwd = cuda_ms(lambda: sdpa(lq, lk, lv, is_causal=True))
    library = {c: lib_fwd for c in fwd_counters.values()}
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), ldo, retain_graph=True))
    library.update(dict.fromkeys(bwd_counters.values(), lib_bwd))
    bounds, peaks = {}, {}
    for r in routes:
        peaks[FWD_COUNTERS[r]] = peaks[BWD_COUNTERS[r]] = route_peak(r, dtype)
        bound = attention_bounds(B, S, H, D, elem=dtype.itemsize, peak=peaks[FWD_COUNTERS[r]])
        bounds[FWD_COUNTERS[r]] = bound["causal_attention_fwd"]
        bounds[BWD_COUNTERS[r]] = bound["causal_attention_bwd"]
    for name in times:
        print(f"time {name} {str(dtype)[6:]} B={B} S={S} H={H} D={D}: kernel {times[name]:.4f} ms, plain {plain[name]:.4f} ms, "
              f"sdpa {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}); "
              f"{bounds[name][0] / times[name]:.1%} of the bound, {times[name] / library[name]:.2f}x sdpa", flush=True)
    for c in times:
        flops = attention_flops(B, S, H, D, products=2 if c in fwd_counters.values() else 5)
        print(f"rate {c} {str(dtype)[6:]}: {flops / times[c] / 1e9:.1f} TFLOP/s "
              f"({flops / times[c] / 1e9 / (peaks[c] / 1e12):.1%} of its {peaks[c] / 1e12:.1f} TFLOP/s peak)", flush=True)
    return times, plain, library, bounds


SLICE_BATCH, SLICE_WARMUP, SLICE_STEPS = 18, 2, 10  # (b) and (e)


def slice_batches(cfg, batch):
    """(a)'s batch-2 batch, then the main path's: both drawn, in this order,
    from one CUDA generator seeded 1, so that (e)'s worker draws (b)'s batch."""
    from ray_tpu_torch.models.lm_train import synthetic_batch

    gen = torch.Generator(device="cuda").manual_seed(1)
    small = synthetic_batch(gen, 2, cfg.block_size, cfg.vocab_size)
    return small, synthetic_batch(gen, batch, cfg.block_size, cfg.vocab_size)


def timed_steps(bundle, params, opt, tok, tgt, warmup, steps):
    """warmup + steps training steps; (losses, seconds of the timed steps)."""
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
    return [x.item() for x in losses], time.perf_counter() - t0


def slice_phase(att, card):
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step

    cfg = GPT2Config.gpt2_124m()
    batch, warmup, steps = SLICE_BATCH, SLICE_WARMUP, SLICE_STEPS
    (tok, tgt), (tok_b, tgt_b) = slice_batches(cfg, batch)

    # (a) one step at batch 2 from identical weights: kernels vs plain attention
    metrics = {}
    for impl in ("auto", "xla"):
        bundle = make_train_step(GPT2Model(dataclasses.replace(cfg, attention_impl=impl), seed=0))
        params, opt = bundle.init(0)
        m = bundle.step(params, opt, tok, tgt)[2]  # no name keeps this optimizer alive into (b)
        metrics[impl] = (m["loss"].item(), m["grad_norm"].item())
        del bundle, params, opt
    (lk, gk), (lp, gp) = metrics["auto"], metrics["xla"]
    check("slice (a) loss kernel vs plain", abs(lk - lp) <= 1e-3 * abs(lp), f"{lk:.6f} vs {lp:.6f}")
    check("slice (a) grad_norm kernel vs plain", abs(gk - gp) <= 1e-2 * abs(gp), f"{gk:.6f} vs {gp:.6f}")

    # (b) the main path: 2 warm-up + 10 timed steps at bench batch 18
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    losses, dt = timed_steps(bundle, params, opt, tok_b, tgt_b, warmup, steps)
    launches = dict(att.LAUNCHES)
    ms_step = dt / steps * 1e3
    tok_s = batch * cfg.block_size * steps / dt
    mfu = tok_s * cfg.flops_per_token() / BF16_PEAK_FLOPS
    print(f"slice GPT-2 124M B={batch} S={cfg.block_size} remat={cfg.remat} policy {cfg.remat_policy!r} on {card}: "
          f"{ms_step:.2f} ms/step, {tok_s:.0f} tokens/s, model FLOP/s {100 * mfu:.2f}% of bf16 peak, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"slice losses {['%.4f' % x for x in losses]}", flush=True)
    check("slice (b) losses finite", all(math.isfinite(x) for x in losses), f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    check("slice (b) loss falls", losses[-1] < losses[0], f"first {losses[0]:.4f} last {losses[-1]:.4f}")
    check_launches("slice (c)", cfg, launches, warmup + steps)
    return launches, {"losses": losses, "tokens_per_s": tok_s}


def fwd_per_step(cfg):
    """Forward attention launches per GPT-2 step: one per layer, two under
    full remat ("dots" and "lite" keep the attention op's outputs)."""
    full = cfg.remat and cfg.remat_policy not in ("dots", "lite")
    return (2 if full else 1) * cfg.n_layer


def check_launches(what, cfg, launches, total):
    """Every forward and backward launch of `total` steps was on the sm90 kernels."""
    per_fwd = fwd_per_step(cfg)
    check(f"{what} forward launches", launches["causal_attention_fwd"] == per_fwd * total,
          f"{launches['causal_attention_fwd']} for {total} steps")
    check(f"{what} forward launches on the sm90 kernel",
          launches["causal_attention_fwd_sm90"] == per_fwd * total and launches["causal_attention_fwd_wmma"] == 0,
          f"sm90 {launches['causal_attention_fwd_sm90']}, wmma {launches['causal_attention_fwd_wmma']}")
    check(f"{what} backward launches", launches["causal_attention_bwd"] == cfg.n_layer * total,
          f"{launches['causal_attention_bwd']} for {total} steps")
    check(f"{what} backward launches on the sm90 kernel",
          launches["causal_attention_bwd_sm90"] == cfg.n_layer * total and launches["causal_attention_bwd_wmma"] == 0,
          f"sm90 {launches['causal_attention_bwd_sm90']}, wmma {launches['causal_attention_bwd_wmma']}")


def trainer_loop(config):
    """(e)'s train loop, run by TorchTrainer in the GPU worker actor: (b)'s
    model, weights, batch and steps; the launch counters reset just before
    the steps and read just after; one report."""
    import os
    import sys

    import torch  # a local name: cloudpickle cannot ship torch.backends.cudnn by reference

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step
    from ray_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False  # as in the driver (phase 1)
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config.gpt2_124m()
    batch, warmup, steps = config["batch"], config["warmup"], config["steps"]
    _, (tok, tgt) = slice_batches(cfg, batch)
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    losses, dt = timed_steps(bundle, params, opt, tok, tgt, warmup, steps)
    launches = dict(att.LAUNCHES)
    session.report({
        "tokens_per_s": batch * cfg.block_size * steps / dt,
        "ms_per_step": dt / steps * 1e3,
        "losses": losses,
        "launches": launches,
        "device": torch.cuda.get_device_name(),
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "forbidden_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    })


def pool_probe():
    """Runs in a pool worker (no GPU asked): what it sees of the card."""
    import os

    from ray_tpu_torch import resolve_device

    try:
        resolve_device()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"), "resolve_device_raised": raised}


def _proc_stat(pid):
    """(state, parent pid, start time) of a live process, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return fields[0], int(fields[1]), int(fields[19])


def session_processes(root):
    """{pid: start time} of `root` and every live process below it, read
    from /proc: this run's cluster, never another checkout's."""
    stats = {int(e): st for e in os.listdir("/proc") if e.isdigit() and (st := _proc_stat(e))}
    out, stack = {}, [root]
    while stack:
        pid = stack.pop()
        if pid in stats and stats[pid][0] != "Z":
            out[pid] = stats[pid][2]
        stack.extend(p for p, st in stats.items() if st[1] == pid)
    return out


def leftover(cluster, before):
    """Processes of `cluster` ({pid: start time}, taken before shutdown)
    still alive, and any process below this script that was not there
    before the phase (`before`, the same kind of map)."""
    alive = {p for p, t in cluster.items() if (st := _proc_stat(p)) and st[0] != "Z" and st[2] == t}
    new = {p for p, t in session_processes(os.getpid()).items() if before.get(p) != t} - {os.getpid()}
    return sorted(alive | new)


def await_no_leftover(what, cluster, before):
    """Wait up to 15 s for the cluster to go, then check that it went."""
    deadline = time.monotonic() + 15
    while leftover(cluster, before) and time.monotonic() < deadline:
        time.sleep(0.5)
    left = leftover(cluster, before)
    check(f"{what} shutdown leaves no ray_tpu_torch process", not left,
          f"{len(cluster)} processes in the cluster before shutdown, alive after: {left}")


def trainer_phase(kind, card, direct):
    """(e): GPT-2 124M through ray_tpu_torch.init → TorchTrainer → a GPU
    worker actor, held against (b), the same steps in this process."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    from ray_tpu_torch._private.worker import global_worker

    cfg = GPT2Config.gpt2_124m()
    torch.cuda.empty_cache()  # the worker needs the card's memory, not this process
    before = session_processes(os.getpid())
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        check("trainer (e) cluster counts one GPU", gpus == 1, f"cluster_resources GPU = {gpus}")
        result = TorchTrainer(
            trainer_loop,
            train_loop_config={"batch": SLICE_BATCH, "warmup": SLICE_WARMUP, "steps": SLICE_STEPS},
            scaling_config=ScalingConfig(num_workers=1),
        ).fit()
        pool = ray_tpu_torch.get(ray_tpu_torch.remote(pool_probe).remote(), timeout=120)
    finally:
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    fit_s = time.perf_counter() - t0
    m = result.metrics
    losses, launches = m["losses"], m["launches"]
    ratio = m["tokens_per_s"] / direct["tokens_per_s"]
    print(f"trainer (e) GPT-2 124M B={SLICE_BATCH} S={cfg.block_size} through TorchTrainer on {card}: "
          f"{m['ms_per_step']:.2f} ms/step, {m['tokens_per_s']:.0f} tokens/s, {ratio:.4f} of slice (b)'s "
          f"{direct['tokens_per_s']:.0f}; peak memory {m['peak_memory_gib']:.2f} GiB; init + fit + shutdown "
          f"{fit_s:.1f} s", flush=True)
    print(f"trainer (e) worker pid {m['pid']} (driver {os.getpid()}), device {m['device']}, "
          f"CUDA_VISIBLE_DEVICES={m['cuda_visible_devices']!r}, jax/ray_tpu modules {m['forbidden_modules']}", flush=True)
    print(f"trainer (e) losses {['%.4f' % x for x in losses]}", flush=True)
    print(f"trainer (e) launches {launches}", flush=True)
    print(f"trainer (e) pool task: CUDA_VISIBLE_DEVICES={pool['cuda_visible_devices']!r}, "
          f"resolve_device() raised: {pool['resolve_device_raised'][:80]!r}", flush=True)
    check("trainer (e) worker is another process", m["pid"] != os.getpid(), f"worker {m['pid']}, driver {os.getpid()}")
    check("trainer (e) worker on this card", m["device"] == kind, f"{m['device']!r} vs {kind!r}")
    check("trainer (e) worker loads no jax or ray_tpu module", m["forbidden_modules"] == [], f"{m['forbidden_modules']}")
    check_launches("trainer (e)", cfg, launches, SLICE_WARMUP + SLICE_STEPS)
    d0 = direct["losses"][0]
    check("trainer (e) first loss vs slice (b)", abs(losses[0] - d0) <= 1e-3 * abs(d0), f"{losses[0]:.6f} vs {d0:.6f}, difference {losses[0] - d0:.3e}")
    check("trainer (e) losses finite", all(math.isfinite(x) for x in losses), f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    check("trainer (e) loss falls", losses[-1] < losses[0], f"first {losses[0]:.4f} last {losses[-1]:.4f}")
    check("trainer (e) tokens/s >= 0.9 x slice (b)", ratio >= 0.9, f"ratio {ratio:.4f}")
    check("trainer (e) pool worker sees no card", pool["cuda_visible_devices"] == "" and bool(pool["resolve_device_raised"]),
          f"CUDA_VISIBLE_DEVICES={pool['cuda_visible_devices']!r}")
    await_no_leftover("trainer (e)", cluster, before)


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
    want = {**dict.fromkeys(COUNTERS, 0), "causal_attention_fwd_sm90_d128": 1, "causal_attention_bwd_sm90_d128": 1}
    check("path (d) D=128 launches on the sm90_d128 kernels", {c: launches[c] for c in COUNTERS} == want
          and launches["causal_attention_fwd"] == 1 and launches["causal_attention_bwd"] == 1, f"{launches}")
    return launches


LLAMA = "llama2_7b"  # LlamaConfig preset of (f) and (g): full width and depth, bf16 weights from seed 0
LLAMA_SEQ, LLAMA_NEW, LLAMA_BATCH = 256, 32, 8  # bench_serve.py's MAX_SEQ, NEW_TOKENS, MAX_BATCH
LLAMA_ATTN = (1, LLAMA_SEQ, 32, 128)  # B, S, H, D of Llama-2-7B's prefill attention
LLAMA_LONG_ATTN = (1, 2048, 32, 128)  # at LlamaConfig's default max_seq_len: training and long prefill
LLAMA_PROMPT = 7  # (f)'s B=1 prompt and (g)'s first request; LLAMA_PROMPT + b is row b at B=8
SERVE_LOADS = (4, 16, 32)  # offered concurrency, 4 x concurrency requests each (bench_serve.py)
REQUEST_TIMEOUT_S = 120  # each served request's own limit in (g) and (i): a stall fails the run
K4_OPS = ("aten::einsum", "aten::softmax", "aten::masked_fill")  # the decode attention over the cache


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_view(model, **changes):
    """`model` with its config changed (compute dtype, attention impl),
    sharing its parameters."""
    import copy

    view = copy.copy(model)
    object.__setattr__(view, "config", dataclasses.replace(model.config, **changes))
    return view


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def llama_loss_check(att, cfg, device, tokens):
    """(f)'s loss forward and backward at full width with 2 layers, so the
    head-dim-128 backward runs from the model: launch counters reset just
    before and read just after; kernels against the plain attention.
    `tokens` holds LLAMA_SEQ + 1 ids, so the attention runs at LLAMA_ATTN's
    S, the shape at which llama_kernel_phase checks and times the kernels."""
    from ray_tpu_torch.models.llama import LlamaModel

    model = LlamaModel(dataclasses.replace(cfg, n_layers=2), device=device, seed=1)
    out = {}
    for impl in ("xla", "auto"):
        view = model_view(model, attention_impl=impl)
        model.zero_grad(set_to_none=True)
        sync(device)
        att.reset_launch_counts()
        loss = view.loss(tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        sync(device)
        launches = dict(att.LAUNCHES)
        norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters())).item()
        out[impl] = (loss.item(), norm, launches)
    (lk, gk, launches), (lp, gp, _) = out["auto"], out["xla"]
    print(f"llama (f) loss 2 layers full width: kernels {lk:.6f} grad_norm {gk:.6f}; plain {lp:.6f} {gp:.6f}", flush=True)
    check("llama (f) loss kernels vs plain", abs(lk - lp) <= 1e-3 * abs(lp), f"{lk:.6f} vs {lp:.6f}")
    check("llama (f) grad_norm kernels vs plain", abs(gk - gp) <= 1e-2 * abs(gp), f"{gk:.6f} vs {gp:.6f}")
    L = 2
    check("llama (f) loss launches on the sm90_d128 kernels (remat: 2 forwards per layer)",
          launches["causal_attention_fwd_sm90_d128"] == 2 * L and launches["causal_attention_fwd"] == 2 * L
          and launches["causal_attention_bwd_sm90_d128"] == L and launches["causal_attention_bwd"] == L, f"{launches}")
    del model
    return launches


def decode_profile(llm, prompts):
    """torch.profiler over one generate: the device's idle share of that
    traced run's wall time (the profiler's own host cost included), and the
    decode attention's (K4_OPS) share of the device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, LLAMA_NEW)
        traced_ms = (time.perf_counter() - t0) * 1e3
    from ray_tpu_torch.tools.profile_train_step import busy_us

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

    def dev_ms(row):
        return getattr(row, "device_time_total", getattr(row, "cuda_time_total", 0.0)) / 1e3

    k4 = sum(dev_ms(r) for r in prof.key_averages() if r.key in K4_OPS)
    steps = prompts.shape[1] + LLAMA_NEW - 1
    check("llama (f) profile holds device kernels", bool(kernels), f"{len(kernels)} kernels")
    check("llama (f) profile: device busy within the traced wall", busy <= traced_ms,
          f"busy {busy:.1f} ms, traced {traced_ms:.1f} ms")
    return {
        "profiled_ms": traced_ms, "device_busy_ms": busy, "kernels_per_step": len(kernels) / steps,
        "idle_share": 1 - busy / traced_ms,
        "k4_ms_per_step": k4 / steps, "k4_share": k4 / device_ms if device_ms else 0.0,
    }


def llama_phase(att, card, model=LLAMA, device="cuda"):
    """(f): Llama on the card, direct.  Returns (launches of the kernels from
    apply and loss, a report dict, {B: generate's tokens} at B=1 and
    LLAMA_BATCH for (g))."""
    from ray_tpu_torch.serve.llm import ShardedLLM, _resolve_cfg, prefill

    device = torch.device(device)
    cfg = _resolve_cfg(model, LLAMA_SEQ)
    llm = ShardedLLM(cfg, init="random", seed=0, device=device)
    m = llm.model
    gen = torch.Generator(device=device).manual_seed(4)
    seq = torch.randint(0, cfg.vocab_size, (1, LLAMA_SEQ + 1), device=device, generator=gen)
    prompt = seq[:, :LLAMA_SEQ]
    report = {"params": llm.param_count(), "weight_bytes": llm.shard_stats()["total_bytes"]}
    with torch.no_grad():
        ref = model_view(m, compute_dtype=torch.float32, attention_impl="xla").apply(prompt).float()
        plain = model_view(m, attention_impl="xla").apply(prompt).float()
        sync(device)
        att.reset_launch_counts()
        kern = m.apply(prompt).float()
        sync(device)
        apply_launches = dict(att.LAUNCHES)
        pre_bf16 = prefill(m, m.init_cache(1), prompt)
        m32 = model_view(m, compute_dtype=torch.float32)
        pre_f32 = prefill(m32, m32.init_cache(1), prompt)
    e_plain, e_kern = max_err(plain, ref), max_err(kern, ref)
    e_plain_last, e_pre = max_err(plain[:, -1], ref[:, -1]), max_err(pre_bf16, ref[:, -1])
    e_pre32 = max_err(pre_f32, ref[:, -1])
    scale = ref.abs().max().item()
    report.update(apply_err=e_kern, apply_plain_err=e_plain, prefill_err=e_pre, prefill_f32_err=e_pre32,
                  logits_absmax=scale)
    print(f"llama (f) {model} S={LLAMA_SEQ} apply vs f32 plain reference (max|logit| {scale:.3f}): kernels "
          f"{e_kern:.3e}, plain bf16 {e_plain:.3e}; last position: prefill loop bf16 {e_pre:.3e} (plain "
          f"{e_plain_last:.3e}), prefill loop f32 {e_pre32:.3e}", flush=True)
    check("llama (f) apply kernels vs f32 reference", e_kern <= 2 * e_plain + 1e-3,
          f"{e_kern:.3e} tol {2 * e_plain + 1e-3:.3e}")
    check("llama (f) prefill loop (bf16) vs apply's f32 reference, last position", e_pre <= 2 * e_plain_last + 1e-3,
          f"{e_pre:.3e} tol {2 * e_plain_last + 1e-3:.3e}")
    check("llama (f) prefill loop (f32) vs apply (f32), last position", e_pre32 <= 2e-3 + 2e-3 * scale,
          f"{e_pre32:.3e} tol {2e-3 + 2e-3 * scale:.3e}")
    check("llama (f) apply launches on the sm90_d128 forward", apply_launches["causal_attention_fwd_sm90_d128"] == cfg.n_layers
          and apply_launches["causal_attention_fwd"] == cfg.n_layers and apply_launches["causal_attention_bwd"] == 0,
          f"{apply_launches}")
    del ref, plain, kern
    loss_launches = llama_loss_check(att, cfg, device, seq)
    launches = {c: apply_launches[c] + loss_launches[c] for c in COUNTERS}

    bound_ms = report["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    direct_tokens = {}
    for B in (1, LLAMA_BATCH):
        prompts = (LLAMA_PROMPT + torch.arange(B)).reshape(B, 1).numpy().astype("int32")
        llm.generate(prompts, LLAMA_NEW)  # warm-up
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        toks = llm.generate(prompts, LLAMA_NEW)
        wall = (time.perf_counter() - t0) * 1e3
        stamps = {}
        llm.generate(prompts, LLAMA_NEW, stage_cb=lambda ph: stamps.__setitem__(ph, time.perf_counter()))
        tpot = (stamps["serve_decode_end"] - stamps["serve_first_token"]) * 1e3 / (LLAMA_NEW - 1)
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0
        step_ms = wall / (prompts.shape[1] + LLAMA_NEW - 1)
        report[f"b{B}"] = {"ms_per_step": step_ms, "tpot_ms": tpot, "bound_share": bound_ms / step_ms,
                           "tokens_per_s": B * LLAMA_NEW / wall * 1e3, "peak_memory_gib": peak}
        print(f"llama (f) generate B={B} P=1 new={LLAMA_NEW} on {card}: {step_ms:.3f} ms/step, decode "
              f"{tpot:.3f} ms/token after the first, {B * LLAMA_NEW / wall * 1e3:.1f} tokens/s; weight-bytes bound "
              f"{bound_ms:.3f} ms/step, {bound_ms / step_ms:.1%} of it; peak memory {peak:.2f} GiB", flush=True)
        check(f"llama (f) generate B={B} tokens", toks.shape == (B, LLAMA_NEW) and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
              f"shape {toks.shape}")
        direct_tokens[B] = toks.tolist()
        if B == LLAMA_BATCH:
            report["profile"] = prof = decode_profile(llm, prompts)
            print(f"llama (f) profile generate B={B}: {prof['profiled_ms']:.1f} ms traced (unprofiled {wall:.1f} ms), "
                  f"device busy {prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%} of the traced run's "
                  f"wall; {prof['kernels_per_step']:.0f} "
                  f"kernels/step; decode attention over the cache ({'+'.join(K4_OPS)}) {prof['k4_ms_per_step']:.4f} "
                  f"ms/step, {prof['k4_share']:.1%} of device time", flush=True)
    report["bound_ms"] = bound_ms
    del llm, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, report, direct_tokens


def graph_times(att, shape, routes, dtype=torch.bfloat16):
    """graph_ms of the forward and backward kernels of `routes` at `shape`."""
    B, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv_views(B, S, H, D, dtype, gen)
    do = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
    qs = (q * torch.tensor(D**-0.5, dtype=dtype)).contiguous()
    o, lse = att.attention_fwd(qs, k, v)
    out = {FWD_COUNTERS[r]: graph_ms(lambda r=r: att._launch_fwd(r, qs, k, v)) for r in routes}
    out.update({BWD_COUNTERS[r]: graph_ms(lambda r=r: att._launch_bwd(r, qs, k, v, o, lse, do)) for r in routes})
    return out


def llama_kernel_phase(att):
    """The head-dim-128 kernels (sm90_d128, and the wmma yardstick) at
    Llama-2-7B's prefill shape and at its long shape: launched directly on
    the same inputs and checked against the float32 plain version, the
    route through causal_attention checked too, then timed beside the plain
    version and SDPA; the sm90_d128 kernels must beat the wmma ones, in
    device time by CUDA-graph replay (at S=256 event timing of single
    launches reads the host's launch rate).
    {shape: (max_err, times, plain, library, bounds)}."""
    out = {}
    for shape, seed in ((LLAMA_ATTN, 6), (LLAMA_LONG_ATTN, 7)):
        B, S, H, D = shape
        what = f"B={B} S={S} H={H} D={D}"
        ek, ep, taken, direct_err = attention_errors(att, B, S, H, D, torch.bfloat16, "auto", seed=seed, direct=True,
                                                     routes=D128_ROUTES)
        check_route(att, taken, torch.bfloat16, D, f"bf16 {what} impl=auto (Llama)")
        check_errors(f"{what} impl=auto (Llama)", ek, ep)
        max_err = check_direct(direct_err, ep, what)
        times, plain, library, bounds = timing_phase(att, shape, routes=D128_ROUTES)
        graph = graph_times(att, shape, D128_ROUTES)
        for counters in (FWD_COUNTERS, BWD_COUNTERS):
            new, old = counters["sm90_d128"], counters["wmma"]
            check(f"{new} faster than {old} at {what} (graph replay)", graph[new] < graph[old],
                  f"{graph[new]:.4f} ms vs {graph[old]:.4f} ms by graph replay; single launches {times[new]:.4f} "
                  f"vs {times[old]:.4f} ms")
        out[shape] = (max_err, times, plain, library, bounds)
    return out


def llama_process_libs(pid):
    """Shared libraries mapped by process `pid`: (any of jax's, CUDA's runtime)."""
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    return any("/jaxlib/" in p or "/jax/" in p for p in paths), any("libcuda" in p for p in paths)


def stall(what, deployment, detail, handle=None):
    """A served request outlived its limit: print what the head holds of
    the deployment's stages (its newest sealed request records, each with
    its stage durations; a stalled request seals only when it returns) and
    the engine's state where the deployment runs one, then fail the run."""
    import ray_tpu_torch
    from ray_tpu_torch.experimental.state import summarize_workloads

    try:
        records = [r for r in summarize_workloads("serve", limit=64).get("records", [])
                   if r.get("name") == f"serve:{deployment}"][-8:]
        for rec in records:
            stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in rec.get("durations", {}).items())
            print(f"{what} stage trace of a recent request: {stages}", flush=True)
        if handle is not None:
            stats = ray_tpu_torch.get(handle.method("engine_stats").remote(), timeout=30)
            print(f"{what} engine state: {stats}", flush=True)
    except Exception as e:  # noqa: BLE001 -- the report is best-effort; the stall fails the run either way
        print(f"{what} stage trace unavailable: {type(e).__name__}: {e}", flush=True)
    check(f"{what} every request answered within {REQUEST_TIMEOUT_S} s", False, detail)
    raise TimeoutError(f"{what}: {detail}")


def served(ref, what, deployment, t_sent, timeout, handle=None):
    """One served request's result, within `timeout` of when it was sent."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import GetTimeoutError

    try:
        return ray_tpu_torch.get(ref, timeout=max(0.0, t_sent + timeout - time.perf_counter()))
    except GetTimeoutError:
        stall(what, deployment, f"a request sent {time.perf_counter() - t_sent:.1f} s ago has not returned", handle)


def offered_load(conc, total, request, what, deployment, timeout, engine=None):
    """`total` requests at offered concurrency `conc` (`request(i)` sends the
    i-th and returns its ref), each bounded by `timeout`: {ref index:
    (latency s, result)}, and the wall seconds."""
    import ray_tpu_torch

    done, inflight, i = {}, {}, 0
    start = time.perf_counter()
    while len(done) < total:
        while len(inflight) < conc and i < total:
            inflight[request(i)] = (i, time.perf_counter())
            i += 1
        ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1, timeout=1.0)
        for r in ready:
            idx, t_sent = inflight.pop(r)
            done[idx] = (time.perf_counter() - t_sent, served(r, what, deployment, t_sent, timeout, engine))
        oldest = min((t for _, t in inflight.values()), default=time.perf_counter())
        if time.perf_counter() - oldest > timeout:
            stall(what, deployment, f"concurrency {conc}: a request sent {time.perf_counter() - oldest:.1f} s ago "
                  f"has not returned; {len(done)} of {total} answered", engine)
    return done, time.perf_counter() - start


def serve_phase(kind, card, direct_tokens, model=LLAMA, device="cuda", timeout=REQUEST_TIMEOUT_S):
    """(g): ray_tpu_torch.init → serve.run(llm_deployment(...)) → handle →
    controller → GPU replica → @serve.batch → ShardedLLM.  `direct_tokens`
    is (f)'s {B: tokens}: one request must equal its B=1 row, and
    LLAMA_BATCH requests sent at once (one batch) each their B=LLAMA_BATCH
    row.  Every request must return within `timeout` of being sent.
    Returns a report."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import summarize_workloads
    from ray_tpu_torch.serve.llm import llm_deployment

    report = {"loads": {}}
    before = session_processes(os.getpid())
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        check("serve (g) cluster counts one GPU", gpus == 1, f"cluster_resources GPU = {gpus}")
        dep = llm_deployment(model, max_seq_len=LLAMA_SEQ, new_tokens=LLAMA_NEW, max_batch_size=LLAMA_BATCH,
                             num_gpus=1, device=device)
        handle = serve.run(dep.bind())
        first = served(handle.remote(LLAMA_PROMPT), "serve (g)", "llm", time.perf_counter(), timeout)
        report["first_request_s"], report["first"] = time.perf_counter() - t0, first
        info = ray_tpu_torch.get(serve.get_deployment_handle("llm").method("info").remote(), timeout=60)
        jax_mapped, cuda_mapped = llama_process_libs(info["pid"])
        with open(f"/proc/{info['pid']}/cmdline") as f:
            cmdline = f.read().replace("\0", " ")
        print(f"serve (g) replica pid {info['pid']} (driver {os.getpid()}): {cmdline.strip()[:120]}; device "
              f"{info['device']}, {info['params_b']} B params, CUDA runtime mapped {cuda_mapped}, jax mapped {jax_mapped}; "
              f"first request answered {report['first_request_s']:.1f} s after init", flush=True)
        check("serve (g) replica is another process on this card", info["pid"] != os.getpid() and info["device"] == kind
              and "ray_tpu_torch.core.worker_main" in cmdline, f"pid {info['pid']}, device {info['device']!r}")
        check("serve (g) replica loads no jax", not jax_mapped, "jax/jaxlib libraries mapped" if jax_mapped else "none")
        direct1 = direct_tokens[1][0]
        check("serve (g) one request equals (f)'s direct B=1 generate", first == direct1,
              f"served {first[:8]}..., direct {direct1[:8]}...")
        # the replica idles, so @serve.batch coalesces requests that arrive
        # within its 20 ms wait, in arrival order, into one batch of LLAMA_BATCH
        t_send = time.perf_counter()
        refs = [handle.remote(LLAMA_PROMPT + b) for b in range(LLAMA_BATCH)]
        send_ms = (time.perf_counter() - t_send) * 1e3
        batch = [served(r, "serve (g)", "llm", t_send, timeout) for r in refs]
        report["batch"] = batch
        wrong = [b for b in range(LLAMA_BATCH) if batch[b] != direct_tokens[LLAMA_BATCH][b]]
        print(f"serve (g) {LLAMA_BATCH} requests sent at once (in {send_ms:.1f} ms): rows differing from "
              f"(f)'s B={LLAMA_BATCH} generate {wrong}", flush=True)
        check(f"serve (g) {LLAMA_BATCH} requests at once each equal their row of (f)'s B={LLAMA_BATCH} generate",
              not wrong, f"rows {wrong} differ; sent in {send_ms:.1f} ms")
        for conc in SERVE_LOADS:
            total = 4 * conc
            done, dt = offered_load(conc, total, handle.remote, "serve (g)", "llm", timeout)
            lat = [t for t, toks in done.values() if len(toks) == LLAMA_NEW]
            bad = total - len(lat)
            lat_ms = np.asarray(lat) * 1e3 if lat else np.zeros(1)
            row = {"requests": total, "answered": len(lat), "tokens_per_s": len(lat) * LLAMA_NEW / dt,
                   "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99))}
            report["loads"][conc] = row
            print(f"serve (g) concurrency {conc}: {total} requests in {dt:.2f} s, {row['tokens_per_s']:.1f} tokens/s, "
                  f"p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms", flush=True)
            check(f"serve (g) concurrency {conc}: every request answered with {LLAMA_NEW} tokens",
                  len(lat) == total and bad == 0, f"{len(lat)} of {total}, {bad} short")
        summary, deadline = {}, time.perf_counter() + 60
        while time.perf_counter() < deadline:  # records ship batched: a later request flushes the tail
            summary = summarize_workloads("serve")
            if "llm" in summary.get("ttft", {}) and "llm" in summary.get("tpot", {}):
                break
            served(handle.remote(LLAMA_PROMPT), "serve (g)", "llm", time.perf_counter(), timeout)
            time.sleep(0.3)
        ttft, tpot = summary.get("ttft", {}).get("llm"), summary.get("tpot", {}).get("llm")
        report.update(ttft=ttft, tpot=tpot)
        if ttft and tpot:
            print(f"serve (g) summarize_workloads('serve'): {summary.get('total_records')} records; TTFT p50 "
                  f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; TPOT p50 {tpot['p50'] * 1e3:.3f} ms "
                  f"p99 {tpot['p99'] * 1e3:.3f} ms", flush=True)
        check("serve (g) TTFT and TPOT in summarize_workloads('serve')", bool(ttft and tpot and ttft["count"] and tpot["count"]),
              f"ttft {ttft}, tpot {tpot}")
        serve.shutdown()
    finally:
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    report["seconds"] = time.perf_counter() - t0
    await_no_leftover("serve (g)", cluster, before)
    return report


ENGINE_SLOTS, ENGINE_PAGE, ENGINE_CHUNK = 8, 16, 32  # (i): num_slots, page_size, prefill_chunk
ENGINE_LENGTHS = (1, 5, 31, 32, 33, 64, 100, 200)  # (i1)'s prompt lengths, repeated to ENGINE_REQUESTS
ENGINE_REQUESTS = 12  # (i1): submitted at once, 16 or 32 new tokens in turn
ENGINE_PROMPTS = 8  # (i2): distinct prompts, lengths drawn from the seed in 1..200; each request draws one
ENGINE_MAX_QUEUE = 32  # (i2)'s admission bound: above concurrency 32 less the 8 slots; the burst overflows it
ENGINE_SEED = 5
BF16_EPS = 2.0**-7  # torch.finfo(torch.bfloat16).eps


def engine_config(**changes):
    from ray_tpu_torch.serve.engine import EngineConfig

    return EngineConfig(num_slots=ENGINE_SLOTS, page_size=ENGINE_PAGE, max_seq_len=LLAMA_SEQ,
                        prefill_chunk=ENGINE_CHUNK, max_new_tokens=LLAMA_NEW, **changes)


def top2_gap(model, prompt, tokens, position):
    """The direct path's choice at `position` of its `tokens` after
    `prompt`, recomputed in float32 (plain attention): (top-2 logit gap,
    |top logit|)."""
    ctx = torch.tensor([list(prompt) + list(tokens[:position])], device=model.device)
    with torch.no_grad():
        logits = model_view(model, compute_dtype=torch.float32, attention_impl="xla").apply(ctx)[0, -1].float()
    top = logits[: model.config.vocab_size].topk(2).values
    return (top[0] - top[1]).item(), top[0].abs().item()


def first_difference(got, want):
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))


def engine_check_phase(card, model=LLAMA, device="cuda"):
    """(i1): the continuous-batching engine in this process, Llama-2-7B's
    full widths with 2 layers in float32, seeded weights: ENGINE_REQUESTS
    requests of mixed prompt lengths submitted at once must each give the
    tokens of ShardedLLM.generate of its prompt alone, with one input shape
    per program."""
    from ray_tpu_torch.serve.engine import InferenceEngine
    from ray_tpu_torch.serve.llm import ShardedLLM, _resolve_cfg

    device = torch.device(device)
    cfg = dataclasses.replace(_resolve_cfg(model, LLAMA_SEQ), n_layers=2, compute_dtype=torch.float32,
                              param_dtype=torch.float32)
    llm = ShardedLLM(cfg, init="random", seed=0, device=device)
    rng = np.random.default_rng(ENGINE_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, ENGINE_LENGTHS[i % len(ENGINE_LENGTHS)]).tolist()
               for i in range(ENGINE_REQUESTS)]
    news = [(16, 32)[i % 2] for i in range(ENGINE_REQUESTS)]
    eng = InferenceEngine(llm, engine_config(), deployment="i1")
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
        outs = [r.sink.result(timeout=REQUEST_TIMEOUT_S) for r in reqs]
        wall = time.perf_counter() - t0
        stats, shapes = eng.stats(), eng.compile_stats()
    finally:
        eng.shutdown()
    direct = [llm.generate(np.asarray([p], np.int32), n)[0].tolist() for p, n in zip(prompts, news)]
    wrong = [i for i in range(ENGINE_REQUESTS) if outs[i] != direct[i]]
    for i in wrong:
        pos = first_difference(outs[i], direct[i])
        gap, top = top2_gap(llm.model, prompts[i], direct[i], pos)
        print(f"engine (i1) request {i} (prompt {len(prompts[i])}) differs at token {pos}: direct top-2 gap "
              f"{gap:.3e} at |logit| {top:.3f}", flush=True)
    tokens = sum(news)
    print(f"engine (i1) {cfg.dim} wide, {cfg.n_layers} layers, float32, on {card}: {ENGINE_REQUESTS} requests "
          f"(prompts {[len(p) for p in prompts]}) in {wall:.2f} s, {tokens / wall:.1f} tokens/s, "
          f"{stats['iterations']:.0f} iterations; pool {stats['pages_total']:.0f} pages of {ENGINE_PAGE}; "
          f"input shapes per program {shapes}", flush=True)
    check("engine (i1) every request equals generate of its prompt alone", not wrong,
          f"requests differing: {wrong}")
    check("engine (i1) one input shape per program", shapes == {"prefill": 1, "decode": 1}, f"{shapes}")
    check("engine (i1) pool empty after the run", stats["pages_used"] == 0 and stats["requests_done"] == ENGINE_REQUESTS,
          f"pages used {stats['pages_used']}, done {stats['requests_done']}")
    del llm
    if device.type == "cuda":
        torch.cuda.empty_cache()


def engine_request(handle, prompt, stream, what, timeout):
    """One request to the engine deployment, buffered or streamed:
    (tokens, seconds, seconds to the first frame or None, frames)."""
    t0 = time.perf_counter()
    if not stream:
        toks = served(handle.remote({"prompt": prompt}), what, "llm", t0, timeout)
        return toks, time.perf_counter() - t0, None, 1
    from ray_tpu_torch.exceptions import EngineStreamError

    toks, first, frames = [], None, 0
    try:
        for frame in handle.stream_tokens({"prompt": prompt}, timeout=timeout):
            first = first or time.perf_counter() - t0
            toks += frame
            frames += 1
            if time.perf_counter() - t0 > timeout:
                stall(what, "llm", f"a stream open {time.perf_counter() - t0:.1f} s has {len(toks)} tokens")
    except EngineStreamError as e:
        if "stalled" not in str(e):
            raise
        stall(what, "llm", f"a stream with {len(toks)} tokens: {e}")
    return toks, time.perf_counter() - t0, first, frames


def engine_load(handle, engine, conc, picks, pool, what, timeout):
    """len(picks) requests at offered concurrency `conc`, every other one
    streamed; the pool's pages in use sampled meanwhile.  (rows, wall
    seconds, most pages used)."""
    import concurrent.futures as cf

    import ray_tpu_torch

    pages = 0.0
    start = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=conc) as ex:
        futs = [ex.submit(engine_request, handle, pool[p], i % 2 == 1, what, timeout) for i, p in enumerate(picks)]
        while not all(f.done() for f in futs):
            cf.wait(futs, timeout=0.5)
            stats = ray_tpu_torch.get(engine.method("engine_stats").remote(), timeout=30)
            pages = max(pages, stats["pages_used"])
        rows = [(p, i % 2 == 1, *f.result()) for i, (p, f) in enumerate(zip(picks, futs))]
    return rows, time.perf_counter() - start, pages


def sse_request(url, prompt, timeout):
    """One SSE stream through the proxy: (tokens, frames, saw the done event)."""
    import urllib.request

    req = urllib.request.Request(f"{url}/llm?stream=sse", data=json.dumps({"prompt": prompt}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype, body = r.headers["Content-Type"], r.read().decode()
    frames = [json.loads(line[len("data: "):])["t"] for line in body.splitlines() if line.startswith('data: {"t"')]
    return [t for f in frames for t in f], len(frames), ctype.startswith("text/event-stream") and "event: done" in body


def overload_burst(handle, url, prompt, what, timeout):
    """Requests beyond the slots and the admission queue, then one HTTP
    request while they wait: (its status and Retry-After, answered,
    rejected with EngineOverloadedError)."""
    import urllib.error
    import urllib.request

    from ray_tpu_torch.exceptions import EngineOverloadedError
    from ray_tpu_torch.serve.handle import _unwrap_cause

    refs, status, deadline = [], None, time.perf_counter() + 30
    while status != 503 and time.perf_counter() < deadline:
        t_sent = time.perf_counter()
        refs += [(handle.remote({"prompt": prompt}), t_sent) for _ in range(2 * ENGINE_SLOTS + ENGINE_MAX_QUEUE)]
        req = urllib.request.Request(f"{url}/llm", data=json.dumps({"prompt": prompt}).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                status, retry = r.status, None
        except urllib.error.HTTPError as e:
            status, retry = e.code, e.headers.get("Retry-After")
    answered = rejected = 0
    for ref, t_sent in refs:
        try:
            served(ref, what, "llm", t_sent, timeout)
            answered += 1
        except TimeoutError:
            raise
        except Exception as e:  # noqa: BLE001 -- counted: only the typed overload error is expected
            if _unwrap_cause(e, (EngineOverloadedError,)) is None:
                raise
            rejected += 1
    return status, retry, answered, rejected


def percentiles_ms(values):
    arr = np.asarray(values, dtype=np.float64) * 1e3 if values else np.zeros(1)
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


ENGINE_PROFILE_CTX = 128  # context of every slot in the profiled decode steps


def engine_decode_profile(llm, steps=10):
    """The engine's decode program alone, every slot active at a context of
    ENGINE_PROFILE_CTX: host ms per step (synchronised), and a
    torch.profiler run of 3 steps for kernels per step, device busy ms per
    step, the device's idle share, and the paged attention's share of
    device time (the gather of each slot's context and its masked softmax:
    the K4 candidate)."""
    progs = llm.engine_programs(num_pages=ENGINE_SLOTS * LLAMA_SEQ // ENGINE_PAGE, page_size=ENGINE_PAGE)
    pages = progs["init"]()
    per_slot = LLAMA_SEQ // ENGINE_PAGE
    tables = np.arange(ENGINE_SLOTS * per_slot, dtype=np.int32).reshape(ENGINE_SLOTS, per_slot)
    tokens = np.full(ENGINE_SLOTS, LLAMA_PROMPT, np.int32)
    positions = np.full(ENGINE_SLOTS, ENGINE_PROFILE_CTX, np.int32)
    active = np.ones(ENGINE_SLOTS, bool)

    def step():
        nxt, _ = progs["decode"](pages, tables, tokens, positions, active)
        return nxt.cpu()  # the engine's per-step read of the next tokens

    for _ in range(2):
        step()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    ms = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if llm.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        traced_ms = (time.perf_counter() - t0) * 1e3
    from ray_tpu_torch.tools.profile_train_step import busy_us

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

    def dev_ms(row):
        return getattr(row, "device_time_total", getattr(row, "cuda_time_total", 0.0)) / 1e3

    attn = sum(dev_ms(r) for r in prof.key_averages() if r.key in ENGINE_ATTN_OPS)
    return {"ms_per_step": ms, "kernels_per_step": len(kernels) / 3, "busy_ms_per_step": busy / 3,
            "idle_share": 1 - busy / traced_ms if traced_ms else 0.0,
            "attn_share": attn / device_ms if device_ms else 0.0, "attn_ms_per_step": attn / 3,
            "pool_bytes": sum(t.numel() * t.element_size() for t in pages)}


ENGINE_ATTN_OPS = ("aten::index", "aten::einsum", "aten::softmax", "aten::masked_fill", "aten::repeat_interleave")


def engine_serve_phase(kind, card, static, model=LLAMA, device="cuda", timeout=REQUEST_TIMEOUT_S):
    """(i2): ray_tpu_torch.init → serve.run(engine_llm_deployment(...)) →
    a GPU replica hosting the engine over Llama-2-7B in bf16 (seed 0, as
    (f) and (g)).  Buffered calls and stream_tokens in turn at each offered
    concurrency, an SSE stream through the proxy, an overload burst that
    must answer 503; every request bounded by `timeout`.  After the
    cluster is gone, each distinct prompt's direct generate: every served
    request must equal it, or differ first where the direct path's top-2
    gap (float32) is within bf16's spacing at that logit.  `static` is
    (g)'s report, printed beside.  Returns a report."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import summarize_workloads
    from ray_tpu_torch.serve.llm import ShardedLLM, _resolve_cfg, engine_llm_deployment

    what = "engine (i2)"
    cfg = _resolve_cfg(model, LLAMA_SEQ)
    rng = np.random.default_rng(ENGINE_SEED + 1)
    pool = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in rng.integers(1, 201, ENGINE_PROMPTS)]
    report, rows = {"loads": {}}, []
    before = session_processes(os.getpid())
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        check(f"{what} cluster counts one GPU", gpus == 1, f"cluster_resources GPU = {gpus}")
        dep = engine_llm_deployment(model, max_seq_len=LLAMA_SEQ, new_tokens=LLAMA_NEW, num_slots=ENGINE_SLOTS,
                                    page_size=ENGINE_PAGE, prefill_chunk=ENGINE_CHUNK, max_queue=ENGINE_MAX_QUEUE,
                                    num_gpus=1, device=device)
        handle = serve.run(dep.bind())
        engine = serve.get_deployment_handle("llm")
        rows.append((0, False, *engine_request(handle, pool[0], False, what, timeout)))
        info = ray_tpu_torch.get(engine.method("info").remote(), timeout=60)
        jax_mapped, _ = llama_process_libs(info["pid"])
        print(f"{what} replica pid {info['pid']} (driver {os.getpid()}), device {info['device']}, first request "
              f"answered {time.perf_counter() - t0:.1f} s after init; pool {info['engine']['pages_total']:.0f} pages of "
              f"{ENGINE_PAGE} tokens", flush=True)
        check(f"{what} replica is another process on this card", info["pid"] != os.getpid() and info["device"] == kind,
              f"pid {info['pid']}, device {info['device']!r}")
        check(f"{what} replica loads no jax", not jax_mapped, "jax/jaxlib libraries mapped" if jax_mapped else "none")
        for conc in SERVE_LOADS:
            picks = rng.integers(0, ENGINE_PROMPTS, 4 * conc).tolist()
            load, wall, pages = engine_load(handle, engine, conc, picks, pool, what, timeout)
            rows += load
            lat = [r[3] for r in load]
            ttft = [r[4] for r in load if r[4] is not None]
            tpot = [(r[3] - r[4]) / (len(r[2]) - 1) for r in load if r[4] is not None and len(r[2]) > 1]
            toks = sum(len(r[2]) for r in load)
            row = {"requests": len(load), "tokens_per_s": toks / wall, "pages_used_max": pages}
            row["p50_ms"], row["p99_ms"] = percentiles_ms(lat)
            row["stream_ttft_p50_ms"], row["stream_ttft_p99_ms"] = percentiles_ms(ttft)
            row["stream_tpot_p50_ms"], row["stream_tpot_p99_ms"] = percentiles_ms(tpot)
            report["loads"][conc] = row
            g = static.get("loads", {}).get(conc, {})
            print(f"{what} concurrency {conc}: {len(load)} requests (every other streamed) in {wall:.2f} s, "
                  f"{row['tokens_per_s']:.1f} tokens/s, p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms; "
                  f"streams: TTFT p50 {row['stream_ttft_p50_ms']:.1f} ms p99 {row['stream_ttft_p99_ms']:.1f} ms, TPOT p50 "
                  f"{row['stream_tpot_p50_ms']:.2f} ms p99 {row['stream_tpot_p99_ms']:.2f} ms; pages used at most "
                  f"{pages:.0f}; static (g): {g.get('tokens_per_s', float('nan')):.1f} tokens/s, p50 "
                  f"{g.get('p50_ms', float('nan')):.1f} ms, p99 {g.get('p99_ms', float('nan')):.1f} ms ({card})", flush=True)
            check(f"{what} concurrency {conc}: every request answered with {LLAMA_NEW} tokens",
                  all(len(r[2]) == LLAMA_NEW for r in load), f"{sum(len(r[2]) == LLAMA_NEW for r in load)} of {len(load)}")
        streams = [r for r in rows if r[1]]
        check(f"{what} streams arrive in several frames", all(r[5] > 1 for r in streams),
              f"frames per stream {min(r[5] for r in streams)}..{max(r[5] for r in streams)}")
        summary = summarize_workloads("serve")
        ttft, tpot = summary.get("ttft", {}).get("llm"), summary.get("tpot", {}).get("llm")
        report.update(ttft=ttft, tpot=tpot, engine=summary.get("engine", {}).get("llm"))
        if ttft and tpot:
            print(f"{what} summarize_workloads('serve'): TTFT p50 {ttft['p50'] * 1e3:.1f} ms p99 "
                  f"{ttft['p99'] * 1e3:.1f} ms; TPOT p50 {tpot['p50'] * 1e3:.3f} ms p99 {tpot['p99'] * 1e3:.3f} ms; "
                  f"engine gauges {report['engine']}; static (g): TTFT p50 "
                  f"{(static.get('ttft') or {}).get('p50', float('nan')) * 1e3:.1f} ms, TPOT p50 "
                  f"{(static.get('tpot') or {}).get('p50', float('nan')) * 1e3:.3f} ms", flush=True)
        check(f"{what} TTFT and TPOT in summarize_workloads('serve')", bool(ttft and tpot), f"ttft {ttft}, tpot {tpot}")
        url = serve.start_http_proxy(0)
        sse, frames, done = sse_request(url, pool[1], timeout)
        rows.append((1, True, sse, 0.0, None, frames))
        check(f"{what} SSE through the proxy: frames, then the done event", done and frames > 1,
              f"{frames} frames, done event {done}")
        status, retry, answered, rejected = overload_burst(handle, url, pool[2], what, timeout)
        print(f"{what} overload burst: HTTP {status} Retry-After {retry}; {answered} answered, {rejected} rejected "
              f"with EngineOverloadedError (max_queue {ENGINE_MAX_QUEUE})", flush=True)
        check(f"{what} overload answers 503 with Retry-After and typed rejections",
              status == 503 and retry is not None and int(retry) >= 1 and rejected > 0,
              f"HTTP {status}, Retry-After {retry}, {rejected} rejected")
        stats = ray_tpu_torch.get(engine.method("engine_stats").remote(), timeout=30)
        report["stats"] = stats
        check(f"{what} one input shape per program", stats["compile_prefill"] == 1 and stats["compile_decode"] == 1,
              f"prefill {stats['compile_prefill']}, decode {stats['compile_decode']}")
        serve.shutdown()
    finally:
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    report["seconds"] = time.perf_counter() - t0
    await_no_leftover(what, cluster, before)

    # the direct path, once the replica has left the card
    llm = ShardedLLM(cfg, init="random", seed=0, device=device)
    direct = {p: llm.generate(np.asarray([pool[p]], np.int32), LLAMA_NEW)[0].tolist() for p in sorted({r[0] for r in rows})}
    # the direct path itself, one prompt in every row of a batch: each row
    # must be its B=1 tokens (the property the engine's equality rests on)
    p0 = min(direct)
    rows8 = llm.generate(np.asarray([pool[p0]] * ENGINE_SLOTS, np.int32), LLAMA_NEW).tolist()
    moved = [r for r, row in enumerate(rows8) if row != direct[p0]]
    check(f"{what} generate at B={ENGINE_SLOTS} of one prompt gives its B=1 tokens in every row", not moved,
          f"rows differing {moved}; first difference {[first_difference(rows8[r], direct[p0]) for r in moved]}")
    report["decode"] = prof = engine_decode_profile(llm)
    print(f"{what} decode program alone, {ENGINE_SLOTS} slots at context {ENGINE_PROFILE_CTX} on {card}: "
          f"{prof['ms_per_step']:.3f} ms/step; profiled: {prof['kernels_per_step']:.0f} kernels/step, device busy "
          f"{prof['busy_ms_per_step']:.3f} ms/step, idle {prof['idle_share']:.1%} of the traced wall; paged attention "
          f"({'+'.join(ENGINE_ATTN_OPS)}) {prof['attn_ms_per_step']:.3f} ms/step, {prof['attn_share']:.1%} of device "
          f"time; pool {prof['pool_bytes'] / 2**30:.3f} GiB", flush=True)
    served_by = {}
    for p, stream, toks, *_ in rows:
        served_by.setdefault(p, {}).setdefault(stream, set()).add(tuple(toks))
    split = {p: modes for p, modes in served_by.items() if len(modes) == 2 and modes[True] != modes[False]}
    check(f"{what} streamed frames concatenate to the buffered result", not split,
          f"prompts where they differ: {sorted(split)}")
    bad, ties = [], []
    for p, modes in sorted(served_by.items()):
        for toks in set().union(*modes.values()):
            if list(toks) == direct[p]:
                continue
            pos = first_difference(toks, direct[p])
            gap, top = top2_gap(llm.model, pool[p], direct[p], pos)
            (ties if gap <= BF16_EPS * top else bad).append(p)
            print(f"{what} prompt {p} ({len(pool[p])} tokens) differs from the direct generate at token {pos}: the "
                  f"direct path's top-2 gap {gap:.4e} (float32) against bf16's spacing {BF16_EPS * top:.4e} at "
                  f"|logit| {top:.4f}", flush=True)
    print(f"{what} {len(rows)} requests over {len(direct)} prompts (lengths {[len(pool[p]) for p in sorted(direct)]}); "
          f"equal to the direct generate but for {len(ties)} bf16 near-ties; init to shutdown {report['seconds']:.1f} s",
          flush=True)
    check(f"{what} every request equals the direct generate, or differs first at a bf16 near-tie", not bad,
          f"prompts differing beyond bf16's spacing: {bad}")
    del llm
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return report


STEP_DAG_MODEL = "gpt2_124m"  # (h): make_lm_step_spec's preset, float32 compute, plain Adam
STEP_DAG_BATCH, STEP_DAG_SEQ, STEP_DAG_STEPS, STEP_DAG_CKPT = 4, 1024, 12, 6
# Adam's rate: the spec's default, 1e-2 (sized for the `tiny` config),
# moves every weight of GPT-2 124M (init std 0.02) by about half its size
# each step: the loss climbed from 10.96 to 16.1 in 12 steps.  3e-4
# (make_train_step's default) trains.
STEP_DAG_LR = 3e-4
STEP_DAG_ATTN = (STEP_DAG_BATCH, STEP_DAG_SEQ, 12, 64)  # B, S, H, D of its attention, float32 (the sm90_f32 route)
STEP_DAG_STORE_BYTES = 8 << 30  # a checkpoint is 1.5 GB of host numpy (params, Adam's mu and nu)


def step_dag_kernel_phase(att):
    """The float32 kernels (the sm90_f32 route, and the wmma yardstick) at
    (h)'s attention shape: routed through causal_attention and launched
    directly, each checked against the float32 plain version (1e-4
    absolute), then timed beside the plain version and SDPA in float32,
    each against its bound (route_peak).  (max_err, times, plain, library,
    bounds)."""
    B, S, H, D = STEP_DAG_ATTN
    what = f"f32 B={B} S={S} H={H} D={D}"
    ek, _, taken, direct_err = attention_errors(att, B, S, H, D, torch.float32, "auto", seed=8, direct=True,
                                                routes=F32_ROUTES)
    check_route(att, taken, torch.float32, D, f"{what} impl=auto (step DAG)")
    for n, e in ek.items():
        check(f"{n} {what} impl=auto", e <= 1e-4, f"{e:.3e} tol 1e-4")
    for c, errs in direct_err.items():
        for n, e in errs.items():
            check(f"{n} {what} {c}", e <= 1e-4, f"{e:.3e} tol 1e-4")
    max_err = {c: max(errs.values()) for c, errs in direct_err.items()}
    return (max_err, *timing_phase(att, STEP_DAG_ATTN, routes=F32_ROUTES, dtype=torch.float32))


def instrumented_spec(spec):
    """`spec` with its build, fold and snapshot wrapped for (h): build turns
    TF32 off (as in the driver, phase 1) and zeroes the worker's launch
    counters before the run; fold stamps each step's completion; the
    snapshot, an eager call at a drained step boundary, also carries the
    launch counts, the stamps, what the worker is, and whether it ran under
    torch's deterministic algorithms (which the spec's build sets on the
    card).  Closures, so that cloudpickle ships them by value: the worker
    needs nothing of this script."""
    build, fold, snapshot, restore = spec.build, spec.fold, spec.snapshot, spec.restore

    def build_(config, rank, world):
        import torch

        from ray_tpu_torch.ops import attention as att

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        att.reset_launch_counts()
        state = build(config, rank, world)
        state["fold_t"] = []
        return state

    def fold_(state, metrics):
        import time

        out = fold(state, metrics)  # float(loss): the step's work is done
        state["fold_t"].append(time.perf_counter())
        return out

    def snapshot_(state):
        import os
        import sys

        import torch

        from ray_tpu_torch.ops import attention as att

        return {
            "lm": snapshot(state),
            "launches": dict(att.LAUNCHES),
            "fold_t": list(state["fold_t"]),
            "pid": os.getpid(),
            "device": torch.cuda.get_device_name() if state["device"].type == "cuda" else "cpu",
            "forbidden_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")),
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        }

    def restore_(state, snap):
        restore(state, snap["lm"])

    return dataclasses.replace(spec, build=build_, fold=fold_, snapshot=snapshot_, restore=restore_)


def ms_per_step(fold_t):
    """Mean ms between step completions, leaving out the first step's
    (warm-up) and the one across the checkpoint (the snapshot's transfer)."""
    gaps = [b - a for i, (a, b) in enumerate(zip(fold_t, fold_t[1:])) if i not in (0, STEP_DAG_CKPT - 1)]
    return sum(gaps) / len(gaps) * 1e3


def checkpoint_crc(leaves):
    """{name: crc32 of the bytes} of a checkpoint's numpy leaves."""
    import zlib

    return {n: zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B")) for n, a in leaves.items()}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat_leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def step_dag_phase(kind, card, model=STEP_DAG_MODEL, batch=STEP_DAG_BATCH, seq=STEP_DAG_SEQ, device="cuda"):
    """(h): GPT-2 124M through ray_tpu_torch.init → TorchTrainer(train_step_spec=
    make_lm_step_spec(...)) → fit_spec, once on the eager per-step path and
    once through the resident step DAG (TrainStepDag), one after the other
    on one cluster, each in its own GPU worker actor.  Every cluster call
    inside fit carries the runtime's timeouts (a step's metrics:
    train_dag_step_timeout_s).  Returns the runs' figures:
    {"eager"|"dag": {...}}."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.lm_train import make_lm_step_spec
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch.config import TorchConfig

    cfg = getattr(GPT2Config, model)() if isinstance(model, str) else model
    if device == "cuda":
        torch.cuda.empty_cache()  # the worker needs the card's memory, not this process
    before = session_processes(os.getpid())
    ray_tpu_torch.init(num_cpus=4, object_store_memory=STEP_DAG_STORE_BYTES)
    runs, crc = {}, {}
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        check("step DAG (h) cluster counts one GPU", gpus == 1, f"cluster_resources GPU = {gpus}")
        for name, use_dag in (("eager", False), ("dag", True)):
            spec = instrumented_spec(make_lm_step_spec(model, batch=batch, seq=seq, steps=STEP_DAG_STEPS,
                                                       checkpoint_every=STEP_DAG_CKPT, learning_rate=STEP_DAG_LR,
                                                       device=device))
            t0 = time.perf_counter()
            result = TorchTrainer(train_step_spec=spec, backend_config=TorchConfig(use_step_dag=use_dag),
                                  scaling_config=ScalingConfig(num_workers=1)).fit()
            ckpt = result.checkpoint.to_dict()
            runs[name] = {"fit_s": time.perf_counter() - t0, "losses": [m["loss"] for m in result.metrics_history],
                          "step": ckpt["step"], "snap": ckpt["spec_state"]}
            crc[name] = checkpoint_crc(flat_leaves(ckpt["spec_state"]["lm"]))
        # fault 0: the eager checkpoint's leaves are views of store blocks its
        # owner freed when fit() returned; the DAG run's puts came after
        after = checkpoint_crc(flat_leaves(runs["eager"]["snap"]["lm"]))
    finally:
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    steps = STEP_DAG_STEPS
    per_fwd = fwd_per_step(cfg)
    for name, run in runs.items():
        snap = run["snap"]
        run["ms_per_step"] = ms_per_step(snap["fold_t"])
        run["launches"] = snap["launches"]
        print(f"step DAG (h) {name}: GPT-2 {model} B={batch} S={spec.config['seq']} f32, {steps} steps through TorchTrainer on "
              f"{card}: {run['ms_per_step']:.2f} ms/step; fit {run['fit_s']:.1f} s; worker pid {snap['pid']}, "
              f"device {snap['device']}, jax/ray_tpu modules {snap['forbidden_modules']}", flush=True)
        print(f"step DAG (h) {name} losses {['%.6f' % x for x in run['losses']]}", flush=True)
        print(f"step DAG (h) {name} launches {run['launches']}", flush=True)
        check(f"step DAG (h) {name} worker is another process", snap["pid"] != os.getpid(), f"worker {snap['pid']}")
        check(f"step DAG (h) {name} worker on this card", snap["device"] == kind, f"{snap['device']!r} vs {kind!r}")
        check(f"step DAG (h) {name} worker loads no jax or ray_tpu module", snap["forbidden_modules"] == [],
              f"{snap['forbidden_modules']}")
        la = run["launches"]
        check(f"step DAG (h) {name} launches all on the sm90_f32 kernels",
              la["causal_attention_fwd_sm90_f32"] == la["causal_attention_fwd"] == per_fwd * steps
              and la["causal_attention_bwd_sm90_f32"] == la["causal_attention_bwd"] == cfg.n_layer * steps,
              f"fwd sm90_f32 {la['causal_attention_fwd_sm90_f32']} of {la['causal_attention_fwd']}, bwd sm90_f32 "
              f"{la['causal_attention_bwd_sm90_f32']} of {la['causal_attention_bwd']}; want {per_fwd * steps} and "
              f"{cfg.n_layer * steps}")
        if device == "cuda":
            check(f"step DAG (h) {name} ran under torch's deterministic algorithms",
                  snap["deterministic"] and snap["cublas_workspace"] is not None,
                  f"deterministic {snap['deterministic']}, CUBLAS_WORKSPACE_CONFIG {snap['cublas_workspace']!r}")
        check(f"step DAG (h) {name} checkpoint at step {steps}",
              run["step"] == steps and int(snap["lm"]["opt_state"]["count"]) == steps,
              f"step {run['step']}, Adam count {int(snap['lm']['opt_state']['count'])}")
        check(f"step DAG (h) {name} losses finite", all(math.isfinite(x) for x in run["losses"]),
              f"{run['losses'][0]:.6f} .. {run['losses'][-1]:.6f}")
    eager, dag = runs["eager"], runs["dag"]
    saved = eager["ms_per_step"] - dag["ms_per_step"]
    print(f"step DAG (h) ms/step eager {eager['ms_per_step']:.3f}, DAG {dag['ms_per_step']:.3f}, difference "
          f"{saved:.3f} ({card})", flush=True)
    # the step is deterministic on the card (ordered dq in the attention
    # backward, torch's deterministic algorithms), as the reference's is:
    # the two paths must agree bit for bit
    diff = [i for i, (a, b) in enumerate(zip(eager["losses"], dag["losses"])) if a != b]
    check("step DAG (h) every loss bit-equal eager vs DAG", not diff and len(eager["losses"]) == len(dag["losses"]),
          f"steps differing {diff}; first {eager['losses'][0]!r} vs {dag['losses'][0]!r}")
    pe, pd = eager["snap"]["lm"]["params"], dag["snap"]["lm"]["params"]
    wdiff = {n: float(np.abs(pe[n].astype(np.float64) - pd[n].astype(np.float64)).max())
             for n in pd if pe[n].tobytes() != pd[n].tobytes()}
    check("step DAG (h) final weights byte-equal eager vs DAG", not wdiff and pe.keys() == pd.keys(),
          f"{len(wdiff)} of {len(pd)} leaves differ" + (f", max |diff| {max(wdiff.values()):.3e}" if wdiff else ""))
    check("step DAG (h) eager checkpoint intact after the DAG run", after == crc["eager"],
          f"{sum(after[n] != crc['eager'][n] for n in after)} of {len(after)} leaves changed")
    await_no_leftover("step DAG (h)", cluster, before)
    return runs


RL_OBS = (84, 84, 4)  # SyntheticPixelEnv's frames: Atari's preprocessed geometry, uint8
RL_ACTIONS = 3
RL_WORKERS, RL_ENVS, RL_FRAGMENT = 2, 32, 50  # (j2): bench_rllib.py's configuration, 3200 rows an iteration
RL_MINIBATCH, RL_SGD_ITERS, RL_LR = 800, 2, 1e-3  # (j2), bench_rllib.py's
RL_TIMED_ITERS = 5  # (j2): after one warm-up iteration
RL_LEARNER_CALLS = 10  # (j2): load_batch + learn_on_loaded_batch on one fixed batch, as bench_rllib.py
RL_WORKER_CPUS = 2  # CPUs (and torch threads) of each rollout worker: the fastest of 1, 2, 3, 8 (tools/rllib_rollout_threads.py)
RL_CHECK_ROWS, RL_CHECK_MINIBATCH = 800, 200  # (j1): 2 epochs of 4 minibatches
RL_CHECK_LR = 3e-4  # (j1): TorchPolicy's default
RL_ASYNC_ENVS, RL_ASYNC_BATCHES, RL_ASYNC_ITERS = 8, 4, 3  # (j3): per worker; learner updates per iteration
RL_TIMEOUT_S = 300  # every cluster call of (j)


def jax_layout_cnn(model, seed):
    """A CNN parameter tree in the JAX package's layout (HWIO convs, [in,
    out] dense, the trunk's rows in NHWC flatten order), drawn from
    `seed` with the reference's scales: what `JaxPolicy.get_weights()`
    returns, made without JAX."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out, scale=2.0):
        return {"w": rng.standard_normal((fan_in, fan_out), np.float32) * np.float32((scale / fan_in) ** 0.5),
                "b": np.zeros(fan_out, np.float32)}

    convs, c_in = [], model.obs_shape[-1]
    for c_out, k, _s in model.conv_filters:
        w = rng.standard_normal((k, k, c_in, c_out), np.float32) * np.float32((2.0 / (k * k * c_in)) ** 0.5)
        convs.append({"w": w, "b": np.zeros(c_out, np.float32)})
        c_in = c_out
    return {"conv": convs, "trunk": dense(int(np.prod(model.out_hwc)), model.hidden),
            "pi": dense(model.hidden, model.num_actions, 0.02), "vf": dense(model.hidden, 1, 1.0)}


def pixel_batch(rows, seed, frames="env"):
    """A PPO batch of `rows` rows from `seed`: the env's frames under random
    actions (frames="env"), or uniform noise frames (bench_rllib.py's
    learner-only batch)."""
    from ray_tpu_torch.rllib import SyntheticPixelEnv
    from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS, SampleBatch

    rng = np.random.default_rng(seed)
    if frames == "env":
        env = SyntheticPixelEnv(num_envs=32, seed=seed)
        obs = [env.reset(seed=seed)]
        while len(obs) * 32 < rows:
            obs.append(env.step(rng.integers(0, RL_ACTIONS, 32))[0])
        obs = np.concatenate(obs)[:rows]
    else:
        obs = rng.integers(0, 256, (rows, *RL_OBS), dtype=np.uint8)
    return SampleBatch({
        OBS: obs,
        ACTIONS: rng.integers(0, RL_ACTIONS, rows),
        LOGPS: np.full(rows, np.log(1 / RL_ACTIONS), np.float32),
        ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
        RETURNS: rng.standard_normal(rows).astype(np.float32),
    })


def rllib_learner_phase(card, device="cuda", model=None, rows=RL_CHECK_ROWS):
    """(j1): the PPO learner on the card against the same learner on the
    CPU: nature-CNN TorchPolicy at 84x84x4, 3 actions, float32 with TF32
    off, the same converted weights, one seeded batch of env frames;
    learn_on_loaded_batch, minibatch 200, 2 epochs.  Checked: the first
    minibatch's gradient within 1e-4 of its norm, the last minibatch's
    metrics within 1e-3 relative, and the learned policy on the batch's
    rows: action probabilities within 1e-3, values within 2e-2 of their
    largest magnitude.  The parameters' differences are printed, not held
    to 1e-5: Adam's step lr * g / (|g| + 1e-8) moves an element whose
    float32 gradient is rounding noise near 1e-8 by up to 2 lr, and every
    later step carries it on.  On these inputs the port's own float32 and
    float64 learners on the CPU differ by 1.864e-3 (34,244 elements above
    1e-5, the update 0.86% apart in norm), their probabilities by 4.7e-5
    and values by 8.5e-4 of the largest."""
    from ray_tpu_torch.models.convert import rllib_params_from_jax
    from ray_tpu_torch.rllib import TorchPolicy
    from ray_tpu_torch.rllib.sample_batch import OBS, SampleBatch

    cfg = dict(obs_shape=RL_OBS, num_actions=RL_ACTIONS, lr=RL_CHECK_LR, model_config={"type": "cnn", **(model or {})})
    learner, host = TorchPolicy(device=device, **cfg), TorchPolicy(device="cpu", **cfg)
    weights = rllib_params_from_jax(jax_layout_cnn(host.model, seed=0), host.model)
    learner.model.load_state_dict(weights)
    host.model.load_state_dict(weights)
    batch = pixel_batch(rows, seed=1)
    # the first minibatch of learn_on_loaded_batch(seed=0)'s first call
    first = np.random.default_rng(0).permutation(rows)[:RL_CHECK_MINIBATCH]
    g_dev, _ = learner.compute_grads(SampleBatch({k: v[first] for k, v in batch.items()}))
    g_cpu, _ = host.compute_grads(SampleBatch({k: v[first] for k, v in batch.items()}))
    g_err = float(np.linalg.norm(g_dev.astype(np.float64) - g_cpu) / np.linalg.norm(g_cpu.astype(np.float64)))
    m_dev = learner.learn_on_loaded_batch(learner.load_batch(batch), 2, RL_CHECK_MINIBATCH)
    m_cpu = host.learn_on_loaded_batch(host.load_batch(batch), 2, RL_CHECK_MINIBATCH)
    m_err = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
    with torch.no_grad():
        obs = torch.from_numpy(batch[OBS])
        (l_dev, v_dev), (l_cpu, v_cpu) = learner.model(obs.to(device)), host.model(obs)
        p_err = float((torch.softmax(l_dev.cpu().double(), -1) - torch.softmax(l_cpu.double(), -1)).abs().max())
        v_err = float((v_dev.cpu().double() - v_cpu).abs().max() / v_cpu.abs().max())
    w_dev, w_cpu = learner.get_weights(), host.get_weights()
    diff = np.concatenate([(w_dev[n].astype(np.float64) - w_cpu[n]).ravel() for n in w_cpu])
    update = np.concatenate([(w_cpu[n].astype(np.float64) - weights[n].numpy()).ravel() for n in w_cpu])
    on_card = {p.device.type for p in learner.model.parameters()}
    print(f"rllib (j1) nature CNN learner on {device} vs the CPU (TF32 off, lr {RL_CHECK_LR}): first minibatch's "
          f"gradient error {g_err:.3e} of its norm; after {rows} rows x 2 epochs: action probabilities {p_err:.3e} "
          f"apart, values {v_err:.3e} of the largest, metrics {m_err:.3e}; parameters max |diff| "
          f"{np.abs(diff).max():.3e}, {int((np.abs(diff) > 1e-5).sum())} of {diff.size} above 1e-5, the update "
          f"{np.linalg.norm(diff) / np.linalg.norm(update):.3e} apart in norm; metrics {m_dev} vs {m_cpu}", flush=True)
    check("rllib (j1) learner's parameters on the card", on_card == {device}, f"{on_card}")
    check("rllib (j1) first minibatch's gradient within 1e-4 of its norm", g_err <= 1e-4, f"{g_err:.3e}")
    check("rllib (j1) metrics within 1e-3 relative", m_err <= 1e-3, f"{m_err:.3e}")
    check("rllib (j1) learned action probabilities within 1e-3", p_err <= 1e-3, f"{p_err:.3e}")
    check("rllib (j1) learned values within 2e-2 of the largest", v_err <= 2e-2, f"{v_err:.3e}")
    return {"grad_err": g_err, "metric_err": m_err, "prob_err": p_err, "value_err": v_err,
            "param_err": float(np.abs(diff).max())}


def rllib_worker_checks(what, infos, worker_cpus):
    for info in infos:
        forbidden = sorted(m for m in info["modules"] if m in ("jax", "jaxlib", "ray_tpu"))
        print(f"{what} rollout worker pid {info['pid']} (driver {os.getpid()}): CUDA_VISIBLE_DEVICES="
              f"{info['cuda_visible_devices']!r}, cuda available {info['cuda_available']}, policy on "
              f"{info['policy_device']}, {info['torch_threads']} torch threads, jax/ray_tpu modules {forbidden}",
              flush=True)
        check(f"{what} rollout worker is another process", info["pid"] != os.getpid(), f"{info['pid']}")
        check(f"{what} rollout worker has no CUDA device",
              info["cuda_visible_devices"] == "" and not info["cuda_available"] and info["policy_device"] == "cpu",
              f"CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']!r}, policy on {info['policy_device']}")
        check(f"{what} rollout worker loads no jax or ray_tpu module", not forbidden, f"{forbidden}")
        check(f"{what} rollout worker runs its granted threads", info["torch_threads"] == worker_cpus,
              f"{info['torch_threads']} vs {worker_cpus}")


def iteration_profile(algo, device):
    """torch.profiler over one PPO iteration in the driver (the learner's
    process): the device's busy time and idle share of that iteration's
    wall (the profiler's own host cost included)."""
    from ray_tpu_torch.tools.profile_train_step import busy_us

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = algo.train()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    check("rllib (j2) profile holds device kernels", bool(kernels), f"{len(kernels)} kernels")
    return {"traced_ms": traced_ms, "device_busy_ms": busy, "kernels": len(kernels),
            "idle_share": 1 - busy / traced_ms, "result": result}


def learner_only(policy, rows, minibatch):
    """bench_rllib.py's learner-only rate: load_batch + learn_on_loaded_batch
    on one fixed batch of uniform frames, RL_LEARNER_CALLS times after one
    warm-up; env-steps/s and ms a call."""
    batch = pixel_batch(rows, seed=2, frames="noise")
    policy.learn_on_loaded_batch(policy.load_batch(batch), RL_SGD_ITERS, minibatch)  # ends in a sync
    t0 = time.perf_counter()
    for _ in range(RL_LEARNER_CALLS):
        metrics = policy.learn_on_loaded_batch(policy.load_batch(batch), RL_SGD_ITERS, minibatch)
    dt = time.perf_counter() - t0
    check("rllib (j2) learner-only losses finite", all(math.isfinite(v) for v in metrics.values()), f"{metrics}")
    return {"env_steps_per_s": RL_LEARNER_CALLS * rows / dt, "ms_per_call": dt / RL_LEARNER_CALLS * 1e3}


def rllib_ppo_run(card, device, env, model, workers, envs, fragment, minibatch, iters, worker_cpus):
    """(j2) inside a live cluster: PPO's build, one warm-up and `iters`
    timed iterations, a profiled one, the learner-only rate."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import AlgorithmConfig

    algo = (
        AlgorithmConfig(learner_device=device, num_cpus_per_worker=worker_cpus)
        .environment(env)
        .rollouts(num_rollout_workers=workers, num_envs_per_worker=envs)
        .training(lr=RL_LR, train_batch_size=workers * envs * fragment, rollout_fragment_length=fragment,
                  sgd_minibatch_size=minibatch, num_sgd_iter=RL_SGD_ITERS, model=model)
        .build()
    )
    try:
        infos = ray_tpu_torch.get([w.worker_info.remote() for w in algo.workers], timeout=RL_TIMEOUT_S)
        rllib_worker_checks("rllib (j2)", infos, worker_cpus)
        warm = algo.train()
        t0 = time.perf_counter()
        runs = [algo.train() for _ in range(iters)]
        wall = time.perf_counter() - t0
        profile = iteration_profile(algo, device)
        learner = learner_only(algo.policy, workers * envs * fragment, minibatch)
        on_card = {p.device.type for p in algo.policy.model.parameters()}
    finally:
        algo.stop()
    steps = sum(r["timesteps_this_iter"] for r in runs)
    mean = {k: sum(r[k] for r in runs) / len(runs) for k in ("time_this_iter_s", "rollout_s", "transfer_s", "h2d_s", "learn_s")}
    losses = [r["total_loss"] for r in (warm, *runs, profile["result"])]
    print(f"rllib (j2) PPO nature CNN, {workers} workers x {envs} envs x {fragment} steps ({steps // iters} rows an "
          f"iteration), minibatch {minibatch}, {RL_SGD_ITERS} epochs, learner on {device} ({card}; cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}), {worker_cpus} torch threads a worker: {steps / wall:.1f} env-steps/s "
          f"over {iters} iterations; an iteration {mean['time_this_iter_s']:.3f} s: rollout {mean['rollout_s']:.3f} "
          f"(slowest worker), transfer {mean['transfer_s']:.3f}, host-to-device {mean['h2d_s']:.4f}, learn "
          f"{mean['learn_s']:.4f}; learner only {learner['env_steps_per_s']:.1f} env-steps/s "
          f"({learner['ms_per_call']:.2f} ms a {steps // iters}-row call); one profiled iteration "
          f"{profile['traced_ms']:.1f} ms, device busy {profile['device_busy_ms']:.2f} ms ({profile['kernels']} "
          f"kernels), idle {profile['idle_share']:.4f}; episode reward mean {runs[-1]['episode_reward_mean']:.3f}",
          flush=True)
    check("rllib (j2) learner's parameters on the card", on_card == {device}, f"{on_card}")
    check("rllib (j2) losses finite", all(math.isfinite(x) for x in losses), f"{losses}")
    return {"env_steps_per_s": steps / wall, "learner_only": learner, "profile": profile, "mean_s": mean}


def rllib_async_run(device, env_factory, model, workers, envs, fragment, worker_cpus):
    """(j3) inside a live cluster: IMPALA, then APPO, a few iterations each
    with the learner thread on `device`."""
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig

    out = {}
    for name, config_cls in (("IMPALA", IMPALAConfig), ("APPO", APPOConfig)):
        algo = (
            config_cls(learner_device=device, num_cpus_per_worker=worker_cpus, num_batches_per_iter=RL_ASYNC_BATCHES,
                       rollout_fragment_length=fragment, lr=RL_LR, model=model)
            .environment(env_factory(envs))
            .rollouts(num_rollout_workers=workers, num_envs_per_worker=envs)
            .build()
        )
        try:
            t0 = time.perf_counter()
            runs = [algo.train() for _ in range(RL_ASYNC_ITERS)]
            wall = time.perf_counter() - t0
            error = algo._learner.error
        finally:
            algo.stop()
        last = runs[-1]
        updates, by_device = last["num_learner_updates"], last["learner_device_updates"]
        steps = sum(r["timesteps_this_iter"] for r in runs)
        print(f"rllib (j3) {name}: {RL_ASYNC_ITERS} iterations, {updates} learner updates {by_device}, "
              f"{steps / wall:.1f} env-steps/s, last losses {[round(r['total_loss'], 4) for r in runs]}", flush=True)
        check(f"rllib (j3) {name} learner updates ran on the card", by_device == {device: updates}, f"{by_device}")
        check(f"rllib (j3) {name} learner update count reached", updates >= RL_ASYNC_ITERS * RL_ASYNC_BATCHES,
              f"{updates} of {RL_ASYNC_ITERS * RL_ASYNC_BATCHES}")
        check(f"rllib (j3) {name} losses finite", all(math.isfinite(r["total_loss"]) for r in runs),
              f"{[r['total_loss'] for r in runs]}")
        check(f"rllib (j3) {name} no learner error", error is None, f"{error!r}")
        out[name] = {"updates": updates, "env_steps_per_s": steps / wall}
    return out


def rllib_phase(card, device="cuda", model=None, workers=RL_WORKERS, envs=RL_ENVS, fragment=RL_FRAGMENT,
                minibatch=RL_MINIBATCH, iters=RL_TIMED_ITERS, async_envs=RL_ASYNC_ENVS, worker_cpus=RL_WORKER_CPUS,
                cluster_cpus=8):
    """(j2) and (j3) on one cluster: ray_tpu_torch.init, PPO at
    bench_rllib.py's configuration, then IMPALA and APPO; no process left
    after shutdown().  torch's default TF32 setting for cuDNN (on) holds
    while they run."""
    import functools

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib import SyntheticPixelEnv

    model = {"type": "cnn", **(model or {})}

    def env_factory(n):  # a partial of the port's class: workers import it, nothing of this script
        return functools.partial(SyntheticPixelEnv, num_envs=n, shaped=True, seed=11)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    before = session_processes(os.getpid())
    ray_tpu_torch.init(num_cpus=cluster_cpus)
    try:
        ppo = rllib_ppo_run(card, device, env_factory(envs), model, workers, envs, fragment, minibatch, iters,
                            worker_cpus)
        asyncs = rllib_async_run(device, env_factory, model, workers, async_envs, fragment, worker_cpus)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    await_no_leftover("rllib (j)", cluster, before)
    return {"ppo": ppo, "async": asyncs}


OFF_SAC = ((3,), 1, (128, 128), 128)  # (k1), (k2): bench_rllib.py _bench_sac's obs, action, hidden, batch
OFF_TD3 = ((3,), 1, (256, 256), 256)  # (k1): TD3Policy's and TD3Config's defaults on the same spaces
OFF_DQN_BATCH = 64  # (k1): DQNConfig's train_batch_size, the nature CNN at RL_OBS uint8
OFF_PARAM_TOL, OFF_METRIC_TOL = 1e-5, 1e-4  # (k1)
SAC_ENVS, SAC_WARMUP, SAC_ITERS, SAC_UPDATES = 16, 80, 500, 4  # (k2): _bench_sac's loop (bench_rllib.py:196-237)
SAC_PROFILE_ITERS = 20  # (k2): iterations under torch.profiler
SAC_ALONE_UPDATES = 200  # (k2): learn_on_batch alone, after the loop
OFF_WORKERS, OFF_ENVS, OFF_FRAGMENT, OFF_ITERS, OFF_UPDATES = 2, 8, 64, 3, 16  # (k3): per iteration
OFF_TIMEOUT_S = 300  # every cluster call of (k)


def jax_layout_dense(module, seed):
    """A parameter tree in the JAX package's layout for `module`'s linear
    layers ([in, out] `w` at the reference's He scale, zero `b`; a bare
    layer list where the names are indices, as `mlp_init` makes), drawn
    from `seed`: what the JAX policy's params look like, made without JAX."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in module.named_parameters():
        if name.endswith(".weight"):
            *path, leaf = name[: -len(".weight")].split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            out_f, in_f = p.shape
            node[leaf] = {"w": rng.standard_normal((in_f, out_f), np.float32) * np.float32((2.0 / in_f) ** 0.5),
                          "b": np.zeros(out_f, np.float32)}

    def lists(node):
        if "w" in node:
            return node
        node = {k: lists(v) for k, v in node.items()}
        return [node[str(i)] for i in range(len(node))] if all(k.isdigit() for k in node) else node

    return lists(tree)


def transitions(rows, obs_dim, act_dim, seed):
    """A replay minibatch of continuous-control transitions from `seed`."""
    from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

    rng = np.random.default_rng(seed)
    return SampleBatch({
        OBS: rng.standard_normal((rows, obs_dim)).astype(np.float32),
        ACTIONS: rng.uniform(-1, 1, (rows, act_dim)).astype(np.float32),
        REWARDS: rng.standard_normal(rows).astype(np.float32),
        NEXT_OBS: rng.standard_normal((rows, obs_dim)).astype(np.float32),
        DONES: (rng.random(rows) < 0.1).astype(np.float32),
    })


def learner_gap(what, pols, metrics, names, device):
    """Metrics' largest relative gap and, per part, (max |diff|, elements
    above OFF_PARAM_TOL, elements) between the CPU learner pols[0] and the
    card's pols[1]; checks the metrics and that the parameters are on the
    card."""
    host, learner = pols
    m_err = max(abs(metrics[1][k] - metrics[0][k]) / max(abs(metrics[0][k]), 1e-12) for k in metrics[0])
    gaps, on_card = {}, set()
    for name in names:
        a, b = getattr(host, name), getattr(learner, name)
        pa, pb = ([a], [b]) if isinstance(a, torch.Tensor) else (list(a.parameters()), list(b.parameters()))
        diff = torch.cat([(y.detach().cpu().double() - x.detach().double()).reshape(-1) for x, y in zip(pa, pb)])
        gaps[name] = (float(diff.abs().max()), int((diff.abs() > OFF_PARAM_TOL).sum()), diff.numel())
        on_card |= {p.device.type for p in pb}
    print(f"offpolicy (k1) {what} one update on {device} vs the CPU (TF32 off, same converted weights and noise): "
          f"metrics {m_err:.3e} relative apart; parameters (max |diff|, above {OFF_PARAM_TOL}, of) {gaps}; "
          f"metrics {metrics[1]} vs {metrics[0]}", flush=True)
    check(f"offpolicy (k1) {what} metrics within {OFF_METRIC_TOL} relative", m_err <= OFF_METRIC_TOL, f"{m_err:.3e}")
    check(f"offpolicy (k1) {what} learner's parameters on the card", on_card == {device}, f"{on_card}")
    return {"metric_err": m_err, "param_err": max(g[0] for g in gaps.values())}


def offpolicy_learner_phase(card, device="cuda", sac=OFF_SAC, td3=OFF_TD3, dqn_batch=OFF_DQN_BATCH, dqn_model=None):
    """(k1): one update of SAC, TD3 and DQN on the card against the same
    update on the CPU, float32 with TF32 off: the same converted weights
    (JAX-layout trees from seeds through rllib_params_from_jax), the same
    batch and the same injected noise.  Metrics within 1e-4 relative;
    SAC's and TD3's parameters within 1e-5.  DQN's nature CNN too, unless
    an element's gradient sits in a rounding tie near Adam's eps (a first
    step moves it by up to 2 lr on either side, see (j1)): then its
    Q-values on the batch must agree within 1e-4 of their largest."""
    from ray_tpu_torch.models.convert import rllib_params_from_jax
    from ray_tpu_torch.rllib import DQNPolicy, SACPolicy, SyntheticPixelEnv, TD3Policy
    from ray_tpu_torch.rllib.sac import floats, transition_tensors

    def load(pols, name, seed, targets=()):
        tree = jax_layout_dense(getattr(pols[0], name), seed)
        for pol in pols:
            state = rllib_params_from_jax(tree, getattr(pol, name))
            for module in (name, *targets):
                getattr(pol, module).load_state_dict(state)

    def noise(rng, shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    out = {}
    obs_shape, act, hidden, rows = sac
    pols = [SACPolicy(obs_shape, act, hidden=hidden, device=d) for d in ("cpu", device)]
    load(pols, "actor", 1)
    load(pols, "critic", 2, targets=("q_target",))
    batch, eps = transitions(rows, obs_shape[0], act, seed=3), noise(np.random.default_rng(4), (2, rows, act))
    metrics = [floats(p._update(*transition_tensors(batch, p.device), *eps.to(p.device))) for p in pols]
    out["SAC"] = learner_gap("SAC", pols, metrics, ("actor", "critic", "q_target", "log_alpha"), device)

    obs_shape, act, hidden, rows = td3
    pols = [TD3Policy(obs_shape, act, hidden=hidden, device=d) for d in ("cpu", device)]
    load(pols, "actor", 5, targets=("actor_target",))
    load(pols, "critic", 6, targets=("q_target",))
    batch, eps = transitions(rows, obs_shape[0], act, seed=7), noise(np.random.default_rng(8), (rows, act))
    metrics = [floats(p._update(*transition_tensors(batch, p.device), eps.to(p.device))) for p in pols]
    out["TD3"] = learner_gap("TD3 (step 0: actor and targets move)", pols, metrics,
                             ("actor", "critic", "actor_target", "q_target"), device)
    for what, gap in (("SAC", out["SAC"]), ("TD3", out["TD3"])):
        check(f"offpolicy (k1) {what} parameters within {OFF_PARAM_TOL}", gap["param_err"] <= OFF_PARAM_TOL,
              f"{gap['param_err']:.3e}")

    cfg = dict(obs_shape=RL_OBS, num_actions=RL_ACTIONS, model_config={"type": "cnn", **(dqn_model or {})})
    pols = [DQNPolicy(device=d, **cfg) for d in ("cpu", device)]
    tree = jax_layout_cnn(pols[0].model, seed=9)
    for pol in pols:
        state = rllib_params_from_jax(tree, pol.model)
        pol.model.load_state_dict(state)
        pol.target_model.load_state_dict(state)
    rng = np.random.default_rng(10)
    env = SyntheticPixelEnv(num_envs=dqn_batch, seed=10)
    obs = env.reset(seed=10)
    actions = rng.integers(0, RL_ACTIONS, dqn_batch)
    next_obs, rewards, dones, _ = env.step(actions)
    weights = rng.uniform(0.2, 1.0, dqn_batch).astype(np.float32)  # PER weights
    cols = [(torch.from_numpy(obs), torch.from_numpy(actions), torch.from_numpy(rewards),
             torch.from_numpy(next_obs), torch.from_numpy(dones.astype(np.float32)), torch.from_numpy(weights))]
    results = [p._update(*(c.to(p.device) for c in cols[0])) for p in pols]
    metrics = [{"loss": float(loss), "td_abs_mean": float(td.mean())} for loss, td in results]
    td_err = float((results[1][1].cpu() - results[0][1]).abs().max())
    gap = learner_gap("DQN nature CNN (PER weights)", pols, metrics, ("model", "target_model"), device)
    with torch.no_grad():
        q_cpu = pols[0].model(torch.from_numpy(obs))[0].double()
        q_dev = pols[1].model(torch.from_numpy(obs).to(device))[0].cpu().double()
    q_err = float((q_dev - q_cpu).abs().max() / q_cpu.abs().max())
    print(f"offpolicy (k1) DQN |td| {td_err:.3e} apart; Q-values after the update {q_err:.3e} of the largest apart",
          flush=True)
    if gap["param_err"] > OFF_PARAM_TOL:
        print(f"offpolicy (k1) DQN: parameters {gap['param_err']:.3e} apart (an Adam tie, see (j1)): the Q-values "
              f"on the batch hold it", flush=True)
        check("offpolicy (k1) DQN Q-values within 1e-4 of the largest", q_err <= 1e-4, f"{q_err:.3e}")
    out["DQN"] = {**gap, "q_err": q_err}
    return out


def sac_bench_phase(card, device="cuda", iters=SAC_ITERS, profile_iters=SAC_PROFILE_ITERS, alone=SAC_ALONE_UPDATES,
                    sac=OFF_SAC):
    """(k2): bench_rllib.py's _bench_sac loop with the learner on the card:
    PendulumEnv with 16 envs, 80 random warm-up steps into the replay
    buffer, one warm update, then `iters` iterations of acting plus 4
    updates of 128 rows.  Then `profile_iters` more under torch.profiler
    (the device's idle share), and `alone` updates alone."""
    from ray_tpu_torch.rllib import PendulumEnv, ReplayBuffer, SACPolicy
    from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch
    from ray_tpu_torch.tools.profile_train_step import busy_us

    obs_shape, act, hidden, rows = sac
    env = PendulumEnv(num_envs=SAC_ENVS, seed=0)
    pol = SACPolicy(obs_shape, act, action_low=env.action_space.low, action_high=env.action_space.high,
                    hidden=hidden, seed=0, device=device)
    buf = ReplayBuffer(100_000, seed=0)
    state = {"obs": env.reset(seed=0), "ep": np.zeros(SAC_ENVS), "hist": []}

    def store(raw, env_actions):
        nobs, rew, done, _ = env.step(env_actions)
        buf.add(SampleBatch({OBS: state["obs"], ACTIONS: raw, REWARDS: rew, NEXT_OBS: nobs,
                             DONES: done.astype(np.float32)}))
        state["ep"] += rew
        for i in np.nonzero(done)[0]:
            state["hist"].append(state["ep"][i])
            state["ep"][i] = 0.0
        state["obs"] = nobs

    rng = np.random.default_rng(0)
    for _ in range(SAC_WARMUP):
        raw = rng.uniform(-1, 1, (SAC_ENVS, act)).astype(np.float32)
        store(raw, pol._center + pol._scale * raw)
    metrics = pol.learn_on_batch(buf.sample(rows))  # builds the optimizers; ends in a copy to the host

    def iteration():
        env_a, raw = pol.compute_actions(state["obs"])
        store(raw, env_a)
        return [pol.learn_on_batch(buf.sample(rows)) for _ in range(SAC_UPDATES)][-1]

    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = iteration()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(profile_iters):
            metrics = iteration()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    print("offpolicy (k2) host time by operator over the profiled iterations (self ms, calls): "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ({e.count})" for e in host), flush=True)
    batch = buf.sample(rows)
    t2 = time.perf_counter()
    for _ in range(alone):
        pol.learn_on_batch(batch)
    alone_ms = (time.perf_counter() - t2) / alone * 1e3
    reward = float(np.mean(state["hist"][-10:])) if state["hist"] else 0.0
    out = {"env_steps_per_s": iters * SAC_ENVS / wall, "updates_per_s": iters * SAC_UPDATES / wall,
           "ms_per_update": wall / (iters * SAC_UPDATES) * 1e3, "ms_per_update_alone": alone_ms,
           "episode_reward_mean": reward, "alpha": metrics["alpha"], "idle_share": 1 - busy_ms / traced_ms,
           "kernels_per_iteration": len(kernels) / profile_iters}
    print(f"offpolicy (k2) SAC on Pendulum, bench_rllib.py's loop ({SAC_ENVS} envs, {iters} iterations of acting + "
          f"{SAC_UPDATES} updates of {rows} rows, hidden {hidden}), learner on {device} ({card}): "
          f"{out['env_steps_per_s']:.1f} env-steps/s, {out['updates_per_s']:.1f} grad updates/s, "
          f"{out['ms_per_update']:.3f} ms an update in the loop (acting included), {alone_ms:.3f} ms an update "
          f"alone; episode reward mean (last 10) {reward:.1f}, alpha {metrics['alpha']:.4f}; {profile_iters} "
          f"profiled iterations {traced_ms:.1f} ms, device busy {busy_ms:.2f} ms ({len(kernels)} kernels, "
          f"{out['kernels_per_iteration']:.1f} an iteration), idle {out['idle_share']:.4f}", flush=True)
    losses = [metrics[k] for k in ("critic_loss", "actor_loss", "alpha_loss")]
    check("offpolicy (k2) SAC losses finite", all(math.isfinite(x) for x in losses), f"{metrics}")
    check("offpolicy (k2) SAC alpha > 0", metrics["alpha"] > 0, f"{metrics['alpha']}")
    check("offpolicy (k2) profile holds device kernels", bool(kernels), f"{len(kernels)} kernels")
    return out


def offpolicy_cluster_phase(card, device="cuda", workers=OFF_WORKERS, envs=OFF_ENVS, fragment=OFF_FRAGMENT,
                            iters=OFF_ITERS, updates=OFF_UPDATES, hidden=None, dqn_model=None,
                            worker_cpus=RL_WORKER_CPUS, cluster_cpus=8):
    """(k3): ray_tpu_torch.init, then SAC, TD3, DDPG (Pendulum) and DQN (the
    pixel env, nature CNN) with `workers` CPU rollout workers, `iters`
    iterations each, updates from the first iteration on; no process left
    after shutdown()."""
    import functools

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib import DDPGConfig, DQNConfig, PendulumEnv, SACConfig, SyntheticPixelEnv, TD3Config

    rows = workers * envs * (fragment // envs)  # an iteration's transitions
    common = dict(learner_device=device, num_cpus_per_worker=worker_cpus, rollout_fragment_length=fragment,
                  learning_starts=rows, num_train_per_iter=updates)
    pendulum = functools.partial(PendulumEnv, num_envs=envs, seed=0)  # the port's class: workers import it
    continuous = {} if hidden is None else {"hidden": hidden}
    runs = {
        "SAC": SACConfig(**common, **continuous).environment(pendulum),
        "TD3": TD3Config(**common, **continuous).environment(pendulum),
        "DDPG": DDPGConfig(**common, **continuous).environment(pendulum),
        "DQN": DQNConfig(**common, buffer_size=4 * rows, model={"type": "cnn", **(dqn_model or {})})
        .environment(functools.partial(SyntheticPixelEnv, num_envs=envs, shaped=True, seed=11)),
    }
    out = {}
    before = session_processes(os.getpid())
    ray_tpu_torch.init(num_cpus=cluster_cpus)
    try:
        for name, config in runs.items():
            algo = config.rollouts(num_rollout_workers=workers, num_envs_per_worker=envs).build()
            try:
                infos = ray_tpu_torch.get([w.worker_info.remote() for w in algo.workers], timeout=OFF_TIMEOUT_S)
                rllib_worker_checks(f"offpolicy (k3) {name}", infos, worker_cpus)
                t0 = time.perf_counter()
                results = [algo.train() for _ in range(iters)]
                wall = time.perf_counter() - t0
                modules = (algo.policy.model,) if name == "DQN" else (algo.policy.actor, algo.policy.critic)
                on_card = {p.device.type for m in modules for p in m.parameters()}
            finally:
                algo.stop()
            key, loss = ("num_td_updates", "loss") if name == "DQN" else ("num_grad_updates", "critic_loss")
            done = sum(r[key] for r in results)
            losses = [r[loss] for r in results]
            print(f"offpolicy (k3) {name}: {iters} iterations of {rows} transitions, {done} updates on {on_card}, "
                  f"{results[-1]['timesteps_total'] / wall:.1f} env-steps/s, losses "
                  f"{[round(x, 4) for x in losses]}", flush=True)
            check(f"offpolicy (k3) {name} updates counted", done == iters * updates, f"{done} of {iters * updates}")
            check(f"offpolicy (k3) {name} learner on the card", on_card == {device}, f"{on_card}")
            check(f"offpolicy (k3) {name} losses finite", all(math.isfinite(x) for x in losses), f"{losses}")
            out[name] = {"updates": done, "env_steps_per_s": results[-1]["timesteps_total"] / wall}
    finally:
        cluster = session_processes(global_worker.head_proc.pid)
        ray_tpu_torch.shutdown()
    await_no_leftover("offpolicy (k3)", cluster, before)
    return out


def build_phase(att):
    """Build every kernel source at once; print registers and spills per
    kernel (ptxas), failing if an sm90 kernel (the f32 ones included)
    spills, and the sm90 kernels' shared memory and CTAs per SM."""
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
                check(f"ptxas: {kernel.group(1) if kernel else entry} spills nothing",
                      bool(spill) and spill.groups() == ("0", "0"),
                      spill.group(0) if spill else "no spill line in the report")
    for name, threads in (("attn_fwd_sm90", 256), ("attn_bwd_sm90", 128), ("attn_fwd_sm90_d128", 288),
                          ("attn_bwd_sm90_d128", 256)):
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        lib = att._kernels(name.replace("attn", "attention"))
        err = getattr(lib, f"rtt_{name}_occupancy")(ctypes.byref(smem), ctypes.byref(ctas))
        check(f"{name} occupancy query", err == 0, f"error {err}")
        print(f"occupancy {name}_kernel: {smem.value} bytes of dynamic shared memory, "
              f"{ctas.value} CTAs (of {threads} threads) per SM", flush=True)
    for name, threads in (("attn_fwd_sm90_f32", {64: 256, 128: 256}), ("attn_bwd_sm90_f32", {64: 256, 128: 128})):
        for D in (64, 128):
            smem, ctas = ctypes.c_int(), ctypes.c_int()
            lib = att._kernels(name.replace("attn", "attention"))
            err = getattr(lib, f"rtt_{name}_occupancy")(D, ctypes.byref(smem), ctypes.byref(ctas))
            check(f"{name} D={D} occupancy query", err == 0, f"error {err}")
            print(f"occupancy {name}_kernel<{D}>: {smem.value} bytes of dynamic shared memory, "
                  f"{ctas.value} CTAs (of {threads[D]} threads) per SM", flush=True)
    for backward, name, threads in ((0, "attn_fwd_kernel", 128), (1, "attn_bwd_kernel", 256)):
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        err = att._kernels("causal_attention").rtt_attn_occupancy(0, 128, backward, ctypes.byref(smem),
                                                                  ctypes.byref(ctas))
        check(f"{name}<bf16, 128> occupancy query", err == 0, f"error {err}")
        print(f"occupancy {name}<bf16, 128> (wmma): {smem.value} bytes of dynamic shared memory, "
              f"{ctas.value} CTAs (of {threads} threads) per SM", flush=True)


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
    with timed("2 build"):
        build_phase(att)

    # 3. kernels
    with timed("3 kernels"):
        max_err = kernel_phase(att)
        determinism_phase(att)
        times, plain, library, bounds = timing_phase(att)

    # 4. the slice, then path (d)
    with timed("4 slice (a)-(d)"):
        launches, direct = slice_phase(att, smi)
        d128_phase(att)

    # 5. (e) the product path: the slice through TorchTrainer in a GPU worker
    with timed("5 (e) trainer"):
        trainer_phase(kind, smi, direct)

    # 6. (f) Llama-2-7B direct: the head-dim-128 kernels at its prefill and
    # long shapes, then the model.  The sm90_d128 kernels' line reads (f)'s
    # launches and the prefill shape's numbers; the wmma kernels' line
    # (on no route: no launches) their direct launches at the prefill
    # shape; both carry the long shape's numbers beside.
    with timed("6 (f) llama direct"):
        d128 = llama_kernel_phase(att)
        llama_launches, _, direct_tokens = llama_phase(att, smi)
    long = {}
    for route in D128_ROUTES:
        for name in (FWD_COUNTERS[route], BWD_COUNTERS[route]):
            launches[name] = llama_launches[name]
            for table, value in zip((max_err, times, plain, library, bounds), d128[LLAMA_ATTN]):
                table[name] = value[name]
            l_err, l_times, l_plain, l_library, l_bounds = d128[LLAMA_LONG_ATTN]
            long[name] = {"shape": list(LLAMA_LONG_ATTN), "max_abs_err": l_err[name], "ms": l_times[name],
                          "plain_ms": l_plain[name], "bound_ms": l_bounds[name][0], "bound_by": l_bounds[name][1],
                          "library_ms": l_library[name]}

    # 7. (g) the product path: serve.run(llm_deployment(...)) on a GPU replica
    with timed("7 (g) serve"):
        static = serve_phase(kind, smi, direct_tokens)

    # 8. (h) the step DAG: GPT-2 124M in float32 through TorchTrainer's
    # eager per-step path and TrainStepDag, on the sm90_f32 kernels.  Their
    # line reads (h)'s launches (both runs) and (h)'s shape's error and
    # times; the wmma line carries its float32 numbers at that shape under
    # "f32", beside its D=128 ones.
    with timed("8 (h) step DAG"):
        f32_err, f32_times, f32_plain, f32_library, f32_bounds = step_dag_kernel_phase(att)
        runs = step_dag_phase(kind, smi)
    f32 = {}
    for name in (FWD_COUNTERS["sm90_f32"], BWD_COUNTERS["sm90_f32"]):
        launches[name] = sum(run["launches"][name] for run in runs.values())
        for table, value in zip((max_err, times, plain, library, bounds),
                                (f32_err, f32_times, f32_plain, f32_library, f32_bounds)):
            table[name] = value[name]
    for name in (FWD_COUNTERS["wmma"], BWD_COUNTERS["wmma"]):
        f32[name] = {"shape": list(STEP_DAG_ATTN), "dtype": "float32", "max_abs_err": f32_err[name],
                     "ms": f32_times[name], "plain_ms": f32_plain[name], "bound_ms": f32_bounds[name][0],
                     "bound_by": f32_bounds[name][1], "library_ms": f32_library[name]}

    # 9. (i) the continuous-batching engine: (i1) in this process at
    # Llama-2-7B's widths in float32, (i2) served over Llama-2-7B in bf16
    with timed("9 (i) engine"):
        engine_check_phase(smi)
        engine_serve_phase(kind, smi, static)

    # 10. (j) RLlib's on-policy family: (j1) the PPO learner on the card
    # against the CPU; (j2) PPO at bench_rllib.py's configuration, rollout
    # workers as CPU actors; (j3) IMPALA and APPO.  No kernel of its own.
    with timed("10 (j) rllib"):
        rllib_learner_phase(smi)
        rllib_phase(smi)

    # 11. (k) RLlib's off-policy family: (k1) SAC, TD3 and DQN updates on the
    # card against the CPU; (k2) bench_rllib.py's SAC loop on the card; (k3)
    # SAC, TD3, DDPG and DQN through a cluster.  No kernel of its own.
    with timed("11 (k) rllib off-policy"):
        offpolicy_learner_phase(smi)
        sac_bench_phase(smi)
        offpolicy_cluster_phase(smi)

    return finish(kernel_report(launches, max_err, times, plain, library, bounds, long, f32), kind)


def kernel_report(launches, max_err, times, plain, library, bounds, long, f32):
    d128 = "launches from Llama-2-7B's apply and loss (phase (f)); error and times at its prefill shape B=1 S=256 H=32 D=128"
    info = {  # name -> (source, replaces, status)
        "causal_attention_fwd_sm90": (
            "ray_tpu_torch/ops/csrc/attention_fwd_sm90.cu", f"{TPU_KERNELS}:1137",  # _splash_attention_forward
            "ported (wgmma, TMA); bf16 at D=64, the GPT-2 path's forward (slice (b)); "
            "also serves impl='flash' (flash_attention.py:758)"),
        "causal_attention_fwd_sm90_d128": (
            "ray_tpu_torch/ops/csrc/attention_fwd_sm90_d128.cu", f"{TPU_KERNELS}:1137",
            f"ported (wgmma, TMA in 64-column halves, producer warp); bf16 at D=128, Llama's forward; {d128}"),
        "causal_attention_fwd_sm90_f32": (
            "ray_tpu_torch/ops/csrc/attention_fwd_sm90_f32.cu", f"{TPU_KERNELS}:1137",
            "ported (mma.sync 3xTF32, TMA); float32 at D=64 and 128: launches from the step DAG phase (h), GPT-2 "
            "124M in float32 (eager and DAG runs); error and times at its attention, B=4 S=1024 H=12 D=64; bound at "
            "3xTF32 (494.7/3 TFLOP/s)"),
        "causal_attention_fwd_wmma": (
            "ray_tpu_torch/ops/csrc/causal_attention.cu", f"{TPU_KERNELS}:1137",
            "ported (WMMA), on no route: the in-run yardstick of the sm90_d128 forward (error and times from direct "
            "launches at B=1 S=256 H=32 D=128) and of the sm90_f32 forward (float32, FMA path, under 'f32')"),
        "causal_attention_bwd_sm90": (
            "ray_tpu_torch/ops/csrc/attention_bwd_sm90.cu", f"{TPU_KERNELS}:2196",  # _splash_attention_bwd_dkv, fused
            "ported (wgmma, TMA, bulk reduce-add of dq in key-tile order); bf16 at D=64, the GPT-2 path's backward (slice (b)); "
            "also serves impl='flash' (flash_attention.py:1121/1456)"),
        "causal_attention_bwd_sm90_d128": (
            "ray_tpu_torch/ops/csrc/attention_bwd_sm90_d128.cu", f"{TPU_KERNELS}:2196",
            "ported (wgmma, TMA in 64-column halves, two warpgroups of 64 keys, bulk reduce-add of dq in key-tile "
            "order); "
            f"bf16 at D=128, Llama's backward; {d128}"),
        "causal_attention_bwd_sm90_f32": (
            "ray_tpu_torch/ops/csrc/attention_bwd_sm90_f32.cu", f"{TPU_KERNELS}:2196",
            "ported (mma.sync 3xTF32, TMA, dq added in key-tile order); float32 at D=64 and 128: launches from the "
            "step DAG phase (h) (eager and DAG runs); error and times at B=4 S=1024 H=12 D=64; bound at 3xTF32"),
        "causal_attention_bwd_wmma": (
            "ray_tpu_torch/ops/csrc/causal_attention.cu", f"{TPU_KERNELS}:2196",
            "ported (WMMA, dq by atomics in no fixed order), on no route: the in-run yardstick of the sm90_d128 "
            "backward (direct launches at B=1 S=256 H=32 D=128) and of the sm90_f32 backward (float32, under 'f32')"),
    }
    return [
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
            **({"long": long[name]} if name in long else {}),
            **({"f32": f32[name]} if name in f32 else {}),
        }
        for name, (source, replaces, status) in info.items()
    ]


def finish(kernels, kind) -> int:
    """The kernels line, then 1 without the result line if any check
    failed, else the result line and 0."""
    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} check(s) failed: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
