"""Where a GPT-2 training step's device time goes, from a torch.profiler trace.

    python -m ray_tpu_torch.tools.profile_train_step [--batch 18] [--steps 3]

Runs GPT-2 124M through `make_train_step` on the CUDA device (warm-up
first), traces `--steps` steps with torch.profiler, and prints the device
time by kernel group (the port's attention kernels, matmuls, loss,
optimizer, the rest), the top kernels, and the device's busy share of the
traced window's wall time.  Exits 1 if the trace holds no device kernel.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch

GROUPS = (  # first match wins; names as CUDA reports the kernels
    ("attention fwd (port kernel, sm90)", ("attn_fwd_sm90_kernel",)),
    ("attention fwd (port kernel, wmma)", ("attn_fwd_kernel",)),
    ("attention bwd (port kernel)", ("attn_bwd_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass")),
    ("loss: softmax / cross entropy", ("softmax", "nll_loss", "cross_entropy", "logsumexp")),
    ("optimizer (AdamW foreach)", ("multi_tensor_apply",)),
    ("layer norm", ("layer_norm",)),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, copies, reductions)"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=18)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step, synthetic_batch

    cfg = GPT2Config.gpt2_124m()
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok, tgt = synthetic_batch(gen, args.batch, cfg.block_size, cfg.vocab_size)
    for _ in range(3):
        params, opt, m = bundle.step(params, opt, tok, tgt)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt, m = bundle.step(params, opt, tok, tgt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device-side events, without the ranges that annotate them (such as
    # "Optimizer.step#AdamW.step"), which would count their kernels twice
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ]
    if not kernels:
        print("profile: the trace holds no device kernel", file=sys.stderr)
        return 1
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        d = e.time_range.elapsed_us()
        by_group[group_of(e.name)] += d
        by_name[e.name] += d
    total = sum(by_group.values())
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"profile GPT-2 124M B={args.batch} S={cfg.block_size} on {card}: "
          f"{args.steps} steps, wall {wall_us / args.steps / 1e3:.2f} ms/step under the profiler, "
          f"device busy {busy / args.steps / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}% of wall), "
          f"{len(kernels) // args.steps} kernels/step")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / args.steps / 1e3:9.3f} ms/step  {100 * us / total:5.1f}%  {group}")
    print("top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / args.steps / 1e3:9.3f} ms/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
