"""GPT-2 124M's training step under each remat policy, in one process.

    python -m ray_tpu_torch.tools.remat_policies [--batch 18] [--steps 10] [--rounds 2]

Runs `make_train_step` on the CUDA device at batch `--batch`, S=1024, bf16
compute, from the same weights and batch, under remat "full", "dots",
"lite" and none, in turn, `--rounds` times; for each: 2 warm-up steps, then
`--steps` timed steps (host clock, synchronised), and the peak device
memory.  Prints the card's name and power limit first; the last loss of
every run must be the same (remat changes what is kept, not what is
computed), else it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch

POLICIES = (("full", True), ("dots", True), ("lite", True), ("none", False))


def run(policy: str, remat: bool, batch: int, steps: int):
    """(ms per step, peak GiB, last loss) of one run."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step, synthetic_batch

    cfg = dataclasses.replace(GPT2Config.gpt2_124m(), remat=remat, remat_policy=policy)
    tok, tgt = synthetic_batch(torch.Generator(device="cuda").manual_seed(1), batch, cfg.block_size, cfg.vocab_size)
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    for _ in range(2):
        params, opt, m = bundle.step(params, opt, tok, tgt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = bundle.step(params, opt, tok, tgt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, torch.cuda.max_memory_allocated() / 2**30, m["loss"].item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=18)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("remat_policies: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    losses = set()
    for rnd in range(args.rounds):
        for policy, remat in POLICIES:
            ms, peak, loss = run(policy, remat, args.batch, args.steps)
            losses.add(loss)
            print(f"remat_policies round {rnd} GPT-2 124M B={args.batch} S=1024 bf16, remat {policy}: {ms:.2f} ms/step, "
                  f"peak memory {peak:.2f} GiB, last loss {loss:.6f} ({card})", flush=True)
            torch.cuda.empty_cache()
    if len(losses) != 1:
        print(f"remat_policies: the policies' last losses differ: {sorted(losses)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
