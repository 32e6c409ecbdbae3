"""PPO's rollout time against the torch threads of each rollout worker.

    python -m ray_tpu_torch.tools.rllib_rollout_threads [--threads 1 2 3 8] [--iters 3]

chip_smoke.py's phase (j2) configuration (nature CNN, 2 rollout workers
x 32 SyntheticPixelEnv envs x 50 steps, minibatch 800, 2 epochs, lr 1e-3)
with each worker granted, and running, `t` torch threads, for each `t` of
`--threads`, each on a cluster of its own with max(8, 2 t) logical CPUs:
beyond 4 threads a worker the two workers hold more threads than the
host's 8 cores (the oversubscribed case, as torch's default of one thread
per core gives).  For each: one warm-up iteration, then `--iters`
iterations; the mean seconds of rollout (slowest worker), transfer,
host-to-device copy and learning, and env-steps/s.  The learner runs on
the card.  Prints the card's name and power limit first, then one JSON
line per setting.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time


def run(threads: int, iters: int) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch.rllib import AlgorithmConfig, SyntheticPixelEnv

    ray_tpu_torch.init(num_cpus=max(8, 2 * threads))
    try:
        algo = (
            AlgorithmConfig(learner_device="cuda", num_cpus_per_worker=threads)
            .environment(functools.partial(SyntheticPixelEnv, num_envs=32, shaped=True, seed=11))
            .rollouts(num_rollout_workers=2, num_envs_per_worker=32)
            .training(lr=1e-3, train_batch_size=3200, rollout_fragment_length=50, sgd_minibatch_size=800,
                      num_sgd_iter=2, model={"type": "cnn"})
            .build()
        )
        try:
            algo.train()
            t0 = time.perf_counter()
            runs = [algo.train() for _ in range(iters)]
            wall = time.perf_counter() - t0
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()
    mean = {k: sum(r[k] for r in runs) / iters for k in ("rollout_s", "transfer_s", "h2d_s", "learn_s")}
    steps = sum(r["timesteps_this_iter"] for r in runs)
    return {"threads_per_worker": threads, "env_steps_per_s": steps / wall, "iteration_s": wall / iters, **mean}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 3, 8])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for threads in args.threads:
        print(json.dumps(run(threads, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
