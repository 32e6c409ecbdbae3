"""The trainer path's first fit after `init`, against later fits and the
direct path: its tokens/s, and which processes and threads spent CPU time
while its steps ran.

    python -m ray_tpu_torch.tools.trainer_first_fit [--fits 2] [--idle 20]

Run it from the repo root on a machine with a CUDA card: it imports
`chip_smoke.py` there and takes that script's batch recipe, timed loop and
train loop (`slice_batches`, `timed_steps`, `trainer_loop`), shipping the
module to the worker by value, so a fit here runs what phase (e) runs.

Sequence: build the kernels; one direct run in this process (slice (b)'s
steps); then two clusters of `--fits` fits each.  The first cluster fits as
soon as `init` returns, as phase (e) does; the second waits `--idle`
seconds after `init` first.  For each fit it prints tokens/s and the ratio
to the direct run, the worker's pid, the CPU seconds of each thread of the
worker over its warm-up and timed steps, and the CPU seconds every other
process on the machine spent in that window (this process reads /proc
every 50 ms while a fit runs).  Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

_HZ = os.sysconf("SC_CLK_TCK")


def _cpu_ticks(path: str):
    """utime + stime of /proc/<pid> or /proc/<pid>/task/<tid>, or None."""
    try:
        with open(f"{path}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return int(fields[11]) + int(fields[12])


def diag_loop(config):
    """chip_smoke's train loop (`config["loop"]`, shipped by value), plus
    the CPU seconds of each thread of this worker and the wall-clock window
    of its warm-up and timed steps."""
    from ray_tpu_torch.air import session

    loop, names, reports, window = config["loop"], {}, [], {}
    real_timed, real_report = loop.__globals__["timed_steps"], session.report

    def thread_ticks():
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/comm") as f:
                    names.setdefault(int(tid), f.read().strip())
            except OSError:
                pass
        names.update({t.native_id: t.name for t in threading.enumerate()})
        return {int(tid): _cpu_ticks(f"/proc/self/task/{tid}") for tid in os.listdir("/proc/self/task")}

    def timed(*args):
        before, window["t0"] = thread_ticks(), time.time()
        out = real_timed(*args)
        window["t1"], after = time.time(), thread_ticks()
        window["threads"] = {
            names.get(tid, str(tid)): (after[tid] - (before.get(tid) or 0)) / _HZ
            for tid in after if after[tid] is not None
        }
        return out

    loop.__globals__["timed_steps"], session.report = timed, lambda metrics, checkpoint=None: reports.append(metrics)
    try:
        loop(config)
    finally:
        loop.__globals__["timed_steps"], session.report = real_timed, real_report
    real_report({**reports[0], **window})


class _ProcSampler:
    """CPU ticks of every process on the machine, read every 50 ms."""

    def __init__(self):
        self.samples = []
        self.cmds = {}  # pid -> command line, read when the pid is first seen
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            now = time.time()
            ticks = {int(e): _cpu_ticks(f"/proc/{e}") for e in os.listdir("/proc") if e.isdigit()}
            for pid in ticks.keys() - self.cmds.keys():
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        self.cmds[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:80]
                except OSError:
                    self.cmds[pid] = "?"
            self.samples.append((now, ticks))
            self._stop.wait(0.05)

    def stop(self):
        self._stop.set()
        self._thread.join()

    def busiest(self, t0: float, t1: float, n: int = 6):
        """[(cpu seconds, pid, command)] of the `n` busiest processes over [t0, t1]."""
        a = max((s for s in self.samples if s[0] <= t0), key=lambda s: s[0], default=self.samples[0])[1]
        b = min((s for s in self.samples if s[0] >= t1), key=lambda s: s[0], default=self.samples[-1])[1]
        out = []
        for pid, tb in b.items():
            if tb is not None:
                out.append(((tb - (a.get(pid) or 0)) / _HZ, pid, self.cmds.get(pid, "?")))
        return sorted(out, reverse=True)[:n]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fits", type=int, default=2)
    p.add_argument("--idle", type=float, default=20.0)
    args = p.parse_args()
    import cloudpickle
    import torch

    if not torch.cuda.is_available():
        print("trainer_first_fit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    import ray_tpu_torch
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    cloudpickle.register_pickle_by_value(chip_smoke)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build_all(chip_smoke.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config.gpt2_124m()
    batch, warmup, steps = chip_smoke.SLICE_BATCH, chip_smoke.SLICE_WARMUP, chip_smoke.SLICE_STEPS
    _, (tok, tgt) = chip_smoke.slice_batches(cfg, batch)
    bundle = make_train_step(GPT2Model(cfg, seed=0))
    params, opt = bundle.init(0)
    _, dt = chip_smoke.timed_steps(bundle, params, opt, tok, tgt, warmup, steps)
    direct = batch * cfg.block_size * steps / dt
    del bundle, params, opt, tok, tgt
    torch.cuda.empty_cache()
    print(f"direct: {direct:.0f} tokens/s, {dt / steps * 1e3:.2f} ms/step", flush=True)
    for idle in (0.0, args.idle):
        ray_tpu_torch.init(num_cpus=4)
        try:
            time.sleep(idle)
            for i in range(args.fits):
                sampler = _ProcSampler()
                try:
                    m = TorchTrainer(diag_loop, train_loop_config={"loop": chip_smoke.trainer_loop, "batch": batch,
                                                                   "warmup": warmup, "steps": steps},
                                     scaling_config=ScalingConfig(num_workers=1)).fit().metrics
                finally:
                    sampler.stop()
                print(f"idle {idle:.0f} s, fit {i}: {m['tokens_per_s']:.0f} tokens/s, {m['ms_per_step']:.2f} ms/step, "
                      f"ratio {m['tokens_per_s'] / direct:.4f}; worker {m['pid']}, window {m['t1'] - m['t0']:.2f} s", flush=True)
                threads = sorted(m["threads"].items(), key=lambda kv: -kv[1])
                print("  worker threads (cpu s): " + ", ".join(f"{n} {s:.2f}" for n, s in threads if s > 0), flush=True)
                for cpu, pid, cmd in sampler.busiest(m["t0"], m["t1"]):
                    print(f"  process {pid} cpu {cpu:.2f} s: {cmd}", flush=True)
        finally:
            ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
