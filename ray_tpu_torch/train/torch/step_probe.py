"""Train-step probe: per-step breakdown spans, jitter stats, MFU.

Extends the flight recorder to the training plane (PAPERS.md §2:
Pathways treats per-step dispatch latency and step jitter as the scarce
resources of single-controller accelerator training — you cannot drive them down
without measuring them).  A ``StepProbe`` wraps a user train loop:

    probe = StepProbe("gpt2_124m", flops_per_step=6 * n_params * tokens)
    for _ in range(steps):
        with probe.step():
            with probe.phase("data_wait"):
                tokens, targets = next(batches)
            with probe.phase("h2d"):
                tokens = tokens.to("cuda", non_blocking=True)
            with probe.phase("compute"):
                params, opt, metrics = train_step(params, opt, tokens)
                probe.block(metrics)   # torch.cuda.synchronize bracketing
            with probe.phase("metrics_fold"):
                loss = float(metrics["loss"])

Each step becomes one record stamped with the canonical
``task_events.PHASES`` ``train_*`` vocabulary, shipped to the head in
batched fire-and-forget ``TRAIN_STEP`` frames:
the head joins them next to task flight records — timeline sub-spans,
``ray_tpu_torch_train_step_seconds{phase,name}`` histograms, and rolling
``ray_tpu_torch_train_step_jitter_pct`` / ``ray_tpu_torch_train_mfu`` gauges that
``ray-tpu summary train`` and the SLO watchdog read.

``phase("compute")`` only measures what the host observes — callers must
``probe.block(out)`` inside it so async dispatch can't hide device time.
``block`` is a no-op when recording is off, preserving pipelining.

Overhead contract: with ``RAY_TPU_TASK_EVENTS=0`` every probe entry
point is a single flag check returning a shared no-op context — no dict,
no clock read, no wire bytes (asserted by tests/test_workload_events.py).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import task_events

# dense bf16 peak FLOP/s per card for MFU when the caller doesn't supply
# one, matched by substring against torch.cuda.get_device_name()
# (NVIDIA data sheets; the SXM parts)
_PEAK_FLOPS_BY_KIND = (
    ("h100", 989e12),
    ("h200", 989e12),
    ("a100", 312e12),
)

_PHASE_NAMES = ("data_wait", "h2d", "compute", "metrics_fold")


def _on_cuda(x: Any) -> bool:
    """Whether ``x`` is, or holds at any depth, a CUDA tensor."""
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return getattr(getattr(x, "device", None), "type", None) == "cuda"


class _NullCtx:
    """Shared no-op context for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()

# batch TRAIN_STEP frames: per-step sends would put a head wakeup on the
# step cadence (the exact overhead the probe exists to measure).  32
# (was 8): the resident DAG loop folds thousands of steps/s, and an
# 8-record batch put an io spawn + stats() pass every 8 steps on the hot
# loop; the staleness bound keeps slow (real-model) cadences timely.
_SHIP_BATCH = 32
_SHIP_FLUSH_S = 0.5


class StepProbe:
    """Rolling per-step recorder for one training run."""

    def __init__(
        self,
        name: str = "train",
        *,
        flops_per_step: Optional[float] = None,
        peak_flops_per_device: Optional[float] = None,
        window: int = 512,
    ):
        self.name = str(name)
        self.flops_per_step = flops_per_step
        self._peak_per_device = peak_flops_per_device
        self._peak_total: Optional[float] = None
        self.enabled = task_events.enabled
        self._durations: "collections.deque" = collections.deque(maxlen=window)
        self._seq = 0
        self._cur: Optional[Dict[str, float]] = None
        self._lock = threading.Lock()
        self._buf: List[dict] = []
        self._last_ship = 0.0

    # ------------------------------------------------------------- scopes

    def step(self):
        """Context manager around ONE training step."""
        if not self.enabled:
            return _NULL
        return self._step_ctx()

    @contextlib.contextmanager
    def _step_ctx(self):
        ph: Dict[str, float] = {}
        ph["train_step_start"] = time.time()
        self._cur = ph
        try:
            yield self
        finally:
            ph["train_step_end"] = time.time()
            self._cur = None
            self._finish(ph)

    def phase(self, name: str):
        """Sub-span inside the current step: one of data_wait / h2d /
        compute / metrics_fold."""
        if name not in _PHASE_NAMES:
            raise ValueError(
                f"unknown train phase {name!r} (choose from {_PHASE_NAMES})"
            )
        if not self.enabled or self._cur is None:
            return _NULL
        return self._phase_ctx(name)

    @contextlib.contextmanager
    def _phase_ctx(self, name: str):
        ph = self._cur
        # names validated against _PHASE_NAMES, which mirrors the
        # canonical train_* block in task_events.PHASES
        ph[f"train_{name}_start"] = time.time()
        try:
            yield None
        finally:
            ph[f"train_{name}_end"] = time.time()

    def block(self, x: Any) -> Any:
        """Device-sync bracketing for phase("compute"): when ``x`` holds a
        CUDA tensor (at any depth of a dict/list/tuple), waits for the card
        with ``torch.cuda.synchronize()``.  Syncs only while measuring, so
        the disabled path keeps async dispatch."""
        if self.enabled and _on_cuda(x):
            import torch

            torch.cuda.synchronize()
        return x

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Rolling window summary: step-time percentiles, jitter, MFU."""
        durs = sorted(self._durations)
        n = len(durs)
        if n == 0:
            return {"name": self.name, "steps": 0}
        p50 = durs[int(0.50 * (n - 1))]
        p99 = durs[int(0.99 * (n - 1))]
        out: Dict[str, Any] = {
            "name": self.name,
            "steps": self._seq,
            "window": n,
            "p50_s": p50,
            "p99_s": p99,
            "max_s": durs[-1],
            "mean_s": sum(durs) / n,
            "jitter_pct": ((p99 - p50) / p50 * 100.0) if p50 > 0 else 0.0,
        }
        mfu = self._mfu(out["mean_s"])
        if mfu is not None:
            out["mfu"] = mfu
        return out

    def _mfu(self, mean_step_s: float) -> Optional[float]:
        if not self.flops_per_step or mean_step_s <= 0:
            return None
        if self._peak_total is None:
            per = self._peak_per_device
            n_dev = 1
            try:
                import torch

                # one process drives one card (torch.cuda.current_device)
                if per is None and torch.cuda.is_available():
                    kind = torch.cuda.get_device_name()
                    for key, flops in _PEAK_FLOPS_BY_KIND:
                        if key in kind.lower():
                            per = flops
                            break
            except Exception:  # graftlint: disable=silent-except -- no CUDA: MFU simply unavailable
                pass
            if per is None:
                return None
            self._peak_total = per * n_dev
        return self.flops_per_step / (mean_step_s * self._peak_total)

    # ----------------------------------------------------------- shipping

    def _finish(self, ph: Dict[str, float]) -> None:
        self._durations.append(
            max(0.0, ph["train_step_end"] - ph["train_step_start"])
        )
        rec = {
            "name": self.name,
            "seq": self._seq,
            "pid": os.getpid(),
            "phases": ph,
        }
        self._seq += 1
        with self._lock:
            self._buf.append(rec)
            now = ph["train_step_end"]
            if (
                len(self._buf) < _SHIP_BATCH
                and now - self._last_ship < _SHIP_FLUSH_S
            ):
                return
            batch, self._buf = self._buf, []
            self._last_ship = now
        self._ship(batch)

    def record_step(self, phases: Dict[str, float]) -> None:
        """Append one PRE-STAMPED step record (canonical ``train_*`` stamp
        names, ``train_step_start``/``train_step_end`` required).

        The resident DAG train loop (the step DAG, not ported yet) stamps its
        phases across three pipelined executor threads — feeder, step,
        fold — so the scoped ``step()``/``phase()`` contexts (which assume
        one thread walking the phases in order) cannot be used; the fold
        stage assembles the full dict and hands it over here.  Disabled
        path: one flag check, nothing allocated."""
        if not self.enabled:
            return
        self._finish(dict(phases))

    def flush(self) -> None:
        """Ship buffered records (end of training / tests)."""
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            self._ship(batch)

    def _ship(self, batch: List[dict]) -> None:
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.protocol import MsgType

        try:
            cw = worker_mod._require_connected()
        except Exception:
            return  # standalone loop outside a cluster: local stats only
        st = self.stats()
        payload = {
            "name": self.name,
            "node_id": cw.node_id,
            "steps": batch,
            "stats": {
                k: v for k, v in st.items() if isinstance(v, (int, float))
            },
        }
        try:
            cw.io.spawn(cw.conn.send(MsgType.TRAIN_STEP, payload))
        except Exception:  # graftlint: disable=silent-except -- observability is best-effort; training itself already advanced
            pass
