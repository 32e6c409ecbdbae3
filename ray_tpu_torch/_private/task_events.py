"""Task-lifecycle flight recorder: per-phase timestamps from submit to done.

Analog of the reference's task-event pipeline (reference:
src/ray/core_worker/task_event_buffer.cc — per-attempt state-transition
timestamps flushed to the GCS task manager and joined into
`ray list tasks --detail` / the timeline; and the dispatch-latency focus
of Pathways' single-controller tracing, PAPERS.md §2).

A task's life is stamped at every hop it takes through the system:

    driver            head                 worker
    ------            ----                 ------
    submit       →    head_enqueue    →    worker_dequeue
                      dispatch             arg_fetch_start / arg_fetch_end
                                           exec_start / exec_end
                                           put_start / put_end
    (result)     ←    done            ←    (TASK_DONE carries the stamps)

The stamps ride the TaskSpec wire dict (``phases``) to the worker and come
back on the TASK_DONE frame; the head joins them into one flight record
per task and aggregates per-phase histograms (queue-wait, arg-fetch, exec,
put, e2e).  Timestamps are ``time.time()``.  Clock caveat: queue_wait,
arg_fetch, exec, and put are computed between stamps taken by ONE process,
so they are immune to clock skew; ``deliver`` (head → worker) and ``e2e`` (driver →
head) cross processes — exact on one host (shared wall clock), off by the
NTP skew on multi-node clusters (and clamped at 0, never negative).

Overhead contract: when recording is off (``RAY_TPU_TASK_EVENTS=0``) every
stamp site is a single flag/None check — no dict allocation, no clock
read.  The driver's flag is authoritative for a task: a spec submitted
without a phases dict is never stamped downstream (head and worker sites
gate on ``spec.phases is not None``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

# Canonical phase-stamp vocabulary, in lifecycle order.  graftlint GL008
# checks literal stamp() sites against this set; the head's record join and
# the monotonic-ordering test both iterate it in order.
PHASES = (
    "submit",  # driver: spec built, about to enqueue on the head conn
    "head_enqueue",  # head: SUBMIT frame decoded, entering the task table
    "dispatch",  # head: scheduler picked a worker, PUSH_TASK sent
    "worker_dequeue",  # worker: execution loop picked the task up
    "arg_fetch_start",  # worker: resolving args + fetching the function
    "arg_fetch_end",
    "exec_start",  # worker: user code entered
    "exec_end",
    "put_start",  # worker: serializing + storing return values
    "put_end",
    "done",  # head: TASK_DONE frame joined into the record
    # -- compiled-DAG steps (ray_tpu_torch/dag/executor.py) --------------
    # A compiled step never transits the head, so its record is a separate
    # sub-lifecycle stamped entirely by the executing node and shipped on
    # the fire-and-forget DAG_STEP frame: block on input channels → run the
    # bound method → push to consumer channels.
    "dag_channel_wait_start",  # executor: blocking on input channels
    "dag_channel_wait_end",
    "dag_exec_start",  # executor: bound method entered
    "dag_exec_end",
    "dag_push_end",  # executor: result handed to every consumer channel
    # -- serve request lifecycle (ray_tpu_torch/serve/tracing.py) --------------
    # A serve request is its own sub-lifecycle: the ingress (HTTP proxy or
    # a bare DeploymentHandle) stamps the front, the replica stamps the
    # back, and the completed record ships to the head on a SERVE_TRACE
    # frame.  The LLM path additionally splits model time at the first
    # token (prefill/decode boundary) — the stamps TTFT/TPOT derive from.
    "serve_proxy_recv",  # ingress: request received (proxy or handle)
    "serve_route",  # ingress: deployment resolved, replica picked
    "serve_replica_recv",  # replica: handle_request entered
    "serve_queue_enter",  # replica: request joined the batch queue
    "serve_queue_exit",  # replica: released into a batch
    "serve_batch_assembled",  # replica: padded tensor batch built
    "serve_prefill_start",  # replica: prefill dispatched
    "serve_first_token",  # replica: first token's logits ready (TTFT end)
    "serve_decode_end",  # replica: last token decoded
    "serve_handler_end",  # replica: handler returned (record sealed)
    # -- train step lifecycle (ray_tpu_torch/train/torch/step_probe.py) ----------
    # One record per training step, stamped entirely by the training
    # process (clock-skew-immune by construction) and shipped batched on
    # TRAIN_STEP frames.  `compute` brackets the jitted step with
    # block_until_ready so async dispatch can't hide device time.
    "train_step_start",
    "train_data_wait_start",  # input pipeline: waiting on the next batch
    "train_data_wait_end",
    "train_h2d_start",  # host→device transfer of the batch
    "train_h2d_end",
    "train_compute_start",  # jitted step dispatch → block_until_ready
    "train_compute_end",
    "train_metrics_fold_start",  # host-side metrics/scalar extraction
    "train_metrics_fold_end",
    "train_step_end",
)

# Derived per-phase durations: name -> (start stamp, end stamp).
# queue_wait/arg_fetch/exec/put pair stamps from ONE process and are immune
# to cross-node clock skew; deliver (head→worker) and e2e (driver→head)
# cross processes — exact on one host, ±NTP skew across nodes, and always
# clamped at 0 so skew can never emit negative latencies.
DURATIONS = {
    "queue_wait": ("head_enqueue", "dispatch"),
    "deliver": ("dispatch", "worker_dequeue"),
    "arg_fetch": ("arg_fetch_start", "arg_fetch_end"),
    "exec": ("exec_start", "exec_end"),
    "put": ("put_start", "put_end"),
    "e2e": ("submit", "done"),
    # compiled-DAG step phases: all three pair stamps from ONE process
    # (the executing node), so they are immune to clock skew by
    # construction.  Eager records lack these stamps and skip them.
    "dag_channel_wait": ("dag_channel_wait_start", "dag_channel_wait_end"),
    "dag_exec": ("dag_exec_start", "dag_exec_end"),
    "dag_push": ("dag_exec_end", "dag_push_end"),
    # serve request stages: route/deliver cross processes (ingress →
    # replica, ±NTP skew off-host); everything from replica_recv on pairs
    # stamps from the replica process.  Eager/task records lack these
    # stamps and skip them.
    "serve_route": ("serve_proxy_recv", "serve_route"),
    "serve_deliver": ("serve_route", "serve_replica_recv"),
    "serve_queue_wait": ("serve_queue_enter", "serve_queue_exit"),
    "serve_batch_assemble": ("serve_queue_exit", "serve_batch_assembled"),
    "serve_prefill": ("serve_prefill_start", "serve_first_token"),
    "serve_decode": ("serve_first_token", "serve_decode_end"),
    "serve_handler": ("serve_replica_recv", "serve_handler_end"),
    "serve_e2e": ("serve_proxy_recv", "serve_handler_end"),
    # train step phases: all stamped by ONE process (the trainer), so
    # every pair is clock-skew-immune by construction.
    "train_data_wait": ("train_data_wait_start", "train_data_wait_end"),
    "train_h2d": ("train_h2d_start", "train_h2d_end"),
    "train_compute": ("train_compute_start", "train_compute_end"),
    "train_metrics_fold": ("train_metrics_fold_start", "train_metrics_fold_end"),
    "train_step": ("train_step_start", "train_step_end"),
}

# Histogram boundaries for the per-phase latency metrics (seconds).  Wide
# range: queue-wait on an idle cluster is sub-millisecond, a cold GPU
# worker spawn or a chaos-delayed dispatch reaches tens of seconds.
PHASE_HISTOGRAM_BOUNDARIES = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
)

PHASE_METRIC = "ray_tpu_torch_task_phase_seconds"
PHASE_METRIC_HELP = (
    "Per-phase task lifecycle latency (flight recorder), tagged by "
    "phase/name/node"
)

# ---- serve request plane (ray_tpu_torch/serve/tracing.py → head join) --------
# Finer boundaries than the task phases: a routed request on a warm
# replica turns around in hundreds of microseconds, while a cold LLM
# batch can take tens of seconds.
SERVE_HISTOGRAM_BOUNDARIES = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
SERVE_METRIC = "ray_tpu_torch_serve_request_seconds"
SERVE_METRIC_HELP = (
    "Per-stage serve request latency (proxy→route→queue→batch→prefill→"
    "decode), tagged by stage/deployment"
)
SERVE_TTFT_METRIC = "ray_tpu_torch_serve_ttft_seconds"
SERVE_TTFT_HELP = "Time from request receipt to the first generated token"
SERVE_TPOT_METRIC = "ray_tpu_torch_serve_tpot_seconds"
SERVE_TPOT_HELP = "Mean per-token decode time after the first token"
# TPOT sits orders of magnitude under request latency
TPOT_HISTOGRAM_BOUNDARIES = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0,
)

# ---- train step plane (ray_tpu_torch/train/torch/step_probe.py → head join) ----
TRAIN_METRIC = "ray_tpu_torch_train_step_seconds"
TRAIN_METRIC_HELP = (
    "Per-phase training step latency (data_wait/h2d/compute/metrics_fold/"
    "step), tagged by phase/name"
)
TRAIN_JITTER_METRIC = "ray_tpu_torch_train_step_jitter_pct"
TRAIN_JITTER_HELP = "Rolling step-time jitter: (p99 - p50) / p50 * 100"
TRAIN_MFU_METRIC = "ray_tpu_torch_train_mfu"
TRAIN_MFU_HELP = "Model FLOPs utilization over the rolling step window"

# THE flag: stamp sites check this module attribute directly
# (`if task_events.enabled: ...`) so the disabled hot path costs one
# attribute load + truth test per site.
enabled: bool = os.environ.get("RAY_TPU_TASK_EVENTS", "1") not in ("0", "false", "")


def set_enabled(on: bool) -> None:
    """Flip recording for THIS process (tests / programmatic opt-out).
    Cluster-wide default comes from RAY_TPU_TASK_EVENTS in each process's
    environment."""
    global enabled
    enabled = bool(on)


def new_phases() -> Dict[str, float]:
    """Fresh stamp dict for a spec being submitted now."""
    return {"submit": time.time()}


def stamp(phases: Optional[Dict[str, float]], phase: str) -> None:
    """Record `phase` at now.  Callers gate on `task_events.enabled` (or
    `spec.phases is not None`) BEFORE calling, keeping the disabled path
    to a single flag check; stamp() itself tolerates None for belt and
    suspenders at cold call sites."""
    if phases is not None:
        phases[phase] = time.time()


def durations(phases: Dict[str, float]) -> Dict[str, float]:
    """Per-phase durations (seconds) for the stamps present in a record.
    Missing stamps skip their phase; clamped at 0 so a stray clock step
    can't emit negative latencies into the histograms."""
    out: Dict[str, float] = {}
    for name, (a, b) in DURATIONS.items():
        ta, tb = phases.get(a), phases.get(b)
        if ta is not None and tb is not None:
            out[name] = max(0.0, tb - ta)
    return out


def ordered(phases: Dict[str, float]) -> list:
    """The record's stamps in canonical lifecycle order — what the
    monotonicity invariant is asserted over."""
    return [(p, phases[p]) for p in PHASES if p in phases]
