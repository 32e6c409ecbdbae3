"""Gang-scheduled resident training steps over compiled-DAG channels.

The port of the JAX package's ``train/jax/step_dag.py``.  The eager path
drives every training step as one actor-call round trip per step per
worker, paying the submit → dispatch → dequeue control-plane tax on the
step cadence — exactly the scarce resource Pathways (PAPERS.md §2) says
single-controller training must protect.  This module compiles the step
into a **resident DAG** instead:

    InputNode(step_idx)
        → dag_shard   (feeder: data_wait + h2d, UNLOCKED — overlaps compute)
        → dag_step    (train step on device-resident params/opt state)
        → dag_fold    (metrics fold to host scalars, UNLOCKED)
        → driver

compiled once per worker with ``gang=True``, so every host of a multi-host
mesh installs its channels in one concurrent ``DAG_SETUP`` round and arms
its resident loops atomically in one ``DAG_ARM`` round — no host ever runs
a step while another is still wiring.  After compile, per-step driver cost
is ONE channel write (the step index) and one channel read (the folded
metrics); params and optimizer state never leave the worker.

Double buffering: the driver keeps ``train_dag_pipeline_depth`` steps in
flight (``CompiledDag.execute_async``), and the feeder stage runs
``options(lock=False)`` so it prepares batch *N+1* (data_wait + h2d into a
per-worker staging slot) while the locked step stage still computes batch
*N*.  Ring slots bound the staging memory: a full channel ring
back-pressures the feeder, which back-pressures the driver.

Failure contract: a participant death/preemption invalidates the compiled
graph (``DagInvalidatedError``, never a hang);
``fit_spec`` then rebuilds the worker gang and resumes from the last
driver-held checkpoint at exactly the checkpointed step.  Checkpoints are
cut at drained step boundaries, so the resumed run replays a
deterministic-by-step-index data stream and reproduces the uninterrupted
run bit for bit.

Eager path preserved: the same :class:`TrainStepSpec` drives per-step
eager actor calls when ``TorchConfig(use_step_dag=False)`` — the two paths
share every state-mutating function, which is what makes the
bit-identical-weights acceptance test meaningful.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig


@dataclass
class TrainStepSpec:
    """A training run decomposed into the resident-DAG stage functions.

    Every callable runs ON the training worker.  ``data`` must be
    deterministic in ``step_idx`` (and rank) — that is what makes
    checkpoint-resume replay bit-exact.  ``step`` mutates ``state`` in
    place (params/opt stay device-resident) and returns the step's
    (possibly device-side) metrics.
    """

    build: Callable[[Dict[str, Any], int, int], Any]  # (config, rank, world) -> state
    data: Callable[[Any, int], Any]  # (state, step_idx) -> host batch
    step: Callable[[Any, Any], Dict[str, Any]]  # (state, batch) -> metrics
    fold: Optional[Callable[[Any, Any], Dict[str, Any]]] = None  # -> host scalars
    h2d: Optional[Callable[[Any, Any], Any]] = None  # (state, batch) -> device batch
    snapshot: Optional[Callable[[Any], Any]] = None  # (state) -> picklable
    restore: Optional[Callable[[Any, Any], None]] = None  # (state, snap)
    steps: int = 0
    checkpoint_every: int = 0  # 0 = only a final checkpoint
    config: Dict[str, Any] = field(default_factory=dict)
    name: str = "train_dag"
    flops_per_step: Optional[float] = None
    # device sync bracketing inside the probed compute phase (StepProbe.block);
    # host-only specs turn it off
    block_metrics: bool = True


def _default_fold(state, metrics) -> Dict[str, Any]:
    out = {}
    for k, v in dict(metrics).items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


# ---------------------------------------------------------------- worker side


class _WorkerTrainState:
    """Per-worker residency: the spec, its built state, the double-buffer
    staging slots, and the step probe.  Stage threads hand off through the
    ``staged``/``folding`` dicts (plain dict ops under the GIL; the channel
    delivery of the step index is the happens-before edge)."""

    def __init__(self, spec: TrainStepSpec, rank: int, world: int, start_step: int):
        from ray_tpu_torch._private import task_events
        from ray_tpu_torch.train.torch.step_probe import StepProbe

        self.spec = spec
        self.rank = rank
        self.world = world
        self.start_step = start_step
        self.steps_done = 0
        self.state: Any = None
        self.staged: Dict[int, Any] = {}  # idx -> device batch (feeder → step)
        self.staged_ph: Dict[int, Dict[str, float]] = {}
        self.folding: Dict[int, Any] = {}  # idx -> (metrics, phases) (step → fold)
        self.events = task_events.enabled
        self.probe = StepProbe(spec.name, flops_per_step=spec.flops_per_step)
        self.records: List[Dict[str, float]] = []  # retained stamps (tests/debug)


def worker_build(worker, spec: TrainStepSpec, checkpoint, start_step: int):
    """Eager call (before compile): build device-resident state, restoring
    from ``checkpoint`` (``{"spec_state": ..., "step": N}``) if given."""
    ts = _WorkerTrainState(spec, worker.world_rank, worker.world_size, start_step)
    ts.state = spec.build(dict(spec.config), ts.rank, ts.world)
    if checkpoint is not None:
        if spec.restore is None:
            raise ValueError("checkpoint given but the TrainStepSpec has no restore()")
        spec.restore(ts.state, checkpoint["spec_state"])
        ts.start_step = int(checkpoint["step"])
    worker._train_dag = ts
    return ts.start_step


def worker_shard(worker, idx: int) -> int:
    """Feeder stage (DAG node, ``lock=False``): produce batch ``idx`` and
    stage it device-side — runs concurrently with the locked step stage,
    which is the whole double-buffer."""
    ts: _WorkerTrainState = worker._train_dag
    ph = None
    if ts.events:
        now = time.time()
        ph = {"train_step_start": now, "train_data_wait_start": now}
    batch = ts.spec.data(ts.state, idx)
    if ph is not None:
        ph["train_data_wait_end"] = ph["train_h2d_start"] = time.time()
    if ts.spec.h2d is not None:
        batch = ts.spec.h2d(ts.state, batch)
    if ph is not None:
        ph["train_h2d_end"] = time.time()
        ts.staged_ph[idx] = ph
    ts.staged[idx] = batch
    return idx


def worker_step(worker, idx: int) -> int:
    """Step stage (DAG node, actor-locked): run the train step on the
    resident state.  The lock also fences eager ``worker_snapshot`` calls
    into step boundaries — a checkpoint can never catch a half-step."""
    ts: _WorkerTrainState = worker._train_dag
    dev = ts.staged.pop(idx)
    ph = ts.staged_ph.pop(idx, None)
    if ph is not None:
        ph["train_compute_start"] = time.time()
    metrics = ts.spec.step(ts.state, dev)
    if ph is not None:
        if ts.spec.block_metrics:
            ts.probe.block(metrics)
        ph["train_compute_end"] = time.time()
    ts.steps_done += 1
    ts.folding[idx] = (metrics, ph)
    return idx


def worker_fold(worker, idx: int) -> Dict[str, Any]:
    """Fold stage (DAG node, ``lock=False``): device metrics → host
    scalars, one StepProbe record per step (stamps assembled across the
    three stage threads — all one process, clock-skew-immune)."""
    ts: _WorkerTrainState = worker._train_dag
    metrics, ph = ts.folding.pop(idx)
    if ph is not None:
        ph["train_metrics_fold_start"] = time.time()
    fold = ts.spec.fold or _default_fold
    out = fold(ts.state, metrics)
    if ph is not None:
        ph["train_metrics_fold_end"] = ph["train_step_end"] = time.time()
        ts.probe.record_step(ph)
        ts.records.append(ph)
        if len(ts.records) > 4096:
            del ts.records[:2048]
    return out


def worker_tick(worker, idx: int) -> Dict[str, Any]:
    """The EAGER path's whole step: the same three stage functions, run
    inline on one actor call — per-step driver cost is one task round
    trip, which is precisely what the resident DAG deletes.  Sharing the
    state-mutating code with the DAG stages is what makes eager-vs-dag
    weight equality a real invariant, not a coincidence."""
    worker_shard(worker, idx)
    worker_step(worker, idx)
    return worker_fold(worker, idx)


def worker_snapshot(worker) -> Dict[str, Any]:
    """Eager call at a DRAINED step boundary: ``{"spec_state", "step"}``.
    The actor lock (shared with the step stage) guarantees state holds an
    integer number of steps."""
    ts: _WorkerTrainState = worker._train_dag
    if ts.spec.snapshot is None:
        raise ValueError("TrainStepSpec has no snapshot(): checkpointing unavailable")
    return {
        "spec_state": ts.spec.snapshot(ts.state),
        "step": ts.start_step + ts.steps_done,
    }


def worker_finish(worker) -> int:
    """Flush the probe's buffered TRAIN_STEP records; returns steps run."""
    ts = getattr(worker, "_train_dag", None)
    if ts is None:
        return 0
    ts.probe.flush()
    return ts.steps_done


def worker_records(worker) -> List[Dict[str, float]]:
    """Retained per-step phase stamps (tests assert the double-buffer
    overlap from these)."""
    ts = getattr(worker, "_train_dag", None)
    return list(ts.records) if ts is not None else []


# ---------------------------------------------------------------- driver side


class TrainStepDag:
    """Driver handle for one gang of resident train loops.

    ``run(n)`` keeps ``pipeline_depth`` steps in flight and returns the
    per-step folded metrics (rank 0's dict per step); it always returns
    with the pipeline drained, so ``snapshot()`` sees an exact step
    boundary.  A transport fault / participant death surfaces as
    ``DagExecutionError`` → ``DagInvalidatedError`` (never a hang) — the
    caller re-builds the gang and a fresh ``TrainStepDag`` resumes from
    the checkpoint.
    """

    def __init__(
        self,
        workers: List[Any],
        spec: TrainStepSpec,
        *,
        checkpoint: Optional[Dict[str, Any]] = None,
        start_step: int = 0,
        pipeline_depth: Optional[int] = None,
    ):
        import ray_tpu_torch
        from ray_tpu_torch.dag import InputNode, MultiOutputNode

        if not workers:
            raise ValueError("TrainStepDag needs at least one train worker")
        self._workers = list(workers)
        self._spec = spec
        self._multi = len(self._workers) > 1
        starts = ray_tpu_torch.get(
            [w.dag_train_build.remote(spec, checkpoint, start_step) for w in self._workers],
            timeout=RayConfig.train_dag_step_timeout_s,
        )
        self._next = int(starts[0])  # next step index to feed
        self._collected = self._next  # steps whose metrics the driver holds
        self._depth = max(1, int(pipeline_depth or RayConfig.train_dag_pipeline_depth))
        self._pending: "collections.deque" = collections.deque()
        with InputNode() as inp:
            chains = [
                w.dag_fold.bind(
                    w.dag_step.bind(w.dag_shard.bind(inp).options(lock=False))
                ).options(lock=False)
                for w in self._workers
            ]
        graph = MultiOutputNode(chains) if self._multi else chains[0]
        # one concurrent DAG_SETUP round + one DAG_ARM round: the whole
        # gang arms atomically or compile raises with nothing resident
        self._compiled = graph.compile(gang=True)

    @property
    def compiled(self):
        return self._compiled

    @property
    def step_index(self) -> int:
        """Next step index the driver will feed."""
        return self._next

    @property
    def invalidated(self) -> Optional[str]:
        return self._compiled.invalidated

    def run(self, num_steps: int, on_metrics=None) -> List[Dict[str, Any]]:
        """Drive ``num_steps`` resident steps, pipelined ``_depth`` deep;
        returns their folded metrics in step order, pipeline drained."""
        target = self._collected + int(num_steps)
        history: List[Dict[str, Any]] = []
        timeout = RayConfig.train_dag_step_timeout_s
        while self._collected < target:
            while len(self._pending) < self._depth and self._next < target:
                self._pending.append(self._compiled.execute_async(self._next))
                self._next += 1
            fut = self._pending.popleft()
            outs = fut.result(timeout=timeout)
            metrics = outs[0] if self._multi else outs
            history.append(metrics)
            self._collected += 1
            if on_metrics is not None:
                on_metrics(self._collected - 1, metrics)
        return history

    def step(self) -> Dict[str, Any]:
        """One synchronous resident step (dispatch-overhead benchmarks)."""
        return self.run(1)[0]

    def snapshot(self) -> Dict[str, Any]:
        """Checkpoint at the current (drained) step boundary from rank 0 —
        DP ranks hold identical post-allreduce params by construction."""
        import ray_tpu_torch

        if self._pending:
            raise RuntimeError("snapshot() with steps in flight; run() drains first")
        snap = ray_tpu_torch.get(
            self._workers[0].dag_train_snapshot.remote(),
            timeout=RayConfig.train_dag_step_timeout_s,
        )
        if snap["step"] != self._collected:
            raise RuntimeError(
                f"checkpoint step {snap['step']} != drained boundary {self._collected}"
            )
        return snap

    def finish(self) -> None:
        """Flush worker probes (best-effort) — call before teardown."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                [w.dag_train_finish.remote() for w in self._workers], timeout=60
            )
        except Exception:  # noqa: BLE001 -- observability flush on a possibly-dead gang
            pass

    def teardown(self) -> None:
        self.finish()
        self._compiled.teardown()


# ------------------------------------------------------------------ trainers


class _EagerSpecDriver:
    """The preserved eager path: the same spec functions driven by
    per-step actor calls (one round trip per step per worker)."""

    def __init__(self, workers, spec, checkpoint, start_step):
        import ray_tpu_torch

        self._workers = list(workers)
        starts = ray_tpu_torch.get(
            [w.dag_train_build.remote(spec, checkpoint, start_step) for w in self._workers],
            timeout=RayConfig.train_dag_step_timeout_s,
        )
        self._next = int(starts[0])

    def run(self, num_steps: int, on_metrics=None) -> List[Dict[str, Any]]:
        import ray_tpu_torch

        history = []
        for _ in range(int(num_steps)):
            refs = [w.dag_tick.remote(self._next) for w in self._workers]
            ms = ray_tpu_torch.get(refs, timeout=RayConfig.train_dag_step_timeout_s)
            history.append(ms[0])
            if on_metrics is not None:
                on_metrics(self._next, ms[0])
            self._next += 1
        return history

    def snapshot(self) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._workers[0].dag_train_snapshot.remote(),
            timeout=RayConfig.train_dag_step_timeout_s,
        )

    def finish(self) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                [w.dag_train_finish.remote() for w in self._workers], timeout=60
            )
        except Exception:  # noqa: BLE001 -- best-effort probe flush
            pass

    def teardown(self) -> None:
        self.finish()


def fit_spec(trainer) -> "Result":
    """Drive a :class:`TrainStepSpec` to completion through the trainer's
    executor stack: placement group + worker gang + backend ``on_start``
    (the dcn collective group), then either the resident DAG loop
    (``TorchConfig(use_step_dag=True)``) or the eager per-step path.

    Failure handling is gang-granular: a participant
    death invalidates the compiled graph typed, the whole gang is rebuilt,
    and training resumes from the last driver-held checkpoint at exactly
    the checkpointed step — metrics history is trimmed to the checkpoint
    so the final history is one clean pass.
    """
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.air.result import Result
    from ray_tpu_torch.exceptions import DagError, RayError
    from ray_tpu_torch.train._internal.backend_executor import BackendExecutor

    spec: TrainStepSpec = trainer.train_step_spec
    if spec.steps <= 0:
        raise ValueError("TrainStepSpec.steps must be positive")
    use_dag = bool(getattr(trainer.backend_config, "use_step_dag", False))
    max_failures = trainer.run_config.failure_config.max_failures
    ckpt: Optional[Dict[str, Any]] = None
    if trainer.resume_from_checkpoint is not None:
        ckpt = trainer.resume_from_checkpoint.to_dict()
    start0 = int(ckpt["step"]) if ckpt else 0
    completed = start0
    history: List[Dict[str, Any]] = []
    ckpt_every = int(spec.checkpoint_every)
    can_ckpt = spec.snapshot is not None
    attempt = 0
    while True:
        executor = BackendExecutor(
            trainer.backend_config, trainer.scaling_config, trainer.run_config.failure_config
        )
        driver = None
        try:
            executor.start()
            workers = executor.worker_group.workers
            if use_dag:
                driver = TrainStepDag(
                    workers, spec, checkpoint=ckpt, start_step=completed
                )
            else:
                driver = _EagerSpecDriver(workers, spec, ckpt, completed)
            while completed < spec.steps:
                chunk = spec.steps - completed
                if can_ckpt and ckpt_every > 0:
                    to_boundary = ckpt_every - (completed % ckpt_every)
                    chunk = min(chunk, to_boundary)
                history.extend(driver.run(chunk))
                completed += chunk
                if can_ckpt and (
                    completed == spec.steps
                    or (ckpt_every > 0 and completed % ckpt_every == 0)
                ):
                    ckpt = driver.snapshot()
            final = driver
            driver = None  # teardown below, outside the fault net
            final.teardown()
            return Result(
                metrics=dict(history[-1]) if history else {},
                checkpoint=Checkpoint.from_dict(ckpt) if ckpt is not None else None,
                metrics_history=history,
            )
        except (DagError, RayError, RuntimeError, ConnectionError, TimeoutError) as e:
            attempt += 1
            if attempt > max_failures:
                raise
            # resume at exactly the checkpointed step: trim optimistic
            # history back to the boundary the checkpoint captured
            completed = int(ckpt["step"]) if ckpt else start0
            del history[completed - start0 :]
            time.sleep(0.5)
        finally:
            if driver is not None:
                try:
                    driver.teardown()
                except Exception:  # noqa: BLE001 -- gang may already be dead mid-fault
                    pass
            executor.shutdown()
