"""The resident train-step DAG in the port (ray_tpu_torch/train/torch/step_dag.py).

The six cases of tests/test_train_dag.py on the port's runtime on the CPU:
the eager per-step path and the gang-armed resident DAG drive the SAME
TrainStepSpec stage functions and give bit-identical weights, Adam state
and per-step metrics (GPT-2 tiny, 2 workers, dcn all-reduce inside the
step); the unlocked feeder stage overlaps the step stage; a participant
killed mid-run surfaces as a typed DagError and a fresh gang resumes from
the checkpoint at exactly its step; RAY_TPU_TASK_EVENTS=0 keeps the
resident loop stamp-free.  The step spec's parity with the JAX package's
(`_lm_step` against `_lm_step`) is in tests/test_torch_lm_train.py, which
pays JAX's import and compile once for both of its parity checks.

One cluster serves the module; the events-off case, last, starts its own.
Every cluster call carries a timeout.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import task_events
from ray_tpu_torch.exceptions import DagError, DagExecutionError, DagInvalidatedError
from ray_tpu_torch.train._internal.worker_group import TrainWorker
from ray_tpu_torch.train.torch.step_dag import TrainStepDag, TrainStepSpec, _EagerSpecDriver

pytestmark = pytest.mark.train_dag

TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    # one intra-op thread per worker: two torch workers on a shared CPU,
    # each spinning a full thread pool while the other waits in the dcn
    # all-reduce, take ~0.3 s a step instead of ~10 ms
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


# ------------------------------------------------------------------ helpers


def _counter_spec(data_sleep=0.0, step_sleep=0.0, die_at=None, **kw):
    """Deterministic numpy spec: w accumulates the step index, so after
    steps 0..N-1 the weight IS N*(N-1)/2 — any skipped or replayed step
    shows in the value.  ``die_at``: rank-(world-1) calls os._exit at that
    global step index on a FRESH build only (a restore marks the state
    resumed), which is the deterministic mid-run participant kill."""

    def build(config, rank, world):
        return {"w": np.zeros(2), "rank": rank, "world": world, "resumed": False}

    def data(state, idx):
        if data_sleep:
            time.sleep(data_sleep)
        return idx

    def step(state, batch):
        if (
            die_at is not None
            and batch == die_at
            and state["rank"] == state["world"] - 1
            and not state["resumed"]
        ):
            import os

            os._exit(1)
        if step_sleep:
            time.sleep(step_sleep)
        state["w"] = state["w"] + batch
        return {"sum": float(state["w"][0])}

    def snapshot(state):
        return {"w": np.array(state["w"])}

    def restore(state, snap):
        state["w"] = np.array(snap["w"])
        state["resumed"] = True

    kw.setdefault("steps", 1 << 30)
    return TrainStepSpec(
        build=build,
        data=data,
        step=step,
        snapshot=snapshot,
        restore=restore,
        block_metrics=False,
        **kw,
    )


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_tree_equal(a, b, what="trees"):
    fa, fb = _flatten(a), _flatten(b)
    assert list(fa) == list(fb), f"{what}: structure differs"
    for key in fa:
        x, y = fa[key], fb[key]
        assert x.dtype == y.dtype and np.array_equal(x, y), (
            f"{what}: leaf {key} differs (max abs diff "
            f"{np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)))})"
        )


def _lm_fit(use_dag: bool, steps: int = 12, workers: int = 2, **run_kw):
    from ray_tpu_torch.models.lm_train import make_lm_step_spec
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch.config import TorchConfig

    spec = make_lm_step_spec(
        "tiny", batch=2, steps=steps, checkpoint_every=0, name="t_train_dag", device="cpu"
    )
    trainer = TorchTrainer(
        train_step_spec=spec,
        backend_config=TorchConfig(use_step_dag=use_dag),
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=False),
        **run_kw,
    )
    return trainer.fit()


# ==================================================== eager/dag equivalence


def test_eager_vs_dag_bit_identical_weights_and_metrics(cluster):
    """The acceptance invariant: the SAME tiny-LM spec driven 12 steps
    through the eager per-step path and the gang-armed resident DAG
    (2-worker gang, dcn grad allreduce inside the step stage) produces
    bit-identical trained weights, Adam state, and per-step metrics.  The
    eager run's checkpoint is read again after the DAG run: its numpy
    leaves are zero-copy views of store blocks that the owner freed while
    the DAG run put new objects (the deferred delete keeps them intact)."""
    eager = _lm_fit(use_dag=False, steps=12)
    ce = eager.checkpoint.to_dict()
    count_before = int(ce["spec_state"]["opt_state"]["count"])
    dag = _lm_fit(use_dag=True, steps=12)
    assert len(eager.metrics_history) == len(dag.metrics_history) == 12
    for i, (em, dm) in enumerate(zip(eager.metrics_history, dag.metrics_history)):
        assert em == dm, f"step {i} metrics diverge: {em} vs {dm}"
    cd = dag.checkpoint.to_dict()
    assert ce["step"] == cd["step"] == 12
    assert count_before == int(ce["spec_state"]["opt_state"]["count"]) == 12
    _assert_tree_equal(ce["spec_state"], cd["spec_state"], "trained weights")


def test_trainer_rejects_ambiguous_loop_spec():
    from ray_tpu_torch.train import TorchTrainer

    with pytest.raises(ValueError, match="exactly one"):
        TorchTrainer()  # neither loop nor spec
    with pytest.raises(ValueError, match="exactly one"):
        TorchTrainer(lambda cfg: None, train_step_spec=_counter_spec(steps=1))


# ========================================================== double buffering


def test_double_buffer_overlap_engages(cluster):
    """The feeder stage (lock=False) must prepare batch N+1 while the
    locked step stage computes batch N.  Asserted from the retained phase
    stamps — stamped across the stage threads of ONE process, so the
    comparison is clock-skew-free — and cross-checked against the eager
    path, where the same stamps can never overlap."""
    spec = _counter_spec(data_sleep=0.03, step_sleep=0.03)
    steps = 10

    w = rt.remote(TrainWorker).remote(0, 1)
    dag = TrainStepDag([w], spec)
    t0 = time.perf_counter()
    dag.run(steps)
    dag_dt = time.perf_counter() - t0
    recs = rt.get(w.dag_train_records.remote(), timeout=TIMEOUT)
    dag.teardown()
    assert len(recs) == steps
    overlaps = sum(
        1
        for prev, nxt in zip(recs, recs[1:])
        if nxt["train_data_wait_start"] < prev["train_compute_end"]
    )
    assert overlaps > 0, (
        f"double buffer never engaged: no batch N+1 data_wait started "
        f"before batch N compute ended across {steps} steps"
    )

    # eager reference: one actor call per step — data_wait N+1 strictly
    # after compute N, and the serialized wall clock pays data + compute
    w2 = rt.remote(TrainWorker).remote(0, 1)
    eager = _EagerSpecDriver([w2], spec, None, 0)
    t0 = time.perf_counter()
    eager.run(steps)
    eager_dt = time.perf_counter() - t0
    recs2 = rt.get(w2.dag_train_records.remote(), timeout=TIMEOUT)
    eager.finish()
    assert all(
        nxt["train_data_wait_start"] >= prev["train_compute_end"]
        for prev, nxt in zip(recs2, recs2[1:])
    ), "eager path cannot overlap phases"
    assert dag_dt < eager_dt, (
        f"pipelined loop ({dag_dt:.2f}s) not faster than serialized "
        f"eager feed ({eager_dt:.2f}s) with equal-cost phases"
    )


# ============================================================ failure contract


def test_participant_kill_typed_invalidation_then_checkpoint_resume(cluster):
    """Kill one gang participant mid-run: the in-flight step surfaces a
    typed DagError (never a hang), later executes raise DagInvalidatedError,
    and a FRESH gang restored from the last checkpoint resumes at exactly
    the checkpointed step — the resumed run's final weights equal an
    uninterrupted run's bit for bit."""
    spec = _counter_spec()

    gang = [rt.remote(TrainWorker).remote(i, 2) for i in range(2)]
    dag = TrainStepDag(gang, spec)
    dag.run(4)
    snap = dag.snapshot()
    assert snap["step"] == 4
    rt.kill(gang[1])
    with pytest.raises((DagExecutionError, DagInvalidatedError)):
        # generous pipeline so the write lands before the loss is seen;
        # the broken transport must wake the read, not time it out
        dag.run(2)
    assert dag.invalidated is not None
    with pytest.raises(DagInvalidatedError):
        dag.run(1)
    try:
        dag.teardown()
    except DagError:
        pass  # best-effort on a half-dead gang

    # fresh gang, restored from the checkpoint: next step index is exactly
    # the checkpointed boundary
    gang2 = [rt.remote(TrainWorker).remote(i, 2) for i in range(2)]
    dag2 = TrainStepDag(gang2, spec, checkpoint=snap)
    assert dag2.step_index == 4
    dag2.run(6)
    final = dag2.snapshot()
    dag2.teardown()
    assert final["step"] == 10

    # uninterrupted reference on one more fresh worker pair
    gang3 = [rt.remote(TrainWorker).remote(i, 2) for i in range(2)]
    dag3 = TrainStepDag(gang3, spec)
    dag3.run(10)
    ref = dag3.snapshot()
    dag3.teardown()
    _assert_tree_equal(final["spec_state"], ref["spec_state"], "resumed weights")


def test_fit_spec_respawns_gang_at_exact_step(cluster):
    """End-to-end through TorchTrainer: a participant os._exits mid-chunk
    (after the step-4 checkpoint), fit_spec rebuilds the worker gang and
    resumes from the checkpoint.  w accumulates the step index, so the
    final value and every per-step metric pin the resume to EXACTLY step 4
    — a replayed or skipped step changes the arithmetic."""
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch.config import TorchConfig

    steps = 12
    spec = _counter_spec(die_at=6, steps=steps, checkpoint_every=4)
    trainer = TorchTrainer(
        train_step_spec=spec,
        backend_config=TorchConfig(use_step_dag=True),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)),
    )
    result = trainer.fit()
    assert len(result.metrics_history) == steps
    for i, m in enumerate(result.metrics_history):
        assert m["sum"] == i * (i + 1) / 2, f"step {i} metric wrong: {m}"
    ck = result.checkpoint.to_dict()
    assert ck["step"] == steps
    assert float(ck["spec_state"]["w"][0]) == steps * (steps - 1) / 2


# ========================================================== events contract


@pytest.fixture
def events_off_cluster(monkeypatch):
    rt.shutdown()  # the module's cluster: workers must start with events off
    monkeypatch.setenv("RAY_TPU_TASK_EVENTS", "0")
    task_events.set_enabled(False)
    try:
        rt.init(num_cpus=4, num_gpus=0)
        yield
    finally:
        rt.shutdown()
        task_events.set_enabled(True)


def test_events_off_keeps_resident_loop_stamp_free(events_off_cluster):
    """RAY_TPU_TASK_EVENTS=0 contract extended to the resident train loop:
    the stage functions take the no-stamp branch (no retained records, no
    probe records), and the head joins zero train records."""
    spec = _counter_spec()
    w = rt.remote(TrainWorker).remote(0, 1)
    dag = TrainStepDag([w], spec)
    hist = dag.run(6)
    assert [m["sum"] for m in hist] == [i * (i + 1) / 2 for i in range(6)]
    recs = rt.get(w.dag_train_records.remote(), timeout=TIMEOUT)
    dag.teardown()
    assert recs == [], "resident loop stamped phase records with events off"
    from ray_tpu_torch.experimental.state import summarize_workloads

    time.sleep(1.0)
    assert summarize_workloads("train")["total_records"] == 0
