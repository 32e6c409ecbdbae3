"""Compiled actor DAGs in the port (ray_tpu_torch/dag/): the cases of
tests/test_dag.py, on the port's runtime on the CPU.

Covers the declaration API (bind / InputNode / MultiOutputNode), the
execute hot path (shm rings co-located, carrier-conn inline otherwise),
the error contract (application exception → DagExecutionError + valid
graph; transport fault → DagInvalidatedError), and the teardown / re-entry
contract (eager service restored, no leaked channels or executor
threads, two sequential compiles over overlapping actors).

One cluster serves the module and every case builds its own actors; the
flight-recorder cases name their own actor classes, since the head keeps
the records of the module's earlier graphs, and the last case shuts the
cluster down itself.  Every `get` and `execute` carries
a timeout.  A torch.Tensor crosses the channels through the tensor reducer.
"""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import task_events
from ray_tpu_torch._private.protocol import MsgType
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.exceptions import DagExecutionError, DagInvalidatedError

pytestmark = pytest.mark.dag


@pytest.fixture(scope="module")
def ray_start_regular():
    rt.init(num_cpus=4, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


class _Stage:
    def __init__(self, add=0):
        self.add = add
        self.calls = 0

    def step(self, x):
        self.calls += 1
        if isinstance(x, str) and x == "boom":
            raise ValueError("kaboom")
        return x + self.add

    def combine(self, a, b):
        self.calls += 1
        return a + b

    def calls_seen(self):
        return self.calls

    def dag_threads(self):
        import threading

        return [
            t.name for t in threading.enumerate() if t.name.startswith("dag-exec")
        ]

    def slow_step(self, x):
        import time as _t

        _t.sleep(float(x))
        return x


@rt.remote
class Stage(_Stage):
    pass


@rt.remote
class Recorded(_Stage):
    """Names the flight-recorder case's records apart from the module's
    other graphs."""


@rt.remote
class Quiet(_Stage):
    """Names the events-off case's graph."""


def _cw():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker.core_worker


# ================================================================ execution


def test_linear_chain_and_repeat_steps(ray_start_regular):
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.compile()
    try:
        for i in range(20):
            assert compiled.execute(i, timeout=60) == i + 111
        assert compiled.invalidated is None
    finally:
        compiled.teardown()


def test_constants_fanout_and_multi_output(ray_start_regular):
    a, b, c = Stage.remote(), Stage.remote(5), Stage.remote()
    with InputNode() as inp:
        left = b.step.bind(inp)  # x + 5
        # constant args ship once at compile, never per step; the input
        # fans out to several consumers; one node feeds two sinks
        dag = MultiOutputNode([c.combine.bind(left, 1000), a.combine.bind(left, inp)])
    compiled = dag.compile()
    try:
        assert compiled.execute(3, timeout=60) == [1008, 11]
        assert compiled.execute(7, timeout=60) == [1012, 19]
    finally:
        compiled.teardown()


def test_declaration_validation(ray_start_regular):
    a = Stage.remote()
    with pytest.raises(ValueError, match="InputNode"):
        a.step.bind(41).compile()  # no InputNode: nothing could trigger it
    with pytest.raises(ValueError):
        MultiOutputNode([])
    with pytest.raises(TypeError):
        MultiOutputNode([InputNode()])


def test_big_payloads_roundtrip_shm_ring(ray_start_regular):
    import numpy as np

    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.compile()
    try:
        # first step sizes the ring small, later 3MB payloads overflow the
        # slot and take the inline carrier path — both must stay seq-aligned
        assert compiled.execute(1, timeout=60) == 1
        big = np.ones(400_000, dtype=np.float64)
        for _ in range(3):
            out = compiled.execute(big, timeout=60)
            assert out.shape == big.shape
    finally:
        compiled.teardown()


def test_tensor_payloads_roundtrip_ring_and_inline(ray_start_regular):
    """A torch.Tensor crosses every channel through the tensor reducer:
    in the ring's slot while it fits, inline on the carrier conn once it
    overflows the slot, bit for bit and in its dtype."""
    import torch  # here, not at module level: the actors' workers import this module

    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.compile()
    try:
        gen = torch.Generator().manual_seed(0)
        for n in (16, 16, 800_000, 16):
            x = torch.randn(n, generator=gen).to(torch.bfloat16)
            out = compiled.execute(x, timeout=60)
            assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
            assert torch.equal(out, x)
        assert compiled.invalidated is None
    finally:
        compiled.teardown()


# ============================================================ error contract


def test_node_exception_poisons_downstream_graph_survives(ray_start_regular):
    a, b = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.compile()
    try:
        assert compiled.execute(0, timeout=60) == 11
        with pytest.raises(DagExecutionError) as err:
            compiled.execute("boom", timeout=60)
        assert "kaboom" in str(err.value.__cause__)
        # poison kept every channel step-aligned: the graph stays valid
        assert compiled.invalidated is None
        assert compiled.execute(5, timeout=60) == 16
        # b never executed the poisoned step (it forwarded the error)
        assert rt.get(b.calls_seen.remote(), timeout=60) == 2
    finally:
        compiled.teardown()


def test_execute_timeout_invalidates(ray_start_regular):
    a = Stage.remote()
    with InputNode() as inp:
        dag = a.step.bind(inp)
    compiled = dag.compile()
    try:
        with pytest.raises(DagExecutionError):
            compiled.execute(1, timeout=0.0)  # deadline expires before the reply
        # an unread output would desync later steps: timed-out graphs are
        # invalid by contract, not silently resumable
        with pytest.raises(DagInvalidatedError):
            compiled.execute(1, timeout=60)
    finally:
        compiled.teardown()


# ======================================================= teardown / re-entry


def test_eager_service_after_teardown_no_leaked_executors(ray_start_regular):
    a, b = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.compile()
    assert compiled.execute(0, timeout=60) == 3
    assert rt.get(a.dag_threads.remote(), timeout=60)  # executors resident
    compiled.teardown()
    # eager calls served again, and the resident executor threads are gone
    assert rt.get(a.step.remote(10), timeout=60) == 11
    deadline = time.monotonic() + 30
    while rt.get(a.dag_threads.remote(), timeout=60):
        assert time.monotonic() < deadline, "executor threads leaked"
        time.sleep(0.2)
    assert rt.get(b.dag_threads.remote(), timeout=60) == []
    # a torn-down graph refuses to execute
    with pytest.raises(DagInvalidatedError):
        compiled.execute(1, timeout=60)
    # teardown is idempotent
    compiled.teardown()


def test_sequential_compiles_on_overlapping_actors(ray_start_regular):
    a, b = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        first = b.step.bind(a.step.bind(inp))
    c1 = first.compile()
    assert c1.execute(0, timeout=60) == 11
    c1.teardown()
    # same actors, different topology: must not collide with stale
    # channels, rings, or executor threads from the first graph
    with InputNode() as inp:
        second = a.step.bind(b.step.bind(inp))
    c2 = second.compile()
    try:
        assert c2.execute(0, timeout=60) == 11
        assert c2.execute(100, timeout=60) == 111
    finally:
        c2.teardown()
    deadline = time.monotonic() + 30
    while rt.get(a.dag_threads.remote(), timeout=60):
        assert time.monotonic() < deadline, "executor threads leaked"
        time.sleep(0.2)


def test_eager_and_compiled_calls_interleave(ray_start_regular):
    """The sequential-actor contract holds across modes: eager calls and
    compiled steps on the same actor are mutually excluded, so every
    increment lands."""
    a = Stage.remote(1)
    with InputNode() as inp:
        dag = a.step.bind(inp)
    compiled = dag.compile()
    try:
        for i in range(10):
            assert compiled.execute(i, timeout=60) == i + 1
            assert rt.get(a.step.remote(i), timeout=60) == i + 1
        assert rt.get(a.calls_seen.remote(), timeout=60) == 20
    finally:
        compiled.teardown()


def test_teardown_unblocks_concurrent_execute(ray_start_regular):
    """teardown() racing an execute() that is parked on its output read:
    the blocked thread must wake (DagExecutionError — or its result, if it
    won the race), never hang on a queue nothing will ever fill again."""
    import threading

    a = Stage.remote(1)
    with InputNode() as inp:
        dag = a.slow_step.bind(inp)
    compiled = dag.compile()
    res = {}

    def run():
        try:
            res["out"] = compiled.execute(0.8, timeout=60)
        except (DagExecutionError, DagInvalidatedError) as e:
            res["err"] = e

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.25)  # let execute park on the output channel
    compiled.teardown()
    t.join(timeout=30)
    assert not t.is_alive(), "execute hung past teardown"
    assert res, "execute neither returned nor raised"
    with pytest.raises(DagInvalidatedError):
        compiled.execute(1, timeout=5)
    # participants are back on normal eager service
    assert rt.get(a.step.remote(10), timeout=60) == 11


def test_abandoned_graph_reclaimed_without_teardown(ray_start_regular):
    """Dropping the last reference without teardown() must not leak the
    graph: the io loop's conn callbacks hold only weakrefs, so __del__
    fires, the executors stop, and the rings/channels are released."""
    import gc

    a = Stage.remote(1)
    with InputNode() as inp:
        compiled = a.step.bind(inp).compile()
    assert compiled.execute(1, timeout=60) == 2
    assert rt.get(a.dag_threads.remote(), timeout=60)
    del compiled
    gc.collect()
    deadline = time.monotonic() + 30
    while rt.get(a.dag_threads.remote(), timeout=60):
        assert time.monotonic() < deadline, "abandoned graph leaked executors"
        time.sleep(0.2)
    assert rt.get(a.step.remote(10), timeout=60) == 11


# ========================================================== flight recorder


def _dag_summary_names():
    summ = _cw().request(MsgType.TASK_SUMMARY, {})
    return {row["name"] for row in summ["summary"] if row["name"].startswith("dag:")}


def test_events_on_records_dag_phases_and_timeline(ray_start_regular):
    a = Recorded.remote(1)
    with InputNode() as inp:
        dag = a.step.bind(inp)
    compiled = dag.compile()
    for i in range(3):
        compiled.execute(i, timeout=60)
    compiled.teardown()  # flushes the executor's buffered step records
    deadline = time.monotonic() + 30
    while "dag:Recorded.step" not in _dag_summary_names():
        assert time.monotonic() < deadline, "no dag step records reached the head"
        time.sleep(0.2)
    spans = [
        e
        for e in rt.timeline()
        if e.get("cat") == "task_phase"
        and e.get("args", {}).get("phase") == "dag_exec"
    ]
    assert spans, "timeline missing per-node dag_exec sub-spans"
    waits = [
        e
        for e in rt.timeline()
        if e.get("args", {}).get("phase") == "dag_channel_wait"
    ]
    assert waits, "timeline missing dag_channel_wait sub-spans"


def test_events_off_keeps_hot_loop_stamp_free(ray_start_regular):
    """RAY_TPU_TASK_EVENTS=0 contract: a compiled step emits no flight
    records at all — the driver's disabled flag rides DAG_SETUP, the
    executor's loop takes the no-stamp branch, and the head never sees a
    DAG_STEP frame."""
    task_events.set_enabled(False)
    try:
        a = Quiet.remote(1)
        with InputNode() as inp:
            dag = a.step.bind(inp)
        compiled = dag.compile()
        for i in range(5):
            assert compiled.execute(i, timeout=60) == i + 1
        compiled.teardown()
        time.sleep(1.0)  # would-be flush window
        assert "dag:Quiet.step" not in _dag_summary_names()
    finally:
        task_events.set_enabled(True)


# ============================================================ last: shutdown


def test_teardown_after_driver_shutdown_is_quiet(ray_start_regular):
    """teardown() is best-effort by contract even once the driver's io
    loop is gone (the common __del__-after-shutdown ordering): it must
    release local state without raising.  Last in the module: it shuts the
    module's cluster down."""
    a = Stage.remote(1)
    with InputNode() as inp:
        compiled = a.step.bind(inp).compile()
    assert compiled.execute(1, timeout=60) == 2
    rt.shutdown()
    compiled.teardown()  # must not raise on the closed loop
    with pytest.raises(DagInvalidatedError):
        compiled.execute(1, timeout=5)
