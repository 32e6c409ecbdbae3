"""Driver-side compiled graph: topology resolution, channel wiring,
execute, and the invalidation / teardown contract.

``compile()`` happens ONCE: resolve the dataflow topology, dial one
carrier conn per participant actor, and install the resident executors
(reverse-topological order, so every consumer's channel registry exists
before its producer is wired).  After that, ``execute(x)`` is one channel
write plus one channel read at the driver — the head scheduler, TaskSpec
construction, and per-call graph serialization are all off the hot loop
(Pathways' scarce-resource argument, PAPERS.md §2).

Failure contract (the JAX package's dag/DESIGN.md):

- application exception in a node → poison flows downstream, ``execute``
  raises :class:`DagExecutionError` with the remote error as cause; the
  graph STAYS VALID (channels stay step-aligned) and the next ``execute``
  works.
- transport fault (severed channel, participant death, sequence gap) →
  the graph is INVALIDATED: the failing ``execute`` raises
  ``DagExecutionError``, every later one raises ``DagInvalidatedError``
  immediately.  Re-compile on the surviving actors or fail.
- ``teardown()`` releases channels and executors everywhere and restores
  the actors to normal eager service; a torn-down graph cannot execute.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import task_events
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.protocol import MsgType
from ray_tpu_torch.dag.channel import (
    ChannelBrokenError,
    ChannelReader,
    ChannelWriter,
    encode_value,
)
from ray_tpu_torch.dag.executor import CTL_PREFIX
from ray_tpu_torch.dag.node import ClassMethodNode, DAGNode, resolve_topology
from ray_tpu_torch.exceptions import (
    DagExecutionError,
    DagInvalidatedError,
    RayActorError,
)
from ray_tpu_torch.util.lockwitness import named_lock


class _Participant:
    """One actor in the graph: its carrier conn and its setup payload."""

    def __init__(self, actor_id: bytes, handle):
        self.actor_id = actor_id
        self.handle = handle
        self.node_id: bytes = b""
        self.direct_addr: str = ""
        self.conn = None
        self.nodes: List[dict] = []  # setup payloads, topo order
        self.min_topo = 1 << 30


class DagStepFuture:
    """One in-flight compiled step, created by ``execute_async``.

    Channels are FIFO, so results resolve strictly in submission order:
    ``result()`` drains any earlier pending steps first, storing their
    outcomes into their own futures — out-of-order ``result`` calls are
    safe, they just do a predecessor's read on its behalf."""

    __slots__ = ("_dag", "seq", "_done", "_exc", "_value")

    def __init__(self, dag: "CompiledDag", seq: int):
        self._dag = dag
        self.seq = seq
        self._done = False
        self._exc: Optional[BaseException] = None
        self._value: Any = None

    @property
    def done(self) -> bool:
        return self._done

    def _set_value(self, value: Any) -> None:
        self._value = value
        self._done = True

    def _set_exc(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for this step's sink output(s); raises exactly what a
        synchronous ``execute`` of this step would have raised."""
        if not self._done:
            self._dag._collect(self, timeout)
        if self._exc is not None:
            raise self._exc
        return self._value


class CompiledDag:
    """A compiled static-dataflow graph over existing actors.  Build with
    ``dag.compile()``; drive with ``execute`` (or pipeline steps with
    ``execute_async``); release with ``teardown``."""

    def __init__(self, output: DAGNode, gang: bool = False):
        from ray_tpu_torch._private import worker as worker_mod

        self._cw = worker_mod._require_connected()
        # _step_lock serializes step submission (seq assignment + input
        # writes); _read_lock serializes output collection; _state_lock
        # guards the small broken/torn-down flags and is NEVER held across
        # blocking channel IO — the io thread's _mark_broken must always
        # get through to wake a reader a collect thread is blocked on
        self._step_lock = named_lock("CompiledDag._step_lock")
        self._read_lock = named_lock("CompiledDag._read_lock")
        self._state_lock = named_lock("CompiledDag._state_lock")
        self._broken: Optional[str] = None
        self._torn_down = False
        self._seq = 0
        self._pending: "collections.deque[DagStepFuture]" = collections.deque()
        self._gang = bool(gang)
        self._dag_id = os.urandom(8).hex()
        self._readers: Dict[str, ChannelReader] = {}
        self._input_writers: List[ChannelWriter] = []
        self._output_keys: List[str] = []
        self._participants: List[_Participant] = []
        self._ctl_key = CTL_PREFIX + self._dag_id
        self._compile(output)

    @property
    def dag_id(self) -> str:
        return self._dag_id

    @property
    def invalidated(self) -> Optional[str]:
        """The invalidation reason, or None while the graph is executable."""
        return self._broken

    # ------------------------------------------------------------- compile

    def _compile(self, output: DAGNode) -> None:
        order, input_node, sinks = resolve_topology(output)
        if not order:
            raise ValueError("compile() needs at least one bound actor-method node")
        if input_node is None:
            raise ValueError(
                "a compiled DAG needs an InputNode: without one no step "
                "could ever trigger the source executors"
            )
        self._multi = len(sinks) > 1
        topo_index = {id(n): i for i, n in enumerate(order)}

        # -- participants: one carrier conn per distinct actor
        by_actor: Dict[bytes, _Participant] = {}
        for n in order:
            aid = n.handle._actor_id
            if aid not in by_actor:
                by_actor[aid] = _Participant(aid, n.handle)
        self._resolve_actors(by_actor)

        # -- channels: one per dataflow edge, keys assigned once
        chan_seq = [0]

        def new_chan() -> str:
            chan_seq[0] += 1
            return f"{self._dag_id}:{chan_seq[0]}"

        driver_node_id = b"" if self._cw.is_client else (self._cw.node_id or b"")

        def co_located(a: bytes, b: bytes) -> bool:
            return bool(a) and a == b

        # per-node bookkeeping built in topo order
        out_edges: Dict[int, List[dict]] = {id(n): [] for n in order}
        setups: Dict[int, dict] = {}
        input_fanout: List[Tuple[str, _Participant, bool]] = []

        for n in order:
            part = by_actor[n.handle._actor_id]
            part.min_topo = min(part.min_topo, topo_index[id(n)])
            args, kwargs = n.bind_info()
            arg_specs: List[dict] = []
            ins: List[dict] = []
            seen_dep: Dict[int, str] = {}
            for key, value in [(None, a) for a in args] + list(kwargs.items()):
                if isinstance(value, ClassMethodNode):
                    chan = seen_dep.get(id(value))
                    if chan is None:
                        chan = new_chan()
                        seen_dep[id(value)] = chan
                        producer = by_actor[value.handle._actor_id]
                        co = co_located(producer.node_id, part.node_id)
                        out_edges[id(value)].append(
                            {"c": chan, "kind": "dial", "addr": part.direct_addr, "co": co}
                        )
                        ins.append({"c": chan, "co": co})
                    arg_specs.append({"k": key, "t": "chan", "c": chan})
                elif isinstance(value, DAGNode):  # the InputNode
                    chan = seen_dep.get(id(value))
                    if chan is None:
                        chan = new_chan()
                        seen_dep[id(value)] = chan
                        co = co_located(driver_node_id, part.node_id)
                        input_fanout.append((chan, part, co))
                        ins.append({"c": chan, "co": co})
                    arg_specs.append({"k": key, "t": "chan", "c": chan})
                else:
                    wire, _ = encode_value(value)
                    arg_specs.append({"k": key, "t": "const", "w": wire})
            if not ins:
                raise ValueError(
                    f"node {n!r} consumes neither the InputNode nor another "
                    "node: it could never be triggered by execute()"
                )
            setups[id(n)] = {
                "label": f"{n.handle._class_name}.{n.method_name}",
                "method": n.method_name,
                "args": arg_specs,
                "ins": ins,
                "outs": [],  # filled below once all consumers are known
                "lock": bool(n.dag_options.get("lock", True)),
            }

        # -- output edges back to the driver
        for sink in sinks:
            part = by_actor[sink.handle._actor_id]
            chan = new_chan()
            co = co_located(part.node_id, driver_node_id)
            out_edges[id(sink)].append({"c": chan, "kind": "back", "co": co})
            self._output_keys.append(chan)
            self._readers[chan] = ChannelReader(
                chan, store=self._cw.store, co_located=co
            )

        for n in order:
            setups[id(n)]["outs"] = out_edges[id(n)]
            by_actor[n.handle._actor_id].nodes.append(setups[id(n)])

        self._participants = list(by_actor.values())

        # -- pre-wire: dial carriers, install executors consumers-first so
        # every producer's dial lands on a registered consumer registry
        events = task_events.enabled
        # the io loop's _dag_read_loop tasks hold these callbacks for each
        # carrier conn's lifetime; strong refs would pin an abandoned
        # CompiledDag forever and the __del__ teardown net could never fire
        wself = weakref.ref(self)

        def _push(payload):
            dag = wself()
            if dag is not None:
                dag._on_push(payload)

        try:
            for part in self._participants:
                label = f"actor {part.actor_id.hex()[:8]}"

                def _lost(lbl=label):
                    dag = wself()
                    if dag is not None:
                        dag._mark_broken(f"lost connection to {lbl}")

                part.conn = self._cw.open_dag_conn(
                    part.direct_addr, on_push=_push, on_close=_lost
                )
            if self._gang:
                # two-phase gang setup: every participant installs its
                # channels/executors WITHOUT starting a loop (concurrent
                # DAG_SETUP round, arm=False), then one concurrent DAG_ARM
                # round starts all resident loops — a multi-host mesh arms
                # atomically, and any failure unwinds every participant
                # through the exception path below before a single loop
                # has run
                self._gang_round(
                    MsgType.DAG_SETUP,
                    lambda part: {
                        "dag_id": self._dag_id,
                        "events": events,
                        "arm": False,
                        "nodes": part.nodes,
                    },
                    "DAG_SETUP",
                )
                self._gang_round(
                    MsgType.DAG_ARM,
                    lambda part: {"dag_id": self._dag_id},
                    "DAG_ARM",
                )
            else:
                for part in sorted(self._participants, key=lambda p: -p.min_topo):
                    reply = self._cw.dag_rpc(
                        part.conn,
                        MsgType.DAG_SETUP,
                        {"dag_id": self._dag_id, "events": events, "nodes": part.nodes},
                        RayConfig.dag_setup_timeout_s,
                    )
                    if not reply.get("ok"):
                        raise RuntimeError(
                            f"DAG_SETUP rejected by {part.actor_id.hex()[:8]}: "
                            f"{reply.get('error', 'unknown error')}"
                        )
            for chan, part, co in input_fanout:
                self._input_writers.append(
                    ChannelWriter(
                        chan,
                        self._cw.io,
                        part.conn,
                        store=self._cw.store,
                        co_located=co,
                    )
                )
        except BaseException:
            with self._state_lock:
                self._torn_down = True  # partial wiring: unwind before raising
            self._release(best_effort_remote=True)
            raise

    def _gang_round(
        self, msg_type, payload_fn: Callable[[_Participant], dict], label: str
    ) -> None:
        """One concurrent negotiation round over every participant: all
        requests in flight at once (gang setup latency is one RTT + the
        slowest participant, not a sum), all replies collected, any
        failure aggregated into one error that names the culprits."""
        timeout = RayConfig.dag_setup_timeout_s
        futs = []
        for part in self._participants:
            futs.append(
                (
                    part,
                    self._cw.io.spawn(
                        part.conn.request(msg_type, payload_fn(part), timeout)
                    ),
                )
            )
        errors = []
        for part, fut in futs:
            try:
                reply = fut.result(timeout + 5)
            except (
                ConnectionError,
                OSError,
                TimeoutError,
                # distinct from builtin TimeoutError until 3.11
                concurrent.futures.TimeoutError,
                asyncio.TimeoutError,
            ) as e:
                errors.append(
                    f"{part.actor_id.hex()[:8]}: {type(e).__name__}: {e}"
                )
                continue
            if not reply.get("ok"):
                errors.append(
                    f"{part.actor_id.hex()[:8]}: {reply.get('error', 'rejected')}"
                )
        if errors:
            raise RuntimeError(
                f"gang {label} failed on {len(errors)} participant(s): "
                + "; ".join(errors)
            )

    def _resolve_actors(self, by_actor: Dict[bytes, _Participant]) -> None:
        """Wait out actor creation and capture each participant's direct
        address + node (for co-location) — compile blocks here so execute
        never races an actor that is still starting."""
        for part in by_actor.values():
            # per-participant deadline (config.py: dag_setup_timeout_s) —
            # a graph over N slow-starting actors must not charge actor
            # N's wait against the ones before it
            deadline = time.monotonic() + RayConfig.dag_setup_timeout_s
            while True:
                reply = self._cw.request(
                    MsgType.ACTOR_STATE, {"actor_id": part.actor_id}
                )
                state = reply.get("state")
                if state == "ALIVE" and reply.get("direct_addr"):
                    part.direct_addr = reply["direct_addr"]
                    break
                if state in ("DEAD", "UNKNOWN"):
                    raise RayActorError(
                        part.actor_id,
                        f"cannot compile a DAG over a {state} actor "
                        f"({reply.get('death_cause') or 'no direct-call server'})",
                    )
                if time.monotonic() >= deadline:
                    raise RayActorError(
                        part.actor_id,
                        f"actor not ALIVE within the {RayConfig.dag_setup_timeout_s:.0f}s "
                        "compile window",
                    )
                time.sleep(0.02)
        for a in self._cw.request(MsgType.LIST_ACTORS, {}).get("actors", []):
            part = by_actor.get(bytes(a["actor_id"]))
            if part is not None:
                part.node_id = bytes(a.get("node_id") or b"")

    # ------------------------------------------------------------- execute

    def execute(self, value: Any = None, timeout: Optional[float] = None) -> Any:
        """Run one step: feed ``value`` to the InputNode's consumers, block
        for the sink outputs.  Returns the single sink's value, or a list
        in declaration order for MultiOutputNode graphs."""
        return self.execute_async(value).result(timeout)

    def execute_async(self, value: Any = None) -> DagStepFuture:
        """Feed one step's input WITHOUT waiting for its outputs: returns a
        :class:`DagStepFuture` whose ``result()`` blocks for them.

        This is the pipelining primitive the resident train loop rides
        (train/torch/step_dag.py): the driver writes step *N+1* into the
        input channel ring while the executors still run step *N*, so the
        per-step driver cost really is one channel write.  In-flight depth
        is naturally bounded by the ring (a full ring back-pressures the
        writer); results resolve in submission order.  Submission raises
        ``DagInvalidatedError`` on a broken/torn-down graph exactly like
        ``execute``."""
        with self._step_lock:
            with self._state_lock:
                if self._torn_down:
                    raise DagInvalidatedError("this compiled DAG was torn down")
                if self._broken is not None:
                    raise DagInvalidatedError(
                        f"compiled DAG invalidated ({self._broken}); re-compile "
                        "on the surviving actors or fail"
                    )
                seq = self._seq
                self._seq += 1
                fut = DagStepFuture(self, seq)
                self._pending.append(fut)
            wire, nbytes = encode_value(value)
            try:
                for writer in self._input_writers:
                    writer.write(seq, wire, nbytes)
            except ChannelBrokenError as e:
                self._mark_broken(str(e))
                err = DagExecutionError(f"input channel failed: {e}")
                err.__cause__ = e
                fut._set_exc(err)
                raise err
        return fut

    def _collect(self, fut: DagStepFuture, timeout: Optional[float]) -> None:
        """Drain pending steps head-first until ``fut`` resolves.  Holds
        ``_read_lock`` (collection order IS channel order); every outcome
        lands in its own future, so concurrent ``result()`` callers each
        get their step's value/error."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._read_lock:
            while not fut._done:
                # snapshot: a concurrent teardown swaps self._readers for {}
                # after posting broken-wakes; the stale readers still deliver
                # those sentinels, a dict lookup would KeyError instead
                readers = self._readers
                with self._state_lock:
                    if fut._done:
                        break
                    if self._torn_down or self._broken is not None:
                        reason = self._broken or "compiled DAG torn down"
                        # the step that CAUSED the fault already holds its
                        # DagExecutionError; every step still in flight
                        # behind it can only ever be invalid
                        while self._pending:
                            head = self._pending.popleft()
                            if not head._done:
                                head._set_exc(
                                    DagInvalidatedError(
                                        f"compiled DAG invalidated ({reason}); "
                                        "re-compile on the surviving actors or fail"
                                    )
                                )
                        break
                    head = self._pending[0] if self._pending else None
                if head is None:
                    raise DagInvalidatedError(
                        "step future does not belong to an in-flight step"
                    )
                if head._done:
                    with self._state_lock:
                        if self._pending and self._pending[0] is head:
                            self._pending.popleft()
                    continue
                outs: List[Any] = []
                first_err: Optional[BaseException] = None
                failure: Optional[DagExecutionError] = None
                for key in self._output_keys:
                    rem = None if deadline is None else max(0.0, deadline - time.monotonic())
                    try:
                        is_err, out = readers[key].get(timeout=rem)
                    except ChannelBrokenError as e:
                        self._mark_broken(str(e))
                        failure = DagExecutionError(f"output channel failed: {e}")
                        failure.__cause__ = e
                        break
                    except TimeoutError as e:
                        # an unread output would desync every later step: a
                        # timed-out graph is not safely resumable
                        self._mark_broken(f"execute timed out after {timeout}s")
                        failure = DagExecutionError(str(e))
                        failure.__cause__ = e
                        break
                    if is_err and first_err is None:
                        first_err = out
                    outs.append(out)
                with self._state_lock:
                    if self._pending and self._pending[0] is head:
                        self._pending.popleft()
                if failure is not None:
                    head._set_exc(failure)
                    continue  # the loop drains the rest as invalidated
                if first_err is not None:
                    # every channel was drained above, so the graph stays
                    # valid — only this step is poisoned
                    err = DagExecutionError(f"a DAG node failed: {first_err}")
                    err.__cause__ = first_err
                    head._set_exc(err)
                else:
                    head._set_value(outs if self._multi else outs[0])

    # -------------------------------------------------- io-thread callbacks

    def _on_push(self, payload: dict) -> None:
        key = payload.get("c", "")
        if key == self._ctl_key:
            self._mark_broken(payload.get("fault", "participant reported a channel fault"))
            return
        reader = self._readers.get(key)
        if reader is not None:
            reader.push(payload)

    def _mark_broken(self, reason: str) -> None:
        """Invalidate the graph (io thread or execute thread) and wake any
        reader the execute thread is blocked on."""
        with self._state_lock:
            if self._torn_down or self._broken is not None:
                return
            self._broken = reason
        for reader in self._readers.values():
            reader.wake_broken(reason)

    # ------------------------------------------------------------ teardown

    def teardown(self) -> None:
        """Release every channel and executor; participants return to
        normal eager service.  Idempotent."""
        with self._state_lock:
            if self._torn_down:
                return
            self._torn_down = True
        self._release(best_effort_remote=True)

    def _release(self, best_effort_remote: bool) -> None:
        # FIRST unblock any execute() parked on an output read (teardown
        # never takes _step_lock, so it can run concurrently with one):
        # the broken-wake turns its pending reads into DagExecutionError
        # instead of a forever-empty queue
        for reader in self._readers.values():
            reader.wake_broken("compiled DAG torn down")
        # an event-loop thread (the __del__ safety net can fire on the io
        # thread once the last strong ref dies inside a push callback)
        # must not block on dag_rpc: io.call would wait on a coroutine
        # scheduled on the very loop this thread is stalling
        if best_effort_remote:
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                pass
            else:
                best_effort_remote = False
        # a disconnected driver has no io loop to run the RPC on — the
        # stopped (never closed) loop would park the coroutine forever;
        # teardown-after-shutdown is local-release only by contract
        if not self._cw.connected:
            best_effort_remote = False
        for part in self._participants:
            if part.conn is None or part.conn.closed:
                continue
            if best_effort_remote:
                try:
                    self._cw.dag_rpc(
                        part.conn,
                        MsgType.DAG_TEARDOWN,
                        {"dag_id": self._dag_id},
                        RayConfig.dag_setup_timeout_s,
                    )
                except (ConnectionError, OSError, TimeoutError, RuntimeError):
                    # dead participant (its runtime tears down on conn loss)
                    # or the io loop already stopped (teardown after
                    # ray_tpu_torch.shutdown) — local release below still runs
                    pass
        # remote ends released their pins first (above), so the driver-side
        # ring deletes in writer.close() actually reclaim the segments
        for writer in self._input_writers:
            writer.close()
        self._input_writers = []
        for reader in self._readers.values():
            reader.close()
        self._readers = {}
        for part in self._participants:
            if part.conn is not None:
                try:
                    self._cw.close_dag_conn(part.conn)
                except RuntimeError:
                    pass  # io loop closed: the conn died with it
                part.conn = None

    def __del__(self):
        try:
            if not self._torn_down and self._cw.connected:
                self.teardown()
        except Exception:  # noqa: BLE001 -- interpreter teardown; nothing to report to
            pass
