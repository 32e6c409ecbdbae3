"""Worker-resident executor loops for compiled actor DAGs.

Installed into a worker by a ``DAG_SETUP`` frame on the actor's direct-call
server (core/worker_main.py routes the DAG_* frames here).  Each bound
method node hosted on this actor gets ONE resident thread that blocks on
its input channels, runs the method, and pushes the result straight to its
consumer channels — the head scheduler never sees a compiled step.

Error contract (the JAX package's dag/DESIGN.md):

- a method exception is serialized as the step's value with the error flag
  set and forwarded on every output channel — downstream nodes skip
  execution and forward it (poison), so channels stay step-aligned and the
  driver raises a typed ``DagExecutionError``; the graph stays valid.
- a transport fault (severed channel, dead peer, sequence gap) breaks the
  channel: the node notifies the driver on the control channel, stops its
  loop, and the driver invalidates the graph (re-compile-or-fail).

Teardown (``DAG_TEARDOWN``, or the driver conn dropping) stops the loops
and releases every channel — the actor returns to normal eager service.
Eager calls and compiled steps on the same sequential actor are mutually
excluded by the worker's ``actor_lock``.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.protocol import Connection, MsgType
from ray_tpu_torch.dag.channel import (
    ChannelBrokenError,
    ChannelClosedError,
    ChannelReader,
    ChannelWriter,
    decode_wire,
    encode_value,
)
from ray_tpu_torch.exceptions import RayTaskError
from ray_tpu_torch.util.lockwitness import named_lock

logger = logging.getLogger(__name__)

CTL_PREFIX = "!ctl:"


class _NodeState:
    """One installed method node: its channels, consts, and loop thread."""

    def __init__(self, label: str, method, arg_specs: List[dict], lock: bool = True):
        self.label = label
        self.method = method
        self.arg_specs = arg_specs  # [{"k": kwarg|None, "t": "chan"|"const", ...}]
        self.lock = lock  # False: run without the actor's sequential lock
        self.readers: List[ChannelReader] = []  # dedup'd, fixed read order
        self.writers: List[ChannelWriter] = []
        self.by_key: Dict[str, ChannelReader] = {}
        self.thread: Optional[threading.Thread] = None
        self.seq = 0


class _DagInstance:
    def __init__(self, dag_id: str, setup_conn, events: bool):
        self.dag_id = dag_id
        self.setup_conn = setup_conn
        self.events = events
        self.nodes: List[_NodeState] = []
        self.faulted = False
        # flight-recorder batching (reference analog: task_event_buffer.cc
        # flushes periodically, never per event): node loops append step
        # records under _ev_lock, one DAG_STEP frame ships a batch
        self._ev_lock = named_lock("_DagInstance._ev_lock")
        self._ev_buf: List[dict] = []
        self._ev_last_flush = 0.0


class DagWorkerRuntime:
    """Per-worker registry of installed DAGs and their channel readers.

    All registry mutation happens on the worker's single io loop (setup /
    teardown handlers and conn-loss callbacks run there); executor threads
    only consume their own queues and channels.
    """

    def __init__(self, runtime):
        self._runtime = runtime  # core.worker_main.WorkerRuntime
        self.cw = runtime.cw
        self._dags: Dict[str, _DagInstance] = {}
        self._readers: Dict[str, ChannelReader] = {}

    # ------------------------------------------------------------- frames

    def handle_push(self, payload: dict) -> None:
        """io thread: route one DAG_PUSH to its channel queue.  O(1), never
        blocks; frames for channels torn down while in flight are dropped."""
        reader = self._readers.get(payload.get("c", ""))
        if reader is not None:
            reader.push(payload)

    async def handle_setup(self, payload: dict, conn) -> dict:
        """Install this actor's nodes of one compiled DAG: register input
        channels, dial consumer conns (pre-wiring — no per-step dials), and
        start the resident executor threads."""
        dag_id = str(payload["dag_id"])
        if dag_id in self._dags:
            return {"ok": False, "error": f"dag {dag_id} already installed"}
        instance = self._runtime.actor.instance
        if instance is None:
            return {"ok": False, "error": "actor instance not initialized"}
        events_on = bool(payload.get("events"))
        if events_on:
            from ray_tpu_torch._private import task_events

            events_on = task_events.enabled
        dag = _DagInstance(dag_id, conn, events_on)
        try:
            for node_p in payload.get("nodes", []):
                await self._setup_node(dag, node_p, conn, instance)
        except Exception as e:  # noqa: BLE001 -- setup must unwind cleanly, whatever failed
            self._release_dag(dag)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        self._dags[dag_id] = dag
        if payload.get("arm", True):
            self._arm(dag)
        return {"ok": True, "nodes": len(dag.nodes)}

    async def handle_arm(self, payload: dict) -> dict:
        """Gang-setup phase 2: start this participant's resident loops.
        Sent only after EVERY participant acknowledged its (unarmed)
        DAG_SETUP, so a multi-host graph arms atomically — no loop runs
        anywhere until all hosts are wired (step_dag gang contract)."""
        dag = self._dags.get(str(payload.get("dag_id", "")))
        if dag is None:
            return {"ok": False, "error": "dag not installed (setup missing or torn down)"}
        self._arm(dag)
        return {"ok": True, "nodes": len(dag.nodes)}

    def _arm(self, dag: _DagInstance) -> None:
        """Start the resident executor threads (idempotent)."""
        for node in dag.nodes:
            if node.thread is not None:
                continue
            node.thread = threading.Thread(
                target=self._node_loop,
                args=(dag, node),
                name=f"dag-exec-{dag.dag_id[:8]}-{node.label}",
                daemon=True,
            )
            node.thread.start()

    async def _setup_node(self, dag: _DagInstance, node_p: dict, conn, instance) -> None:
        method_name = str(node_p["method"])
        method = getattr(instance, method_name, None)
        if method is None or not callable(method):
            raise AttributeError(f"actor has no method {method_name!r}")
        arg_specs = []
        for spec in node_p.get("args", []):
            if spec.get("t") == "const":
                # constants ship once at compile and are decoded here, never
                # re-serialized per step
                arg_specs.append(
                    {"k": spec.get("k"), "t": "const", "value": decode_wire(spec["w"])}
                )
            else:
                arg_specs.append({"k": spec.get("k"), "t": "chan", "c": str(spec["c"])})
        node = _NodeState(
            str(node_p.get("label") or method_name),
            method,
            arg_specs,
            lock=bool(node_p.get("lock", True)),
        )
        # register into dag.nodes BEFORE any channel wiring: a failure
        # below (unreachable consumer, dead ring) must let _release_dag
        # close this node's dialed conns and unregister its readers too
        dag.nodes.append(node)
        for in_p in node_p.get("ins", []):
            key = str(in_p["c"])
            reader = ChannelReader(
                key, store=self.cw.store, co_located=bool(in_p.get("co"))
            )
            node.readers.append(reader)
            node.by_key[key] = reader
            self._readers[key] = reader
        for out_p in node_p.get("outs", []):
            key = str(out_p["c"])
            if out_p.get("kind") == "back":
                # the consumer is the driver: push on the conn it opened
                node.writers.append(
                    ChannelWriter(
                        key,
                        self.cw.io,
                        conn,
                        store=self.cw.store,
                        co_located=bool(out_p.get("co")),
                    )
                )
                continue
            host, port_s = str(out_p["addr"]).rsplit(":", 1)
            peer = await Connection.connect(
                host, int(port_s), RayConfig.connect_timeout_s, retry=False
            )
            self.cw.io.spawn(self._peer_read_loop(peer))
            node.writers.append(
                ChannelWriter(
                    key,
                    self.cw.io,
                    peer,
                    store=self.cw.store,
                    co_located=bool(out_p.get("co")),
                    owns_conn=True,
                )
            )

    async def _peer_read_loop(self, conn):
        """Drain a producer-dialed consumer conn (nothing flows back on it;
        this exists to notice EOF so the socket doesn't linger half-dead)."""
        try:
            while True:
                await conn.read_frame()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            conn.close()

    async def handle_teardown(self, payload: dict) -> dict:
        dag = self._dags.pop(str(payload.get("dag_id", "")), None)
        if dag is None:
            return {"ok": True, "absent": True}
        for node in dag.nodes:
            for reader in node.readers:
                reader.stop()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and any(
            n.thread is not None and n.thread.is_alive() for n in dag.nodes
        ):
            await asyncio.sleep(0.005)
        self._release_dag(dag)
        stopped = not any(n.thread is not None and n.thread.is_alive() for n in dag.nodes)
        return {"ok": True, "stopped": stopped}

    def on_conn_lost(self, conn) -> None:
        """io thread: the driver's setup conn died — the dag dies with its
        driver.  Stop the loops; each loop releases its own channels."""
        for dag_id, dag in list(self._dags.items()):
            if dag.setup_conn is conn:
                self._dags.pop(dag_id, None)
                for node in dag.nodes:
                    for reader in node.readers:
                        reader.stop()
                self._unregister(dag)

    # ----------------------------------------------------------- executor

    def _node_loop(self, dag: _DagInstance, node: _NodeState) -> None:
        """The resident hot loop: block on inputs → run → push.  With task
        events off this stamps nothing — one flag check per step.  (The JAX
        package marks this method as a loop root for its static analyzer,
        graftsan; the port has no such analyzer and imports nothing of that
        package, so it carries no mark.)"""
        try:
            while True:
                t_wait = time.time() if dag.events else 0.0
                try:
                    in_vals, err_in = self._gather(node)
                except ChannelClosedError:
                    break
                except (ChannelBrokenError, TimeoutError) as e:
                    self._transport_fault(dag, node, e)
                    break
                seq = node.seq
                node.seq += 1
                t_exec = time.time() if dag.events else 0.0
                if err_in is not None:
                    out_val, is_err = err_in, True  # poison forward, skip exec
                else:
                    out_val, is_err = self._invoke(node, in_vals)
                t_done = time.time() if dag.events else 0.0
                try:
                    wire, nbytes = encode_value(out_val)
                    for writer in node.writers:
                        writer.write(seq, wire, nbytes, err=is_err)
                except ChannelBrokenError as e:
                    self._transport_fault(dag, node, e)
                    break
                if dag.events:
                    self._emit_step(dag, node, seq, is_err, t_wait, t_exec, t_done)
        finally:
            if dag.events:
                self.flush_steps(dag)
            self._release_node(node)

    def _gather(self, node: _NodeState):
        """One message from EVERY input channel (fixed order) — reading all
        inputs even after an error keeps the channels step-aligned, which
        is what lets the graph survive an application exception."""
        values: Dict[str, object] = {}
        first_err = None
        for reader in node.readers:
            is_err, value = reader.get()
            if is_err and first_err is None:
                first_err = value
            values[reader.key] = value
        if first_err is not None:
            return None, first_err
        args, kwargs = [], {}
        for spec in node.arg_specs:
            value = spec["value"] if spec["t"] == "const" else values[spec["c"]]
            if spec["k"]:
                kwargs[spec["k"]] = value
            else:
                args.append(value)
        return (args, kwargs), None

    def _invoke(self, node: _NodeState, in_vals):
        args, kwargs = in_vals
        try:
            fn = node.method
            if inspect.iscoroutinefunction(getattr(fn, "__func__", fn)):
                fut = asyncio.run_coroutine_threadsafe(
                    fn(*args, **kwargs), self._runtime.actor.async_loop
                )
                # The node loop is a resident data-plane thread whose step
                # IS this call: parking on the actor's asyncio loop until
                # the async method finishes is the execution model.
                return fut.result(), False
            if not node.lock:
                # node opted out via bind(...).options(lock=False): it may
                # overlap the locked nodes and eager calls on this actor —
                # the declaration site owns the disjoint-state contract
                # (the resident feeder stage of a train DAG pipelines
                # against the locked step stage exactly this way)
                return fn(*args, **kwargs), False
            # compiled steps and eager calls on the same actor are mutually
            # excluded — the actor's sequential-execution contract holds
            # across both modes
            with self._runtime.actor_lock:
                return fn(*args, **kwargs), False
        except BaseException as e:  # noqa: BLE001 -- becomes the step's poisoned value
            return RayTaskError.from_exception(node.label, e), True

    def _transport_fault(self, dag: _DagInstance, node: _NodeState, exc: BaseException) -> None:
        """A channel died under this node: tell the driver (best-effort —
        the driver's own conn monitoring is the backstop) so it invalidates
        the graph, and log locally either way."""
        if dag.faulted:
            return
        dag.faulted = True
        logger.warning("dag %s node %s channel fault: %s", dag.dag_id, node.label, exc)
        try:
            self.cw.io.spawn(
                dag.setup_conn.send(
                    MsgType.DAG_PUSH,
                    {"c": CTL_PREFIX + dag.dag_id, "fault": f"{node.label}: {exc}"},
                )
            )
        except RuntimeError:
            pass  # io loop already stopped; the conn loss reaches the driver anyway

    # flush a DAG_STEP batch when it reaches this many records or this
    # much staleness — per-step frames would triple the hot loop's process
    # wakeups on a small box (reference analog: task_event_buffer.cc
    # flushes on a timer, never per event).  64 (was 16): at resident
    # train-loop rates (~4k steps/s × 3 nodes) a 16-record batch meant an
    # io-loop wakeup every ~5 steps, which measurably throttled the loop
    # itself; the staleness bound below keeps low-rate graphs timely.
    _EV_BATCH = 64
    _EV_FLUSH_S = 0.1

    def _emit_step(self, dag, node, seq, is_err, t_wait, t_exec, t_done) -> None:
        """Buffer one compiled step's flight record; a full or stale
        buffer ships as a single DAG_STEP frame (head joins the batch
        into the timeline / phase histograms).  Off the critical path:
        the flush rides the io loop."""
        # stamp names come from the canonical task_events.PHASES vocabulary
        # (graftlint GL008 checks these literal sites)
        ph: Dict[str, float] = {}
        ph["dag_channel_wait_start"] = t_wait
        ph["dag_channel_wait_end"] = t_exec
        ph["dag_exec_start"] = t_exec
        ph["dag_exec_end"] = t_done
        ph["dag_push_end"] = time.time()
        rec = {
            "name": node.label,
            "seq": seq,
            "pid": os.getpid(),
            "error": bool(is_err),
            "phases": ph,
        }
        with dag._ev_lock:
            dag._ev_buf.append(rec)
            now = ph["dag_push_end"]
            if (
                len(dag._ev_buf) < self._EV_BATCH
                and now - dag._ev_last_flush < self._EV_FLUSH_S
            ):
                return
            batch, dag._ev_buf = dag._ev_buf, []
            dag._ev_last_flush = now
        self._ship_steps(dag, batch)

    def flush_steps(self, dag: "_DagInstance") -> None:
        """Ship whatever step records remain (teardown / loop exit)."""
        with dag._ev_lock:
            batch, dag._ev_buf = dag._ev_buf, []
        if batch:
            self._ship_steps(dag, batch)

    def _ship_steps(self, dag: "_DagInstance", batch: List[dict]) -> None:
        # ring occupancy samples ride the batch (one header unpack per
        # channel per flush — the memory accounting plane costs the hot
        # loop nothing extra)
        channels = []
        for node in dag.nodes:
            for reader in node.readers:
                occ = reader.occupancy()
                if occ is not None:
                    channels.append(
                        {"c": reader.key, "occ": occ[0], "slots": occ[1]}
                    )
        try:
            self.cw.io.spawn(
                self.cw.conn.send(
                    MsgType.DAG_STEP,
                    {
                        "dag_id": dag.dag_id,
                        "node_id": self.cw.node_id,
                        "steps": batch,
                        "channels": channels,
                    },
                )
            )
        except RuntimeError:
            pass  # io loop gone mid-shutdown; the steps already completed

    # ------------------------------------------------------------ cleanup

    def _release_node(self, node: _NodeState) -> None:
        for writer in node.writers:
            writer.close()
        for reader in node.readers:
            reader.close()

    def _release_dag(self, dag: _DagInstance) -> None:
        for node in dag.nodes:
            if node.thread is None:  # setup failed before threads started
                self._release_node(node)
        self._unregister(dag)

    def _unregister(self, dag: _DagInstance) -> None:
        for node in dag.nodes:
            for reader in node.readers:
                self._readers.pop(reader.key, None)
