"""CoreWorker: the in-process runtime for drivers and workers.

Analog of the reference's C++ CoreWorker (reference:
src/ray/core_worker/core_worker.cc — SubmitTask:1617, Put:923, Get:1130,
Wait:1268, CreateActor:1680, SubmitActorTask:1913) plus its Cython binding
(python/ray/_raylet.pyx:1253).  Each process owns one CoreWorker holding:

- a multiplexed TCP connection to the head (control plane), serviced by a
  dedicated asyncio thread (the analog of the reference's io_service threads)
- an attachment to the node-local shared-memory object store (data plane)
- local reference counting with batched release to the head (the
  owner-centralized form of reference reference_count.cc)
- the function table client (export/fetch via head KV, analog of
  python/ray/_private/function_manager.py)
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.log_plane import LOG_TAIL_MARKER
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.protocol import Connection, MsgType
from ray_tpu_torch._private.serialization import SerializedObject
from ray_tpu_torch._private.task_spec import (
    ACTOR_CREATION_TASK,
    ACTOR_TASK,
    ARG_REF,
    ARG_VALUE,
    NORMAL_TASK,
    TaskSpec,
)
from ray_tpu_torch.core.shm_store import ShmObjectStore
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    HeadUnreachableError,
    ObjectLostError,
    PreemptedError,
    RayActorError,
    RaySystemError,
    RayTaskError,
    TaskCancelledError,
    WorkerCrashedError,
)
from ray_tpu_torch.util.lockwitness import named_condition, named_lock

logger = logging.getLogger(__name__)

_ERROR_CLASSES = {
    "RayActorError": RayActorError,
    "ActorDiedError": ActorDiedError,
    "TaskCancelledError": TaskCancelledError,
    "WorkerCrashedError": WorkerCrashedError,
    "SchedulingError": RaySystemError,
    "ObjectLostError": ObjectLostError,
    "PreemptedError": PreemptedError,
}


def _new_span():
    from ray_tpu_torch.util.tracing import new_span_context

    return new_span_context()


def _new_phases():
    """Flight-recorder stamp dict for a spec being built now, or None when
    recording is off (the single submit-side flag check)."""
    from ray_tpu_torch._private import task_events

    if not task_events.enabled:
        return None
    return task_events.new_phases()


def _error_from_string(msg: str) -> Exception:
    # head-side crash forensics: the sealed reason may carry the victim's
    # captured log tail appended as one marker line (gcs/server.py
    # _with_log_tail) — split it off and attach it typed
    log_tail = []
    if LOG_TAIL_MARKER in msg:
        msg, _, tail_json = msg.partition(LOG_TAIL_MARKER)
        msg = msg.rstrip()
        try:
            import json as _json

            log_tail = list(_json.loads(tail_json))
        except ValueError:
            log_tail = []
    head, _, rest = msg.partition(":")
    cls = _ERROR_CLASSES.get(head.strip())
    if cls is RayActorError or cls is ActorDiedError:
        return cls(reason=rest.strip() or msg, log_tail=log_tail)
    if cls is TaskCancelledError:
        return TaskCancelledError()
    if cls is PreemptedError:
        # the head seals "... (attempt N/M)": recover the accounting so
        # callers can read .attempt/.budget off the typed error
        import re as _re

        m = _re.search(r"attempt (\d+)/(\d+)", rest)
        base = rest.rsplit(" (attempt ", 1)[0].strip() or "task preempted"
        if m:
            return PreemptedError(base, int(m.group(1)), int(m.group(2)))
        return PreemptedError(base)
    if cls:
        try:
            return cls(rest.strip() or msg)
        except TypeError:
            pass
    return RaySystemError(msg)


class _Lease:
    """One cached worker lease (control-plane fast path): a direct
    connection to a leased worker plus the in-flight task table.  All
    mutable state is guarded by CoreWorker._lease_lock."""

    __slots__ = (
        "lease_id",
        "worker_id",
        "addr",
        "conn",
        "shape",
        "node_id",
        "granted_by",
        "grantor",  # "head" | node_id bytes (raylet agent)
        "pool",  # owning _LeasePool
        "inflight",  # task_id -> {"wire": spec wire, "oids": [...], "t": push ts}
        "revoked",
        "returned",
        "last_used",
        "push_buffer",
        "flush_scheduled",
    )

    def __init__(self, lease_id, worker_id, addr, conn, shape, node_id, granted_by, grantor, pool):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.addr = addr
        self.conn = conn
        self.shape = shape
        self.node_id = node_id
        self.granted_by = granted_by
        self.grantor = grantor
        self.pool = pool
        self.inflight: Dict[bytes, dict] = {}
        self.revoked = False
        self.returned = False
        self.last_used = time.time()
        self.push_buffer: List[dict] = []
        self.flush_scheduled = False


class _LeasePool:
    """All leases a client holds for one (shape, affinity, band), plus
    the client-side dispatch queue over them.  The pump assigns
    breadth-first (idle leases before deepening any queue) so wall-clock
    parallelism survives, grows the pool toward the demand (up to
    ``lease_max_per_shape``), bounds per-lease queue depth by the
    observed task duration (``lease_queue_latency_budget_s`` /
    EWMA: tiny tasks pipeline deep, long tasks spread), and overflows to
    the head path when the pool is saturated and cannot grow — the head
    stays the capacity authority."""

    __slots__ = ("key", "leases", "queue", "growing", "ewma", "denied_at")

    def __init__(self, key):
        self.key = key
        self.leases: List[_Lease] = []
        from collections import deque

        self.queue = deque()  # TaskSpec objects not yet assigned anywhere
        self.growing = 0  # lease requests in flight
        # observed mean task duration (push→done, seconds); optimistic
        # start so unknown workloads pipeline a little, corrected by the
        # first completions — overestimates (queue wait included) only
        # push toward MORE breadth, the safe direction
        self.ewma = 0.02
        self.denied_at = 0.0

    # tests/tooling treat the registry values as "the leases"
    def __bool__(self):
        return bool(self.leases)

    def __len__(self):
        return len(self.leases)

    def __iter__(self):
        return iter(self.leases)


class _EventLoopThread:
    """Dedicated asyncio loop thread servicing the head connection."""

    def __init__(self, name: str = "ray_tpu_torch-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def call(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        def _halt():
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            # stop on the NEXT tick so cancellations actually unwind first
            self.loop.call_soon(self.loop.stop)

        self.loop.call_soon_threadsafe(_halt)
        self._thread.join(timeout=5)


class CoreWorker:
    def __init__(
        self,
        head_host: str,
        head_port: int,
        mode: str,  # "driver" | "worker"
        job_id: Optional[JobID] = None,
        node_id: Optional[bytes] = None,
        store_path: Optional[str] = None,
        worker_env: Optional[Dict[str, str]] = None,
    ):
        self.mode = mode
        self.job_id = job_id or JobID.from_int(os.getpid() & 0xFFFFFFFF)
        self.worker_id = WorkerID.from_random()
        self.node_id = node_id
        self.head_host, self.head_port = head_host, head_port
        self.current_task_id: Optional[bytes] = None  # set by the executor
        self._put_counter = 0
        self._put_lock = named_lock("CoreWorker._put_lock")
        self._local_refs: Dict[bytes, int] = {}
        self._refs_lock = named_lock("CoreWorker._refs_lock")
        self._pending_removals: List[bytes] = []
        self._pending_adds: List[bytes] = []
        self._submit_buffer: List[dict] = []
        self._submit_flush_scheduled = False
        self._exported_functions: Dict[bytes, bool] = {}
        self._fetched_functions: Dict[bytes, Any] = {}
        self._actor_seq: Dict[bytes, int] = {}
        # --- direct actor-call state (reference analog: DirectActorSubmitter
        # + the in-process memory store, core_worker.cc:1146) ---
        # small direct-call results live here, never in shm or at the head
        self._memory_store: Dict[bytes, SerializedObject] = {}
        # oid -> threading.Event set when its direct reply lands
        self._direct_pending: Dict[bytes, threading.Event] = {}
        # signalled on every direct completion (wait() blocks here instead
        # of on individual events, which would starve in list order)
        self._direct_cv = named_condition("CoreWorker._direct_cv")
        self._direct_conns: Dict[bytes, Connection] = {}  # actor_id -> conn
        # oid -> callbacks fired once the object resolves (io-loop context;
        # tracks in-flight calls without a thread per request).  _cb_lock
        # orders registration against _wake_direct so a resolving direct
        # call can't slip between the resolved-check and the pending-check.
        self._done_callbacks: Dict[bytes, List[Callable[[], None]]] = {}
        self._cb_lock = named_lock("CoreWorker._cb_lock")
        # task_id -> arg ObjectRef handles held until the reply: the head
        # never sees a direct task, so the CALLER's local refs are what pin
        # the args for the call's duration
        self._direct_keepalive: Dict[bytes, list] = {}
        # last failed ALIVE probe per actor (negative cache: don't pay an
        # ACTOR_STATE round-trip per submit while the actor is creating;
        # invalidated by the head's actor-state pubsub on ALIVE)
        self._direct_probe_at: Dict[bytes, float] = {}
        self._actor_events_subscribed = False
        self._push_task_handler: Optional[Callable[[dict], None]] = None
        # multi-tenant scheduling: the job-level band every spec this
        # process submits defaults to (ray_tpu_torch.init(priority=...) /
        # RAY_TPU_JOB_PRIORITY); per-call .options(priority=) overrides
        self.default_priority = 1
        # head → actor-worker checkpoint request (PREEMPT_ACTOR); the
        # worker runtime installs the handler that runs __ray_save__
        self._preempt_handler: Optional[Callable[[dict], dict]] = None
        self._early_pushes: List[dict] = []  # frames that raced handler setup
        self._disconnect_cbs: List[Callable[[], None]] = []
        self._subscriptions: Dict[str, List[Callable[[dict], None]]] = {}
        self.connected = False

        # --- head fault tolerance (gcs/HEAD_FT.md) ---
        # set while the head connection is healthy; cleared for the length
        # of a redial window (head_reconnect_window_s) so head-path RPCs
        # PARK instead of failing, then either resume on the reattached
        # conn or fail typed when the window closes
        self._head_up = threading.Event()
        self._head_up.set()
        self._reattach_cbs: List[Callable[[], None]] = []
        # worker-runtime hook returning {actor, actor_direct_addr,
        # running} for the reattach announce (installed by worker_main)
        self._reattach_state_cb: Optional[Callable[[], dict]] = None
        from collections import OrderedDict as _OrderedDict
        from collections import deque as _deque

        # task_id -> spec wire for head-path submits whose completion we
        # haven't observed: resubmitted (idempotency key = task id) after
        # a reattach so a submit racing the crash is never lost — and
        # never double-executed (the head dedupes against sealed returns
        # and worker re-announces).  Bounded; pruned as gets resolve.
        self._unacked_submits: "_OrderedDict[bytes, dict]" = _OrderedDict()
        # recent TASK_DONE payloads, replayed (flagged) after a reattach —
        # the worker can't know which of them the dead head processed
        self._done_ring: "_deque" = _deque(maxlen=256)
        # actor ids this driver created (reclaimed on reattach so the
        # restarted head re-learns ownership)
        self._owned_actors: set = set()
        self._worker_reg: dict = {}  # registration echo for reattach
        self._driver_env: Dict[str, str] = {}
        # ref-flush batches awaiting re-send after a failed attempt
        # ((stable batch id, msg type, oids); io-thread only)
        self._ref_retry_batches: List[tuple] = []

        # --- worker-lease cache (control-plane fast path) ---
        # (shape, node_affinity, band) -> _LeasePool: once leases for
        # shape S are held, queues of S-shaped tasks push straight to the
        # leased workers — no head round-trip per task
        self._lease_lock = named_lock("CoreWorker._lease_lock")
        self._leases: Dict[tuple, _LeasePool] = {}
        self._lease_by_id: Dict[bytes, _Lease] = {}
        self._lease_gc_started = False
        # raylet-local dispatch: node_id -> lease-agent conn (or False =
        # known absent), discovered via LIST_NODES labels
        self._node_agent_conn: Dict[bytes, Any] = {}
        # GCS shard plane: one conn to a shard listener, dialed after
        # registration; None means everything routes to the head
        self._shard_conn: Optional[Connection] = None

        self.is_client = False  # remote driver without a local store mmap
        self._client_promoted: set = set()
        self._conn_lost = False
        self.io = _EventLoopThread()
        try:
            # connect() retries with backoff inside the window, so a head
            # mid-restart is absorbed; past the window the failure is TYPED,
            # not a generic timeout 60s later
            self.conn: Connection = self.io.call(
                Connection.connect(head_host, head_port, RayConfig.connect_timeout_s)
            )
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            self.io.stop()
            raise HeadUnreachableError(
                f"head at {head_host}:{head_port} unreachable within the "
                f"{RayConfig.connect_timeout_s:.1f}s dial window: {e}"
            ) from e
        self.store: Optional[ShmObjectStore] = None
        self.io.spawn(self._read_loop(self.conn))
        self.io.spawn(self._gc_flush_loop())
        if mode == "worker":
            # liveness beacon: a SIGSTOPped/hung worker keeps its TCP socket
            # open, so the head needs missed-beat detection to re-schedule
            # its tasks (analog: reference gcs_heartbeat_manager.h)
            self.io.spawn(self._heartbeat_loop(self.conn))
        self.connected = True
        from ray_tpu_torch._private import chaos

        chaos.maybe_init_from_env("worker" if mode == "worker" else "driver")
        if mode == "driver":
            self.register_as_driver(worker_env or {})
        if chaos.aware():
            chaos.set_emitter(self._chaos_emit)
            self._chaos_sync()
        # sampling profiler (_private/profiler.py): one env read; unless
        # RAY_TPU_PROFILER=0 excised the plane, join the runtime arm/
        # disarm channel and point the stats sink at the head conn.
        # Zygote-forked workers land here after the fork, so the env read
        # sees the fork request's environment, not the zygote parent's.
        from ray_tpu_torch._private import profiler

        profiler.maybe_init_from_env("worker" if mode == "worker" else "driver")
        if profiler.aware():
            profiler.set_emitter(self._profile_emit)
            self._profile_sync()

    # ------------------------------------------------------------- plumbing

    # message types the GCS shard listeners serve (gcs/shards.py); plus
    # WAIT_OBJECT without a destination node and read-only ACTOR_STATE,
    # decided per-payload in _conn_for
    _SHARD_TYPES = frozenset(
        {
            MsgType.KV_PUT,
            MsgType.KV_GET,
            MsgType.KV_DEL,
            MsgType.KV_KEYS,
            MsgType.KV_EXISTS,
            MsgType.GET_ACTOR,
        }
    )

    def _conn_for(self, msg_type, payload) -> Connection:
        """Route shard-servable RPCs off the head loop (KV, object-locate
        waits, actor-directory reads); everything else — and everything
        when no shard conn is up — goes to the head."""
        sc = self._shard_conn
        if sc is None or sc.closed:
            return self.conn
        if msg_type in self._SHARD_TYPES:
            return sc
        if (
            msg_type == MsgType.WAIT_OBJECT
            and payload.get("node_id") is None
            and not payload.get("evicted")
        ):
            return sc
        if msg_type == MsgType.ACTOR_STATE and payload.get("direct_addr") is None:
            return sc
        return self.conn

    def request(self, msg_type, payload, timeout: Optional[float] = None):
        """Synchronous control RPC from any thread.  While a head redial
        window is open (head_reconnect_window_s), a lost head connection
        PARKS the call — it resumes on the reattached conn or fails with
        a typed HeadUnreachableError when the window closes.  With the
        window at 0 (the default) the historical fail-fast semantics are
        preserved: known-dead conn ⇒ immediate typed failure."""
        if self._conn_lost:
            raise HeadUnreachableError(
                f"head connection lost; {MsgType(msg_type).name} unavailable"
            )
        return self.io.call(
            self._head_request_parked(
                msg_type, payload, timeout or RayConfig.rpc_timeout_s
            )
        )

    async def _head_request_parked(
        self, msg_type, payload, timeout: Optional[float]
    ):
        """One control RPC with head-outage parking (io-loop coroutine).
        Retried RPCs on this path are idempotent by construction: reads
        (KV_GET/WAIT_OBJECT/...), overwriting writes (KV_PUT), or writes
        deduped server-side by an idempotency key (CREATE_ACTOR by actor
        id; SUBMIT rides the resubmit ring instead of this path).  The
        caller's timeout bounds the TOTAL wait, parking included — a 2s
        probe must not silently become a 30s reconnect-window stall."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._conn_lost:
                raise HeadUnreachableError(
                    f"head connection lost; {MsgType(msg_type).name} unavailable"
                )
            if deadline is not None and time.monotonic() >= deadline:
                raise HeadUnreachableError(
                    f"head unreachable: {MsgType(msg_type).name} still parked "
                    f"after its {timeout:.1f}s timeout"
                )
            if not self._head_up.is_set():
                # head mid-restart: park until the redial loop resolves it
                await asyncio.sleep(0.1)
                continue
            conn = self._conn_for(msg_type, payload)
            try:
                return await conn.request(msg_type, payload, timeout)
            except ConnectionError as e:
                # only transport loss converts: a remote ERROR_REPLY also
                # surfaces as ConnectionError but leaves the conn healthy
                if isinstance(e, HeadUnreachableError):
                    raise
                if conn is not self.conn and conn.closed:
                    # shard listener gone: permanent fallback to the head
                    # (it keeps every handler), retrying this call there
                    self._shard_conn = None
                    continue
                if self._conn_lost:
                    raise HeadUnreachableError(
                        f"head connection lost during {MsgType(msg_type).name}: {e}"
                    ) from e
                if not self.conn.closed and self._head_up.is_set():
                    raise  # application error on a healthy conn
                if RayConfig.head_reconnect_window_s <= 0:
                    raise HeadUnreachableError(
                        f"head connection lost during {MsgType(msg_type).name}: {e}"
                    ) from e
                # conn died under us with a redial window open: park + retry
                # (the brief sleep also covers the gap before the read
                # loop notices the loss and clears _head_up)
                await asyncio.sleep(0.05)

    def _dial_shard(self, addrs):
        """Dial one GCS shard listener (picked by worker-id hash so
        clients spread across shards); fire-and-forget — until it lands,
        everything routes to the head."""
        if not addrs or os.environ.get("RAY_TPU_NO_GCS_SHARDS"):
            return
        import zlib as _zlib

        addr = addrs[_zlib.crc32(self.worker_id.binary()) % len(addrs)]
        host, port_s = str(addr).rsplit(":", 1)

        async def _dial():
            try:
                conn = await Connection.connect(host, int(port_s), 5, retry=False)
            except Exception:  # graftlint: disable=silent-except -- shard plane is an offload; the head serves everything without it
                return
            self._shard_conn = conn

            async def _read():
                try:
                    while True:
                        mt, rid, pl = await conn.read_frame()
                        conn.dispatch_reply(mt, rid, pl)
                except (asyncio.IncompleteReadError, ConnectionError, OSError):
                    conn.close()
                    if self._shard_conn is conn:
                        self._shard_conn = None

            asyncio.get_running_loop().create_task(_read())

        self.io.spawn(_dial())

    async def _read_loop(self, conn: Connection):
        try:
            while True:
                msg_type, rid, payload = await conn.read_frame()
                if conn.dispatch_reply(msg_type, rid, payload):
                    continue
                if msg_type == MsgType.PUSH_TASK:
                    if self._push_task_handler:
                        self._push_task_handler(payload)
                    else:
                        self._early_pushes.append(payload)
                elif msg_type == MsgType.PUBLISH:
                    # iterate a snapshot: callbacks may unsubscribe
                    # themselves (weakref pruning) during the fan-out
                    for cb in list(self._subscriptions.get(payload.get("channel", ""), [])):
                        try:
                            cb(payload.get("message", {}))
                        except Exception:  # noqa: BLE001
                            logger.exception("pubsub subscriber callback raised")
                elif msg_type == MsgType.CANCEL_TASK and self._push_task_handler:
                    self._push_task_handler({"cancel": payload.get("task_id")})
                elif msg_type == MsgType.PREEMPT_ACTOR:
                    # checkpoint request: __ray_save__ is user code — run
                    # it on its own thread, never on this io loop
                    self._on_preempt_request(rid, payload)
                elif msg_type == MsgType.LEASE_REVOKE:
                    # the head wants a cached lease back (preemption):
                    # stop pushing, drain, return
                    self._on_lease_revoke(payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self._on_head_conn_lost(conn)

    # --------------------------------- head fault tolerance (reconnect)

    def _on_head_conn_lost(self, conn: Connection):
        """The head conn's read loop died (io thread).  With a redial
        window configured this starts the reconnect loop; otherwise it
        fails fast exactly like the historical path."""
        if conn is not self.conn or self._conn_lost:
            return  # stale read loop (conn already replaced) / deliberate
        window = RayConfig.head_reconnect_window_s
        if window <= 0:
            self._fail_head()
            return
        if not self._head_up.is_set():
            return  # reconnect already in flight
        # NOTE: self.connected stays True while the redial window is open —
        # the runtime is still attached (APIs park, direct/lease/DAG paths
        # keep flowing); it drops only when the window closes unrecovered
        self._head_up.clear()
        logger.warning(
            "head connection lost; redialing %s:%s for up to %.1fs",
            self.head_host,
            self.head_port,
            window,
        )
        asyncio.get_running_loop().create_task(self._reconnect_head(window))

    def _fail_head(self):
        """Terminal: the head is gone (no window, or the window closed).
        Parked callers wake and observe _conn_lost → typed failure."""
        self._conn_lost = True
        self.connected = False
        self._head_up.set()
        with self._direct_cv:
            self._direct_cv.notify_all()
        for cb in list(self._disconnect_cbs):
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("disconnect callback raised")

    async def _reconnect_head(self, window: float):
        from ray_tpu_torch._private import chaos as _chaos

        deadline = time.monotonic() + window
        backoff = _chaos.Backoff(base=0.1, cap=1.0)
        while True:
            if self._conn_lost:
                return  # deliberate disconnect raced the redial
            rem = deadline - time.monotonic()
            if rem <= 0:
                logger.error(
                    "head still unreachable after the %.1fs reconnect window",
                    window,
                )
                self._fail_head()
                return
            try:
                conn = await Connection.connect(
                    self.head_host, self.head_port, min(rem, 5.0), retry=False
                )
            except (ConnectionError, OSError, asyncio.TimeoutError):
                delay = backoff.next_delay_or(1.0)
                await asyncio.sleep(
                    min(delay, max(0.05, deadline - time.monotonic()))
                )
                continue
            try:
                await self._do_reattach(conn, deadline)
            except Exception:  # noqa: BLE001
                logger.warning("head reattach attempt failed; retrying", exc_info=True)
                conn.close()
                delay = backoff.next_delay_or(1.0)
                await asyncio.sleep(
                    min(delay, max(0.05, deadline - time.monotonic()))
                )
                continue
            return

    async def _do_reattach(self, conn: Connection, deadline: float):
        """Announce ourselves to the (restarted) head on a fresh conn and
        resume service: swap the conn, re-subscribe, replay unacked
        completions, resubmit unacked head-path submits (idempotency key:
        task id), wake every parked waiter."""
        # the reply needs a live read loop for this conn; if reattach
        # fails the loop dies with the closed conn and is ignored
        # (stale-conn guard in _on_head_conn_lost)
        asyncio.get_running_loop().create_task(self._read_loop(conn))
        with self._lease_lock:
            leases = [
                {
                    "lease_id": l.lease_id,
                    "worker_id": l.worker_id,
                    "resources": dict(l.shape),
                    "priority": int(l.pool.key[2]),
                }
                for l in self._lease_by_id.values()
                if l.grantor == "head" and not l.returned
            ]
        payload: Dict[str, Any] = {
            "pid": os.getpid(),
            # BOTH roles re-claim: a worker-hosted actor (one that
            # created actors) owns the actors it created just like a driver —
            # skipping its claim would owner-reap them at reconciliation
            "owned_actors": sorted(self._owned_actors),
            "leases": leases,
        }
        if self.mode == "worker":
            payload.update(
                {
                    "role": "worker",
                    "worker_id": self.worker_id.binary(),
                    "node_id": self.node_id,
                }
            )
            payload.update(self._worker_reg)
            if self._reattach_state_cb is not None:
                try:
                    payload.update(self._reattach_state_cb() or {})
                except Exception:  # noqa: BLE001
                    logger.exception("reattach state provider raised; announcing bare")
        else:
            payload.update(
                {
                    "role": "driver",
                    "job_id": self.job_id.binary(),
                    "worker_env": self._driver_env,
                }
            )
        while True:
            reply = await conn.request(MsgType.REATTACH, payload, 10)
            if reply.get("ok"):
                break
            if reply.get("retry") and time.monotonic() < deadline:
                # e.g. a worker whose raylet hasn't re-registered yet
                await asyncio.sleep(RayConfig.head_reattach_retry_s)
                continue
            raise ConnectionError(f"head rejected reattach: {reply!r}")
        old = self.conn
        self.conn = conn
        old.close()
        self._shard_conn = None
        self._dial_shard(reply.get("shard_addrs") or [])
        if reply.get("store_path") and not reply.get("store_preserved", True):
            # the head recreated its store segment (the survivor was
            # unusable): our mmap points at the dead inode — re-attach or
            # every later put/seal lands in a segment the head never reads
            try:
                self.attach_store(reply["store_path"])
            except Exception:  # noqa: BLE001
                logger.exception("store re-attach after head restart failed")
        if self.mode == "worker":
            asyncio.get_running_loop().create_task(self._heartbeat_loop(conn))
        for channel in list(self._subscriptions):
            await conn.send(MsgType.SUBSCRIBE, {"channel": channel})
        # replay completions the dead head may never have processed (the
        # head dedupes via its recent-done ring / sealed returns); snapshot
        # under the lock — executor/user threads mutate both rings
        with self._refs_lock:
            adds, self._pending_adds = self._pending_adds, []
            dones = list(self._done_ring)
            unacked = list(self._unacked_submits.values())
        # ref flushes STILL land before completions on the new conn: a
        # TASK_DONE replay unpins args — a late ADD_REF behind it could
        # resurrect a count on an already-freed object.  Batches keep
        # their id across attempts (io-thread only), so a send whose
        # first try raced delivery dedupes head-side instead of
        # double-counting.
        ref_batches = self._ref_retry_batches
        self._ref_retry_batches = []
        if adds:
            ref_batches.append((os.urandom(8), MsgType.ADD_REF, adds))
        if ref_batches:
            try:
                for bid, mtype, oids in ref_batches:
                    await conn.send(mtype, {"object_ids": oids, "batch": bid})
            except Exception:
                self._ref_retry_batches = ref_batches
                raise
        for done in dones:
            await conn.send(MsgType.TASK_DONE, dict(done, replay=True))
        # resubmit unacked submits — never double-executed: the head
        # dedupes by task id against sealed returns and re-announced
        # running tasks, parking verdicts until its grace window closes
        for wire in unacked:
            await conn.send(MsgType.SUBMIT_TASK, {"spec": wire, "resubmit": True})
        self.connected = True
        self._head_up.set()
        with self._direct_cv:
            self._direct_cv.notify_all()
        logger.info(
            "reattached to head (incarnation %s) after restart",
            reply.get("incarnation"),
        )
        if self._reattach_cbs:
            cbs = list(self._reattach_cbs)

            def _fire():
                for cb in cbs:
                    try:
                        cb()
                    except Exception:  # noqa: BLE001
                        logger.exception("reattach callback raised")

            threading.Thread(target=_fire, name="head-reattach-cbs", daemon=True).start()

    def on_reattach(self, cb: Callable[[], None]):
        """Invoke cb (dedicated thread) after every successful head
        reattach — e.g. an actor re-syncing the state of actors it owns."""
        self._reattach_cbs.append(cb)

    def set_reattach_state_provider(self, cb: Callable[[], dict]):
        """Worker-runtime hook: returns the reattach announce extras
        ({actor, actor_direct_addr, running: [spec wires]})."""
        self._reattach_state_cb = cb

    def on_disconnect(self, cb: Callable[[], None]):
        """Invoke cb (io thread) when the head connection drops — a worker
        whose head died must EXIT, not linger as an orphan blocked on its
        task queue (reference analog: workers die with their raylet).
        If the connection already dropped (head died before this
        registration), cb fires immediately — the callback must tolerate
        a possible double invocation in that race."""
        self._disconnect_cbs.append(cb)
        if not self.connected:
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("disconnect callback raised (immediate fire)")

    def _chaos_sync(self):
        """Late-joiner plan sync + live arm/disarm subscription.  Only runs
        in chaos-aware processes (RAY_TPU_CHAOS_* env), so the default path
        pays nothing; a process spawned after a runtime arm picks the plan
        up from KV, and subsequent arms/disarms arrive over pubsub."""
        import json as _json

        from ray_tpu_torch._private import chaos

        try:
            blob = self.kv_get("chaos:plan")
            if blob:
                chaos.apply_ctrl(_json.loads(bytes(blob).decode()))
            self.subscribe("chaos", chaos.apply_ctrl)
        except Exception:  # noqa: BLE001
            logger.warning(
                "chaos control-channel sync failed; an env-armed plan (if "
                "any) stays active, runtime arm/disarm won't reach this "
                "process",
                exc_info=True,
            )

    def _profile_sync(self):
        """Late-joiner profiler sync + live arm/disarm subscription: a
        process spawned after a runtime arm picks the control record up
        from KV ``profile:ctrl``; later arms/disarms arrive over the
        ``profile`` pubsub channel.  The callback registers synchronously
        (one dict append); the SUBSCRIBE + late-join KV read ride the io
        loop fire-and-forget, so a plane that defaults to disarmed adds
        ZERO blocking round trips to worker startup — the 600-actor
        creation path must not pay serialized head RPCs for this."""
        import json as _json

        from ray_tpu_torch._private import profiler

        self._subscriptions.setdefault("profile", []).append(profiler.apply_ctrl)

        async def _sync():
            try:
                # subscribe BEFORE the KV read: an arm landing in the gap
                # then reaches us twice (push + KV), and arm() is
                # idempotent — the reverse order could miss it entirely
                await self.conn.send(MsgType.SUBSCRIBE, {"channel": "profile"})
                reply = await self.conn.request(
                    MsgType.KV_GET, {"key": "profile:ctrl"}, 10
                )
                if reply.get("found"):
                    profiler.apply_ctrl(
                        _json.loads(bytes(reply["value"]).decode())
                    )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "profiler control-channel sync failed; an env-armed "
                    "sampler (if any) stays active, runtime arm/disarm "
                    "won't reach this process",
                    exc_info=True,
                )

        self.io.spawn(_sync())

    def _profile_emit(self, payload: dict):
        """Fire-and-forget folded-stack delta frame to the head (called
        from the sampler thread — must never block)."""
        if self.node_id:
            payload = dict(payload, node_id=self.node_id)
        try:
            self.io.spawn(self.conn.send(MsgType.PROFILE_STATS, payload))
        except Exception:  # graftlint: disable=silent-except -- profiler frames are best-effort observability; the process-local totals remain the witness
            pass

    def report_error(self, payload: dict):
        """Fire-and-forget structured error record (ERROR_REPORT) to the
        head's dedup ring — crash forensics, must never block or raise
        into the task error path."""
        if self.node_id:
            payload = dict(payload, node_id=self.node_id)
        try:
            self.io.spawn(self.conn.send(MsgType.ERROR_REPORT, payload))
        except Exception:  # graftlint: disable=silent-except -- forensics plane is best-effort; the stored RayTaskError is authoritative
            pass

    def fetch_log(self, payload: dict, timeout: float = 30.0) -> dict:
        """LOG_FETCH: pull log records by entity (worker/actor/task/
        job/node) — the head resolves the entity and serves its
        own node or forwards the read to the owning raylet."""
        return self.request(MsgType.LOG_FETCH, payload, timeout=timeout)

    def _chaos_emit(self, ev: dict):
        """Fire-and-forget structured event for a fired fault (RECORD_EVENT
        is exempt from injection, so emission can't recurse)."""
        try:
            self.io.spawn(
                self.conn.send(
                    MsgType.RECORD_EVENT,
                    {
                        "severity": "WARNING",
                        "source": "chaos",
                        "message": ev["message"],
                        "fields": ev["fields"],
                    },
                )
            )
        except Exception:  # graftlint: disable=silent-except -- fault events are best-effort observability; the local chaos.fired() log is authoritative
            pass

    async def _heartbeat_loop(self, conn: Connection):
        """Beats ride one specific conn and die with it — a successful
        reattach starts a fresh loop on the new conn."""
        period = RayConfig.heartbeat_period_ms / 1000.0
        try:
            while conn is self.conn:
                await asyncio.sleep(period)
                await conn.send(
                    MsgType.HEARTBEAT, {"worker_id": self.worker_id.binary()}
                )
        except (ConnectionError, OSError):
            pass

    async def _gc_flush_loop(self):
        while True:
            await asyncio.sleep(0.2)
            if not self._head_up.is_set():
                continue  # head mid-restart: keep batching, flush after
            # adds flush BEFORE removals so this process's +/- pairs can
            # never transiently go negative at the head.  Each batch keeps
            # a STABLE id across retries (the head dedupes re-sends whose
            # first attempt raced a conn loss after processing); a failed
            # batch re-queues FIFO so a head-restart window loses nothing.
            batches = self._ref_retry_batches
            self._ref_retry_batches = []
            with self._refs_lock:
                if self._pending_adds:
                    batches.append(
                        (os.urandom(8), MsgType.ADD_REF, self._pending_adds)
                    )
                    self._pending_adds = []
                if self._pending_removals:
                    batches.append(
                        (os.urandom(8), MsgType.REMOVE_REF, self._pending_removals)
                    )
                    self._pending_removals = []
            for i, (bid, mtype, oids) in enumerate(batches):
                try:
                    await self.conn.request(
                        mtype, {"object_ids": oids, "batch": bid}, 10
                    )
                except Exception:  # graftlint: disable=silent-except -- tail re-queued in order below; window 0 ⇒ the disconnect callback path owns shutdown
                    # keep the ordered tail for the next tick (attempting
                    # later batches after a failure could land removals
                    # ahead of their adds)
                    if not self._conn_lost:
                        self._ref_retry_batches = batches[i:]
                    break

    # ------------------------------------------------------------- refcounts

    def _add_local_ref(self, oid: bytes):
        # batched like removals (one request per flush cycle, not per ref):
        # a .remote() burst creating thousands of return refs must not pay
        # a head round trip each — ordering vs removals is preserved by the
        # adds-first flush
        with self._refs_lock:
            n = self._local_refs.get(oid, 0)
            self._local_refs[oid] = n + 1
            if n == 0:
                self._pending_adds.append(oid)

    def _remove_local_ref(self, oid: bytes):
        with self._refs_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n <= 0:
                self._local_refs.pop(oid, None)
                self._pending_removals.append(oid)
                # direct-call results live only in this process: last local
                # ref gone = value unreachable
                self._memory_store.pop(oid, None)
                # head-FT: a fire-and-forget submit retires once NO return
                # ref survives — nobody awaits it, so replaying it after a
                # reattach could only double-run its side effects
                # (ObjectID = task_id(24) + return index)
                tid = oid[:24]
                wire = self._unacked_submits.get(tid)
                if wire is not None and not any(
                    tid + i.to_bytes(4, "little") in self._local_refs
                    for i in range(int(wire.get("num_returns", 1)))
                ):
                    self._unacked_submits.pop(tid, None)
            else:
                self._local_refs[oid] = n

    # ------------------------------------------------------------ functions

    def export_function(self, fn_or_class: Any) -> Tuple[bytes, str]:
        """Ship a function/class definition to the head KV function table
        (analog: reference function_manager.py export via GCS KV)."""
        blob = serialization.dumps(fn_or_class)
        fid = hashlib.sha1(blob).digest()[:16]
        if fid not in self._exported_functions:
            key = f"fn:{fid.hex()}"
            self.request(MsgType.KV_PUT, {"key": key, "value": blob, "overwrite": False})
            self._exported_functions[fid] = True
        name = getattr(fn_or_class, "__name__", str(fn_or_class))
        return fid, name

    def fetch_function(self, function_id: bytes) -> Any:
        fn = self._fetched_functions.get(function_id)
        if fn is not None:
            return fn
        key = f"fn:{function_id.hex()}"
        # config-driven (not hardcoded) so chaos runs / slow CI can widen
        # the window without editing source; the client-side rpc timeout
        # keeps a margin over the server-side wait
        fetch_timeout = RayConfig.function_fetch_timeout_s
        reply = self.request(
            MsgType.KV_GET,
            {"key": key, "wait": True, "timeout": fetch_timeout},
            timeout=fetch_timeout + 5.0,
        )
        if not reply.get("found"):
            raise RaySystemError(f"function {function_id.hex()} not found in table")
        fn = serialization.loads(reply["value"])
        self._fetched_functions[function_id] = fn
        return fn

    # --------------------------------------------------------------- objects

    def _next_put_oid(self) -> bytes:
        with self._put_lock:
            self._put_counter += 1
            idx = self._put_counter
        task_id = (
            TaskID(self.current_task_id)
            if self.current_task_id
            else TaskID.for_driver_task(self.job_id)
        )
        return ObjectID.for_put(task_id, idx).binary()

    def put(self, value: Any, tier: Optional[str] = None) -> ObjectRef:
        """``tier``: None or "host" (serialize→shm).  The device tier (CUDA
        tensors pinned in place, pulled over the collective plane) is not
        ported: "device" raises, and the automatic tier never picks it."""
        if tier == "device":
            raise NotImplementedError(
                "put(tier='device'): the CUDA-resident object tier is not "
                "ported yet (ROADMAP, Queue 1: the device tier and GPU gauges)"
            )
        oid = self._next_put_oid()
        self.put_object(oid, serialization.serialize(value))
        return ObjectRef(oid, self)

    def put_object(self, oid: bytes, sobj: SerializedObject):
        # refs to memory-store-only values (direct-call results) must be
        # globally resolvable once they leave this process
        self._promote_memory_objects(sobj.contained)
        if self.store is None:
            # client mode: the payload rides the head connection and lands
            # in the head node's store (seal included server-side)
            self.request(
                MsgType.CLIENT_PUT,
                {
                    "object_id": oid,
                    "value": sobj.to_wire(),
                    "contained": sobj.contained,
                },
            )
            return
        if not self.store.put_serialized(oid, sobj):
            pass  # already present (idempotent put)
        # contained refs ride the seal message so the head pins the inner
        # objects for the container's lifetime (borrower protocol)
        self.request(
            MsgType.PUT_OBJECT,
            {
                "object_id": oid,
                "node_id": self.node_id,
                "contained": sobj.contained,
                "nbytes": sobj.total_bytes(),
            },
        )

    def _promote_memory_objects(self, oids: Sequence[bytes], _async: bool = False):
        """Make memory-store-only values (inline direct-call results)
        globally resolvable before their refs ship to another process:
        write to the node store + seal at the head (recursing through
        refs contained in the promoted values themselves).

        Refs whose producing direct call is still in flight are promoted
        ASYNCHRONOUSLY once the reply lands (the submit carries the ref
        immediately; any consumer blocks in the head WAIT_OBJECT until the
        deferred seal arrives) — blocking here would serialize chained
        actor-call pipelines and can deadlock when a sequential actor's own
        pending result is passed to a peer.  With _async=True the head seal
        is fire-and-forget (required on the io thread, where a blocking
        request would deadlock the loop)."""
        for oid in oids:
            oid = bytes(oid)
            if oid in self._direct_pending:
                self._defer_promotion(oid)
                continue
            sobj = self._memory_store.get(oid)
            if sobj is None:
                continue
            self._promote_memory_objects(sobj.contained, _async=_async)
            if self.store is None:
                # client mode: ship the payload through the head (once —
                # marked promoted only AFTER the RPC succeeds, so a
                # transient failure is retried on the next ship)
                if oid in self._client_promoted:
                    continue
                payload = {
                    "object_id": oid,
                    "value": sobj.to_wire(),
                    "contained": sobj.contained,
                }
                if _async:
                    self.io.spawn(
                        self._ship_promotion(MsgType.CLIENT_PUT, payload, mark=oid)
                    )
                else:
                    self.request(MsgType.CLIENT_PUT, payload)
                    self._client_promoted.add(oid)
                continue
            if self.store.contains(oid):
                continue
            self.store.put_serialized(oid, sobj)
            payload = {
                "object_id": oid,
                "node_id": self.node_id,
                "contained": sobj.contained,
                "nbytes": sobj.total_bytes(),
            }
            if _async:
                self.io.spawn(self._ship_promotion(MsgType.PUT_OBJECT, payload))
            else:
                self.request(MsgType.PUT_OBJECT, payload)

    async def _ship_promotion(self, msg_type, payload, mark: Optional[bytes] = None):
        """Deferred-promotion seal RPC with retries: a consumer may already
        be blocked in the head WAIT_OBJECT for this object, so a silently
        dropped seal would hang it — retry transient failures and log loud
        on final failure (the sync promotion path raises in the submitter
        instead)."""
        for attempt in range(3):
            try:
                await self.conn.request(msg_type, payload, 30)
                if mark is not None:
                    self._client_promoted.add(mark)
                return
            except asyncio.CancelledError:
                return
            except Exception:
                if attempt == 2:
                    logger.warning(
                        "deferred promotion seal failed for %s after 3 attempts; "
                        "consumers of this ref may hang",
                        bytes(payload["object_id"]).hex()[:16],
                    )
                    return
                await asyncio.sleep(0.2 * (attempt + 1))

    def _defer_promotion(self, oid: bytes):
        """Promote oid when its in-flight direct call completes, holding a
        local handle so the value can't be freed before the deferred seal."""
        keep = ObjectRef(oid, self)

        def _cb(_keep=keep):
            # may run on the io thread (from _wake_direct): promotion must
            # not block, hence the fire-and-forget seal path.  _keep dies
            # with this callback (popped from _done_callbacks after firing),
            # releasing the local handle once the promotion is in flight.
            self._promote_memory_objects([oid], _async=True)

        self.on_object_done(keep, _cb)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        out: List[Any] = [None] * len(refs)
        pending: List[Tuple[int, bytes]] = []
        for i, ref in enumerate(refs):
            oid = ref.binary() if isinstance(ref, ObjectRef) else bytes(ref)
            if oid in self._direct_pending:
                # in-flight direct actor call: wait for its reply, then
                # resolve from whatever it produced (memory store / shm /
                # head fallback).  Release our CPU while blocked, like the
                # head-wait path below.
                self._notify_blocked(True)
                try:
                    self._resolve_direct(oid, deadline)
                finally:
                    self._notify_blocked(False)
            sobj = self._memory_store.get(oid)
            if sobj is None and self.store is not None:
                sobj = self.store.get_serialized(oid)
            if sobj is not None:
                out[i] = self._materialize(sobj)
            else:
                pending.append((i, oid))
        if pending:
            self._notify_blocked(True)
            try:
                rem = None
                if deadline is not None:
                    rem = max(0.0, deadline - time.monotonic())

                if self.store is None:
                    # client mode: CLIENT_GET waits + pulls + returns the
                    # payload in ONE round trip (a separate WAIT_OBJECT
                    # first would duplicate the wait+pull server-side)
                    async def _fetch_all():
                        return await asyncio.gather(
                            *[
                                self._head_request_parked(
                                    MsgType.CLIENT_GET,
                                    {"object_id": oid, "timeout": rem},
                                    (rem + 10) if rem is not None else 3600,
                                )
                                for _, oid in pending
                            ]
                        )

                    for (i, oid), reply in zip(pending, self.io.call(_fetch_all())):
                        state = reply.get("state")
                        if state == "timeout":
                            raise GetTimeoutError(
                                f"get() timed out on {oid.hex()[:16]}"
                            )
                        if state == "error":
                            raise _error_from_string(
                                reply.get("error", "object fetch failed")
                            )
                        out[i] = self._materialize(
                            SerializedObject.from_wire(reply["value"])
                        )
                    return out

                # ONE batched wait for every missing ref (the head wakes us
                # as they all seal) — then read the local store; only refs
                # that are sealed-but-not-local (remote copies needing a
                # transfer, or head-side errors) fall back to the per-oid
                # WAIT_OBJECT form whose reply embeds the cross-node pull
                distinct_ids = list(dict.fromkeys(oid for _, oid in pending))
                reply = self.request(
                    MsgType.WAIT_OBJECT,
                    {
                        "object_ids": distinct_ids,
                        "num_ready": len(distinct_ids),
                        "timeout": rem,
                    },
                    timeout=(rem + 10) if rem is not None else 3600,
                )
                sealed = {bytes(o) for o in reply.get("ready", [])}
                distinct = set(distinct_ids)
                if len(sealed & distinct) < len(distinct) and deadline is not None:
                    missing = next(o for _, o in pending if o not in sealed)
                    raise GetTimeoutError(f"get() timed out on {missing.hex()[:16]}")
                slow = []
                for i, oid in pending:
                    sobj = self.store.get_serialized(oid)
                    if sobj is not None:
                        out[i] = self._materialize(sobj)
                    else:
                        slow.append((i, oid))
                if slow:
                    rem = None
                    if deadline is not None:
                        rem = max(0.0, deadline - time.monotonic())

                    async def _wait_all():
                        return await asyncio.gather(
                            *[
                                self._head_request_parked(
                                    MsgType.WAIT_OBJECT,
                                    {
                                        "object_id": oid,
                                        "timeout": rem,
                                        "node_id": self.node_id,
                                    },
                                    (rem + 5) if rem is not None else 3600,
                                )
                                for _, oid in slow
                            ]
                        )

                    replies = self.io.call(_wait_all())
                    for (i, oid), reply in zip(slow, replies):
                        state = reply.get("state")
                        if state == "timeout":
                            raise GetTimeoutError(f"get() timed out on {oid.hex()[:16]}")
                        if state == "error":
                            raise _error_from_string(reply.get("error", "task failed"))
                        sobj = self.store.get_serialized(oid)
                        if sobj is None:
                            sobj = self._refetch_evicted(oid, deadline)
                        out[i] = self._materialize(sobj)
            finally:
                self._notify_blocked(False)
        if self._unacked_submits:
            # resolved results retire their submit from the head-FT
            # resubmit ring: a completed-and-observed task must never be
            # replayed after a reattach
            with self._refs_lock:
                for ref in refs:
                    if isinstance(ref, ObjectRef):
                        self._unacked_submits.pop(ref.task_id().binary(), None)
        return out

    def _refetch_evicted(self, oid: bytes, deadline: Optional[float]) -> SerializedObject:
        """The head said sealed but the local store misses it (LRU evicted
        under us).  Report the stale location; the head re-pulls from
        another copy or reconstructs from lineage."""
        for _ in range(2):
            rem = None
            if deadline is not None:
                rem = max(0.0, deadline - time.monotonic())
            reply = self.request(
                MsgType.WAIT_OBJECT,
                {"object_id": oid, "timeout": rem, "node_id": self.node_id, "evicted": True},
                timeout=(rem + 5) if rem is not None else 3600,
            )
            state = reply.get("state")
            if state == "timeout":
                raise GetTimeoutError(f"get() timed out on {oid.hex()[:16]}")
            if state == "error":
                raise _error_from_string(reply.get("error", "object lost"))
            sobj = self.store.get_serialized(oid)
            if sobj is not None:
                return sobj
        raise ObjectLostError(oid.hex(), "sealed but repeatedly missing from local store")

    def _materialize(self, sobj: SerializedObject) -> Any:
        value = serialization.deserialize(sobj)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    def _notify_blocked(self, blocked: bool):
        if self.mode != "worker" or not self.current_task_id:
            return
        if not self._head_up.is_set():
            return  # head mid-restart: advisory accounting, skip
        try:
            self.io.spawn(
                self.conn.send(
                    MsgType.TASK_BLOCKED if blocked else MsgType.TASK_UNBLOCKED,
                    {"task_id": self.current_task_id},
                )
            )
        except Exception:  # graftlint: disable=silent-except -- blocked-notify is advisory cpu accounting; worst case the head keeps the slot held
            pass

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
        fetch_local: bool = True,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """One blocking server-side wait (h_wait_object batch form) instead
        of client polling — the head wakes us on seal."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        ready_idx = set()
        pending_ids = []
        direct_ids = []
        for i, ref in enumerate(refs):
            oid = ref.binary()
            if oid in self._memory_store or (
                self.store is not None and self.store.contains(oid)
            ):
                ready_idx.add(i)
            elif oid in self._direct_pending:
                direct_ids.append((i, oid))
            else:
                pending_ids.append((i, ref.binary()))
        if len(ready_idx) < num_returns and (direct_ids or pending_ids):
            # issue the head-side batched WAIT_OBJECT CONCURRENTLY with the
            # direct-call condition wait: either completion wakes this
            # waiter, so already-sealed head-path objects can satisfy
            # num_returns while direct calls are still in flight (sequencing
            # direct-then-head would block past ready objects — ADVICE r3)
            head_state: Dict[str, Any] = {"gen": 0}
            head_fut = None

            def _on_head(f, gen):
                # a reply from a wait we already abandoned (cancel lost the
                # race) is dropped HERE, under the cv, so it can neither
                # clear the current wait's tracking nor overwrite an
                # unconsumed current-generation reply in the one-slot dict
                if f.cancelled():
                    return
                try:
                    kind, value = "reply", f.result()
                except BaseException as e:  # graftlint: disable=silent-except -- error captured into `value` and delivered to the waiting thread below
                    kind, value = "error", e
                with self._direct_cv:
                    if gen != head_state["gen"]:
                        return  # stale generation
                    head_state[kind] = (gen, value)
                    self._direct_cv.notify_all()

            def _issue_head_wait(ids, want):
                # `want` excludes in-flight direct calls from the deficit
                # (they satisfy num_returns without the head's help, and
                # folding them in would withhold seals that could satisfy
                # the caller); with no direct calls it is the full deficit,
                # keeping the common case a single round trip.  The reply
                # carries ALL currently-sealed ids, and the cv loop
                # re-issues for the rest if still short.
                rem_ = None if deadline is None else max(0.0, deadline - time.monotonic())
                wait_payload = {
                    "object_ids": ids,
                    "num_ready": want,
                    "timeout": rem_,
                }
                fut = self.io.spawn(
                    self._head_request_parked(
                        MsgType.WAIT_OBJECT,
                        wait_payload,
                        (rem_ + 10) if rem_ is not None else 3600,
                    )
                )
                head_state["gen"] += 1
                gen = head_state["gen"]
                fut.add_done_callback(lambda f, g=gen: _on_head(f, g))
                return fut

            if pending_ids:
                head_fut = _issue_head_wait(
                    [oid for _, oid in pending_ids],
                    max(1, num_returns - len(ready_idx) - len(direct_ids)),
                )
            with self._direct_cv:
                while True:
                    # recheck ALL direct calls each wake (per-event waits in
                    # list order would let a slow early call starve
                    # detection of an already-finished later one)
                    still = []
                    pending_grew = False
                    for i, oid in direct_ids:
                        if oid not in self._direct_pending:
                            if oid in self._memory_store or (
                                self.store is not None and self.store.contains(oid)
                            ):
                                ready_idx.add(i)
                            else:
                                # result was stored, not inlined: it sealed
                                # at the head; fold into the head-path set
                                pending_ids.append((i, oid))
                                pending_grew = True
                        else:
                            still.append((i, oid))
                    direct_ids = still
                    if pending_grew and "reply" not in head_state:
                        # an in-flight head wait was issued BEFORE these
                        # sealed-at-head oids joined pending_ids, so it could
                        # block on unrelated refs even though the new oids
                        # already satisfy num_returns.  Cancel it (a late
                        # reply carries a stale generation and is ignored)
                        # and re-issue below over the updated set — the
                        # sealed oids make the fresh wait return immediately
                        # when they cover the deficit.  A stale head error is
                        # cleared too: the retry decides afresh.
                        if head_fut is not None:
                            head_fut.cancel()
                            head_fut = None
                        head_state.pop("error", None)
                    if "reply" in head_state:
                        gen, reply = head_state.pop("reply")
                        if gen == head_state["gen"]:
                            # current wait consumed; stale-generation replies
                            # must not clear head_fut (the live wait stays)
                            head_fut = None
                            sealed = {bytes(o) for o in reply.get("ready", [])}
                            for i, oid in pending_ids:
                                if oid in sealed:
                                    ready_idx.add(i)
                            pending_ids = [
                                (i, oid) for i, oid in pending_ids if i not in ready_idx
                            ]
                    if len(ready_idx) >= num_returns:
                        break
                    if "error" in head_state and not direct_ids:
                        gen, err = head_state.pop("error")
                        if gen == head_state["gen"]:
                            # only fatal when still short AND no direct call
                            # can still help: completions that satisfy
                            # num_returns must win over a failed head rpc
                            raise err
                    rem = None if deadline is None else deadline - time.monotonic()
                    if rem is not None and rem <= 0:
                        break
                    if head_fut is None and pending_ids and "error" not in head_state:
                        # previous head wait consumed (or direct completions
                        # moved stored results into pending): watch the rest
                        head_fut = _issue_head_wait(
                            [oid for _, oid in pending_ids],
                            max(1, num_returns - len(ready_idx) - len(direct_ids)),
                        )
                    if not direct_ids and head_fut is None:
                        break
                    self._direct_cv.wait(rem)
            if head_fut is not None:
                # satisfied by direct completions before the head replied:
                # abandon the server-side wait (its late reply is ignored)
                head_fut.cancel()
            # direct results that were stored (not inlined) sealed at the
            # head but may not have been covered by the concurrent batch
            # (issued before they moved to pending_ids): probe them locally,
            # then with a zero-timeout head probe (they are already sealed,
            # so this never blocks)
            late = []
            for i, oid in pending_ids:
                if i in ready_idx:
                    continue
                if oid in self._memory_store or (
                    self.store is not None and self.store.contains(oid)
                ):
                    ready_idx.add(i)
                else:
                    late.append((i, oid))
            if late and len(ready_idx) < num_returns:
                reply = self.request(
                    MsgType.WAIT_OBJECT,
                    {
                        "object_ids": [oid for _, oid in late],
                        "num_ready": len(late),
                        "timeout": 0,
                    },
                    timeout=30,
                )
                sealed = {bytes(o) for o in reply.get("ready", [])}
                for i, oid in late:
                    if oid in sealed:
                        ready_idx.add(i)
        ready, not_ready = [], []
        for i, ref in enumerate(refs):
            (ready if i in ready_idx and len(ready) < num_returns else not_ready).append(ref)
        return ready, not_ready

    def flush_ref_adds(self):
        """Synchronously declare any batched local-ref adds at the head.

        Call before an operation after which a PEER could legitimately drop
        the last head-side pin on one of those refs — a direct-call reply
        (the caller releases its arg keepalives on receipt), an explicit
        free() (releases containment pins on nested refs we may have just
        deserialized).  The 200ms batched flush must not lose that race:
        a late ADD_REF would resurrect a count on an already-freed object."""
        if not self._head_up.is_set():
            # head mid-restart: its refcount table died with it anyway —
            # blocking a (possibly lease-path, head-free) completion on
            # reconnect would stall flows that don't need the head
            return
        with self._refs_lock:
            adds, self._pending_adds = self._pending_adds, []
        if adds:
            try:
                # stable batch id: the parked path re-sends this same
                # payload after a reattach, and the head dedupes a first
                # attempt that raced the crash after being applied
                self.request(
                    MsgType.ADD_REF, {"object_ids": adds, "batch": os.urandom(8)}
                )
            except Exception:  # graftlint: disable=silent-except -- head connection lost; refs die with the head anyway
                pass

    def free(self, refs: Sequence[ObjectRef]):
        for r in refs:
            self._memory_store.pop(r.binary(), None)
        self.flush_ref_adds()
        self.request(MsgType.FREE_OBJECT, {"object_ids": [r.binary() for r in refs]})

    # ----------------------------------------------------------------- tasks

    def submit_task(
        self,
        function_id: bytes,
        function_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int,
        resources: Dict[str, float],
        max_retries: int,
        pg_id: Optional[bytes],
        pg_bundle_index: int,
        node_affinity: Optional[bytes] = None,
        runtime_env: Optional[dict] = None,
        priority: Optional[int] = None,
        max_preemptions: Optional[int] = None,
    ) -> List[ObjectRef]:
        if runtime_env:
            from ray_tpu_torch._private.runtime_env import process_runtime_env

            runtime_env = process_runtime_env(self, runtime_env)
        task_id = TaskID.for_normal_task(self.job_id)
        encoded_args, nested_refs = self._encode_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            task_type=NORMAL_TASK,
            function_id=function_id,
            function_name=function_name,
            args=encoded_args,
            nested_refs=nested_refs,
            num_returns=num_returns,
            resources=resources,
            max_retries=max_retries,
            retries_left=max_retries,
            pg_id=pg_id,
            pg_bundle_index=pg_bundle_index,
            node_affinity=node_affinity,
            caller_id=self.worker_id.binary(),
            trace_ctx=_new_span(),
            phases=_new_phases(),
            runtime_env=runtime_env or {},
            priority=int(
                priority if priority is not None else self.default_priority
            ),
            max_preemptions=(
                int(max_preemptions) if max_preemptions is not None else -1
            ),
        )
        # lease fast path first: an S-shaped lease in hand means this spec
        # pushes straight to the leased worker — no head round-trip at all
        if self._try_lease_submit(spec):
            return [ObjectRef(oid, self) for oid in spec.return_object_ids()]
        # fire-and-forget on the ordered conn: queueing cannot fail in a
        # way the caller could act on (failures seal into the return
        # objects), and a sync round trip per submit would serialize
        # batched submissions (reference analog: async SubmitTask)
        self._enqueue_submit(spec)
        return [ObjectRef(oid, self) for oid in spec.return_object_ids()]

    def create_actor(
        self,
        actor_id: bytes,
        function_id: bytes,
        class_name: str,
        args: tuple,
        kwargs: dict,
        resources: Dict[str, float],
        max_restarts: int,
        max_concurrency: int,
        name: str,
        namespace: str,
        detached: bool,
        pg_id: Optional[bytes],
        pg_bundle_index: int,
        runtime_env: Optional[dict] = None,
        implicit_cpu: bool = False,
        node_affinity: Optional[bytes] = None,
        priority: Optional[int] = None,
        preemptible: bool = False,
    ) -> ObjectRef:
        from ray_tpu_torch._private.ids import ActorID

        if runtime_env:
            from ray_tpu_torch._private.runtime_env import process_runtime_env

            runtime_env = process_runtime_env(self, runtime_env)

        task_id = TaskID.for_actor_creation(ActorID(actor_id))
        encoded_args, nested_refs = self._encode_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            task_type=ACTOR_CREATION_TASK,
            implicit_cpu=implicit_cpu,
            function_id=function_id,
            function_name=class_name,
            actor_id=actor_id,
            args=encoded_args,
            nested_refs=nested_refs,
            num_returns=1,
            resources=resources,
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            name=name or "",
            namespace=namespace or "",
            detached=detached,
            pg_id=pg_id,
            pg_bundle_index=pg_bundle_index,
            node_affinity=node_affinity,
            caller_id=self.worker_id.binary(),
            trace_ctx=_new_span(),
            phases=_new_phases(),
            runtime_env=runtime_env or {},
            priority=int(
                priority if priority is not None else self.default_priority
            ),
            preemptible=bool(preemptible),
        )
        self.request(MsgType.CREATE_ACTOR, {"spec": spec.to_wire()})
        # reclaimed on reattach so a restarted head re-learns ownership
        # (owner-death cleanup keys off the owner's conn)
        self._owned_actors.add(bytes(actor_id))
        return ObjectRef(spec.return_object_ids()[0], self)

    def submit_actor_task(
        self,
        actor_id: bytes,
        function_id: bytes,
        method_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int,
    ) -> List[ObjectRef]:
        from ray_tpu_torch._private.ids import ActorID

        seq = self._actor_seq.get(actor_id, 0)
        self._actor_seq[actor_id] = seq + 1
        task_id = TaskID.for_actor_task(ActorID(actor_id))
        encoded_args, nested_refs = self._encode_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            task_type=ACTOR_TASK,
            function_id=function_id,
            method_name=method_name,
            actor_id=actor_id,
            args=encoded_args,
            nested_refs=nested_refs,
            num_returns=num_returns,
            seq_no=seq,
            caller_id=self.worker_id.binary(),
            trace_ctx=_new_span(),
            phases=_new_phases(),
            # actor calls execute on the actor's own worker, but carrying
            # the submitter's band lets the executing method's NESTED
            # submissions inherit the job priority (worker_main seeds
            # default_priority from the running spec)
            priority=int(self.default_priority),
        )
        conn = self._direct_conn(actor_id)
        if conn is not None:
            for oid in spec.return_object_ids():
                self._direct_pending[oid] = threading.Event()
            # the head never sees this task, so no head-side arg pin exists:
            # hold local handles on every referenced arg until the reply so
            # our own batched REMOVE_REF can't zero them mid-call
            arg_ids = [bytes(a[2]) for a in spec.args if a[0] == ARG_REF]
            arg_ids += [bytes(i) for i in nested_refs]
            self._direct_keepalive[spec.task_id] = [
                ObjectRef(oid, self) for oid in arg_ids
            ]
            self.io.spawn(self._direct_call(conn, spec, actor_id))
            return [ObjectRef(oid, self) for oid in spec.return_object_ids()]
        # fire-and-forget on the ordered conn: queueing cannot fail in a
        # way the caller could act on (failures seal into the return
        # objects), and a sync round trip per submit would serialize
        # batched submissions (reference analog: async SubmitTask)
        self._enqueue_submit(spec)
        return [ObjectRef(oid, self) for oid in spec.return_object_ids()]

    def _enqueue_submit(self, spec: TaskSpec):
        """Coalesce a .remote() burst into few SUBMIT_TASKS frames: the
        flush coroutine drains whatever accumulated by the time the io
        loop runs it, so a tight submission loop pays ~one frame per loop
        wakeup instead of one per task (order preserved)."""
        wire = spec.to_wire()
        with self._refs_lock:
            self._submit_buffer.append(wire)
            # head-FT resubmit ring: held until a get() observes the
            # result (or FIFO eviction); replayed with resubmit=True
            # after a reattach, deduped head-side by task id
            self._unacked_submits[bytes(spec.task_id)] = wire
            while len(self._unacked_submits) > 4096:
                self._unacked_submits.popitem(last=False)
            if self._submit_flush_scheduled:
                return
            self._submit_flush_scheduled = True
        self.io.spawn(self._flush_submits())

    async def _flush_submits(self):
        with self._refs_lock:
            batch, self._submit_buffer = self._submit_buffer, []
            self._submit_flush_scheduled = False
        if not batch:
            return
        try:
            if len(batch) == 1:
                await self.conn.send(MsgType.SUBMIT_TASK, {"spec": batch[0]})
            else:
                await self.conn.send(MsgType.SUBMIT_TASKS, {"specs": batch})
        except (ConnectionError, OSError):
            if RayConfig.head_reconnect_window_s <= 0 or self._conn_lost:
                raise
            # head mid-restart: the batch survives in _unacked_submits and
            # rides the post-reattach resubmit replay

    # ------------------------------------- worker-lease cache (fast path)

    def _try_lease_submit(self, spec: TaskSpec) -> bool:
        """Route a plain normal task through the lease pool for its
        resource shape.  Returns False (head path) for shapes we can't or
        shouldn't lease: placement-group tasks (bundle accounting lives at
        the head) and client mode (no store to read results from)."""
        if not RayConfig.lease_cache_enabled or self.is_client:
            return False
        if spec.task_type != NORMAL_TASK or spec.pg_id:
            return False
        # the band is part of the shape: a high-band task must NEVER queue
        # behind lower-band work on a lower-band lease — it takes its own
        # lease (or the head path, where it can preempt)
        key = (
            tuple(sorted((spec.resources or {"CPU": 1.0}).items())),
            bytes(spec.node_affinity) if spec.node_affinity else None,
            int(spec.priority),
        )
        # return oids go direct-pending NOW, before the task is visible
        # anywhere: a get() racing the pool's assign must wait on the
        # event (set on completion, conn loss, OR head-path flush), never
        # park in a head-side wait for a result that will arrive inline
        oids = spec.return_object_ids()
        for oid in oids:
            self._direct_pending[oid] = threading.Event()
        arg_ids = [bytes(a[2]) for a in spec.args if a[0] == ARG_REF]
        arg_ids += [bytes(i) for i in (spec.nested_refs or ())]
        if arg_ids:
            self._direct_keepalive[spec.task_id] = [
                ObjectRef(oid, self) for oid in arg_ids
            ]
        with self._lease_lock:
            pool = self._leases.get(key)
            if pool is None:
                pool = self._leases[key] = _LeasePool(key)
            pool.queue.append((spec, oids))
        self._start_lease_gc()
        self._pump_lease_pool(pool)
        # the spec is now owned by the pool: it leaves via a lease push,
        # a head-path flush, or a typed error — never silently
        return True

    def _pump_lease_pool(self, pool: _LeasePool):
        """The client-side dispatcher over one lease pool.  Called on
        every enqueue, completion, grant, denial, revoke, and conn loss;
        assigns breadth-first, grows on demand, deepens within the
        latency budget, and overflows to the head when saturated."""
        flush: List[TaskSpec] = []
        touched: List[_Lease] = []
        grow = False
        with self._lease_lock:
            live = [l for l in pool.leases if not l.revoked and not l.conn.closed]
            pool.leases = live
            cap = max(
                1,
                min(
                    512,
                    int(
                        RayConfig.lease_queue_latency_budget_s
                        / max(pool.ewma, 1e-4)
                    ),
                ),
            )
            while pool.queue:
                lease = min(live, key=lambda l: len(l.inflight)) if live else None
                out = len(lease.inflight) if lease is not None else 0
                if lease is not None and out == 0:
                    # breadth first: an idle lease always takes the task
                    self._assign_to_lease(lease, *pool.queue.popleft())
                    touched.append(lease)
                    continue
                can_grow = (
                    len(live) + pool.growing < RayConfig.lease_max_per_shape
                    and time.monotonic() - pool.denied_at
                    >= RayConfig.lease_request_retry_s
                )
                if can_grow:
                    # hold the rest until the grant (or denial) re-pumps:
                    # deepening now would serialize work that could run in
                    # parallel on the incoming lease
                    pool.growing += 1
                    grow = True
                    break
                if pool.growing:
                    break  # a grant/denial in flight will re-pump
                if lease is not None and out < cap:
                    # can't grow: pipeline within the latency budget
                    self._assign_to_lease(lease, *pool.queue.popleft())
                    touched.append(lease)
                    continue
                if live:
                    # saturated at the depth budget: the pool already holds
                    # all the capacity a grant would give us — hold; every
                    # completion (and the gc tick) re-pumps with a fresher
                    # duration estimate
                    break
                # lease-less and can't grow: the head owns capacity — let
                # it spread/spawn/preempt as it sees fit
                flush = list(pool.queue)
                pool.queue.clear()
                break
        for lease in touched:
            with self._lease_lock:
                if lease.flush_scheduled:
                    continue
                lease.flush_scheduled = True
            self.io.spawn(self._flush_lease_pushes(lease))
        if grow:
            threading.Thread(
                target=self._grow_pool, args=(pool,), daemon=True
            ).start()
        for spec, oids in flush:
            # hand the task to the head (which pins args at submit), then
            # release the direct registration: waiters wake, find nothing
            # local, and fall through to the head-side wait
            self._direct_keepalive.pop(spec.task_id, None)
            self._enqueue_submit(spec)
            for oid in oids:
                ev = self._direct_pending.pop(bytes(oid), None)
                if ev is not None:
                    ev.set()
                self._fire_done_callbacks(bytes(oid))
        if flush:
            with self._direct_cv:
                self._direct_cv.notify_all()

    def _grow_pool(self, pool: _LeasePool):
        """Worker thread: one lease request for the pool (sync RPCs —
        never on the io loop), then re-pump whatever the outcome."""
        try:
            self._request_lease(pool)
        finally:
            with self._lease_lock:
                pool.growing = max(0, pool.growing - 1)
            self._pump_lease_pool(pool)

    def _request_lease(self, pool: _LeasePool) -> Optional[_Lease]:
        shape, affinity, band = pool.key
        if not self._head_up.is_set():
            # head mid-restart: deny fast so the pump deepens the leases
            # it already holds (the head-free flow the outage must not
            # stall) instead of parking pool growth on the redial
            pool.denied_at = time.monotonic()
            return None
        try:
            payload = {
                "resources": dict(shape),
                "priority": int(band),
            }
            reply = None
            granted_by = "cached_lease"
            grantor: Any = "head"
            if affinity:
                payload["node_id"] = affinity
                agent = self._agent_conn_for(affinity)
                if agent is not None:
                    try:
                        reply = self.io.call(
                            agent.request(MsgType.LEASE_REQUEST, payload, 5), 10
                        )
                        if reply.get("granted"):
                            granted_by = "raylet"
                            grantor = affinity
                    except Exception:  # graftlint: disable=silent-except -- local agent unreachable; the head grant below still works
                        reply = None
            if reply is None or not reply.get("granted"):
                reply = self.request(MsgType.LEASE_REQUEST, payload, timeout=10)
                granted_by = "cached_lease"
                grantor = "head"
            if not reply.get("granted"):
                pool.denied_at = time.monotonic()
                return None
            host, port_s = str(reply["addr"]).rsplit(":", 1)
            conn = self.io.call(
                Connection.connect(
                    host, int(port_s), RayConfig.connect_timeout_s, retry=False
                )
            )
            lease = _Lease(
                bytes(reply["lease_id"]),
                bytes(reply["worker_id"]),
                str(reply["addr"]),
                conn,
                shape,
                bytes(reply.get("node_id") or b""),
                granted_by,
                grantor,
                pool,
            )
            with self._lease_lock:
                pool.leases.append(lease)
                self._lease_by_id[lease.lease_id] = lease
                pool.denied_at = 0.0
            self.io.spawn(self._lease_read_loop(lease))
            return lease
        except Exception:  # graftlint: disable=silent-except -- lease path is an optimization; submits fall back to the head
            pool.denied_at = time.monotonic()
            return None

    def _agent_conn_for(self, node_id: bytes) -> Optional[Connection]:
        """Conn to node_id's raylet lease agent, discovered via the node
        table (label ``dispatch_addr``); False-cached when absent."""
        if not RayConfig.raylet_local_dispatch:
            return None
        cached = self._node_agent_conn.get(node_id)
        if cached is False:
            return None
        if cached is not None and not cached.closed:
            return cached
        addr = ""
        try:
            for n in self.list_nodes():
                if bytes(n["node_id"]) == bytes(node_id):
                    addr = (n.get("labels") or {}).get("dispatch_addr", "")
                    break
        except Exception:  # graftlint: disable=silent-except -- discovery failure falls back to head grants
            return None
        if not addr:
            self._node_agent_conn[node_id] = False
            return None
        try:
            host, port_s = addr.rsplit(":", 1)
            conn = self.io.call(
                Connection.connect(host, int(port_s), 5, retry=False)
            )
        except Exception:  # graftlint: disable=silent-except -- unreachable agent negative-caches; head grants still work
            self._node_agent_conn[node_id] = False
            return None

        async def _read():
            try:
                while True:
                    mt, rid, pl = await conn.read_frame()
                    if conn.dispatch_reply(mt, rid, pl):
                        continue
                    if mt == MsgType.LEASE_REVOKE:
                        self._on_lease_revoke(pl)
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                conn.close()

        self.io.spawn(_read())
        self._node_agent_conn[node_id] = conn
        return conn

    def _assign_to_lease(self, lease: _Lease, spec: TaskSpec, oids):
        """Bind one queued task to a lease (caller holds _lease_lock):
        stage the wire for the next batched LEASE_PUSH flush.  The
        direct-pending events and arg keepalives were registered at
        enqueue (the head never sees this task — the caller's local
        handles pin its ref args, the direct-call contract)."""
        spec.granted_by = lease.granted_by
        now = time.time()
        if spec.phases is not None:
            # the lease IS the grant: enqueue and dispatch collapse into
            # the push instant (queue_wait ~0 — the point of the cache)
            spec.phases["head_enqueue"] = now
            spec.phases["dispatch"] = now
        wire = spec.to_wire()
        lease.inflight[spec.task_id] = {"wire": wire, "oids": oids, "t": now}
        lease.push_buffer.append(wire)
        lease.last_used = now

    async def _flush_lease_pushes(self, lease: _Lease):
        """Coalesced LEASE_PUSH: drains whatever accumulated by the time
        the io loop runs this (same discipline as _flush_submits)."""
        with self._lease_lock:
            batch, lease.push_buffer = lease.push_buffer, []
            lease.flush_scheduled = False
        if not batch:
            return
        try:
            await lease.conn.send(MsgType.LEASE_PUSH, {"specs": batch})
        except Exception:  # graftlint: disable=silent-except -- conn loss recovery (resubmit / typed errors) lives in the read loop's finally
            lease.conn.close()

    async def _lease_read_loop(self, lease: _Lease):
        try:
            while True:
                msg_type, rid, payload = await lease.conn.read_frame()
                if lease.conn.dispatch_reply(msg_type, rid, payload):
                    continue
                if msg_type == MsgType.LEASE_DONE:
                    self._on_lease_done(lease, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            lease.conn.close()
            self._on_lease_conn_lost(lease)

    def _on_lease_done(self, lease: _Lease, payload: dict):
        drained = False
        now = time.time()
        for result in payload.get("results", []):
            tid = bytes(result.get("task_id") or b"")
            with self._lease_lock:
                entry = lease.inflight.pop(tid, None)
                drained = lease.revoked and not lease.inflight
                if entry is not None:
                    # mean task duration feeds the pool's depth budget;
                    # queue wait inflates the sample, which only pushes
                    # toward MORE breadth — the safe direction
                    sample = max(1e-5, now - entry.get("t", now))
                    lease.pool.ewma = 0.8 * lease.pool.ewma + 0.2 * sample
            if entry is None:
                continue
            for oid, wire in (result.get("inline") or {}).items():
                self._memory_store[bytes(oid)] = SerializedObject.from_wire(wire)
            self._direct_keepalive.pop(tid, None)
            for oid in entry["oids"]:
                ev = self._direct_pending.pop(bytes(oid), None)
                if ev is not None:
                    ev.set()
                self._fire_done_callbacks(bytes(oid))
        with self._direct_cv:
            self._direct_cv.notify_all()
        if drained:
            # revoked lease fully drained: hand it back now — every pushed
            # task ran exactly once, nothing to resubmit
            self._finalize_lease_return(lease)
        else:
            self._pump_lease_pool(lease.pool)

    def _on_lease_revoke(self, payload: dict):
        """LEASE_REVOKE push (head or raylet agent): stop using the lease;
        return it once the in-flight tail drains (or immediately when
        idle).  Tasks already pushed keep running on the still-alive
        worker — revocation must not double-execute them."""
        lease = self._lease_by_id.get(bytes(payload.get("lease_id") or b""))
        if lease is None:
            return
        with self._lease_lock:
            lease.revoked = True
            idle = not lease.inflight and not lease.push_buffer
            if lease in lease.pool.leases:
                lease.pool.leases.remove(lease)
        if idle:
            self._finalize_lease_return(lease)
        self._pump_lease_pool(lease.pool)

    def _on_lease_conn_lost(self, lease: _Lease):
        """The leased worker (or its socket) died.  Revoked leases were
        preempted: unreplied pushes resubmit on the PREEMPTION budget and
        seal a typed PreemptedError once it's spent.  Otherwise it's a
        fault: resubmit on the retry budget, WorkerCrashedError when
        exhausted."""
        with self._lease_lock:
            if lease in lease.pool.leases:
                lease.pool.leases.remove(lease)
            self._lease_by_id.pop(lease.lease_id, None)
            pending = list(lease.inflight.items())
            lease.inflight.clear()
        for tid, entry in pending:
            wire = entry["wire"]
            self._direct_keepalive.pop(tid, None)
            if lease.revoked:
                pc = int(wire.get("preempt_count", 0)) + 1
                budget = (
                    int(wire.get("max_preemptions", -1))
                    if int(wire.get("max_preemptions", -1)) >= 0
                    else RayConfig.task_preemption_budget
                )
                if pc > budget:
                    self._seal_local_error(
                        entry["oids"],
                        wire,
                        PreemptedError(
                            "preempted by higher-priority work (lease revoked)",
                            pc,
                            budget,
                        ),
                    )
                    continue
                wire["preempt_count"] = pc
            else:
                rl = int(wire.get("retries_left", 0))
                if rl <= 0:
                    self._seal_local_error(
                        entry["oids"],
                        wire,
                        WorkerCrashedError(
                            "leased worker died while running "
                            f"{wire.get('function_name') or 'task'}"
                        ),
                    )
                    continue
                wire["retries_left"] = rl - 1
            # resubmit through the head: it owns placement from here.
            # Ring first — if the head is mid-restart the send fails and
            # the post-reattach resubmit replay is what delivers it.
            with self._refs_lock:
                self._unacked_submits[bytes(tid)] = wire
            self.io.spawn(self._send_submit_best_effort(wire))
        # wake waiters AFTER the resubmits are queued on the ordered conn:
        # their follow-up WAIT_OBJECT can then never race ahead of the
        # resubmit frame
        for tid, entry in pending:
            for oid in entry["oids"]:
                ev = self._direct_pending.pop(bytes(oid), None)
                if ev is not None:
                    ev.set()
                self._fire_done_callbacks(bytes(oid))
        with self._direct_cv:
            self._direct_cv.notify_all()
        if lease.revoked and not lease.returned:
            # killed mid-revoke (deadline escalation): the grantor's
            # worker-death path reclaimed the resources; nothing to return
            lease.returned = True
        # tasks still waiting in the pool queue re-route (fresh lease or
        # head path)
        self._pump_lease_pool(lease.pool)

    async def _send_submit_best_effort(self, wire: dict):
        try:
            await self.conn.send(MsgType.SUBMIT_TASK, {"spec": wire})
        except (ConnectionError, OSError):
            # head down: the wire is in _unacked_submits; reattach replays
            pass

    def _seal_local_error(self, oids, wire, cause: Exception):
        err = serialization.serialize(
            RayTaskError(
                str(wire.get("function_name") or "task"),
                str(cause),
                cause=cause,
            )
        )
        for oid in oids:
            self._memory_store[bytes(oid)] = err

    def _finalize_lease_return(self, lease: _Lease):
        with self._lease_lock:
            if lease.returned:
                return
            if not lease.revoked and (lease.inflight or lease.push_buffer):
                # the idle-GC scan and this finalize are not atomic: a
                # submit can assign work in between.  A live lease with
                # work keeps running — returning it here would close the
                # push conn under a pushed task (double execution via the
                # conn-loss resubmit, or a spurious WorkerCrashedError)
                return
            lease.returned = True
            self._lease_by_id.pop(lease.lease_id, None)
            if lease in lease.pool.leases:
                lease.pool.leases.remove(lease)
        payload = {"lease_id": lease.lease_id}
        try:
            if lease.grantor == "head":
                self.io.spawn(self.conn.send(MsgType.LEASE_RETURN, payload))
            else:
                agent = self._node_agent_conn.get(lease.grantor)
                if agent and not agent.closed:
                    self.io.spawn(agent.send(MsgType.LEASE_RETURN, payload))
                else:
                    self.io.spawn(self.conn.send(MsgType.LEASE_RETURN, payload))
        except Exception:  # graftlint: disable=silent-except -- grantor conn gone; its disconnect path reclaims the lease
            pass
        self.io.loop.call_soon_threadsafe(lease.conn.close)

    def _start_lease_gc(self):
        with self._lease_lock:
            if self._lease_gc_started:
                return
            self._lease_gc_started = True

        async def _gc():
            while True:
                await asyncio.sleep(
                    max(0.25, RayConfig.lease_idle_timeout_s / 4)
                )
                now = time.time()
                idle: List[_Lease] = []
                stalled: List[_LeasePool] = []
                with self._lease_lock:
                    for pool in self._leases.values():
                        if pool.queue:
                            stalled.append(pool)  # re-pump below, not idle
                            continue
                        for lease in pool.leases:
                            if (
                                not lease.inflight
                                and not lease.push_buffer
                                and now - lease.last_used
                                > RayConfig.lease_idle_timeout_s
                            ):
                                idle.append(lease)
                for pool in stalled:
                    # a held queue re-evaluates periodically: the grow
                    # deny-window may have lapsed, or capacity returned
                    self._pump_lease_pool(pool)
                for lease in idle:
                    self._finalize_lease_return(lease)

        self.io.spawn(_gc())

    # -------------------------------------------------- direct actor calls

    def _direct_conn(self, actor_id: bytes) -> Optional[Connection]:
        """Open (or reuse) a connection straight to the actor's worker —
        the head stays out of the per-call loop (reference analog:
        direct_actor_task_submitter.cc).  Returns None when the actor
        isn't ALIVE yet or direct calls are disabled: those calls take
        the head path, which queues through the actor FSM."""
        if not RayConfig.enable_direct_actor_calls:
            return None
        conn = self._direct_conns.get(actor_id)
        if conn is not None and not conn.closed:
            return conn
        self._direct_conns.pop(actor_id, None)
        last = self._direct_probe_at.get(actor_id)
        if last is not None and time.monotonic() - last < 5.0:
            return None  # known not-ALIVE: skip the probe, head path
        try:
            reply = self.request(MsgType.ACTOR_STATE, {"actor_id": actor_id})
        except Exception:  # graftlint: disable=silent-except -- probe failure falls back to the head routing path
            return None
        addr = reply.get("direct_addr") or ""
        if reply.get("state") != "ALIVE" or not addr:
            # negative-cache until the head's actor pubsub reports ALIVE
            self._direct_probe_at[actor_id] = time.monotonic()
            self._subscribe_actor_events()
            return None
        self._direct_probe_at.pop(actor_id, None)
        host, port_s = addr.rsplit(":", 1)
        try:
            # single attempt (retry=False): an unreachable direct port must
            # negative-cache fast, not burn the whole dial window per call
            conn = self.io.call(
                Connection.connect(
                    host, int(port_s), RayConfig.connect_timeout_s, retry=False
                )
            )
        except Exception:  # graftlint: disable=silent-except -- negative-cached below; calls route via the head meanwhile
            # unreachable direct port (e.g. filtered cross-node): negative-
            # cache so every call doesn't pay a connect timeout
            self._direct_probe_at[actor_id] = time.monotonic()
            return None
        self._direct_conns[actor_id] = conn
        self.io.spawn(self._direct_read_loop(conn))
        return conn

    def _subscribe_actor_events(self):
        """Clear the not-ALIVE cache the moment the head reports an actor
        ALIVE, so the very next call probes and goes direct."""
        if self._actor_events_subscribed:
            return
        self._actor_events_subscribed = True

        def _on_actor_event(msg: dict):
            if msg.get("state") == "ALIVE":
                self._direct_probe_at.pop(bytes(msg.get("actor_id", b"")), None)

        try:
            self.subscribe("actor", _on_actor_event)
        except Exception:  # graftlint: disable=silent-except -- flag reset below retries the subscription on the next direct-call probe
            self._actor_events_subscribed = False

    async def _direct_read_loop(self, conn: Connection):
        try:
            while True:
                msg_type, rid, payload = await conn.read_frame()
                conn.dispatch_reply(msg_type, rid, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            conn.close()

    async def _direct_call(self, conn: Connection, spec: TaskSpec, actor_id: bytes):
        try:
            # graftsan: disable=GS005 -- actor method runtime is unbounded by design; the bounded failure mode is conn loss (read loop dies -> pending replies fail), not a timer
            reply = await conn.request(
                MsgType.ACTOR_CALL, {"spec": spec.to_wire()}, timeout=None
            )
        except Exception:  # graftlint: disable=silent-except -- converted to a stored RayTaskError below; the caller raises it on get()
            # conn died mid-call (actor crash/restart/migration): in-flight
            # actor calls fail — NEVER resubmit, the method may have side
            # effects and already run (reference semantics: actor death
            # fails in-flight calls with RayActorError; retrying a crash()
            # would kill the restarted actor again).  Subsequent calls
            # re-resolve through the head, which owns the FSM.
            self._direct_conns.pop(actor_id, None)
            from ray_tpu_torch.exceptions import RayTaskError

            err = serialization.serialize(
                RayTaskError(
                    spec.method_name,
                    f"worker died while running {spec.method_name}: "
                    "direct connection lost",
                    cause=WorkerCrashedError(
                        f"worker died while running {spec.method_name}"
                    ),
                )
            )
            for oid in spec.return_object_ids():
                self._memory_store[oid] = err
            self._wake_direct(spec)
            return
        inline = reply.get("inline") or {}
        for oid, wire in inline.items():
            self._memory_store[bytes(oid)] = SerializedObject.from_wire(wire)
        self._wake_direct(spec)

    def _wake_direct(self, spec: TaskSpec):
        # (absent memory-store entries mean a stored result: get() falls
        # through to the normal store/head resolution)
        self._direct_keepalive.pop(spec.task_id, None)
        for oid in spec.return_object_ids():
            ev = self._direct_pending.pop(oid, None)
            if ev is not None:
                ev.set()
            self._fire_done_callbacks(oid)
        with self._direct_cv:
            self._direct_cv.notify_all()

    def _fire_done_callbacks(self, oid: bytes):
        with self._cb_lock:
            cbs = self._done_callbacks.pop(oid, [])
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("object-done callback raised")

    def on_object_done(self, ref: ObjectRef, cb: Callable[[], None]):
        """Invoke cb() once (from the io thread, or inline if already
        resolved) when the ref's object resolves — success OR error.  cb
        must be cheap and thread-safe; no thread is spawned per watch."""
        oid = ref.binary()
        watch = False
        with self._cb_lock:
            if oid in self._memory_store or (
                self.store is not None and self.store.contains(oid)
            ):
                resolved = True
            elif oid in self._direct_pending:
                # _wake_direct pops pending, then takes _cb_lock to fire —
                # our append is ordered before that fire
                self._done_callbacks.setdefault(oid, []).append(cb)
                resolved = False
            else:
                # no longer pending: either never a direct call (head path)
                # or the reply landed between our checks — re-check the
                # memory store before committing to a head-side watch
                if oid in self._memory_store:
                    resolved = True
                else:
                    self._done_callbacks.setdefault(oid, []).append(cb)
                    resolved = False
                    watch = True
        if resolved:
            cb()
        elif watch:
            self.io.spawn(self._watch_object(oid))

    async def _watch_object(self, oid: bytes):
        try:
            payload = {"object_id": oid, "timeout": None}
            await self._head_request_parked(MsgType.WAIT_OBJECT, payload, 3600)
        except Exception:  # graftlint: disable=silent-except -- watch is best-effort; callbacks fire regardless so waiters re-check the store
            pass
        self._fire_done_callbacks(oid)

    def _resolve_direct(self, oid: bytes, deadline: Optional[float]) -> bool:
        """Block until an in-flight direct call for oid completes.  True if
        the caller should re-check local sources (always, on completion)."""
        ev = self._direct_pending.get(oid)
        if ev is None:
            return True
        rem = None if deadline is None else max(0.0, deadline - time.monotonic())
        if not ev.wait(rem):
            raise GetTimeoutError(f"get() timed out on direct call {oid.hex()[:16]}")
        return True

    def _encode_args(self, args: tuple, kwargs: dict) -> Tuple[List[list], List[bytes]]:
        """Inline small values; put large ones in the store and pass refs
        (reference: direct-call arg inlining, max_direct_call_object_size).

        Also returns the ids of refs nested inside inlined ARG_VALUE
        payloads: the submit message carries them so the head pins them for
        the task's lifetime, exactly like top-level ARG_REF args."""
        encoded: List[list] = []
        nested: List[bytes] = []
        limit = RayConfig.max_direct_call_object_size
        items = [(False, a) for a in args] + [(k, v) for k, v in kwargs.items()]
        for key, value in items:
            if isinstance(value, ObjectRef):
                self._promote_memory_objects([value.binary()])
                encoded.append([ARG_REF, key if key else None, value.binary()])
                continue
            sobj = serialization.serialize(value)
            if sobj.total_bytes() <= limit:
                self._promote_memory_objects(sobj.contained)
                encoded.append([ARG_VALUE, key if key else None, sobj.to_wire()])
                nested.extend(sobj.contained)
            else:
                # large value → stored object, reusing the bytes already in
                # hand; its contained refs are pinned by put_object for the
                # stored container's lifetime
                oid = self._next_put_oid()
                self.put_object(oid, sobj)
                ref = ObjectRef(oid, self)
                encoded.append([ARG_REF, key if key else None, ref.binary()])
        return encoded, list(dict.fromkeys(nested))

    def decode_args(self, encoded: List[list]) -> Tuple[tuple, dict]:
        args: List[Any] = []
        kwargs: Dict[str, Any] = {}
        for kind, key, payload in encoded:
            if kind == ARG_VALUE:
                value = serialization.deserialize(SerializedObject.from_wire(payload))
            else:
                value = self.get([ObjectRef(bytes(payload), None)])[0]
            if key:
                kwargs[key] = value
            else:
                args.append(value)
        return tuple(args), kwargs

    # -------------------------------------------- compiled-DAG channel conns

    def open_dag_conn(self, addr: str, on_push, on_close):
        """Dial a compiled-DAG carrier connection to a participant actor's
        direct-call server and service it on the io loop: DAG_PUSH frames
        route to ``on_push`` (io-thread context, must not block), replies
        pair with in-flight ``dag_rpc`` requests, and transport loss fires
        ``on_close`` exactly once.  These conns are owned by the compiled
        graph (ray_tpu_torch/dag/compiled.py), not the shared direct-call cache:
        a severed channel must invalidate its graph, never a neighbour's
        eager calls."""
        host, port_s = addr.rsplit(":", 1)
        conn = self.io.call(
            Connection.connect(
                host, int(port_s), RayConfig.connect_timeout_s, retry=False
            )
        )
        self.io.spawn(self._dag_read_loop(conn, on_push, on_close))
        return conn

    async def _dag_read_loop(self, conn: Connection, on_push, on_close):
        try:
            while True:
                msg_type, rid, payload = await conn.read_frame()
                if conn.dispatch_reply(msg_type, rid, payload):
                    continue
                if msg_type == MsgType.DAG_PUSH:
                    on_push(payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            conn.close()
            try:
                on_close()
            except Exception:  # noqa: BLE001
                logger.exception("dag conn close callback raised")

    def dag_rpc(self, conn: Connection, msg_type, payload: dict, timeout: float):
        """Channel-negotiation RPC (DAG_SETUP / DAG_TEARDOWN) on a carrier
        conn opened by open_dag_conn.  The outer wait is bounded too: a
        stopped-but-not-closed io loop (driver shutdown racing a dag
        teardown) would otherwise park the coroutine forever and hang
        ``fut.result()``."""
        try:
            return self.io.call(conn.request(msg_type, payload, timeout), timeout + 5)
        except (concurrent.futures.TimeoutError, asyncio.TimeoutError) as e:
            # both are distinct from builtin TimeoutError until 3.11 (the
            # outer fut.result raises the former, the request's inner
            # wait_for the latter): normalize so callers' TimeoutError
            # handling covers every stalled-rpc case
            raise TimeoutError(f"dag rpc {msg_type} timed out after {timeout + 5:.0f}s") from e

    def close_dag_conn(self, conn: Connection):
        self.io.loop.call_soon_threadsafe(conn.close)

    # ----------------------------------------------------- actors / cluster

    def get_named_actor(self, name: str, namespace: str):
        return self.request(MsgType.GET_ACTOR, {"name": name, "namespace": namespace})

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self._owned_actors.discard(bytes(actor_id))
        self.request(MsgType.KILL_ACTOR, {"actor_id": actor_id, "no_restart": no_restart})

    def cancel_task(self, task_id: bytes, force: bool = False):
        self.request(MsgType.CANCEL_TASK, {"task_id": task_id, "force": force})

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.request(MsgType.KV_PUT, {"key": key, "value": value, "overwrite": overwrite})[
            "added"
        ]

    def kv_get(self, key: str, wait: bool = False, timeout: Optional[float] = None) -> Optional[bytes]:
        reply = self.request(
            MsgType.KV_GET,
            {"key": key, "wait": wait, "timeout": timeout},
            timeout=(timeout or RayConfig.rpc_timeout_s) + 5,
        )
        return reply["value"] if reply.get("found") else None

    def kv_del(self, key: str, prefix: bool = False) -> int:
        return self.request(MsgType.KV_DEL, {"key": key, "prefix": prefix})["deleted"]

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.request(MsgType.KV_KEYS, {"prefix": prefix})["keys"]

    def subscribe(self, channel: str, callback: Callable[[dict], None]):
        self._subscriptions.setdefault(channel, []).append(callback)
        self.request(MsgType.SUBSCRIBE, {"channel": channel})

    def cluster_resources(self) -> Dict[str, float]:
        return self.request(MsgType.CLUSTER_RESOURCES, {})["resources"]

    def available_resources(self) -> Dict[str, float]:
        return self.request(MsgType.AVAILABLE_RESOURCES, {})["resources"]

    def list_nodes(self) -> List[dict]:
        return self.request(MsgType.LIST_NODES, {})["nodes"]

    # ---------------------------------------------------------------- admin

    def attach_store(self, store_path: str):
        self.store = ShmObjectStore(store_path, create=False)
        if RayConfig.object_spilling_enabled:
            self._spill_dir = store_path + ".spill"
            self.store.spill_hook = self._spill_hook
        # pressure events from THIS claimant's allocs (workers putting task
        # results are the common path) must reach the head's event ring too,
        # not only allocs made in the raylet process
        self.store.event_hook = self._store_event_hook

    def _store_event_hook(self, event_type: str, payload: dict) -> None:
        try:
            self.io.spawn(
                self.conn.send(
                    MsgType.RECORD_EVENT,
                    {
                        "severity": "WARNING",
                        "source": "object_store",
                        "message": event_type,
                        "fields": {"node_id": self.node_id, **payload},
                    },
                )
            )
        except Exception:  # graftlint: disable=silent-except -- event emission is best-effort; store pressure must never fail a put
            pass

    def _spill_hook(self, need: int) -> bool:
        """Memory pressure on our node's store: spill LRU objects to the
        node's spill dir ourselves (the store is shared; files land where
        every claimant of this node can restore them) and notify the head,
        which updates the spill registry and drops the gone shm locations
        (reference: local_object_manager.h:105 SpillObjects)."""
        from ray_tpu_torch.raylet.spill import spill_batch

        spilled = spill_batch(self.store, int(need), self._spill_dir)
        if not spilled:
            return False
        # fire-and-forget on our ordered conn: the notify lands before any
        # later message that could depend on the new locations
        self.io.spawn(
            self.conn.request(
                MsgType.SPILL_NOTIFY,
                {"node_id": self.node_id, "spilled": spilled},
                60,
            )
        )
        return True

    def set_preempt_handler(self, handler: Callable[[dict], dict]):
        """Install the actor runtime's checkpoint handler (worker_main
        ``on_preempt``): payload → reply dict, run off the io loop."""
        self._preempt_handler = handler

    def _on_preempt_request(self, rid: int, payload: dict):
        handler = self._preempt_handler

        def _run():
            try:
                if handler is None:
                    result = {"ok": False, "error": "no actor runtime"}
                else:
                    result = handler(payload)
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "__ray_save__ checkpoint failed; the head will escalate "
                    "to a budget-charged kill",
                    exc_info=True,
                )
                result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                self.io.spawn(self.conn.reply(rid, result))
            except Exception:  # noqa: BLE001
                logger.warning(
                    "preempt reply could not be sent (head conn lost); the "
                    "head's rpc timeout escalates on its own",
                    exc_info=True,
                )

        threading.Thread(target=_run, name="preempt-save", daemon=True).start()

    def set_push_task_handler(self, handler: Callable[[dict], None]):
        self._push_task_handler = handler
        early, self._early_pushes = self._early_pushes, []
        for payload in early:
            handler(payload)

    def register_as_worker(
        self,
        node_id: bytes,
        pid: int,
        has_gpu: bool = False,
        direct_addr: str = "",
        log_file: str = "",
    ):
        reply = self.request(
            MsgType.REGISTER_WORKER,
            {
                "worker_id": self.worker_id.binary(),
                "node_id": node_id,
                "pid": pid,
                "has_gpu": has_gpu,
                "direct_addr": direct_addr,
                # where this worker's stdout/stderr land on its node —
                # the head's LOG_FETCH entity resolution (worker/actor/
                # task → file) starts here
                "log_file": log_file,
            },
        )
        # registration echo for a post-restart reattach announce
        self._worker_reg = {"has_gpu": has_gpu, "direct_addr": direct_addr}
        self.node_id = node_id
        self.attach_store(reply["store_path"])
        self._dial_shard(reply.get("shard_addrs") or [])
        return reply

    def register_as_driver(self, worker_env: Dict[str, str]):
        self._driver_env = dict(worker_env or {})
        reply = self.request(
            MsgType.REGISTER_JOB,
            {
                "job_id": self.job_id.binary(),
                "pid": os.getpid(),
                "worker_env": worker_env,
            },
        )
        self.node_id = reply["node_id"]
        store_path = reply["store_path"]
        force_client = bool(os.environ.get("RAY_TPU_FORCE_CLIENT"))
        if os.path.exists(store_path) and not force_client:
            self.attach_store(store_path)
        else:
            # remote driver (Ray-Client mode, reference: util/client/): no
            # node store to mmap — object payloads ride the head connection
            self.is_client = True
        self._dial_shard(reply.get("shard_addrs") or [])
        return reply

    def task_done(
        self,
        task_id: bytes,
        sealed: List[bytes],
        error: Optional[str],
        stored_error: bool,
        exec_start: float = 0.0,
        exec_end: float = 0.0,
        contained: Optional[Dict[bytes, List[bytes]]] = None,
        phases: Optional[Dict[str, float]] = None,
    ):
        # refs this task created locally (e.g. deserialized ref-args kept
        # in actor state) must be declared BEFORE the head unpins the args
        # on TASK_DONE, or the batched add could lose the race with a
        # driver-side delete
        self.flush_ref_adds()
        payload = {
            "task_id": task_id,
            "sealed": sealed,
            "error": error,
            "stored_error": stored_error,
            "exec_start": exec_start,
            "exec_end": exec_end,
            # refs pickled inside each sealed return value → the head
            # pins them for the return object's lifetime
            "contained": contained or {},
            # flight-recorder stamps accumulated across the hops
            # (task_events.py); None/{} when recording is off
            "phases": phases or {},
        }
        # ring first: if the send races a head crash, the post-reattach
        # replay re-delivers it (flagged; the head applies at most once).
        # Under the lock: the reattach path snapshots the ring concurrently.
        with self._refs_lock:
            self._done_ring.append(payload)
        try:
            self.io.call(self.conn.send(MsgType.TASK_DONE, payload))
        except (ConnectionError, OSError):
            if RayConfig.head_reconnect_window_s <= 0 or self._conn_lost:
                raise
            # head mid-restart: the completion survives in the ring

    def disconnect(self):
        self.connected = False
        self._conn_lost = True  # post-disconnect RPCs fail fast and typed
        self._head_up.set()  # wake parked head-FT waiters into the typed path
        for c in list(self._direct_conns.values()):
            try:
                c.close()
            except (OSError, RuntimeError):
                pass  # already-dead transport; disconnect continues
        self._direct_conns.clear()
        # cached leases die with the driver: the head reclaims them on the
        # conn drop; close the push conns so leased workers stop waiting
        with self._lease_lock:
            leases = list(self._lease_by_id.values())
            self._lease_by_id.clear()
            self._leases.clear()
        for lease in leases:
            try:
                lease.conn.close()
            except (OSError, RuntimeError):
                pass  # already-dead transport; disconnect continues
        for c in list(self._node_agent_conn.values()):
            if c and c is not False:
                try:
                    c.close()
                except (OSError, RuntimeError):
                    pass  # already-dead transport; disconnect continues
        if self._shard_conn is not None:
            try:
                self._shard_conn.close()
            except (OSError, RuntimeError):
                pass  # already-dead transport; disconnect continues
        try:
            self.conn.close()
        except (OSError, RuntimeError):
            pass  # already-dead transport; disconnect continues
        try:
            if self.store:
                self.store.close()
        except Exception:  # noqa: BLE001
            logger.debug("store close failed at disconnect", exc_info=True)
        self.io.stop()
