"""Head server: cluster metadata authority + scheduler + object directory.

Analog of the reference's GCS server + raylet control logic
(reference: src/ray/gcs/gcs_server/gcs_server.cc — NodeInfo/ActorInfo/
PlacementGroupInfo/JobInfo/KV/Pubsub services; src/ray/raylet/
node_manager.cc + scheduling/cluster_task_manager.cc for leasing and
dispatch).  One asyncio process serves:

- node registry + worker pool directives (spawn/kill) per node
- cluster task scheduling (hybrid pack/spread policy, resource accounting)
- actor directory + FSM (pending → alive → restarting/dead), named actors
- placement groups (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD) with resource
  reservation and bundle accounting
- object directory (pending → sealed/error) with waiter wakeup
- cluster-wide KV (function table, collective rendezvous), pubsub channels

Design deltas from the reference, kept from the JAX package's runtime:
- Control is a star over length-prefixed msgpack/TCP instead of per-pair
  gRPC meshes; the data plane (tensors) never touches it — large values live
  in the node-local shared-memory store (src/object_store/store.cc).
- Scheduling decisions are centralized here rather than spilled-back raylet
  to raylet (reference cluster_task_manager.cc:80): the global view is what
  placement quality needs.
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import log_plane as _log_plane
from ray_tpu_torch._private import profiler as _profiler
from ray_tpu_torch._private import task_events as _task_events
from ray_tpu_torch._private.config import RayConfig, session_root
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.protocol import Connection, MsgType
from ray_tpu_torch._private.task_spec import ACTOR_CREATION_TASK, ACTOR_TASK, NORMAL_TASK, TaskSpec

logger = logging.getLogger("ray_tpu_torch.gcs")

# Object table states (analog: reference object directory + task states)
PENDING, SEALED, ERRORED = 0, 1, 2


def _percentiles(vals: List[float]) -> dict:
    """Nearest-rank percentile row shared by every summary surface."""
    vals = sorted(vals)
    n = len(vals)
    if n == 0:
        return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0, "mean": 0.0}
    return {
        "count": n,
        "p50": vals[int(0.50 * (n - 1))],
        "p95": vals[int(0.95 * (n - 1))],
        "p99": vals[int(0.99 * (n - 1))],
        "max": vals[-1],
        "mean": sum(vals) / n,
    }

# Actor FSM states (reference: gcs_actor_manager.cc state machine).
# PREEMPTED is the one addition over the reference: the scheduler evicted
# the actor by policy (checkpoint saved, resources released) and it parks
# until capacity returns — distinct from RESTARTING so the worker-death
# path knows not to charge the fault-restart budget.
ACTOR_PENDING, ACTOR_ALIVE, ACTOR_RESTARTING, ACTOR_DEAD, ACTOR_PREEMPTED = (
    "PENDING_CREATION",
    "ALIVE",
    "RESTARTING",
    "DEAD",
    "PREEMPTED",
)


class WorkerInfo:
    __slots__ = (
        "worker_id",
        "node_id",
        "conn",
        "pid",
        "idle",
        "actor_id",
        "running_tasks",
        "started_at",
        "idle_since",
        "dedicated",
        "has_gpu",
        "direct_addr",
        "lease",
        "log_file",
    )

    def __init__(
        self, worker_id: bytes, node_id: bytes, conn: Connection, pid: int, has_gpu: bool = False
    ):
        self.worker_id = worker_id
        self.node_id = node_id
        self.conn = conn
        self.pid = pid
        self.idle = True
        self.actor_id: Optional[bytes] = None
        self.running_tasks: Set[bytes] = set()
        self.started_at = time.time()
        self.idle_since = time.time()
        self.dedicated = False  # actor-dedicated workers never return to pool
        self.has_gpu = has_gpu  # spawned as a GPU worker (ambient CUDA_VISIBLE_DEVICES)
        # dialable host:port of the worker's direct-call server (every
        # worker runs one now — the lease fast path pushes tasks here)
        self.direct_addr = ""
        # active worker lease (control-plane fast path): {"lease_id",
        # "cid", "resources", "priority", "via", "granted_at", "revoking"}
        self.lease: Optional[dict] = None
        # absolute path of the worker's log file on ITS node (from
        # registration) — LOG_FETCH entity resolution starts here
        self.log_file = ""


class NodeInfo:
    """Node bookkeeping.  Resource accounting is delegated to the native
    scheduling core (src/scheduler/scheduler.cc via core/native_scheduler.py
    — fixed-point math, hybrid policy), the analog of the reference's C++
    ClusterResourceManager (src/ray/raylet/scheduling/)."""

    __slots__ = (
        "node_id",
        "conn",
        "resources_total",
        "store_path",
        "alive",
        "workers",
        "starting_workers",
        "labels",
        "address",
        "transfer_addr",
        "store_stats",
        "idle_pool",
        "_sched",
    )

    def __init__(
        self,
        node_id: bytes,
        conn: Optional[Connection],
        resources: Dict[str, float],
        store_path: str,
        sched=None,
    ):
        self.node_id = node_id
        self.conn = conn  # raylet connection (None for the head's own node)
        self.resources_total = dict(resources)
        self.store_path = store_path
        self.alive = True
        self.workers: Dict[bytes, WorkerInfo] = {}
        # O(1) idle-worker index, split by GPU worker or not: _find_idle_worker /
        # the scheduler's capacity count were O(total workers) per call,
        # which is what made 600-actor fleets quadratic at the head
        self.idle_pool: Dict[bool, Set[bytes]] = {False: set(), True: set()}
        self.starting_workers = 0
        self.labels: Dict[str, str] = {}
        self.address = ""
        self.transfer_addr = ""
        # freshest shm-store occupancy reported on this node's heartbeat
        # (the head's own node is sampled directly by the observer loop)
        self.store_stats: Dict[str, float] = {}
        self._sched = sched
        if sched is not None:
            sched.upsert_node(node_id, self.resources_total)

    @property
    def resources_available(self) -> Dict[str, float]:
        avail = self._sched.available(self.node_id)
        # only report resource types this node actually has
        return {k: avail.get(k, 0.0) for k in self.resources_total}

    def can_fit(self, demand: Dict[str, float]) -> bool:
        avail = self._sched.available(self.node_id)
        for k, v in demand.items():
            if v > 0 and avail.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def total_fit(self, demand: Dict[str, float]) -> bool:
        for k, v in demand.items():
            if v > 0 and self.resources_total.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def acquire(self, demand: Dict[str, float]):
        self._sched.acquire(self.node_id, demand, force=True)

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        return self._sched.acquire(self.node_id, demand, force=False)

    def release(self, demand: Dict[str, float]):
        self._sched.release(self.node_id, demand)

    def utilization(self) -> float:
        return self._sched.utilization(self.node_id)

    # ---- idle-worker index (kept in lockstep with WorkerInfo.idle) ----

    def mark_idle(self, w: "WorkerInfo"):
        w.idle = True
        w.idle_since = time.time()
        if not w.dedicated and w.actor_id is None and w.lease is None:
            self.idle_pool[w.has_gpu].add(w.worker_id)

    def mark_busy(self, w: "WorkerInfo"):
        w.idle = False
        self.idle_pool[w.has_gpu].discard(w.worker_id)

    def forget_worker(self, w: "WorkerInfo"):
        self.workers.pop(w.worker_id, None)
        self.idle_pool[w.has_gpu].discard(w.worker_id)

    def pop_idle(self, needs_gpu: bool) -> Optional["WorkerInfo"]:
        pool = self.idle_pool[needs_gpu]
        while pool:
            wid = next(iter(pool))
            pool.discard(wid)
            w = self.workers.get(wid)
            if w is not None and w.idle and w.actor_id is None and not w.dedicated and w.lease is None:
                w.idle = False
                return w
        return None


class ActorInfo:
    __slots__ = (
        "actor_id",
        "state",
        "worker_id",
        "node_id",
        "creation_spec",
        "name",
        "namespace",
        "detached",
        "max_restarts",
        "restarts_used",
        "pending_calls",
        "death_cause",
        "death_log_tail",
        "owner_conn_id",
        "direct_addr",
        "creation_cpu_released",
    )

    def __init__(self, spec: TaskSpec):
        self.actor_id = spec.actor_id
        self.state = ACTOR_PENDING
        self.creation_cpu_released = False
        self.worker_id: Optional[bytes] = None
        self.node_id: Optional[bytes] = None
        self.creation_spec = spec
        self.name = spec.name
        self.namespace = spec.namespace
        self.detached = spec.detached
        self.max_restarts = spec.max_restarts
        self.restarts_used = 0
        self.pending_calls: List[TaskSpec] = []
        self.death_cause = ""
        # LOG_TAIL_MARKER suffix captured at death from the victim
        # worker's recent-line ring; appended to every seal string so
        # late calls to the dead actor still surface the forensics
        self.death_log_tail = ""
        self.owner_conn_id: Optional[int] = None
        # "host:port" of the worker's direct-call server (reference analog:
        # the worker address a DirectActorSubmitter pushes to,
        # direct_actor_task_submitter.cc)
        self.direct_addr: str = ""


class PlacementGroupInfo:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "state", "bundle_nodes", "waiters", "bundle_available")

    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]], strategy: str, name: str):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"
        self.bundle_nodes: List[Optional[bytes]] = [None] * len(bundles)
        # per-bundle remaining resources (consumed by tasks placed in it)
        self.bundle_available: List[Dict[str, float]] = [dict(b) for b in bundles]
        self.waiters: List[asyncio.Future] = []


class TaskEntry:
    """A task known to the scheduler: queued, leased, or running."""

    __slots__ = (
        "spec", "state", "worker_id", "node_id", "caller_conn_id", "blocked",
        "wire", "res_shape", "enqueued_at", "preempted", "preempt_count",
        "preempt_requested_at",
    )

    def __init__(self, spec: TaskSpec, caller_conn_id: int, wire=None):
        self.spec = spec
        self.state = "QUEUED"
        self.worker_id: Optional[bytes] = None
        self.node_id: Optional[bytes] = None
        self.caller_conn_id = caller_conn_id
        self.blocked = False  # worker released cpu while waiting in get()
        self.res_shape = None  # cached sorted resource tuple (scheduler scan)
        # queue-wait clock for fair-share deficits + starvation boosts;
        # independent of the flight recorder so priorities work with
        # RAY_TPU_TASK_EVENTS=0 (it measures the same head_enqueue→dispatch
        # window the queue_wait phase records)
        self.enqueued_at = time.time()
        # preemption accounting: the scheduler killed this running task by
        # policy (requeue, don't charge the fault-retry budget); the count
        # seals a typed PreemptedError once the preemption budget is spent.
        # Seeded from the spec so preemptions a task already suffered on a
        # revoked lease (driver-side resubmit) stay on the same budget.
        self.preempted = False
        self.preempt_count = int(getattr(spec, "preempt_count", 0) or 0)
        self.preempt_requested_at = 0.0  # rate-limits victim scans per entry
        # the submit frame's wire form, reused verbatim for the PUSH_TASK
        # dispatch — re-encoding the spec per hop was measurable on the
        # task hot path
        self.wire = wire


class HeadServer:
    """The cluster brain.  One instance per cluster."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        resources: Optional[Dict[str, float]] = None,
        store_path: str = "",
        store_capacity: int = 0,
        session_dir: str = "",
    ):
        self.host = host
        self.port = port
        self.session_dir = session_dir or session_root()
        self.store_path = store_path or os.path.join(self.session_dir, "store")
        self.store_capacity = store_capacity or RayConfig.object_store_memory
        self._server: Optional[asyncio.AbstractServer] = None

        from ray_tpu_torch.core.native_scheduler import NativeScheduler

        self.sched = NativeScheduler()
        self.nodes: Dict[bytes, NodeInfo] = {}
        self.head_node_id = NodeID.from_random().binary()
        self._head_resources = resources or {}

        self.workers: Dict[bytes, WorkerInfo] = {}
        self.actors: Dict[bytes, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        self.pgs: Dict[bytes, PlacementGroupInfo] = {}
        self.jobs: Dict[bytes, dict] = {}

        # object directory: oid -> [state, error_payload]
        self.objects: Dict[bytes, List] = {}
        self.object_waiters: Dict[bytes, List[asyncio.Future]] = {}
        self.object_refcounts: Dict[bytes, int] = {}
        # container oid -> ids of refs pickled inside its value.  While the
        # container is in scope its inner objects are pinned (one refcount
        # each), closing the sender-releases-before-receiver-registers race
        # (analog: reference reference_count.cc borrower/containment protocol)
        self.object_contained: Dict[bytes, List[bytes]] = {}
        # oid -> set of node_ids holding a sealed copy (analog: reference
        # OwnershipBasedObjectDirectory location sets)
        self.object_locations: Dict[bytes, set] = {}
        # oid -> (node_id, path): objects whose only durable copy is a
        # spill file on that node's disk (reference analog: spilled-URL
        # tracking, raylet/local_object_manager.h)
        self.object_spilled: Dict[bytes, tuple] = {}
        # (oid, dest_node) -> future, coalescing concurrent pull requests
        self._pull_inflight: Dict[Tuple[bytes, bytes], asyncio.Future] = {}
        # lineage: return oid -> producing TaskSpec, byte-budgeted FIFO
        # (analog: reference TaskManager lineage pinning, task_manager.h:91-105
        # + ObjectRecoveryManager, object_recovery_manager.h:90)
        self.lineage: Dict[bytes, TaskSpec] = {}
        self._lineage_bytes: Dict[bytes, int] = {}
        self._lineage_total = 0
        self._reconstructions: Dict[bytes, int] = {}

        # cluster KV: a lock-partitioned thread-safe store shared with the
        # GCS shard servers (gcs/shards.py) — the head's internal reads and
        # writes and the shard listeners operate on the SAME table, so
        # sharding is purely a question of which event loop serves an RPC
        from ray_tpu_torch.gcs.shards import ActorMirror, GcsShardServer, ObjectMirror, ShardedKV

        self.kv = ShardedKV(max(1, RayConfig.gcs_kv_shards or 1))
        # read replicas of the object seal-state + actor directory, written
        # through on every head-side transition and served by the shards
        self._obj_mirror = ObjectMirror()
        self._actor_mirror = ActorMirror()
        self._shard_server: Optional[GcsShardServer] = None
        self.shard_addrs: List[str] = []
        # pubsub: channel -> {conn_id: Connection}
        self.subscribers: Dict[str, Dict[int, Connection]] = {}

        self.task_queue: List[TaskEntry] = []
        self.tasks: Dict[bytes, TaskEntry] = {}  # leased/running by task id
        self.finished_task_count = 0
        # worker-lease fast path: lease_id -> worker_id, plus the holder
        # index (head-granted leases die with their driver connection)
        self.leases: Dict[bytes, bytes] = {}
        self._leases_by_conn: Dict[int, Set[bytes]] = {}
        # rolling task-execution event log for `ray-tpu timeline` (analog:
        # reference core_worker/profiling.cc → GCS → chrome trace)
        from collections import deque

        self.timeline: "deque" = deque(maxlen=10000)
        # structured cluster events (analog: reference src/ray/util/event.h
        # + dashboard event module): lifecycle transitions worth surfacing
        # to operators, ring-buffered and queryable via LIST_EVENTS
        self.events: "deque" = deque(maxlen=5000)
        # flight recorder (task_events.py): per-task joined phase records —
        # the source for TASK_SUMMARY / `ray-tpu summary tasks`; per-phase
        # histograms live in self.kv under metrics:* (written via
        # _observe_phase) so every metrics scrape surface sees them
        self.task_records: "deque" = deque(maxlen=4096)
        # parsed histogram records cached by kv key: one json.dumps per
        # observe instead of a loads+dumps round trip on the done path
        self._phase_hist_cache: Dict[str, dict] = {}
        # workload-plane observability (train/memory + SLO watchdog)
        # object accounting sidecar: oid -> {"nbytes", "owner"} stamped at
        # seal time (owner derived from the sealing connection)
        self.object_meta: Dict[bytes, dict] = {}
        # freshest rolling stats per train run (TRAIN_STEP frames)
        self.train_stats: Dict[str, dict] = {}
        # freshest DAG channel ring occupancy samples (DAG_STEP frames)
        self.dag_channel_stats: Dict[str, dict] = {}
        # SLO watchdog: spec blob cache + one evaluator and verdict per slo
        self._slo_specs_blob: Optional[bytes] = None
        self._slo_specs: List[dict] = []
        self._slo_evals: Dict[str, object] = {}
        self._slo_state: Dict[str, dict] = {}
        # multi-tenant preemption (ROADMAP item 5): within-band fair-share
        # deficits keyed by (band, job), accumulated from queue-wait and
        # drained per dispatch
        self._job_deficit: Dict[Tuple[int, bytes], float] = {}
        self._fair_tick_at = time.time()
        # actors evicted by policy (checkpoint saved, resources released),
        # parked until capacity returns: actor_id -> parked-since ts
        self._preempted_parked: Dict[bytes, float] = {}
        # actors with a PREEMPT_ACTOR rpc in flight (double-preempt guard)
        self._preempting: Set[bytes] = set()
        # rolling preemption log → `ray-tpu summary preemptions`
        self._preempt_log: "deque" = deque(maxlen=512)
        # head-owned ray_tpu_torch_preemptions_total{band,kind} counter records
        self._counter_cache: Dict[str, dict] = {}
        # SLO policy: while a preempt_below_band SLO burns, new low-band
        # re-admissions hold; recovery clears it and parked work returns
        self._slo_preempt_hold = False
        self._slo_breach_ticks: Dict[str, int] = {}
        self._last_policy_preempt = 0.0
        self._preempt_scans_left = 0  # per-tick victim-scan budget
        # cluster-wide sampling profiler (_private/profiler.py): folded
        # stacks aggregated per (role, node) from batched PROFILE_STATS
        # frames, flush-window slices for the chrome timeline, one-shot
        # native stack dumps (`ray-tpu stacks`), and the active control
        # record (mirrors kv "profile:ctrl" for status without a parse)
        self.profile_stacks: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.profile_meta: Dict[Tuple[str, str], dict] = {}
        self.profile_slices: "deque" = deque(maxlen=2048)
        self.profile_stack_dumps: List[dict] = []
        self.profile_ctrl: Optional[dict] = None

        # ---- structured log plane (util/OBSERVABILITY.md "Logs") ----
        # error ring + signature-dedup index behind `summary errors`
        # (the resurrected ERROR_PUSH role, MsgType.ERROR_REPORT)
        self.error_records: "deque" = deque(maxlen=512)
        self._error_index: Dict[str, dict] = {}
        # driver conn -> job id, for job-scoped "logs" fan-out (two
        # concurrent drivers each see only their own workers' lines)
        self._conn_job: Dict[int, bytes] = {}
        # per-source recent-line ring fed by the logs pubsub transit:
        # the forensics tail attached to ActorDiedError when the victim
        # process died without shipping its own (source = log basename)
        self._recent_logs: Dict[str, "deque"] = {}
        # worker id -> {"node", "path", "src"}, kept past worker death
        # (the ring above outlives the WorkerInfo; this is how a dead
        # actor's seal finds its victim's tail, and how LOG_FETCH still
        # resolves an exited worker's file)
        self._worker_log_src: Dict[bytes, dict] = {}
        # log records carrying trace ids, rendered into ray_tpu_torch.timeline()
        # as instant markers ("which line printed during which phase")
        self._log_trace_marks: "deque" = deque(maxlen=2048)

        # ---- head fault tolerance (gcs/HEAD_FT.md) ----
        # per-boot incarnation: 1 on a fresh session, +1 per restart in
        # the same session dir (persisted in head_meta.json + WAL'd)
        self.incarnation = 1
        self.started_at = time.time()
        # active recovery grace window (None when not recovering): holds
        # dispatch while live peers re-attach; state not reconfirmed by
        # the deadline is reaped through the existing fault machinery
        self._recovery: Optional[dict] = None
        self.last_recovery: Optional[dict] = None
        # resubmits / actor calls / lease restores parked until the grace
        # window closes (reconciliation decides dedupe vs enqueue)
        self._recovery_resubmits: List[Tuple[int, dict]] = []
        self._recovery_actor_calls: List[TaskSpec] = []
        # holder-announced leases whose worker hasn't reattached yet,
        # keyed by worker id and drained when that worker announces — a
        # standing structure (NOT recovery-scoped) because a worker's
        # redial can outlast the grace window
        self._pending_lease_restores: Dict[bytes, List[Tuple[int, dict]]] = {}
        # driver-announced actor ownership claims: applied immediately to
        # known actors, and retained so a WORKER announce that lands after
        # its owner's reattach still binds to the right conn
        self._owner_claims: Dict[bytes, int] = {}
        self._reattach_stats = {
            "nodes": 0,
            "workers": 0,
            "drivers": 0,
            "actors": 0,
            "tasks": 0,
            "leases": 0,
        }
        # TASK_DONE replay dedupe: a reattached worker re-sends its recent
        # completions (the head may or may not have processed them before
        # the crash / conn loss) — processing one twice would double-pin
        # contained refs and double-count metrics
        self._recent_dones: Set[bytes] = set()
        from collections import deque as _deque

        self._recent_dones_fifo: "_deque" = _deque(maxlen=8192)
        # ref-batch dedupe: clients tag ADD_REF/REMOVE_REF flushes with a
        # batch id and re-send after a conn loss (the loss may have raced
        # the reply) — a counter bump is not idempotent, so dedupe here
        self._ref_batches: Set[bytes] = set()
        self._ref_batches_fifo: "_deque" = _deque(maxlen=4096)
        # True on a restarted head: pre-crash client refcounts were never
        # re-announced, so an ABSENT count is "unknown", not zero
        self._refs_amnesic = False
        self._store_preserved = False

        self._conn_seq = 0
        self._last_beat: Dict[int, float] = {}
        self._conns: Dict[int, Connection] = {}
        self._conn_kind: Dict[int, str] = {}  # driver|worker|raylet
        self._conn_worker: Dict[int, bytes] = {}
        self._conn_node: Dict[int, bytes] = {}
        self._sched_wakeup = asyncio.Event()
        self._shutdown = False
        self._storage = None
        self._tables_dirty = False
        self._worker_env: Dict[str, str] = {}
        self._next_worker_seq = 0
        self._zygote = None  # warm fork server for pool workers

    # ------------------------------------------------------------------ setup

    def _load_head_meta(self) -> Optional[dict]:
        """One-shot boot IO (before any client is served): the previous
        incarnation's identity record, or None on a fresh session."""
        import json as _json

        try:
            with open(self._head_meta_path) as f:
                return _json.load(f)
        except (OSError, ValueError):
            return None

    def _save_head_meta(self):
        """Persist identity for the NEXT incarnation (atomic replace);
        one-shot boot IO, runs before any client traffic is accepted."""
        import json as _json

        try:
            tmp = self._head_meta_path + ".tmp"
            with open(tmp, "w") as f:
                _json.dump(
                    {
                        "node_id": self.head_node_id.hex(),
                        "port": self.port,
                        "incarnation": self.incarnation,
                        "pid": os.getpid(),
                    },
                    f,
                )
            os.replace(tmp, self._head_meta_path)
        except OSError:
            logger.warning("head_meta.json write failed; restarts lose identity", exc_info=True)

    async def start(self) -> int:
        os.makedirs(self.session_dir, exist_ok=True)
        # head identity persistence: a restarted head in the SAME session
        # dir adopts its predecessor's node id (so surviving workers'
        # RAY_TPU_NODE_ID and the replayed object directory stay valid),
        # its listen port when none was pinned (so peers' redial loops
        # find it), and the next incarnation number
        self._head_meta_path = os.path.join(self.session_dir, "head_meta.json")
        prev_meta = self._load_head_meta()
        if prev_meta:
            try:
                self.head_node_id = bytes.fromhex(prev_meta["node_id"])
                self.incarnation = int(prev_meta.get("incarnation", 1)) + 1
            except (KeyError, ValueError):
                prev_meta = None
        # chaos scope + env-armed plan; fired faults land in the cluster
        # event ring directly (this process OWNS the ring)
        chaos.maybe_init_from_env("head")
        chaos.set_emitter(self._chaos_emit)
        # profiler scope + emitter: the head ingests its own folded-stack
        # frames directly, marshalled onto this loop — the sampler thread
        # must never touch the tables the loop owns (RAY_TPU_PROFILER=1
        # in the env arms head-role sampling from startup; the deprecated
        # RAY_TPU_HEAD_PROFILE alias in head_main routes here too)
        _profiler.maybe_init_from_env("head")
        if _profiler.aware():
            _head_loop = asyncio.get_running_loop()

            def _profile_emit(payload: dict, _loop=_head_loop):
                try:
                    _loop.call_soon_threadsafe(
                        self._ingest_profile_frame,
                        dict(payload, node_id=self.head_node_id),
                    )
                except RuntimeError:
                    pass  # loop already closed (shutdown): frame dropped

            _profiler.set_emitter(_profile_emit)
        # head's own node
        res = dict(self._head_resources)
        res.setdefault("CPU", float(os.cpu_count() or 4))
        res.setdefault("memory", 4.0 * (1 << 30))
        res.setdefault("object_store_memory", float(self.store_capacity))
        node = NodeInfo(self.head_node_id, None, res, self.store_path, sched=self.sched)
        node.labels["node_type"] = "head"
        self.nodes[self.head_node_id] = node
        # create the shm store segment for the head node
        from ray_tpu_torch.core.shm_store import ShmObjectStore
        from ray_tpu_torch.raylet.object_agent import ObjectTransferAgent

        # a restarted head ATTACHES to the surviving store segment instead
        # of recreating it: objects produced before the crash stay
        # readable, and surviving workers' mmaps of the same file remain
        # coherent (recreating would silently split-brain them)
        self._store_preserved = False
        if prev_meta and os.path.exists(self.store_path):
            try:
                self._store = ShmObjectStore(self.store_path, create=False)
                self._store_preserved = True
            except OSError:
                logger.warning(
                    "surviving store segment unusable; recreating (its "
                    "objects are lost — lineage/spill recovery applies)"
                )
        if not self._store_preserved:
            self._store = ShmObjectStore(
                self.store_path, capacity=self.store_capacity, create=True
            )
        if RayConfig.object_spilling_enabled:
            loop = asyncio.get_running_loop()
            spill_dir = self.store_path + ".spill"

            def _head_spill_hook(need: int) -> bool:
                # fires on whatever thread hit pressure (restore runs in an
                # executor; the agent's pulls run on the loop); registry
                # updates are marshalled back onto the loop
                from ray_tpu_torch.raylet.spill import spill_batch

                spilled = spill_batch(self._store, int(need), spill_dir)
                if not spilled:
                    return False
                loop.call_soon_threadsafe(
                    self._record_spills, self.head_node_id, spilled
                )
                return True

            self._store.spill_hook = _head_spill_hook
        # the head node participates in the transfer mesh like any raylet;
        # advertise a dialable address (bind wildcard → RAY_TPU_NODE_IP or loopback)
        self.object_agent = ObjectTransferAgent(self._store)
        transfer_port = await self.object_agent.start()
        if self.host not in ("0.0.0.0", ""):
            advertise = self.host
        else:
            from ray_tpu_torch.util.collective.dcn_backend import _self_ip

            advertise = os.environ.get("RAY_TPU_NODE_IP") or _self_ip()
        node.transfer_addr = f"{advertise}:{transfer_port}"

        # GCS shards: per-shard event loops + listeners for the KV /
        # object-locate / actor-directory read planes, so those RPCs stop
        # serializing behind task dispatch on this loop.  Shard-side table
        # mutations marshal their WAL records back here (the WAL fd is
        # owned by the head loop's persist machinery).
        nshards = RayConfig.gcs_kv_shards
        if nshards > 0:
            from ray_tpu_torch.gcs.shards import GcsShardServer

            head_loop = asyncio.get_running_loop()

            def _shard_wal(*record):
                head_loop.call_soon_threadsafe(self._wal, *record)

            self._shard_server = GcsShardServer(
                self.kv,
                self._obj_mirror,
                self._actor_mirror,
                host=self.host,
                wal_cb=_shard_wal,
                dirty_cb=self._mark_tables_dirty,
            )
            self.shard_addrs = self._shard_server.start(nshards, advertise=advertise)

        # head node's own Prometheus scrape endpoint (raylets run their own)
        from ray_tpu_torch.raylet.metrics_agent import start_metrics_server

        def _head_app_metrics() -> str:
            # the agent shares this process and loop: render the app
            # metrics (incl. flight-recorder phase histograms) straight
            # from the kv table, no connected worker needed
            from ray_tpu_torch.util import metrics as metrics_mod

            return metrics_mod.render_prometheus(
                metrics_mod.merge_series(metrics_mod.raw_records_from_kv(self.kv))
            )

        try:
            mport = await start_metrics_server(
                self.head_node_id.hex(), self._store, app_metrics=_head_app_metrics
            )
            node.labels["metrics_addr"] = f"{advertise}:{mport}"
        except Exception as e:  # noqa: BLE001
            logger.warning("head metrics endpoint unavailable: %s", e)

        if self.port == 0 and prev_meta and prev_meta.get("port"):
            # reclaim the predecessor's port so peers' redial loops reach
            # us without rediscovery; fall back to an ephemeral port if
            # something else grabbed it (peers then fail their window —
            # same as a head that never came back)
            try:
                self._server = await asyncio.start_server(
                    self._on_connection, self.host, int(prev_meta["port"])
                )
            except OSError:
                logger.warning(
                    "predecessor port %s unavailable; binding ephemeral",
                    prev_meta["port"],
                )
                self._server = await asyncio.start_server(
                    self._on_connection, self.host, 0
                )
        else:
            self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._save_head_meta()

        # tail this node's worker logs → "logs" pubsub channel (analog:
        # reference log_monitor.py; drivers subscribe when log_to_driver)
        from ray_tpu_torch._private.log_monitor import LogTailer

        loop = asyncio.get_running_loop()

        def _publish_logs(msg: dict):
            asyncio.run_coroutine_threadsafe(self._publish("logs", msg), loop)

        # head-spawned workers only — raylets tail their own node's files.
        # driver-*.log rides along: the driver tee (log_plane) lands its
        # structured records there, making driver output job-addressable
        self._log_tailer = LogTailer(
            self.session_dir,
            _publish_logs,
            pattern="worker-head-*.log|driver-*.log",
            rotation_bytes=RayConfig.log_rotation_bytes,
            rotation_backups=RayConfig.log_rotation_backups,
        )
        self._log_tailer.start()
        # zero-init the log plane's metric families so scrapes see them
        # before the first line / error flows (prom_validate contract)
        self._inc_counter(
            "ray_tpu_torch_log_lines_total",
            "log lines transiting the head's logs channel, by stream/node",
            {"stream": "out", "node": "head"},
            0.0,
        )
        self._inc_counter(
            "ray_tpu_torch_log_lines_total",
            "log lines transiting the head's logs channel, by stream/node",
            {"stream": "err", "node": "head"},
            0.0,
        )
        for kind in ("task", "actor_task", "actor_death"):
            self._inc_counter(
                "ray_tpu_torch_error_records_total",
                "structured error records in the head's dedup ring, by kind",
                {"kind": kind},
                0.0,
            )
        # table persistence: restore surviving metadata from a prior head
        # incarnation (detached actors restart on fresh workers; spilled /
        # lineage-backed objects stay recoverable), then append every
        # mutation to the WAL and compact when it grows (analog: reference
        # gcs_table_storage.h → redis_store_client.h per-write persistence)
        from ray_tpu_torch.gcs.storage import GcsWalStorage

        self._storage = GcsWalStorage(self.session_dir)
        self._compact_lock = asyncio.Lock()
        # recovery grace window: a RESTARTED head holds dispatch while
        # live peers redial and re-announce; set BEFORE restore so the
        # replayed detached-actor creations park for reclaim instead of
        # immediately respawning actors whose workers may still be alive
        if self.incarnation > 1:
            # pre-crash client refs were never re-announced: an absent
            # refcount must err toward retention, not deletion
            self._refs_amnesic = True
        if self.incarnation > 1 and RayConfig.head_recovery_grace_s > 0:
            self._recovery = {
                "started": time.time(),
                "deadline": time.time() + RayConfig.head_recovery_grace_s,
                "unclaimed_actors": set(),
            }
            # stats cover THIS window only (a second restart must not
            # re-report the first recovery's reattaches)
            self._reattach_stats = {k: 0 for k in self._reattach_stats}
        self._restore_tables()
        # identity record: lets the NEXT incarnation remap directory/spill
        # entries that point at THIS head's (ephemeral) store segment
        self._wal("head", self.head_node_id)
        self._wal("boot", self.incarnation, time.time())
        if self.incarnation > 1:
            self._record_event(
                "WARNING",
                "head",
                f"head restarted (incarnation {self.incarnation}, store "
                f"{'preserved' if self._store_preserved else 'recreated'})",
                incarnation=self.incarnation,
            )
            self._inc_counter(
                "ray_tpu_torch_head_restarts_total",
                "head process restarts within this session",
                {},
                1.0,
            )
            if self._recovery is not None:
                asyncio.get_running_loop().create_task(self._recovery_window())

        # SLO specs can be seeded from the environment (operators without a
        # driver attached yet); a later slo_api.set_slos replaces them
        env_specs = os.environ.get("RAY_TPU_SLO_SPECS", "").strip()
        if env_specs and "slo:specs" not in self.kv:
            try:
                from ray_tpu_torch._private import slo as slo_mod

                slo_mod.parse_specs(env_specs)
                self.kv["slo:specs"] = env_specs.encode()
            except (ValueError, TypeError) as e:
                logger.warning("RAY_TPU_SLO_SPECS rejected: %s", e)

        asyncio.get_running_loop().create_task(self._scheduler_loop())
        asyncio.get_running_loop().create_task(self._idle_reaper_loop())
        asyncio.get_running_loop().create_task(self._failure_detector_loop())
        asyncio.get_running_loop().create_task(self._persist_loop())
        asyncio.get_running_loop().create_task(self._memory_monitor_loop())
        asyncio.get_running_loop().create_task(self._workload_observer_loop())
        logger.info("head server listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self):
        self._shutdown = True
        if self._shard_server is not None:
            self._shard_server.stop()
        if self._storage is not None:
            try:
                async with self._compact_lock:
                    self._storage.compact(self._snapshot_tables())
            except Exception:  # noqa: BLE001
                logger.exception("final WAL compaction failed at shutdown")
        # kill all worker processes we know about
        for w in list(self.workers.values()):
            try:
                os.kill(w.pid, 15)
            except OSError:
                pass
        if self._zygote is not None:
            self._zygote.stop()
        for conn in list(self._conns.values()):
            conn.close()
        if self._server:
            self._server.close()
        try:
            self.object_agent.stop()
        except Exception:  # noqa: BLE001
            logger.debug("object agent stop failed at shutdown", exc_info=True)
        try:
            self._store.close()
        except Exception:  # noqa: BLE001
            logger.debug("store close failed at shutdown", exc_info=True)

    # ---------------------------------------------- table persistence (WAL)

    def _mark_tables_dirty(self):
        self._tables_dirty = True

    def _wal(self, *record):
        """Append one table mutation to the WAL (never fatal)."""
        if self._storage is None:
            return
        try:
            self._storage.append(record)
        except Exception:  # noqa: BLE001
            # losing a WAL record silently costs durability on the NEXT
            # restart; say so loudly even though the live tables are intact
            logger.exception("WAL append failed; record dropped: %r", record[:1])

    def _wal_locs(self, oid: bytes):
        """Idempotent location upsert after any directory mutation."""
        self._wal("loc=", bytes(oid), sorted(self.object_locations.get(oid, ())))

    def _snapshot_tables(self) -> dict:
        detached = []
        for actor in self.actors.values():
            if actor.detached and actor.state != ACTOR_DEAD:
                detached.append(actor.creation_spec.to_wire())
        pgs = [
            (pg.pg_id, pg.bundles, pg.strategy, pg.name)
            for pg in self.pgs.values()
            if pg.state != "REMOVED"
        ]
        return {
            # the runtime chaos plan ("chaos:plan", written by h_chaos_ctrl
            # outside the WAL) must not ride the snapshot: a restarted head
            # comes back fault-free unless the env re-arms it
            "kv": {k: v for k, v in self.kv.items() if k != "chaos:plan"},
            "jobs": dict(self.jobs),
            "detached_actors": detached,
            "pgs": pgs,
            "head_node_id": self.head_node_id,
            # object directory + spill registry + lineage: what makes a
            # restarted head able to find / restore / reconstruct objects
            "object_locations": {o: sorted(l) for o, l in self.object_locations.items()},
            "object_spilled": dict(self.object_spilled),
            "lineage": {o: s.to_wire() for o, s in self.lineage.items()},
            "sealed": [o for o, e in self.objects.items() if e[0] == SEALED],
        }

    def _quarantine_wal(self, reason: str):
        """Move the corrupt WAL segments aside so fresh appends start on a
        clean log and the NEXT restart doesn't re-fail on the same bytes."""
        for path in (self._storage.rotated_path, self._storage.wal_path):
            if os.path.exists(path):
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    logger.exception("could not quarantine corrupt WAL %s", path)
        self._record_event(
            "ERROR",
            "head",
            f"WAL corrupt mid-file; recovered from snapshot only ({reason})",
        )

    def _restore_tables(self):
        from ray_tpu_torch.gcs.storage import WalCorruptionError

        try:
            tables, records = self._storage.load()
        except WalCorruptionError as e:
            # mid-file corruption: replaying a reordered suffix can
            # resurrect deleted state — recover the snapshot alone, loudly
            logger.error("WAL replay aborted: %s — falling back to snapshot-only recovery", e)
            tables, records = self._storage.base.load(), []
            self._quarantine_wal(str(e))
        if not tables and not records:
            return
        st, old_heads = self._seed_state_from_tables(tables)
        # replay the WAL over the base state, newest wins.  A record that
        # fails to APPLY is corruption just like a bad crc: skipping it
        # while applying later records reorders state, so the whole replay
        # is abandoned for snapshot-only recovery (positional contract,
        # same as storage._replay_file).
        try:
            self._apply_wal_records(st, records, old_heads)
        except Exception as e:  # noqa: BLE001
            logger.error(
                "WAL record failed to apply — falling back to snapshot-only "
                "recovery",
                exc_info=True,
            )
            self._quarantine_wal(f"unappliable record: {type(e).__name__}: {e}")
            st, old_heads = self._seed_state_from_tables(tables)
            records = []
        self._materialize_restored(st, old_heads, len(records))

    @staticmethod
    def _seed_state_from_tables(tables) -> Tuple[dict, set]:
        st = {
            "kv": {},
            "jobs": {},
            "detached": {},
            "pgs": {},
            "locs": {},
            "spilled": {},
            "lineage": {},
            "sealed": set(),
        }
        old_heads = set()
        if tables and tables.get("head_node_id"):
            old_heads.add(bytes(tables["head_node_id"]))
        if tables:
            st["kv"].update(tables.get("kv", {}))
            st["jobs"].update(tables.get("jobs", {}))
            for wire in tables.get("detached_actors", []):
                st["detached"][bytes(TaskSpec.from_wire(wire).actor_id)] = wire
            for pg_id, bundles, strategy, name in tables.get("pgs", []):
                st["pgs"][bytes(pg_id)] = (bundles, strategy, name)
            st["locs"].update(
                {bytes(o): set(l) for o, l in tables.get("object_locations", {}).items()}
            )
            st["spilled"].update(
                {bytes(o): tuple(v) for o, v in tables.get("object_spilled", {}).items()}
            )
            st["lineage"].update(
                {bytes(o): w for o, w in tables.get("lineage", {}).items()}
            )
            st["sealed"].update(bytes(o) for o in tables.get("sealed", []))
        return st, old_heads

    @staticmethod
    def _apply_wal_records(st: dict, records: List[Tuple], old_heads: set):
        for rec in records:
            kind = rec[0]
            if kind == "kv":
                if rec[2] is None:
                    st["kv"].pop(rec[1], None)
                else:
                    st["kv"][rec[1]] = rec[2]
            elif kind == "job":
                st["jobs"][rec[1]] = rec[2]
            elif kind == "dactor":
                if rec[2] is None:
                    st["detached"].pop(bytes(rec[1]), None)
                else:
                    st["detached"][bytes(rec[1])] = rec[2]
            elif kind == "pg":
                if rec[2] is None:
                    st["pgs"].pop(bytes(rec[1]), None)
                else:
                    st["pgs"][bytes(rec[1])] = tuple(rec[2])
            elif kind == "seal":
                st["sealed"].add(bytes(rec[1]))
            elif kind == "loc=":
                locs = {bytes(x) for x in rec[2]}
                if locs:
                    st["locs"][bytes(rec[1])] = locs
                else:
                    st["locs"].pop(bytes(rec[1]), None)
            elif kind == "spill":
                if rec[2] is None:
                    st["spilled"].pop(bytes(rec[1]), None)
                else:
                    st["spilled"][bytes(rec[1])] = tuple(rec[2])
            elif kind == "lineage":
                if rec[2] is None:
                    st["lineage"].pop(bytes(rec[1]), None)
                else:
                    st["lineage"][bytes(rec[1])] = rec[2]
            elif kind == "obj-":
                oid = bytes(rec[1])
                st["locs"].pop(oid, None)
                st["spilled"].pop(oid, None)
                st["sealed"].discard(oid)
            elif kind == "head":
                old_heads.add(bytes(rec[1]))
            elif kind == "boot":
                pass  # incarnation breadcrumb (head_meta.json is authoritative)
            else:
                raise ValueError(f"unknown WAL record kind {kind!r}")

    def _materialize_restored(self, st: dict, old_heads: set, n_records: int):
        # the CURRENT head id is not "old" even if a prior boot WAL'd it:
        # a restarted head reuses its predecessor's identity (head_meta)
        old_heads = {h for h in old_heads if h != self.head_node_id}
        self.kv.update(st["kv"])
        self.jobs.update(st["jobs"])
        for wire in st["detached"].values():
            spec = TaskSpec.from_wire(wire)
            if spec.actor_id in self.actors:
                continue
            actor = ActorInfo(spec)
            actor.owner_conn_id = -1  # detached: owned by the cluster
            self.actors[spec.actor_id] = actor
            if spec.name:
                self.named_actors[(spec.namespace, spec.name)] = spec.actor_id
            self._actor_mirror.upsert(
                spec.actor_id,
                state=ACTOR_PENDING,
                name=spec.name,
                namespace=spec.namespace,
                creation_spec=wire,
                direct_addr="",
                death_cause="",
            )
            for oid in spec.return_object_ids():
                self._object_entry(oid)
            if self._recovery is not None:
                # live-recovery: the actor's worker may still be ALIVE and
                # mid-redial — park the creation; a worker re-attach claims
                # it, and _finish_recovery requeues the unclaimed rest
                self._recovery["unclaimed_actors"].add(bytes(spec.actor_id))
                continue
            # old worker processes died with the previous head; re-run the
            # creation task on a fresh worker (actor restart semantics)
            entry = TaskEntry(spec, -1)
            self.tasks[spec.task_id] = entry
            self.task_queue.append(entry)
        for pg_id, (bundles, strategy, name) in st["pgs"].items():
            if pg_id not in self.pgs:
                self.pgs[pg_id] = PlacementGroupInfo(pg_id, bundles, strategy, name)
        for oid, locs in st["locs"].items():
            # nodes re-register with their prior ids; stale entries for
            # nodes that never come back are pruned at the end of the
            # recovery grace window (or skipped by the pull path).
            # Entries on a PRIOR head incarnation are gone for good (that
            # head's store segment was recreated); entries on THIS head's
            # own node survive when the segment was attached, not rebuilt.
            locs = {n for n in locs if n not in old_heads}
            if not self._store_preserved:
                locs.discard(self.head_node_id)
            if locs:
                self.object_locations[oid] = set(locs)
        for oid, (nid, spath) in st["spilled"].items():
            # spill FILES survive head restarts; files spilled by the old
            # head process are served by THIS head (same session dir)
            if bytes(nid) in old_heads:
                nid = self.head_node_id
            self.object_spilled[oid] = (bytes(nid), spath)
        for oid, wire in st["lineage"].items():
            try:
                spec = TaskSpec.from_wire(wire)
            except Exception:  # noqa: BLE001
                logger.warning(
                    "dropping undecodable lineage entry for %s during replay",
                    oid.hex()[:16],
                    exc_info=True,
                )
                continue
            self._record_lineage(spec, len(repr(wire)))
        for oid in (
            st["sealed"] | set(st["locs"]) | set(st["spilled"]) | set(st["lineage"])
        ):
            e = self._object_entry(oid)
            e[0] = SEALED
            self._obj_mirror.seal(oid)
        logger.info(
            "restored GCS tables: %d kv, %d detached actors, %d pgs, "
            "%d object locations, %d spilled, %d lineage entries "
            "(%d WAL records replayed)",
            len(st["kv"]),
            len(st["detached"]),
            len(st["pgs"]),
            len(st["locs"]),
            len(st["spilled"]),
            len(st["lineage"]),
            n_records,
        )
        # fold everything into a fresh base so the next restart replays a
        # short WAL
        try:
            self._storage.compact(self._snapshot_tables())
        except Exception:  # noqa: BLE001
            logger.exception("post-replay WAL compaction failed")

    async def _persist_loop(self):
        """Compaction pacing: the WAL already made every mutation durable;
        this loop just folds it into the base snapshot when it grows (or
        periodically while dirty, bounding replay length).  Only phase 1
        (serialize + WAL rotation) runs on the loop — snapshot file IO and
        fsync happen in a thread so head RPCs never stall behind them; the
        batched-fsync flusher also rides this loop's tick."""
        last_compact = time.time()
        while not self._shutdown:
            await asyncio.sleep(0.5)
            try:
                # bound the batched-fsync window; in a thread so head RPCs
                # never wait on disk, under the lock so a concurrent
                # begin_compact can't close the fd mid-fsync
                async with self._compact_lock:
                    await asyncio.to_thread(self._storage.sync)
            except Exception:  # noqa: BLE001
                logger.exception("batched WAL fsync failed; retrying next tick")
            grown = self._storage.wal_bytes > 4 * (1 << 20)
            periodic = self._tables_dirty and time.time() - last_compact > 10.0
            if not (grown or periodic):
                continue
            self._tables_dirty = False
            last_compact = time.time()
            try:
                async with self._compact_lock:
                    # phase 1 ON the loop: the snapshot must be consistent
                    # with the WAL rotation point w.r.t. concurrent appends
                    snapshot = self._storage.begin_compact(self._snapshot_tables())
                    await asyncio.to_thread(self._storage.finish_compact, snapshot)
            except Exception:
                logger.exception("GCS compaction failed")

    # ------------------------------------- head FT: recovery + reattachment

    def _note_done(self, tid: bytes):
        """Remember a processed TASK_DONE (bounded) so a reattached
        worker's replay of the same completion is dropped, not re-applied."""
        tid = bytes(tid)
        if tid in self._recent_dones:
            return
        if len(self._recent_dones_fifo) == self._recent_dones_fifo.maxlen:
            self._recent_dones.discard(self._recent_dones_fifo[0])
        self._recent_dones_fifo.append(tid)
        self._recent_dones.add(tid)

    def _resubmit_is_duplicate(self, spec: TaskSpec) -> bool:
        """Idempotent resubmit check: the task id IS the idempotency key.
        A resubmitted spec is a duplicate if the task is still tracked
        (re-announced by its reattached worker), was already seen
        completing, or every return object already sealed/errored (the
        WAL'd commit point)."""
        if spec.task_id in self.tasks:
            return True
        if bytes(spec.task_id) in self._recent_dones:
            return True
        oids = spec.return_object_ids()
        if oids and all(
            self.objects.get(oid, (PENDING,))[0] in (SEALED, ERRORED)
            for oid in oids
        ):
            return True
        return False

    async def _recovery_window(self):
        rec = self._recovery
        if rec is None:
            return
        await asyncio.sleep(max(0.0, rec["deadline"] - time.time()))
        try:
            await self._finish_recovery()
        except Exception:  # noqa: BLE001
            logger.exception("recovery reconciliation failed; resuming dispatch anyway")
            self._recovery = None
            self._kick_scheduler()

    async def _finish_recovery(self):
        """Close the grace window: everything re-announced stays; state
        not reconfirmed is declared dead through the EXISTING machinery —
        detached-actor creations requeue (fault FSM), unclaimed driver
        actors die like their owner exited, stale object locations prune
        so lineage/spill recovery applies, parked calls and resubmits
        flow with idempotent dedupe."""
        rec, self._recovery = self._recovery, None
        if rec is None:
            return
        reaped = {"actors": 0, "owners": 0, "locations": 0, "spills": 0}
        # 1. restored detached actors nobody reclaimed: their workers are
        #    gone — re-run creation on a fresh worker (cold-restart path)
        for aid in rec["unclaimed_actors"]:
            actor = self.actors.get(aid)
            if actor is None or actor.state != ACTOR_PENDING or actor.worker_id:
                continue
            entry = TaskEntry(actor.creation_spec, -1)
            self.tasks[actor.creation_spec.task_id] = entry
            self.task_queue.append(entry)
            reaped["actors"] += 1
            self._record_event(
                "WARNING",
                "head",
                "ghost reaped: detached actor never re-announced; "
                "respawning through the restart FSM",
                actor_id=aid.hex(),
            )
        # 2. worker-announced non-detached actors whose owner driver never
        #    re-attached: same fate as an owner that exited.  Per-actor
        #    isolation: one malformed entry must not abandon the parked
        #    resubmit/call drains below (their senders were acked
        #    {parked: true} and will never re-send)
        for actor in list(self.actors.values()):
            if actor.owner_conn_id == -2 and not actor.detached:
                claim = self._owner_claims.get(actor.actor_id)
                if claim is not None:
                    actor.owner_conn_id = claim  # late claim application
                    continue
                reaped["owners"] += 1
                self._owner_claims.pop(actor.actor_id, None)
                try:
                    await self._destroy_actor(
                        actor, "owner driver never re-attached after head restart"
                    )
                except Exception:  # noqa: BLE001
                    logger.exception("orphan-owner reap failed; continuing reconcile")
        # surviving claims are KEPT: a worker whose redial outlasts the
        # grace window still binds its announced actors to the right
        # owner conn instead of the -2 sentinel (which nothing ever reaps)
        # 3. object locations / spill entries on nodes that never came
        #    back: prune so gets fall through to spill-restore / lineage
        #    reconstruction instead of hanging on a dead copy
        for oid, locs in list(self.object_locations.items()):
            dead = {n for n in locs if n not in self.nodes}
            if dead:
                locs -= dead
                reaped["locations"] += 1
                if not locs:
                    del self.object_locations[oid]
                self._wal_locs(oid)
        for oid, (nid, _path) in list(self.object_spilled.items()):
            if bytes(nid) not in self.nodes:
                del self.object_spilled[oid]
                self._wal("spill", bytes(oid), None)
                reaped["spills"] += 1
        # 4. actor calls that raced the reconciliation: their actors are
        #    either re-announced (push) or truly dead (typed error)
        calls, self._recovery_actor_calls = self._recovery_actor_calls, []
        for spec in calls:
            try:
                await self._submit_actor_task(spec)
            except Exception:  # noqa: BLE001
                logger.exception("parked actor call failed during reconcile")
        # 5. lease restores for still-absent workers stay parked in
        #    _pending_lease_restores — each worker's own (possibly late)
        #    reattach drains its entries
        # 6. parked resubmits: enqueue only what no surviving peer owns
        resubs, self._recovery_resubmits = self._recovery_resubmits, []
        deduped = 0
        for cid, wire in resubs:
            try:
                spec = TaskSpec.from_wire(wire)
                if self._resubmit_is_duplicate(spec):
                    deduped += 1
                    continue
                await self.h_submit_task(cid, None, {"spec": wire})
            except Exception:  # noqa: BLE001
                logger.exception("parked resubmit failed during reconcile")
        duration = time.time() - rec["started"]
        self.last_recovery = {
            "at": time.time(),
            "duration_s": duration,
            "incarnation": self.incarnation,
            "reattached": dict(self._reattach_stats),
            "reaped": reaped,
            "resubmits": {"received": len(resubs), "deduped": deduped},
        }
        self._set_gauge(
            "ray_tpu_torch_head_recovery_seconds",
            "duration of the last head recovery grace window",
            {},
            duration,
        )
        self._record_event(
            "INFO",
            "head",
            "recovery reconcile complete: "
            f"{self._reattach_stats['nodes']} nodes / "
            f"{self._reattach_stats['workers']} workers / "
            f"{self._reattach_stats['drivers']} drivers re-attached, "
            f"{self._reattach_stats['actors']} actors + "
            f"{self._reattach_stats['tasks']} running tasks reclaimed; "
            f"reaped {reaped['actors']} actors, {reaped['owners']} orphaned "
            f"owners, {reaped['locations']} stale locations; "
            f"{deduped}/{len(resubs)} resubmits deduped",
            **{f"reattached_{k}": v for k, v in self._reattach_stats.items()},
        )
        logger.info("head recovery complete in %.2fs: %s", duration, self.last_recovery)
        self._kick_scheduler()

    def _restore_lease(self, cid: int, l: dict):
        """Re-establish a holder-announced worker lease after a restart.
        The lease's task flow never stopped (pushes ride the holder↔worker
        direct conn) — this only restores the head's resource hold so the
        scheduler doesn't double-book the leased worker."""
        wid = bytes(l.get("worker_id") or b"")
        w = self.workers.get(wid)
        if w is None:
            # the leased worker is still mid-redial: park the claim; the
            # worker's own reattach drains it (silently dropping it would
            # let the scheduler double-book the worker the holder is
            # still pushing lease tasks to)
            self._pending_lease_restores.setdefault(wid, []).append((cid, l))
            return
        if w.lease is not None:
            # already held (duplicate announce, or a same-head reattach of
            # a lease the head never forgot): REBIND it to the holder's new
            # conn, or the old conn's late EOF would release a lease the
            # reattached holder is still pushing on
            old_cid = w.lease.get("cid")
            if old_cid != cid:
                lid = bytes(w.lease.get("lease_id") or b"")
                w.lease["cid"] = cid
                if old_cid is not None:
                    self._leases_by_conn.get(old_cid, set()).discard(lid)
                self._leases_by_conn.setdefault(cid, set()).add(lid)
            return
        res = {str(k): float(v) for k, v in (l.get("resources") or {}).items()}
        node = self.nodes.get(w.node_id)
        if node is None:
            return
        node.acquire(res)
        node.mark_busy(w)
        lid = bytes(l.get("lease_id") or b"")
        w.lease = {
            "lease_id": lid,
            "cid": cid,
            "resources": res,
            "priority": int(l.get("priority", 1)),
            "via": "head",
            "granted_at": time.time(),
            "revoking": False,
        }
        self.leases[lid] = wid
        self._leases_by_conn.setdefault(cid, set()).add(lid)
        self._reattach_stats["leases"] += 1

    async def h_reattach(self, cid, conn, p):
        """A live peer redialed after a head restart and re-announces what
        it holds.  Role-tagged; every branch is idempotent (a retried
        reattach re-applies cleanly)."""
        role = str(p.get("role", ""))
        if role == "node":
            nid = bytes(p["node_id"])
            node = self.nodes.get(nid)
            if node is None:
                node = NodeInfo(
                    nid, conn, p["resources"], p["store_path"], sched=self.sched
                )
                self.nodes[nid] = node
            else:
                node.conn = conn
                node.alive = True
            node.address = p.get("address", "")
            node.transfer_addr = p.get("transfer_addr", "")
            if p.get("metrics_addr"):
                node.labels["metrics_addr"] = p["metrics_addr"]
            if p.get("dispatch_addr"):
                node.labels["dispatch_addr"] = p["dispatch_addr"]
            self._conn_kind[cid] = "raylet"
            self._conn_node[cid] = nid
            self._last_beat[cid] = time.time()
            self._reattach_stats["nodes"] += 1
            self._record_event(
                "INFO",
                "head",
                "node re-attached after head restart",
                node_id=nid.hex(),
                objects=int(p.get("num_objects", 0)),
            )
            self._kick_scheduler()
            return {
                "ok": True,
                "head_node_id": self.head_node_id,
                "incarnation": self.incarnation,
            }
        if role == "worker":
            nid = bytes(p["node_id"])
            node = self.nodes.get(nid)
            if node is None:
                # its raylet hasn't re-registered yet: ask the worker to
                # retry within its window instead of failing it
                return {"ok": False, "retry": True, "reason": "node not re-attached yet"}
            wid = bytes(p["worker_id"])
            w = self.workers.get(wid)
            if w is None:
                w = WorkerInfo(
                    wid, nid, conn, int(p.get("pid", 0)), has_gpu=bool(p.get("has_gpu"))
                )
                self.workers[wid] = w
                node.workers[wid] = w
            else:
                w.conn = conn
            if p.get("direct_addr"):
                host = str(node.transfer_addr or "127.0.0.1:0").rsplit(":", 1)[0]
                port = str(p["direct_addr"]).rsplit(":", 1)[-1]
                w.direct_addr = f"{host or '127.0.0.1'}:{port}"
            self._conn_kind[cid] = "worker"
            self._conn_worker[cid] = wid
            self._last_beat[cid] = time.time()
            actor_wire = p.get("actor")
            if actor_wire:
                await self._reclaim_actor(w, node, actor_wire, p)
            elif w.actor_id is None and not w.running_tasks:
                node.mark_idle(w)
            for wire in p.get("running", []):
                spec = TaskSpec.from_wire(wire)
                existing = self.tasks.get(spec.task_id)
                if existing is not None:
                    if existing.state == "QUEUED":
                        # _on_worker_dead requeued it when this worker's
                        # old conn EOF'd, but the worker survived and is
                        # STILL running it: cancel the duplicate retry or
                        # the scheduler double-executes the task
                        try:
                            self.task_queue.remove(existing)
                        except ValueError:
                            pass
                        self.tasks.pop(spec.task_id, None)
                    else:
                        continue
                entry = TaskEntry(spec, -1)
                entry.state = "RUNNING"
                entry.worker_id = wid
                entry.node_id = nid
                self.tasks[spec.task_id] = entry
                w.running_tasks.add(spec.task_id)
                for oid in spec.return_object_ids():
                    self._object_entry(oid)
                if spec.task_type == NORMAL_TASK:
                    node.mark_busy(w)
                    node.acquire(self._task_resources(spec))
                elif spec.task_type == ACTOR_CREATION_TASK:
                    # the crash raced this creation mid-__init__: the dead
                    # head acked CREATE_ACTOR (so the driver will not
                    # re-issue it) but the instance wasn't up yet, so the
                    # worker's announce carries only the running spec.
                    # Materialize the FSM entry NOW or the imminent
                    # TASK_DONE has no ActorInfo to flip ALIVE and the
                    # live actor would be unreachable forever.
                    aid2 = bytes(spec.actor_id)
                    actor2 = self.actors.get(aid2)
                    if actor2 is None:
                        actor2 = ActorInfo(spec)
                        actor2.owner_conn_id = (
                            -1
                            if spec.detached
                            else self._owner_claims.get(aid2, -2)
                        )
                        self.actors[aid2] = actor2
                        if spec.name:
                            self.named_actors[(spec.namespace, spec.name)] = aid2
                        if spec.detached:
                            self._wal("dactor", aid2, wire)
                            self._mark_tables_dirty()
                        # creation-time hold (implicit CPU included):
                        # _release_creation_cpu gives the implicit share
                        # back when TASK_DONE flips it ALIVE
                        node.acquire(dict(spec.resources or {"CPU": 1.0}))
                    actor2.worker_id = wid
                    actor2.node_id = nid
                    w.dedicated = True
                    w.actor_id = aid2
                    node.mark_busy(w)
                    if self._recovery is not None:
                        self._recovery["unclaimed_actors"].discard(aid2)
                self._reattach_stats["tasks"] += 1
            # a worker-hosted actor can OWN actors (an actor that creates
            # actors) and hold cached leases, exactly like a
            # driver — its claims must land or reconciliation owner-reaps
            # otherwise-healthy actors
            self._apply_reattach_claims(cid, p)
            # lease claims parked while THIS worker was mid-redial drain
            # now (holder conn must still be live — a dead holder's
            # release path already ran and would never reclaim the hold)
            for hcid, l in self._pending_lease_restores.pop(wid, []):
                if hcid in self._conns:
                    self._restore_lease(hcid, l)
            self._reattach_stats["workers"] += 1
            self._kick_scheduler()
            return {
                "ok": True,
                "store_path": node.store_path,
                # False only for head-node peers when the surviving segment
                # was unusable and recreated: their mmaps point at the dead
                # inode and must re-attach (split-brain otherwise)
                "store_preserved": bool(
                    self._store_preserved or nid != self.head_node_id
                ),
                "shard_addrs": self.shard_addrs,
                "incarnation": self.incarnation,
            }
        if role == "driver":
            self._conn_kind[cid] = "driver"
            job_id = p.get("job_id", b"")
            if job_id not in self.jobs:
                self.jobs[job_id] = {
                    "started_at": time.time(),
                    "driver_pid": p.get("pid", 0),
                }
                self._wal("job", job_id, self.jobs[job_id])
            self._worker_env.update(p.get("worker_env") or {})
            self._apply_reattach_claims(cid, p)
            self._reattach_stats["drivers"] += 1
            return {
                "ok": True,
                "store_path": self.nodes[self.head_node_id].store_path,
                "store_preserved": self._store_preserved,
                "node_id": self.head_node_id,
                "shard_addrs": self.shard_addrs,
                "incarnation": self.incarnation,
            }
        raise ValueError(f"unknown reattach role {role!r}")

    def _apply_reattach_claims(self, cid: int, p: dict):
        """Bind a reattached peer's ownership claims + held leases: claims
        rebind known actors to the new conn immediately and are retained
        (_owner_claims) for actors whose hosting worker announces later."""
        for aid in p.get("owned_actors", []):
            aid = bytes(aid)
            self._owner_claims[aid] = cid
            actor = self.actors.get(aid)
            if actor is not None and not actor.detached:
                actor.owner_conn_id = cid
        for l in p.get("leases", []):
            self._restore_lease(cid, l)

    async def _reclaim_actor(self, w: WorkerInfo, node: NodeInfo, wire, p: dict):
        """A surviving actor worker re-announced its actor: rebind it into
        the directory as ALIVE with its resources re-acquired, whatever
        the replayed WAL believed."""
        spec = TaskSpec.from_wire(wire)
        aid = bytes(spec.actor_id)
        actor = self.actors.get(aid)
        # the restart FSM may have queued this actor's re-creation before
        # the surviving worker's announce landed (same-head conn sever:
        # _on_worker_dead fired on the old conn's EOF).  A queued creation
        # is cancelled — the live instance wins; one already RUNNING on a
        # fresh worker means the FSM owns the actor now, so the stale
        # instance must NOT be rebound over it.
        creation = self.tasks.get(spec.task_id)
        if creation is not None and creation.spec.task_type == ACTOR_CREATION_TASK:
            if creation.state == "RUNNING" and creation.worker_id != w.worker_id:
                return
            if creation.state == "QUEUED":
                try:
                    self.task_queue.remove(creation)
                except ValueError:
                    pass
                self.tasks.pop(spec.task_id, None)
        fresh = actor is None
        if fresh:
            actor = ActorInfo(spec)
            # -2 = awaiting owner reclaim: a driver reattach claims it
            # (possibly already did — _owner_claims), _finish_recovery
            # destroys the unclaimed rest (owner-exited semantics).
            # Detached actors are cluster-owned as usual.
            if spec.detached:
                actor.owner_conn_id = -1
            else:
                actor.owner_conn_id = self._owner_claims.get(aid, -2)
            self.actors[aid] = actor
            if spec.detached:
                self._wal("dactor", aid, wire)
                self._mark_tables_dirty()
        already_bound = actor.worker_id == w.worker_id and actor.state == ACTOR_ALIVE
        actor.state = ACTOR_ALIVE
        actor.worker_id = w.worker_id
        actor.node_id = node.node_id
        actor.death_log_tail = ""  # forensics from a prior incarnation
        if spec.name:
            self.named_actors[(spec.namespace, spec.name)] = aid
        if p.get("actor_direct_addr"):
            host = str(node.transfer_addr or "127.0.0.1:0").rsplit(":", 1)[0]
            port = str(p["actor_direct_addr"]).rsplit(":", 1)[-1]
            actor.direct_addr = f"{host or '127.0.0.1'}:{port}"
        w.actor_id = aid
        w.dedicated = True
        node.mark_busy(w)
        if not already_bound:
            # lifetime resources were released with the old head's tables;
            # the worker genuinely holds them — force-reacquire
            node.acquire(self._actor_lifetime_resources(spec))
            actor.creation_cpu_released = True
            self._reattach_stats["actors"] += 1
        if self._recovery is not None:
            self._recovery["unclaimed_actors"].discard(aid)
        self._actor_mirror.upsert(
            aid,
            state=ACTOR_ALIVE,
            name=spec.name,
            namespace=spec.namespace,
            creation_spec=wire,
            direct_addr=actor.direct_addr,
            death_cause="",
        )
        await self._publish("actor", {"actor_id": aid, "state": ACTOR_ALIVE})
        # calls queued while the actor was thought PENDING flush now
        calls, actor.pending_calls = actor.pending_calls, []
        for call in calls:
            await self._push_actor_task(actor, call)

    # ----------------------------------------------------------- connections

    async def _on_connection(self, reader, writer):
        conn = Connection(reader, writer)
        self._conn_seq += 1
        cid = self._conn_seq
        self._conns[cid] = conn
        try:
            while not self._shutdown:
                msg_type, rid, payload = await conn.read_frame()
                if conn.dispatch_reply(msg_type, rid, payload):
                    continue
                # serve each request concurrently; handler errors reply ERROR
                asyncio.get_running_loop().create_task(
                    self._handle(cid, conn, msg_type, rid, payload)
                )
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._conns.pop(cid, None)
            self._last_beat.pop(cid, None)
            conn.close()
            await self._on_disconnect(cid, conn)

    async def _handle(self, cid: int, conn: Connection, msg_type: int, rid: int, payload: dict):
        try:
            handler = self._HANDLERS.get(msg_type)
            if handler is None:
                raise ValueError(f"unknown message type {msg_type}")
            result = await handler(self, cid, conn, payload)
            if rid:
                await conn.reply(rid, result or {})
        except Exception as e:  # noqa: BLE001
            logger.exception("handler error for msg %s", msg_type)
            if rid:
                try:
                    await conn.reply(rid, {}, error=f"{type(e).__name__}: {e}")
                except Exception:  # graftlint: disable=silent-except -- error already logged above; the reply transport itself is dead
                    pass

    async def _on_disconnect(self, cid: int, conn: Optional[Connection] = None):
        # leases die with the connection that holds them (driver exit, or
        # a worker whose nested submits cached leases) — unless the holder
        # already reattached and the lease was restored under its NEW cid
        for lid in self._leases_by_conn.pop(cid, set()):
            wid = self.leases.get(lid)
            w = self.workers.get(wid) if wid else None
            if (
                w is not None
                and w.lease is not None
                and w.lease.get("cid", cid) == cid
            ):
                self._release_lease(
                    w, self.nodes.get(w.node_id), reason="holder disconnected"
                )
        kind = self._conn_kind.pop(cid, None)
        self._conn_job.pop(cid, None)
        # ownership claims recorded for this conn die with it: a LATER
        # "late claim application" must never rebind an actor to a
        # vanished conn id (conn ids are not reused — that actor would
        # leak forever)
        if kind in ("worker", "driver"):
            for aid in [a for a, c in self._owner_claims.items() if c == cid]:
                del self._owner_claims[aid]
        if kind == "worker":
            wid = self._conn_worker.pop(cid, None)
            w = self.workers.get(wid) if wid else None
            if w is not None and conn is not None and w.conn is not conn:
                return  # reattached on a newer conn: this EOF is stale
            if wid:
                await self._on_worker_dead(wid, "worker process died (connection lost)")
        elif kind == "raylet":
            nid = self._conn_node.pop(cid, None)
            node = self.nodes.get(nid) if nid else None
            if node is not None and conn is not None and node.conn is not conn:
                return  # node reattached on a newer conn: stale EOF
            if nid:
                await self._on_node_dead(nid)
        elif kind == "driver":
            # non-detached actors owned by this driver die with it — but
            # with a reconnect window open the driver may be mid-redial
            # (same-head conn sever): park the orphans behind the window
            # and reap only those never re-claimed
            orphans = [
                actor
                for actor in self.actors.values()
                if actor.owner_conn_id == cid and not actor.detached
            ]
            if not orphans:
                return
            window = RayConfig.head_reconnect_window_s
            if window <= 0:
                for actor in orphans:
                    await self._destroy_actor(actor, "owner driver exited")
                return
            ids = []
            for actor in orphans:
                actor.owner_conn_id = -2  # awaiting owner re-claim
                ids.append(actor.actor_id)
            asyncio.get_running_loop().create_task(
                self._reap_unclaimed_owners(ids, window + 1.0)
            )

    async def _reap_unclaimed_owners(self, actor_ids: List[bytes], delay: float):
        """Reattach-window grace for owner death: destroy only the actors
        whose owner never re-claimed them (reattach rebinds owner_conn_id
        via _apply_reattach_claims, which also records _owner_claims)."""
        await asyncio.sleep(delay)
        for aid in actor_ids:
            actor = self.actors.get(bytes(aid))
            if actor is None or actor.detached or actor.owner_conn_id != -2:
                continue
            claim = self._owner_claims.get(bytes(aid))
            if claim is not None:
                actor.owner_conn_id = claim  # late claim application
                continue
            await self._destroy_actor(
                actor, "owner driver exited (never re-attached)"
            )

    # ------------------------------------------------------ lifecycle: nodes

    async def h_register_node(self, cid, conn, p):
        nid = p["node_id"]
        node = NodeInfo(nid, conn, p["resources"], p["store_path"], sched=self.sched)
        node.address = p.get("address", "")
        node.transfer_addr = p.get("transfer_addr", "")
        if p.get("metrics_addr"):
            node.labels["metrics_addr"] = p["metrics_addr"]
        if p.get("dispatch_addr"):
            # the node's lease agent: clients dial it for node-affine
            # leases (raylet-local dispatch)
            node.labels["dispatch_addr"] = p["dispatch_addr"]
        self.nodes[nid] = node
        self._record_event("INFO", "node", "node registered", node_id=nid.hex())
        self._conn_kind[cid] = "raylet"
        self._conn_node[cid] = nid
        self._kick_scheduler()
        return {"ok": True, "head_node_id": self.head_node_id}

    async def h_register_worker(self, cid, conn, p):
        wid = p["worker_id"]
        nid = p["node_id"]
        node = self.nodes.get(nid)
        if node is None:
            raise ValueError("unknown node")
        w = WorkerInfo(wid, nid, conn, p["pid"], has_gpu=bool(p.get("has_gpu")))
        # where the worker's stdout/stderr land on its node — the
        # LOG_FETCH entity resolution (worker/actor/task → file)
        w.log_file = str(p.get("log_file") or "")
        if w.log_file:
            self._worker_log_src[wid] = {
                "node": nid,
                "path": w.log_file,
                "src": os.path.basename(w.log_file),
            }
            if len(self._worker_log_src) > 8192:
                self._worker_log_src.pop(next(iter(self._worker_log_src)))
        if p.get("direct_addr"):
            # worker binds wildcard; its node's transfer address carries
            # the routable host (same derivation as actor direct addrs)
            host = str(node.transfer_addr or "127.0.0.1:0").rsplit(":", 1)[0]
            port = str(p["direct_addr"]).rsplit(":", 1)[-1]
            w.direct_addr = f"{host or '127.0.0.1'}:{port}"
        self.workers[wid] = w
        node.workers[wid] = w
        node.mark_idle(w)
        node.starting_workers = max(0, node.starting_workers - 1)
        self._conn_kind[cid] = "worker"
        self._conn_worker[cid] = wid
        self._kick_scheduler()
        return {
            "ok": True,
            "store_path": node.store_path,
            "shard_addrs": self.shard_addrs,
        }

    async def h_register_driver(self, cid, conn, p):
        self._conn_kind[cid] = "driver"
        job_id = p.get("job_id", b"")
        # job-scoped log streaming: this driver's "logs" subscription only
        # receives records stamped with ITS job (or stamp-free lines)
        self._conn_job[cid] = job_id
        self.jobs[job_id] = {"started_at": time.time(), "driver_pid": p.get("pid", 0)}
        self._wal("job", job_id, self.jobs[job_id])
        self._mark_tables_dirty()
        self._worker_env.update(p.get("worker_env") or {})
        return {
            "ok": True,
            "store_path": self.nodes[self.head_node_id].store_path,
            "node_id": self.head_node_id,
            "shard_addrs": self.shard_addrs,
        }

    async def h_heartbeat(self, cid, conn, p):
        self._last_beat[cid] = time.time()
        # raylet beats piggyback their node's shm-store occupancy so the
        # head can aggregate cluster memory without an extra RPC plane
        store = p.get("store")
        if store and p.get("node_id") is not None:
            node = self.nodes.get(bytes(p["node_id"]))
            if node is not None:
                node.store_stats = {
                    str(k): float(v) for k, v in store.items()
                }
        return {"ok": True, "t": time.time()}

    async def _failure_detector_loop(self):
        """Missed-beat expiry for raylets and workers: TCP staying open is
        not liveness — a SIGSTOPped process holds its socket forever.
        Analog: reference GcsHeartbeatManager (gcs_heartbeat_manager.h,
        30 missed beats ⇒ dead per ray_config_def.h:56-59)."""
        period = RayConfig.heartbeat_period_ms / 1000.0
        window = period * RayConfig.num_heartbeats_timeout
        while not self._shutdown:
            await asyncio.sleep(period)
            if self._recovery is not None:
                continue  # grace window: peers are mid-redial, not dead
            now = time.time()
            for cid, kind in list(self._conn_kind.items()):
                if kind not in ("raylet", "worker"):
                    continue
                last = self._last_beat.get(cid)
                if last is None:
                    self._last_beat[cid] = now  # grace from first sighting
                    continue
                if now - last <= window:
                    continue
                conn = self._conns.get(cid)
                # a peer that REATTACHed on a newer conn leaves this cid's
                # mappings stale until the old socket EOFs: drop them
                # without reaping the (live, beating-elsewhere) peer
                peer = (
                    self.nodes.get(self._conn_node.get(cid, b""))
                    if kind == "raylet"
                    else self.workers.get(self._conn_worker.get(cid, b""))
                )
                if peer is not None and peer.conn is not conn:
                    self._conn_kind.pop(cid, None)
                    self._conn_node.pop(cid, None)
                    self._conn_worker.pop(cid, None)
                    self._last_beat.pop(cid, None)
                    if conn is not None:
                        conn.close()
                    continue
                if kind == "raylet":
                    nid = self._conn_node.get(cid)
                    logger.warning(
                        "node %s missed heartbeats for %.1fs — declaring dead",
                        nid.hex()[:8] if nid else "?",
                        now - last,
                    )
                    self._conn_kind.pop(cid, None)
                    self._conn_node.pop(cid, None)
                    if nid:
                        await self._on_node_dead(nid)
                else:
                    wid = self._conn_worker.get(cid)
                    logger.warning(
                        "worker %s missed heartbeats for %.1fs — declaring dead",
                        wid.hex()[:8] if wid else "?",
                        now - last,
                    )
                    self._conn_kind.pop(cid, None)
                    self._conn_worker.pop(cid, None)
                    if wid:
                        await self._on_worker_dead(
                            wid, f"missed heartbeats for {now - last:.1f}s"
                        )
                self._last_beat.pop(cid, None)
                if conn is not None:
                    conn.close()

    async def _on_node_dead(self, nid: bytes):
        node = self.nodes.get(nid)
        if node is None or not node.alive:
            return
        node.alive = False
        logger.warning("node %s died", nid.hex()[:8])
        for wid in list(node.workers):
            await self._on_worker_dead(wid, "node died")
        # strip PG bundles on the dead node
        for pg in self.pgs.values():
            for i, bn in enumerate(pg.bundle_nodes):
                if bn == nid:
                    pg.bundle_nodes[i] = None
                    pg.state = "RESCHEDULING"
        del self.nodes[nid]
        self.sched.remove_node(nid)
        # its object copies are gone with its store segment
        for oid, locs in list(self.object_locations.items()):
            if nid in locs:
                locs.discard(nid)
                if not locs:
                    del self.object_locations[oid]
                self._wal_locs(oid)
        await self._publish("node", {"event": "dead", "node_id": nid})
        self._record_event("ERROR", "node", "node died", node_id=nid.hex())
        self._kick_scheduler()

    # ---------------------------------------------------- lifecycle: workers

    def _release_dead_pins(self, w, node):
        """Drop the pins the dead worker's process held in its node's store,
        once the process is gone, so that blocks deleted while it pinned
        them (or after) are freed (plasma drops a client's pins when its
        connection goes): the head's own store directly, a raylet's by
        directive."""
        if not w.pid:
            return
        if w.node_id == self.head_node_id:
            from ray_tpu_torch.core.shm_store import release_pins_when_gone

            async def _release():
                n = await release_pins_when_gone(self._store, w.pid)
                if n:
                    logger.info("dropped %d store pins of dead worker pid %d", n, w.pid)

            asyncio.get_running_loop().create_task(_release())
        elif node is not None and node.conn is not None:
            asyncio.get_running_loop().create_task(
                node.conn.send(MsgType.PUSH_TASK, {"directive": "release_pins", "pid": w.pid})
            )

    async def _on_worker_dead(self, wid: bytes, reason: str):
        w = self.workers.pop(wid, None)
        if w is None:
            return  # already processed (node death then conn drop re-reports)
        self._record_event("WARNING", "worker", f"worker died: {reason}", worker_id=wid.hex())
        node = self.nodes.get(w.node_id)
        if node:
            node.forget_worker(w)
        # a leased worker's death releases the lease's resource hold (the
        # holder notices the conn loss itself and re-routes via the head)
        if w.lease is not None:
            self._release_lease(w, node, reason="worker died")
        logger.info("worker %s dead: %s", wid.hex()[:8], reason)
        # if the process is actually still alive (e.g. declared dead because
        # its node was removed), cut its head connection so it exits instead
        # of lingering as a zombie reporter
        try:
            if w.conn is not None:
                w.conn.close()
        except Exception:  # noqa: BLE001
            logger.debug("closing dead worker connection failed", exc_info=True)
        self._release_dead_pins(w, node)
        # fail or retry its running tasks
        for tid in list(w.running_tasks):
            entry = self.tasks.pop(tid, None)
            if entry is None:
                continue
            # only normal tasks hold node resources while running; actor
            # method calls run on the actor's lifetime reservation
            if (
                node
                and entry.state == "RUNNING"
                and not entry.blocked
                and entry.spec.task_type == NORMAL_TASK
            ):
                self._release_task_resources(node, entry.spec)
            if entry.spec.task_type == ACTOR_CREATION_TASK:
                # actor FSM handles restart/destroy below; balance the
                # submit-time pin here (the restart path re-pins)
                self._unpin_args(entry.spec)
                continue
            if entry.spec.task_type == ACTOR_TASK:
                actor = self.actors.get(entry.spec.actor_id)
                if actor is not None and actor.state == ACTOR_PREEMPTED:
                    # graceful preemption: the save fence held the actor
                    # lock, so this pushed call never entered user code —
                    # requeue it for the respawn exactly like a call that
                    # arrives one RPC later, instead of surfacing a policy
                    # eviction to the caller as a WorkerCrashedError
                    actor.pending_calls.append(entry.spec)
                    continue
            if entry.preempted:
                # policy kill, not a fault: requeue on the preemption
                # budget, never the retry budget — and when THAT budget is
                # spent, seal a typed PreemptedError so callers can tell
                # "evicted for more important work" from a crash
                entry.preempted = False
                entry.preempt_count += 1
                budget = (
                    entry.spec.max_preemptions
                    if entry.spec.max_preemptions >= 0
                    else RayConfig.task_preemption_budget
                )
                if entry.preempt_count <= budget:
                    entry.state = "QUEUED"
                    entry.worker_id = None
                    entry.node_id = None
                    entry.enqueued_at = time.time()
                    self.tasks[tid] = entry
                    self.task_queue.append(entry)
                    logger.info(
                        "requeueing preempted task %s (preemption %d/%d)",
                        entry.spec.function_name,
                        entry.preempt_count,
                        budget,
                    )
                else:
                    self._unpin_args(entry.spec)
                    await self._seal_error_objects(
                        entry.spec,
                        f"PreemptedError: preempted by higher-priority work "
                        f"(attempt {entry.preempt_count}/{budget})",
                    )
                continue
            if entry.spec.retries_left > 0:
                entry.spec.retries_left -= 1
                entry.state = "QUEUED"
                entry.worker_id = None
                # fresh queue-wait clock: a long-RUNNING task's crash must
                # not instantly qualify it for the starvation boost
                entry.enqueued_at = time.time()
                self.tasks[tid] = entry  # stays tracked across the retry
                self.task_queue.append(entry)
                logger.info("retrying task %s (%d retries left)", entry.spec.function_name, entry.spec.retries_left)
            else:
                self._unpin_args(entry.spec)
                await self._seal_error_objects(
                    entry.spec,
                    f"WorkerCrashedError: worker died while running "
                    f"{entry.spec.function_name or entry.spec.method_name}: {reason}",
                )
        # actor hosted on this worker?
        if w.actor_id is not None:
            actor = self.actors.get(w.actor_id)
            if actor is not None:
                await self._on_actor_worker_dead(actor, reason)
        self._retire_worker_metrics(wid)
        self._kick_scheduler()

    def _retire_worker_metrics(self, wid: bytes):
        """Fold a dead worker's per-process metric series into one durable
        ``:retired`` series per (metric, tags) and drop the per-worker
        keys — without this, worker churn grows the metrics: namespace
        (and every scrape payload) by one immortal record per dead
        process.  Counters and histograms keep their totals; a dead
        worker's gauge is a stale point-in-time reading and dies with it."""
        import json as _json

        from ray_tpu_torch.util import metrics as metrics_mod

        suffix = ":" + wid.hex()[:12]
        for key in [
            k for k in self.kv if k.startswith("metrics:") and k.endswith(suffix)
        ]:
            blob = self.kv.pop(key)
            try:
                rec = _json.loads(blob)
            except (ValueError, TypeError):
                continue
            if rec.get("kind") == "gauge":
                continue
            rkey = key[: -len(suffix)] + ":retired"
            cur_blob = self.kv.get(rkey)
            if cur_blob is not None:
                try:
                    cur = _json.loads(cur_blob)
                    metrics_mod.merge_records(cur, rec)
                    rec = cur
                except (ValueError, TypeError):
                    pass  # corrupt retired record: replace it outright
            self.kv[rkey] = _json.dumps(rec).encode()

    async def _on_actor_worker_dead(self, actor: ActorInfo, reason: str):
        if actor.state == ACTOR_DEAD:
            return
        node = self.nodes.get(actor.node_id) if actor.node_id else None
        if node:
            # a death MID-CREATION still holds the implicit creation CPU
            self._release_creation_cpu(actor, node, actor.creation_spec)
            node.release(self._actor_lifetime_resources(actor.creation_spec))
        # crash forensics: snapshot the victim's recent lines NOW — the
        # worker binding is cleared just below, after which neither
        # _destroy_actor here nor a later exhausted-restart death can
        # resolve worker → log file
        actor.death_log_tail = (
            self._with_log_tail(actor.worker_id) or actor.death_log_tail
        )
        actor.worker_id = None
        actor.node_id = None
        actor.direct_addr = ""
        # the death event is where a preemption reservation ends: the
        # forced-escalation path keeps the actor reserved in _preempting
        # until here so a concurrent victim scan can't re-preempt the
        # ALIVE-again actor and turn a budget-charged fault kill into an
        # uncharged graceful park
        self._preempting.discard(actor.actor_id)
        if actor.state == ACTOR_PREEMPTED:
            # policy eviction, checkpoint already saved: park until
            # capacity returns (the scheduler loop re-admits) — the
            # fault-restart budget is NOT charged; this death is the
            # graceful release the preemption protocol asked for
            actor.creation_cpu_released = False
            self._preempted_parked.setdefault(actor.actor_id, time.time())
            self._actor_mirror.upsert(
                actor.actor_id, state=ACTOR_PREEMPTED, direct_addr=""
            )
            self._record_event(
                "WARNING",
                "preempt",
                "actor preempted: checkpointed and released; parked for "
                "re-admission",
                actor_id=actor.actor_id.hex(),
            )
            await self._publish(
                "actor", {"actor_id": actor.actor_id, "state": ACTOR_PREEMPTED}
            )
            self._kick_scheduler()
            return
        if actor.restarts_used < actor.max_restarts or actor.max_restarts == -1:
            actor.restarts_used += 1
            self._requeue_actor_creation(actor)
            logger.info(
                "restarting actor %s (%d/%s)",
                actor.actor_id.hex()[:8],
                actor.restarts_used,
                actor.max_restarts,
            )
            self._record_event(
                "WARNING",
                "actor",
                f"actor restarting ({actor.restarts_used}/{actor.max_restarts})",
                actor_id=actor.actor_id.hex(),
            )
            await self._publish("actor", {"actor_id": actor.actor_id, "state": ACTOR_RESTARTING})
        else:
            # terminal: the death cause carries the restart accounting so
            # the client-side RayActorError says HOW the budget was spent,
            # not just that the actor is gone
            await self._destroy_actor(
                actor,
                f"{reason} (restarts exhausted: "
                f"{actor.restarts_used}/{actor.max_restarts})",
            )
        self._kick_scheduler()

    def _requeue_actor_creation(self, actor: ActorInfo):
        """Queue a fresh creation incarnation through the restart FSM —
        shared by fault restarts and preemption re-admission so the two
        paths cannot drift.  The new incarnation acquires CPU afresh, and
        args are re-pinned exactly like a fresh submit: the restarted
        creation task's h_task_done will unpin again (without this,
        restart underflows the arg refcounts and deletes live objects)."""
        actor.state = ACTOR_RESTARTING
        self._actor_mirror.upsert(
            actor.actor_id, state=ACTOR_RESTARTING, direct_addr=""
        )
        actor.creation_cpu_released = False
        spec = actor.creation_spec
        self._pin_args(spec)
        entry = TaskEntry(spec, -1)
        self.tasks[spec.task_id] = entry
        self.task_queue.append(entry)

    async def _destroy_actor(self, actor: ActorInfo, reason: str):
        if actor.detached:
            self._wal("dactor", bytes(actor.actor_id), None)
            self._mark_tables_dirty()
        if actor.state == ACTOR_DEAD:
            return
        # a destroy racing a preemption wins: drop the parking-lot entry
        # (no respawn), the in-flight reservation, and the saved
        # checkpoint (nobody will restore it)
        self._preempted_parked.pop(actor.actor_id, None)
        self._preempting.discard(actor.actor_id)
        ckpt_key = f"actor_ckpt:{actor.actor_id.hex()}"
        if ckpt_key in self.kv:
            del self.kv[ckpt_key]
            self._wal("kv", ckpt_key, None)
        actor.state = ACTOR_DEAD
        actor.death_cause = reason
        # crash forensics: snapshot the victim worker's recent lines
        # (the ring keeps rolling for the worker's successor); a worker-
        # death path already snapshotted in _on_actor_worker_dead before
        # it cleared the binding — keep that copy.  Every seal of this
        # actor's calls — current and future — carries the tail.
        if not actor.death_log_tail:
            actor.death_log_tail = self._with_log_tail(actor.worker_id)
        if not reason.startswith(("ray.kill", "owner driver")):
            # intentional teardown is not an error; faults and exhausted
            # restart budgets are
            tail_lines: List[str] = []
            if actor.death_log_tail:
                import json as _json

                try:
                    tail_lines = _json.loads(
                        actor.death_log_tail[len(_log_plane.LOG_TAIL_MARKER) :]
                    )
                except (ValueError, TypeError):
                    tail_lines = []
            self._note_error_record(
                {
                    "signature": (
                        f"ActorDeath:{actor.creation_spec.name}:"
                        f"{reason.split('(')[0].strip()[:120]}"
                    ),
                    "kind": "actor_death",
                    "exc_type": "ActorDiedError",
                    "message": reason,
                    "name": actor.creation_spec.name,
                    "actor_id": actor.actor_id.hex(),
                    "node_id": actor.node_id.hex() if actor.node_id else "",
                    "log_tail": tail_lines,
                }
            )
        self._actor_mirror.upsert(
            actor.actor_id, state=ACTOR_DEAD, death_cause=reason, direct_addr=""
        )
        logger.info("actor %s dead: %s", actor.actor_id.hex()[:8], reason)
        self._record_event("ERROR", "actor", f"actor dead: {reason}", actor_id=actor.actor_id.hex())
        if actor.name:
            self.named_actors.pop((actor.namespace, actor.name), None)
            self._actor_mirror.drop_name(actor.namespace, actor.name)
        # fail queued calls
        for spec in actor.pending_calls:
            self._unpin_args(spec)
            await self._seal_error_objects(
                spec, f"RayActorError: {reason}{actor.death_log_tail}"
            )
        actor.pending_calls.clear()
        # drop queued creation / calls in the scheduler queue (balancing
        # their submit-time arg pins)
        dropped = [e for e in self.task_queue if e.spec.actor_id == actor.actor_id]
        self.task_queue = [
            e
            for e in self.task_queue
            if not (e.spec.actor_id == actor.actor_id)
        ]
        for e in dropped:
            self.tasks.pop(e.spec.task_id, None)
            self._unpin_args(e.spec)
        if actor.worker_id:
            w = self.workers.get(actor.worker_id)
            if w is not None:
                w.actor_id = None
                # reaches remote hosts too (raylet kill_worker directive)
                self._kill_worker_process(w, 15)
            node = self.nodes.get(actor.node_id) if actor.node_id else None
            if node:
                self._release_creation_cpu(actor, node, actor.creation_spec)
                node.release(self._actor_lifetime_resources(actor.creation_spec))
            actor.worker_id = None
        await self._publish("actor", {"actor_id": actor.actor_id, "state": ACTOR_DEAD, "reason": reason})

    # --------------------------------------------------------------- objects

    def _object_entry(self, oid: bytes) -> List:
        e = self.objects.get(oid)
        if e is None:
            e = [PENDING, None]
            self.objects[oid] = e
        return e

    async def _seal_object(self, oid: bytes):
        e = self._object_entry(oid)
        e[0] = SEALED
        self._obj_mirror.seal(oid)  # wake shard-side waiters too
        self._wal("seal", bytes(oid))
        for fut in self.object_waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(e)

    async def _seal_error_objects(self, spec: TaskSpec, error: str):
        """Mark every return object of a failed task as errored; waiters get
        the error string and raise client-side."""
        for oid in spec.return_object_ids():
            e = self._object_entry(oid)
            e[0] = ERRORED
            e[1] = error
            self._obj_mirror.error(oid, error)
            for fut in self.object_waiters.pop(oid, []):
                if not fut.done():
                    fut.set_result(e)

    def _add_location(self, oid: bytes, node_id: Optional[bytes]):
        # only live nodes can serve copies; a zombie worker on a removed
        # node must not pollute the directory
        if node_id and bytes(node_id) in self.nodes:
            self.object_locations.setdefault(oid, set()).add(bytes(node_id))
            self._wal_locs(oid)

    async def h_put_object(self, cid, conn, p):
        nid = p.get("node_id")
        if nid is None:
            nid = self._conn_node.get(cid) or self.head_node_id
        oid = bytes(p["object_id"])
        self._pin_contained(oid, p.get("contained") or [])
        self._record_object_meta(cid, oid, p.get("nbytes"))
        self._add_location(p["object_id"], nid)
        await self._seal_object(p["object_id"])
        return {"ok": True}

    def _record_object_meta(self, cid: int, oid: bytes, nbytes, tier: str = "shm") -> None:
        """Object-accounting sidecar for `ray-tpu summary memory`: who
        sealed it (derived from the sealing connection — workers by id,
        drivers/clients by kind), how big it is, and which tier holds it."""
        wid = self._conn_worker.get(cid)
        owner = (
            bytes(wid).hex()[:12]
            if wid
            else (self._conn_kind.get(cid) or "head")
        )
        self.object_meta[oid] = {
            "owner": owner,
            "nbytes": int(nbytes or 0),
            "tier": tier,
        }

    def _pin_contained(self, oid: bytes, contained: List[bytes]):
        """Pin the refs pickled inside a stored object for the container's
        lifetime (released in _dec_ref/free when the container is deleted).
        A re-seal with the same ids (eviction refetch) is a no-op; a re-seal
        with different ids (reconstruction re-ran the producer, whose inner
        put ids differ) replaces the old pins with the new ones."""
        inner = [bytes(i) for i in contained]
        prev = self.object_contained.get(oid)
        if prev == inner or (prev is None and not inner):
            return
        if inner:
            self.object_contained[oid] = inner
            for iid in inner:
                self.object_refcounts[iid] = self.object_refcounts.get(iid, 0) + 1
        else:
            self.object_contained.pop(oid, None)
        if prev:
            for iid in prev:
                self._dec_ref(iid)

    def _release_contained(self, oid: bytes):
        for iid in self.object_contained.pop(oid, ()):  # recursive via _dec_ref
            self._dec_ref(iid)

    async def _ensure_object_local(
        self, oid: bytes, dest_nid: bytes, timeout: Optional[float] = None
    ) -> Optional[str]:
        """Make a sealed object present on dest node; returns None on
        success, "__timeout__" if `timeout` lapsed (transfer continues in
        the background), or an error string.  Pulls coalesce per (oid,
        dest) and run as their own task so a timed-out waiter never cancels
        the transfer for other waiters."""
        locs = self.object_locations.get(oid)
        if not locs and oid in self.object_spilled:
            # only durable copy is a spill file: restore it into its node's
            # shm first, then transfer normally
            err = await self._restore_spilled(oid)
            if err is not None:
                return err
            locs = self.object_locations.get(oid)
        if not locs:
            return f"ObjectLostError: {oid.hex()[:16]} sealed but no live copy"
        if dest_nid in locs:
            return None
        key = (oid, dest_nid)
        task = self._pull_inflight.get(key)
        if task is None:

            async def _run():
                try:
                    return await self._pull_to_node(oid, dest_nid)
                except Exception as e:  # noqa: BLE001
                    logger.warning(
                        "pull of %s to node %s failed: %s",
                        oid.hex()[:16],
                        dest_nid.hex()[:8],
                        e,
                    )
                    return f"transfer failed: {e}"
                finally:
                    self._pull_inflight.pop(key, None)

            task = asyncio.get_running_loop().create_task(_run())
            self._pull_inflight[key] = task
        try:
            return await asyncio.wait_for(asyncio.shield(task), timeout)
        except asyncio.TimeoutError:
            return "__timeout__"

    async def _pull_to_node(self, oid: bytes, dest_nid: bytes) -> Optional[str]:
        """One logical pull = a bounded, backoff-disciplined sequence of
        attempts.  Transfer failures against LIVE sources retry with full
        jitter (a restarting transfer agent or an injected wire fault must
        not immediately escalate to lineage reconstruction); "no live
        copy" is not retried — that is reconstruction's job.  The caller's
        deadline still bounds the whole sequence via _ensure_object_local's
        wait_for."""
        # config counts TOTAL pull rounds; Backoff.max_attempts counts
        # retries (delays granted), hence the -1
        total_rounds = max(1, RayConfig.object_pull_attempts)
        backoff = chaos.Backoff(base=0.1, cap=2.0, max_attempts=total_rounds - 1)
        while True:
            err = await self._pull_to_node_once(oid, dest_nid)
            if err is None or not err.startswith("ObjectLostError"):
                return err
            # a spill may have raced the pull (the holder deleted its shm
            # copy and its SPILL_NOTIFY is in flight): give the notify a
            # beat, then restore-and-retry before declaring the object lost
            await asyncio.sleep(0.3)
            if oid in self.object_spilled:
                rerr = await self._restore_spilled(oid)
                if rerr is None:
                    if dest_nid in self.object_locations.get(oid, ()):
                        return None
                    err2 = await self._pull_to_node_once(oid, dest_nid)
                    if err2 is None:
                        return None
                    err = err2
            if "no live copy" in err:
                return err
            delay = backoff.next_delay()
            if delay is None:
                return err
            logger.info(
                "pull of %s to %s failed (%s); retrying in %.2fs "
                "(round %d/%d)",
                oid.hex()[:16],
                dest_nid.hex()[:8],
                err,
                delay,
                backoff.attempt + 1,
                total_rounds,
            )
            await asyncio.sleep(delay)

    async def _pull_to_node_once(self, oid: bytes, dest_nid: bytes) -> Optional[str]:
        last_err = "no live copy"
        for src_nid in list(self.object_locations.get(oid, ())):
            src = self.nodes.get(src_nid)
            if src is None or not src.alive or not src.transfer_addr:
                continue
            if dest_nid == self.head_node_id:
                try:
                    ok = await asyncio.wait_for(
                        self.object_agent.pull(oid, src.transfer_addr), timeout=300
                    )
                except Exception as e:  # graftlint: disable=silent-except -- captured into last_err, surfaced as the ObjectLostError below
                    ok, last_err = False, f"{type(e).__name__}: {e}"
                if ok:
                    self._add_location(oid, dest_nid)
                    return None
            else:
                dest = self.nodes.get(dest_nid)
                if dest is None or dest.conn is None:
                    return f"destination node {dest_nid.hex()[:8]} gone"
                try:
                    reply = await dest.conn.request(
                        MsgType.OBJECT_PULL,
                        {"object_id": oid, "src_addr": src.transfer_addr},
                        timeout=310,
                    )
                except Exception as e:  # graftlint: disable=silent-except -- captured into last_err via the reply dict, surfaced as ObjectLostError
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if reply.get("ok"):
                    self._add_location(oid, dest_nid)
                    return None
                last_err = reply.get("error", "pull refused")
        return f"ObjectLostError: transfer of {oid.hex()[:16]} failed: {last_err}"

    async def h_wait_object(self, cid, conn, p):
        if "object_ids" in p:
            return await self._wait_batch(p)
        oid = p["object_id"]
        timeout = p.get("timeout")
        deadline = time.time() + timeout if timeout is not None else None
        dest_nid = bytes(p["node_id"]) if p.get("node_id") is not None else None
        if p.get("evicted") and dest_nid is not None:
            # client found the object missing from its local store after a
            # sealed reply: that location is stale (LRU-evicted)
            locs = self.object_locations.get(oid)
            if locs is not None:
                locs.discard(dest_nid)
                if not locs:
                    del self.object_locations[oid]
                self._wal_locs(oid)
        while True:
            e = self._object_entry(oid)
            if e[0] == PENDING:
                fut = asyncio.get_running_loop().create_future()
                self.object_waiters.setdefault(oid, []).append(fut)
                rem = None if deadline is None else max(0.001, deadline - time.time())
                try:
                    await asyncio.wait_for(fut, rem)
                except asyncio.TimeoutError:
                    return {"state": "timeout"}
            e = self.objects[oid]
            if e[0] == ERRORED:
                return {"state": "error", "error": e[1]}
            if dest_nid is None:
                return {"state": "sealed"}
            # cross-node data plane: fetch the object onto the waiter's node
            # within what's left of the caller's deadline
            rem = None if deadline is None else max(0.001, deadline - time.time())
            err = await self._ensure_object_local(oid, dest_nid, timeout=rem)
            if err is None:
                return {"state": "sealed"}
            if err == "__timeout__":
                return {"state": "timeout"}
            if not err.startswith("ObjectLostError"):
                # dest-side or unexpected transfer error while source copies
                # may be healthy: report it, do NOT wipe valid locations
                return {"state": "error", "error": err}
            # every copy is gone (eviction / node loss): lineage recovery
            # (analog: reference object_recovery_manager.h:90), then loop
            # back to wait for the re-executed task to seal
            self.object_locations.pop(oid, None)
            self._wal_locs(oid)
            rec_err = self._reconstruct_object(oid)
            if rec_err is not None:
                return {"state": "error", "error": err + "; " + rec_err}

    async def _wait_batch(self, p):
        """Server-side ray.wait: block until num_ready of the ids are
        sealed/errored or the timeout passes (analog: reference
        WaitManager, src/ray/raylet/wait_manager.cc).

        Waiter futures register ONCE per pending oid; each round only
        counts completions — re-registering per wake made a 10k-ref wait
        O(N²) in future churn (measured as the 10k-queued drain wall)."""
        oids = [bytes(o) for o in p["object_ids"]]
        want = min(p.get("num_ready", len(oids)), len(oids))
        timeout = p.get("timeout")
        deadline = time.time() + timeout if timeout is not None else None
        n_ready = sum(1 for o in oids if self._object_entry(o)[0] != PENDING)
        registered: List[Tuple[bytes, Any]] = []
        try:
            if n_ready < want and (deadline is None or time.time() < deadline):
                loop = asyncio.get_running_loop()
                # counter + ONE event instead of asyncio.wait over the
                # future set: asyncio.wait re-arms a done-callback on every
                # remaining future per wake — O(N²) churn across a 10k-ref
                # get() (measured ~1.2M future callback ops per 3k drain)
                ev = asyncio.Event()
                state = {"done": 0}

                def _on_done(_f):
                    state["done"] += 1
                    ev.set()

                for o in oids:
                    if self._object_entry(o)[0] == PENDING:
                        f = loop.create_future()
                        f.add_done_callback(_on_done)
                        self.object_waiters.setdefault(o, []).append(f)
                        registered.append((o, f))
                while n_ready + state["done"] < want and state["done"] < len(registered):
                    rem = None if deadline is None else max(0.001, deadline - time.time())
                    if deadline is not None and time.time() >= deadline:
                        break
                    ev.clear()
                    try:
                        await asyncio.wait_for(ev.wait(), rem)
                    except asyncio.TimeoutError:
                        break
            return {"ready": [o for o in oids if self._object_entry(o)[0] != PENDING]}
        finally:
            for o, f in registered:
                if not f.done():
                    f.remove_done_callback(_on_done)
                    f.cancel()
                lst = self.object_waiters.get(o)
                if lst is not None:
                    try:
                        lst.remove(f)
                    except ValueError:
                        pass
                    if not lst:
                        self.object_waiters.pop(o, None)

    def _delete_everywhere(self, oid: bytes):
        """Drop all copies: head store directly, remote nodes by directive
        (including any spill file)."""
        locs = self.object_locations.pop(oid, set())
        self._wal("obj-", bytes(oid))
        for nid in locs:
            if nid == self.head_node_id:
                self._store.delete(oid)
            else:
                node = self.nodes.get(nid)
                if node is not None and node.conn is not None:
                    asyncio.get_running_loop().create_task(
                        node.conn.send(MsgType.OBJECT_DELETE, {"object_ids": [oid]})
                    )
        spilled = self.object_spilled.pop(oid, None)
        if spilled is not None:
            snid, path = spilled
            if snid == self.head_node_id:
                from ray_tpu_torch.raylet.spill import delete_spilled

                delete_spilled(path)
            else:
                node = self.nodes.get(snid)
                if node is not None and node.conn is not None:
                    asyncio.get_running_loop().create_task(
                        node.conn.send(
                            MsgType.OBJECT_DELETE,
                            {"object_ids": [], "spill_paths": [path]},
                        )
                    )
        # even with no recorded location (pre-location legacy puts), try head
        if not locs:
            self._store.delete(oid)

    # --------------------------------------------------------------- spilling

    async def h_client_put(self, cid, conn, p):
        """Remote driver (Ray-Client mode) put: the payload rode the
        control connection; store it in the head node's store and seal
        (reference analog: util/client dataclient put)."""
        from ray_tpu_torch._private.serialization import SerializedObject

        oid = bytes(p["object_id"])
        sobj = SerializedObject.from_wire(p["value"])
        await asyncio.get_running_loop().run_in_executor(
            None, self._store.put_serialized, oid, sobj
        )
        self._pin_contained(oid, p.get("contained") or [])
        self._add_location(oid, self.head_node_id)
        await self._seal_object(oid)
        return {"ok": True}

    async def h_client_get(self, cid, conn, p):
        """Remote driver get: wait for seal, pull the object to the head
        node, return the payload over the control connection."""
        oid = bytes(p["object_id"])
        reply = await self.h_wait_object(
            cid,
            conn,
            {"object_id": oid, "timeout": p.get("timeout"), "node_id": self.head_node_id},
        )
        if reply.get("state") != "sealed":
            return reply
        sobj = await asyncio.get_running_loop().run_in_executor(
            None, self._store.get_serialized, oid
        )
        if sobj is None:
            return {"state": "error", "error": f"ObjectLostError: {oid.hex()[:16]}"}
        return {"state": "sealed", "value": sobj.to_wire()}

    async def h_spill_notify(self, cid, conn, p):
        """A store claimant on `node_id` moved these objects to its disk
        (ray_tpu_torch/raylet/spill.py); record the spill locations and drop the
        now-gone shm locations (reference analog: spilled-URL updates to
        the owner, raylet/local_object_manager.h)."""
        nid = bytes(p["node_id"]) if p.get("node_id") else self.head_node_id
        self._record_spills(nid, {bytes(k): v for k, v in (p.get("spilled") or {}).items()})
        return {"ok": True}

    def _record_spills(self, nid: bytes, spilled: Dict[bytes, str]):
        if spilled:
            self._record_event(
                "INFO", "spill", f"spilled {len(spilled)} objects", node_id=nid.hex()
            )
        for oid, path in spilled.items():
            self.object_spilled[oid] = (nid, path)
            self._wal("spill", bytes(oid), (nid, path))
            locs = self.object_locations.get(oid)
            if locs is not None:
                locs.discard(nid)
                if not locs:
                    del self.object_locations[oid]
            self._wal_locs(oid)

    async def _restore_spilled(self, oid: bytes) -> Optional[str]:
        """Bring a spilled object back into its node's shm store."""
        snid, path = self.object_spilled.get(oid, (None, None))
        if snid is None:
            return f"ObjectLostError: {oid.hex()[:16]} has no spilled copy"
        if snid == self.head_node_id:
            from ray_tpu_torch.raylet.spill import delete_spilled, restore_object

            def _restore_and_clean():
                ok = restore_object(self._store, oid, path)
                if ok:
                    delete_spilled(path)  # back in shm; don't leak the file
                return ok

            ok = await asyncio.get_running_loop().run_in_executor(
                None, _restore_and_clean
            )
        else:
            node = self.nodes.get(snid)
            if node is None or node.conn is None or not node.alive:
                return (
                    f"ObjectLostError: spill node {snid.hex()[:8]} for "
                    f"{oid.hex()[:16]} is gone"
                )
            try:
                reply = await node.conn.request(
                    MsgType.OBJECT_RESTORE,
                    {"object_id": oid, "path": path},
                    timeout=300,
                )
                ok = bool(reply.get("ok"))
            except Exception:  # noqa: BLE001
                logger.warning(
                    "restore RPC for spilled object %s failed",
                    oid.hex()[:16],
                    exc_info=True,
                )
                ok = False
        if not ok:
            return f"ObjectLostError: restore of {oid.hex()[:16]} failed"
        self.object_spilled.pop(oid, None)
        self._wal("spill", bytes(oid), None)
        self._add_location(oid, snid)
        return None

    async def h_free_object(self, cid, conn, p):
        for oid in p["object_ids"]:
            self.objects.pop(oid, None)
            self._obj_mirror.drop(oid)
            self.object_meta.pop(bytes(oid), None)
            self._delete_everywhere(oid)
            self._release_contained(bytes(oid))
        return {"ok": True}

    def _ref_batch_seen(self, p) -> bool:
        """Dedupe re-sent ref flushes (head-FT: a conn loss may race the
        reply, so clients re-send tagged batches after reattach — counter
        bumps are not idempotent on their own)."""
        b = p.get("batch")
        if not b:
            return False
        b = bytes(b)
        if b in self._ref_batches:
            return True
        if len(self._ref_batches_fifo) == self._ref_batches_fifo.maxlen:
            self._ref_batches.discard(self._ref_batches_fifo[0])
        self._ref_batches_fifo.append(b)
        self._ref_batches.add(b)
        return False

    async def h_add_ref(self, cid, conn, p):
        if self._ref_batch_seen(p):
            return {"ok": True, "deduped": True}
        for oid in p["object_ids"]:
            self.object_refcounts[oid] = self.object_refcounts.get(oid, 0) + 1
        return {"ok": True}

    def _pin_args(self, spec: TaskSpec):
        """Bump refcounts of ARG_REF arguments AND refs nested inside
        inlined ARG_VALUE payloads (inverse of _unpin_args)."""
        for aid in self._arg_ref_ids(spec):
            self.object_refcounts[aid] = self.object_refcounts.get(aid, 0) + 1

    def _unpin_args(self, spec: TaskSpec):
        """Release the submit-time pins on ARG_REF + nested arguments
        (paired with the bump in h_submit_task)."""
        for aid in self._arg_ref_ids(spec):
            self._dec_ref(aid)

    @staticmethod
    def _arg_ref_ids(spec: TaskSpec) -> List[bytes]:
        ids = [bytes(arg[2]) for arg in spec.args if arg[0] == 1]  # ARG_REF
        ids.extend(bytes(i) for i in (spec.nested_refs or ()))
        return ids

    def _dec_ref(self, oid: bytes):
        if (
            self._refs_amnesic
            and oid not in self.object_refcounts
            and oid in self.objects
        ):
            # restarted head: this object's pre-crash client refs were
            # never re-announced — the count is UNKNOWN, not zero.  Keep
            # the object (leaks until job teardown) rather than deleting
            # data another peer still references.
            return
        n = self.object_refcounts.get(oid, 0) - 1
        if n <= 0:
            self.object_refcounts.pop(oid, None)
            # out of scope everywhere → evictable; delete eagerly
            self.objects.pop(oid, None)
            self._obj_mirror.drop(oid)
            self.object_meta.pop(oid, None)
            self._delete_everywhere(oid)
            # nobody can ever get() it again → its lineage is dead too
            self._drop_lineage(oid)
            self._reconstructions.pop(oid, None)
            # the deleted container no longer pins the refs inside it
            self._release_contained(oid)
        else:
            self.object_refcounts[oid] = n

    # --------------------------------------------------- lineage / recovery

    def _record_lineage(self, spec: TaskSpec, wire_size: int):
        """Remember the producing spec for each return object, pinning the
        spec's ref-args so reconstruction inputs can't be deleted while the
        lineage is held.  FIFO-evicted beyond lineage_max_bytes; the spec's
        size is charged once per task, not once per return."""
        charged = False
        for oid in spec.return_object_ids():
            if oid in self.lineage:
                charged = True  # already recorded for this task
                continue
            self.lineage[oid] = spec
            self._wal("lineage", bytes(oid), spec.to_wire())
            self._lineage_bytes[oid] = 0 if charged else wire_size
            if not charged:
                self._lineage_total += wire_size
                charged = True
            self._pin_args(spec)
        budget = RayConfig.lineage_max_bytes
        while self._lineage_total > budget and self.lineage:
            evict = next(iter(self.lineage))
            self._drop_lineage(evict)

    def _drop_lineage(self, oid: bytes):
        spec = self.lineage.pop(oid, None)
        if spec is None:
            return
        self._wal("lineage", bytes(oid), None)
        self._lineage_total -= self._lineage_bytes.pop(oid, 0)
        self._unpin_args(spec)

    def _reconstruct_object(self, oid: bytes) -> Optional[str]:
        """Queue re-execution of the producing task for a lost object.
        Returns None if reconstruction is underway, else an error string
        (analog: reference ObjectRecoveryManager::RecoverObject)."""
        spec = self.lineage.get(oid)
        if spec is None:
            return f"ObjectLostError: {oid.hex()[:16]} lost and no lineage retained"
        n = self._reconstructions.get(oid, 0)
        if n >= RayConfig.max_object_reconstructions:
            return (
                f"ObjectLostError: {oid.hex()[:16]} lost after "
                f"{n} reconstruction attempts"
            )
        # every return object of the re-executed task becomes pending again
        for roid in spec.return_object_ids():
            if not self.object_locations.get(roid):
                e = self._object_entry(roid)
                e[0] = PENDING
                e[1] = None
                self._obj_mirror.reset(roid)
        if spec.task_id not in self.tasks:
            # the attempt budget is consumed only by an actual re-execution —
            # concurrent waiters piggyback on the in-flight one for free
            self._reconstructions[oid] = n + 1
            logger.info(
                "reconstructing %s via re-execution of %s",
                oid.hex()[:16],
                spec.function_name,
            )
            # re-pin args exactly like a fresh submit (task_done unpins)
            self._pin_args(spec)
            entry = TaskEntry(spec, -1)
            self.tasks[spec.task_id] = entry
            self.task_queue.append(entry)
            self._kick_scheduler()
        return None

    async def h_remove_ref(self, cid, conn, p):
        if self._ref_batch_seen(p):
            return {"ok": True, "deduped": True}
        for oid in p["object_ids"]:
            self._dec_ref(oid)
        return {"ok": True}

    # ----------------------------------------------------------------- tasks

    async def h_submit_tasks(self, cid, conn, p):
        """Batched submit: a driver-side .remote() burst coalesced into one
        frame (reference analog: the lease-request batching the reference
        gets from per-scheduling-class lease pipelining)."""
        for wire in p["specs"]:
            await self.h_submit_task(cid, conn, {"spec": wire})
        return {"ok": True}

    async def h_submit_task(self, cid, conn, p):
        spec = TaskSpec.from_wire(p["spec"])
        if p.get("resubmit"):
            # post-reattach resubmission of an unacked submit: the task id
            # is the idempotency key — a submit that raced the crash must
            # never double-execute.  During the grace window the verdict
            # can't be final yet (its worker may still be mid-redial), so
            # the spec parks until reconciliation closes.
            if self._recovery is not None:
                self._recovery_resubmits.append((cid, p["spec"]))
                return {"ok": True, "parked": True}
            if self._resubmit_is_duplicate(spec):
                return {"ok": True, "deduped": True}
        # flight recorder: the phases dict is SHARED with p["spec"] (the
        # cached wire reused for PUSH_TASK), so this stamp reaches the
        # worker too.  None when the submitting driver has recording off —
        # that one check is the whole disabled-path cost here.
        if spec.phases is not None:
            spec.phases["head_enqueue"] = time.time()
        for oid in spec.return_object_ids():
            self._object_entry(oid)
        # pin ref-args until the task completes so an eager driver-side
        # del doesn't free an argument out from under the task
        self._pin_args(spec)
        if spec.task_type == ACTOR_TASK:
            return await self._submit_actor_task(spec)
        if spec.task_type == NORMAL_TASK:
            # cheap size estimate for the lineage budget (re-serializing the
            # spec on the submit hot path would double the encode cost)
            est = 256
            for a in spec.args:
                pay = a[2]
                if isinstance(pay, (bytes, bytearray, memoryview)):
                    est += len(pay)  # ARG_REF: object id
                elif isinstance(pay, (list, tuple)) and len(pay) == 3:
                    # ARG_VALUE wire form: [metadata, inband, buffers]
                    est += len(pay[1]) + sum(len(b) for b in pay[2])
                else:
                    est += 64
            self._record_lineage(spec, est)
        entry = TaskEntry(spec, cid, wire=p["spec"])
        self.tasks[spec.task_id] = entry
        self.task_queue.append(entry)
        self._kick_scheduler()
        return {"ok": True}

    async def _submit_actor_task(self, spec: TaskSpec):
        actor = self.actors.get(spec.actor_id)
        if actor is None:
            if self._recovery is not None:
                # the actor's worker may be mid-redial: park the call;
                # _finish_recovery re-runs it once the directory settles
                self._recovery_actor_calls.append(spec)
                return {"ok": True, "parked": True}
            self._unpin_args(spec)
            await self._seal_error_objects(spec, "RayActorError: unknown actor")
            return {"ok": False}
        if actor.state == ACTOR_DEAD:
            self._unpin_args(spec)
            await self._seal_error_objects(
                spec,
                f"RayActorError: {actor.death_cause or 'actor is dead'}"
                f"{actor.death_log_tail}",
            )
            return {"ok": False}
        if (
            actor.state in (ACTOR_PENDING, ACTOR_RESTARTING, ACTOR_PREEMPTED)
            or actor.worker_id is None
        ):
            # PREEMPTED queues too: a call racing the checkpoint/release
            # window must wait for the respawn, not land on a dying worker
            actor.pending_calls.append(spec)
            return {"ok": True, "queued": True}
        await self._push_actor_task(actor, spec)
        return {"ok": True}

    async def _push_actor_task(self, actor: ActorInfo, spec: TaskSpec):
        w = self.workers.get(actor.worker_id)
        if w is None:
            actor.pending_calls.append(spec)
            return
        if spec.phases is not None:
            # actor calls queue in pending_calls while the actor creates /
            # restarts; dispatch is stamped at the actual push so
            # queue_wait covers that wait, like scheduler queueing does
            # for normal tasks
            spec.phases["dispatch"] = time.time()
        entry = TaskEntry(spec, -1)
        entry.state = "RUNNING"
        entry.worker_id = w.worker_id
        entry.node_id = w.node_id
        self.tasks[spec.task_id] = entry
        w.running_tasks.add(spec.task_id)
        await w.conn.send(MsgType.PUSH_TASK, {"spec": spec.to_wire()})

    async def h_task_done(self, cid, conn, p):
        tid = p["task_id"]
        if p.get("replay"):
            # a reattached worker re-sends its recent completions (it
            # can't know which landed before the crash): apply at most once
            if bytes(tid) in self._recent_dones:
                return {"ok": True, "deduped": True}
        self._note_done(tid)
        wid = self._conn_worker.get(cid)
        w = self.workers.get(wid) if wid else None
        if wid is not None and w is None:
            # Zombie report: this worker was already declared dead (its node
            # was removed — SIGKILLed raylets don't reap their workers) and
            # its task has been retried or failed.  Sealing from here would
            # record data on a dead node's store segment; drop it and cut
            # the connection so the orphan exits.
            logger.info("dropping TASK_DONE from de-registered worker %s", wid.hex()[:8])
            conn.close()
            return {"ok": False, "stale": True}
        entry = self.tasks.pop(tid, None)
        if w is not None:
            w.running_tasks.discard(tid)
        self.finished_task_count += 1
        if p.get("exec_end"):
            entry_for_tl = entry  # tid was popped above; there is no fallback
            self.timeline.append(
                {
                    "name": (entry_for_tl.spec.function_name or entry_for_tl.spec.method_name)
                    if entry_for_tl
                    else "task",
                    "pid": w.pid if w else 0,
                    "ts": p.get("exec_start", 0.0),
                    "dur": p["exec_end"] - p.get("exec_start", p["exec_end"]),
                    "error": bool(p.get("error")),
                    # span chain when tracing is on (util/tracing.py)
                    "trace": (entry_for_tl.spec.trace_ctx or {}) if entry_for_tl else {},
                    # flight-recorder stamps → per-phase sub-spans in the
                    # chrome-trace export (h_timeline)
                    "phases": self._join_task_phases(p, entry_for_tl, w),
                    "task_id": bytes(tid).hex(),
                }
            )
        if entry is not None:
            self._unpin_args(entry.spec)
            spec = entry.spec
            node = self.nodes.get(entry.node_id) if entry.node_id else None
            if spec.task_type == NORMAL_TASK:
                if node and not entry.blocked:
                    self._release_task_resources(node, spec)
                if w is not None and not w.dedicated:
                    wnode = self.nodes.get(w.node_id)
                    if wnode is not None:
                        wnode.mark_idle(w)
                    else:
                        w.idle = True
                        w.idle_since = time.time()
            if spec.task_type == ACTOR_CREATION_TASK:
                # default-CPU actors give the creation CPU back once up
                # (or dead): running actors hold 0 CPU by default
                self._release_creation_cpu(self.actors.get(spec.actor_id), node, spec)
            if p.get("error") and spec.task_type == ACTOR_CREATION_TASK:
                actor = self.actors.get(spec.actor_id)
                if actor:
                    await self._destroy_actor(actor, f"creation failed: {p['error']}")
            elif spec.task_type == ACTOR_CREATION_TASK:
                actor = self.actors.get(spec.actor_id)
                if actor:
                    actor.state = ACTOR_ALIVE
                    # a restarted incarnation must not inherit the previous
                    # incarnation's death forensics
                    actor.death_log_tail = ""
                    self._actor_mirror.upsert(actor.actor_id, state=ACTOR_ALIVE)
                    await self._publish("actor", {"actor_id": actor.actor_id, "state": ACTOR_ALIVE})
                    # flush queued calls in order
                    calls, actor.pending_calls = actor.pending_calls, []
                    for call in calls:
                        await self._push_actor_task(actor, call)
        # seal return objects (worker stored them before TASK_DONE).  When the
        # task raised, the worker stores the RayTaskError *as the value* and
        # sets stored_error — the directory seals normally and the client
        # raises on deserialize (reference semantics).
        if p.get("error") and not p.get("stored_error"):
            if entry is not None:
                await self._seal_error_objects(entry.spec, p["error"])
        else:
            seal_nid = w.node_id if w is not None else self._conn_node.get(cid)
            contained = p.get("contained") or {}
            for oid in p.get("sealed", []):
                self._pin_contained(bytes(oid), contained.get(bytes(oid)) or [])
                self._add_location(bytes(oid), seal_nid)
                await self._seal_object(oid)
        self._kick_scheduler()
        return {"ok": True}

    async def h_task_blocked(self, cid, conn, p):
        """Worker blocked in get(): release its cpu so dependents can run
        (analog: reference NotifyDirectCallTaskBlocked → raylet releases the
        lease's cpu, node_manager.cc HandleNotifyDirectCallTaskBlocked)."""
        entry = self.tasks.get(p["task_id"])
        if entry and not entry.blocked and entry.spec.task_type == NORMAL_TASK and entry.node_id:
            node = self.nodes.get(entry.node_id)
            if node:
                entry.blocked = True
                self._release_task_resources(node, entry.spec)
                self._kick_scheduler()
        return {}

    async def h_task_unblocked(self, cid, conn, p):
        entry = self.tasks.get(p["task_id"])
        if entry and entry.blocked and entry.node_id:
            node = self.nodes.get(entry.node_id)
            if node:
                entry.blocked = False
                # reacquire; transient oversubscription is allowed, as in the
                # reference (the worker already holds the lease)
                node.acquire(self._task_resources(entry.spec))
        return {}

    async def h_cancel_task(self, cid, conn, p):
        tid = p["task_id"]
        for e in self.task_queue:
            if e.spec.task_id == tid:
                self.task_queue.remove(e)
                self.tasks.pop(tid, None)
                self._unpin_args(e.spec)
                await self._seal_error_objects(e.spec, "TaskCancelledError: cancelled before execution")
                return {"ok": True, "cancelled": True}
        entry = self.tasks.get(tid)
        if entry is not None and entry.worker_id:
            w = self.workers.get(entry.worker_id)
            if w is not None:
                await w.conn.send(MsgType.CANCEL_TASK, {"task_id": tid})
                if p.get("force"):
                    try:
                        os.kill(w.pid, 9)
                    except OSError:
                        pass
        return {"ok": True, "cancelled": False}

    # ------------------------------- worker leases (control-plane fast path)

    async def h_lease_request(self, cid, conn, p):
        """Grant a worker lease for one resource shape S: the holder pushes
        its whole queue of S-shaped tasks straight to the leased worker's
        direct-call server, amortizing the head round-trip to ~0 per task
        (reference analog: raylet worker-lease reuse,
        node_manager.cc RequestWorkerLease + direct task submission).  The
        lease holds S on the node for its lifetime — per-task accounting
        never touches this loop."""
        if not RayConfig.lease_cache_enabled:
            return {"granted": False, "reason": "disabled"}
        res = {
            str(k): float(v)
            for k, v in (p.get("resources") or {"CPU": 1.0}).items()
        }
        needs_gpu = res.get(RayConfig.gpu_resource_name, 0) > 0
        affinity = p.get("node_id")
        if affinity:
            node = self.nodes.get(bytes(affinity))
            if node is None or not node.alive or not node.try_acquire(res):
                return {"granted": False, "reason": "no capacity"}
        else:
            nid = self.sched.pick_and_acquire(
                res, RayConfig.scheduler_spread_threshold, prefer=self.head_node_id
            )
            if nid is None:
                return {"granted": False, "reason": "no capacity"}
            node = self.nodes.get(nid)
            if node is None:
                return {"granted": False, "reason": "no capacity"}
        worker = node.pop_idle(needs_gpu)
        if worker is None or not worker.direct_addr:
            if worker is not None:
                node.mark_idle(worker)  # registered pre-fast-path: no addr
            node.release(res)
            # denials warm the pool: the client's retry shortly after grants
            self._maybe_spawn_worker(node, 1, needs_gpu)
            return {"granted": False, "reason": "no idle worker"}
        lease_id = os.urandom(12)
        worker.lease = {
            "lease_id": lease_id,
            "cid": cid,
            "resources": res,
            "priority": int(p.get("priority", 1)),
            "via": "head",
            "granted_at": time.time(),
            "revoking": False,
        }
        self.leases[lease_id] = worker.worker_id
        self._leases_by_conn.setdefault(cid, set()).add(lease_id)
        return {
            "granted": True,
            "lease_id": lease_id,
            "worker_id": worker.worker_id,
            "addr": worker.direct_addr,
            "node_id": node.node_id,
        }

    async def h_lease_return(self, cid, conn, p):
        lease_id = bytes(p["lease_id"])
        wid = self.leases.get(lease_id)
        w = self.workers.get(wid) if wid else None
        if w is None or w.lease is None or bytes(w.lease["lease_id"]) != lease_id:
            self.leases.pop(lease_id, None)
            return {"ok": False}
        self._release_lease(w, self.nodes.get(w.node_id), reason="returned")
        self._kick_scheduler()
        return {"ok": True}

    def _release_lease(self, w: WorkerInfo, node: Optional[NodeInfo], reason: str = ""):
        """Idempotent lease teardown: release the shape hold and return
        the worker to the pool (unless it died — the death path forgot it
        already)."""
        lease = w.lease
        if lease is None:
            return
        w.lease = None
        lid = bytes(lease["lease_id"])
        self.leases.pop(lid, None)
        holders = self._leases_by_conn.get(lease.get("cid"))
        if holders is not None:
            holders.discard(lid)
        if node is not None:
            node.release(lease["resources"])
            if (
                w.worker_id in self.workers
                and not w.dedicated
                and w.actor_id is None
            ):
                node.mark_idle(w)

    def _revoke_lease(self, w: WorkerInfo, band: int, reason: str = ""):
        """Lease revocation IS preemption at the grant layer: ask the
        holder to stop pushing and return; a holder that drains within
        ``lease_revoke_deadline_s`` keeps every pushed task's single
        execution (no double-execution), a late one gets its leased worker
        SIGKILLed — the holder then resubmits unreplied tasks on the
        preemption budget (typed PreemptedError once spent)."""
        lease = w.lease
        if lease is None or lease.get("revoking"):
            return
        lease["revoking"] = True
        self._record_preemption(
            "lease",
            victim_band=int(lease.get("priority", 1)),
            requester_band=band,
            name="lease",
            victim=bytes(lease["lease_id"]).hex()[:16],
            reason=reason,
        )
        payload = {"lease_id": lease["lease_id"], "band": band}
        loop = asyncio.get_running_loop()
        if lease.get("via") == "raylet":
            node = self.nodes.get(w.node_id)
            if node is not None and node.conn is not None:
                loop.create_task(
                    node.conn.send(
                        MsgType.PUSH_TASK,
                        {"directive": "revoke_lease", **payload},
                    )
                )
        else:
            conn = self._conns.get(lease.get("cid"))
            if conn is not None:
                loop.create_task(conn.send(MsgType.LEASE_REVOKE, payload))
            else:
                # holder already gone: reclaim directly, nothing to drain
                self._release_lease(w, self.nodes.get(w.node_id), reason="holder gone")
                return
        loop.create_task(self._lease_revoke_deadline(w, lease))

    async def _lease_revoke_deadline(self, w: WorkerInfo, lease: dict):
        await asyncio.sleep(RayConfig.lease_revoke_deadline_s)
        if w.lease is lease:
            # holder didn't drain + return in time: forced preemption —
            # kill the leased worker; its death releases the hold, and the
            # holder's conn loss converts unreplied pushes into
            # budget-accounted preemptions client-side
            self._record_preemption(
                "lease_forced",
                victim_band=int(lease.get("priority", 1)),
                requester_band=-1,
                name="lease",
                victim=bytes(lease["lease_id"]).hex()[:16],
                reason="revoke deadline passed",
            )
            self._kill_worker_process(w, 9)

    async def h_lease_notify(self, cid, conn, p):
        """Async accounting of raylet-local grants (the whole point: the
        head LEARNS about placements instead of brokering them).  Between
        the grant and this frame the node is transiently oversubscribed in
        the head's view — same contract as blocked-task reacquisition."""
        op = str(p.get("op", ""))
        lid = bytes(p.get("lease_id") or b"")
        if op == "grant":
            wid = bytes(p.get("worker_id") or b"")
            w = self.workers.get(wid)
            nid = self._conn_node.get(cid) or (w.node_id if w else None)
            node = self.nodes.get(nid) if nid else None
            res = {
                str(k): float(v) for k, v in (p.get("resources") or {}).items()
            }
            if node is not None:
                node.acquire(res)
            if w is not None:
                if node is not None:
                    node.mark_busy(w)
                w.lease = {
                    "lease_id": lid,
                    "cid": -1,
                    "resources": res,
                    "priority": int(p.get("priority", 1)),
                    "via": "raylet",
                    "granted_at": time.time(),
                    "revoking": False,
                }
                self.leases[lid] = wid
            elif node is not None:
                # unknown worker (raced registration): release to stay sane
                node.release(res)
        elif op == "return":
            wid = self.leases.get(lid)
            w = self.workers.get(wid) if wid else None
            if w is not None and w.lease is not None and bytes(w.lease["lease_id"]) == lid:
                self._release_lease(w, self.nodes.get(w.node_id), reason="raylet return")
            else:
                self.leases.pop(lid, None)
            self._kick_scheduler()
        return {"ok": True}

    async def h_task_stats(self, cid, conn, p):
        """Batched flight records for tasks that never transit the head
        (lease / raylet grants reply straight to the caller): join them
        into the same ring + histograms as TASK_DONE records, tagged with
        granted_by so the queue-wait split is complete."""
        from ray_tpu_torch._private import task_events

        node_hex = bytes(p.get("node_id") or b"").hex()
        for rec in p.get("records", []):
            phases = {
                str(k): float(v) for k, v in (rec.get("phases") or {}).items()
            }
            if not phases:
                continue
            phases.setdefault("done", time.time())
            name = str(rec.get("name") or "task")
            gby = str(rec.get("granted_by") or "cached_lease")
            durs = task_events.durations(phases)
            tid_hex = bytes(rec.get("task_id") or b"").hex()
            self.task_records.append(
                {
                    "task_id": tid_hex,
                    "name": name,
                    "node_id": node_hex,
                    "pid": int(rec.get("pid", 0)),
                    "error": bool(rec.get("error")),
                    "trace": {},
                    "phases": phases,
                    "durations": durs,
                    "granted_by": gby,
                }
            )
            for phase, dur in durs.items():
                self._observe_phase(phase, name, node_hex, dur, granted_by=gby)
            es = phases.get("exec_start")
            if es is not None:
                self.timeline.append(
                    {
                        "name": name,
                        "pid": int(rec.get("pid", 0)),
                        "ts": es,
                        "dur": max(0.0, phases.get("exec_end", es) - es),
                        "error": bool(rec.get("error")),
                        "trace": {},
                        "phases": phases,
                        "task_id": tid_hex,
                    }
                )
        return {}

    # ---------------------------------------------------------------- actors

    async def h_create_actor(self, cid, conn, p):
        spec = TaskSpec.from_wire(p["spec"])
        existing = self.actors.get(spec.actor_id)
        if existing is not None and existing.state != ACTOR_DEAD:
            # idempotent retry: a driver whose CREATE_ACTOR reply was lost
            # to a head crash re-issues it after reattach — the actor id
            # is the dedupe key, creation must not run twice
            existing.owner_conn_id = cid if not existing.detached else existing.owner_conn_id
            return {"ok": True, "existing": True}
        if spec.name:
            key = (spec.namespace, spec.name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != ACTOR_DEAD:
                    raise ValueError(f"actor name {spec.name!r} already taken")
        actor = ActorInfo(spec)
        actor.owner_conn_id = cid
        self.actors[spec.actor_id] = actor
        if spec.name:
            self.named_actors[(spec.namespace, spec.name)] = spec.actor_id
        self._actor_mirror.upsert(
            spec.actor_id,
            state=ACTOR_PENDING,
            name=spec.name,
            namespace=spec.namespace,
            creation_spec=p["spec"],
            direct_addr="",
            death_cause="",
        )
        if spec.detached:
            self._wal("dactor", bytes(spec.actor_id), spec.to_wire())
            self._mark_tables_dirty()
        for oid in spec.return_object_ids():
            self._object_entry(oid)
        # pin creation args like any submit — the creation task's
        # h_task_done unpins (restart re-pins before re-queueing)
        self._pin_args(spec)
        entry = TaskEntry(spec, cid)
        self.tasks[spec.task_id] = entry
        self.task_queue.append(entry)
        self._kick_scheduler()
        return {"ok": True}

    async def h_get_actor(self, cid, conn, p):
        name, namespace = p.get("name", ""), p.get("namespace", "")
        aid = p.get("actor_id") or self.named_actors.get((namespace, name))
        if aid is None or aid not in self.actors:
            return {"found": False}
        a = self.actors[aid]
        return {
            "found": a.state != ACTOR_DEAD,
            "actor_id": a.actor_id,
            "state": a.state,
            "creation_spec": a.creation_spec.to_wire(),
            "direct_addr": a.direct_addr,
        }

    async def h_kill_actor(self, cid, conn, p):
        actor = self.actors.get(p["actor_id"])
        if actor is None:
            return {"ok": False}
        if p.get("no_restart", True):
            actor.max_restarts = actor.restarts_used  # forbid further restarts
            await self._destroy_actor(actor, "ray.kill")
        else:
            if actor.worker_id:
                w = self.workers.get(actor.worker_id)
                if w:
                    self._kill_worker_process(w, 9)
        return {"ok": True}

    async def h_actor_state(self, cid, conn, p):
        a = self.actors.get(p["actor_id"])
        if a is None:
            return {"state": "UNKNOWN"}
        if p.get("direct_addr") is not None:
            # the actor's worker registering its direct-call server; the
            # worker's node IP is authoritative for the host part
            host = ""
            w = self.workers.get(a.worker_id) if a.worker_id else None
            node = self.nodes.get(w.node_id) if w else None
            if node is not None and getattr(node, "transfer_addr", None):
                host = str(node.transfer_addr).rsplit(":", 1)[0]
            port = str(p["direct_addr"]).rsplit(":", 1)[-1]
            a.direct_addr = f"{host or '127.0.0.1'}:{port}"
            self._actor_mirror.upsert(a.actor_id, direct_addr=a.direct_addr)
        return {
            "state": a.state,
            "death_cause": a.death_cause,
            "direct_addr": a.direct_addr,
        }

    async def h_list_actors(self, cid, conn, p):
        out = []
        for a in self.actors.values():
            out.append(
                {
                    "actor_id": a.actor_id,
                    "state": a.state,
                    "name": a.name,
                    "namespace": a.namespace,
                    "class_name": a.creation_spec.function_name,
                    "node_id": a.node_id or b"",
                    "worker_id": a.worker_id or b"",
                    "pid": self.workers[a.worker_id].pid if a.worker_id in self.workers else 0,
                }
            )
        return {"actors": out}

    # ------------------------------------------------------ placement groups

    async def h_create_pg(self, cid, conn, p):
        existing = self.pgs.get(bytes(p["pg_id"]))
        if existing is not None and existing.state != "REMOVED":
            # idempotent retry (head-FT parked path): a creator whose reply
            # was lost to a head crash re-issues CREATE_PG after reattach —
            # re-placing would double-reserve the bundles
            return {"ok": True, "placed": existing.state == "CREATED", "existing": True}
        pg = PlacementGroupInfo(p["pg_id"], p["bundles"], p["strategy"], p.get("name", ""))
        self.pgs[pg.pg_id] = pg
        self._wal("pg", bytes(pg.pg_id), (pg.bundles, pg.strategy, pg.name))
        self._mark_tables_dirty()
        self._try_place_pg(pg)
        self._kick_scheduler()
        return {"ok": True, "placed": pg.state == "CREATED"}

    def _try_place_pg(self, pg: PlacementGroupInfo) -> bool:
        """All-or-nothing bundle placement (2-phase reserve in the reference:
        gcs_placement_group_scheduler.cc PrepareResources/CommitResources —
        atomic here because the resource view is centralized)."""
        alive = [n for n in self.nodes.values() if n.alive]
        placement: List[Tuple[int, NodeInfo]] = []
        # simulate against copies of available resources
        sim = {n.node_id: dict(n.resources_available) for n in alive}

        def fits(node, bundle):
            av = sim[node.node_id]
            return all(av.get(k, 0.0) + 1e-9 >= v for k, v in bundle.items() if v > 0)

        def take(node, bundle):
            av = sim[node.node_id]
            for k, v in bundle.items():
                if v > 0:
                    av[k] = av.get(k, 0.0) - v

        strategy = pg.strategy
        if strategy == "STRICT_PACK":
            for n in alive:
                ok = True
                snapshot = dict(sim[n.node_id])
                for b in pg.bundles:
                    if fits(n, b):
                        take(n, b)
                    else:
                        ok = False
                        break
                if not ok:
                    sim[n.node_id] = snapshot
                    continue
                placement = [(i, n) for i in range(len(pg.bundles))]
                break
            if not placement:
                return False
        elif strategy == "STRICT_SPREAD":
            if len(alive) < len(pg.bundles):
                return False
            used_nodes: Set[bytes] = set()
            for i, b in enumerate(pg.bundles):
                cand = [n for n in alive if n.node_id not in used_nodes and fits(n, b)]
                if not cand:
                    return False
                n = max(cand, key=lambda x: x.resources_available.get("CPU", 0))
                take(n, b)
                used_nodes.add(n.node_id)
                placement.append((i, n))
        elif strategy == "SPREAD":
            last = None
            for i, b in enumerate(pg.bundles):
                cand = [n for n in alive if fits(n, b)]
                if not cand:
                    return False
                cand.sort(key=lambda x: (x.node_id == (last or b""), -x.resources_available.get("CPU", 0)))
                n = cand[0]
                take(n, b)
                last = n.node_id
                placement.append((i, n))
        else:  # PACK (default): prefer one node, fall back to others
            for i, b in enumerate(pg.bundles):
                cand = [n for n in alive if fits(n, b)]
                if not cand:
                    return False
                cand.sort(key=lambda x: -x.utilization())
                n = cand[0]
                take(n, b)
                placement.append((i, n))
        # commit
        for i, n in placement:
            n.acquire(pg.bundles[i])
            pg.bundle_nodes[i] = n.node_id
        pg.state = "CREATED"
        pg.bundle_available = [dict(b) for b in pg.bundles]
        for fut in pg.waiters:
            if not fut.done():
                fut.set_result(True)
        pg.waiters.clear()
        return True

    async def h_pg_ready(self, cid, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            raise ValueError("unknown placement group")
        if pg.state == "CREATED":
            return {"ready": True}
        fut = asyncio.get_running_loop().create_future()
        pg.waiters.append(fut)
        try:
            await asyncio.wait_for(fut, p.get("timeout"))
            return {"ready": True}
        except asyncio.TimeoutError:
            return {"ready": False}

    async def h_remove_pg(self, cid, conn, p):
        self._wal("pg", bytes(p["pg_id"]), None)
        self._mark_tables_dirty()
        pg = self.pgs.pop(p["pg_id"], None)
        if pg is None:
            return {"ok": False}
        if pg.state == "CREATED":
            for i, nid in enumerate(pg.bundle_nodes):
                node = self.nodes.get(nid) if nid else None
                if node:
                    # release what the PG still holds (reserved minus consumed is
                    # held by running tasks; they release into the node on finish)
                    node.release(pg.bundle_available[i])
        pg.state = "REMOVED"
        return {"ok": True}

    async def h_get_pg(self, cid, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return {"found": False}
        return {
            "found": True,
            "state": pg.state,
            "bundles": pg.bundles,
            "strategy": pg.strategy,
            "bundle_nodes": [n or b"" for n in pg.bundle_nodes],
        }

    async def h_list_pgs(self, cid, conn, p):
        return {
            "pgs": [
                {"pg_id": pg.pg_id, "name": pg.name, "state": pg.state, "strategy": pg.strategy}
                for pg in self.pgs.values()
            ]
        }

    # ------------------------------------------------------------- KV/pubsub

    async def h_kv_put(self, cid, conn, p):
        self._mark_tables_dirty()
        key = p["key"]
        # shared put path with the shard servers (gcs/shards.py): store +
        # wake kv waiters wherever they registered (head or shard loops).
        # No kv:{key} pubsub publish: nothing subscribes to it, and with
        # clients routing KV_PUT to the shard listeners a head-only
        # publish would be a silent divergence trap anyway — waiters are
        # the notification mechanism for kv rendezvous.
        added = self.kv.put_notify(key, p["value"], p.get("overwrite", True))
        if added:
            self._wal("kv", key, p["value"])
        return {"added": added}

    async def h_kv_get(self, cid, conn, p):
        key = p["key"]
        if p.get("wait") and key not in self.kv:
            # waiter future fired by put_notify — not a poll loop: N
            # rendezvousing workers cost zero wakeups until the key lands
            timeout = p.get("timeout") or RayConfig.collective_rendezvous_timeout_s
            fut = self.kv.register_waiter(key)
            if fut is not None:
                try:
                    await asyncio.wait_for(fut, timeout)
                except asyncio.TimeoutError:
                    return {"found": False}
                finally:
                    self.kv.unregister_waiter(key, fut)
        v = self.kv.get(key)
        return {"found": v is not None, "value": v if v is not None else b""}

    async def h_kv_del(self, cid, conn, p):
        self._mark_tables_dirty()
        n = 0
        if p.get("prefix"):
            for k in [k for k in self.kv if k.startswith(p["key"])]:
                del self.kv[k]
                self._wal("kv", k, None)
                n += 1
        elif p["key"] in self.kv:
            del self.kv[p["key"]]
            self._wal("kv", p["key"], None)
            n = 1
        return {"deleted": n}

    async def h_kv_keys(self, cid, conn, p):
        pref = p.get("prefix", "")
        keys = [k for k in self.kv if k.startswith(pref)]
        if p.get("values"):
            # prefix-ranged multi-get: one frame instead of 1+N round
            # trips (the raylet metrics agents scrape the metrics:*
            # namespace this way every Prometheus interval)
            return {"keys": keys, "values": {k: self.kv[k] for k in keys}}
        return {"keys": keys}

    async def h_kv_exists(self, cid, conn, p):
        return {"exists": p["key"] in self.kv}

    async def h_subscribe(self, cid, conn, p):
        self.subscribers.setdefault(p["channel"], {})[cid] = conn
        return {"ok": True}

    async def h_publish(self, cid, conn, p):
        await self._publish(p["channel"], p["message"])
        return {"ok": True}

    async def _publish(self, channel: str, message: dict):
        if channel == "logs":
            self._account_log_message(message)
            if str(message.get("source", "")).startswith("driver-"):
                # driver-tee files are for LOG_FETCH retrieval only: the
                # driver already printed these bytes to its own terminal,
                # and streaming them back would echo through the tee →
                # tailer → sink → tee loop, amplifying every line
                return
        subs = self.subscribers.get(channel)
        if not subs:
            return
        dead = []
        # snapshot: the awaits inside the loop yield to handlers that
        # subscribe/unsubscribe, which would mutate the dict mid-iteration
        # (observed as a RuntimeError storm during mass worker death)
        for cid, conn in list(subs.items()):
            msg = message
            if channel == "logs":
                msg = self._scope_log_message(cid, message)
                if msg is None:
                    continue  # nothing in this batch belongs to that driver
            try:
                await conn.send(MsgType.PUBLISH, {"channel": channel, "message": msg})
            except Exception:  # graftlint: disable=silent-except -- dead subscriber is expected churn; pruned from the channel just below
                dead.append(cid)
        for cid in dead:
            subs.pop(cid, None)

    def _account_log_message(self, message: dict):
        """Head-side transit accounting for one tailer batch: line
        counters by stream/node, the per-source forensics ring (feeds
        ActorDiedError.log_tail — a SIGKILLed victim can't ship its own
        tail), and trace-stamped records for the timeline markers."""
        records = message.get("records")
        if not records:
            return
        source = message.get("source", "")
        from collections import deque as _deque

        ring = self._recent_logs.get(source)
        if ring is None:
            ring = self._recent_logs[source] = _deque(
                maxlen=max(8, RayConfig.error_log_tail_lines)
            )
            if len(self._recent_logs) > 4096:
                # bound source cardinality across very long sessions
                self._recent_logs.pop(next(iter(self._recent_logs)))
        by_stream: Dict[str, Dict[str, int]] = {}
        for rec in records:
            ring.append(rec.get("msg", ""))
            stream = rec.get("stream", "out")
            node = str(rec.get("node") or "head")
            per = by_stream.setdefault(stream, {})
            per[node] = per.get(node, 0) + 1
            if rec.get("trace"):
                self._log_trace_marks.append(rec)
        for stream, per in by_stream.items():
            for node, n in per.items():
                self._inc_counter(
                    "ray_tpu_torch_log_lines_total",
                    "log lines transiting the head's logs channel, by stream/node",
                    {"stream": stream, "node": node},
                    float(n),
                )

    def _scope_log_message(self, cid: int, message: dict) -> Optional[dict]:
        """Job-scope one tailer batch for one subscriber: a driver conn
        sees records stamped with ITS job plus stamp-free lines (raw mode,
        infra output); non-driver subscribers see everything.  Returns
        None when the filtered batch is empty."""
        job = self._conn_job.get(cid)
        if job is None:
            return message  # not a registered driver: unscoped (tests, tools)
        records = message.get("records")
        if records is None:
            return message  # v1 raw batch (structured capture off): unscoped
        job_hex = bytes(job).hex()
        kept = [
            r for r in records if not r.get("job") or r.get("job") == job_hex
        ]
        if not kept:
            return None
        if len(kept) == len(records):
            return message
        return {
            "source": message.get("source"),
            "lines": [r.get("msg", "") for r in kept],
            "records": kept,
        }

    def _with_log_tail(self, worker_id: Optional[bytes]) -> str:
        """LOG_TAIL_MARKER suffix for a seal string: the victim worker's
        last lines as seen by the logs pubsub transit.  The dead process
        cannot ship its own forensics — this ring is the survivor copy.
        Empty string when capture is off or nothing transited yet."""
        if not worker_id or not _log_plane.enabled:
            # RAY_TPU_LOG_STRUCTURED=0 contract: no sentinel-marked tail
            # may enter a seal string — a worker printing the resulting
            # exception would leak stamp bytes into a raw-mode log file
            return ""
        info = self._worker_log_src.get(bytes(worker_id))
        ring = self._recent_logs.get(info["src"]) if info else None
        if not ring:
            return ""
        import json as _json

        try:
            return _log_plane.LOG_TAIL_MARKER + _json.dumps(list(ring))
        except (TypeError, ValueError):
            return ""

    def _note_error_record(self, p: dict):
        """One structured error record into the head ring + signature
        dedup index + counter family — shared by ERROR_REPORT frames and
        head-side actor-death synthesis so `summary errors` sees both."""
        sig = str(p.get("signature") or "unknown")
        kind = str(p.get("kind") or "task")
        rec = dict(p)
        rec["ts"] = time.time()
        self.error_records.append(rec)
        ent = self._error_index.get(sig)
        if ent is None:
            if len(self._error_index) >= 1024:
                # bound distinct-signature cardinality; oldest group goes
                self._error_index.pop(next(iter(self._error_index)))
            self._error_index[sig] = {
                "signature": sig,
                "kind": kind,
                "first_ts": rec["ts"],
                "last_ts": rec["ts"],
                "count": 1,
                "sample": rec,
            }
            # first sighting of a NEW signature is event-worthy; repeats
            # only bump the dedup count (flood-safe by construction)
            self._record_event(
                "ERROR",
                "errors",
                f"{rec.get('exc_type', 'Error')} in {rec.get('name', '?')}: "
                f"{str(rec.get('message', ''))[:200]}",
                signature=sig,
                kind=kind,
            )
        else:
            ent["count"] += 1
            ent["last_ts"] = rec["ts"]
            ent["sample"] = rec
        self._inc_counter(
            "ray_tpu_torch_error_records_total",
            "structured error records received on the head error ring, by kind",
            {"kind": kind},
            1.0,
        )

    async def h_error_report(self, cid, conn, p):
        """Resurrected ERROR_PUSH role (new burned-in value): a worker's
        uncaught task/actor exception arrives as a structured record —
        signature, traceback, last-K log lines — fire-and-forget (rid 0,
        no reply)."""
        self._note_error_record(p)
        return {"ok": True}

    # ------------------------------------------------- log plane: retrieval

    def _resolve_log_entity(self, kind: str, ident: str):
        """Entity → files on nodes.  Returns
        ``(targets: {node_id: [paths]}, rec_filter: (key, hexprefix)|None,
        job_hex|None)``; raises ValueError with a user-facing message when
        the entity doesn't resolve."""
        targets: Dict[bytes, List[str]] = {}
        rec_filter = None
        job_hex = None

        def _add_worker(wid: bytes):
            info = self._worker_log_src.get(bytes(wid))
            if not info:
                w = self.workers.get(bytes(wid))
                if w is None or not w.log_file:
                    raise ValueError(
                        f"no log file known for worker {bytes(wid).hex()[:8]}"
                    )
                info = {"node": w.node_id, "path": w.log_file}
            targets.setdefault(bytes(info["node"]), []).append(info["path"])

        def _actor_worker(aid_hex: str) -> bytes:
            for aid, actor in self.actors.items():
                if aid.hex().startswith(aid_hex):
                    if actor.worker_id is None:
                        raise ValueError(
                            f"actor {aid_hex[:8]} has no worker (state "
                            f"{actor.state}): no log file to read"
                        )
                    return bytes(actor.worker_id)
            raise ValueError(f"unknown actor {aid_hex[:8]}")

        if kind == "worker":
            for wid in list(self._worker_log_src) + list(self.workers):
                if wid.hex().startswith(ident):
                    _add_worker(wid)
                    break
            else:
                raise ValueError(f"unknown worker {ident[:8]}")
        elif kind == "actor":
            wid = _actor_worker(ident)
            _add_worker(wid)
            rec_filter = ("actor", ident)
        elif kind == "replica":
            # "deployment#index": replicas are named actors
            # SERVE_REPLICA::{deployment}::{gen}::{rseq} (serve/controller.py)
            dep, _, idx = ident.partition("#")
            idx = int(idx or 0)
            prefix = f"SERVE_REPLICA::{dep}::"
            names = sorted(
                (name, aid)
                for (_ns, name), aid in self.named_actors.items()
                if name.startswith(prefix)
            )
            if not names:
                raise ValueError(f"no live replicas for deployment {dep!r}")
            if idx >= len(names):
                raise ValueError(
                    f"replica index {idx} out of range: deployment {dep!r} "
                    f"has {len(names)} live replica(s)"
                )
            aid = names[idx][1]
            wid = _actor_worker(bytes(aid).hex())
            _add_worker(wid)
            rec_filter = ("actor", bytes(aid).hex())
        elif kind == "task":
            # the running-task stamp addresses lines; read the whole
            # cluster's files filtered down to this task's records
            for info in self._worker_log_src.values():
                targets.setdefault(bytes(info["node"]), []).append(info["path"])
            rec_filter = ("task", ident)
        elif kind == "job":
            job_hex = ident
            for info in self._worker_log_src.values():
                targets.setdefault(bytes(info["node"]), []).append(info["path"])
            # the driver tee lands on the head node as driver-{job8}-*.log
            import glob as _glob

            for path in _glob.glob(
                os.path.join(self.session_dir, f"driver-{ident[:8]}*.log")
            ):
                targets.setdefault(self.head_node_id, []).append(path)
        elif kind == "node":
            for nid in self.nodes:
                if nid.hex().startswith(ident):
                    break
            else:
                raise ValueError(f"unknown node {ident[:8]}")
            for info in self._worker_log_src.values():
                if bytes(info["node"]) == nid:
                    targets.setdefault(nid, []).append(info["path"])
            if nid == self.head_node_id:
                head_log = os.path.join(self.session_dir, "head.log")
                if os.path.exists(head_log):
                    targets.setdefault(nid, []).append(head_log)
            if not targets:
                raise ValueError(
                    f"node {ident[:8]} has no registered worker logs yet"
                )
        else:
            raise ValueError(f"unknown log entity kind {kind!r}")
        return targets, rec_filter, job_hex

    def _fetch_log_local(self, payload: dict) -> dict:
        """The head is its own node's log agent (no raylet on the head):
        same read the raylet-side agent performs, same session-dir jail."""
        from ray_tpu_torch._private import log_monitor

        sess = os.path.realpath(self.session_dir)
        files = [
            f
            for f in (payload.get("files") or [])
            if os.path.realpath(f).startswith(sess + os.sep)
        ]
        cursor = payload.get("cursor") or None
        grep = payload.get("grep") or None
        job = payload.get("job") or None
        if cursor:
            recs, cur = log_monitor.read_new_records(cursor, grep=grep, job=job)
        else:
            recs, cur = log_monitor.tail_file_records(
                files, tail=int(payload.get("tail") or 100), grep=grep, job=job
            )
        return {"ok": True, "records": recs, "cursor": cur}

    async def _fetch_log_from(self, nid: bytes, payload: dict) -> dict:
        if nid == self.head_node_id:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._fetch_log_local, payload
            )
        node = self.nodes.get(nid)
        if node is None or node.conn is None or not node.alive:
            return {
                "ok": False,
                "error": f"node {nid.hex()[:8]} is not reachable",
            }
        return await node.conn.request(MsgType.LOG_FETCH, payload, timeout=30)

    async def h_log_fetch(self, cid, conn, p):
        """Pull-based log retrieval: resolve the entity to files on nodes,
        delegate the disk read to each node's log agent, merge by
        timestamp.  ``cursor`` (from a prior reply) switches to a follow
        read — only new complete lines since that reply."""
        kind = str(p.get("kind") or "worker")
        ident = str(p.get("id") or "")
        tail = int(p.get("tail") or 100)
        grep = p.get("grep") or None
        cursor = p.get("cursor") or None

        if kind == "list":
            # directory view (state API list_logs): every log file the
            # head can currently resolve, as node:basename strings
            files = sorted(
                {
                    f"{bytes(info['node']).hex()[:12]}:{info['src']}"
                    for info in self._worker_log_src.values()
                    if not ident or bytes(info["node"]).hex().startswith(ident)
                }
            )
            return {"ok": True, "files": files}

        if cursor:
            # follow: the reply cursor is {node_hex: {path: offset}} — route
            # each sub-cursor back to the node that owns those files
            jobs = [
                (nh, {"cursor": sub, "grep": grep, "job": p.get("job") or None})
                for nh, sub in cursor.items()
                if sub
            ]
            records: List[dict] = []
            out_cursor: Dict[str, dict] = {}
            for nh, payload in jobs:
                r = await self._fetch_log_from(bytes.fromhex(nh), payload)
                if not r.get("ok"):
                    return r
                records.extend(r.get("records") or [])
                out_cursor[nh] = r.get("cursor") or {}
            records.sort(key=lambda r: r.get("ts") or 0.0)
            return {"ok": True, "records": records, "cursor": out_cursor}

        try:
            targets, rec_filter, job_hex = self._resolve_log_entity(kind, ident)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        if p.get("job") and not job_hex:
            job_hex = str(p["job"])
        records = []
        out_cursor = {}
        for nid, files in targets.items():
            r = await self._fetch_log_from(
                nid,
                {"files": files, "tail": tail, "grep": grep, "job": job_hex},
            )
            if not r.get("ok"):
                # partial reach (a node died mid-query) degrades, not fails,
                # a multi-node read; a single-target read surfaces the error
                if len(targets) == 1:
                    return r
                continue
            records.extend(r.get("records") or [])
            out_cursor[nid.hex()] = r.get("cursor") or {}
        if rec_filter is not None:
            key, prefix = rec_filter
            records = [
                r for r in records if str(r.get(key, "")).startswith(prefix)
            ]
        records.sort(key=lambda r: r.get("ts") or 0.0)
        if tail > 0:
            records = records[-tail:]
        return {"ok": True, "records": records, "cursor": out_cursor}

    # -------------------------------------------------------- cluster state

    async def h_cluster_resources(self, cid, conn, p):
        total: Dict[str, float] = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.resources_total.items():
                    total[k] = total.get(k, 0.0) + v
        return {"resources": total}

    async def h_available_resources(self, cid, conn, p):
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.resources_available.items():
                    avail[k] = avail.get(k, 0.0) + v
        return {"resources": avail}

    async def h_list_nodes(self, cid, conn, p):
        return {
            "nodes": [
                {
                    "node_id": n.node_id,
                    "alive": n.alive,
                    "resources": n.resources_total,
                    "available": n.resources_available,
                    "labels": n.labels,
                    "num_workers": len(n.workers),
                    "idle_workers": len(n.idle_pool[False]) + len(n.idle_pool[True]),
                    "starting_workers": n.starting_workers,
                }
                for n in self.nodes.values()
            ]
        }

    async def h_list_tasks(self, cid, conn, p):
        out = []
        for e in self.task_queue:
            out.append(
                {
                    "task_id": e.spec.task_id,
                    "state": "QUEUED",
                    "name": e.spec.function_name,
                    "resources": self._task_resources(e.spec),
                }
            )
        for e in self.tasks.values():
            if e.state != "QUEUED":
                out.append(
                    {
                        "task_id": e.spec.task_id,
                        "state": e.state,
                        "name": e.spec.function_name,
                        "type": e.spec.task_type,
                        "worker_id": e.worker_id or b"",
                    }
                )
        return {"tasks": out, "finished": self.finished_task_count}

    # -------------------------------------------------------- flight recorder

    def _join_task_phases(self, p: dict, entry, w) -> dict:
        """Join the TASK_DONE stamps with head-side context into one flight
        record, aggregate per-phase histograms, and return the stamp dict
        for the timeline event.  One truthiness check when recording is off
        (the worker sends phases={} then)."""
        wire_phases = p.get("phases")
        if not wire_phases:
            return {}
        from ray_tpu_torch._private import task_events

        phases = {str(k): float(v) for k, v in wire_phases.items()}
        phases["done"] = time.time()
        spec = entry.spec if entry is not None else None
        name = (spec.function_name or spec.method_name) if spec else "task"
        gby = str(getattr(spec, "granted_by", "head") or "head") if spec else "head"
        node_hex = (entry.node_id.hex() if entry and entry.node_id else "")
        durs = task_events.durations(phases)
        self.task_records.append(
            {
                "task_id": bytes(p["task_id"]).hex(),
                "name": name or "task",
                "node_id": node_hex,
                "pid": w.pid if w else 0,
                "error": bool(p.get("error")),
                "trace": (spec.trace_ctx or {}) if spec else {},
                "phases": phases,
                "durations": durs,
                "granted_by": gby,
            }
        )
        for phase, dur in durs.items():
            self._observe_phase(phase, name or "task", node_hex, dur, granted_by=gby)
        return phases

    def _observe_phase(
        self,
        phase: str,
        name: str,
        node_hex: str,
        dur: float,
        granted_by: str = "",
    ):
        """Fold one task-phase duration into the flight-recorder
        histograms (see _observe_hist for the write-through contract).
        Task records carry the grant path (head / cached_lease / raylet)
        as a label so queue-wait splits by dispatch mode; the dag/serve/
        train planes omit it."""
        from ray_tpu_torch._private import task_events

        tags = {"phase": phase, "name": name, "node": node_hex[:12]}
        if granted_by:
            tags["granted_by"] = granted_by
        self._observe_hist(
            task_events.PHASE_METRIC,
            task_events.PHASE_METRIC_HELP,
            task_events.PHASE_HISTOGRAM_BOUNDARIES,
            tags,
            dur,
        )

    def _observe_hist(self, metric, help_text, boundaries, tags, value):
        """Fold one observation into a head-owned histogram series,
        written through to self.kv under metrics:* so the normal scrape
        surfaces (util/metrics.read_all, per-node /metrics) pick it up
        like any app metric.  Deliberately NOT WAL-persisted (direct kv
        mutation, like chaos:plan): latency history dies with the head
        incarnation."""
        import json as _json

        from ray_tpu_torch.util import metrics as metrics_mod

        key = f"metrics:{metric}:{metrics_mod.tag_string(tags)}:head"
        rec = self._phase_hist_cache.get(key)
        if rec is None:
            rec = metrics_mod.new_histogram_record(help_text, boundaries)
            rec["tags"] = tags
            self._phase_hist_cache[key] = rec
        metrics_mod.observe_into(rec, value)
        self.kv[key] = _json.dumps(rec).encode()

    def _set_gauge(self, metric, help_text, tags, value):
        """Head-owned gauge series, same write-through as _observe_hist."""
        import json as _json

        from ray_tpu_torch.util import metrics as metrics_mod

        key = f"metrics:{metric}:{metrics_mod.tag_string(tags)}:head"
        rec = {
            "kind": "gauge",
            "value": float(value),
            "ts": time.time(),
            "description": help_text,
            "tags": tags,
        }
        self.kv[key] = _json.dumps(rec).encode()

    async def h_task_summary(self, cid, conn, p):
        """Workload summaries over the joined flight records.  `what`
        selects the plane: "tasks" (default — per-phase latency table,
        the backend of `ray-tpu summary tasks` / /api/task_summary),
        "serve" (per-deployment stage latencies + TTFT/TPOT), "train"
        (per-run step breakdown + jitter/MFU), "memory" (per-node store
        occupancy, object accounting, spill counters), "slo" (the watchdog's verdicts), "preemptions" (the
        priority scheduler's victim log, counters, parked actors and
        SLO hold).  Reference analog: `ray summary tasks`,
        state/state_cli.py."""
        what = str(p.get("what", "tasks"))
        limit = int(p.get("limit", 0))
        if what == "serve":
            return self._summary_serve(limit)
        if what == "train":
            return self._summary_train(limit)
        if what == "memory":
            return self._summary_memory()
        if what == "slo":
            return self._summary_slo()
        if what == "preemptions":
            return self._summary_preemptions(limit)
        if what == "errors":
            return self._summary_errors(limit)
        if what == "head":
            return {
                "incarnation": self.incarnation,
                "head_node_id": self.head_node_id.hex(),
                "started_at": self.started_at,
                "restarts_total": self.incarnation - 1,
                "recovering": self._recovery is not None,
                "last_recovery": self.last_recovery,
            }
        if what != "tasks":
            raise ValueError(f"unknown summary kind {what!r}")
        records = list(self.task_records)
        groups: Dict[Tuple[str, str], List[float]] = {}
        for rec in records:
            for phase, dur in rec["durations"].items():
                groups.setdefault((rec["name"], phase), []).append(dur)
        summary = []
        for (name, phase), vals in sorted(groups.items()):
            summary.append({"name": name, "phase": phase, **_percentiles(vals)})
        out = {"summary": summary, "total_records": len(records)}
        if limit > 0:
            out["records"] = records[-limit:]
        return out

    def _summary_train(self, limit: int = 0) -> dict:
        """Per-run step breakdown (phase percentiles over the record
        ring) plus the freshest rolling stats each probe shipped
        (jitter/MFU over ITS window, which outlives the ring)."""
        records = [
            r for r in self.task_records if r["name"].startswith("train:")
        ]
        groups: Dict[Tuple[str, str], List[float]] = {}
        for rec in records:
            run = rec["name"][len("train:"):]
            for phase, dur in rec["durations"].items():
                groups.setdefault((run, phase), []).append(dur)
        summary = [
            {"run": run, "phase": phase, **_percentiles(vals)}
            for (run, phase), vals in sorted(groups.items())
        ]
        out = {
            "summary": summary,
            "runs": {k: dict(v) for k, v in self.train_stats.items()},
            "total_records": len(records),
        }
        if limit > 0:
            out["records"] = records[-limit:]
        return out

    def _summary_memory(self) -> dict:
        """Cluster memory accounting: per-node shm occupancy, the object
        directory by state/owner, spill counters, DAG ring occupancy."""
        nodes = {}
        for nid, node in self.nodes.items():
            stats = dict(node.store_stats)
            if nid == self.head_node_id and getattr(self, "_store", None):
                stats = {
                    "used": float(self._store.used()),
                    "capacity": float(self._store.capacity()),
                    "objects": float(self._store.num_objects()),
                    "evictions": float(self._store.evictions()),
                }
            nodes[nid.hex()] = {"alive": node.alive, **stats}
        by_state: Dict[str, int] = {"SEALED": 0, "PENDING": 0, "ERRORED": 0}
        for entry in self.objects.values():
            key = {PENDING: "PENDING", SEALED: "SEALED", ERRORED: "ERRORED"}[entry[0]]
            by_state[key] += 1
        by_owner: Dict[str, dict] = {}
        by_tier: Dict[str, dict] = {}
        for oid, meta in self.object_meta.items():
            if oid not in self.objects:
                continue
            slot = by_owner.setdefault(
                meta.get("owner", "?"), {"count": 0, "bytes": 0}
            )
            slot["count"] += 1
            slot["bytes"] += int(meta.get("nbytes", 0))
            tslot = by_tier.setdefault(
                meta.get("tier", "shm"), {"count": 0, "bytes": 0}
            )
            tslot["count"] += 1
            tslot["bytes"] += int(meta.get("nbytes", 0))
        pinned = sum(1 for c in self.object_refcounts.values() if c > 0)
        return {
            "nodes": nodes,
            "objects": {
                "by_state": by_state,
                "by_owner": by_owner,
                "by_tier": by_tier,
                "pinned": pinned,
                "total": len(self.objects),
                "spilled": len(self.object_spilled),
                "lineage": len(self.lineage),
            },
            "dag_channels": {k: dict(v) for k, v in self.dag_channel_stats.items()},
            # per-deployment paged-KV pool occupancy (the engine's device
            # memory knob): same gauge families as `summary serve`
            "serve_engine": self._engine_gauges(),
        }

    def _summary_serve(self, limit: int = 0) -> dict:
        """Per-(deployment, stage) latency table plus TTFT/TPOT
        percentiles, aggregated over the serve flight records."""
        records = [
            r for r in self.task_records if r["name"].startswith("serve:")
        ]
        stages: Dict[Tuple[str, str], List[float]] = {}
        ttft: Dict[str, List[float]] = {}
        tpot: Dict[str, List[float]] = {}
        for rec in records:
            dep = rec["name"][len("serve:"):]
            for phase, dur in rec["durations"].items():
                stages.setdefault((dep, phase), []).append(dur)
            if rec.get("ttft_s") is not None:
                ttft.setdefault(dep, []).append(float(rec["ttft_s"]))
            if rec.get("tpot_s") is not None:
                tpot.setdefault(dep, []).append(float(rec["tpot_s"]))
        summary = [
            {"deployment": dep, "stage": stage, **_percentiles(vals)}
            for (dep, stage), vals in sorted(stages.items())
        ]
        out = {
            "summary": summary,
            "ttft": {d: _percentiles(v) for d, v in ttft.items()},
            "tpot": {d: _percentiles(v) for d, v in tpot.items()},
            "engine": self._engine_gauges(),
            "total_records": len(records),
        }
        if limit > 0:
            out["records"] = records[-limit:]
        return out

    def _engine_gauges(self) -> dict:
        """Continuous-batching engine occupancy, read from the replica-
        published ``ray_tpu_torch_serve_engine_*`` gauge families in the
        metrics kv namespace (per-process series merged, freshest write
        wins) — slot/page occupancy and queue depth per deployment for
        `summary serve|memory`."""
        from ray_tpu_torch.util import metrics as metrics_mod

        prefix = "ray_tpu_torch_serve_engine_"
        raw = metrics_mod.raw_records_from_kv(self.kv)
        engine_raw = {k: v for k, v in raw.items() if k.startswith(prefix)}
        out: dict = {}
        for key, rec in sorted(metrics_mod.merge_series(engine_raw).items()):
            name, _, _ = metrics_mod.parse_series_key(key)
            tags = dict(rec.get("tags") or {})
            slot = out.setdefault(tags.pop("deployment", "?"), {})
            short = name[len(prefix):]
            if tags:
                short += ":" + ",".join(f"{v}" for _, v in sorted(tags.items()))
            slot[short] = rec.get("value", 0.0)
        return out

    def _summary_slo(self) -> dict:
        return {
            "slos": [dict(v) for v in self._slo_state.values()],
            "specs": [dict(s) for s in self._slo_specs],
        }

    async def h_dag_step(self, cid, conn, p):
        """A batch of compiled-DAG step flight records (fire-and-forget
        DAG_STEP frame from dag/executor.py, sent only while task events
        are on; the executor buffers ~16 steps per frame so the hot loop
        never pays a head wakeup per step).  Compiled steps never transit
        the scheduler, so these frames are their entire head-side
        footprint: join each record into the flight-record ring, the
        per-phase histograms, and the timeline — where h_timeline renders
        per-node dag_channel_wait / dag_exec / dag_push sub-spans exactly
        like the eager phases."""
        from ray_tpu_torch._private import task_events

        dag_id = str(p.get("dag_id", ""))
        node_hex = bytes(p.get("node_id") or b"").hex()
        for step in p.get("steps", []):
            phases = {str(k): float(v) for k, v in (step.get("phases") or {}).items()}
            if not phases:
                continue
            name = f"dag:{step.get('name', 'node')}"
            step_id = f"{dag_id}:{int(step.get('seq', 0))}"
            durs = task_events.durations(phases)
            self.task_records.append(
                {
                    "task_id": step_id,
                    "name": name,
                    "node_id": node_hex,
                    "pid": int(step.get("pid", 0)),
                    "error": bool(step.get("error")),
                    "trace": {},
                    "phases": phases,
                    "durations": durs,
                }
            )
            for phase, dur in durs.items():
                self._observe_phase(phase, name, node_hex, dur)
            exec_start = phases.get("dag_exec_start", 0.0)
            self.timeline.append(
                {
                    "name": name,
                    "pid": int(step.get("pid", 0)),
                    "ts": exec_start,
                    "dur": max(0.0, phases.get("dag_exec_end", exec_start) - exec_start),
                    "error": bool(step.get("error")),
                    "trace": {},
                    "phases": phases,
                    "task_id": step_id,
                }
            )
        # ring occupancy samples piggyback the step batch (sampled at
        # flush time, ~16 steps apart — no extra frames on the hot loop)
        now = time.time()
        for ch in p.get("channels", []):
            key = str(ch.get("c", ""))
            if not key:
                continue
            stat = {
                "occupancy": int(ch.get("occ", 0)),
                "slots": int(ch.get("slots", 0)),
                "dag_id": dag_id,
                "ts": now,
            }
            self.dag_channel_stats[key] = stat
            self._set_gauge(
                "ray_tpu_torch_dag_channel_occupancy",
                "Ring slots holding unconsumed steps (sampled per "
                "DAG_STEP flush)",
                {"channel": key},
                stat["occupancy"],
            )
            self._set_gauge(
                "ray_tpu_torch_dag_channel_slots",
                "Ring capacity in slots",
                {"channel": key},
                stat["slots"],
            )
        return {}

    async def h_serve_trace(self, cid, conn, p):
        """A batch of serve request flight records (fire-and-forget
        SERVE_TRACE frame from serve/tracing.py, sent only while task
        events are on).  Joined exactly like task records: the
        flight-record ring (name ``serve:<deployment>``), per-stage
        `ray_tpu_torch_serve_request_seconds{stage,deployment}` histograms,
        first-class TTFT/TPOT distributions, and timeline sub-spans."""
        from ray_tpu_torch._private import task_events

        node_hex = bytes(p.get("node_id") or b"").hex()
        for req in p.get("requests", []):
            phases = {str(k): float(v) for k, v in (req.get("phases") or {}).items()}
            if not phases:
                continue
            dep = str(req.get("deployment") or "deployment")
            name = f"serve:{dep}"
            durs = task_events.durations(phases)
            rec = {
                "task_id": "",
                "name": name,
                "node_id": node_hex,
                "pid": int(req.get("pid", 0)),
                "error": bool(req.get("error")),
                "trace": {
                    str(k): str(v) for k, v in (req.get("trace") or {}).items()
                },
                "phases": phases,
                "durations": durs,
                "ttft_s": req.get("ttft_s"),
                "tpot_s": req.get("tpot_s"),
                "tokens": int(req.get("tokens") or 0),
            }
            self.task_records.append(rec)
            for stage, dur in durs.items():
                if not stage.startswith("serve_"):
                    continue
                self._observe_hist(
                    task_events.SERVE_METRIC,
                    task_events.SERVE_METRIC_HELP,
                    task_events.SERVE_HISTOGRAM_BOUNDARIES,
                    {"stage": stage, "deployment": dep},
                    dur,
                )
            if rec["ttft_s"] is not None:
                self._observe_hist(
                    task_events.SERVE_TTFT_METRIC,
                    task_events.SERVE_TTFT_HELP,
                    task_events.SERVE_HISTOGRAM_BOUNDARIES,
                    {"deployment": dep},
                    float(rec["ttft_s"]),
                )
            if rec["tpot_s"] is not None:
                self._observe_hist(
                    task_events.SERVE_TPOT_METRIC,
                    task_events.SERVE_TPOT_HELP,
                    task_events.TPOT_HISTOGRAM_BOUNDARIES,
                    {"deployment": dep},
                    float(rec["tpot_s"]),
                )
            start = phases.get("serve_replica_recv") or phases.get("serve_proxy_recv", 0.0)
            end = phases.get("serve_handler_end", start)
            self.timeline.append(
                {
                    "name": name,
                    "pid": rec["pid"],
                    "ts": start,
                    "dur": max(0.0, end - start),
                    "error": rec["error"],
                    "trace": rec["trace"],
                    "phases": phases,
                    "task_id": "",
                }
            )
        return {}

    async def h_train_step(self, cid, conn, p):
        """A batch of train-step flight records plus the probe's rolling
        stats (fire-and-forget TRAIN_STEP frame from
        train/torch/step_probe.py).  Steps join the ring/timeline/
        histograms; the rolling stats become the jitter/MFU gauges the
        SLO watchdog and `ray-tpu summary train` read."""
        from ray_tpu_torch._private import task_events

        node_hex = bytes(p.get("node_id") or b"").hex()
        run = str(p.get("name") or "train")
        name = f"train:{run}"
        for step in p.get("steps", []):
            phases = {str(k): float(v) for k, v in (step.get("phases") or {}).items()}
            if not phases:
                continue
            durs = task_events.durations(phases)
            self.task_records.append(
                {
                    "task_id": f"{run}:{int(step.get('seq', 0))}",
                    "name": name,
                    "node_id": node_hex,
                    "pid": int(step.get("pid", 0)),
                    "error": False,
                    "trace": {},
                    "phases": phases,
                    "durations": durs,
                }
            )
            for phase, dur in durs.items():
                if not phase.startswith("train_"):
                    continue
                self._observe_hist(
                    task_events.TRAIN_METRIC,
                    task_events.TRAIN_METRIC_HELP,
                    task_events.PHASE_HISTOGRAM_BOUNDARIES,
                    {"phase": phase, "name": run},
                    dur,
                )
            step_start = phases.get("train_step_start", 0.0)
            self.timeline.append(
                {
                    "name": name,
                    "pid": int(step.get("pid", 0)),
                    "ts": step_start,
                    "dur": max(
                        0.0, phases.get("train_step_end", step_start) - step_start
                    ),
                    "error": False,
                    "trace": {},
                    "phases": phases,
                    "task_id": f"{run}:{int(step.get('seq', 0))}",
                }
            )
        stats = p.get("stats") or {}
        if stats:
            stats = {str(k): v for k, v in stats.items()}
            stats["node"] = node_hex[:12]
            stats["ts"] = time.time()
            self.train_stats[run] = stats
            if "jitter_pct" in stats:
                self._set_gauge(
                    task_events.TRAIN_JITTER_METRIC,
                    task_events.TRAIN_JITTER_HELP,
                    {"name": run},
                    float(stats["jitter_pct"]),
                )
            if "mfu" in stats:
                self._set_gauge(
                    task_events.TRAIN_MFU_METRIC,
                    task_events.TRAIN_MFU_HELP,
                    {"name": run},
                    float(stats["mfu"]),
                )
        return {}

    def _chaos_emit(self, ev: dict):
        self._record_event("WARNING", "chaos", ev["message"], **ev["fields"])

    async def h_chaos_ctrl(self, cid, conn, p):
        """Runtime chaos arm/disarm from the driver, applied here and
        fanned out: live chaos-aware processes get the push on the
        "chaos" pubsub channel; late joiners read the KV entry at
        startup.  Runtime-armed plans are deliberately NOT WAL-persisted
        — a restarted head comes back fault-free unless env re-arms it."""
        import json as _json

        op = str(p.get("op", ""))
        if op == "arm":
            plan, seed = str(p.get("plan", "")), int(p.get("seed", 0))
            ctrl = {"op": "arm", "plan": plan, "seed": seed}
            chaos.apply_ctrl(ctrl)
            self.kv["chaos:plan"] = _json.dumps(ctrl).encode()
            self._record_event("WARNING", "chaos", f"chaos armed: {plan}", seed=seed)
        elif op == "disarm":
            chaos.apply_ctrl({"op": "disarm"})
            self.kv.pop("chaos:plan", None)
            self._record_event("INFO", "chaos", "chaos disarmed")
        elif op != "status":
            raise ValueError(f"unknown chaos op {op!r}")
        if op != "status":
            await self._publish(
                "chaos",
                {"op": op, "plan": str(p.get("plan", "")), "seed": int(p.get("seed", 0))},
            )
        return {"ok": True, "status": chaos.status()}

    # ------------------------------------------------- sampling profiler

    async def h_profile_ctrl(self, cid, conn, p):
        """Cluster-wide profiler control (util/profile_api.py): arm /
        disarm fan out exactly like chaos — applied here, stored in KV
        ``profile:ctrl`` for late joiners, pushed to live processes over
        the ``profile`` pubsub channel.  ``collect`` returns the folded
        stacks aggregated per (role, node); ``stacks`` broadcasts a
        one-shot native stack-dump request whose replies ``collect_stacks``
        then returns (`ray-tpu stacks`)."""
        import json as _json

        op = str(p.get("op", ""))
        if op == "arm":
            ctrl = {
                "op": "arm",
                "hz": int(p.get("hz") or RayConfig.profiler_hz),
                "roles": p.get("roles") or None,
                "deep": bool(p.get("deep")),
            }
            if p.get("clear", True):
                self._clear_profile_aggregation()
            self.profile_ctrl = ctrl
            _profiler.apply_ctrl(ctrl)
            self.kv["profile:ctrl"] = _json.dumps(ctrl).encode()
            self._record_event(
                "INFO",
                "profiler",
                f"profiler armed at {ctrl['hz']}Hz",
                hz=ctrl["hz"],
                roles=ctrl["roles"],
                deep=ctrl["deep"],
            )
            await self._publish("profile", ctrl)
        elif op == "disarm":
            self.profile_ctrl = None
            _profiler.apply_ctrl({"op": "disarm"})
            self.kv.pop("profile:ctrl", None)
            self._record_event("INFO", "profiler", "profiler disarmed")
            await self._publish("profile", {"op": "disarm"})
        elif op == "collect":
            out = {
                "stacks": {
                    f"{role}|{node}": dict(stacks)
                    for (role, node), stacks in self.profile_stacks.items()
                },
                "meta": {
                    f"{role}|{node}": dict(meta)
                    for (role, node), meta in self.profile_meta.items()
                },
            }
            if p.get("clear"):
                self._clear_profile_aggregation()
            return out
        elif op == "stacks":
            # one-shot native stack dump, cluster-wide: clear the last
            # harvest, dump this process in-band, fan the request out
            self.profile_stack_dumps = [
                {
                    "role": "head",
                    "pid": os.getpid(),
                    "node": self.head_node_id.hex()[:12],
                    "text": _profiler.dump_stacks(),
                }
            ]
            await self._publish("profile", {"op": "stacks"})
        elif op == "collect_stacks":
            return {"dumps": list(self.profile_stack_dumps)}
        elif op != "status":
            raise ValueError(f"unknown profile op {op!r}")
        agg = {
            f"{role}|{node}": {
                "samples": sum(stacks.values()),
                "distinct_stacks": len(stacks),
                **{
                    k: v
                    for k, v in self.profile_meta.get((role, node), {}).items()
                    if k in ("overhead_ratio", "idle", "hz")
                },
            }
            for (role, node), stacks in self.profile_stacks.items()
        }
        return {
            "ok": True,
            "armed": self.profile_ctrl is not None,
            "ctrl": dict(self.profile_ctrl) if self.profile_ctrl else None,
            "aggregate": agg,
            "local": _profiler.status(),
        }

    def _clear_profile_aggregation(self):
        self.profile_stacks.clear()
        self.profile_meta.clear()
        self.profile_slices.clear()

    async def h_profile_stats(self, cid, conn, p):
        """Fire-and-forget folded-stack delta (or stack-dump) frame from
        an armed process — one per flush window, never per sample."""
        self._ingest_profile_frame(p)
        return {}

    def _ingest_profile_frame(self, p: dict):
        node_raw = p.get("node_id")
        node = bytes(node_raw).hex()[:12] if node_raw else "local"
        role_proc = str(p.get("role", "?"))
        pid = int(p.get("pid") or 0)
        if "stack_dump" in p:
            if len(self.profile_stack_dumps) < 256:
                self.profile_stack_dumps.append(
                    {
                        "role": role_proc,
                        "pid": pid,
                        "node": node,
                        "text": str(p["stack_dump"]),
                    }
                )
            return
        stacks = p.get("stacks") or {}
        per_role: Dict[str, int] = {}
        for folded, n in stacks.items():
            folded = str(folded)
            # the stack's own root segment is its effective role: engine /
            # dashboard threads aggregate under their thread-role even
            # though the shipping process is a worker
            role = folded.split(";", 1)[0]
            n = int(n)
            per_role[role] = per_role.get(role, 0) + n
            bucket = self.profile_stacks.setdefault((role, node), {})
            bucket[folded] = bucket.get(folded, 0) + n
            if len(bucket) > RayConfig.profiler_max_stacks:
                self._trim_profile_bucket(role, bucket)
        for role, n in per_role.items():
            self._inc_counter(
                "ray_tpu_torch_profiler_samples_total",
                "Wall-clock profiler stack samples aggregated at the head",
                {"role": role, "node": node},
                float(n),
            )
        wall = float(p.get("wall_s") or 0.0)
        if wall > 0:
            ratio = float(p.get("overhead_s") or 0.0) / wall
            self._set_gauge(
                "ray_tpu_torch_profiler_overhead_ratio",
                "Fraction of wall time the armed sampler spends sampling "
                "(the ≤5% contract's numerator)",
                {"role": role_proc, "node": node},
                ratio,
            )
            # meta lands under every stack-root role this frame carried
            # (plus the process role): an engine/dashboard bucket's
            # sampler IS its host process's sampler, so its status row
            # must show that sampler's overhead/hz, not blanks
            for meta_role in set(per_role) | {role_proc}:
                meta = self.profile_meta.setdefault((meta_role, node), {})
                meta.update(
                    {
                        "overhead_ratio": ratio,
                        "idle": int(p.get("idle") or 0),
                        "hz": int(p.get("hz") or 0),
                        "pid": pid,
                    }
                )
        if per_role:
            top = sorted(stacks.items(), key=lambda kv: -int(kv[1]))[:5]
            self.profile_slices.append(
                {
                    "t0": float(p.get("t0") or time.time()),
                    "t1": float(p.get("t1") or time.time()),
                    "role": role_proc,
                    "node": node,
                    "pid": pid,
                    "samples": sum(per_role.values()),
                    "top": [[k, int(v)] for k, v in top],
                }
            )

    @staticmethod
    def _trim_profile_bucket(role: str, bucket: Dict[str, int]):
        """Cap a (role, node) bucket at profiler_max_stacks by folding the
        smallest counts into one <other> stack — sample totals stay exact,
        only the tail's split degrades."""
        keep = RayConfig.profiler_max_stacks * 3 // 4
        ranked = sorted(bucket.items(), key=lambda kv: -kv[1])
        spill = sum(n for _, n in ranked[keep:])
        bucket.clear()
        bucket.update(ranked[:keep])
        other = f"{role};<other>"
        bucket[other] = bucket.get(other, 0) + spill

    def _record_event(self, severity: str, source: str, message: str, **fields):
        self.events.append(
            {
                "timestamp": time.time(),
                "severity": severity,
                "source": source,
                "message": message,
                **fields,
            }
        )

    async def h_list_events(self, cid, conn, p):
        limit = int(p.get("limit", 1000))
        if limit <= 0:
            return {"events": []}
        return {"events": list(self.events)[-limit:]}

    async def h_record_event(self, cid, conn, p):
        """Remote processes (raylets, workers) append to the head's
        cluster-event ring (reference analog: src/ray/util/event.h events
        flowing to the dashboard event module)."""
        # sanitize remote-controlled fields: keys must be strings and must
        # not collide with the event envelope (severity/source/message/
        # timestamp), or the splat raises / silently rewrites history
        fields = {
            str(k): v
            for k, v in (p.get("fields") or {}).items()
            if str(k) not in ("severity", "source", "message", "timestamp")
        }
        self._record_event(
            str(p.get("severity", "INFO")),
            str(p.get("source", "remote")),
            str(p.get("message", "")),
            **fields,
        )
        return {"ok": True}

    async def h_list_objects(self, cid, conn, p):
        """Directory dump for `ray list objects` (reference analog:
        experimental/state/api.py:991 backed by the StateAggregator)."""
        import itertools

        limit = int(p.get("limit", 1000))
        out = []
        # safe to islice the live dict: this handler has no awaits inside
        # the loop, so nothing mutates the directory mid-iteration
        for oid, entry in itertools.islice(self.objects.items(), limit):
            spilled = self.object_spilled.get(oid)
            out.append(
                {
                    "object_id": oid,
                    "state": {PENDING: "PENDING", SEALED: "SEALED", ERRORED: "ERRORED"}[entry[0]],
                    "ref_count": self.object_refcounts.get(oid, 0),
                    "locations": [n.hex() for n in self.object_locations.get(oid, ())],
                    "spilled": bool(spilled),
                    "has_lineage": oid in self.lineage,
                }
            )
        return {"objects": out, "total": len(self.objects)}

    # timeline sub-span labels per flight-recorder duration (task_events
    # .DURATIONS keys); e2e spans both processes and stays implicit in the
    # submit→done stamps carried in args
    _TIMELINE_PHASES = (
        ("queue-wait", "head_enqueue", "dispatch"),
        ("deliver", "dispatch", "worker_dequeue"),
        ("arg-fetch", "arg_fetch_start", "arg_fetch_end"),
        ("exec", "exec_start", "exec_end"),
        ("put", "put_start", "put_end"),
        # compiled-DAG / serve-request / train-step records come straight
        # from the canonical phase vocabulary, so a phase added there can
        # never silently miss the timeline — records without the stamps
        # skip them
    ) + tuple(
        (name, start, end)
        for name, (start, end) in _task_events.DURATIONS.items()
        if name.startswith(("dag_", "serve_", "train_"))
    )

    async def h_timeline(self, cid, conn, p):
        """Chrome-trace events of recent task executions, nested per-phase
        sub-spans from the flight recorder, and cluster events (chaos
        faults, node/worker transitions) as instant markers — one view for
        fault → latency-spike causality
        (reference: `ray timeline` scripts.py → profile table dump)."""
        events = []
        for e in self.timeline:
            trace = e.get("trace") or {}
            events.append(
                {
                    "name": e["name"],
                    "cat": "task",
                    "ph": "X",
                    "ts": e["ts"] * 1e6,
                    "dur": e["dur"] * 1e6,
                    "pid": e["pid"],
                    "tid": e["pid"],
                    "args": {"error": e["error"], **trace},
                    "trace": trace,
                }
            )
            phases = e.get("phases") or {}
            for label, start, end in self._TIMELINE_PHASES:
                ts, te = phases.get(start), phases.get(end)
                if ts is None or te is None:
                    continue
                events.append(
                    {
                        "name": f"{e['name']}:{label}",
                        "cat": "task_phase",
                        "ph": "X",
                        "ts": ts * 1e6,
                        "dur": max(0.0, te - ts) * 1e6,
                        "pid": e["pid"],
                        "tid": e["pid"],
                        "args": {
                            "phase": label,
                            "task_id": e.get("task_id", ""),
                            **trace,
                        },
                        "trace": trace,
                    }
                )
        for ev in self.events:
            events.append(
                {
                    "name": f"{ev.get('source', '')}: {ev.get('message', '')}",
                    "cat": f"event:{ev.get('source', '')}",
                    "ph": "i",
                    "s": "g",
                    "ts": ev.get("timestamp", 0.0) * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {
                        k: v
                        for k, v in ev.items()
                        if k not in ("timestamp", "message", "source")
                    },
                }
            )
        # trace-stamped log records join the same view as instant markers:
        # "which line printed during which traced phase" without leaving
        # the timeline (records reach here via the logs pubsub transit)
        for rec in self._log_trace_marks:
            events.append(
                {
                    "name": f"log: {str(rec.get('msg', ''))[:120]}",
                    "cat": "log",
                    "ph": "i",
                    "s": "t",
                    "ts": (rec.get("ts") or 0.0) * 1e6,
                    "pid": rec.get("pid", 0),
                    "tid": rec.get("pid", 0),
                    "args": {
                        "msg": rec.get("msg", ""),
                        "stream": rec.get("stream", ""),
                        "node": rec.get("node", ""),
                        "task_id": rec.get("task", ""),
                        "trace_id": rec.get("trace", ""),
                    },
                    "trace": {"trace_id": rec.get("trace", "")},
                }
            )
        # sampled-stack slices (one per profiler flush window per process)
        # render as spans on the same view, so a queue-wait span and the
        # stacks that caused it sit side by side; args carry the window's
        # top folded stacks for drill-down
        for s in self.profile_slices:
            events.append(
                {
                    "name": f"profile:{s['role']}",
                    "cat": "profile",
                    "ph": "X",
                    "ts": s["t0"] * 1e6,
                    "dur": max(0.0, s["t1"] - s["t0"]) * 1e6,
                    "pid": s["pid"],
                    "tid": s["pid"],
                    "args": {
                        "role": s["role"],
                        "node": s["node"],
                        "samples": s["samples"],
                        "top_stacks": s["top"],
                    },
                }
            )
        return {"events": events}

    async def h_drain_node(self, cid, conn, p):
        nid = p["node_id"]
        await self._on_node_dead(nid)
        return {"ok": True}

    # -------------------------------------------------------------- scheduler

    def _kick_scheduler(self):
        self._sched_wakeup.set()

    def _task_resources(self, spec: TaskSpec) -> Dict[str, float]:
        return spec.resources or {"CPU": 1.0}

    def _release_creation_cpu(self, actor, node, spec: TaskSpec):
        """Give back the implicit creation CPU exactly once per actor
        incarnation (at ALIVE, or on death mid-creation — whichever comes
        first); explicit num_cpus and PG-bundle actors hold theirs."""
        if not getattr(spec, "implicit_cpu", False) or spec.pg_id or node is None:
            return
        if actor is not None:
            if actor.creation_cpu_released:
                return
            actor.creation_cpu_released = True
        cpu = (spec.resources or {"CPU": 1.0}).get("CPU", 0.0)
        if cpu > 0:
            node.release({"CPU": cpu})

    def _actor_lifetime_resources(self, spec: TaskSpec) -> Dict[str, float]:
        """What a LIVE actor holds: its declared resources, minus the
        creation-only implicit CPU (released at ALIVE; reference
        semantics: actors default to 0 CPU once running)."""
        res = dict(spec.resources or {"CPU": 1.0})
        if getattr(spec, "implicit_cpu", False) and not spec.pg_id:
            res.pop("CPU", None)
        return res

    def _release_task_resources(self, node: NodeInfo, spec: TaskSpec):
        res = self._task_resources(spec)
        if spec.pg_id and spec.pg_id in self.pgs:
            pg = self.pgs[spec.pg_id]
            idx = spec.pg_bundle_index if spec.pg_bundle_index >= 0 else 0
            if idx < len(pg.bundle_available):
                for k, v in res.items():
                    if v > 0:
                        pg.bundle_available[idx][k] = pg.bundle_available[idx].get(k, 0.0) + v
        else:
            node.release(res)

    def _pick_node(self, spec: TaskSpec) -> Optional[NodeInfo]:
        """Hybrid scheduling policy (reference:
        scheduling/policy/hybrid_scheduling_policy.h:48): pack onto the
        best-utilized feasible node while utilization < threshold, else
        spread to the least utilized."""
        res = self._task_resources(spec)
        if spec.pg_id:
            pg = self.pgs.get(spec.pg_id)
            if pg is None or pg.state != "CREATED":
                return None
            idx = spec.pg_bundle_index
            candidates = range(len(pg.bundles)) if idx < 0 else [idx]
            for i in candidates:
                nid = pg.bundle_nodes[i]
                node = self.nodes.get(nid) if nid else None
                if node is None or not node.alive:
                    continue
                av = pg.bundle_available[i]
                if all(av.get(k, 0.0) + 1e-9 >= v for k, v in res.items() if v > 0):
                    # consume from the bundle, not the node pool
                    for k, v in res.items():
                        if v > 0:
                            av[k] = av.get(k, 0.0) - v
                    spec.pg_bundle_index = i
                    return node
            return None
        if spec.node_affinity:
            node = self.nodes.get(spec.node_affinity)
            if node and node.alive and node.try_acquire(res):
                return node
            return None
        # decision + reservation in one native call (hybrid pack/spread)
        nid = self.sched.pick_and_acquire(
            res, RayConfig.scheduler_spread_threshold, prefer=self.head_node_id
        )
        if nid is None:
            return None
        return self.nodes.get(nid)

    async def _scheduler_loop(self):
        while not self._shutdown:
            self._sched_wakeup.clear()
            try:
                await self._schedule_once()
            except Exception:
                logger.exception("scheduler tick failed")
            try:
                await asyncio.wait_for(self._sched_wakeup.wait(), timeout=0.5)
                if len(self.task_queue) > 1024:
                    # genuinely deep backlog: let a few more completions
                    # land so one scan dispatches several workers' worth
                    # (amortizes the O(queue) pass).  Threshold matters:
                    # at >64 the sleep taxed every ~100-task burst (batch
                    # microbench 1390/s -> 772/s); longer sleeps measured
                    # worse too (workers idle waiting)
                    await asyncio.sleep(0.002)
            except asyncio.TimeoutError:
                pass

    async def _schedule_once(self):
        if self._recovery is not None:
            # recovery grace window: dispatch holds while live peers
            # re-attach — placing work on half-reconciled capacity could
            # double-book workers whose running tasks haven't been
            # re-announced yet (gcs/HEAD_FT.md)
            return
        # retry pending PGs (e.g. after resources freed / node added)
        for pg in self.pgs.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                self._try_place_pg(pg)
        # re-admit actors parked by preemption once capacity returns (and
        # no SLO-policy hold / queued higher-band work would immediately
        # re-evict them)
        if self._preempted_parked and not self._slo_preempt_hold:
            self._readmit_preempted()
        if not self.task_queue:
            return
        self._preempt_scans_left = 4  # bound victim-scan work per tick
        self._order_task_queue()
        remaining: List[TaskEntry] = []
        spawn_demand: Dict[bytes, int] = {}
        # dispatch-capacity snapshot, PER NODE: idle workers + spawnable
        # slots.  Once the cluster-wide total hits zero NOTHING can dispatch
        # this tick, so stop scanning — without this a deep backlog (10k+
        # queued) pays an O(queue) scan per tick, O(queue²) per drain
        # (measured 140s for a 10k drain).  Per-node counters (not one
        # global counter) so a backlog head pinned to one saturated node
        # cannot exhaust the budget and hide tasks placeable on OTHER idle
        # nodes in the same tick.  Counting is conservative (idle GPU
        # workers count as slots for CPU tasks), which only lengthens the
        # scan, never skips a dispatchable task.
        node_slots: Dict[bytes, int] = {}
        for node in self.nodes.values():
            if not node.alive:
                continue
            # O(1) from the idle index (was an O(workers) scan per tick)
            idle = len(node.idle_pool[False]) + len(node.idle_pool[True])
            limit = RayConfig.worker_startup_concurrency or max(
                2, int(node.resources_total.get("CPU", 2))
            )
            headroom = RayConfig.worker_pool_max_workers - len(node.workers)
            node_slots[node.node_id] = idle + max(
                0, min(headroom, limit) - node.starting_workers
            )
        total_slots = sum(node_slots.values())
        # tasks that reserved resources but found no idle worker this tick;
        # reservations are held until the end so demand is capped by what the
        # node can actually run simultaneously (not by queue length)
        unfulfilled: List[Tuple[TaskEntry, NodeInfo]] = []
        # bound the pick+release work spent skipping past a backlog pinned
        # to slot-exhausted nodes: past this many skips the rest of the
        # queue waits for the next tick (keeps a 10k-deep single-node
        # backlog from restoring the O(queue²) drain while another node
        # holds one idle slot)
        exhausted_skips = 64 + 8 * len(node_slots)
        # resource shapes that already failed placement THIS tick: within a
        # tick resources are only consumed (releases land after the loop),
        # so a failed shape cannot succeed later in the same scan — skip
        # the native pick for the rest of a deep homogeneous backlog
        # (measured: 430 failed pick_and_acquire calls per drained task
        # without this, the whole-queue rescan per tick)
        failed_shapes: set = set()
        for i, entry in enumerate(self.task_queue):
            if total_slots <= 0 or exhausted_skips <= 0:
                remaining.extend(self.task_queue[i:])
                break
            spec = entry.spec
            shape = None
            if not spec.pg_id and not spec.node_affinity:
                shape = entry.res_shape
                if shape is None:
                    shape = entry.res_shape = tuple(
                        sorted(self._task_resources(spec).items())
                    )
                if shape in failed_shapes:
                    remaining.append(entry)
                    continue
            node = self._pick_node(spec)
            if node is None:
                # Infeasible tasks stay pending — a node with the resources
                # may join later (reference semantics: raylet keeps
                # infeasible tasks queued and warns; the autoscaler reacts).
                if shape is not None:
                    failed_shapes.add(shape)
                # a band-above-floor request that cannot place may evict
                # lower-band work (victims die async; a later tick places us)
                if spec.priority > 0 and self._preempt_scans_left > 0:
                    self._maybe_preempt(entry)
                remaining.append(entry)
                continue
            if node_slots.get(node.node_id, 0) <= 0:
                # this node's dispatch capacity is spent for the tick, but
                # other nodes may still have slots: release the reservation
                # and keep scanning rather than burning the global budget
                self._release_task_resources(node, spec)
                # the release invalidates failed_shapes' only-consumed-
                # within-a-tick premise: a shape that failed while this
                # reservation was held may fit now — clear so it isn't
                # skipped for the rest of the scan (cost bounded by
                # exhausted_skips, which caps how often this branch runs)
                failed_shapes.clear()
                remaining.append(entry)
                exhausted_skips -= 1
                continue
            worker = self._find_idle_worker(node, spec)
            if worker is None:
                key = (node.node_id, self._needs_gpu(spec))
                spawn_demand[key] = spawn_demand.get(key, 0) + 1
                unfulfilled.append((entry, node))
                remaining.append(entry)
                node_slots[node.node_id] -= 1  # consumed a spawn slot
                total_slots -= 1
                continue
            await self._dispatch(entry, node, worker)
            node_slots[node.node_id] -= 1
            total_slots -= 1
        for entry, node in unfulfilled:
            self._release_task_resources(node, entry.spec)
        self.task_queue = remaining
        # spawn-ahead for queued actor creations: a creation blocked on
        # the creation CPU will need a fresh dedicated worker the moment a
        # slot frees — overlap the (slow) process spawn with the current
        # creations' startup instead of serializing spawn → create →
        # spawn.  Excess spawns become idle pool workers (reused by the
        # next creation or reaped on the idle timeout), so this only
        # pipelines work that is already committed.
        creation_backlog = sum(
            1
            for e in remaining
            if e.spec.task_type == ACTOR_CREATION_TASK and not self._needs_gpu(e.spec)
        )
        if creation_backlog:
            alive = [n for n in self.nodes.values() if n.alive]
            per_node = max(1, creation_backlog // max(1, len(alive)))
            for node in alive:
                idle_here = len(node.idle_pool[False])
                want = per_node - idle_here - node.starting_workers
                if want > 0:
                    spawn_demand[(node.node_id, False)] = max(
                        spawn_demand.get((node.node_id, False), 0),
                        node.starting_workers + want,
                    )
        for (nid, gpu), demand in spawn_demand.items():
            node = self.nodes.get(nid)
            if node is not None:
                self._maybe_spawn_worker(node, demand, gpu)

    @staticmethod
    def _needs_gpu(spec: TaskSpec) -> bool:
        return (spec.resources or {}).get(RayConfig.gpu_resource_name, 0) > 0

    def _find_idle_worker(self, node: NodeInfo, spec: TaskSpec) -> Optional[WorkerInfo]:
        return node.pop_idle(self._needs_gpu(spec))

    def _maybe_spawn_worker(self, node: NodeInfo, demand: int = 1, gpu: bool = False):
        """Spawn workers up to current demand — the startup-token discipline
        of the reference's WorkerPool (worker_pool.cc:218
        StartWorkerProcess + MonitorStartingWorkerProcess:485).  Concurrent
        STARTS are capped at ~#CPUs (reference maximum_startup_concurrency):
        an uncapped 25-way python-import storm on a small host starves the
        running workers' heartbeats; the pending demand drains across ticks
        as registrations free tokens."""
        startup_limit = RayConfig.worker_startup_concurrency or max(
            2, int(node.resources_total.get("CPU", 2))
        )
        while node.starting_workers < min(demand, startup_limit):
            pool_size = len(node.workers) + node.starting_workers
            if pool_size >= RayConfig.worker_pool_max_workers:
                return
            node.starting_workers += 1
            if node.conn is None:
                self._spawn_local_worker(node, gpu)
            else:
                asyncio.get_running_loop().create_task(
                    node.conn.send(MsgType.PUSH_TASK, {"directive": "spawn_worker", "gpu": gpu})
                )

    def _spawn_local_worker(self, node: NodeInfo, gpu: bool = False):
        self._next_worker_seq += 1
        env = dict(os.environ)
        env.update(self._worker_env)
        env["RAY_TPU_HEAD"] = f"{self.host}:{self.port}"
        env["RAY_TPU_NODE_ID"] = node.node_id.hex()
        env["RAY_TPU_STORE_PATH"] = node.store_path
        # per-process chaos stream id: worker k's fault decisions come from
        # a distinct deterministic RNG stream (chaos.py stream_seed)
        env["RAY_TPU_CHAOS_NONCE"] = str(self._next_worker_seq)
        if gpu:
            # GPU worker: keeps the ambient CUDA_VISIBLE_DEVICES — this
            # worker owns every card of the node
            env["RAY_TPU_WORKER_GPU"] = "1"
        else:
            # pool workers see no card: CUDA stays uninitialisable there
            env["CUDA_VISIBLE_DEVICES"] = ""
            env.pop("RAY_TPU_WORKER_GPU", None)
        log = os.path.join(self.session_dir, f"worker-head-{self._next_worker_seq}.log")
        if not gpu:
            # pool workers fork from the warm zygote (~30ms vs ~1s exec);
            # GPU workers keep exec (a forked child cannot initialise CUDA).
            # The zygote pipe round trip is blocking — run it in a thread so
            # the event loop keeps serving RPCs (first spawn pays the
            # zygote's own ~1s preimport)
            if self._zygote is None:
                from ray_tpu_torch._private.zygote import ZygoteSpawner

                self._zygote = ZygoteSpawner(
                    dict(env), os.path.join(self.session_dir, "zygote-head.log")
                )
            asyncio.get_running_loop().run_in_executor(
                None, self._spawn_pool_worker_blocking, env, log
            )
            return
        with open(log, "ab") as logf:
            subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
                env=env,
                stdout=logf,
                stderr=logf,
                start_new_session=True,
            )

    def _spawn_pool_worker_blocking(self, env: dict, log: str):
        """Executor-thread body: zygote fork with exec fallback."""
        if self._zygote is not None and self._zygote.spawn(env, log) is not None:
            return
        try:
            with open(log, "ab") as logf:
                subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
                    env=env,
                    stdout=logf,
                    stderr=logf,
                    start_new_session=True,
                )
        except Exception:
            logger.exception("pool worker spawn failed")

    async def _dispatch(self, entry: TaskEntry, node: NodeInfo, worker: WorkerInfo):
        spec = entry.spec
        # fair-share: a dispatch drains a quantum from the job's deficit so
        # siblings in the same band take the next turns
        k = (spec.priority, bytes(spec.job_id or b""))
        d = self._job_deficit.get(k)
        if d is not None:
            self._job_deficit[k] = max(0.0, d - RayConfig.priority_fair_quantum_s)
        if spec.phases is not None:
            # shared with entry.wire (see h_submit_task), so the stamp
            # rides the cached PUSH_TASK frame to the worker
            spec.phases["dispatch"] = time.time()
        entry.state = "RUNNING"
        entry.worker_id = worker.worker_id
        entry.node_id = node.node_id
        node.mark_busy(worker)
        worker.running_tasks.add(spec.task_id)
        if spec.task_type == ACTOR_CREATION_TASK:
            worker.dedicated = True
            worker.actor_id = spec.actor_id
            actor = self.actors.get(spec.actor_id)
            if actor is not None:
                actor.worker_id = worker.worker_id
                actor.node_id = node.node_id
        try:
            # PG tasks re-encode: _pick_node may have just assigned the
            # bundle index, which the cached submit wire wouldn't carry
            wire = (
                entry.wire
                if entry.wire is not None and not spec.pg_id
                else spec.to_wire()
            )
            await worker.conn.send(MsgType.PUSH_TASK, {"spec": wire})
        except Exception:  # noqa: BLE001
            logger.warning(
                "task push to worker %s failed; declaring it dead",
                worker.worker_id.hex()[:8],
                exc_info=True,
            )
            await self._on_worker_dead(worker.worker_id, "push failed")

    # ----------------------------------- multi-tenant priorities / preemption

    def _order_task_queue(self):
        """Priority-aware dispatch order: higher bands first (with a
        one-band starvation boost once a task queues past
        ``priority_starvation_s``, so a starved low-band job still
        drains), weighted deficit fair-share within a band — each (band,
        job) accumulates queue-wait while it has work queued and a
        dispatch drains a quantum (``_dispatch``), so jobs that have
        waited longest take the next turns — and FIFO as the tiebreak.
        The single-tenant case (one band, one job) skips the sort: the
        queue stays the plain FIFO the drain-throughput work in
        ``_schedule_once`` was measured against."""
        q = self.task_queue
        now = time.time()
        dt = max(0.0, now - self._fair_tick_at)
        self._fair_tick_at = now
        keys = {(e.spec.priority, bytes(e.spec.job_id or b"")) for e in q}
        if len(keys) <= 1:
            if self._job_deficit:
                self._job_deficit = {
                    k: v for k, v in self._job_deficit.items() if k in keys
                }
            return
        # accumulate queue-wait once per (band, job) with work queued;
        # prune jobs whose queue drained (bounds the dict by live tenants)
        deficits = {k: v for k, v in self._job_deficit.items() if k in keys}
        for k in keys:
            deficits[k] = deficits.get(k, 0.0) + dt
        self._job_deficit = deficits
        starve = RayConfig.priority_starvation_s
        order = {id(e): i for i, e in enumerate(q)}

        def sort_key(e):
            band = e.spec.priority
            if starve > 0 and now - e.enqueued_at > starve:
                band += 1  # starvation boost: one band up, never unbounded
            return (
                -band,
                -deficits.get((e.spec.priority, bytes(e.spec.job_id or b"")), 0.0),
                order[id(e)],
            )

        q.sort(key=sort_key)

    def _readmit_preempted(self):
        """Respawn-with-restore: when a parked preempted actor's creation
        demand fits again and no queued higher-band work would immediately
        re-evict it, re-queue the creation task through the normal restart
        FSM (the worker restores from the saved checkpoint at creation).
        The fault-restart budget stays untouched — preemption is policy,
        not a fault."""
        # only FEASIBLE queued work counts against re-admission: a
        # permanently-infeasible high-band task (kept queued by design,
        # see _schedule_once) must not starve parked actors forever.
        # Fit answers are memoized per resource shape, so a deep
        # homogeneous backlog costs one total_fit plus a band-skip pass —
        # not the O(queue × nodes) scan the dispatch loop was
        # restructured to avoid.
        max_queued_band = -1
        shape_feasible: Dict[tuple, bool] = {}
        for e in self.task_queue:
            if e.spec.priority <= max_queued_band:
                continue
            shape = e.res_shape
            if shape is None:
                shape = tuple(sorted(self._task_resources(e.spec).items()))
            feas = shape_feasible.get(shape)
            if feas is None:
                res = dict(shape)
                feas = any(
                    n.alive and n.total_fit(res) for n in self.nodes.values()
                )
                shape_feasible[shape] = feas
            if feas:
                max_queued_band = e.spec.priority
        for aid in list(self._preempted_parked):
            actor = self.actors.get(aid)
            if actor is None or actor.state != ACTOR_PREEMPTED:
                self._preempted_parked.pop(aid, None)
                continue
            spec = actor.creation_spec
            if spec.priority < max_queued_band:
                continue  # higher-band work is still waiting for capacity
            res = self._task_resources(spec)
            if not any(
                n.alive and n.can_fit(res) for n in self.nodes.values()
            ):
                continue
            self._preempted_parked.pop(aid, None)
            self._requeue_actor_creation(actor)
            logger.info("re-admitting preempted actor %s", aid.hex()[:8])
            self._record_event(
                "INFO",
                "preempt",
                "actor re-admitted after preemption",
                actor_id=aid.hex(),
            )

    def _maybe_preempt(self, entry: TaskEntry) -> bool:
        """Victim selection for a band-N request that cannot place: find
        ONE node whose total capacity could hold the demand, walk its
        lower-band work bottom-up — idle preemptible-actor leases first
        (nothing in flight), then running best-effort tasks (kill +
        requeue on the preemption budget), then busy preemptible actors
        (checkpoint-respawn) — and evict the minimal prefix whose release
        covers the deficit.  All-or-nothing per node: freeing less than
        the demand would thrash lower bands without producing a
        placement."""
        now = time.time()
        save_deadline = RayConfig.actor_preempt_save_deadline_s
        if now - entry.preempt_requested_at < save_deadline + 2.0:
            return False  # victims from the last request may still be dying
        self._preempt_scans_left -= 1
        spec = entry.spec
        if spec.pg_id:
            return False  # PG demand is bundle-reserved; out of scope
        demand = self._task_resources(spec)
        band = spec.priority
        nodes = [n for n in self.nodes.values() if n.alive]
        if spec.node_affinity:
            nodes = [n for n in nodes if n.node_id == spec.node_affinity]
        # enumerate eligible victims ONCE cluster-wide, then node-filter
        # the (much smaller) candidate lists per node — not one full
        # actors+tasks table walk per node
        leases, idle_a, running, busy_a = self._victim_candidates(band)
        for node in nodes:
            if not node.total_fit(demand):
                continue
            nid = node.node_id
            cand = (
                [x for x in leases if x[1].node_id == nid],
                [x for x in idle_a if x[1].node_id == nid],
                [x for x in running if x[1].node_id == nid],
                [x for x in busy_a if x[1].node_id == nid],
            )
            victims = self._select_victims(node, band, demand, cand)
            if victims is None:
                continue
            entry.preempt_requested_at = now
            why = (
                f"band {band} "
                f"{spec.function_name or spec.method_name or 'task'} "
                "cannot place"
            )
            for kind, victim in victims:
                if kind == "task":
                    self._preempt_task_victim(victim, band, reason=why)
                elif kind == "lease":
                    self._revoke_lease(victim, band, reason=why)
                else:
                    self._spawn_actor_preempt(victim, band, reason=why)
            return True
        return False

    def _spawn_actor_preempt(
        self, actor: ActorInfo, band: int, reason: str = ""
    ) -> bool:
        """Reserve the victim SYNCHRONOUSLY (before the coroutine ever
        runs) and launch the checkpoint-respawn protocol.  Without the
        sync add, every victim scan in the same tick would re-count this
        actor's not-yet-released resources and over-evict elsewhere."""
        if actor.state != ACTOR_ALIVE or actor.actor_id in self._preempting:
            return False
        self._preempting.add(actor.actor_id)
        asyncio.get_running_loop().create_task(
            self._preempt_actor(actor, band, reason=reason)
        )
        return True

    def _victim_candidates(
        self, band: int, node_id: Optional[bytes] = None
    ) -> Tuple[List, List, List, List]:
        """Preemption-eligible work strictly below `band`, bucketed in
        the bottom-up eviction order — (cached worker leases, idle
        preemptible actors, running best-effort tasks, busy preemptible
        actors) — each entry a (victim_band, obj, releasable_resources)
        tuple, lowest band first.  Leases evict first: revocation is
        drain-and-return, the cheapest reclamation there is.  The ONE
        eligibility predicate shared by demand-driven victim selection
        and the SLO policy."""
        lease_bucket: List[Tuple[int, object, Dict[str, float]]] = []
        for lid, wid in self.leases.items():
            w = self.workers.get(wid)
            if w is None or w.lease is None or w.lease.get("revoking"):
                continue
            lband = int(w.lease.get("priority", 1))
            if lband >= band:
                continue
            if node_id is not None and w.node_id != node_id:
                continue
            lease_bucket.append((lband, w, dict(w.lease["resources"])))
        lease_bucket.sort(key=lambda x: x[0])
        idle_actors: List[Tuple[int, object, Dict[str, float]]] = []
        busy_actors: List[Tuple[int, object, Dict[str, float]]] = []
        running: List[Tuple[int, object, Dict[str, float]]] = []
        for actor in self.actors.values():
            cspec = actor.creation_spec
            if (
                actor.state != ACTOR_ALIVE
                or not cspec.preemptible
                or cspec.priority >= band
                or actor.actor_id in self._preempting
            ):
                continue
            if node_id is not None and actor.node_id != node_id:
                continue
            w = self.workers.get(actor.worker_id)
            if w is None:
                continue  # no process to strike
            release = self._actor_lifetime_resources(cspec)
            bucket = busy_actors if w.running_tasks else idle_actors
            bucket.append((cspec.priority, actor, release))
        for t in self.tasks.values():
            if (
                t.state != "RUNNING"
                or t.preempted
                or t.blocked
                or t.spec.task_type != NORMAL_TASK
                or t.spec.priority >= band
                or t.spec.pg_id
                or t.worker_id not in self.workers
            ):
                continue
            if node_id is not None and t.node_id != node_id:
                continue
            running.append((t.spec.priority, t, self._task_resources(t.spec)))
        for bucket in (idle_actors, running, busy_actors):
            bucket.sort(key=lambda x: x[0])  # lowest band evicted first
        return lease_bucket, idle_actors, running, busy_actors

    def _select_victims(
        self,
        node: NodeInfo,
        band: int,
        demand: Dict[str, float],
        candidates: Optional[Tuple[List, List, List, List]] = None,
    ) -> Optional[List[Tuple[str, object]]]:
        """Bottom-up victim set on one node covering `demand`'s deficit,
        or None when even evicting everything eligible wouldn't fit it.
        `candidates` is the node-filtered _victim_candidates tuple when
        the caller already enumerated cluster-wide."""
        avail = node.resources_available
        deficit = {
            k: v - avail.get(k, 0.0)
            for k, v in demand.items()
            if v > avail.get(k, 0.0) + 1e-9
        }
        if not deficit:
            return []  # already fits; nothing to evict
        leases, idle_actors, running, busy_actors = (
            candidates
            if candidates is not None
            else self._victim_candidates(band, node.node_id)
        )
        chosen: List[Tuple[str, object]] = []

        def take(cands, kind):
            for _, victim, release in cands:
                if not deficit:
                    return
                covers = False
                for k in list(deficit):
                    r = release.get(k, 0.0)
                    if r > 0:
                        covers = True
                        deficit[k] -= r
                        if deficit[k] <= 1e-9:
                            del deficit[k]
                if covers:
                    chosen.append((kind, victim))

        take(leases, "lease")  # cached worker leases: drain-and-return
        if deficit:
            take(idle_actors, "actor")  # idle leases: nothing in flight
        if deficit:
            take(running, "task")  # kill + requeue
        if deficit:
            take(busy_actors, "actor")  # checkpoint-respawn mid-work
        return None if deficit else chosen

    def _kill_worker_process(self, w: WorkerInfo, sig: int = 9):
        """Signal a worker process wherever it lives: os.kill reaches only
        this host, remote victims get a raylet directive.  An
        undeliverable directive (node gone, raylet conn dead) runs the
        worker-death path directly — a victim already marked preempted /
        PREEMPTED must not survive in name only, wedged out of both the
        victim scan and re-admission."""
        if w.node_id == self.head_node_id:
            try:
                os.kill(w.pid, sig)
            except OSError:
                pass
            return
        node = self.nodes.get(w.node_id)
        if node is None or node.conn is None:
            asyncio.get_running_loop().create_task(
                self._on_worker_dead(
                    w.worker_id, "kill directive undeliverable (node gone)"
                )
            )
            return

        async def _deliver():
            try:
                await node.conn.send(
                    MsgType.PUSH_TASK,
                    {"directive": "kill_worker", "pid": w.pid, "sig": sig},
                )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "kill_worker directive to node %s failed; declaring "
                    "worker %s dead",
                    w.node_id.hex()[:8],
                    w.worker_id.hex()[:8],
                    exc_info=True,
                )
                await self._on_worker_dead(
                    w.worker_id, "kill directive failed (raylet conn)"
                )

        asyncio.get_running_loop().create_task(_deliver())

    def _preempt_task_victim(
        self, entry: TaskEntry, band: int, reason: str = ""
    ):
        w = self.workers.get(entry.worker_id)
        if w is None or entry.preempted:
            return
        entry.preempted = True
        self._record_preemption(
            "task",
            victim_band=entry.spec.priority,
            requester_band=band,
            name=entry.spec.function_name,
            victim=bytes(entry.spec.task_id).hex()[:16],
            reason=reason,
        )
        # SIGKILL the worker; _on_worker_dead sees entry.preempted and
        # requeues on the preemption budget (never the fault-retry budget)
        self._kill_worker_process(w, 9)

    async def _preempt_actor(
        self, actor: ActorInfo, band: int, reason: str = ""
    ):
        """The checkpoint-respawn protocol: PREEMPT_ACTOR → the actor's
        optional ``__ray_save__`` runs under
        ``actor_preempt_save_deadline_s`` (the checkpoint lands in head
        KV before the worker replies) → graceful release with NO
        restart-budget charge, parked for re-admission.  A failed, late,
        or missing reply escalates to SIGKILL through the normal fault
        path — restart budget charged, immediate requeue.

        Only entered via _spawn_actor_preempt, which already reserved
        this actor in _preempting (synchronously, so same-tick victim
        scans can't double-count its release); the reservation is
        released in the finally below — EXCEPT on the forced path, where
        it is held until the SIGKILL's death event lands
        (_on_actor_worker_dead discards), so the window between
        state=ALIVE and the worker actually dying can't be re-preempted
        into an uncharged graceful park."""
        keep_reserved = False
        try:
            if actor.state != ACTOR_ALIVE:
                return
            w = self.workers.get(actor.worker_id)
            if w is None:
                return
            deadline = RayConfig.actor_preempt_save_deadline_s
            # mark first: new calls queue in pending_calls instead of
            # racing onto a worker that is about to release
            actor.state = ACTOR_PREEMPTED
            try:
                reply = await w.conn.request(
                    MsgType.PREEMPT_ACTOR,
                    {"actor_id": actor.actor_id, "save_deadline_s": deadline},
                    timeout=deadline + 3.0,
                )
                ok = bool(reply.get("ok"))
            except Exception:  # noqa: BLE001
                logger.warning(
                    "PREEMPT_ACTOR save rpc to %s failed/timed out; "
                    "escalating to a budget-charged kill",
                    actor.actor_id.hex()[:8],
                    exc_info=True,
                )
                ok = False
            if actor.state != ACTOR_PREEMPTED:
                # destroyed or died while saving (preempt racing a
                # voluntary exit / ray.kill): the other transition owns
                # cleanup; do not park, do not kill twice
                return
            if ok:
                self._record_preemption(
                    "actor",
                    victim_band=actor.creation_spec.priority,
                    requester_band=band,
                    name=actor.creation_spec.function_name,
                    victim=actor.actor_id.hex()[:16],
                    reason=reason,
                )
            else:
                if actor.worker_id is None:
                    # the worker died on its own while we were saving and
                    # _on_actor_worker_dead already parked this PREEMPTED
                    # actor — leave that transition in charge (flipping to
                    # ALIVE here would strand a parked entry whose
                    # re-admission check silently drops it: a permanent
                    # ALIVE-with-no-worker wedge)
                    return
                # escalate: back to ALIVE so the death path charges the
                # restart budget and requeues immediately (fault FSM);
                # the _preempting reservation rides until that death event
                actor.state = ACTOR_ALIVE
                keep_reserved = True
                self._record_preemption(
                    "actor_forced",
                    victim_band=actor.creation_spec.priority,
                    requester_band=band,
                    name=actor.creation_spec.function_name,
                    victim=actor.actor_id.hex()[:16],
                    reason=(reason + "; __ray_save__ missed its deadline")
                    .strip("; "),
                )
            w2 = self.workers.get(actor.worker_id or b"")
            if w2 is not None:
                # checkpoint (if any) is already durable in head KV — the
                # worker's kv_put completed before its reply — so SIGKILL
                # is safe on both paths
                self._kill_worker_process(w2, 9)
        finally:
            if not keep_reserved:
                self._preempting.discard(actor.actor_id)

    def _record_preemption(
        self,
        kind: str,
        victim_band: int,
        requester_band: int,
        name: str = "",
        victim: str = "",
        reason: str = "",
    ):
        self._preempt_log.append(
            {
                "ts": time.time(),
                "kind": kind,
                "band": victim_band,
                "requester_band": requester_band,
                "name": name,
                "victim": victim,
                "reason": reason,
            }
        )
        self._record_event(
            "WARNING",
            "preempt",
            f"preempted {kind} {name or victim} "
            f"(band {victim_band} -> requester band {requester_band})"
            + (f": {reason}" if reason else ""),
            kind=kind,
            victim=victim,
        )
        self._inc_counter(
            "ray_tpu_torch_preemptions_total",
            "Work evicted by the priority-preemptive scheduler, by victim "
            "band and kind (task / actor / actor_forced)",
            {"band": str(victim_band), "kind": kind},
        )

    def _inc_counter(self, metric, help_text, tags, inc: float = 1.0):
        """Head-owned counter series, same kv write-through as
        _set_gauge (deliberately not WAL-persisted)."""
        import json as _json

        from ray_tpu_torch.util import metrics as metrics_mod

        key = f"metrics:{metric}:{metrics_mod.tag_string(tags)}:head"
        rec = self._counter_cache.get(key)
        if rec is None:
            rec = {
                "kind": "counter",
                "value": 0.0,
                "description": help_text,
                "tags": tags,
            }
            self._counter_cache[key] = rec
        rec["value"] += inc
        rec["ts"] = time.time()
        self.kv[key] = _json.dumps(rec).encode()

    def _summary_preemptions(self, limit: int = 0) -> dict:
        """Backend of `ray-tpu summary preemptions`: the rolling victim
        log, the counter families, parked actors, and the SLO hold."""
        counts: Dict[str, float] = {}
        prefix = "metrics:ray_tpu_torch_preemptions_total:"
        for key, rec in self._counter_cache.items():
            if not key.startswith(prefix):
                continue
            tags = rec.get("tags") or {}
            counts[
                f"band={tags.get('band', '?')},kind={tags.get('kind', '?')}"
            ] = rec.get("value", 0.0)
        recs = list(self._preempt_log)
        return {
            "preemptions": recs[-limit:] if limit > 0 else recs,
            "counts": counts,
            "parked": [a.hex() for a in self._preempted_parked],
            "slo_hold": self._slo_preempt_hold,
            "total": len(recs),
        }

    def _summary_errors(self, limit: int = 0) -> dict:
        """Backend of `ray-tpu summary errors`: the signature-dedup view
        of the error ring — each distinct crash signature once, with
        first/last-seen and a count, newest-first — plus the counter
        family.  Dedup is the point: a hot loop throwing 10k times is ONE
        row with count=10000, not 10k rows."""
        counts: Dict[str, float] = {}
        prefix = "metrics:ray_tpu_torch_error_records_total:"
        for key, rec in self._counter_cache.items():
            if not key.startswith(prefix):
                continue
            tags = rec.get("tags") or {}
            counts[f"kind={tags.get('kind', '?')}"] = rec.get("value", 0.0)
        groups = sorted(
            self._error_index.values(),
            key=lambda g: g.get("last_ts", 0.0),
            reverse=True,
        )
        if limit > 0:
            groups = groups[:limit]
        rows = []
        for g in groups:
            sample = g.get("sample") or {}
            rows.append(
                {
                    "signature": g["signature"],
                    "kind": g.get("kind", "task"),
                    "count": g.get("count", 0),
                    "first_ts": g.get("first_ts", 0.0),
                    "last_ts": g.get("last_ts", 0.0),
                    "exc_type": sample.get("exc_type", ""),
                    "message": sample.get("message", ""),
                    "name": sample.get("name", ""),
                    "last": sample,
                }
            )
        return {
            "errors": rows,
            "counts": counts,
            "distinct": len(self._error_index),
            "total": len(self.error_records),
        }

    def _apply_slo_policy(self, spec: dict, verdict: dict, now: float):
        """SLO → policy: a sustained burn on a spec carrying
        ``preempt_below_band`` evicts the lowest-band victim instead of
        merely emitting a breach marker, and holds re-admission of parked
        preempted work; recovery lifts the hold so it returns."""
        band = spec.get("preempt_below_band")
        if band is None:
            return
        name = spec["name"]
        if verdict["ok"]:
            if self._slo_breach_ticks.pop(name, None) is not None:
                if not self._slo_breach_ticks and self._slo_preempt_hold:
                    self._slo_preempt_hold = False
                    self._record_event(
                        "INFO",
                        "preempt",
                        f"slo {name} recovered: re-admitting preempted work",
                        slo=name,
                    )
            return
        ticks = self._slo_breach_ticks.get(name, 0) + 1
        self._slo_breach_ticks[name] = ticks
        if ticks < RayConfig.slo_preempt_sustain_ticks:
            return
        self._slo_preempt_hold = True
        if now - self._last_policy_preempt < RayConfig.slo_preempt_cooldown_s:
            return
        if self._policy_preempt(
            int(band), reason=f"slo {name} sustained burn"
        ):
            self._last_policy_preempt = now

    def _policy_preempt(self, band_below: int, reason: str) -> bool:
        """Evict ONE victim below `band_below`, lowest band first,
        bottom-up across the cluster (cached leases, idle preemptible
        actors, running tasks, busy preemptible actors)."""
        leases, idle_actors, running, busy_actors = self._victim_candidates(
            band_below
        )
        for cands, kind in (
            (leases, "lease"),
            (idle_actors, "actor"),
            (running, "task"),
            (busy_actors, "actor"),
        ):
            if not cands:
                continue
            victim = cands[0][1]
            if kind == "task":
                self._preempt_task_victim(victim, band_below, reason=reason)
            elif kind == "lease":
                self._revoke_lease(victim, band_below, reason=reason)
            else:
                self._spawn_actor_preempt(victim, band_below, reason=reason)
            return True
        return False

    # ---------------------------------------------------------- maintenance

    async def _memory_monitor_loop(self):
        """OOM policy: when this host's memory crosses the threshold, kill
        ONE worker running a retriable normal task per pass — never a
        task's last attempt, so forward progress survives sustained
        pressure (analog: reference raylet worker_killing_policy.cc
        retriable-FIFO policy + memory_monitor.py:94)."""
        interval = RayConfig.memory_monitor_interval_s
        if interval <= 0:
            return
        while not self._shutdown:
            await asyncio.sleep(interval)
            try:
                import psutil

                usage = psutil.virtual_memory().percent / 100.0
            except Exception:  # graftlint: disable=silent-except -- psutil is optional; without it the OOM monitor degrades to a no-op by design
                continue
            if os.environ.get("RAY_TPU_TEST_FORCE_MEMORY_PRESSURE"):
                usage = 1.0
            if usage < RayConfig.memory_usage_threshold:
                continue
            victim = None
            for entry in self.tasks.values():
                if (
                    entry.state == "RUNNING"
                    and entry.spec.task_type == NORMAL_TASK
                    and entry.spec.retries_left > 0
                    and entry.worker_id in self.workers
                    # os.kill only reaches THIS host: never signal a pid
                    # that belongs to a remote node's worker
                    and self.workers[entry.worker_id].node_id == self.head_node_id
                ):
                    victim = self.workers[entry.worker_id]
                    break
            if victim is None:
                continue
            logger.warning(
                "memory pressure %.0f%%: killing worker %s (task will retry)",
                usage * 100,
                victim.worker_id.hex()[:8],
            )
            self._record_event(
                "WARNING",
                "oom",
                f"memory pressure {usage:.0%}: killing retriable worker",
                worker_id=victim.worker_id.hex(),
            )
            try:
                os.kill(victim.pid, 9)
            except OSError:
                pass

    # ------------------------------------------- workload observer / SLOs

    _OBSERVER_PERIOD_S = 2.0

    async def _workload_observer_loop(self):
        """The workload-plane watchdog: every tick it (a) refreshes the
        cluster memory gauges (shm occupancy per node, object directory
        accounting, spill counters) and (b) evaluates the declared SLOs
        over rolling windows of the head's aggregated histograms.  SLO
        breaches land in the cluster-event ring (source ``slo`` — instant
        markers on the chrome timeline next to chaos events) and export
        ray_tpu_torch_slo_ok / ray_tpu_torch_slo_burn_rate gauges — the policy signal
        ROADMAP item 5's preemption/autoscaling consumes."""
        while not self._shutdown:
            await asyncio.sleep(self._OBSERVER_PERIOD_S)
            try:
                self._refresh_memory_gauges()
                self._evaluate_slos()
            except Exception:  # noqa: BLE001
                logger.exception("workload observer tick failed")

    # drop DAG channel samples this long after their last DAG_STEP flush:
    # channel keys embed a per-compile random id and the head never sees
    # DAG_TEARDOWN (it rides the direct-call conns), so without an age-out
    # every compile would leak a stats entry + two gauge series forever
    # and dead DAGs would scrape as live occupancy
    _DAG_CHANNEL_TTL_S = 60.0

    def _expire_dag_channel_stats(self):
        from ray_tpu_torch.util import metrics as metrics_mod

        now = time.time()
        for key, stat in list(self.dag_channel_stats.items()):
            if now - float(stat.get("ts", 0.0)) <= self._DAG_CHANNEL_TTL_S:
                continue
            self.dag_channel_stats.pop(key, None)
            tag_str = metrics_mod.tag_string({"channel": key})
            self.kv.pop(
                f"metrics:ray_tpu_torch_dag_channel_occupancy:{tag_str}:head", None
            )
            self.kv.pop(
                f"metrics:ray_tpu_torch_dag_channel_slots:{tag_str}:head", None
            )

    def _refresh_memory_gauges(self):
        self._expire_dag_channel_stats()
        for nid, node in self.nodes.items():
            if not node.alive:
                continue
            stats = node.store_stats
            if nid == self.head_node_id and getattr(self, "_store", None):
                stats = {
                    "used": float(self._store.used()),
                    "capacity": float(self._store.capacity()),
                    "objects": float(self._store.num_objects()),
                    "evictions": float(self._store.evictions()),
                }
            if not stats:
                continue
            tags = {"node": nid.hex()[:12]}
            self._set_gauge(
                "ray_tpu_torch_shm_used_bytes",
                "Bytes allocated in the node's shm object store",
                tags,
                stats.get("used", 0),
            )
            self._set_gauge(
                "ray_tpu_torch_shm_capacity_bytes",
                "Capacity of the node's shm object store",
                tags,
                stats.get("capacity", 0),
            )
            self._set_gauge(
                "ray_tpu_torch_shm_objects",
                "Objects resident in the node's shm store",
                tags,
                stats.get("objects", 0),
            )
            self._set_gauge(
                "ray_tpu_torch_shm_evictions_total",
                "LRU evictions since the node's store was created",
                tags,
                stats.get("evictions", 0),
            )
        by_state = {"SEALED": 0, "PENDING": 0, "ERRORED": 0}
        for entry in self.objects.values():
            by_state[
                {PENDING: "PENDING", SEALED: "SEALED", ERRORED: "ERRORED"}[entry[0]]
            ] += 1
        for state, count in by_state.items():
            self._set_gauge(
                "ray_tpu_torch_object_count",
                "Objects in the head directory by state",
                {"state": state},
                count,
            )
        self._set_gauge(
            "ray_tpu_torch_object_pinned_count",
            "Objects with a positive cluster refcount",
            {},
            sum(1 for c in self.object_refcounts.values() if c > 0),
        )
        self._set_gauge(
            "ray_tpu_torch_objects_spilled",
            "Objects whose only durable copy is a spill file",
            {},
            len(self.object_spilled),
        )

    def _slo_metrics_view(self) -> Dict[str, dict]:
        """read_all()-shaped merged metrics with a "name" key per record
        (what SloEvaluator matches on)."""
        from ray_tpu_torch.util import metrics as metrics_mod

        merged = metrics_mod.merge_series(
            metrics_mod.raw_records_from_kv(self.kv)
        )
        for key, rec in merged.items():
            rec["name"], _, _ = metrics_mod.parse_series_key(key)
        return merged

    def _evaluate_slos(self):
        import json as _json

        from ray_tpu_torch._private import slo as slo_mod

        blob = self.kv.get("slo:specs")
        if blob != self._slo_specs_blob:
            self._slo_specs_blob = blob
            try:
                self._slo_specs = slo_mod.parse_specs(blob or b"[]")
            except (ValueError, TypeError) as e:
                logger.warning("invalid slo:specs ignored: %s", e)
                self._slo_specs = []
            live = {s["name"] for s in self._slo_specs}
            self._slo_evals = {
                name: ev for name, ev in self._slo_evals.items() if name in live
            }
            self._slo_state = {
                name: st for name, st in self._slo_state.items() if name in live
            }
            # a removed policy SLO must not pin the re-admission hold
            self._slo_breach_ticks = {
                n: t for n, t in self._slo_breach_ticks.items() if n in live
            }
            if not self._slo_breach_ticks:
                self._slo_preempt_hold = False
        if not self._slo_specs:
            return
        merged = self._slo_metrics_view()
        now = time.time()
        for spec in self._slo_specs:
            name = spec["name"]
            ev = self._slo_evals.get(name)
            if ev is None or ev.spec != spec:
                # new or changed spec: fresh evaluator (fresh window)
                ev = slo_mod.SloEvaluator(spec)
                self._slo_evals[name] = ev
            verdict = ev.evaluate(merged, now)
            prev_ok = self._slo_state.get(name, {}).get("ok", True)
            self._slo_state[name] = verdict
            self._set_gauge(
                "ray_tpu_torch_slo_ok",
                "1 while the SLO holds over its rolling window",
                {"slo": name},
                1.0 if verdict["ok"] else 0.0,
            )
            self._set_gauge(
                "ray_tpu_torch_slo_burn_rate",
                "Error-budget burn rate (1.0 consumes the budget exactly)",
                {"slo": name},
                float(verdict.get("burn_rate") or 0.0),
            )
            if prev_ok and not verdict["ok"]:
                self._record_event(
                    "WARNING",
                    "slo",
                    f"SLO breach: {name} "
                    f"value={verdict.get('value')} "
                    f"threshold={verdict.get('threshold')} "
                    f"burn_rate={verdict.get('burn_rate'):.2f}",
                    slo=name,
                    value=verdict.get("value"),
                    threshold=verdict.get("threshold"),
                    burn_rate=verdict.get("burn_rate"),
                )
            elif not prev_ok and verdict["ok"]:
                self._record_event(
                    "INFO",
                    "slo",
                    f"SLO recovered: {name}",
                    slo=name,
                    value=verdict.get("value"),
                )
            # policy output: sustained burn → preempt the lowest band;
            # recovery → lift the re-admission hold
            self._apply_slo_policy(spec, verdict, now)

    async def _idle_reaper_loop(self):
        while not self._shutdown:
            await asyncio.sleep(5.0)
            now = time.time()
            for node in self.nodes.values():
                idle = [
                    w
                    for w in node.workers.values()
                    if w.idle and not w.dedicated and now - w.idle_since > RayConfig.idle_worker_kill_s
                ]
                # keep a floor of warm workers
                keep = RayConfig.worker_pool_min_idle
                for w in idle[keep:]:
                    try:
                        os.kill(w.pid, 15)
                    except OSError:
                        pass

    _HANDLERS = {}


HeadServer._HANDLERS = {
    MsgType.REGISTER_NODE: HeadServer.h_register_node,
    MsgType.REGISTER_WORKER: HeadServer.h_register_worker,
    MsgType.REGISTER_JOB: HeadServer.h_register_driver,
    MsgType.HEARTBEAT: HeadServer.h_heartbeat,
    MsgType.DRAIN_NODE: HeadServer.h_drain_node,
    MsgType.SUBMIT_TASK: HeadServer.h_submit_task,
    MsgType.TASK_DONE: HeadServer.h_task_done,
    MsgType.CANCEL_TASK: HeadServer.h_cancel_task,
    MsgType.TASK_BLOCKED: HeadServer.h_task_blocked,
    MsgType.TASK_UNBLOCKED: HeadServer.h_task_unblocked,
    MsgType.CREATE_ACTOR: HeadServer.h_create_actor,
    MsgType.GET_ACTOR: HeadServer.h_get_actor,
    MsgType.KILL_ACTOR: HeadServer.h_kill_actor,
    MsgType.ACTOR_STATE: HeadServer.h_actor_state,
    MsgType.LIST_ACTORS: HeadServer.h_list_actors,
    MsgType.PUT_OBJECT: HeadServer.h_put_object,
    MsgType.WAIT_OBJECT: HeadServer.h_wait_object,
    MsgType.FREE_OBJECT: HeadServer.h_free_object,
    MsgType.ADD_REF: HeadServer.h_add_ref,
    MsgType.REMOVE_REF: HeadServer.h_remove_ref,
    MsgType.SPILL_NOTIFY: HeadServer.h_spill_notify,
    MsgType.LIST_OBJECTS: HeadServer.h_list_objects,
    MsgType.LIST_EVENTS: HeadServer.h_list_events,
    MsgType.RECORD_EVENT: HeadServer.h_record_event,
    MsgType.CHAOS_CTRL: HeadServer.h_chaos_ctrl,
    MsgType.SUBMIT_TASKS: HeadServer.h_submit_tasks,
    MsgType.CLIENT_PUT: HeadServer.h_client_put,
    MsgType.CLIENT_GET: HeadServer.h_client_get,
    MsgType.KV_PUT: HeadServer.h_kv_put,
    MsgType.KV_GET: HeadServer.h_kv_get,
    MsgType.KV_DEL: HeadServer.h_kv_del,
    MsgType.KV_KEYS: HeadServer.h_kv_keys,
    MsgType.KV_EXISTS: HeadServer.h_kv_exists,
    MsgType.SUBSCRIBE: HeadServer.h_subscribe,
    MsgType.PUBLISH: HeadServer.h_publish,
    MsgType.CREATE_PG: HeadServer.h_create_pg,
    MsgType.REMOVE_PG: HeadServer.h_remove_pg,
    MsgType.GET_PG: HeadServer.h_get_pg,
    MsgType.PG_READY: HeadServer.h_pg_ready,
    MsgType.LIST_PGS: HeadServer.h_list_pgs,
    MsgType.CLUSTER_RESOURCES: HeadServer.h_cluster_resources,
    MsgType.AVAILABLE_RESOURCES: HeadServer.h_available_resources,
    MsgType.LIST_NODES: HeadServer.h_list_nodes,
    MsgType.LIST_TASKS: HeadServer.h_list_tasks,
    MsgType.TIMELINE: HeadServer.h_timeline,
    MsgType.TASK_SUMMARY: HeadServer.h_task_summary,
    MsgType.DAG_STEP: HeadServer.h_dag_step,
    MsgType.SERVE_TRACE: HeadServer.h_serve_trace,
    MsgType.TRAIN_STEP: HeadServer.h_train_step,
    MsgType.LEASE_REQUEST: HeadServer.h_lease_request,
    MsgType.LEASE_RETURN: HeadServer.h_lease_return,
    MsgType.LEASE_NOTIFY: HeadServer.h_lease_notify,
    MsgType.TASK_STATS: HeadServer.h_task_stats,
    MsgType.PROFILE_CTRL: HeadServer.h_profile_ctrl,
    MsgType.PROFILE_STATS: HeadServer.h_profile_stats,
    MsgType.REATTACH: HeadServer.h_reattach,
    MsgType.LOG_FETCH: HeadServer.h_log_fetch,
    MsgType.ERROR_REPORT: HeadServer.h_error_report,
}
