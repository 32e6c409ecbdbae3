"""Worker process main: execute tasks pushed by the head.

Analog of the reference's default_worker.py + the C++ task execution loop
(reference: python/ray/_private/workers/default_worker.py,
src/ray/core_worker/core_worker.cc RunTaskExecutionLoop:2176 /
ExecuteTask:2231, and the Cython execute_task upcall _raylet.pyx:596).

A worker is either a pool worker (runs one normal task at a time) or an
actor-dedicated worker (holds the instance; executes its method calls in
submission order, or concurrently up to max_concurrency, or on an asyncio
loop for async actors — the analog of reference concurrency groups /
fiber-based async actors, src/ray/core_worker/transport/
concurrency_group_manager.cc + fiber.h).
"""

from __future__ import annotations

import inspect
import os
import queue
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import log_plane, serialization
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.task_spec import ACTOR_CREATION_TASK, ACTOR_TASK, NORMAL_TASK, TaskSpec
from ray_tpu_torch.exceptions import RayTaskError
from ray_tpu_torch.util.lockwitness import named_condition, named_lock


class _ActorState:
    def __init__(self):
        self.instance: Any = None
        self.cls: Any = None
        self.async_loop: Optional[Any] = None  # asyncio loop for async actors
        self.executor: Optional[ThreadPoolExecutor] = None
        # creation spec wire, kept for the head-FT reattach announce (a
        # restarted head re-learns this worker hosts the actor)
        self.spec_wire: Optional[dict] = None


class WorkerRuntime:
    def __init__(self, core_worker):
        self.cw = core_worker
        self.actor = _ActorState()
        self.task_queue: "queue.Queue[dict]" = queue.Queue()
        self.cancelled: set = set()
        self._concurrency_sem: Optional[threading.Semaphore] = None
        self._direct_server = None
        self._direct_port = 0
        # mutual exclusion between eager actor calls and compiled-DAG
        # executor steps (ray_tpu_torch/dag/): a sequential actor keeps its
        # one-call-at-a-time contract across both modes
        self.actor_lock = named_lock("WorkerRuntime.actor_lock")
        # lease fast path (control plane): batched completion frames per
        # holder conn + batched flight records to the head.  Flushing is
        # an io-loop TIMER (~2ms coalescing window), never the run
        # thread: a completed result must reach the holder even while the
        # NEXT task blocks in user code or arg resolution — holding it
        # until the queue drains deadlocks consumer tasks waiting on the
        # unflushed result.
        self._lease_out_lock = named_lock("WorkerRuntime._lease_out_lock")
        self._lease_outbox: Dict[int, list] = {}  # id(conn) -> results
        self._lease_conns: Dict[int, Any] = {}
        self._stats_buffer: List[dict] = []
        self._lease_flush_armed = False
        # calls between dequeue and their TASK_DONE flush: the actor_lock
        # covers only user code, so the preemption fence must ALSO wait
        # for this to reach zero — a call whose completion report is
        # still in flight when the checkpoint ships would be requeued by
        # the head and double-executed on the restored state
        self._inflight = 0
        self._inflight_cv = named_condition("WorkerRuntime._inflight_cv")
        self._dag_runtime = None  # lazy: ray_tpu_torch.dag.executor.DagWorkerRuntime
        # per-caller sequential ordering across the head→direct transition
        # (reference analog: sequential_actor_submit_queue.cc): seq we expect
        # next per caller_id, plus held-back out-of-order specs
        self._expected_seq: Dict[bytes, int] = {}
        self._held: Dict[bytes, Dict[int, dict]] = {}
        # head-pushed tasks between push and their TASK_DONE flush, spec
        # wire by task id: re-announced on a head-FT reattach so the
        # restarted head re-owns them instead of treating the driver's
        # idempotent resubmit as fresh work (double execution).  Locked:
        # io thread inserts, executor threads retire, the reattach
        # coroutine snapshots — an unlocked snapshot can raise mid-announce
        # and leave the actor un-re-announced (ghost-reaped while alive)
        self._head_inflight: Dict[bytes, dict] = {}
        self._head_inflight_lock = named_lock("WorkerRuntime._head_inflight_lock")

    # ------------------------------------------------------------ main loop

    def run(self):
        """Pull pushed tasks off the queue and execute (the analog of
        RunTaskExecutionLoop)."""
        while True:
            payload = self.task_queue.get()
            if payload is None:
                break
            if "cancel" in payload:
                self.cancelled.add(payload["cancel"])
                continue
            if "flush_held" in payload:
                for s, r in self._flush_expired(payload["flush_held"]):
                    self._execute_guarded(s, r)
                continue
            spec = TaskSpec.from_wire(payload["spec"])
            reply_to = payload.get("direct")
            if payload.get("lease") is not None:
                # lease-pushed normal task: execute serially (one lease =
                # one concurrent task of shape S); completions flush on
                # the io-loop timer armed by _queue_lease_result
                self._execute_guarded(spec, ("lease", payload["lease"]))
                continue
            if spec.task_type == ACTOR_TASK and self._concurrency_sem is None:
                # sequential actor: enforce per-caller seq order so calls
                # that raced the head→direct routing transition still run
                # in submission order
                for s, r in self._sequence(spec, reply_to):
                    self._execute_guarded(s, r)
                continue
            if spec.task_type == ACTOR_TASK and self._concurrency_sem is not None:
                # concurrent actor: run in the pool, keep pulling
                self.actor.executor.submit(self._execute_guarded, spec, reply_to)
            else:
                self._execute_guarded(spec, reply_to)

    def _sequence(self, spec: TaskSpec, reply_to):
        """Yield (spec, reply) pairs now runnable under per-caller seq
        order; hold out-of-order arrivals (bounded wait, then run anyway —
        at-least-once retry semantics make duplicates possible)."""
        import time as _time

        from ray_tpu_torch._private.config import RayConfig

        caller = spec.caller_id or b""
        if caller not in self._expected_seq and spec.seq_no == 0:
            self._expected_seq[caller] = 0  # genuine first call
        if caller not in self._expected_seq or spec.seq_no > self._expected_seq[caller]:
            # Out of order, or first contact at seq>0 — the caller's earlier
            # calls may still be in flight on the head path (a direct frame
            # can win that race), or we're a restarted worker mid-stream.
            # Hold; the flush timer runs it anyway if no predecessor shows
            # (a gap may never fill, e.g. predecessor died with the old
            # worker).
            held = self._held.setdefault(caller, {})
            held[spec.seq_no] = {"reply": reply_to, "spec": spec, "t": _time.time()}
            limit = RayConfig.direct_call_reorder_wait_s
            threading.Timer(
                limit + 0.05, lambda: self.task_queue.put({"flush_held": caller})
            ).start()
            return
        self._expected_seq[caller] = max(self._expected_seq[caller], spec.seq_no + 1)
        yield spec, reply_to
        held = self._held.get(caller, {})
        while self._expected_seq[caller] in held:
            nxt = held.pop(self._expected_seq[caller])
            self._expected_seq[caller] += 1
            yield nxt["spec"], nxt["reply"]

    def _flush_expired(self, caller: bytes):
        """Run held-back out-of-order calls whose wait expired (in seq
        order), advancing expected past them."""
        import time as _time

        from ray_tpu_torch._private.config import RayConfig

        held = self._held.get(caller, {})
        limit = RayConfig.direct_call_reorder_wait_s
        now = _time.time()
        for s in sorted(held):
            if now - held[s]["t"] >= limit or s <= self._expected_seq.get(caller, 0):
                h = held.pop(s)
                self._expected_seq[caller] = max(self._expected_seq.get(caller, 0), s + 1)
                yield h["spec"], h["reply"]

    def on_push(self, payload: dict):
        """Called from the io thread; never block it."""
        if payload.get("directive"):
            return  # spawn directives are raylet business, not ours
        wire = payload.get("spec")
        if (
            wire is not None
            and "direct" not in payload
            and "lease" not in payload
        ):
            # head-path task: tracked from PUSH (a queued-but-unstarted
            # task must also be re-announced after a head restart, or the
            # driver's resubmit would race this copy — double execution)
            tid = bytes(wire.get("task_id") or b"")
            if tid:
                with self._head_inflight_lock:
                    self._head_inflight[tid] = wire
        self.task_queue.put(payload)

    def reattach_state(self) -> dict:
        """Head-FT reattach announce (core_worker calls this on redial):
        the hosted actor (if any) + every head-path task still owed a
        TASK_DONE."""
        out: Dict[str, Any] = {}
        if self.actor.instance is not None and self.actor.spec_wire is not None:
            out["actor"] = self.actor.spec_wire
            if self._direct_port:
                out["actor_direct_addr"] = f"0.0.0.0:{self._direct_port}"
        with self._head_inflight_lock:
            out["running"] = list(self._head_inflight.values())
        return out

    # --------------------------------------- lease fast path (batched IO)

    # coalescing window for completion/stats frames: everything that
    # finishes within it rides one frame, and a result is never held
    # hostage by the NEXT task's execution
    _LEASE_FLUSH_WINDOW_S = 0.002

    def _queue_lease_result(self, conn, spec: TaskSpec, inline, sealed, ph):
        """Accumulate one lease-task completion for the holder + one
        flight record for the head, and arm the io-loop flush timer."""
        import time as _time

        cid = id(conn)
        with self._lease_out_lock:
            self._lease_conns[cid] = conn
            self._lease_outbox.setdefault(cid, []).append(
                {"task_id": spec.task_id, "inline": inline, "stored": sealed}
            )
            if ph is not None:
                ph.setdefault("done", _time.time())
                self._stats_buffer.append(
                    {
                        "task_id": spec.task_id,
                        "name": spec.function_name or spec.method_name or "task",
                        "granted_by": getattr(spec, "granted_by", "cached_lease"),
                        "phases": ph,
                        "pid": os.getpid(),
                    }
                )
            if self._lease_flush_armed:
                return
            self._lease_flush_armed = True

        async def _later():
            import asyncio

            await asyncio.sleep(self._LEASE_FLUSH_WINDOW_S)
            with self._lease_out_lock:
                self._lease_flush_armed = False
            self._flush_lease_batches()

        try:
            self.cw.io.spawn(_later())
        except Exception:  # graftlint: disable=silent-except -- io loop gone (shutdown); the inline flush below is the recovery
            with self._lease_out_lock:
                self._lease_flush_armed = False
            self._flush_lease_batches()

    def _flush_lease_batches(self):
        from ray_tpu_torch._private.protocol import MsgType

        with self._lease_out_lock:
            batches = {
                cid: results
                for cid, results in self._lease_outbox.items()
                if results
            }
            for cid in batches:
                self._lease_outbox[cid] = []
            stats, self._stats_buffer = self._stats_buffer, []
        for cid, results in batches.items():
            conn = self._lease_conns.get(cid)
            if conn is None or conn.closed:
                continue  # holder gone: its conn-loss path owns recovery
            self.cw.io.spawn(conn.send(MsgType.LEASE_DONE, {"results": results}))
        if stats:
            try:
                self.cw.io.spawn(
                    self.cw.conn.send(
                        MsgType.TASK_STATS,
                        {"node_id": self.cw.node_id, "records": stats},
                    )
                )
            except Exception:  # graftlint: disable=silent-except -- stats are best-effort observability; the completions above are what correctness needs
                pass

    def on_preempt(self, payload: dict) -> dict:
        """Checkpoint request from the head's preemptive scheduler
        (PREEMPT_ACTOR), run on a dedicated thread (core_worker spawns
        it).  Contract: the actor's optional ``__ray_save__`` runs under
        the actor lock (a sequential actor is never checkpointed
        mid-call) within the head's deadline; the returned state is
        serialized into head KV ``actor_ckpt:<actor_id>`` BEFORE we
        reply ok, so the head can SIGKILL this process immediately after
        — ``__ray_restore__`` receives it verbatim on respawn.  Any
        failure (busy past the deadline, save raised, no instance)
        replies not-ok and the head escalates to a budget-charged kill."""
        import time as _time

        inst = self.actor.instance
        if inst is None:
            return {"ok": False, "error": "no actor instance"}
        actor_id = bytes(payload.get("actor_id") or b"")
        deadline = float(payload.get("save_deadline_s") or 5.0)
        save = getattr(inst, "__ray_save__", None)
        start = _time.time()
        if not self.actor_lock.acquire(timeout=deadline):
            return {"ok": False, "error": "actor busy past the save deadline"}
        fenced = False
        try:
            # the lock only fences NEW user code; a call whose method
            # already returned may still be storing results / flushing
            # TASK_DONE — wait it out, or the head would see the task in
            # running_tasks at kill time, requeue it, and double-execute
            # it against checkpointed state that already includes it
            if not self._drain_inflight(start + deadline):
                return {
                    "ok": False,
                    "error": "in-flight call still reporting past the "
                    "save deadline",
                }
            if save is None:
                # nothing to checkpoint: release is still graceful
                # (respawn re-runs __init__ from the original creation
                # args) — hold the fence so no call ACKs a mutation the
                # fresh __init__ then silently discards
                fenced = True
                return {"ok": True, "saved": False}
            state = save()
            if _time.time() - start > deadline:
                # the head's rpc timeout has already escalated (or is
                # about to); don't ship a checkpoint the protocol
                # considers dead
                return {
                    "ok": False,
                    "error": "__ray_save__ exceeded its deadline",
                }
            blob = serialization.dumps(state)
            self.cw.kv_put(f"actor_ckpt:{actor_id.hex()}", blob)
            # fence: the lock stays HELD from here until the head's
            # SIGKILL lands — a queued call running (and ACKing a result
            # to its caller) after the snapshot would be silently rolled
            # back by the restore.  Deliberately never released on the
            # success path; this process is about to die.
            fenced = True
            return {"ok": True, "saved": True}
        finally:
            if not fenced:
                self.actor_lock.release()

    def _drain_inflight(self, deadline_ts: float) -> bool:
        """Wait (bounded) until no call sits between dequeue and its
        TASK_DONE flush.  Caller holds actor_lock, so no NEW call can
        enter user code while we wait; only completion tails drain."""
        import time as _time

        with self._inflight_cv:
            while self._inflight:
                rem = deadline_ts - _time.time()
                if rem <= 0:
                    return False
                self._inflight_cv.wait(rem)
            return True

    def register_with_lease_agent(self, agent_addr: str, direct_port: int):
        """Announce this worker to its node's raylet lease agent
        (raylet/lease_agent.py) so node-affine leases grant locally.  The
        connection doubles as the liveness signal: the agent forgets the
        worker when it drops."""
        from ray_tpu_torch._private.config import RayConfig
        from ray_tpu_torch._private.protocol import Connection, MsgType

        host, port_s = agent_addr.rsplit(":", 1)

        async def _register():
            conn = await Connection.connect(
                host, int(port_s), RayConfig.connect_timeout_s, retry=False
            )
            await conn.send(
                MsgType.REGISTER_WORKER,
                {
                    "worker_id": self.cw.worker_id.binary(),
                    "pid": os.getpid(),
                    "direct_addr": f"0.0.0.0:{direct_port}",
                    "has_gpu": bool(os.environ.get("RAY_TPU_WORKER_GPU")),
                },
            )
            return conn

        try:
            self._agent_conn = self.cw.io.call(_register(), timeout=10)
        except Exception:  # noqa: BLE001 -- local dispatch is an optimization; head grants still work
            traceback.print_exc(file=sys.stderr)
            self._agent_conn = None

    def _notify_agent_dedicated(self):
        """Tell the lease agent this worker now belongs to an actor and
        must never be leased."""
        conn = getattr(self, "_agent_conn", None)
        if conn is None or conn.closed:
            return
        from ray_tpu_torch._private.protocol import MsgType

        try:
            self.cw.io.spawn(
                conn.send(
                    MsgType.REGISTER_WORKER,
                    {"worker_id": self.cw.worker_id.binary(), "dedicated": True},
                )
            )
        except Exception:  # graftlint: disable=silent-except -- best-effort; the agent also learns via lease-push failures
            pass

    def dag_runtime(self):
        """Lazy compiled-DAG runtime (ray_tpu_torch/dag/executor.py) —
        created on the first DAG_SETUP so workers that never join a compiled
        graph never import the dag subsystem.  Only called from the io loop
        (direct-server frame handlers), so no lock is needed."""
        if self._dag_runtime is None:
            from ray_tpu_torch.dag.executor import DagWorkerRuntime

            self._dag_runtime = DagWorkerRuntime(self)
        return self._dag_runtime

    # ------------------------------------------------------------ execution

    def _execute_guarded(self, spec: TaskSpec, reply_to=None):
        with self._inflight_cv:
            self._inflight += 1
        try:
            self._execute_guarded_inner(spec, reply_to)
        finally:
            # retire AFTER the TASK_DONE flush inside the inner call: the
            # reattach announce must cover a completion still in flight
            with self._head_inflight_lock:
                self._head_inflight.pop(bytes(spec.task_id), None)
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _execute_guarded_inner(self, spec: TaskSpec, reply_to=None):
        import time as _time

        from ray_tpu_torch._private.config import RayConfig

        sealed: List[bytes] = []
        contained: Dict[bytes, List[bytes]] = {}
        inline: Dict[bytes, list] = {}  # oid -> SerializedObject wire (direct replies)
        error: Optional[str] = None
        stored_error = False
        exec_start = _time.time()
        direct = reply_to is not None
        # flight-recorder stamps ride the spec (task_events.py); None when
        # recording is off — each stamp site below is one None check
        ph = spec.phases
        if ph is not None:
            ph["worker_dequeue"] = exec_start
        # nested submissions made by this task inherit its band: without
        # this, a best-effort job's fan-out would silently escalate to the
        # pool worker's default (band 1) and could preempt other tenants
        self.cw.default_priority = spec.priority
        try:
            if spec.task_id in self.cancelled:
                raise RayTaskError(
                    spec.function_name or spec.method_name,
                    "TaskCancelledError: cancelled",
                )
            results = self._execute(spec)
            if ph is not None:
                ph["exec_end"] = ph["put_start"] = _time.time()
            outs = self._normalize_returns(spec, results)
            limit = RayConfig.max_direct_call_object_size
            for oid, value in outs:
                sobj = serialization.serialize(value)
                # direct small refless results reply inline and never touch
                # the store or the head (the reference's in-process memory
                # store for direct-call returns, core_worker.cc:1146);
                # results CONTAINING refs go through the store so the
                # head's containment pinning covers them
                if direct and sobj.total_bytes() <= limit and not sobj.contained:
                    inline[oid] = sobj.to_wire()
                    continue
                # refs to OUR memory-store-only values (results of direct
                # calls we made) must be globally resolvable before they
                # ship inside this return
                self.cw._promote_memory_objects(sobj.contained)
                self.cw.store.put_serialized(oid, sobj)
                sealed.append(oid)
                if sobj.contained:
                    contained[oid] = sobj.contained
            if ph is not None:
                ph["put_end"] = _time.time()
        except BaseException as e:  # noqa: BLE001
            name = spec.function_name or spec.method_name
            # crash forensics: the last-K lines THIS process captured ride
            # inside the error object to the driver and inside the
            # ERROR_REPORT record to the head's dedup ring
            tail = log_plane.recent_tail(RayConfig.error_log_tail_lines)
            if isinstance(e, RayTaskError):
                err = e
                if tail and not err.log_tail:
                    err.log_tail = tail
            else:
                err = RayTaskError.from_exception(name, e, log_tail=tail)
            error = f"{type(e).__name__}: {e}"
            self._report_error(spec, e, err, tail)
            # store the error as the value of every return object
            try:
                for oid in spec.return_object_ids():
                    sobj = serialization.serialize(err)
                    if direct and not sobj.contained:
                        inline[oid] = sobj.to_wire()
                        continue
                    self.cw.store.put_serialized(oid, sobj)
                    sealed.append(oid)
                    if sobj.contained:
                        # refs pickled inside the exception value need the
                        # same containment pin as normal returns
                        contained[oid] = sobj.contained
                stored_error = True
            except BaseException:  # graftlint: disable=silent-except -- reflected in stored_error; the print_exc below logs the original failure
                stored_error = False
            traceback.print_exc(file=sys.stderr)
        finally:
            self.cw.current_task_id = None
            log_plane.clear_task_context()
        if direct:
            lease_mode = reply_to[0] == "lease"
            # over-limit / ref-containing results were stored: seal them at
            # the head first, then answer the caller (inline errors raise
            # client-side on deserialize, like stored ones)
            try:
                if sealed:
                    self.cw.task_done(
                        spec.task_id,
                        sealed,
                        None,
                        True,
                        exec_start=exec_start,
                        exec_end=_time.time(),
                        contained=contained,
                        # lease records ship on the batched TASK_STATS
                        # plane instead (tagged granted_by) — stamping
                        # both would double-count the flight recorder
                        phases=None if lease_mode else ph,
                    )
            except Exception:
                traceback.print_exc(file=sys.stderr)
            # inline-only direct replies skip task_done, but refs this call
            # deserialized into actor state still sit in the batched ADD_REF
            # buffer — declare them before the caller (who holds the only
            # head-visible pin via its arg keepalives) sees the reply and
            # releases, or the late add resurrects a freed count
            self.cw.flush_ref_adds()
            if lease_mode:
                self._queue_lease_result(reply_to[1], spec, inline, sealed, ph)
                return
            conn, rid = reply_to
            self.cw.io.spawn(
                conn.reply(rid, {"inline": inline, "stored": sealed})
            )
            return
        try:
            self.cw.task_done(
                spec.task_id,
                sealed,
                error,
                stored_error,
                exec_start=exec_start,
                exec_end=_time.time(),
                contained=contained,
                phases=ph,
            )
        except Exception:
            traceback.print_exc(file=sys.stderr)
            os._exit(1)  # lost the head: die, the head treats it as worker death

    def _report_error(self, spec: TaskSpec, exc: BaseException, err, tail):
        """Fire-and-forget structured error record to the head's dedup
        ring (ERROR_REPORT — the resurrected ERROR_PUSH role).  Never
        raises: error reporting must not mask the task error itself."""
        try:
            tb = getattr(err, "traceback_str", "") or ""
            name = spec.function_name or spec.method_name
            self.cw.report_error(
                {
                    "signature": _error_signature(exc, name),
                    "kind": "actor_task" if spec.actor_id else "task",
                    "exc_type": type(exc).__name__,
                    "message": str(exc)[:512],
                    "name": name,
                    "traceback": tb[-8192:],
                    "log_tail": tail,
                    "job_id": bytes(spec.job_id).hex() if spec.job_id else "",
                    "task_id": bytes(spec.task_id).hex(),
                    "actor_id": bytes(spec.actor_id).hex() if spec.actor_id else "",
                    "pid": os.getpid(),
                }
            )
        except Exception:  # graftlint: disable=silent-except -- forensics plane is best-effort; the task error itself is already stored
            pass

    def _apply_runtime_env(self, spec: TaskSpec):
        """env_vars / working_dir / py_modules / offline-pip-venv
        materialized in-process before execution (reference:
        _private/runtime_env/ — theirs sets up dedicated workers via the
        agent; see _private/runtime_env.py).  Returns the undo so a
        reused pool worker doesn't leak shipped modules or an activated
        venv into later tasks."""
        from ray_tpu_torch._private.runtime_env import apply_runtime_env

        return apply_runtime_env(
            self.cw,
            spec.runtime_env or {},
            session_dir=os.path.dirname(os.environ.get("RAY_TPU_STORE_PATH", "")),
        )

    def _execute(self, spec: TaskSpec):
        from ray_tpu_torch.util.tracing import span_scope

        self.cw.current_task_id = spec.task_id
        if log_plane.enabled:
            # running-task identity for the structured log plane: every
            # line this task prints is stamped with it (O(1) per line —
            # one dict swap here, one dict merge per line)
            cls = self.actor.cls
            log_plane.task_context(
                task=bytes(spec.task_id).hex(),
                trace=(spec.trace_ctx or {}).get("trace_id") or None,
                job=bytes(spec.job_id).hex() if spec.job_id else None,
                actor=bytes(spec.actor_id).hex() if spec.actor_id else None,
                cls=getattr(cls, "__name__", None) if spec.actor_id else None,
            )
        with span_scope(spec.trace_ctx):
            return self._execute_inner(spec)

    def _execute_inner(self, spec: TaskSpec):
        import time as _time

        # arg-fetch phase covers runtime-env materialization, argument
        # resolution (ref pulls), and the function-table fetch — everything
        # between dequeue and the first line of user code
        ph = spec.phases
        if ph is not None:
            ph["arg_fetch_start"] = _time.time()
        undo_env = self._apply_runtime_env(spec)
        if spec.task_type == NORMAL_TASK:
            # pool workers are reused: the env (sys.path entries, env vars,
            # cwd) must not leak into the next (unrelated) task — even when
            # arg decode or the function fetch fails.  Actors keep theirs:
            # the env belongs to the actor.
            try:
                args, kwargs = self.cw.decode_args(spec.args)
                fn = self.cw.fetch_function(spec.function_id)
                if ph is not None:
                    ph["arg_fetch_end"] = ph["exec_start"] = _time.time()
                return fn(*args, **kwargs)
            finally:
                undo_env()
        args, kwargs = self.cw.decode_args(spec.args)
        if spec.task_type == ACTOR_CREATION_TASK:
            cls = self.cw.fetch_function(spec.function_id)
            self.actor.cls = cls
            self.actor.spec_wire = spec.to_wire()
            if _is_async_actor(cls):
                # async actors process calls concurrently on one event loop
                # (reference: fiber-based async actors, core_worker fiber.h;
                # default max concurrency 1000 for asyncio actors)
                self._start_async_loop()
                concurrency = max(spec.max_concurrency, 100)
            else:
                concurrency = spec.max_concurrency
            if concurrency > 1:
                self.actor.executor = ThreadPoolExecutor(max_workers=concurrency)
                self._concurrency_sem = threading.Semaphore(concurrency)
            if ph is not None:
                ph["arg_fetch_end"] = ph["exec_start"] = _time.time()
            self._notify_agent_dedicated()  # actor workers are never leased
            self.actor.instance = cls(*args, **kwargs)
            if spec.preemptible:
                # respawn-with-restore: a checkpoint saved by a prior
                # incarnation's __ray_save__ hands the state back before
                # any queued call runs (one KV get, preemptible-only cost)
                self._maybe_restore(spec)
            self._start_direct_server(spec.actor_id)
            return None
        if spec.task_type == ACTOR_TASK:
            if ph is not None:
                ph["arg_fetch_end"] = ph["exec_start"] = _time.time()
            inst = self.actor.instance
            if inst is None:
                raise RuntimeError("actor instance not initialized")
            if spec.method_name == "_ray_tpu_torch_init_collective":
                # driver-side create_collective_group() trampoline: join the
                # group in this actor's process (reference analog: declared
                # groups lazily initialized inside each actor,
                # collective.py:151)
                from ray_tpu_torch.util.collective import init_collective_group

                world_size, rank, backend, group_name, *rest = args
                init_collective_group(
                    world_size, rank, backend, group_name,
                    rendezvous_nonce=rest[0] if rest else "",
                )
                return None
            method = getattr(inst, spec.method_name)
            if inspect.iscoroutinefunction(getattr(method, "__func__", method)):
                import asyncio

                fut = asyncio.run_coroutine_threadsafe(method(*args, **kwargs), self.actor.async_loop)
                return fut.result()
            if self._concurrency_sem is None:
                # sequential actor: eager calls and resident compiled-DAG
                # steps (dag/executor.py takes the same lock) stay mutually
                # excluded, preserving the one-call-at-a-time contract.
                # Step OUT of the in-flight count while waiting for the
                # lock: a preemption fence holding it needs to see
                # quiescence, and a call that never entered user code is
                # exactly what the head safely requeues after the kill —
                # counting it would turn every racing benign call into a
                # forced (budget-charged) preemption.
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()
                self.actor_lock.acquire()
                try:
                    with self._inflight_cv:
                        self._inflight += 1
                    return method(*args, **kwargs)
                finally:
                    self.actor_lock.release()
            return method(*args, **kwargs)
        raise ValueError(f"unknown task type {spec.task_type}")

    def _maybe_restore(self, spec: TaskSpec):
        key = f"actor_ckpt:{bytes(spec.actor_id).hex()}"
        blob = self.cw.kv_get(key)
        if not blob:
            return
        restore = getattr(self.actor.instance, "__ray_restore__", None)
        if restore is None:
            return
        # a raising restore fails the creation task, which destroys the
        # actor with "creation failed: ..." — a corrupt checkpoint must be
        # loud, not silently discarded
        restore(serialization.loads(bytes(blob)))
        # one-shot: a consumed checkpoint must not survive into a LATER
        # genuine-fault restart, which promises a fresh __init__ — without
        # this, a crash long after re-admission would silently roll the
        # actor back to the stale preemption snapshot
        self.cw.kv_del(key)

    def _normalize_returns(self, spec: TaskSpec, results: Any):
        oids = spec.return_object_ids()
        if spec.num_returns == 1:
            return [(oids[0], results)]
        if results is None:
            results = [None] * spec.num_returns
        results = list(results)
        if len(results) != spec.num_returns:
            raise ValueError(
                f"task declared num_returns={spec.num_returns} but returned {len(results)} values"
            )
        return list(zip(oids, results))

    def _start_async_loop(self):
        import asyncio

        loop = asyncio.new_event_loop()
        self.actor.async_loop = loop
        t = threading.Thread(target=loop.run_forever, name="actor-async", daemon=True)
        t.start()

    def ensure_direct_server(self) -> int:
        """Start (once) this worker's direct-call server and return its
        port — the worker→worker/driver data path that keeps the head out
        of the per-call loop (reference analog: CoreWorker's PushTask gRPC
        service, direct_actor_task_submitter.cc).  Every worker runs one
        now, not just actors: the lease fast path pushes whole task queues
        here (LEASE_PUSH), so the address rides worker registration."""
        import asyncio

        from ray_tpu_torch._private.protocol import Connection, MsgType

        if self._direct_server is not None:
            return self._direct_port

        async def _serve(reader, writer):
            conn = Connection(reader, writer)
            try:
                while True:
                    msg_type, rid, payload = await conn.read_frame()
                    if msg_type == MsgType.ACTOR_CALL:
                        self.task_queue.put(
                            {"spec": payload["spec"], "direct": (conn, rid)}
                        )
                    elif msg_type == MsgType.LEASE_PUSH:
                        # a lease holder's batched task queue: O(1) enqueue
                        # per spec, completions batch back on LEASE_DONE
                        for wire in payload.get("specs", []):
                            self.task_queue.put({"spec": wire, "lease": conn})
                    elif msg_type == MsgType.DAG_PUSH:
                        # compiled-step doorbell: O(1) enqueue to the node's
                        # channel, the resident executor thread does the rest
                        if self._dag_runtime is not None:
                            self._dag_runtime.handle_push(payload)
                    elif msg_type == MsgType.DAG_SETUP:
                        try:
                            reply = await self.dag_runtime().handle_setup(payload, conn)
                        except Exception as e:  # noqa: BLE001 -- reported to the compiling driver
                            await conn.reply(rid, {}, error=f"{type(e).__name__}: {e}")
                        else:
                            await conn.reply(rid, reply)
                    elif msg_type == MsgType.DAG_ARM:
                        # gang-setup phase 2: start resident loops installed
                        # by an unarmed DAG_SETUP (atomic multi-host arming)
                        if self._dag_runtime is None:
                            await conn.reply(
                                rid, {}, error="no dag runtime (setup never ran)"
                            )
                        else:
                            try:
                                reply = await self._dag_runtime.handle_arm(payload)
                            except Exception as e:  # noqa: BLE001 -- reported to the compiling driver
                                await conn.reply(
                                    rid, {}, error=f"{type(e).__name__}: {e}"
                                )
                            else:
                                await conn.reply(rid, reply)
                    elif msg_type == MsgType.DAG_TEARDOWN:
                        if self._dag_runtime is None:
                            await conn.reply(rid, {"ok": True, "absent": True})
                        else:
                            await conn.reply(
                                rid, await self._dag_runtime.handle_teardown(payload)
                            )
                    elif msg_type == MsgType.ENGINE_STREAM:
                        # serve-engine token-stream negotiation: attach a
                        # dag channel to a live stream / cancel one.  The
                        # frames themselves then ride DAG_PUSH above.
                        try:
                            from ray_tpu_torch.serve.engine import (
                                transport as engine_transport,
                            )

                            reply = await engine_transport.handle_frame(payload, conn)
                        except Exception as e:  # noqa: BLE001 -- reported to the attaching consumer
                            await conn.reply(
                                rid, {}, error=f"{type(e).__name__}: {e}"
                            )
                        else:
                            await conn.reply(rid, reply)
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                pass
            finally:
                # a dag dies with its driver conn: stop executors, release
                # channels, return to eager-only service
                if self._dag_runtime is not None:
                    self._dag_runtime.on_conn_lost(conn)
                # engine token streams die with their consumer conn too
                # (writer + shm ring reclaimed there); sys.modules guard so
                # workers that never streamed don't import the serve engine
                eng_transport = sys.modules.get("ray_tpu_torch.serve.engine.transport")
                if eng_transport is not None:
                    eng_transport.conn_lost(conn)

        async def _start():
            server = await asyncio.start_server(_serve, "0.0.0.0", 0)
            port = server.sockets[0].getsockname()[1]
            self._direct_server = server
            return port

        try:
            self._direct_port = self.cw.io.call(_start(), timeout=10)
        except Exception:
            traceback.print_exc(file=sys.stderr)  # head path keeps working
            self._direct_port = 0
        return self._direct_port

    def _start_direct_server(self, actor_id: bytes):
        """Announce this actor's direct-call endpoint to the head (the
        server itself is the shared per-worker one)."""
        from ray_tpu_torch._private.config import RayConfig
        from ray_tpu_torch._private.protocol import MsgType

        if not RayConfig.enable_direct_actor_calls:
            return
        port = self.ensure_direct_server()
        if not port:
            return
        try:
            self.cw.request(
                MsgType.ACTOR_STATE,
                {"actor_id": actor_id, "direct_addr": f"0.0.0.0:{port}"},
            )
        except Exception:
            traceback.print_exc(file=sys.stderr)  # head path keeps working


def _is_async_actor(cls) -> bool:
    return any(
        inspect.iscoroutinefunction(m)
        for _, m in inspect.getmembers(cls, predicate=inspect.isfunction)
    )


def _error_signature(exc: BaseException, name: str) -> str:
    """Dedup key for the head's error ring: exception type + function +
    deepest in-user-code frame.  Two crashes from the same broken line
    collapse into one signature however many workers hit it."""
    file, line = "", 0
    tb = exc.__traceback__
    while tb is not None:
        file = os.path.basename(tb.tb_frame.f_code.co_filename)
        line = tb.tb_lineno
        tb = tb.tb_next
    return f"{type(exc).__name__}:{name}:{file}:{line}"


def _own_log_file() -> str:
    """Where this process's stdout actually lands (the worker log the
    raylet/zygote/head wired us to) — registered with the head so
    LOG_FETCH can address this worker's output by entity."""
    try:
        path = os.readlink("/proc/self/fd/1")
        return path if path.startswith("/") else ""
    except OSError:
        return ""


def main():
    # stack dumps on demand: `kill -USR1 <worker pid>` writes every
    # thread's traceback to the worker log — the first tool for "which
    # worker is wedged, and where" at fleet scale.  Shared helper: head,
    # raylet, and dashboard mains register the same dump.
    from ray_tpu_torch._private.profiler import install_sigusr1

    install_sigusr1()

    host, port = os.environ["RAY_TPU_HEAD"].split(":")
    node_id = bytes.fromhex(os.environ["RAY_TPU_NODE_ID"])
    from ray_tpu_torch._private.config import RayConfig

    if os.environ.get("RAY_TPU_SYSTEM_CONFIG"):
        RayConfig.initialize_from_json(os.environ["RAY_TPU_SYSTEM_CONFIG"])

    # structured log capture FIRST, so even registration-path output is
    # stamped.  Covers exec-spawned workers and zygote-forked children
    # alike — both re-enter main() with fd 1/2 already dup2'd onto the
    # worker log (RAY_TPU_LOG_STRUCTURED=0 keeps raw lines; install is a
    # no-op then).
    log_plane.install(node=node_id.hex()[:8])

    from ray_tpu_torch.core.core_worker import CoreWorker

    cw = CoreWorker(host, int(port), mode="worker")
    log_plane.set_static(wid=cw.worker_id.hex()[:8])
    runtime = WorkerRuntime(cw)
    # handler must be live BEFORE registering: the head pushes the first task
    # the moment registration lands
    cw.set_push_task_handler(runtime.on_push)
    cw.set_preempt_handler(runtime.on_preempt)
    cw.set_reattach_state_provider(runtime.reattach_state)
    # every worker serves direct calls now (lease pushes + actor calls);
    # the address rides registration so the head can grant leases on it
    direct_port = 0
    if RayConfig.enable_direct_actor_calls or RayConfig.lease_cache_enabled:
        direct_port = runtime.ensure_direct_server()
    cw.register_as_worker(
        node_id,
        os.getpid(),
        has_gpu=bool(os.environ.get("RAY_TPU_WORKER_GPU")),
        direct_addr=f"0.0.0.0:{direct_port}" if direct_port else "",
        log_file=_own_log_file(),
    )
    # node-local dispatch: announce to this node's raylet lease agent (if
    # any) so node-affine leases grant without a head round-trip
    agent_addr = os.environ.get("RAY_TPU_RAYLET_DISPATCH", "")
    if agent_addr and direct_port:
        runtime.register_with_lease_agent(agent_addr, direct_port)

    # mark this process as a connected worker for nested API calls
    from ray_tpu_torch._private import worker as worker_mod

    worker_mod.global_worker.core_worker = cw
    worker_mod.global_worker.mode = "worker"

    # a worker whose head died must exit, not linger as an orphan blocked
    # on its task queue (reference: workers die with their raylet); the
    # sentinel unblocks run(), and hard-exit below skips joining actor
    # executor threads that may be wedged in user code
    cw.on_disconnect(lambda: runtime.task_queue.put(None))
    runtime.run()
    os._exit(0)


if __name__ == "__main__":
    main()
