"""Wire protocol for the control plane.

The reference uses gRPC + protobuf for every control RPC
(reference: src/ray/rpc/grpc_server.h, src/ray/protobuf/*.proto).  We keep
the same *message taxonomy* (register node/worker, lease, push task, task
done, object location, KV, pubsub, heartbeat) but carry it as
length-prefixed msgpack frames over asyncio TCP sockets — simpler, no IDL
step, and fast enough for a control plane whose hot data path lives in
shared memory anyway.

Frame layout: 4-byte little-endian length, then a msgpack array
``[msg_type:int, request_id:int, payload:map]``.  request_id pairs requests
with replies on a single multiplexed connection (the analog of gRPC call
tags in the reference's ClientCallManager, src/ray/rpc/client_call.h).
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import struct
import time
from typing import Any, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 31


class MsgType(enum.IntEnum):
    # Retired slots — values burned, never reuse (IntEnum silently aliases
    # reused values; see the TASK_UNBLOCKED=26 incident below):
    #   NODE_TABLE=13   (clients read node tables via LIST_NODES)
    #   PIN_OBJECT=47   (pinning rides ADD_REF / task-spec containment)
    #   PUBSUB_POLL=57  (subscribers get pushed PUBLISH frames)
    #   ERROR_PUSH=80   (task errors reach drivers as stored RayTaskError values)
    #   DEVICE_FREE=115 (the device object tier, not ported yet)

    # replies
    REPLY = 0
    ERROR_REPLY = 1

    # node / worker lifecycle (analog: node_manager.proto, gcs_service.proto)
    REGISTER_NODE = 10
    REGISTER_WORKER = 11
    HEARTBEAT = 12
    DRAIN_NODE = 14  # graftsan: disable=GS004 -- operator-initiated drain: the head-side handler is the product surface; senders are external admin tooling (ROADMAP autoscaling), not this tree

    # tasks (analog: core_worker.proto PushTask, node_manager RequestWorkerLease)
    SUBMIT_TASK = 20
    SUBMIT_TASKS = 26  # batched submit: a burst of .remote() in one frame
    PUSH_TASK = 21
    TASK_DONE = 22
    CANCEL_TASK = 23
    STEAL_OK = 24  # graftlint: disable=protocol-exhaustive -- reserved for work stealing (reference task stealing protocol); scheduler does not steal yet  # graftsan: disable=GS004 -- reserved: ROADMAP work-stealing lands both sides at once; the slot stays so wire captures stay decodable
    TASK_BLOCKED = 25  # worker blocked in get(): release its cpu (analog:
    TASK_UNBLOCKED = 27  # reference NotifyDirectCallTaskBlocked, raylet_client.cc)
    # NOTE: 26 is taken by SUBMIT_TASKS above.  TASK_UNBLOCKED was
    # historically also 26, which made IntEnum alias the two members and the
    # head's handler dict silently dispatched unblock notifications to the
    # batched-submit handler — the released CPU was never reacquired.
    # graftlint GL004 (protocol-exhaustive) now rejects duplicate values.

    # actors (analog: gcs_service.proto ActorInfoGcsService)
    CREATE_ACTOR = 30
    ACTOR_CALL = 31
    GET_ACTOR = 32
    KILL_ACTOR = 33
    ACTOR_STATE = 34
    LIST_ACTORS = 35

    # objects (analog: object_manager.proto, core_worker GetObjectStatus)
    PUT_OBJECT = 40
    GET_OBJECT = 41  # graftlint: disable=protocol-exhaustive -- reserved; gets resolve via WAIT_OBJECT + shared-memory mmap, never a payload RPC  # graftsan: disable=GS004 -- reserved: ROADMAP device-tier object plane needs a payload-get frame; keep the slot
    FREE_OBJECT = 42
    OBJECT_LOCATION = 43  # graftlint: disable=protocol-exhaustive -- reserved; the head's object directory answers location queries inside WAIT_OBJECT  # graftsan: disable=GS004 -- reserved: ROADMAP device-tier object plane will query locations out-of-band; keep the slot
    WAIT_OBJECT = 44
    ADD_REF = 45
    REMOVE_REF = 46
    OBJECT_PULL = 48  # head → raylet: pull oid from a peer's transfer agent
    OBJECT_DELETE = 49  # head → raylet: drop local copy (+ spill files)
    SPILL_NOTIFY = 90  # any store claimant → head: these oids now live on disk
    OBJECT_RESTORE = 92  # head → raylet: load a spilled file back into shm
    # Ray-Client-style remote drivers (no mmap of any node's store): object
    # payloads ride the control connection (analog: reference
    # util/client/ dataclient streaming, ray_client.proto)
    CLIENT_PUT = 93
    CLIENT_GET = 94

    # KV + pubsub (analog: gcs_kv_manager.h, pubsub.proto)
    KV_PUT = 50
    KV_GET = 51
    KV_DEL = 52
    KV_KEYS = 53
    KV_EXISTS = 54
    SUBSCRIBE = 55
    PUBLISH = 56

    # placement groups (analog: gcs_service.proto PlacementGroupInfoGcsService)
    CREATE_PG = 60
    REMOVE_PG = 61
    GET_PG = 62
    PG_READY = 63
    LIST_PGS = 64

    # jobs / cluster state (analog: gcs_service.proto JobInfoGcsService)
    REGISTER_JOB = 70
    CLUSTER_RESOURCES = 71
    AVAILABLE_RESOURCES = 72
    LIST_NODES = 73
    LIST_TASKS = 74
    TIMELINE = 75
    LIST_OBJECTS = 76
    LIST_EVENTS = 77
    RECORD_EVENT = 78  # any process → head: append to the cluster-event ring
    TASK_SUMMARY = 79  # per-phase latency summary over the flight records

    # fault injection (chaos.py): driver → head arm/disarm, fanned out to
    # chaos-aware processes over the "chaos" pubsub channel
    CHAOS_CTRL = 95

    # compiled actor DAGs (ray_tpu_torch/dag/): channel setup/teardown
    # rides the direct-call conns; DAG_PUSH is the per-step doorbell+data
    # frame on the pre-wired channels; DAG_STEP carries a node's
    # flight-recorder stamps to the head (fire-and-forget, only when task
    # events are on)
    DAG_SETUP = 96
    DAG_TEARDOWN = 97
    DAG_PUSH = 98
    DAG_STEP = 99
    # the serve engine's token-stream negotiation (attach / cancel) on a
    # consumer-dialed direct conn (serve/engine/transport.py)
    ENGINE_STREAM = 102

    # workload-plane flight records (fire-and-forget, batched, sent only
    # while task events are on): serve request traces from replicas
    # (serve/tracing.py) and train-step records from StepProbe
    # (train/torch/step_probe.py) — the head joins both next to the task
    # flight records
    SERVE_TRACE = 100
    TRAIN_STEP = 101

    # multi-tenant preemption (gcs/server.py victim selection): head →
    # actor worker request to checkpoint (`__ray_save__` under a deadline,
    # checkpoint lands in head KV `actor_ckpt:<id>`) and release; a
    # missing/late/failed reply escalates to SIGKILL with the restart
    # budget charged.  Respawn-with-restore rides the normal actor-restart
    # FSM once capacity returns.
    PREEMPT_ACTOR = 103

    # control-plane fast path (worker-lease caching + raylet-local
    # dispatch; gcs/server.py lease service, raylet/lease_agent.py,
    # core_worker.py _LeaseCache).  A driver holding a lease for resource
    # shape S pushes its whole queue of S-shaped tasks straight to the
    # leased worker, amortizing the head round-trip to ~0 per task
    # (reference analog: worker lease reuse in the raylet,
    # node_manager.cc RequestWorkerLease + direct task submission).
    LEASE_REQUEST = 104  # client → head/raylet-agent: grant a worker lease
    LEASE_RETURN = 105  # client → grantor: release the lease (idle/revoked)
    LEASE_REVOKE = 106  # grantor → client push: give it back (preemption)
    LEASE_PUSH = 107  # client → leased worker: batched task specs (no rid)
    LEASE_DONE = 108  # leased worker → client: batched task completions
    TASK_STATS = 109  # worker → head: batched flight records for tasks
    # that never transit the head (lease / raylet dispatch), so the
    # queue-wait histograms split by granted_by stay complete
    LEASE_NOTIFY = 110  # raylet → head: async accounting of local grants

    # cluster-wide sampling profiler (_private/profiler.py,
    # util/profile_api.py — same arm/disarm + KV/pubsub fan-out shape as
    # CHAOS_CTRL): PROFILE_CTRL is the driver→head control RPC
    # (arm/disarm/status/collect/stacks); armed processes ship folded-
    # stack deltas and one-shot stack dumps to the head on
    # fire-and-forget batched PROFILE_STATS frames (one per flush
    # window, never per sample)
    PROFILE_CTRL = 111
    PROFILE_STATS = 112

    # head fault tolerance (gcs/HEAD_FT.md): a live peer that redialed a
    # RESTARTED head re-announces its identity + held state (role-tagged:
    # raylet node resources/store, worker running tasks + hosted actor,
    # driver owned actors + cached leases) so the recovery grace window
    # can reconcile the replayed WAL state against what actually survived
    # (reference analog: HandleNotifyGCSRestart, node_manager.cc:1161)
    REATTACH = 114

    # -- compiled-DAG gang setup (ray_tpu_torch/dag/compiled.py) ---------
    # Second phase of the two-phase gang compile: DAG_SETUP with
    # ``arm: false`` installs channels/executors WITHOUT starting the
    # resident loops, then one DAG_ARM per participant starts every loop
    # only after ALL participants reported installed — a multi-host mesh
    # arms atomically or not at all (train/torch/step_dag.py).
    DAG_ARM = 113

    # structured log plane (util/OBSERVABILITY.md "Logs"): LOG_FETCH is
    # the pull-based retrieval RPC — client → head resolves an entity
    # (worker/actor/task/job/node) to its node's log files; the
    # head serves its own node and forwards the resolved read to the
    # owning raylet, which answers from disk (tail-N / cursor-ranged /
    # follow-by-polling).  ERROR_REPORT is the resurrected ERROR_PUSH
    # role at a NEW burned-in value (80 stays burned, see the retired
    # list above): worker → head fire-and-forget structured error record
    # (signature, traceback, last-K captured log lines) feeding the
    # head-side dedup ring behind `ray-tpu summary errors`.
    LOG_FETCH = 116
    ERROR_REPORT = 117


# Frames the chaos layer never injects into: its own control plane and
# the structured-event channel fault reports ride on (keep in sync with
# chaos.EXEMPT_MSG_TYPES, which holds the raw values to avoid a cycle).
_CHAOS_EXEMPT = frozenset({MsgType.RECORD_EVENT, MsgType.CHAOS_CTRL})


def _default(obj):
    raise TypeError(f"Unserializable control-plane value: {type(obj)!r}")


def pack(msg_type: int, request_id: int, payload: Dict[str, Any]) -> bytes:
    body = msgpack.packb(
        [int(msg_type), request_id, payload], use_bin_type=True, default=_default
    )
    return _LEN.pack(len(body)) + body


def unpack(body: bytes) -> Tuple[int, int, Dict[str, Any]]:
    msg_type, request_id, payload = msgpack.unpackb(body, raw=False, strict_map_key=False)
    return msg_type, request_id, payload


class Connection:
    """A multiplexed request/reply + push connection over one TCP socket.

    Both ends can issue requests; unsolicited pushes use request_id 0.
    """

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._write_lock = asyncio.Lock()
        # Disable Nagle on EVERY conn, including server-accepted ones
        # (connect() only covered the dialing side): a Nagled reply leg
        # adds milliseconds of coalescing delay to each small control
        # frame, which dominates ping-pong patterns like direct actor
        # calls.
        try:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                import socket as _s

                sock.setsockopt(_s.IPPROTO_TCP, _s.TCP_NODELAY, 1)
        except OSError:
            pass

    @classmethod
    async def connect(
        cls, host: str, port: int, timeout: float = 10.0, retry: bool = True
    ) -> "Connection":
        """Dial with bounded full-jitter retry inside the `timeout` window,
        so a peer that is mid-restart (head failover, raylet respawn)
        doesn't fail every client at t=0 — and the retries don't
        synchronize into a reconnect herd.  `retry=False` keeps the old
        single-attempt fast-fail (direct-call probes want that: an
        unreachable actor port should negative-cache immediately, not
        burn the whole dial window)."""
        deadline = time.monotonic() + timeout
        backoff = chaos.Backoff(base=0.05, cap=1.0)
        while True:
            rem = deadline - time.monotonic()
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), max(rem, 0.05)
                )
                break
            except (OSError, asyncio.TimeoutError) as e:
                delay = backoff.next_delay()
                rem = deadline - time.monotonic()
                if not retry or rem <= 0 or delay is None:
                    raise ConnectionError(
                        f"connect to {host}:{port} failed after "
                        f"{backoff.attempt} attempt(s) within {timeout:.1f}s: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                await asyncio.sleep(min(delay, rem))
        return cls(reader, writer)  # __init__ sets TCP_NODELAY

    async def send(self, msg_type: int, payload: Dict[str, Any], request_id: int = 0):
        data = pack(msg_type, request_id, payload)
        dup = False
        if chaos.wire_on and msg_type not in _CHAOS_EXEMPT:
            verdict = chaos.wire_decide("wire.send", int(msg_type))
            if verdict is not None:
                action, param = verdict
                if action == "drop":
                    return
                if action == "sever":
                    self.close()
                    raise ConnectionError(
                        f"chaos: connection severed on send({int(msg_type)})"
                    )
                if action == "delay":
                    await asyncio.sleep(param)
                dup = action == "dup"
        async with self._write_lock:
            self.writer.write(data)
            if dup:
                self.writer.write(data)
            await self.writer.drain()

    async def request(
        self, msg_type: int, payload: Dict[str, Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """Send a request and await the paired reply (run read_loop elsewhere)."""
        if chaos.wire_on and msg_type not in _CHAOS_EXEMPT:
            verdict = chaos.wire_decide("wire.request", int(msg_type))
            if verdict is not None:
                action, param = verdict
                if action == "fail":
                    raise ConnectionError(
                        f"chaos: request({int(msg_type)}) failed before send"
                    )
                if action == "delay":
                    await asyncio.sleep(param)
        rid = next(self._req_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self.send(msg_type, payload, rid)
            return await (asyncio.wait_for(fut, timeout) if timeout else fut)
        finally:
            self._pending.pop(rid, None)

    async def reply(self, request_id: int, payload: Dict[str, Any], error: str = None):
        if error is not None:
            await self.send(MsgType.ERROR_REPLY, {"error": error}, request_id)
        else:
            await self.send(MsgType.REPLY, payload, request_id)

    def dispatch_reply(self, msg_type: int, request_id: int, payload: Dict[str, Any]) -> bool:
        """Route an incoming frame to a pending request future. Returns True if consumed."""
        fut = self._pending.get(request_id)
        if fut is None or fut.done():
            return False
        if msg_type == MsgType.ERROR_REPLY:
            fut.set_exception(ConnectionError(payload.get("error", "remote error")))
        else:
            fut.set_result(payload)
        return True

    async def read_frame(self) -> Tuple[int, int, Dict[str, Any]]:
        while True:
            hdr = await self.reader.readexactly(_LEN.size)
            (n,) = _LEN.unpack(hdr)
            if n > MAX_FRAME:
                raise ConnectionError(f"frame too large: {n}")
            body = await self.reader.readexactly(n)
            frame = unpack(body)
            if chaos.wire_on and frame[0] not in _CHAOS_EXEMPT:
                verdict = chaos.wire_decide("wire.read", int(frame[0]))
                if verdict is not None:
                    action, param = verdict
                    if action == "drop":
                        continue  # frame vanishes; keep reading
                    if action == "sever":
                        self.close()
                        raise ConnectionError(
                            f"chaos: connection severed on read({int(frame[0])})"
                        )
                    if action == "delay":
                        await asyncio.sleep(param)
            return frame

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self.writer.close()
            except (OSError, RuntimeError):
                # best-effort close of an already-broken transport; the
                # pending-future sweep below is what callers observe
                pass
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("connection closed"))
            self._pending.clear()

    @property
    def closed(self) -> bool:
        return self._closed
