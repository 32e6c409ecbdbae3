"""Raylet-local lease dispatch: node-affine work granted without a head
round-trip.

The reference schedules *bottom-up* — raylets grant worker leases locally
and the GCS only learns about placements (reference:
src/ray/raylet/node_manager.cc RequestWorkerLease +
scheduling/cluster_task_manager.cc).  This agent is that grant path for
this runtime: workers spawned on the node announce their direct-call
endpoints here (``RAY_TPU_RAYLET_DISPATCH``); clients with node-affine
work request leases straight from the agent; grants come from the local
idle set, band-ordered (higher priority first, FIFO within a band, with
the same starvation boost the head's dispatch queue applies), and the
head learns about each grant ASYNCHRONOUSLY over the raylet's control
connection (``LEASE_NOTIFY``) — it accounts the resources but never
brokered the placement.

Revocation (preemption at the raylet): the head routes a
``revoke_lease`` directive through the raylet; the agent forwards
``LEASE_REVOKE`` to the holder's connection, and the holder drains +
returns exactly like a head-granted lease.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.protocol import Connection, MsgType


class _AgentWorker:
    __slots__ = ("worker_id", "pid", "direct_addr", "has_gpu", "conn", "leased", "dedicated")

    def __init__(self, worker_id: bytes, pid: int, direct_addr: str, has_gpu: bool, conn):
        self.worker_id = worker_id
        self.pid = pid
        self.direct_addr = direct_addr
        self.has_gpu = has_gpu
        self.conn = conn  # the worker's registration conn (liveness)
        self.leased: Optional[bytes] = None  # lease_id while granted
        self.dedicated = False  # actor workers are never leased


class LeaseAgent:
    """One per raylet, sharing its event loop."""

    def __init__(self, raylet, advertise: str):
        self.raylet = raylet
        self.advertise = advertise
        self.workers: Dict[bytes, _AgentWorker] = {}
        self.leases: Dict[bytes, dict] = {}  # lease_id -> grant record
        # queued local requests waiting for a worker: band-ordered with the
        # head's starvation-boost semantics; each entry (band, seq,
        # enqueued_at, resources, needs_gpu, future)
        self._pending: List[dict] = []
        self._seq = 0
        # local resource mirror: what OUR grants hold (the head's view
        # stays authoritative; between grant and LEASE_NOTIFY the node is
        # transiently oversubscribed in its view, by design)
        self._in_use: Dict[str, float] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.port = 0

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._on_connection, "0.0.0.0", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.close()

    # ------------------------------------------------------------- serving

    async def _on_connection(self, reader, writer):
        conn = Connection(reader, writer)
        registered: Optional[_AgentWorker] = None
        try:
            while True:
                msg_type, rid, payload = await conn.read_frame()
                if conn.dispatch_reply(msg_type, rid, payload):
                    continue
                if msg_type == MsgType.REGISTER_WORKER:
                    registered = self._on_register(conn, payload, registered)
                elif msg_type == MsgType.LEASE_REQUEST:
                    asyncio.get_running_loop().create_task(
                        self._h_lease_request(conn, rid, payload)
                    )
                elif msg_type == MsgType.LEASE_RETURN:
                    self._release(bytes(payload.get("lease_id") or b""))
                    if rid:
                        await conn.reply(rid, {"ok": True})
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            conn.close()
            if registered is not None:
                # worker gone: forget it and drop any lease it carried
                self.workers.pop(registered.worker_id, None)
                if registered.leased:
                    self._release(registered.leased, worker_gone=True)
            else:
                # a HOLDER conn (lease client) died: reclaim every lease it
                # was granted — head-granted leases die with the driver's
                # head conn, raylet-granted ones must die with this one or
                # the worker + its capacity leak at both the agent and the
                # head (which learned of the grant via LEASE_NOTIFY)
                for lid, rec in list(self.leases.items()):
                    if rec.get("holder") is conn:
                        self._release(lid)

    def _on_register(self, conn, p, prev) -> Optional[_AgentWorker]:
        wid = bytes(p.get("worker_id") or b"")
        if p.get("dedicated"):
            w = self.workers.get(wid)
            if w is not None:
                w.dedicated = True
            return prev
        w = _AgentWorker(
            wid,
            int(p.get("pid", 0)),
            str(p.get("direct_addr") or ""),
            bool(p.get("has_gpu")),
            conn,
        )
        self.workers[wid] = w
        self._grant_pending()
        return w

    # -------------------------------------------------------------- leasing

    def _fits(self, res: Dict[str, float]) -> bool:
        total = self.raylet.resources or {}
        for k, v in res.items():
            if v <= 0:
                continue
            if self._in_use.get(k, 0.0) + v > float(total.get(k, 0.0)) + 1e-9:
                return False
        return True

    def _idle_worker(self, needs_gpu: bool) -> Optional[_AgentWorker]:
        for w in self.workers.values():
            if (
                w.leased is None
                and not w.dedicated
                and w.direct_addr
                and w.has_gpu == needs_gpu
            ):
                return w
        return None

    async def _h_lease_request(self, conn, rid, p):
        res = {
            str(k): float(v)
            for k, v in (p.get("resources") or {"CPU": 1.0}).items()
        }
        band = int(p.get("priority", 1))
        self._seq += 1
        entry = {
            "band": band,
            "seq": self._seq,
            "enqueued_at": time.time(),
            "resources": res,
            "needs_gpu": res.get(RayConfig.gpu_resource_name, 0) > 0,
            "fut": asyncio.get_running_loop().create_future(),
            "holder": conn,
        }
        self._pending.append(entry)
        self._grant_pending()
        try:
            # short park: band-ordered grant when a worker frees in time,
            # else the client falls back to the head grant path
            reply = await asyncio.wait_for(entry["fut"], 0.2)
        except asyncio.TimeoutError:
            reply = {"granted": False, "reason": "no local capacity"}
        finally:
            if entry in self._pending:
                self._pending.remove(entry)
        if rid:
            try:
                await conn.reply(rid, reply)
            except (OSError, RuntimeError):
                if reply.get("granted"):
                    self._release(bytes(reply["lease_id"]))

    def _grant_pending(self):
        """Band-ordered local grant: higher band first (one-band
        starvation boost past priority_starvation_s), FIFO within a band
        — the head's dispatch ordering, applied at the raylet."""
        if not self._pending:
            return
        now = time.time()
        starve = RayConfig.priority_starvation_s

        def order(e):
            band = e["band"]
            if starve > 0 and now - e["enqueued_at"] > starve:
                band += 1
            return (-band, e["seq"])

        for entry in sorted(self._pending, key=order):
            if entry["fut"].done():
                continue
            if not self._fits(entry["resources"]):
                continue
            w = self._idle_worker(entry["needs_gpu"])
            if w is None:
                continue
            lease_id = os.urandom(12)
            w.leased = lease_id
            for k, v in entry["resources"].items():
                self._in_use[k] = self._in_use.get(k, 0.0) + v
            host = self.advertise or "127.0.0.1"
            port = str(w.direct_addr).rsplit(":", 1)[-1]
            self.leases[lease_id] = {
                "worker_id": w.worker_id,
                "resources": dict(entry["resources"]),
                "priority": entry["band"],
                "holder": entry["holder"],
            }
            entry["fut"].set_result(
                {
                    "granted": True,
                    "lease_id": lease_id,
                    "worker_id": w.worker_id,
                    "addr": f"{host}:{port}",
                    "node_id": self.raylet.node_id.binary(),
                }
            )
            self._notify_head("grant", lease_id, self.leases[lease_id])

    def _release(self, lease_id: bytes, worker_gone: bool = False):
        rec = self.leases.pop(lease_id, None)
        if rec is None:
            return
        w = self.workers.get(rec["worker_id"])
        if w is not None and w.leased == lease_id:
            w.leased = None
        for k, v in rec["resources"].items():
            self._in_use[k] = max(0.0, self._in_use.get(k, 0.0) - v)
        self._notify_head("return", lease_id, rec)
        if not worker_gone:
            self._grant_pending()

    def revoke(self, lease_id: bytes, band: int):
        """Head directive: forward the revoke to the holder (the client
        then drains + LEASE_RETURNs here like any lease)."""
        rec = self.leases.get(bytes(lease_id))
        if rec is None:
            return
        holder = rec.get("holder")
        if holder is None or holder.closed:
            self._release(bytes(lease_id))
            return
        asyncio.get_running_loop().create_task(
            holder.send(
                MsgType.LEASE_REVOKE,
                {"lease_id": bytes(lease_id), "band": int(band)},
            )
        )

    def _notify_head(self, op: str, lease_id: bytes, rec: dict):
        conn = getattr(self.raylet, "conn", None)
        if conn is None:
            return
        payload = {
            "op": op,
            "lease_id": lease_id,
            "worker_id": rec["worker_id"],
            "resources": rec["resources"],
            "priority": rec["priority"],
        }
        try:
            asyncio.get_running_loop().create_task(
                conn.send(MsgType.LEASE_NOTIFY, payload)
            )
        except RuntimeError:
            print("lease-agent: head notify skipped (no loop)", file=sys.stderr)
