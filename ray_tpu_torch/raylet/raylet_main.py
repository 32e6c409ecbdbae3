"""Raylet: the per-node agent.

Analog of the reference's raylet binary (reference: src/ray/raylet/main.cc +
worker_pool.cc): registers the node with the head, spawns worker processes
on demand, supervises them, and — since round 2 — owns the node's private
shared-memory object store plus the transfer agent that moves objects
between nodes (reference: src/ray/object_manager/object_manager.h).
Scheduling decisions live in the head (see gcs/server.py); this agent is
the node-local arm that executes spawn/kill/pull/delete directives.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import traceback
from typing import List

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import profiler
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.protocol import Connection, MsgType
from ray_tpu_torch.util.lockwitness import named_lock


class Raylet:
    def __init__(self, head_host: str, head_port: int, resources: dict, session_dir: str):
        self.head_host = head_host
        self.head_port = head_port
        self.resources = resources
        self.session_dir = session_dir
        self.node_id = NodeID.from_random()
        self.store_path = os.path.join(session_dir, f"store-{self.node_id.hex()[:8]}")
        self.worker_procs: List[subprocess.Popen] = []
        self.worker_pids: List[int] = []  # zygote-forked workers
        self._zygote = None
        # spawns run on executor threads (off the read loop): serialize
        # seq/zygote mutation
        self._spawn_lock = named_lock("Raylet._spawn_lock")
        self._worker_seq = 0
        self.store = None
        self.object_agent = None
        self.lease_agent = None  # node-local dispatch (lease_agent.py)

    async def run(self):
        from ray_tpu_torch.core.shm_store import ShmObjectStore
        from ray_tpu_torch.raylet.object_agent import ObjectTransferAgent

        # Per-node store segment: THIS is what makes multi-node real — data
        # produced on this node lives here, and crossing nodes requires the
        # transfer agent, exactly like plasma + object manager upstream.
        self.store = ShmObjectStore(
            self.store_path, capacity=RayConfig.object_store_memory, create=True
        )
        if RayConfig.object_spilling_enabled:
            loop = asyncio.get_running_loop()
            spill_dir = self.store_path + ".spill"

            def _spill_hook(need: int) -> bool:
                # runs on whichever thread hit pressure (agent pulls run on
                # the loop itself); notify is scheduled, never awaited here
                from ray_tpu_torch.raylet.spill import spill_batch

                spilled = spill_batch(self.store, int(need), spill_dir)
                if not spilled:
                    return False
                conn = getattr(self, "conn", None)
                if conn is not None:
                    asyncio.run_coroutine_threadsafe(
                        conn.send(
                            MsgType.SPILL_NOTIFY,
                            {"node_id": self.node_id.binary(), "spilled": spilled},
                        ),
                        loop,
                    )
                return True

            self.store.spill_hook = _spill_hook

            def _event_hook(event_type: str, payload: dict) -> None:
                # store pressure events surface in the head's cluster-event
                # ring so operators can see eviction fallbacks
                conn = getattr(self, "conn", None)
                if conn is not None:
                    asyncio.run_coroutine_threadsafe(
                        conn.send(
                            MsgType.RECORD_EVENT,
                            {
                                "severity": "WARNING",
                                "source": "object_store",
                                "message": event_type,
                                "fields": {
                                    "node_id": self.node_id.hex(),
                                    **payload,
                                },
                            },
                        ),
                        loop,
                    )

            self.store.event_hook = _event_hook
        self.object_agent = ObjectTransferAgent(self.store)
        transfer_port = await self.object_agent.start()
        advertise = os.environ.get("RAY_TPU_NODE_IP", "127.0.0.1")

        # node-local lease dispatch: workers announce themselves here and
        # node-affine leases grant without a head round-trip (the head
        # learns asynchronously via LEASE_NOTIFY)
        dispatch_addr = ""
        if RayConfig.raylet_local_dispatch and RayConfig.lease_cache_enabled:
            from ray_tpu_torch.raylet.lease_agent import LeaseAgent

            self.lease_agent = LeaseAgent(self, advertise)
            dispatch_port = await self.lease_agent.start()
            dispatch_addr = f"{advertise}:{dispatch_port}"

        # per-node Prometheus scrape endpoint (reference analog:
        # dashboard reporter_agent.py)
        from ray_tpu_torch.raylet.metrics_agent import start_metrics_server

        async def _app_metrics() -> str:
            # pull the cluster's app-metrics records (incl. flight-recorder
            # phase histograms) from the head KV over the raylet's control
            # connection; conn is set after registration, scrapes before
            # that serve node stats only
            conn = getattr(self, "conn", None)
            if conn is None:
                return ""
            from ray_tpu_torch.util import metrics as metrics_mod

            # prefix-ranged multi-get: ONE round trip per scrape, not 1+N
            reply = await conn.request(
                MsgType.KV_KEYS, {"prefix": "metrics:", "values": True}, 10
            )
            raw = {
                str(k): bytes(v) for k, v in (reply.get("values") or {}).items()
            }
            return metrics_mod.render_prometheus(
                metrics_mod.merge_series(metrics_mod.raw_records_from_kv(raw))
            )

        try:
            metrics_port = await start_metrics_server(
                self.node_id.hex(), self.store, app_metrics=_app_metrics
            )
        except Exception as e:  # noqa: BLE001
            print(f"raylet: metrics endpoint unavailable: {e}", file=sys.stderr)
            metrics_port = 0

        chaos.maybe_init_from_env("raylet")
        profiler.maybe_init_from_env("raylet")
        conn = await Connection.connect(self.head_host, self.head_port)
        self.conn = conn
        reply_fut = asyncio.get_running_loop().create_task(self._read_loop(conn))
        asyncio.get_running_loop().create_task(self._heartbeat_loop(conn))
        # announce payload is also the head-FT reattach announce (plus
        # role/num_objects): keep it for the redial loop
        self._announce = {
            "node_id": self.node_id.binary(),
            "resources": self.resources,
            "store_path": self.store_path,
            "address": advertise,
            "transfer_addr": f"{advertise}:{transfer_port}",
            "metrics_addr": f"{advertise}:{metrics_port}" if metrics_port else "",
            "dispatch_addr": dispatch_addr,
        }
        # bounded like every other request on this conn: a head wedged
        # mid-recovery must fail the registration, not park the raylet
        # forever (30s > REATTACH's 10 — first registration can land while
        # the head is still replaying its WAL)
        reply = await conn.request(MsgType.REGISTER_NODE, self._announce, 30)
        if not reply.get("ok"):
            raise RuntimeError(
                f"head rejected node registration for {self.node_id.hex()[:8]}: "
                f"{reply!r}"
            )

        # tail this node's worker logs and relay to the head's "logs"
        # channel (analog: reference log_monitor.py per node)
        from ray_tpu_torch._private.log_monitor import LogTailer

        loop = asyncio.get_running_loop()

        def _publish_logs(msg: dict):
            # via self.conn: survives a head-FT conn swap after a restart
            asyncio.run_coroutine_threadsafe(
                self.conn.send(
                    MsgType.PUBLISH, {"channel": "logs", "message": msg}
                ),
                loop,
            )

        self._log_tailer = LogTailer(
            self.session_dir,
            _publish_logs,
            pattern=f"worker-{self.node_id.hex()[:8]}-*.log",
            rotation_bytes=RayConfig.log_rotation_bytes,
            rotation_backups=RayConfig.log_rotation_backups,
        )
        self._log_tailer.start()

        if chaos.aware():
            # fault events → the head's cluster-event ring (best-effort;
            # RECORD_EVENT frames are exempt from injection)
            def _chaos_emit(ev: dict):
                asyncio.run_coroutine_threadsafe(
                    self.conn.send(
                        MsgType.RECORD_EVENT,
                        {
                            "severity": "WARNING",
                            "source": "chaos",
                            "message": ev["message"],
                            "fields": ev["fields"],
                        },
                    ),
                    loop,
                )

            chaos.set_emitter(_chaos_emit)
            # late-joiner plan sync + live arm/disarm pushes (the PUBLISH
            # branch in _read_loop applies them)
            try:
                kv = await conn.request(MsgType.KV_GET, {"key": "chaos:plan"}, 10)
                if kv.get("found"):
                    chaos.apply_ctrl(json.loads(bytes(kv["value"]).decode()))
                await conn.request(MsgType.SUBSCRIBE, {"channel": "chaos"}, 10)
            except Exception:  # noqa: BLE001
                print(
                    "raylet: chaos control-channel sync failed; env-armed "
                    "plan (if any) stays active",
                    file=sys.stderr,
                )
        if profiler.aware():
            # folded-stack deltas → the head aggregator; late-join the
            # active control record; live arm/disarm pushes land in the
            # PUBLISH branch of _read_loop
            def _profile_emit(payload: dict):
                asyncio.run_coroutine_threadsafe(
                    self.conn.send(
                        MsgType.PROFILE_STATS,
                        dict(payload, node_id=self.node_id.binary()),
                    ),
                    loop,
                )

            profiler.set_emitter(_profile_emit)
            try:
                # subscribe BEFORE the KV read: an arm landing in the gap
                # then reaches us twice (push + KV, arm is idempotent);
                # the reverse order could miss it entirely
                await conn.request(MsgType.SUBSCRIBE, {"channel": "profile"}, 10)
                kv = await conn.request(
                    MsgType.KV_GET, {"key": "profile:ctrl"}, 10
                )
                if kv.get("found"):
                    profiler.apply_ctrl(json.loads(bytes(kv["value"]).decode()))
            except Exception:  # noqa: BLE001
                print(
                    "raylet: profiler control-channel sync failed; env-armed "
                    "sampler (if any) stays active",
                    file=sys.stderr,
                )
        print(f"NODE {self.node_id.hex()}", flush=True)
        # service loop: the read loop ending means the head conn died.
        # With a redial window configured this node RIDES THROUGH a head
        # restart — local workers, the store, and the lease agent keep
        # serving while we reattach — instead of tearing the node down.
        while True:
            try:
                await reply_fut
            except Exception:  # noqa: BLE001
                # unexpected read-loop failure (IO errors are caught inside
                # it): fall through to a clean teardown, never skip
                # shutdown() — workers and the store die with this node
                traceback.print_exc(file=sys.stderr)
                break
            window = RayConfig.head_reconnect_window_s
            if window <= 0:
                break
            got = await self._redial_head(window)
            if got is None:
                break
            self.conn, reply_fut = got
            asyncio.get_running_loop().create_task(self._heartbeat_loop(self.conn))
            print("raylet: reattached to restarted head", file=sys.stderr, flush=True)
        self.shutdown()

    async def _redial_head(self, window: float):
        """Redial + REATTACH within the window.  Returns (conn, read_fut)
        or None when the head never came back."""
        import time

        from ray_tpu_torch._private.chaos import Backoff

        print(
            f"raylet: head connection lost; redialing for up to {window:.1f}s",
            file=sys.stderr,
            flush=True,
        )
        deadline = time.monotonic() + window
        backoff = Backoff(base=0.1, cap=1.0)
        loop = asyncio.get_running_loop()
        while time.monotonic() < deadline:
            rem = deadline - time.monotonic()
            try:
                conn = await Connection.connect(
                    self.head_host, self.head_port, min(max(rem, 0.1), 5.0), retry=False
                )
            except Exception:  # graftlint: disable=silent-except -- head still down; the redial loop IS the handler (backoff below, typed give-up at the window)
                await asyncio.sleep(
                    min(backoff.next_delay_or(1.0), max(0.05, deadline - time.monotonic()))
                )
                continue
            read_fut = loop.create_task(self._read_loop(conn))
            payload = dict(self._announce)
            payload["role"] = "node"
            try:
                payload["num_objects"] = self.store.num_objects()
            except OSError:
                payload["num_objects"] = 0
            try:
                reply = await conn.request(MsgType.REATTACH, payload, 10)
                if not reply.get("ok"):
                    raise ConnectionError(f"head rejected node reattach: {reply!r}")
            except Exception:  # noqa: BLE001
                traceback.print_exc(file=sys.stderr)
                conn.close()
                try:
                    await read_fut
                except Exception:  # graftlint: disable=silent-except -- read loop on an abandoned dial; its conn is already closed
                    pass
                await asyncio.sleep(
                    min(backoff.next_delay_or(1.0), max(0.05, deadline - time.monotonic()))
                )
                continue
            return conn, read_fut
        print(
            f"raylet: head still unreachable after {window:.1f}s; shutting down node",
            file=sys.stderr,
            flush=True,
        )
        return None

    async def _heartbeat_loop(self, conn: Connection):
        """Periodic liveness beacon.  The head declares this node dead after
        num_heartbeats_timeout missed beats — TCP staying open is NOT enough
        (a SIGSTOPped or wedged raylet keeps its socket alive forever).
        Analog: reference gcs_heartbeat_manager.h."""
        period = RayConfig.heartbeat_period_ms / 1000.0
        try:
            while True:
                await asyncio.sleep(period)
                beat = {"node_id": self.node_id.binary()}
                # piggyback this node's shm occupancy so the head's memory
                # accounting (`ray-tpu summary memory`, ray_tpu_torch_shm_*
                # gauges) covers every node without a second RPC plane
                store = self.store
                if store is not None:
                    try:
                        beat["store"] = {
                            "used": store.used(),
                            "capacity": store.capacity(),
                            "objects": store.num_objects(),
                            "evictions": store.evictions(),
                        }
                    except OSError:
                        pass  # store mid-teardown: plain beat still goes
                await conn.send(MsgType.HEARTBEAT, beat)
        except (ConnectionError, OSError):
            pass

    async def _read_loop(self, conn: Connection):
        try:
            while True:
                msg_type, rid, payload = await conn.read_frame()
                if conn.dispatch_reply(msg_type, rid, payload):
                    continue
                if msg_type == MsgType.PUSH_TASK and payload.get("directive") == "spawn_worker":
                    # blocking zygote/exec work off the read loop
                    asyncio.get_running_loop().run_in_executor(
                        None, self._spawn_worker, bool(payload.get("gpu"))
                    )
                elif (
                    msg_type == MsgType.PUSH_TASK
                    and payload.get("directive") == "revoke_lease"
                ):
                    # head preemption of a locally-granted lease: forward
                    # to the holder, which drains + returns through us
                    if self.lease_agent is not None:
                        self.lease_agent.revoke(
                            bytes(payload.get("lease_id") or b""),
                            int(payload.get("band", 0)),
                        )
                elif (
                    msg_type == MsgType.PUSH_TASK
                    and payload.get("directive") == "kill_worker"
                ):
                    # preemption victim on this node: the head's os.kill
                    # only reaches its own host, so the strike is delegated
                    # here (worker death then flows back over the conn loss)
                    try:
                        os.kill(int(payload["pid"]), int(payload.get("sig", 9)))
                    except (OSError, ValueError, KeyError):
                        pass  # already gone / malformed: the head's failure detector owns the truth
                elif (
                    msg_type == MsgType.PUSH_TASK
                    and payload.get("directive") == "release_pins"
                ):
                    # a worker of this node died: drop its pins in this
                    # node's store once its process is gone
                    from ray_tpu_torch.core.shm_store import release_pins_when_gone

                    asyncio.get_running_loop().create_task(
                        release_pins_when_gone(self.store, int(payload["pid"]))
                    )
                elif msg_type == MsgType.OBJECT_PULL:
                    asyncio.get_running_loop().create_task(
                        self._handle_pull(conn, rid, payload)
                    )
                elif msg_type == MsgType.LOG_FETCH:
                    # per-node log agent: the head resolved the entity to
                    # files on THIS node; serve the disk read off the loop
                    asyncio.get_running_loop().create_task(
                        self._handle_log_fetch(conn, rid, payload)
                    )
                elif msg_type == MsgType.OBJECT_DELETE:
                    for oid in payload.get("object_ids", []):
                        self.store.delete(bytes(oid))
                    if payload.get("spill_paths"):
                        from ray_tpu_torch.raylet.spill import delete_spilled

                        for path in payload["spill_paths"]:
                            delete_spilled(path)
                elif msg_type == MsgType.OBJECT_RESTORE:
                    asyncio.get_running_loop().create_task(
                        self._handle_restore(conn, rid, payload)
                    )
                elif (
                    msg_type == MsgType.PUBLISH
                    and payload.get("channel") == "chaos"
                ):
                    chaos.apply_ctrl(payload.get("message") or {})
                elif (
                    msg_type == MsgType.PUBLISH
                    and payload.get("channel") == "profile"
                ):
                    profiler.apply_ctrl(payload.get("message") or {})
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        # shutdown is decided by run()'s service loop: with a reconnect
        # window open, a dead head conn means redial, not teardown

    async def _handle_pull(self, conn: Connection, rid: int, payload: dict):
        oid = bytes(payload["object_id"])
        src = payload["src_addr"]
        try:
            ok = await asyncio.wait_for(self.object_agent.pull(oid, src), timeout=300)
            await conn.reply(rid, {"ok": bool(ok)})
        except Exception as e:  # graftlint: disable=silent-except -- failure forwarded to the head inside the reply payload
            try:
                await conn.reply(rid, {"ok": False, "error": f"{type(e).__name__}: {e}"})
            except (OSError, RuntimeError):
                # head connection died while replying; the read loop's
                # shutdown path owns cleanup
                pass

    async def _handle_log_fetch(self, conn: Connection, rid: int, payload: dict):
        """Serve a resolved LOG_FETCH read from this node's disk: tail-N
        across the rotation seam, or a cursor-ranged follow read.  File
        paths were resolved by the head against entities IT owns; this
        agent only reads session-dir logs (enforced below)."""
        from ray_tpu_torch._private import log_monitor

        def _do():
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

        try:
            result = await asyncio.get_running_loop().run_in_executor(None, _do)
        except Exception as e:  # graftlint: disable=silent-except -- failure forwarded to the head inside the reply payload
            result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        try:
            await conn.reply(rid, result)
        except (OSError, RuntimeError):
            # head connection died while replying; the read loop's
            # shutdown path owns cleanup
            pass

    async def _handle_restore(self, conn: Connection, rid: int, payload: dict):
        from ray_tpu_torch.raylet.spill import delete_spilled, restore_object

        oid, path = bytes(payload["object_id"]), payload["path"]

        def _do():
            ok = restore_object(self.store, oid, path)
            if ok:
                delete_spilled(path)  # back in shm; don't leak the file
            return ok

        ok = await asyncio.get_running_loop().run_in_executor(None, _do)
        try:
            await conn.reply(rid, {"ok": bool(ok)})
        except (OSError, RuntimeError):
            # head connection died while replying; restore result stands
            pass

    def _spawn_worker(self, gpu: bool = False):
        with self._spawn_lock:
            self._spawn_worker_locked(gpu)

    def _spawn_worker_locked(self, gpu: bool = False):
        self._worker_seq += 1
        env = dict(os.environ)
        env["RAY_TPU_HEAD"] = f"{self.head_host}:{self.head_port}"
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_STORE_PATH"] = self.store_path
        # per-process chaos stream id (see chaos.py stream_seed)
        env["RAY_TPU_CHAOS_NONCE"] = str(self._worker_seq)
        if self.lease_agent is not None and self.lease_agent.port:
            # workers dial the node's lease agent so node-affine leases
            # grant locally (127.0.0.1: same host by construction)
            env["RAY_TPU_RAYLET_DISPATCH"] = f"127.0.0.1:{self.lease_agent.port}"
        else:
            env.pop("RAY_TPU_RAYLET_DISPATCH", None)
        if gpu:
            # GPU worker: keeps the ambient CUDA_VISIBLE_DEVICES
            env["RAY_TPU_WORKER_GPU"] = "1"
        else:
            env["CUDA_VISIBLE_DEVICES"] = ""  # pool workers see no card
            env.pop("RAY_TPU_WORKER_GPU", None)
        log = os.path.join(
            self.session_dir, f"worker-{self.node_id.hex()[:8]}-{self._worker_seq}.log"
        )
        if not gpu:
            # pool workers fork from the warm zygote (~30ms vs ~1s exec);
            # GPU workers keep exec — a forked child cannot initialise CUDA
            if self._zygote is None:
                from ray_tpu_torch._private.zygote import ZygoteSpawner

                self._zygote = ZygoteSpawner(
                    dict(env),
                    os.path.join(
                        self.session_dir, f"zygote-{self.node_id.hex()[:8]}.log"
                    ),
                )
            pid = self._zygote.spawn(env, log)
            if pid is not None:
                self.worker_pids.append(pid)
                return
        with open(log, "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
                env=env,
                stdout=logf,
                stderr=logf,
            )
        self.worker_procs.append(proc)

    def kill_workers(self):
        for proc in self.worker_procs:
            try:
                proc.terminate()
            except OSError:
                pass
        for pid in self.worker_pids:
            try:
                os.kill(pid, 15)
            except OSError:
                pass
        if self._zygote is not None:
            self._zygote.stop()

    def shutdown(self):
        self.kill_workers()
        try:
            if self.lease_agent is not None:
                self.lease_agent.stop()
        except Exception:  # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
        try:
            if self.object_agent is not None:
                self.object_agent.stop()
        except Exception:  # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
        try:
            if self.store is not None:
                self.store.close()
        except Exception:  # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
        try:
            os.unlink(self.store_path)
        except OSError:
            pass


def main():
    # same on-demand stack dump every worker registers (kill -USR1)
    profiler.install_sigusr1()
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", required=True)  # host:port
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--session-dir", required=True)
    args = parser.parse_args()
    host, port = args.head.rsplit(":", 1)
    raylet = Raylet(host, int(port), json.loads(args.resources), args.session_dir)
    # the raylet's own stderr joins the structured plane too (stamped
    # with its node id; no-op under RAY_TPU_LOG_STRUCTURED=0).  stdout
    # stays raw: it is the "NODE <id>" handshake pipe the cluster
    # launcher readline()s — a record-wrapped handshake never matches
    # (same contract as the head's "PORT <n>" pipe)
    from ray_tpu_torch._private import log_plane

    log_plane.install(node=raylet.node_id.hex()[:8], wrap_stdout=False)

    def _term(signum, frame):
        raylet.shutdown()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    try:
        asyncio.run(raylet.run())
    except KeyboardInterrupt:
        raylet.shutdown()


if __name__ == "__main__":
    main()
