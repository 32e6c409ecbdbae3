"""Sharded GCS namespaces: KV, object-locate, and actor-directory reads
served off the head event loop.

The head loop is the task-dispatch critical path (ROADMAP item 1 /
PAPERS.md §2: dispatch latency is the scarce resource).  Before this
module, every KV get, metrics scrape, object-locate wait, and actor
lookup serialized behind task dispatch on that one loop.  Now:

- ``ShardedKV`` is the cluster KV table itself: a thread-safe mapping
  partitioned into per-shard dicts with per-shard locks, plus a global
  waiter registry (``kv_get(wait=True)`` futures fire on THEIR owning
  event loop via call_soon_threadsafe, whichever thread performs the
  put).  The head server holds one instance as ``self.kv`` — all of its
  internal reads/writes go through the same store the shard servers
  serve, so there is exactly one source of truth.

- ``ObjectMirror`` / ``ActorMirror`` are read replicas of the head's
  object directory (seal state only — locations and transfers stay
  authoritative on the head) and actor table.  The head writes through
  on every transition (a dict store + possible waiter wake, O(1)); the
  shard listeners serve ``WAIT_OBJECT`` (batch and locate forms) and
  ``GET_ACTOR`` / read-only ``ACTOR_STATE`` from them.

- ``GcsShardServer`` runs N threads, each with its OWN asyncio loop and
  TCP listener (reference analog: the multi-shard GCS deployments of
  Ray 2.x whitepapers; here threads-with-own-loops, since the data is
  lock-partitioned in one process).  Clients learn the shard addresses
  at registration and route shardable message types there
  (core_worker.request), falling back to the head connection — the head
  keeps every handler, so shards are purely an offload.
"""

from __future__ import annotations

import asyncio
import logging
import threading

import zlib
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util.lockwitness import named_lock

logger = logging.getLogger("ray_tpu_torch.gcs.shards")

# object mirror states (match gcs/server.py PENDING/SEALED/ERRORED)
PENDING, SEALED, ERRORED = 0, 1, 2


class ShardedKV:
    """Thread-safe cluster KV table partitioned into lock shards.

    Implements the mapping surface gcs/server.py uses (``[]``, ``get``,
    ``pop``, ``in``, iteration, ``items``/``keys``) — iteration returns a
    snapshot, so handler code can await mid-scan without tripping over
    concurrent shard writes."""

    def __init__(self, nshards: int = 4):
        n = max(1, int(nshards))
        self._n = n
        self._shards: List[Dict[str, bytes]] = [dict() for _ in range(n)]
        self._locks = [named_lock(f"ShardedKV._locks[{i}]") for i in range(n)]
        # key -> [(loop, future)]: kv_get(wait=True) waiters, fired by
        # whichever thread lands the put (on the waiter's own loop)
        self._waiters: Dict[str, List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]]] = {}
        self._wlock = named_lock("ShardedKV._wlock")

    def _i(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self._n

    # ---------------------------------------------------- mapping surface

    def __getitem__(self, key: str) -> bytes:
        i = self._i(key)
        with self._locks[i]:
            return self._shards[i][key]

    def __setitem__(self, key: str, value: bytes):
        i = self._i(key)
        with self._locks[i]:
            self._shards[i][key] = value

    def __delitem__(self, key: str):
        i = self._i(key)
        with self._locks[i]:
            del self._shards[i][key]

    def __contains__(self, key: str) -> bool:
        i = self._i(key)
        with self._locks[i]:
            return key in self._shards[i]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def get(self, key: str, default=None):
        i = self._i(key)
        with self._locks[i]:
            return self._shards[i].get(key, default)

    def pop(self, key: str, *default):
        i = self._i(key)
        with self._locks[i]:
            return self._shards[i].pop(key, *default)

    def keys(self) -> List[str]:
        out: List[str] = []
        for i in range(self._n):
            with self._locks[i]:
                out.extend(self._shards[i].keys())
        return out

    def items(self) -> List[Tuple[str, bytes]]:
        out: List[Tuple[str, bytes]] = []
        for i in range(self._n):
            with self._locks[i]:
                out.extend(self._shards[i].items())
        return out

    def update(self, other):
        for k, v in (other.items() if hasattr(other, "items") else other):
            self[k] = v

    # ------------------------------------------------------- put + waiters

    def put_notify(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        """The KV_PUT body: store (respecting overwrite=False) and fire
        any registered kv-wait futures on their own loops.  Returns
        whether the value was added."""
        i = self._i(key)
        with self._locks[i]:
            if not overwrite and key in self._shards[i]:
                return False
            self._shards[i][key] = value
        with self._wlock:
            waiters = self._waiters.pop(key, [])
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(self._fire, fut)
            except RuntimeError:
                pass  # waiter's loop already closed
        return True

    @staticmethod
    def _fire(fut: asyncio.Future):
        if not fut.done():
            fut.set_result(True)

    def register_waiter(self, key: str) -> Optional[asyncio.Future]:
        """Register a kv-wait future on the CALLING loop; returns None if
        the key already exists (nothing to wait for)."""
        loop = asyncio.get_running_loop()
        with self._wlock:
            # check under the waiter lock so a concurrent put_notify can't
            # land between our existence check and the registration
            if key in self:
                return None
            fut = loop.create_future()
            self._waiters.setdefault(key, []).append((loop, fut))
        return fut

    def unregister_waiter(self, key: str, fut: asyncio.Future):
        with self._wlock:
            lst = self._waiters.get(key)
            if lst is None:
                return
            self._waiters[key] = [(l, f) for (l, f) in lst if f is not fut]
            if not self._waiters[key]:
                self._waiters.pop(key, None)


class ObjectMirror:
    """Seal-state read replica of the head's object directory, with its
    own waiter registry so WAIT_OBJECT can be served from any shard loop
    (or the head loop) and woken by the head's write-through."""

    def __init__(self):
        self._state: Dict[bytes, Tuple[int, Optional[str]]] = {}
        self._waiters: Dict[bytes, List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]]] = {}
        self._lock = named_lock("ObjectMirror._lock")

    def state(self, oid: bytes) -> Tuple[int, Optional[str]]:
        with self._lock:
            return self._state.get(oid, (PENDING, None))

    def _transition(self, oid: bytes, st: Tuple[int, Optional[str]], wake: bool):
        with self._lock:
            self._state[oid] = st
            waiters = self._waiters.pop(oid, []) if wake else []
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(ShardedKV._fire, fut)
            except RuntimeError:
                pass

    def seal(self, oid: bytes):
        self._transition(bytes(oid), (SEALED, None), wake=True)

    def error(self, oid: bytes, msg: str):
        self._transition(bytes(oid), (ERRORED, msg), wake=True)

    def reset(self, oid: bytes):
        """Back to PENDING (reconstruction re-running the producer)."""
        with self._lock:
            self._state[bytes(oid)] = (PENDING, None)

    def drop(self, oid: bytes):
        with self._lock:
            self._state.pop(bytes(oid), None)

    def register_waiter(self, oid: bytes) -> Optional[asyncio.Future]:
        """None if already non-pending (check-then-register is atomic)."""
        loop = asyncio.get_running_loop()
        with self._lock:
            if self._state.get(bytes(oid), (PENDING, None))[0] != PENDING:
                return None
            fut = loop.create_future()
            self._waiters.setdefault(bytes(oid), []).append((loop, fut))
        return fut

    def unregister_waiter(self, oid: bytes, fut: asyncio.Future):
        with self._lock:
            lst = self._waiters.get(bytes(oid))
            if lst is None:
                return
            kept = [(l, f) for (l, f) in lst if f is not fut]
            if kept:
                self._waiters[bytes(oid)] = kept
            else:
                self._waiters.pop(bytes(oid), None)


class ActorMirror:
    """Read replica of the actor directory: GET_ACTOR / read-only
    ACTOR_STATE served without touching the head loop."""

    def __init__(self):
        self._actors: Dict[bytes, dict] = {}
        self._named: Dict[Tuple[str, str], bytes] = {}
        self._lock = named_lock("ActorMirror._lock")

    def upsert(self, actor_id: bytes, **fields):
        with self._lock:
            slot = self._actors.setdefault(bytes(actor_id), {})
            slot.update(fields)
            name = slot.get("name")
            if name:
                self._named[(slot.get("namespace", ""), name)] = bytes(actor_id)

    def drop_name(self, namespace: str, name: str):
        with self._lock:
            self._named.pop((namespace, name), None)

    def lookup(self, actor_id: Optional[bytes], namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            aid = bytes(actor_id) if actor_id else self._named.get((namespace, name))
            if aid is None:
                return None
            info = self._actors.get(aid)
            return dict(info, actor_id=aid) if info is not None else None


class GcsShardServer:
    """N shard threads, each with its own event loop and TCP listener,
    serving the read planes above.  Start from the head process; the
    returned addresses ride the REGISTER_* replies to clients."""

    def __init__(
        self,
        kv: ShardedKV,
        objects: ObjectMirror,
        actors: ActorMirror,
        host: str = "127.0.0.1",
        wal_cb=None,
        dirty_cb=None,
    ):
        self.kv = kv
        self.objects = objects
        self.actors = actors
        self.host = host
        # thread-safe callbacks into the head's persistence plumbing;
        # the head marshals onto its own loop internally
        self._wal_cb = wal_cb or (lambda *a: None)
        self._dirty_cb = dirty_cb or (lambda: None)
        self._threads: List[threading.Thread] = []
        self._loops: List[asyncio.AbstractEventLoop] = []
        self.addrs: List[str] = []
        self._stopping = False

    # ------------------------------------------------------------- lifecycle

    def start(self, nshards: int, advertise: Optional[str] = None) -> List[str]:
        for i in range(max(0, int(nshards))):
            ready = threading.Event()
            holder: Dict[str, Any] = {}
            t = threading.Thread(
                target=self._shard_thread,
                args=(i, ready, holder),
                name=f"gcs-shard-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
            ready.wait(10)
            port = holder.get("port")
            if port:
                self.addrs.append(f"{advertise or self.host}:{port}")
                self._loops.append(holder["loop"])
        return self.addrs

    def stop(self):
        self._stopping = True
        for loop in self._loops:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass

    def _shard_thread(self, idx: int, ready: threading.Event, holder: dict):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def _boot():
            bind = "0.0.0.0" if self.host in ("0.0.0.0", "") else self.host
            server = await asyncio.start_server(self._on_connection, bind, 0)
            holder["port"] = server.sockets[0].getsockname()[1]
            holder["loop"] = loop

        try:
            loop.run_until_complete(_boot())
        except OSError:
            logger.exception("gcs shard %d failed to bind; running without it", idx)
            ready.set()
            return
        ready.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    # --------------------------------------------------------------- serving

    async def _on_connection(self, reader, writer):
        from ray_tpu_torch._private.protocol import Connection

        conn = Connection(reader, writer)
        try:
            while not self._stopping:
                msg_type, rid, payload = await conn.read_frame()
                asyncio.get_running_loop().create_task(
                    self._handle(conn, msg_type, rid, payload)
                )
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            conn.close()

    async def _handle(self, conn, msg_type: int, rid: int, payload: dict):
        from ray_tpu_torch._private.protocol import MsgType

        try:
            if msg_type == MsgType.KV_PUT:
                result = await self._h_kv_put(payload)
            elif msg_type == MsgType.KV_GET:
                result = await self._h_kv_get(payload)
            elif msg_type == MsgType.KV_DEL:
                result = self._h_kv_del(payload)
            elif msg_type == MsgType.KV_KEYS:
                result = self._h_kv_keys(payload)
            elif msg_type == MsgType.KV_EXISTS:
                result = {"exists": payload["key"] in self.kv}
            elif msg_type == MsgType.WAIT_OBJECT:
                result = await self._h_wait_object(payload)
            elif msg_type == MsgType.GET_ACTOR:
                result = self._h_get_actor(payload)
            elif msg_type == MsgType.ACTOR_STATE:
                result = self._h_actor_state(payload)
            elif msg_type == MsgType.HEARTBEAT:
                result = {"ok": True}
            else:
                raise ValueError(f"message type {msg_type} is not shard-servable")
            if rid:
                await conn.reply(rid, result or {})
        except Exception as e:  # noqa: BLE001
            logger.exception("shard handler error for msg %s", msg_type)
            if rid:
                try:
                    await conn.reply(rid, {}, error=f"{type(e).__name__}: {e}")
                except Exception:  # graftlint: disable=silent-except -- error already logged; reply transport dead
                    pass

    # ------------------------------------------------------------------- KV

    async def _h_kv_put(self, p) -> dict:
        key = p["key"]
        added = self.kv.put_notify(key, p["value"], p.get("overwrite", True))
        if added:
            self._wal_cb("kv", key, p["value"])
            self._dirty_cb()
        return {"added": added}

    async def _h_kv_get(self, p) -> dict:
        from ray_tpu_torch._private.config import RayConfig

        key = p["key"]
        if p.get("wait") and key not in self.kv:
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

    def _h_kv_del(self, p) -> dict:
        n = 0
        if p.get("prefix"):
            for k in [k for k in self.kv.keys() if k.startswith(p["key"])]:
                if self.kv.pop(k, None) is not None:
                    self._wal_cb("kv", k, None)
                    n += 1
        elif self.kv.pop(p["key"], None) is not None:
            self._wal_cb("kv", p["key"], None)
            n = 1
        if n:
            self._dirty_cb()
        return {"deleted": n}

    def _h_kv_keys(self, p) -> dict:
        pref = p.get("prefix", "")
        keys = [k for k in self.kv.keys() if k.startswith(pref)]
        if p.get("values"):
            vals = {}
            for k in keys:
                v = self.kv.get(k)
                if v is not None:
                    vals[k] = v
            return {"keys": keys, "values": vals}
        return {"keys": keys}

    # --------------------------------------------------------------- objects

    async def _h_wait_object(self, p) -> dict:
        """Seal-state waits only: the batch form and the single form
        without a destination node.  Transfer-triggering waits (node_id
        set) are routed to the head by the client."""
        if "object_ids" in p:
            return await self._wait_batch(p)
        import time

        oid = bytes(p["object_id"])
        timeout = p.get("timeout")
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            st, err = self.objects.state(oid)
            if st == ERRORED:
                return {"state": "error", "error": err}
            if st == SEALED:
                return {"state": "sealed"}
            fut = self.objects.register_waiter(oid)
            if fut is None:
                continue  # sealed between check and register
            rem = None if deadline is None else max(0.001, deadline - time.time())
            try:
                await asyncio.wait_for(fut, rem)
            except asyncio.TimeoutError:
                return {"state": "timeout"}
            finally:
                self.objects.unregister_waiter(oid, fut)

    async def _wait_batch(self, p) -> dict:
        import time

        oids = [bytes(o) for o in p["object_ids"]]
        want = min(p.get("num_ready", len(oids)), len(oids))
        timeout = p.get("timeout")
        deadline = time.time() + timeout if timeout is not None else None
        registered: List[Tuple[bytes, asyncio.Future]] = []
        ev = asyncio.Event()
        state = {"done": 0}

        def _on_done(_f):
            state["done"] += 1
            ev.set()

        try:
            if deadline is None or time.time() < deadline:
                for o in oids:
                    fut = self.objects.register_waiter(o)
                    if fut is not None:
                        fut.add_done_callback(_on_done)
                        registered.append((o, fut))
                # exact ready count AT registration time: every oid that
                # declined a waiter is non-pending.  (A separate pre-count
                # plus counting declines again DOUBLE-counts ready oids —
                # the loop below then exits early and the caller turns the
                # short ready-set into a spurious GetTimeoutError.)
                n_ready = len(oids) - len(registered)
                while n_ready + state["done"] < want and state["done"] < len(registered):
                    if deadline is not None and time.time() >= deadline:
                        break
                    rem = None if deadline is None else max(0.001, deadline - time.time())
                    ev.clear()
                    try:
                        await asyncio.wait_for(ev.wait(), rem)
                    except asyncio.TimeoutError:
                        break
            return {
                "ready": [o for o in oids if self.objects.state(o)[0] != PENDING]
            }
        finally:
            for o, f in registered:
                if not f.done():
                    f.remove_done_callback(_on_done)
                    f.cancel()
                self.objects.unregister_waiter(o, f)

    # ---------------------------------------------------------------- actors

    def _h_get_actor(self, p) -> dict:
        info = self.actors.lookup(
            p.get("actor_id"), p.get("namespace", ""), p.get("name", "")
        )
        if info is None or info.get("creation_spec") is None:
            return {"found": False}
        return {
            "found": info.get("state") != "DEAD",
            "actor_id": info["actor_id"],
            "state": info.get("state", "UNKNOWN"),
            "creation_spec": info["creation_spec"],
            "direct_addr": info.get("direct_addr", ""),
        }

    def _h_actor_state(self, p) -> dict:
        info = self.actors.lookup(p.get("actor_id"), "", "")
        if info is None:
            return {"state": "UNKNOWN"}
        return {
            "state": info.get("state", "UNKNOWN"),
            "death_cause": info.get("death_cause", ""),
            "direct_addr": info.get("direct_addr", ""),
        }
