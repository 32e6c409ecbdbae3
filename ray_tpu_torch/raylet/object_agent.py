"""Cross-node object transfer agent: chunked pull over TCP.

The analog of the reference's ObjectManager (reference:
src/ray/object_manager/object_manager.h:128,137 HandlePush/HandlePull;
pull prioritization/throttling in pull_manager.h; 5 MiB chunks per
ray_config_def.h:314).  Design deltas for this runtime:

- pull-based only: the node that NEEDS an object dials the node that HAS
  it and streams the sealed store value byte-for-byte into a local
  unsealed allocation, then seals.  (The reference also pushes
  proactively; pull covers correctness, push is an optimization.)
- the head orchestrates: it owns the object directory (locations) and
  directs the destination raylet to pull — so the per-node agent stays a
  dumb data mover with no metadata of its own.
- in-flight dedup + a concurrency semaphore bound simultaneous pulls the
  way PullManager's num_chunks throttle does.

Wire protocol (one TCP connection per pull, no pickle):
  request:  28-byte object id
  response: <B found><Q size> header, then `size` raw bytes.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Dict, Optional

from ray_tpu_torch._private.chaos import Backoff
from ray_tpu_torch.core.shm_store import ShmObjectStore

_HDR = struct.Struct("<BQ")
CHUNK = 5 << 20  # 5 MiB, reference ray_config_def.h:314
OID_LEN = ShmObjectStore.ID_LEN


class ObjectTransferAgent:
    """Serves local sealed objects to peers and pulls remote ones in."""

    def __init__(self, store: ShmObjectStore, max_concurrent_pulls: int = 4):
        self.store = store
        self._server: Optional[asyncio.AbstractServer] = None
        self._pull_sem = asyncio.Semaphore(max_concurrent_pulls)
        self._inflight: Dict[bytes, asyncio.Future] = {}

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._serve, host, port)
        return self._server.sockets[0].getsockname()[1]

    def stop(self):
        if self._server is not None:
            self._server.close()
            self._server = None

    # ------------------------------------------------------------- serve side

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                oid = await reader.readexactly(OID_LEN)
                view = self.store.raw_view(oid)
                if view is None:
                    writer.write(_HDR.pack(0, 0))
                    await writer.drain()
                    continue
                try:
                    size = len(view)
                    writer.write(_HDR.pack(1, size))
                    for off in range(0, size, CHUNK):
                        # copy each chunk out of shm before handing it to the
                        # transport so the pin can be dropped deterministically
                        writer.write(bytes(view[off : off + CHUNK]))
                        await writer.drain()
                finally:
                    view.release()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except (OSError, RuntimeError):
                # transport already torn down; nothing to clean further
                pass

    # -------------------------------------------------------------- pull side

    async def pull(self, oid: bytes, src_addr: str) -> bool:
        """Fetch `oid` from the agent at src_addr ("host:port") into the
        local store.  Concurrent pulls of the same object coalesce."""
        if self.store.contains(oid):
            return True
        existing = self._inflight.get(oid)
        if existing is not None:
            return await asyncio.shield(existing)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[oid] = fut
        try:
            async with self._pull_sem:
                ok = await self._pull_once(oid, src_addr)
            fut.set_result(ok)
            return ok
        except BaseException as e:
            fut.set_exception(e)
            # consume so a lone waiterless failure doesn't warn
            fut.exception()
            raise
        finally:
            self._inflight.pop(oid, None)

    async def _pull_once(self, oid: bytes, src_addr: str) -> bool:
        host, port = src_addr.rsplit(":", 1)
        # bounded full-jitter dial retry (3 retries after the first dial):
        # a peer agent mid-restart answers a beat later; without this every
        # refused dial escalates to a full head-level pull round (or
        # lineage reconstruction)
        backoff = Backoff(base=0.05, cap=0.5, max_attempts=3)
        while True:
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
                break
            except OSError:
                delay = backoff.next_delay()
                if delay is None:
                    raise
                await asyncio.sleep(delay)
        try:
            writer.write(oid)
            await writer.drain()
            hdr = await reader.readexactly(_HDR.size)
            found, size = _HDR.unpack(hdr)
            if not found:
                return False
            # raw_create may trigger the spill hook (blocking disk writes):
            # run it off-loop so heartbeats/RPCs keep flowing mid-spill
            view = await asyncio.get_running_loop().run_in_executor(
                None, self.store.raw_create, oid, size
            )
            if view is None:
                return True  # raced another path; already present
            got = 0
            try:
                while got < size:
                    chunk = await reader.read(min(CHUNK, size - got))
                    if not chunk:
                        raise ConnectionError("transfer peer closed mid-object")
                    view[got : got + len(chunk)] = chunk
                    got += len(chunk)
            except BaseException:
                del view
                self.store.raw_abort(oid)
                raise
            del view
            self.store.raw_seal(oid)
            return True
        finally:
            try:
                writer.close()
            except (OSError, RuntimeError):
                # transport already torn down; pull outcome was decided above
                pass
