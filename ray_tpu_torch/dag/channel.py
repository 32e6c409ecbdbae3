"""Pre-wired SPSC channels for compiled actor DAGs.

One channel per dataflow edge, wired once at ``dag.compile()`` and reused
every step — the per-call dispatch tax (submit → head_enqueue → dispatch →
dequeue) is gone from the hot loop.  A channel is:

- a **shm ring** (co-located endpoint pairs): a ring of reusable slots in
  the node's shared-memory store, created lazily by the producer on its
  first write and attached by the consumer.  EVERY co-located step rides
  the ring — no per-step TCP frame at all: the consumer spin-then-sleep
  waits on the ring header's write cursor, so a hot producer→consumer
  handoff costs microseconds instead of a socket round-trip plus three
  thread wakeups.  A payload too big for the slot leaves a zero-length
  overflow sentinel in its slot (keeping the seq stream contiguous) and
  ships inline on the carrier conn.
- a **carrier connection**: the persistent direct-call TCP conn between
  the two endpoint processes.  Cross-node channels inline every payload
  here (one ``DAG_PUSH`` frame per step); co-located channels use it only
  for overflow payloads, the ring-unusable fallback (store pressure), and
  control traffic (teardown stop, fault notification).

Ordering and visibility: slot bytes are written strictly before the
header's write-cursor bump, and x86 store ordering plus the GIL's
per-process serialization make the cursor bump the publication point —
the consumer never observes a half-written slot.  The ring's read cursor
lives in the shared header so a full ring back-pressures the writer
without ack frames.

Transport faults never retransmit: a severed carrier, a dead ring, or a
sequence gap on the inline path (chaos drop/dup) breaks the channel,
which invalidates the compiled graph at the driver (re-compile-or-fail —
the JAX package's dag/DESIGN.md).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import queue
import struct
import time
from typing import Any, Optional, Tuple

import msgpack

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.protocol import MsgType
from ray_tpu_torch._private.serialization import SerializedObject


class ChannelBrokenError(ConnectionError):
    """Transport-level channel failure (severed conn, seq gap, dead ring):
    the compiled graph owning this channel is no longer executable."""


class ChannelClosedError(Exception):
    """Orderly teardown sentinel consumed by the executor loop."""


def ring_oid(chan_key: str) -> bytes:
    """Deterministic 28-byte store id for a channel's shm ring — both
    endpoints derive it, so the doorbell never has to carry it."""
    return hashlib.sha256(b"dag-ring:" + chan_key.encode()).digest()[:28]


def encode_value(value: Any) -> Tuple[list, int]:
    """Serialize once per step; returns (wire form, payload bytes).  The
    same wire is fanned out to every consumer channel."""
    sobj = serialization.serialize(value)
    return sobj.to_wire(), sobj.total_bytes()


def decode_wire(wire: list) -> Any:
    return serialization.deserialize(SerializedObject.from_wire(wire))


class ShmRing:
    """Reusable slot ring inside one sealed store object.

    Layout: 64-byte header ``<QQII`` (write_seq, read_seq, nslots,
    slot_size) then ``nslots`` slots of ``u32 len | payload``.  Single
    producer, single consumer; the doorbell frame on the carrier conn is
    the only cross-process notification.
    """

    HEADER = 64
    _HDR = struct.Struct("<QQII")
    _LEN = struct.Struct("<I")

    def __init__(self, store, oid: bytes, view, region, nslots: int, slot_size: int):
        self._store = store
        self._oid = oid
        self._view = view
        self._region = region  # the pin: keeps the ring mapped + un-evicted
        self.nslots = nslots
        self.slot_size = slot_size

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, store, chan_key: str, slot_size: int, nslots: int) -> Optional["ShmRing"]:
        oid = ring_oid(chan_key)
        size = cls.HEADER + nslots * (cls._LEN.size + slot_size)
        # the header ships inside the sealed create: a consumer that
        # attaches the instant the object appears reads valid geometry
        hdr = cls._HDR.pack(0, 0, nslots, slot_size)
        if not store.create_raw_sealed(oid, size, init=hdr):
            # stale ring from a crashed prior compile of the same key:
            # reclaim it if nothing pins it, else give up (inline fallback)
            if not store.delete_if_unpinned(oid):
                return None
            if not store.create_raw_sealed(oid, size, init=hdr):
                return None
        got = store.pinned_view(oid)
        if got is None:
            return None
        view, region = got
        return cls(store, oid, view, region, nslots, slot_size)

    def close(self):
        """Drop the pin and try to delete the backing object.  BOTH
        endpoints attempt the delete: it only succeeds once the other
        side's pin is gone, so whichever endpoint closes last reclaims the
        segment regardless of teardown order (DAG_TEARDOWN releases the
        worker ends before the driver's — creator-only deletion would
        strand every driver-read output ring)."""
        self._view = None
        self._region = None  # releases the store pin (refcount-deterministic)
        try:
            self._store.delete_if_unpinned(self._oid)
        except OSError:
            pass  # store already closed at process teardown

    # -- data path ---------------------------------------------------------

    def _seqs(self) -> Tuple[int, int]:
        w, r, _, _ = self._HDR.unpack_from(self._view, 0)
        return w, r

    def _slot_off(self, seq: int) -> int:
        return self.HEADER + (seq % self.nslots) * (self._LEN.size + self.slot_size)

    def fits(self, nbytes: int) -> bool:
        return self._view is not None and nbytes <= self.slot_size

    def write_slot(self, seq: int, blob: bytes, timeout: float = 30.0) -> None:
        """Write blob (may be the b'' overflow sentinel) into slot
        ``seq % nslots`` and publish it by bumping write_seq.  Blocks while
        the ring is full — the reader's cursor in the shared header is the
        back-pressure signal, no ack frames."""
        if self._view is None:
            raise ChannelBrokenError("shm ring closed")
        deadline = time.monotonic() + timeout
        while True:
            _w, r = self._seqs()
            if seq - r < self.nslots:
                break
            if time.monotonic() >= deadline:
                raise ChannelBrokenError(
                    f"shm ring full for {timeout:.0f}s: consumer stalled or dead"
                )
            time.sleep(0.0002)
        self._publish(seq, blob)

    def write_slot_nowait(self, seq: int, blob: bytes) -> None:
        """Publish into a slot the caller just confirmed free via
        ``can_accept(seq)``.  The reader cursor only ever advances, so room
        cannot vanish between the check and the write — this path never
        waits, which is what lets the serve engine call it from its io
        loop (graftsan GS001: ``write_slot`` proper parks in a back-
        pressure sleep)."""
        if self._view is None:
            raise ChannelBrokenError("shm ring closed")
        self._publish(seq, blob)

    def _publish(self, seq: int, blob: bytes) -> None:
        off = self._slot_off(seq)
        self._LEN.pack_into(self._view, off, len(blob))
        start = off + self._LEN.size
        self._view[start : start + len(blob)] = blob
        struct.pack_into("<Q", self._view, 0, seq + 1)  # write_seq: publish

    def can_accept(self, seq: int) -> bool:
        """Room for slot ``seq`` right now?  Non-blocking capacity probe
        for producers that must not stall on a slow consumer (the serve
        engine's token fan-out uses it via ChannelWriter.try_write)."""
        if self._view is None:
            raise ChannelBrokenError("shm ring closed")
        _w, r = self._seqs()
        return seq - r < self.nslots

    def available(self, seq: int) -> bool:
        """Has the producer published slot ``seq`` yet?  The consumer's
        spin-wait polls this — one struct unpack of shared memory."""
        if self._view is None:
            raise ChannelBrokenError("shm ring closed")
        (w,) = struct.unpack_from("<Q", self._view, 0)
        return w > seq

    def read(self, seq: int) -> bytes:
        """Copy slot ``seq`` out (the slot is reused after the cursor bump,
        so the payload must not alias ring memory) and advance read_seq."""
        if self._view is None:
            raise ChannelBrokenError("shm ring closed")
        off = self._slot_off(seq)
        (n,) = self._LEN.unpack_from(self._view, off)
        start = off + self._LEN.size
        blob = bytes(self._view[start : start + n])
        struct.pack_into("<Q", self._view, 8, seq + 1)  # read_seq
        return blob


class ChannelWriter:
    """Producer endpoint.  ``write`` is called from exactly one thread (the
    node's executor loop, or the driver's execute thread); the actual send
    is spawned onto the owning process's io loop WITHOUT waiting for the
    socket flush — the hot loop never pays a cross-thread round-trip per
    frame.  Ordering holds because run_coroutine_threadsafe schedules
    FIFO and sends on one conn serialize on its write lock in scheduling
    order.  A transport failure is captured into ``broken`` by the done
    callback and raised at the NEXT write on this channel; the blocked
    output read (or the carrier-conn monitoring) surfaces the fault for
    the step that caused it."""

    def __init__(
        self,
        key: str,
        io,
        conn,
        store=None,
        co_located: bool = False,
        owns_conn: bool = False,
    ):
        self.key = key
        self._io = io
        self._conn = conn
        self._store = store
        self._co_located = co_located
        self._owns_conn = owns_conn
        self._ring: Optional[ShmRing] = None
        self._ring_unusable = False
        self._last_send = None
        self.broken: Optional[str] = None

    def write(self, seq: int, wire: list, nbytes: int, err: bool = False) -> None:
        if self.broken is not None:
            raise ChannelBrokenError(f"channel {self.key}: {self.broken}")
        if self._co_located and self._store is not None:
            blob = msgpack.packb([err, wire], use_bin_type=True)
            ring = self._ensure_ring(len(blob))
            if ring is not None:
                if ring.fits(len(blob)):
                    ring.write_slot(seq, blob)
                    return  # no doorbell: the reader spins on the header
                # oversized for the slot: sentinel keeps the seq stream
                # contiguous in the ring, payload rides the carrier below
                ring.write_slot(seq, b"")
        self._send_inline(seq, wire, err)

    def try_write(self, seq: int, wire: list, nbytes: int, err: bool = False) -> bool:
        """Non-blocking ``write``: False when the co-located ring has no
        room for ``seq`` (the consumer is behind) instead of blocking the
        producer — a multi-stream producer (the serve engine's token
        fan-out) retries the stalled stream next iteration rather than
        head-of-line-blocking every other stream on one slow consumer.
        The inline/cross-node path always accepts (its buffer is the io
        queue); raises ChannelBrokenError exactly like ``write``."""
        if self.broken is not None:
            raise ChannelBrokenError(f"channel {self.key}: {self.broken}")
        if self._co_located and self._store is not None:
            blob = msgpack.packb([err, wire], use_bin_type=True)
            ring = self._ensure_ring(len(blob))
            if ring is not None:
                if not ring.can_accept(seq):
                    return False
                if ring.fits(len(blob)):
                    ring.write_slot_nowait(seq, blob)
                    return True
                ring.write_slot_nowait(seq, b"")
        self._send_inline(seq, wire, err)
        return True

    def _send_inline(self, seq: int, wire: list, err: bool) -> None:
        payload = {"c": self.key, "s": seq, "e": err, "v": wire}
        try:
            fut = self._io.spawn(self._conn.send(MsgType.DAG_PUSH, payload))
        except RuntimeError as e:  # io loop shut down under us
            self.broken = f"{type(e).__name__}: {e}"
            raise ChannelBrokenError(f"channel {self.key}: {self.broken}") from e
        self._last_send = fut
        fut.add_done_callback(self._on_send_done)

    def _on_send_done(self, fut) -> None:
        """io-loop callback: capture a failed send so the next write on
        this channel raises instead of silently desyncing the stream."""
        try:
            exc = fut.exception()
        except BaseException:  # noqa: BLE001 -- cancelled during teardown
            exc = None
        if exc is not None and self.broken is None:
            self.broken = f"{type(exc).__name__}: {exc}"

    def _ensure_ring(self, blob_len: int) -> Optional[ShmRing]:
        if self._ring is not None or self._ring_unusable:
            return self._ring
        slot = max(2 * blob_len, RayConfig.dag_ring_slot_min_bytes)
        try:
            self._ring = ShmRing.create(
                self._store, self.key, slot, RayConfig.dag_channel_slots
            )
        except (MemoryError, OSError, RuntimeError):
            self._ring = None
        if self._ring is None:
            # store pressure / stale pin: this channel inlines from now on
            self._ring_unusable = True
        return self._ring

    def close(self):
        fut = self._last_send
        self._last_send = None
        if fut is not None and not fut.done():
            # drain the in-flight frame so orderly teardown never truncates
            # the stream — but never from the io loop itself (setup-failure
            # unwind runs there; blocking it would deadlock the send)
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                try:
                    fut.result(timeout=5)
                except (
                    ConnectionError,
                    OSError,
                    TimeoutError,
                    # distinct from builtin TimeoutError until 3.11: a
                    # stalled drain must not abort the rest of teardown
                    concurrent.futures.TimeoutError,
                ):
                    pass  # peer already gone; teardown proceeds
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        if self._owns_conn and self._conn is not None:
            conn = self._conn
            self._conn = None
            # transport teardown belongs on the loop that owns the socket
            self._io.loop.call_soon_threadsafe(conn.close)


class ChannelReader:
    """Consumer endpoint.

    Co-located channels (``co_located=True``) wait on the shm ring's
    write cursor with a spin-then-sleep loop — the hot handoff costs
    microseconds, and the control queue (stop / fault / overflow inline
    frames) is polled each iteration so teardown and invalidation still
    interrupt a blocked reader promptly.  Cross-node channels block on
    the queue the io thread feeds (``push`` is O(1) and never blocks the
    loop); slot copy-out and deserialization always happen on the
    consumer's thread in ``get``."""

    _STOP = {"__stop__": True}
    # yield-spin this long before degrading to timed naps.  The spin
    # iterations call sleep(0) — a sched_yield, not a busy burn — so on a
    # core-starved box the waiting stages hand their CPU to whichever
    # stage is actually executing instead of stealing cycles from it; an
    # actively-pumping pipeline still lands each handoff within the
    # window at microsecond latency.  Naps escalate geometrically toward
    # _NAP_MAX_S so a graph left resident but idle (compile once, execute
    # for hours) costs ~500 wakeups/s per edge instead of 5k, while the
    # first hot handoff after an idle stretch still lands within 2ms.
    _SPIN_S = 0.002
    _NAP_S = 0.0002
    _NAP_MAX_S = 0.002

    def __init__(self, key: str, store=None, co_located: bool = False):
        self.key = key
        self._store = store
        self._co = bool(co_located) and store is not None
        self._q: "queue.Queue[dict]" = queue.Queue()
        self._ring: Optional[ShmRing] = None
        self._inline_only = False  # writer's ring creation failed: stop probing
        self._expected = 0

    def push(self, payload: dict) -> None:
        self._q.put(payload)

    def occupancy(self) -> Optional[Tuple[int, int]]:
        """(unconsumed steps, slot capacity) for a ring-backed channel —
        one header unpack of shared memory, sampled by the executor's
        DAG_STEP flush for the head's memory accounting.  None for
        inline/cross-node channels (their depth is the io queue's)."""
        ring = self._ring
        if ring is None or ring._view is None:
            return None
        try:
            w, r = ring._seqs()
        except (ChannelBrokenError, struct.error):
            return None
        return max(0, w - r), ring.nslots

    def wake_broken(self, reason: str) -> None:
        self._q.put({"__broken__": reason})

    def stop(self) -> None:
        self._q.put(self._STOP)

    def get(self, timeout: Optional[float] = None) -> Tuple[bool, Any]:
        """Block for the next step's (is_error, value).  Raises
        ChannelClosedError on orderly stop, ChannelBrokenError on
        transport failure or a sequence gap, TimeoutError on timeout."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        if self._co:
            return self._get_ring(deadline, timeout)
        return self._get_inline(deadline, timeout)

    # -- co-located: ring first, queue for control/overflow ---------------

    def _get_ring(self, deadline, timeout) -> Tuple[bool, Any]:
        seq = self._expected
        spin_until = time.monotonic() + self._SPIN_S
        nap = self._NAP_S
        while True:
            ring = self._ring
            if ring is None and not self._inline_only:
                ring = self._try_attach()
            if ring is not None and ring.available(seq):
                blob = ring.read(seq)
                self._expected += 1
                if not blob:
                    # overflow sentinel: the payload rides the carrier conn
                    return self._decode(self._next_inline(deadline, timeout), seq)
                err, wire = msgpack.unpackb(blob, raw=False)
                return bool(err), decode_wire(wire)
            try:
                payload = self._q.get_nowait()
            except queue.Empty:
                payload = None
            if payload is not None:
                # control frame, or a data frame from a ring-less writer
                # (ring creation failed under store pressure — permanent,
                # so stop paying the per-iteration store lookup above)
                self._raise_control(payload)
                if ring is None:
                    self._inline_only = True
                out = self._decode(payload, seq)
                self._expected += 1
                return out
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise TimeoutError(
                    f"channel {self.key}: no message within {timeout}s"
                ) from None
            if now < spin_until:
                time.sleep(0.0)
            else:
                time.sleep(nap)
                nap = min(nap * 1.5, self._NAP_MAX_S)

    def _try_attach(self) -> Optional[ShmRing]:
        got = self._store.pinned_view(ring_oid(self.key))
        if got is None:
            return None  # producer hasn't created it (yet, or ever)
        view, region = got
        _w, _r, nslots, slot_size = ShmRing._HDR.unpack_from(view, 0)
        if nslots == 0:
            return None  # impossible post-seal, but never cache bad geometry
        self._ring = ShmRing(
            self._store, ring_oid(self.key), view, region, nslots, slot_size
        )
        return self._ring

    # -- inline path: the io thread's queue is the stream -----------------

    def _get_inline(self, deadline, timeout) -> Tuple[bool, Any]:
        payload = self._next_inline(deadline, timeout)
        seq = self._expected
        self._expected += 1
        return self._decode(payload, seq)

    def _next_inline(self, deadline, timeout) -> dict:
        rem = None if deadline is None else max(0.0, deadline - time.monotonic())
        try:
            payload = self._q.get(timeout=rem)
        except queue.Empty:
            raise TimeoutError(f"channel {self.key}: no message within {timeout}s") from None
        self._raise_control(payload)
        return payload

    def _raise_control(self, payload: dict) -> None:
        if payload.get("__stop__"):
            raise ChannelClosedError(self.key)
        if "__broken__" in payload:
            raise ChannelBrokenError(f"channel {self.key}: {payload['__broken__']}")

    def _decode(self, payload: dict, expect_seq: int) -> Tuple[bool, Any]:
        seq = int(payload.get("s", -1))
        if seq != expect_seq:
            # no retransmit protocol: a gap or duplicate (chaos drop/dup)
            # means the stream can never realign — fail loudly
            raise ChannelBrokenError(
                f"channel {self.key}: sequence gap (expected {expect_seq}, got {seq})"
            )
        return bool(payload.get("e")), decode_wire(payload["v"])

    def close(self):
        if self._ring is not None:
            self._ring.close()
            self._ring = None
