"""Python client for the native shared-memory object store.

Analog of the reference's plasma client (reference:
src/ray/object_manager/plasma/client.cc) but with direct segment mapping
instead of a unix-socket protocol: every process mmaps the same tmpfs file
and calls into ``libray_tpu_torch_store.so`` (src/object_store/store.cc) under a
process-shared robust mutex.  Sealed objects are immutable; ``get`` returns
zero-copy memoryviews into the mapping, pinned (refcounted) for as long as
any consumer view is alive via PEP-688 buffer-protocol exporters.

Object payload layout (one store object per framework object):
  u32 header_len | msgpack [metadata, inband_len, [buffer_lens]] |
  inband bytes | 64-pad | buffer0 | 64-pad | buffer1 | ...
"""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import struct
import sys
import time
import traceback
from typing import List, Optional

import msgpack

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.build_native import ensure_lib
from ray_tpu_torch._private.serialization import SerializedObject

_U32 = struct.Struct("<I")
_ALIGN = 64
# shared zero block for create_raw_sealed: full-length slices of bytes
# return the object itself, so only the final partial chunk ever copies
_ZERO_CHUNK = b"\x00" * (256 * 1024)


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _Lib:
    _instance = None

    @classmethod
    def get(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(ensure_lib("store"))
            lib.store_create.restype = ctypes.c_void_p
            lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.store_attach.restype = ctypes.c_void_p
            lib.store_attach.argtypes = [ctypes.c_char_p]
            lib.store_detach.argtypes = [ctypes.c_void_p]
            lib.store_alloc.restype = ctypes.c_int
            lib.store_alloc.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.store_alloc_opts.restype = ctypes.c_int
            lib.store_alloc_opts.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.store_evict_candidates.restype = ctypes.c_int
            lib.store_evict_candidates.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.store_seal.restype = ctypes.c_int
            lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.store_get.restype = ctypes.c_int
            lib.store_get.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.store_release.restype = ctypes.c_int
            lib.store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.store_release_process.restype = ctypes.c_int
            lib.store_release_process.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            for name in (
                "store_contains",
                "store_delete",
                "store_delete_if_unpinned",
                "store_abort",
            ):
                f = getattr(lib, name)
                f.restype = ctypes.c_int
                f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            for name in (
                "store_capacity",
                "store_used",
                "store_num_objects",
                "store_evictions",
                "store_mapped_size",
            ):
                f = getattr(lib, name)
                f.restype = ctypes.c_uint64
                f.argtypes = [ctypes.c_void_p]
            cls._instance = lib
        return cls._instance


def process_gone(pid: int) -> bool:
    """True once ``pid`` has exited (no such process, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True
    except OSError:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except OSError:
            pass
        return False


async def release_pins_when_gone(store: "ShmObjectStore", pid: int, wait_s: float = 10.0) -> int:
    """Drop the pins of a worker declared dead once its process is gone
    (a worker cut off while alive exits on its own): the number dropped, 0
    if it outlived ``wait_s``."""
    import asyncio

    deadline = time.monotonic() + wait_s
    while not process_gone(pid):
        if time.monotonic() >= deadline:
            return 0
        await asyncio.sleep(0.05)
    return store.release_process(pid)


# memoryview() only delegates to a Python-level __buffer__ from 3.12 on
# (PEP 688); before that, readers must fall back to copying under the pin
_MEMORYVIEW_DELEGATES = sys.version_info >= (3, 12)


class _PinnedRegion:
    """Buffer-protocol exporter that releases the store pin when collected.

    numpy arrays built over slices of ``memoryview(region)`` keep the region
    alive, so the pin (store refcount) outlives every zero-copy consumer —
    the moral equivalent of plasma's client-side release tracking
    (reference: plasma/client.cc Release).

    On Python < 3.12 ``memoryview(region)`` raises TypeError (PEP 688 is
    3.12+), so callers there read through ``region._view`` and COPY the
    bytes out while the region object — and therefore the pin — is still
    alive: correct on every version, zero-copy where the interpreter
    allows it.
    """

    def __init__(self, store: "ShmObjectStore", oid: bytes, offset: int, view: memoryview):
        self._store = store
        self._oid = oid
        self._offset = offset  # names the pinned block (store_release)
        self._view = view

    def __buffer__(self, flags):
        return self._view.__buffer__(flags)

    def __del__(self):
        try:
            self._store.release(self._oid, self._offset)
        except Exception:  # graftlint: disable=silent-except -- interpreter-teardown __del__; the segment may already be unmapped
            pass


class StoreFullError(MemoryError):
    """Allocation failed without eviction; the caller's spill hook (if any)
    should make room and retry."""


class ShmObjectStore:
    """One per process; head creates the segment, workers attach."""

    def __init__(self, path: str, capacity: int = 0, create: bool = False, nslots: int = 65536):
        self._lib = _Lib.get()
        self._path = path
        # optional hook: called with (bytes_needed) under memory pressure;
        # returns True if room was made (spill-to-disk orchestration —
        # reference analog: LocalObjectManager::SpillObjects triggered
        # before eviction of referenced data, raylet/local_object_manager.h)
        self.spill_hook = None
        # optional (event_type, payload) callback for cluster-event
        # reporting (wired by the raylet to the head's event ring)
        self.event_hook = None
        self._last_pressure_report = float("-inf")
        if create:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._handle = self._lib.store_create(path.encode(), capacity, nslots)
        else:
            self._handle = self._lib.store_attach(path.encode())
        if not self._handle:
            raise OSError(f"cannot {'create' if create else 'attach'} shm store at {path}")
        size = self._lib.store_mapped_size(self._handle)
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mv = memoryview(self._mm)

    ID_LEN = 28  # must match kIdLen in src/object_store/store.cc

    def _check(self, object_id: bytes):
        if self._handle is None:
            raise OSError("shm store is closed")
        if len(object_id) != self.ID_LEN:
            raise ValueError(f"object id must be {self.ID_LEN} bytes, got {len(object_id)}")

    # -- framework-object API -------------------------------------------------

    def put_serialized(self, object_id: bytes, obj: SerializedObject) -> bool:
        """Write + seal. Returns False if the object already exists."""
        self._check(object_id)
        header = msgpack.packb(
            [obj.metadata, len(obj.inband), [b.nbytes for b in obj.buffers]],
            use_bin_type=True,
        )
        prefix = _U32.size + len(header) + len(obj.inband)
        total = _pad(prefix)
        for b in obj.buffers:
            total += _pad(b.nbytes)
        off = ctypes.c_uint64()
        rc = self._alloc_with_spill(object_id, total, ctypes.byref(off))
        if rc == -1:
            return False
        if rc != 0:
            raise MemoryError(
                f"shm store cannot fit object of {total} bytes "
                f"(used {self.used()}/{self.capacity()})"
            )
        base = off.value
        try:
            view = self._mv[base : base + total]
            pos = 0
            view[pos : pos + _U32.size] = _U32.pack(len(header))
            pos += _U32.size
            view[pos : pos + len(header)] = header
            pos += len(header)
            if obj.inband:
                view[pos : pos + len(obj.inband)] = obj.inband
            pos = _pad(pos + len(obj.inband))
            for b in obj.buffers:
                if b.nbytes:
                    if b.format == "B" and b.ndim == 1:
                        flat = b
                    else:
                        try:
                            flat = b.cast("B")  # zero-copy for contiguous views
                        except TypeError:
                            flat = memoryview(bytes(b))
                    view[pos : pos + b.nbytes] = flat
                pos = _pad(pos + b.nbytes)
            del view
        except BaseException:
            # roll back the unsealed allocation so the id isn't wedged forever
            self._lib.store_abort(self._handle, object_id)
            raise
        if self._lib.store_seal(self._handle, object_id) != 0:
            # the only way an ALLOCATED slot stops being sealable is a
            # concurrent store_delete (an unsealed object is freed at once,
            # creator pin or not): the owner's last reference died while we were
            # writing, so the value is unreachable by contract — degrade
            # to a no-op rather than failing the producing task (seen as
            # actor creations poisoned by their own dropped creation ref)
            self._lib.store_abort(self._handle, object_id)
            return False
        return True

    def get_serialized(self, object_id: bytes) -> Optional[SerializedObject]:
        """Zero-copy read of a sealed object; None if absent/unsealed."""
        self._check(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, object_id, ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        region = _PinnedRegion(self, object_id, off.value, self._mv[off.value : off.value + size.value])
        if _MEMORYVIEW_DELEGATES:
            view = memoryview(region)  # slices keep `region` (the pin) alive
            copy_out = False
        else:
            view = region._view  # `region` local holds the pin while we read
            copy_out = True
        (hlen,) = _U32.unpack(view[: _U32.size])
        pos = _U32.size
        metadata, inband_len, buf_lens = msgpack.unpackb(
            bytes(view[pos : pos + hlen]), raw=False
        )
        pos += hlen
        inband = bytes(view[pos : pos + inband_len])
        pos = _pad(pos + inband_len)
        buffers: List[memoryview] = []
        for blen in buf_lens:
            chunk = view[pos : pos + blen]
            buffers.append(memoryview(bytes(chunk)) if copy_out else chunk)
            pos = _pad(pos + blen)
        sobj = SerializedObject(bytes(metadata), inband, buffers)
        if copy_out:
            # pre-3.12 buffers are copies, but the pin contract must not be
            # version-dependent: a live get_serialized() result keeps the
            # object evict-exempt either way (test_pinned_not_evicted)
            sobj._pin = region
        return sobj

    def metadata_of(self, object_id: bytes) -> Optional[bytes]:
        """Metadata tag of a sealed object without materializing inband or
        buffers — a cheap tier probe (e.g. META_DEVICE envelopes written by
        the device-store eviction ladder, core/DEVICE_TIER.md).  None if
        absent/unsealed."""
        self._check(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, object_id, ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        try:
            view = self._mv[off.value : off.value + size.value]
            (hlen,) = _U32.unpack(view[: _U32.size])
            metadata, _, _ = msgpack.unpackb(
                bytes(view[_U32.size : _U32.size + hlen]), raw=False
            )
            return bytes(metadata)
        finally:
            self._lib.store_release(self._handle, object_id, off.value)

    # -- raw ops (object-transfer layer) --------------------------------------

    def raw_view(self, object_id: bytes) -> Optional[memoryview]:
        """Pinned zero-copy view of a sealed object's full store value (the
        serialized wire image).  The pin is released when the view's owner
        (_PinnedRegion) is garbage collected.  Used by the transfer agent to
        stream an object to another node byte-for-byte."""
        self._check(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, object_id, ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        region = _PinnedRegion(self, object_id, off.value, self._mv[off.value : off.value + size.value])
        if _MEMORYVIEW_DELEGATES:
            return memoryview(region)
        # pre-3.12: copy the wire image out under the pin (`region` lives
        # until after bytes() completes), then let the pin drop
        return memoryview(bytes(region._view))

    def raw_create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Allocate an unsealed object of `size` bytes and return a writable
        view; None if the id already exists.  Pair with raw_seal/raw_abort.
        This is the receive half of a chunked pull (analog: reference
        ObjectBufferPool create-chunk path, object_manager/object_buffer_pool.h)."""
        self._check(object_id)
        off = ctypes.c_uint64()
        rc = self._alloc_with_spill(object_id, size, ctypes.byref(off))
        if rc == -1:
            return None
        if rc != 0:
            raise MemoryError(
                f"shm store cannot fit object of {size} bytes "
                f"(used {self.used()}/{self.capacity()})"
            )
        return self._mv[off.value : off.value + size]

    def _alloc_with_spill(self, object_id: bytes, size: int, off_ref) -> int:
        """Allocate, preferring spill-to-disk over LRU eviction when a
        spill hook is wired: in-scope objects must not be silently dropped
        to make room (they'd need lineage reconstruction to come back)."""
        if self.spill_hook is None:
            return self._lib.store_alloc(self._handle, object_id, size, off_ref)
        if size + _ALIGN > self.capacity():
            # can never fit even after padding: fail without churning the
            # working set to disk
            return -2
        for _ in range(3):
            rc = self._lib.store_alloc_opts(self._handle, object_id, size, 0, off_ref)
            if rc != -2:
                return rc
            try:
                made_room = self.spill_hook(size)
            except Exception:  # noqa: BLE001
                # a broken spill hook must not fail the alloc (the evicting
                # fallback below still runs) — but it must not be invisible
                traceback.print_exc(file=sys.stderr)
                made_room = False
            if not made_room:
                break
        # last resort: evicting alloc (out-of-scope data goes first by LRU).
        # This is the outcome spill-before-evict exists to prevent — loudly
        # record that in-scope objects may now be LRU-dropped (a put()
        # object without lineage lost here is unrecoverable), so a slow or
        # full spill disk under sustained pressure is diagnosable.  Rate-
        # limited: sustained pressure means this path fires per-alloc, and
        # an unthrottled warning+event per alloc would flood the log and
        # the head's event ring with the very condition being reported.
        import time as _time

        now = _time.monotonic()
        if now - self._last_pressure_report > 10.0:
            self._last_pressure_report = now
            logger.warning(
                "shm store: spill could not make room for %d bytes after 3 "
                "rounds (used %d/%d); falling back to LRU eviction — in-scope "
                "objects without lineage may be lost",
                size,
                self.used(),
                self.capacity(),
            )
            if self.event_hook is not None:
                try:
                    self.event_hook(
                        "OBJECT_STORE_EVICTING_FALLBACK",
                        {
                            "requested": size,
                            "used": self.used(),
                            "capacity": self.capacity(),
                        },
                    )
                except Exception:  # graftlint: disable=silent-except -- pressure-event emission is best-effort; the alloc itself must proceed
                    pass
        return self._lib.store_alloc(self._handle, object_id, size, off_ref)

    def evict_candidates(self, max_n: int = 64) -> List[tuple]:
        """LRU-first (object_id, size) pairs that are sealed and unpinned —
        what a spill pass would move to disk."""
        if not self._handle:
            return []
        ids = ctypes.create_string_buffer(max_n * self.ID_LEN)
        sizes = (ctypes.c_uint64 * max_n)()
        n = self._lib.store_evict_candidates(self._handle, max_n, ids, sizes)
        out = []
        for i in range(max(0, n)):
            out.append((ids.raw[i * self.ID_LEN : (i + 1) * self.ID_LEN], int(sizes[i])))
        return out

    def create_raw_sealed(self, object_id: bytes, size: int, init: bytes = b"") -> bool:
        """Allocate a zero-initialized `size`-byte object, write ``init`` at
        offset 0, and seal it in one step — the backing region for a
        compiled-DAG channel ring (dag/channel.py), which both endpoints
        mutate in place through pinned views for the channel's lifetime.
        ``init`` lands BEFORE the seal, so a peer that attaches the moment
        the object becomes visible can never observe a half-initialized
        header.  The pins the endpoints take keep the region off the LRU.
        Returns False if the id already exists."""
        view = self.raw_create(object_id, size)
        if view is None:
            return False
        # zero in bounded chunks: one `b"\x00" * size` temporary would
        # transiently double a multi-MB ring's footprint per channel
        off = 0
        while off < size:
            n = min(size - off, len(_ZERO_CHUNK))
            view[off : off + n] = _ZERO_CHUNK[:n]
            off += n
        if init:
            view[: len(init)] = init
        self.raw_seal(object_id)
        return True

    def pinned_view(self, object_id: bytes):
        """Writable zero-copy view of a sealed object plus the pin holder:
        ``(view, region)`` or None if absent.  The caller must keep
        ``region`` alive for as long as it touches ``view`` — dropping the
        last reference releases the store pin (on every Python version;
        this bypasses the PEP-688 read path, so pre-3.12 gets zero-copy
        too).  Mutating the view is only sound for regions whose layout is
        owned by cooperating endpoints (DAG channel rings) — sealed data
        objects stay immutable by contract."""
        self._check(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, object_id, ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        region = _PinnedRegion(self, object_id, off.value, self._mv[off.value : off.value + size.value])
        return region._view, region

    def raw_seal(self, object_id: bytes):
        if self._lib.store_seal(self._handle, object_id) != 0:
            self._lib.store_abort(self._handle, object_id)
            raise RuntimeError("seal failed")

    def raw_abort(self, object_id: bytes):
        self._lib.store_abort(self._handle, object_id)

    def contains(self, object_id: bytes) -> bool:
        if not self._handle:
            return False
        return bool(self._lib.store_contains(self._handle, object_id))

    def release(self, object_id: bytes, offset: int):
        """Drop one pin that a get at ``offset`` took."""
        if self._handle:
            self._lib.store_release(self._handle, object_id, offset)

    def release_process(self, pid: int) -> int:
        """Drop every pin that the dead process ``pid`` held, freeing each
        delete-pending block whose last pin goes (plasma drops a client's
        pins when it disconnects); the number of pins dropped.  Only for a
        process known dead: a live one's views would lose their blocks."""
        return self._lib.store_release_process(self._handle, pid) if self._handle else 0

    def delete(self, object_id: bytes):
        """The owner-driven free: a sealed object that a reader still pins
        is freed by that reader's last release (store.cc, store_delete)."""
        if self._handle:
            self._lib.store_delete(self._handle, object_id)

    def delete_if_unpinned(self, object_id: bytes) -> bool:
        """Delete unless a reader pins it (spill path safety); True if the
        shm copy is gone."""
        if not self._handle:
            return False
        return self._lib.store_delete_if_unpinned(self._handle, object_id) == 0

    def capacity(self) -> int:
        return self._lib.store_capacity(self._handle) if self._handle else 0

    def used(self) -> int:
        return self._lib.store_used(self._handle) if self._handle else 0

    def num_objects(self) -> int:
        return self._lib.store_num_objects(self._handle) if self._handle else 0

    def evictions(self) -> int:
        return self._lib.store_evictions(self._handle) if self._handle else 0

    def close(self):
        """Detach.  If zero-copy views are still alive we must NOT unmap the
        segment under them — leave the mapping to the process teardown."""
        if self._handle:
            handle, self._handle = self._handle, None
            try:
                self._mv.release()
                self._mm.close()
            except BufferError:
                # outstanding exported views: skip munmap, only free the
                # client bookkeeping at exit (the OS reclaims the mapping)
                return
            self._lib.store_detach(handle)
