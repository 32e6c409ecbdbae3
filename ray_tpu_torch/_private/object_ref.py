"""User-facing ObjectRef handle.

Analog of the reference's ObjectRef (reference: python/ray/_raylet.pyx
ObjectRef cdef class + python/ray/includes/object_ref.pxi): a handle to a
future value in the object store.  Deleting the last handle in the owning
process releases the reference at the head (distributed refcounting, the
moral of reference src/ray/core_worker/reference_count.cc — ours is
owner-centralized rather than borrower-chained in round 1).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    """Handle to an object in the store; resolved with ``ray_tpu_torch.get``."""

    __slots__ = ("_id", "_owner", "__weakref__")

    def __init__(self, id_bytes: bytes, owner=None, skip_adding_local_ref: bool = False):
        if isinstance(id_bytes, ObjectID):
            id_bytes = id_bytes.binary()
        self._id = id_bytes
        self._owner = owner
        if owner is not None and not skip_adding_local_ref:
            owner._add_local_ref(id_bytes)

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def object_id(self) -> ObjectID:
        return ObjectID(self._id)

    def task_id(self):
        return ObjectID(self._id).task_id()

    def future(self):
        """A concurrent.futures.Future resolving to the value (or raising)."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            import ray_tpu_torch

            try:
                fut.set_result(ray_tpu_torch.get(self))
            except BaseException as e:  # graftlint: disable=silent-except -- error delivered to the future's consumer via set_exception
                fut.set_exception(e)

        import threading

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __await__(self):
        """Allow ``await ref`` inside async actors."""
        return self._await_impl().__await__()

    async def _await_impl(self):
        import asyncio
        import functools

        import ray_tpu_torch

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, functools.partial(ray_tpu_torch.get, self))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]}…)"

    def __reduce__(self):
        # Crossing a process boundary: report the id to the active serialize()
        # capture so the shipping control message pins it at the head until
        # the receiver registers its own ref (borrower protocol; reference
        # analog: reference_count.cc WrapObjectIds / borrower bookkeeping).
        from ray_tpu_torch._private.serialization import record_contained_ref

        record_contained_ref(self._id)
        return (_rebuild_ref, (self._id,))

    def __del__(self):
        owner = self._owner
        if owner is not None:
            try:
                owner._remove_local_ref(self._id)
            except Exception:  # graftlint: disable=silent-except -- interpreter-teardown __del__; the worker may already be disconnected
                pass


def _rebuild_ref(id_bytes: bytes) -> "ObjectRef":
    # Deserialized inside a worker/driver: attach to the live core worker so
    # the ref participates in local refcounting there.
    owner = None
    try:
        from ray_tpu_torch._private import worker as _w

        owner = _w.global_worker.core_worker if _w.global_worker.connected else None
    except Exception:  # graftlint: disable=silent-except -- no live worker in this process: the ref deserializes detached, by design
        owner = None
    if owner is not None:
        owner._add_local_ref(id_bytes)
        return ObjectRef(id_bytes, owner, skip_adding_local_ref=True)
    return ObjectRef(id_bytes, None)
