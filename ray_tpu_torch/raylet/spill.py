"""Spill/restore IO: move sealed objects between the shm store and disk.

Analog of the reference's IO-worker spill path (reference:
src/ray/raylet/local_object_manager.h:105 SpillObjects /
:117 AsyncRestoreSpilledObject + object_manager/spilled_object_reader.h):
a spilled object is the byte-for-byte store payload written to one file
per object in the node's session spill dir; restore re-creates and seals
it, after which gets and transfers proceed as if it never left.
"""

from __future__ import annotations

import errno
import os
import sys
import time
from typing import Optional

from ray_tpu_torch._private import chaos


def spill_path(spill_dir: str, oid: bytes) -> str:
    return os.path.join(spill_dir, oid.hex())


def spill_object(store, oid: bytes, spill_dir: str) -> Optional[str]:
    """Write the sealed object's store image to disk and drop the shm copy.
    Returns the file path, or None if the object vanished or a reader pins
    it (a pinned zero-copy view must never lose its backing block)."""
    view = store.raw_view(oid)
    if view is None:
        return None
    os.makedirs(spill_dir, exist_ok=True)
    path = spill_path(spill_dir, oid)
    tmp = path + ".tmp"
    try:
        if chaos.disk_on:
            verdict = chaos.disk_decide("disk.spill.write")
            if verdict is not None:
                action, param = verdict
                if action == "delay":
                    time.sleep(param)  # slow spill disk (off-loop path)
                elif action == "short":
                    # torn spill file must never become the final path
                    with open(tmp, "wb") as f:
                        f.write(bytes(view[: max(1, len(view) // 2)]))
                    delete_spilled(tmp)
                    raise OSError(errno.ENOSPC, "chaos: short spill write")
                elif action == "fail":
                    raise OSError(errno.ENOSPC, "chaos: spill write failed")
        with open(tmp, "wb") as f:
            f.write(view)
        os.replace(tmp, path)
    finally:
        del view  # release our pin before deleting
    if not store.delete_if_unpinned(oid):
        # a reader pinned it since the candidate scan: keep the shm copy,
        # withdraw the spill (no location change to report)
        delete_spilled(path)
        return None
    return path


def restore_object(store, oid: bytes, path: str) -> bool:
    """Load a spilled file back into the shm store and seal it."""
    if store.contains(oid):
        return True
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    buf = store.raw_create(oid, size)
    if buf is None:  # concurrent restore won the race
        return store.contains(oid)
    try:
        if chaos.disk_on:
            verdict = chaos.disk_decide("disk.spill.read")
            if verdict is not None:
                action, param = verdict
                if action == "delay":
                    time.sleep(param)  # slow restore (executor thread)
                elif action == "fail":
                    raise IOError("chaos: spill read failed")
        with open(path, "rb") as f:
            remaining = memoryview(buf)
            while remaining.nbytes:
                n = f.readinto(remaining)
                if not n:
                    raise IOError(f"short read restoring {oid.hex()[:16]}")
                remaining = remaining[n:]
        del remaining, buf
        store.raw_seal(oid)
    except BaseException:  # noqa: BLE001
        import traceback

        traceback.print_exc(file=sys.stderr)
        store.raw_abort(oid)
        return False
    return True


def delete_spilled(path: str):
    try:
        os.unlink(path)
    except OSError:
        pass


def spill_batch(store, need: int, spill_dir: str, max_n: int = 128) -> dict:
    """Spill LRU candidates until ~2x `need` bytes are freed (or we run
    out).  Returns {oid: path} for the head's spill registry.  Safe from
    any thread/claimant of the store: candidates are sealed + unpinned, and
    spill_object re-checks under the store mutex via its pinned view."""
    spilled = {}
    freed = 0
    target = max(need * 2, need)
    for oid, size in store.evict_candidates(max_n):
        if freed >= target:
            break
        try:
            path = spill_object(store, oid, spill_dir)
        except Exception:  # noqa: BLE001
            # a candidate that failed to spill (raced a delete, disk full)
            # is skipped, not fatal — but disk-full must be visible
            import traceback

            traceback.print_exc(file=sys.stderr)
            path = None
        if path:
            spilled[oid] = path
            freed += size
    return spilled
