"""Binary unique IDs for every entity in the system.

Analog of the reference ID hierarchy (reference:
src/ray/common/id.h — TaskID/ObjectID/ActorID/NodeID/PlacementGroupID).
We keep the same *shape* of the design — fixed-size binary IDs with
structural relationships (an ObjectID embeds the TaskID that produced it,
a TaskID embeds the ActorID/JobID it belongs to) — but use a simpler
16-byte random core since we do not need Ray's wire-compat layout.
"""

from __future__ import annotations

import os
import threading

_UNIQUE_LEN = 16  # bytes of entropy for base ids


class BaseID:
    """A fixed-length binary id, hashable and comparable."""

    __slots__ = ("_bin",)
    SIZE = _UNIQUE_LEN

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        self._bin = binary

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bin))

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __lt__(self, other):
        return self._bin < other._bin

    def __repr__(self):
        return f"{type(self).__name__}({self._bin.hex()[:16]}…)"

    def __reduce__(self):
        return (type(self), (self._bin,))


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, i: int):
        return cls(i.to_bytes(4, "little"))

    def int(self) -> int:
        return int.from_bytes(self._bin, "little")


class NodeID(BaseID):
    SIZE = _UNIQUE_LEN


class WorkerID(BaseID):
    SIZE = _UNIQUE_LEN


class ActorID(BaseID):
    """job_id (4) + unique (12)."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID):
        return cls(job_id.binary() + os.urandom(12))

    def job_id(self) -> JobID:
        return JobID(self._bin[:4])


class PlacementGroupID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID):
        return cls(job_id.binary() + os.urandom(12))


class TaskID(BaseID):
    """actor_id (16) + unique (8).  Driver tasks use a nil actor part."""

    SIZE = 24

    @classmethod
    def for_driver_task(cls, job_id: JobID):
        return cls(job_id.binary() + b"\x00" * 12 + os.urandom(8))

    @classmethod
    def for_normal_task(cls, job_id: JobID):
        return cls(job_id.binary() + b"\x00" * 12 + os.urandom(8))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID):
        return cls(actor_id.binary() + os.urandom(8))

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID):
        # Deterministic: the creation task of an actor.
        return cls(actor_id.binary() + b"\xff" * 8)

    def actor_id(self) -> ActorID:
        return ActorID(self._bin[:16])

    def job_id(self) -> JobID:
        return JobID(self._bin[:4])


class ObjectID(BaseID):
    """task_id (24) + return-index (4, little endian).

    Mirrors the reference's scheme where an ObjectID is derived from the
    producing TaskID plus an index (src/ray/common/id.h); this is what makes
    lineage-based reconstruction possible — given an object id you know the
    task that created it.
    """

    SIZE = 28

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int):
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        # puts use the high bit of the index to avoid collision with returns
        return cls(task_id.binary() + (0x80000000 | put_index).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bin[:24])

    def return_index(self) -> int:
        return int.from_bytes(self._bin[24:], "little") & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bin[24:], "little") & 0x80000000)


ObjectRef = ObjectID  # the user-facing alias; see object_ref.py for the rich wrapper


class _Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v
