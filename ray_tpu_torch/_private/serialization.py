"""Object serialization.

Analog of the reference's pickle5 + out-of-band-buffer scheme
(reference: python/ray/_private/serialization.py — cloudpickle protocol 5
with zero-copy numpy buffers landing in plasma).  Values are pickled with
cloudpickle protocol 5; large contiguous buffers (numpy arrays, and torch
tensors via this module's pickler) are captured out-of-band so they can be
placed in / read from the shared-memory object store without a copy.
"""

from __future__ import annotations

import io
import pickle
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, List, Sequence

import cloudpickle
import numpy as np

# Metadata tags (analog: ray_constants OBJECT_METADATA_TYPE_*)
META_PICKLE = b"py"
META_RAW = b"raw"  # value is raw bytes, stored as-is, zero-copy
META_TASK_ERROR = b"err"
META_ACTOR_HANDLE = b"actor"

# Contained-ref capture: while serialize() runs, ObjectRef.__reduce__ records
# every ref pickled into the payload here.  The ids ride the control message
# that ships the payload (PUT_OBJECT / TaskSpec.nested_refs / TASK_DONE), so
# the head can pin inner objects for as long as their container is in scope —
# the owner-centralized form of the reference's borrower protocol
# (reference: src/ray/core_worker/reference_count.cc), which exists to close
# the window where the sender releases a shipped ref before the receiver has
# registered its own.
_capture = threading.local()


def _begin_ref_capture() -> list:
    stack = getattr(_capture, "stack", None)
    if stack is None:
        stack = _capture.stack = []
    frame: list = []
    stack.append(frame)
    return frame


def _end_ref_capture(frame: list) -> List[bytes]:
    stack = getattr(_capture, "stack", None)
    if stack and stack[-1] is frame:
        stack.pop()
    # dedup, keep order
    return list(dict.fromkeys(frame))


def record_contained_ref(oid: bytes):
    """Called by ObjectRef.__reduce__ during an active serialize()."""
    stack = getattr(_capture, "stack", None)
    if stack:
        stack[-1].append(oid)


# A torch dtype without a numpy counterpart travels as the signed integer
# type of its width (bfloat16 as int16, the float8 types as int8) and is
# restored by name on load.
_INT_OF_WIDTH = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _tensor_to_host(t):
    """(numpy array sharing the tensor's host bytes, dtype name, was-on-card).

    A CUDA tensor is copied to the host and any tensor made contiguous, so
    the array is one buffer, which protocol 5 ships out of band."""
    import torch

    on_cuda = t.device.type == "cuda"
    x = t.detach()
    if x.device.type != "cpu":
        x = x.cpu()
    x = x.contiguous()
    name = str(x.dtype).removeprefix("torch.")
    try:
        arr = x.numpy()
    except TypeError:  # bfloat16, float8: no numpy dtype
        arr = x.view(getattr(torch, np.dtype(_INT_OF_WIDTH[x.element_size()]).name)).numpy()
    return arr, name, on_cuda


def _rebuild_tensor(arr, dtype_name: str, on_cuda: bool, requires_grad: bool, parameter: bool = False):
    """Inverse of _reduce_tensor.  A tensor that was on a card comes back on
    the card when this process has one, as `jnp.asarray` puts an array on
    the loader's default device, and on the CPU otherwise."""
    import warnings

    import torch

    with warnings.catch_warnings():
        # arr may be a read-only view of the pickle's bytes; every path
        # below copies it before anyone can write
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    dtype = getattr(torch, dtype_name)
    if t.dtype != dtype:
        t = t.view(dtype)
    if on_cuda and torch.cuda.is_available():
        t = t.to("cuda")
    elif not (arr.flags.owndata and arr.flags.writeable):
        # an out-of-band buffer is a view of the object store's mapping:
        # a tensor over it would let one reader's in-place op change the
        # object for every later get
        t = t.clone()
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(t):
    arr, name, on_cuda = _tensor_to_host(t)
    parameter = type(t) is sys.modules["torch"].nn.Parameter
    return (_rebuild_tensor, (arr, name, on_cuda, bool(t.requires_grad), parameter))


class _Pickler(cloudpickle.Pickler):
    """cloudpickle with the tensor reducer, for this module's picklers only.

    Tensors travel as one contiguous host buffer (out of band, zero-copy
    into shm) plus their dtype and device kind.  The reducer is not put in
    copyreg's global table, so `torch.save` and `copy` in the same process
    keep torch's own reduction.  torch is never imported here: the head,
    the raylet and the zygote stay torch-free, and a process that has not
    imported torch holds no tensor to send."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _pickle(value: Any, buffer_callback=None) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
        return f.getvalue()


@dataclass
class SerializedObject:
    """A value split into metadata, in-band pickle bytes, and raw buffers."""

    metadata: bytes
    inband: bytes
    buffers: List[memoryview] = field(default_factory=list)
    # ObjectRef ids pickled inside this value (borrower pinning; not on the
    # data-plane wire — shipped via the control message that moves the value)
    contained: List[bytes] = field(default_factory=list)

    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)

    def to_wire(self) -> list:
        """msgpack-compatible representation (copies buffers)."""
        return [self.metadata, self.inband, [bytes(b) for b in self.buffers]]

    @classmethod
    def from_wire(cls, wire: Sequence) -> "SerializedObject":
        meta, inband, bufs = wire
        return cls(bytes(meta), bytes(inband), [memoryview(b) for b in bufs])


def serialize(value: Any) -> SerializedObject:
    if isinstance(value, bytes):
        return SerializedObject(META_RAW, b"", [memoryview(value)])
    buffers: List[pickle.PickleBuffer] = []
    frame = _begin_ref_capture()
    try:
        inband = _pickle(value, buffer_callback=buffers.append)
    finally:
        contained = _end_ref_capture(frame)
    views = []
    for pb in buffers:
        try:
            views.append(pb.raw())
        except BufferError:
            # non-contiguous buffer: force a contiguous copy
            views.append(memoryview(bytes(pb)))
    return SerializedObject(META_PICKLE, inband, views, contained)


def deserialize(obj: SerializedObject) -> Any:
    if obj.metadata == META_RAW:
        return bytes(obj.buffers[0]) if obj.buffers else b""
    value = pickle.loads(obj.inband, buffers=obj.buffers)
    return value


def dumps(value: Any) -> bytes:
    """Flat single-buffer form, for control-plane payloads."""
    return _pickle(value)


def loads(data: bytes) -> Any:
    return pickle.loads(data)
