"""ctypes wrapper for the native scheduling core (src/scheduler/scheduler.cc).

Resource names are interned to dense indices here; values cross the
boundary as int64 fixed-point at 1e4 scale (reference:
src/ray/raylet/scheduling/fixed_point.h uses the same factor).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

from ray_tpu_torch._private.build_native import ensure_lib
from ray_tpu_torch.util.lockwitness import named_lock

SCALE = 10_000
MAX_RESOURCES = 128


class _Lib:
    _instance = None

    @classmethod
    def get(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(ensure_lib("scheduler"))
            lib.sched_create.restype = ctypes.c_void_p
            lib.sched_destroy.argtypes = [ctypes.c_void_p]
            I64P = ctypes.POINTER(ctypes.c_int64)
            lib.sched_upsert_node.restype = ctypes.c_int
            lib.sched_upsert_node.argtypes = [ctypes.c_void_p, ctypes.c_int, I64P, ctypes.c_int]
            lib.sched_remove_node.restype = ctypes.c_int
            lib.sched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.sched_acquire.restype = ctypes.c_int
            lib.sched_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int, I64P, ctypes.c_int]
            lib.sched_acquire_force.argtypes = [ctypes.c_void_p, ctypes.c_int, I64P, ctypes.c_int]
            lib.sched_release.argtypes = [ctypes.c_void_p, ctypes.c_int, I64P, ctypes.c_int]
            lib.sched_utilization.restype = ctypes.c_int64
            lib.sched_utilization.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.sched_available.argtypes = [ctypes.c_void_p, ctypes.c_int, I64P, ctypes.c_int]
            lib.sched_pick_and_acquire.restype = ctypes.c_int
            lib.sched_pick_and_acquire.argtypes = [
                ctypes.c_void_p,
                I64P,
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.sched_feasible.restype = ctypes.c_int
            lib.sched_feasible.argtypes = [ctypes.c_void_p, I64P, ctypes.c_int]
            cls._instance = lib
        return cls._instance


class NativeScheduler:
    """One per head server: the cluster resource view + hybrid policy."""

    def __init__(self):
        self._lib = _Lib.get()
        self._h = self._lib.sched_create()
        self._names: Dict[str, int] = {}
        self._node_ids: Dict[bytes, int] = {}
        self._idx_to_node: Dict[int, bytes] = {}
        self._next_node = 0
        self._lock = named_lock("NativeScheduler._lock")

    def _intern(self, name: str) -> int:
        idx = self._names.get(name)
        if idx is None:
            if len(self._names) >= MAX_RESOURCES:
                raise ValueError("too many distinct resource types")
            idx = len(self._names)
            self._names[name] = idx
        return idx

    def _vec(self, resources: Dict[str, float]):
        arr = (ctypes.c_int64 * MAX_RESOURCES)()
        top = 0
        for name, value in resources.items():
            i = self._intern(name)
            arr[i] = int(round(value * SCALE))
            top = max(top, i + 1)
        return arr, max(top, len(self._names))

    def _node_idx(self, node_id: bytes, create: bool = False) -> Optional[int]:
        idx = self._node_ids.get(node_id)
        if idx is None and create:
            idx = self._next_node
            self._next_node += 1
            self._node_ids[node_id] = idx
            self._idx_to_node[idx] = node_id
        return idx

    # ----------------------------------------------------------------- api

    def upsert_node(self, node_id: bytes, totals: Dict[str, float]):
        with self._lock:
            idx = self._node_idx(node_id, create=True)
            arr, n = self._vec(totals)
            self._lib.sched_upsert_node(self._h, idx, arr, n)

    def remove_node(self, node_id: bytes):
        with self._lock:
            idx = self._node_idx(node_id)
            if idx is not None:
                self._lib.sched_remove_node(self._h, idx)

    def acquire(self, node_id: bytes, demand: Dict[str, float], force: bool = False) -> bool:
        with self._lock:
            idx = self._node_idx(node_id)
            if idx is None:
                return False
            arr, n = self._vec(demand)
            if force:
                self._lib.sched_acquire_force(self._h, idx, arr, n)
                return True
            return self._lib.sched_acquire(self._h, idx, arr, n) == 0

    def release(self, node_id: bytes, demand: Dict[str, float]):
        with self._lock:
            idx = self._node_idx(node_id)
            if idx is not None:
                arr, n = self._vec(demand)
                self._lib.sched_release(self._h, idx, arr, n)

    def utilization(self, node_id: bytes) -> float:
        with self._lock:
            idx = self._node_idx(node_id)
            if idx is None:
                return 0.0
            return self._lib.sched_utilization(self._h, idx) / SCALE

    def available(self, node_id: bytes) -> Dict[str, float]:
        with self._lock:
            idx = self._node_idx(node_id)
            if idx is None:
                return {}
            arr = (ctypes.c_int64 * MAX_RESOURCES)()
            self._lib.sched_available(self._h, idx, arr, len(self._names))
            return {name: arr[i] / SCALE for name, i in self._names.items()}

    def pick_and_acquire(
        self,
        demand: Dict[str, float],
        spread_threshold: float,
        prefer: Optional[bytes] = None,
    ) -> Optional[bytes]:
        """Hybrid policy decision + reservation in one native call."""
        with self._lock:
            arr, n = self._vec(demand)
            prefer_idx = self._node_ids.get(prefer, -1) if prefer else -1
            idx = self._lib.sched_pick_and_acquire(
                self._h, arr, n, int(spread_threshold * SCALE), prefer_idx
            )
            if idx < 0:
                return None
            return self._idx_to_node[idx]

    def feasible(self, demand: Dict[str, float]) -> bool:
        with self._lock:
            arr, n = self._vec(demand)
            return bool(self._lib.sched_feasible(self._h, arr, n))

    def __del__(self):
        try:
            self._lib.sched_destroy(self._h)
        except Exception:  # graftlint: disable=silent-except -- interpreter-teardown __del__; the lib may already be unloaded
            pass
