"""Public collective API.

Keeps the reference's surface (reference: python/ray/util/collective/
collective.py — init_collective_group:120, create_collective_group:151,
allreduce:258, barrier:298, reduce:311, broadcast:373, allgather:423,
reducescatter:472, send:531, recv:594) with one backend so far:

- ``dcn``: cross-process TCP ring with head-KV rendezvous (dcn_backend.py)
- ``ici`` (alias ``nccl``): the in-process device backend; not ported yet —
  an NCCL backend comes with multi-GPU (ROADMAP, Queue 1)

Rendezvous state lives in the head KV instead of a named store actor
(reference used NCCLUniqueIDStore, collective_group/util.py:9).
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.util.collective.types import Backend, GroupInfo, ReduceOp


class _KvShim:
    """KV access that works inside any connected driver/worker process."""

    def kv_put(self, key: str, value: bytes):
        from ray_tpu_torch._private import worker as worker_mod

        worker_mod._require_connected().kv_put(key, value)

    def kv_get(self, key: str, wait: bool = False, timeout: Optional[float] = None):
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod._require_connected().kv_get(key, wait=wait, timeout=timeout)


class _GroupManager:
    def __init__(self):
        self._groups: Dict[str, object] = {}
        self._infos: Dict[str, GroupInfo] = {}
        self._lock = threading.Lock()

    def create(self, backend: str, group_name: str, world_size: int, rank: int, devices=None, nonce: str = ""):
        backend = Backend.resolve(backend)
        with self._lock:
            if group_name in self._groups:
                raise ValueError(f"collective group {group_name!r} already exists")
        if backend == "ici":
            raise NotImplementedError(
                "the in-process device collective backend (ici/nccl) is not "
                "ported yet (ROADMAP, Queue 1: multi-GPU); use backend='dcn'"
            )
        from ray_tpu_torch.util.collective.dcn_backend import DcnGroup

        group = DcnGroup(group_name, world_size, rank, _KvShim(), nonce=nonce)
        info = GroupInfo(group_name, world_size, rank, backend)
        with self._lock:
            self._groups[group_name] = group
            self._infos[group_name] = info
        return group

    def get(self, group_name: str):
        g = self._groups.get(group_name)
        if g is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this process; "
                f"call init_collective_group() first"
            )
        return g

    def info(self, group_name: str) -> GroupInfo:
        return self._infos[group_name]

    def destroy(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
            self._infos.pop(group_name, None)
        if g is not None:
            g.destroy()


_manager = _GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "dcn",
    group_name: str = "default",
    devices=None,
    rendezvous_nonce: str = "",
):
    """Called by each participant (usually inside a worker actor) to join a
    group (reference: collective.py:120).  ``rendezvous_nonce``: one value
    shared by ALL ranks of one group incarnation — a respawned gang passes
    a fresh nonce so its dcn rendezvous can never consume a dead
    predecessor's stale KV entries."""
    _manager.create(backend, group_name, world_size, rank, devices, nonce=rendezvous_nonce)


def create_collective_group(
    actors: List,
    world_size: int,
    ranks: List[int],
    backend: str = "dcn",
    group_name: str = "default",
    rendezvous_nonce: str = "",
):
    """Driver-side declaration: tells every actor to join (reference:
    collective.py:151 — there it only *declares*; here we actively invoke
    the actors' _ray_tpu_torch_init_collective trampoline)."""
    import ray_tpu_torch
    from ray_tpu_torch.actor import ActorMethod

    refs = []
    for actor, rank in zip(actors, ranks):
        # ActorHandle.__getattr__ blocks underscore names; build the method
        # explicitly — the worker-side executor special-cases this name
        method = ActorMethod(actor, "_ray_tpu_torch_init_collective")
        refs.append(
            method.remote(world_size, rank, backend, group_name, rendezvous_nonce)
        )
    ray_tpu_torch.get(refs, timeout=180)


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.info(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.info(group_name).world_size


def _to_numpy(tensor):
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    """In-place-style allreduce: returns the reduced tensor (numpy out;
    numpy arrays or torch tensors in)."""
    g = _manager.get(group_name)
    if hasattr(g, "rank"):  # dcn
        return g.allreduce(_to_numpy(tensor), op)
    return g.allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _manager.get(group_name)
    if hasattr(g, "rank"):  # dcn
        return g.reduce(_to_numpy(tensor), dst_rank, op)
    return g.reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default", topology: str = "ring"):
    """``topology`` applies to dcn groups: "ring" (n-1 serial hops) or
    "tree" (binomial fan-out over p2p links, O(log n) depth — internal
    ranks re-serve their subtree, so aggregate bandwidth scales past the
    source's single uplink).  ICI groups ignore it (XLA schedules)."""
    g = _manager.get(group_name)
    if hasattr(g, "rank"):
        return g.broadcast(_to_numpy(tensor), src_rank, topology=topology)
    return g.broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    g = _manager.get(group_name)
    if hasattr(g, "rank"):
        return g.allgather(_to_numpy(tensor))
    return g.allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    g = _manager.get(group_name)
    if hasattr(g, "rank"):
        return g.reducescatter(_to_numpy(tensor), op)
    return g.reducescatter(tensor, op)


def barrier(group_name: str = "default"):
    _manager.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    _manager.get(group_name).send(_to_numpy(tensor), dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return _manager.get(group_name).recv(src_rank)


def sendrecv(per_device, pairs, group_name: str = "default"):
    """ICI point-to-point: (src, dst) pairs executed as one ppermute over
    the group's device mesh (single-process multi-device groups; the
    multigpu flavor of reference send/recv, collective.py:531,594)."""
    g = _manager.get(group_name)
    if hasattr(g, "rank"):  # dcn: cross-process groups use send()/recv()
        raise ValueError(
            "sendrecv() is ICI-only (one process, many devices); "
            "for DCN groups use send()/recv()"
        )
    return g.sendrecv(per_device, pairs)
