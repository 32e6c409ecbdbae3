"""The port's object store keeps a pinned block until its last release.

An owner-driven delete of a sealed object that a reader still pins (a
zero-copy numpy array from a `get`) only marks it delete-pending; the
release that drops the last pin frees the block.  Held here at the store
level, through the port's runtime on the CPU, and, as the fault it repairs,
against the JAX package's runtime, whose store frees pinned blocks.
"""

import gc
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.serialization import deserialize, serialize
from ray_tpu_torch.core.shm_store import ShmObjectStore

TIMEOUT = 60
BLOCK = 64 * 1024 // 8  # float64 elements in a 64 KB payload


def _oid(i: int) -> bytes:
    return i.to_bytes(4, "little") + b"\x01" * 24


@pytest.fixture
def store(tmp_path):
    s = ShmObjectStore(str(tmp_path / "store"), capacity=1 << 20, create=True, nslots=256)
    try:
        yield s
    finally:
        s.close()


def test_deleted_pinned_object_survives_refill(store):
    assert store.put_serialized(_oid(0), serialize(np.full(BLOCK, 7.0)))
    sobj = store.get_serialized(_oid(0))
    view = deserialize(sobj)
    assert not view.flags.owndata  # zero-copy over the segment
    used = store.used()
    store.delete(_oid(0))
    # pending: gone for every lookup, still allocated and counted
    assert not store.contains(_oid(0))
    assert store.get_serialized(_oid(0)) is None
    assert store.used() == used and store.num_objects() == 1
    # fill the segment several times over: puts evict what they must, but
    # never the pending block
    for i in range(1, 41):
        assert store.put_serialized(_oid(i), serialize(np.full(BLOCK, float(i))))
    assert np.all(view == 7.0)
    for i in range(1, 41):
        store.delete(_oid(i))  # unpinned: freed at once (or already evicted)
    assert store.used() == used and store.num_objects() == 1
    del view, sobj
    gc.collect()
    assert store.used() == 0 and store.num_objects() == 0


def test_recreated_id_and_pending_block_release_apart(store):
    """An id re-created while its old block is pending names two blocks;
    each pin's release finds its own."""
    assert store.put_serialized(_oid(5), serialize(np.full(BLOCK, 1.0)))
    old = deserialize(store.get_serialized(_oid(5)))
    store.delete(_oid(5))
    assert store.put_serialized(_oid(5), serialize(np.full(BLOCK, 2.0)))
    new = deserialize(store.get_serialized(_oid(5)))
    assert store.num_objects() == 2
    del old
    gc.collect()
    assert store.num_objects() == 1 and np.all(new == 2.0)
    # the new object's pin survived the old one's release: still no free
    store.delete(_oid(5))
    assert store.num_objects() == 1
    for i in range(6, 30):
        assert store.put_serialized(_oid(i), serialize(np.full(BLOCK, float(i))))
    assert np.all(new == 2.0)
    del new
    gc.collect()
    for i in range(6, 30):
        store.delete(_oid(i))
    assert store.used() == 0 and store.num_objects() == 0


def _gets_survive_later_results(pkg, **init_kw):
    """An array and a tensor got from tasks (their refs dropped at once, so
    the owner frees both) against 40 later task results and puts."""
    pkg.init(num_cpus=2, **init_kw)
    try:
        make_array = pkg.remote(lambda v: np.full(1 << 20, v))
        make_tensor = pkg.remote(lambda v: torch.full((1 << 20,), v, dtype=torch.float64))
        arr, ten = pkg.get([make_array.remote(7.0), make_tensor.remote(7.0)], timeout=TIMEOUT)
        # the owner batches its reference drops every 0.2 s: give the free
        # of both objects time to reach the head before the later results
        time.sleep(1.0)
        kept = []
        for i in range(40):
            pkg.get(make_array.remote(float(i)), timeout=TIMEOUT)
            kept.append(pkg.put(np.full(1 << 18, float(i))))
        return arr[:3].tolist(), bool(np.all(arr == 7.0)), bool(torch.all(ten == 7.0))
    finally:
        pkg.shutdown()


def test_runtime_gets_survive_later_results():
    import ray_tpu_torch

    head, arr_ok, ten_ok = _gets_survive_later_results(ray_tpu_torch, num_gpus=0)
    assert arr_ok, f"the array got from a task now reads {head}"
    assert ten_ok


@pytest.mark.xfail(strict=True, reason="the reference's store frees pinned blocks (ROADMAP Queue 3)")
def test_reference_runtime_gets_survive_later_results(monkeypatch):
    import ray_tpu
    from ray_tpu._private.config import RayConfig

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    try:
        head, arr_ok, _ = _gets_survive_later_results(ray_tpu)
    finally:
        RayConfig.reset()
    assert arr_ok, f"the array got from a task now reads {head}"
