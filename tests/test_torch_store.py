"""The port's object store keeps a pinned block until its last release.

An owner-driven delete of a sealed object that a reader still pins (a
zero-copy numpy array from a `get`) only marks it delete-pending; the
release that drops the last pin frees the block.  Held here at the store
level, through the port's runtime on the CPU, and, as the fault it repairs,
against the JAX package's runtime, whose store frees pinned blocks.  A
reader that dies holding pins never releases them: the store keeps each pin
under its reader's pid, and the runtime drops a dead worker's pins
(`store_release_process`), so its blocks are freed all the same, whether
the delete came before the death or after it.
"""

import gc
import os
import signal
import subprocess
import sys
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


_READER = """
import sys, time
import numpy as np
from ray_tpu_torch._private.serialization import deserialize
from ray_tpu_torch.core.shm_store import ShmObjectStore
store = ShmObjectStore(sys.argv[1], create=False)
view = deserialize(store.get_serialized(bytes.fromhex(sys.argv[2])))
print(int(not view.flags.owndata and np.all(view == 7.0)), flush=True)
time.sleep(600)
"""


@pytest.mark.parametrize("delete_first", [True, False], ids=["delete-then-kill", "kill-then-delete"])
def test_dead_readers_pins_are_dropped(store, tmp_path, delete_first):
    """A reader process pins a block zero-copy and is SIGKILLed without a
    release; store_release_process(pid) drops its pins and frees the block,
    deleted before the death (then pending) or after it."""
    assert store.put_serialized(_oid(9), serialize(np.full(BLOCK, 7.0)))
    used = store.used()
    reader = subprocess.Popen([sys.executable, "-c", _READER, str(tmp_path / "store"), _oid(9).hex()],
                              stdout=subprocess.PIPE, text=True)
    try:
        assert reader.stdout.readline().strip() == "1"  # a zero-copy view, pinned under the reader's pid
        assert store.release_process(os.getpid()) == 0  # this process holds no pin
        if delete_first:
            store.delete(_oid(9))
            assert store.used() == used and store.num_objects() == 1  # pending on the reader's pin
    finally:
        reader.send_signal(signal.SIGKILL)
        reader.wait(timeout=TIMEOUT)
    assert store.release_process(reader.pid) == 1 and store.release_process(reader.pid) == 0
    if not delete_first:
        assert store.num_objects() == 1  # nothing pins it now: the delete frees it at once
        store.delete(_oid(9))
    assert store.used() == 0 and store.num_objects() == 0


def _wait_for(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _settled(store, timeout=TIMEOUT):
    """(used, object count) once two readings 0.5 s apart agree."""
    deadline = time.monotonic() + timeout
    last = (store.used(), store.num_objects())
    while True:
        time.sleep(0.5)
        now = (store.used(), store.num_objects())
        if now == last:
            return now
        assert time.monotonic() < deadline, "the store never settled"
        last = now


@pytest.mark.parametrize("delete_first", [True, False], ids=["delete-then-kill", "kill-then-delete"])
def test_runtime_frees_blocks_a_killed_worker_pinned(delete_first):
    """Through the runtime: an actor takes a zero-copy array from the store
    (a task argument, so the actor borrows no ref) and keeps it, is
    SIGKILLed, the object is deleted (the owner drops its last ref), and
    the head node's store returns to its earlier used bytes and object
    count, the delete coming before the death or after it.  Every cluster
    call carries a timeout."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker

    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        @ray_tpu_torch.remote
        class Reader:
            def ping(self):
                return os.getpid()

            def hold(self, arr):
                self.view = arr
                return bool(not arr.flags.owndata and np.all(arr == 7.0))

        reader = Reader.remote()
        pid = ray_tpu_torch.get(reader.ping.remote(), timeout=TIMEOUT)
        assert pid != os.getpid()
        store = global_worker.core_worker.store
        used, objects = _settled(store)  # the ping's own objects are freed in the owner's next batches
        ref = ray_tpu_torch.put(np.full(1 << 20, 7.0))
        oid = ref.binary()
        assert ray_tpu_torch.get(reader.hold.remote(ref), timeout=TIMEOUT)  # zero-copy in the actor
        assert store.used() > used
        if delete_first:
            del ref  # the owner frees it: pending on the actor's pin
            _wait_for(lambda: not store.contains(oid), "the owner's delete")
            assert store.used() > used
        os.kill(pid, signal.SIGKILL)
        if not delete_first:
            del ref
        _wait_for(lambda: store.used() == used and store.num_objects() == objects,
                  f"the store returns to used={used}, objects={objects}")
    finally:
        ray_tpu_torch.shutdown()


def _killed_borrower_keeps_object(pkg):
    """An actor borrows a ref nested in a list (the call's argument, not
    resolved) and drops it as its call returns; it is SIGKILLed right
    after, before its batched ref release goes out.  Returns (the object
    is readable while the driver still holds the ref, the object is freed
    within 5 s of the driver dropping its ref)."""
    from importlib import import_module

    worker_mod = import_module(pkg.__name__ + "._private.worker")
    pkg.init(num_cpus=2)
    try:
        @pkg.remote
        class Borrower:
            def ping(self):
                return os.getpid()

            def take(self, refs):
                return len(refs)

        borrower = Borrower.remote()
        pid = pkg.get(borrower.ping.remote(), timeout=TIMEOUT)
        store = worker_mod.global_worker.core_worker.store
        ref = pkg.put(np.full(1 << 18, 7.0))
        oid = ref.binary()
        assert pkg.get(borrower.take.remote([ref]), timeout=TIMEOUT) == 1
        os.kill(pid, signal.SIGKILL)
        time.sleep(1.0)
        held = store.contains(oid) and bool(np.all(np.asarray(pkg.get(ref, timeout=TIMEOUT)) == 7.0))
        del ref
        deadline = time.monotonic() + 5
        while store.contains(oid) and time.monotonic() < deadline:
            time.sleep(0.05)
        return held, not store.contains(oid)
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("package", [
    pytest.param("ray_tpu", marks=pytest.mark.xfail(
        strict=True, reason="the reference keeps an object a SIGKILLed borrower never released (ROADMAP Queue 3)")),
    pytest.param("ray_tpu_torch", marks=pytest.mark.xfail(
        strict=True, reason="the port keeps it as the reference does (ROADMAP Queue 3)")),
])
def test_killed_borrower_releases_its_borrow(package, monkeypatch):
    """The object stays readable while the driver holds its ref, and is
    freed once the driver drops it, though the borrower was SIGKILLed
    before its release went out.  Both packages keep the object (the
    head never learns that the dead borrower's borrow ended)."""
    import importlib

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    pkg = importlib.import_module(package)
    try:
        held, freed = _killed_borrower_keeps_object(pkg)
    finally:
        if package == "ray_tpu":
            from ray_tpu._private.config import RayConfig

            RayConfig.reset()
    assert held, "the object was freed while the driver held its ref"
    assert freed, "the object outlived the driver's ref: the dead borrower's borrow never ended"
