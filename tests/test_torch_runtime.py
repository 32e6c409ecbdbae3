"""ray_tpu_torch's runtime core on the CPU: one cluster for the module.

The cluster is started with a logical GPU (`num_gpus=1`) so that the GPU
worker's exec path runs here too; no CUDA is touched.  Every `get` carries a
timeout, so a wedged cluster fails the test instead of hanging the sweep,
and the fixture always shuts the cluster down.
"""

import io
import os
import sys
import tempfile

import pytest
import torch

import ray_tpu_torch as rt

TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=1)
    try:
        yield
    finally:
        rt.shutdown()


@rt.remote
def _add_one(x):
    return x + 1


@rt.remote
def _echo(x):
    return x


def _info():
    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "gpu_worker": os.environ.get("RAY_TPU_WORKER_GPU"),
        "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")),
    }


_process_info = rt.remote(_info)


@rt.remote
def _resolve_default_device():
    from ray_tpu_torch import resolve_device

    try:
        resolve_device()
    except RuntimeError as e:
        return f"raised: {e}"
    return "no error"


@rt.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n

    def info(self):
        return _info()


def _descendants(root):
    """Pids of every process below `root`, read from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, stack = [], [root]
    while stack:
        for c in children.get(stack.pop(), []):
            out.append(c)
            stack.append(c)
    return out


def test_task_and_actor(cluster):
    assert rt.get(_add_one.remote(41), timeout=TIMEOUT) == 42
    counter = _Counter.remote(10)
    assert rt.get([counter.add.remote(1), counter.add.remote(2)], timeout=TIMEOUT) == [11, 13]


TENSORS = {
    "f32": lambda: torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
    "bf16": lambda: torch.randn(4, 7, generator=torch.Generator().manual_seed(1)).bfloat16(),
    "int64": lambda: torch.arange(-5, 12, dtype=torch.int64).reshape(1, 17),
    "non_contiguous": lambda: torch.randn(6, 4, generator=torch.Generator().manual_seed(2)).t()[:, ::2],
    "zero_dim": lambda: torch.tensor(2.5),
}


@pytest.mark.parametrize("kind", sorted(TENSORS))
def test_put_get_tensor_exact(cluster, kind):
    t = TENSORS[kind]()
    refs = (rt.put(t), _echo.remote(t))
    for ref in refs:
        back = rt.get(ref, timeout=TIMEOUT)
        assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
        assert back.dtype == t.dtype and back.shape == t.shape
        assert torch.equal(back, t)
        back.add_(1)  # the store's bytes are never handed out writable
        assert torch.equal(rt.get(ref, timeout=TIMEOUT), t)


@rt.remote
def _save_load_after_put():
    """torch.save / torch.load(weights_only=True) in a worker that has just
    sent and received tensors through the runtime."""
    model = torch.nn.Linear(3, 2)
    state = rt.get(rt.put(model.state_dict()), timeout=TIMEOUT)
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=True)
    return all(torch.equal(back[k], v) for k, v in model.state_dict().items()) and back.keys() == state.keys()


def test_torch_save_keeps_torch_reduction(cluster):
    """The runtime's tensor reducer is its own pickler's, not copyreg's: a
    file written by torch.save after a put loads with weights_only=True."""
    assert rt.get(_save_load_after_put.remote(), timeout=TIMEOUT) is True
    t = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    assert torch.equal(rt.get(rt.put({"w": t}), timeout=TIMEOUT)["w"], t)
    buf = io.BytesIO()
    torch.save({"w": t}, buf)
    buf.seek(0)
    assert torch.equal(torch.load(buf, weights_only=True)["w"], t)


def test_workers_import_no_jax_or_ray_tpu(cluster):
    info = rt.get(_process_info.remote(), timeout=TIMEOUT)
    assert info["forbidden"] == []
    counter = _Counter.options(num_gpus=1).remote(0)
    assert rt.get(counter.info.remote(), timeout=TIMEOUT)["forbidden"] == []
    rt.kill(counter)


def test_every_session_process_runs_a_port_module(cluster):
    from ray_tpu_torch._private.worker import global_worker

    rt.get([_add_one.remote(i) for i in range(4)], timeout=TIMEOUT)  # pool workers up
    head = global_worker.head_proc.pid
    pids = [head] + _descendants(head)
    assert len(pids) >= 3, pids  # head, zygote, workers
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
        except OSError:
            continue  # exited meanwhile
        if state == "Z":
            continue  # a killed actor's worker, not reaped yet: no cmdline left
        assert "-m" in argv and argv[argv.index("-m") + 1].startswith("ray_tpu_torch."), (pid, argv)


def test_head_and_zygote_load_no_torch(cluster):
    """They fork or start every worker: CUDA must stay untouched there, and
    torch's import is kept out of them altogether."""
    from ray_tpu_torch._private.worker import global_worker

    rt.get(_add_one.remote(0), timeout=TIMEOUT)  # the zygote is up
    head = global_worker.head_proc.pid
    servers = [head]
    for pid in _descendants(head):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
            # the zygote server reads its spawn requests from a pipe; the
            # workers it forked keep its command line but read /dev/null
            if "ray_tpu_torch._private.zygote" in argv and os.readlink(f"/proc/{pid}/fd/0") != os.devnull:
                servers.append(pid)
        except OSError:
            continue
    assert len(servers) == 2, servers
    for pid in servers:
        with open(f"/proc/{pid}/maps") as f:
            assert "libtorch" not in f.read(), pid


def test_pool_worker_sees_no_card(cluster):
    info = rt.get(_process_info.remote(), timeout=TIMEOUT)
    assert info["cuda_visible_devices"] == "" and info["gpu_worker"] is None
    assert rt.get(_resolve_default_device.remote(), timeout=TIMEOUT).startswith("raised")


def test_gpu_actor_is_an_exec_gpu_worker(cluster):
    counter = _Counter.options(num_gpus=1).remote(0)
    info = rt.get(counter.info.remote(), timeout=TIMEOUT)
    with open(f"/proc/{info['pid']}/cmdline", "rb") as f:
        argv = f.read().decode().split("\0")
    rt.kill(counter)
    assert info["gpu_worker"] == "1"
    assert info["cuda_visible_devices"] == os.environ.get("CUDA_VISIBLE_DEVICES")
    assert argv[argv.index("-m") + 1] == "ray_tpu_torch.core.worker_main"  # exec, not a zygote fork


def test_cluster_resources_name_the_gpu(cluster):
    assert rt.cluster_resources()["GPU"] == 1.0


def test_session_dir_is_the_ports_own(cluster):
    from ray_tpu_torch._private.worker import global_worker

    root = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    assert global_worker.session_dir.startswith(os.path.join(root, "session_"))
    assert os.path.isdir(global_worker.session_dir)


def test_session_root_follows_tmpdir(tmp_path, monkeypatch):
    """Two checkouts with their own TMPDIR never share a session root."""
    from ray_tpu_torch._private.config import session_root

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)  # re-read TMPDIR
    assert session_root() == os.path.join(str(tmp_path), "ray_tpu_torch")


def test_put_device_tier_raises(cluster):
    with pytest.raises(NotImplementedError, match="device tier"):
        rt.put(torch.ones(3), tier="device")


def test_gpu_detection_reads_no_cuda(monkeypatch):
    from ray_tpu_torch._private import worker

    monkeypatch.setenv("RAY_TPU_GPUS", "3")
    assert worker._detect_gpus() == 3
    monkeypatch.delenv("RAY_TPU_GPUS")
    monkeypatch.setattr(worker.os, "listdir", lambda p: ["0000:01:00.0", "0000:02:00.0"])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert worker._detect_gpus() == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert worker._detect_gpus() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert worker._detect_gpus() == 2
    assert "torch.cuda" not in sys.modules or not torch.cuda.is_initialized()
