"""Driver-side global worker state + init/shutdown + get/put/wait.

Analog of the reference's python/ray/_private/worker.py (init:1031,
connect:1853, get:2200, put:2313, wait:2369, shutdown:1567): owns the head
process lifecycle on the driver node and the process-global CoreWorker.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.config import RayConfig, session_root
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.object_ref import ObjectRef


class Worker:
    """Process-global runtime handle (reference: worker.py global_worker)."""

    def __init__(self):
        self.core_worker = None
        self.mode: Optional[str] = None  # driver | worker | None
        self.head_proc: Optional[subprocess.Popen] = None
        self.session_dir: str = ""
        self.address: str = ""

    @property
    def connected(self) -> bool:
        return self.core_worker is not None and self.core_worker.connected


global_worker = Worker()

def _detect_gpus() -> int:
    """How many CUDA devices this host gives the cluster (the head node's
    GPU resource).  ``RAY_TPU_GPUS`` overrides; else the NVIDIA driver's
    device list in /proc (or ``nvidia-smi -L``), cut to ``CUDA_VISIBLE_DEVICES`` when that is set.
    No CUDA call is made: the head and its zygote inherit nothing from this
    process, but a driver that counts through CUDA and later forks would
    leave the child unable to initialise CUDA."""
    env = os.environ.get("RAY_TPU_GPUS")
    if env is not None:
        return int(env)
    try:
        present = len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        try:  # no /proc entry (some containers): ask the driver's tool
            out = subprocess.run(
                ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=30
            ).stdout
        except (OSError, subprocess.SubprocessError):
            return 0
        present = sum(1 for line in out.splitlines() if line.startswith("GPU "))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return present
    # the CUDA runtime stops at the first entry it cannot use: "" and "-1"
    # hide every card
    n = 0
    for entry in visible.split(","):
        entry = entry.strip()
        if not entry or entry.startswith("-"):
            break
        n += 1
    return min(n, present)


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: str = "",
    runtime_env: Optional[dict] = None,
    priority: Optional[int] = None,
    _system_config: Optional[dict] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    **kwargs,
) -> "RuntimeContext":
    """Start (or connect to) a cluster and attach this process as driver.

    Reference semantics: python/ray/_private/worker.py:1031.

    ``priority`` sets this job's scheduling band (0 = best-effort, 1 =
    normal, 2+ = latency-critical): every task/actor this driver submits
    defaults to it (per-call ``.options(priority=...)`` overrides), and a
    higher-band request that cannot place may preempt lower-band work
    (see STATUS.md "Multi-tenancy").  Defaults to ``RAY_TPU_JOB_PRIORITY``
    from the environment (what ``JobSubmissionClient.submit_job(priority=
    ...)`` sets for its entrypoint), else 1.
    """
    from ray_tpu_torch.runtime_context import RuntimeContext

    if global_worker.connected:
        if ignore_reinit_error:
            return RuntimeContext(global_worker)
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")

    RayConfig.initialize(_system_config)

    if address in (None, "local"):
        host, port = _start_head(
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            object_store_memory=object_store_memory,
            system_config=_system_config,
        )
    else:
        if address == "auto":
            address = os.environ.get("RAY_TPU_ADDRESS", "")
            if not address:
                raise ConnectionError("address='auto' but RAY_TPU_ADDRESS is not set")
        host, port_s = address.rsplit(":", 1)
        port = int(port_s)

    from ray_tpu_torch.core.core_worker import CoreWorker

    worker_env = {}
    if _system_config:
        worker_env["RAY_TPU_SYSTEM_CONFIG"] = json.dumps(_system_config)
    # Ship the driver's import path so by-reference cloudpickle functions
    # (module-level defs outside site-packages) resolve in workers — the
    # single-machine analog of the reference's working_dir runtime env
    # (reference: _private/runtime_env/working_dir.py).
    import sys as _sys

    extra_paths = [p for p in _sys.path if p and p not in ("",)]
    existing = os.environ.get("PYTHONPATH", "")
    worker_env["PYTHONPATH"] = os.pathsep.join(
        dict.fromkeys(extra_paths + ([existing] if existing else []))
    )
    cw = CoreWorker(host, port, mode="driver", worker_env=worker_env)
    if priority is None:
        priority = int(os.environ.get("RAY_TPU_JOB_PRIORITY", "1") or 1)
    cw.default_priority = int(priority)
    global_worker.core_worker = cw
    global_worker.mode = "driver"
    global_worker.address = f"{host}:{port}"
    global_worker.namespace = namespace
    from collections import deque

    global_worker.captured_logs = deque(maxlen=1000)  # bounded ring, test hook
    job_hex = cw.job_id.binary().hex()
    if log_to_driver:
        # worker stdout/stderr stream to the driver — job-scoped by the
        # head (this subscription only receives records stamped with OUR
        # job), rendered with the (ClassName pid=… node=…) prefix, rate-
        # capped and repeat-collapsed by the sink (flood control)
        from ray_tpu_torch._private.log_monitor import DriverLogSink

        sink = DriverLogSink(rate_lines_s=RayConfig.driver_log_rate_lines_s)
        global_worker.driver_log_sink = sink

        def _on_log(msg: dict):
            global_worker.captured_logs.extend(msg.get("lines", []))
            sink.feed(msg)

        try:
            cw.subscribe("logs", _on_log)
        except Exception as e:  # noqa: BLE001
            print(
                f"ray_tpu_torch: worker-log streaming unavailable: {e}", file=sys.stderr
            )
    # driver output joins the log plane: terminal bytes untouched, each
    # completed line also teed as a structured record into the session
    # dir, where the head's tailer makes it LOG_FETCH-addressable by job
    if global_worker.session_dir:
        from ray_tpu_torch._private import log_plane

        log_plane.install_driver_tee(
            os.path.join(
                global_worker.session_dir,
                f"driver-{job_hex[:8]}-{os.getpid()}.log",
            ),
            job=job_hex,
        )
    atexit.register(shutdown)
    return RuntimeContext(global_worker)


def _start_head(
    num_cpus=None,
    num_gpus=None,
    resources=None,
    object_store_memory=None,
    system_config=None,
) -> Tuple[str, int]:
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    gpus = num_gpus if num_gpus is not None else _detect_gpus()
    if gpus:
        res[RayConfig.gpu_resource_name] = float(gpus)
    session_dir = os.path.join(
        session_root(), f"session_{int(time.time() * 1000)}_{os.getpid()}"
    )
    os.makedirs(session_dir, exist_ok=True)
    global_worker.session_dir = session_dir
    cmd = [
        sys.executable,
        "-m",
        "ray_tpu_torch.gcs.head_main",
        "--session-dir",
        session_dir,
        "--resources",
        json.dumps(res),
    ]
    if object_store_memory:
        cmd += ["--object-store-memory", str(object_store_memory)]
    env = dict(os.environ)
    if system_config:
        env["RAY_TPU_SYSTEM_CONFIG"] = json.dumps(system_config)
    log_path = os.path.join(session_dir, "head.log")
    with open(log_path, "ab") as logf:
        # the child holds its own dup of the fd; keeping ours open would
        # leak one fd per init() for the life of the driver
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=logf, start_new_session=True
        )
    global_worker.head_proc = proc
    # wait for "PORT <n>"
    deadline = time.time() + 30
    line = b""
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith(b"PORT "):
            return "127.0.0.1", int(line.split()[1])
        if proc.poll() is not None:
            break
        time.sleep(0.01)
    raise RuntimeError(
        f"head process failed to start (see {log_path}): {line.decode(errors='replace')}"
    )


def shutdown():
    """Tear down the driver connection and the head we own
    (reference: worker.py:1567)."""
    cw = global_worker.core_worker
    if cw is not None:
        from ray_tpu_torch._private import log_plane

        log_plane.uninstall()  # unwind the driver tee; no-op otherwise
        sink = getattr(global_worker, "driver_log_sink", None)
        if sink is not None:
            sink.flush()  # surface any pending "repeated N×" collapse
            global_worker.driver_log_sink = None
        try:
            cw.disconnect()
        except Exception:  # noqa: BLE001
            import traceback

            traceback.print_exc(file=sys.stderr)
        global_worker.core_worker = None
    proc = global_worker.head_proc
    if proc is not None:
        try:
            proc.terminate()
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            # a wedged (or SIGSTOPped) head ignores SIGTERM: escalate to
            # SIGKILL and REAP, so no zombie outlives the driver — with a
            # structured breadcrumb, since an escalation here usually means
            # the head was already sick
            print(
                json.dumps(
                    {
                        "event": "head_shutdown_escalated",
                        "pid": proc.pid,
                        "signal": "SIGKILL",
                        "after_timeout_s": 5,
                    }
                ),
                file=sys.stderr,
            )
            try:
                proc.kill()
                proc.wait(timeout=5)
            except (subprocess.TimeoutExpired, OSError):
                print(
                    json.dumps({"event": "head_unreapable", "pid": proc.pid}),
                    file=sys.stderr,
                )
        except OSError:
            pass  # already gone
        global_worker.head_proc = None
    global_worker.mode = None
    atexit.unregister(shutdown)


def is_initialized() -> bool:
    return global_worker.connected


def _require_connected():
    if not global_worker.connected:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return global_worker.core_worker


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None
) -> Any:
    cw = _require_connected()
    if isinstance(refs, ObjectRef):
        return cw.get([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("ray_tpu_torch.get() accepts an ObjectRef or a list of ObjectRefs")
        return cw.get(list(refs), timeout)
    raise TypeError(f"cannot get() {type(refs)}")


def put(value: Any, *, tier: Optional[str] = None) -> ObjectRef:
    """``tier``: None or "host" (serialize→shm).  "device" (a CUDA-resident
    object tier) is not ported yet and raises NotImplementedError."""
    cw = _require_connected()
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed (reference parity)")
    if tier not in (None, "device", "host"):
        raise ValueError(f"tier must be None, 'device', or 'host', got {tier!r}")
    return cw.put(value, tier=tier)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    cw = _require_connected()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > len(refs)")
    return cw.wait(list(refs), num_returns, timeout, fetch_local)


def kill(actor_handle, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    cw = _require_connected()
    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    cw.kill_actor(actor_handle._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    cw = _require_connected()
    cw.cancel_task(ref.task_id().binary(), force)


def get_actor(name: str, namespace: str = ""):
    from ray_tpu_torch.actor import ActorHandle

    cw = _require_connected()
    reply = cw.get_named_actor(name, namespace)
    if not reply.get("found"):
        raise ValueError(f"Failed to look up actor with name '{name}'")
    from ray_tpu_torch._private.task_spec import TaskSpec

    spec = TaskSpec.from_wire(reply["creation_spec"])
    return ActorHandle._from_spec(spec, cw)
