"""Preforked worker factory ("zygote").

Worker processes come from os.fork() out of a warm interpreter instead
of exec + cold import (reference analog: the WorkerPool's prestarted
idle workers, src/ray/raylet/worker_pool.cc:218 — theirs keeps started
PROCESSES warm; ours keeps the IMPORT warm and forks on demand, which on
a 1-core host turns ~1s/worker into ~30ms/worker — the difference
between ~1/s and tens/s actor creation).

The zygote is a single-threaded child of the raylet/head started with
the POOL env (``CUDA_VISIBLE_DEVICES=""``): it preimports the worker dependency
closure once, then serves length-prefixed JSON spawn requests on stdin:

    {"env": {...}, "log": "<path>"}  ->  fork()

The forked child applies the env, redirects stdio to the worker log,
setsids, and runs worker_main.main(); the parent replies {"pid": n}.
GPU workers never come from the zygote — a forked child cannot initialise
CUDA, so they keep the exec path.  Nothing in the zygote touches CUDA or
imports torch.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import subprocess
import sys
import threading
from typing import Dict, Optional

_LEN = struct.Struct("<I")


def zygote_main():
    # auto-reap forked workers (no zombies; nobody waits on them here)
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    # preimport the worker's heavy dependency closure ONCE.  Deliberately
    # NOT torch: its import may create helper threads, and fork() from a
    # threaded process is undefined-behavior territory — workers that use
    # torch import it after the fork, as they would under exec.
    import ray_tpu_torch  # noqa: F401
    import ray_tpu_torch.core.worker_main as worker_main

    if threading.active_count() != 1:
        print(
            f"zygote: {threading.active_count()} threads after preimport; "
            "fork safety not guaranteed",
            file=sys.stderr,
            flush=True,
        )
    inp = sys.stdin.buffer
    out = sys.stdout.buffer
    while True:
        hdr = inp.read(_LEN.size)
        if len(hdr) < _LEN.size:
            return  # parent closed the pipe: shut down
        (n,) = _LEN.unpack(hdr)
        body = inp.read(n)
        if len(body) < n:
            return
        req = json.loads(body)
        pid = os.fork()
        if pid == 0:
            try:
                os.setsid()
            except OSError:
                pass
            # clear-and-set, not update-over-base: the request carries the
            # COMPLETE intended env, and keys deliberately absent from a
            # later spawn's dict (e.g. the GPU-worker flag absent for pool
            # workers) must not be silently inherited from whatever env
            # the zygote itself was started with
            os.environ.clear()
            os.environ.update(req.get("env") or {})
            try:
                log = req.get("log")
                if log:
                    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                    os.dup2(fd, 1)
                    os.dup2(fd, 2)
                    os.close(fd)
                devnull = os.open(os.devnull, os.O_RDONLY)
                os.dup2(devnull, 0)
                os.close(devnull)
                signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                worker_main.main()
            except BaseException:  # noqa: BLE001
                import traceback

                traceback.print_exc(file=sys.stderr)
            finally:
                os._exit(0)
        payload = json.dumps({"pid": pid}).encode()
        out.write(_LEN.pack(len(payload)) + payload)
        out.flush()


class ZygoteSpawner:
    """Client side: owns one zygote process, restarts it if it dies, and
    falls back to None (caller uses exec) on any failure."""

    def __init__(self, base_env: Dict[str, str], log_path: str = ""):
        self._base_env = dict(base_env)
        self._log_path = log_path
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()

    def _start(self):
        log = open(self._log_path, "ab") if self._log_path else subprocess.DEVNULL
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.zygote"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=log,
            env=self._base_env,
            start_new_session=True,
        )
        if self._log_path:
            log.close()

    def spawn(self, env: Dict[str, str], log: str) -> Optional[int]:
        """Fork a worker; returns its pid, or None if the zygote path is
        unavailable (caller falls back to exec)."""
        with self._lock:
            try:
                if self._proc is None or self._proc.poll() is not None:
                    self._start()
                payload = json.dumps({"env": env, "log": log}).encode()
                self._proc.stdin.write(_LEN.pack(len(payload)) + payload)
                self._proc.stdin.flush()
                hdr = self._proc.stdout.read(_LEN.size)
                if len(hdr) < _LEN.size:
                    raise EOFError("zygote closed")
                (n,) = _LEN.unpack(hdr)
                reply = json.loads(self._proc.stdout.read(n))
                return int(reply["pid"])
            except Exception as e:  # noqa: BLE001
                # zygote path is an optimization: fall back to exec — but
                # audibly, because silent 30ms→1s spawn regressions hide here
                print(
                    f"zygote spawn failed ({type(e).__name__}: {e}); "
                    "falling back to exec",
                    file=sys.stderr,
                    flush=True,
                )
                try:
                    if self._proc is not None:
                        self._proc.kill()
                except OSError:
                    pass
                self._proc = None
                return None

    def stop(self):
        with self._lock:
            if self._proc is not None:
                try:
                    self._proc.stdin.close()
                    self._proc.terminate()
                except (OSError, ValueError):
                    pass  # pipe already closed / process already gone
                self._proc = None


if __name__ == "__main__":
    zygote_main()
