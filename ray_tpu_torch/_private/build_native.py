"""Build + load native components on demand.

The native pieces live in ``ray_tpu_torch/src/`` (C++, the package's own
copies of the object store and the scheduler) and are compiled once into
``ray_tpu_torch/_native/`` with a content-hash stamp so a source edit
triggers a rebuild.  No build system needed beyond g++ — single-TU libraries.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_ROOT, "_native")
_LOCK = threading.Lock()

_LIBS = {
    "store": {
        "sources": [os.path.join(_PKG_ROOT, "src", "object_store", "store.cc")],
        "flags": ["-lpthread"],
    },
    "scheduler": {
        "sources": [os.path.join(_PKG_ROOT, "src", "scheduler", "scheduler.cc")],
        "flags": ["-lpthread"],
    },
}


def _digest(paths) -> str:
    h = hashlib.sha1()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def ensure_lib(name: str) -> str:
    """Compile (if stale) and return the path to libray_tpu_torch_<name>.so."""
    spec = _LIBS[name]
    with _LOCK:
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        so_path = os.path.join(_NATIVE_DIR, f"libray_tpu_torch_{name}.so")
        stamp_path = so_path + ".stamp"
        digest = _digest(spec["sources"])
        if os.path.exists(so_path) and os.path.exists(stamp_path):
            with open(stamp_path) as f:
                if f.read().strip() == digest:
                    return so_path
        # Compile to a temp path and rename: concurrent processes (head +
        # freshly spawned workers) may race the first build, and dlopen of a
        # half-written .so would crash.  rename() is atomic on the same fs.
        tmp_path = f"{so_path}.{os.getpid()}.tmp"
        cmd = (
            ["g++", "-O2", "-g", "-shared", "-fPIC", "-std=c++17", "-o", tmp_path]
            + spec["sources"]
            + spec["flags"]
        )
        # graftsan: disable=GS002 -- serializing the one-time native build under _LOCK is the point: every caller needs the finished .so before proceeding
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp_path, so_path)
        with open(stamp_path, "w") as f:
            f.write(digest)
        return so_path
