"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface.  No PyTorch header is included, so a build
takes seconds, not the minutes that `torch.utils.cpp_extension.load` needs.
Libraries are written to `_build/` beside this file (git-ignored), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` into `_build/` unless the same source was
    built already; returns the library's path.  The compiler's resource
    report (registers, shared memory, spills) is kept beside it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent builder or a
    # cut-off build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        (BUILD_DIR / f"lib{name}-{digest}.ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all(names: Iterable[str]) -> List[Path]:
    """`build` each of `names`, one nvcc for each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def ptxas_report(name: str) -> str:
    """The compiler's resource report kept beside the built `csrc/<name>.cu`."""
    return build(name).with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
