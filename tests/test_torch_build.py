"""The kernel builder's host-side logic (no nvcc needed).

A library is found by a hash of its source and flags, so an unchanged
source is loaded as built and an edited one is rebuilt; a missing compiler
or a failed compile raises instead of falling back.
"""

import subprocess
import types

import pytest

from ray_tpu_torch.ops import _build


def _digest_path(tmp_path, monkeypatch, source: str):
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / "k.cu").write_text(source)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")


def test_built_library_is_reused_and_edit_rebuilds(tmp_path, monkeypatch):
    _digest_path(tmp_path, monkeypatch, "// v1\n")
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").write(b"lib")
        return types.SimpleNamespace(returncode=0, stdout="ptxas info", stderr="")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    first = _build.build("k")
    assert first.exists() and len(calls) == 1
    assert "-gencode=arch=compute_90a,code=sm_90a" in calls[0]
    assert _build.build("k") == first and len(calls) == 1  # unchanged: no compile
    (tmp_path / "csrc" / "k.cu").write_text("// v2\n")
    second = _build.build("k")
    assert second != first and len(calls) == 2
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_edited_header_rebuilds_every_source_that_includes_it(tmp_path, monkeypatch):
    _digest_path(tmp_path, monkeypatch, '#include "common.cuh"\n#include <cuda.h>\n')
    csrc = tmp_path / "csrc"
    (csrc / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    (csrc / "other.cu").write_text("// includes nothing\n")
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd[-1])
        open(cmd[cmd.index("-o") + 1], "wb").write(b"lib")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    assert _build.sources(csrc / "k.cu") == [csrc / "k.cu", csrc / "common.cuh", csrc / "inner.cuh"]
    first, other = _build.build("k"), _build.build("other")
    (csrc / "inner.cuh").write_text("// v2\n")  # included through common.cuh
    assert _build.build("k") != first and _build.build("other") == other
    assert calls == [str(csrc / "k.cu"), str(csrc / "other.cu"), str(csrc / "k.cu")]


def test_failed_compile_raises_and_leaves_nothing(tmp_path, monkeypatch):
    _digest_path(tmp_path, monkeypatch, "broken\n")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(
        subprocess, "run", lambda cmd, **kw: types.SimpleNamespace(returncode=1, stdout="", stderr="error: x")
    )
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build("k")
    assert not list((tmp_path / "_build").iterdir())


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_all_runs_one_nvcc_per_source_and_keeps_reports(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    compiled = []

    def fake_nvcc(cmd, **kw):
        compiled.append(cmd[-1])
        open(cmd[cmd.index("-o") + 1], "wb").write(b"lib")
        return types.SimpleNamespace(returncode=0, stdout=f"ptxas info : Used 9 registers {cmd[-1]}", stderr="")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    libs = _build.build_all(["a", "b"])
    assert [p.name.split("-")[0] for p in libs] == ["liba", "libb"]
    assert sorted(compiled) == [str(csrc / "a.cu"), str(csrc / "b.cu")]
    assert _build.ptxas_report("b").endswith("b.cu") and len(compiled) == 2  # read, not rebuilt
