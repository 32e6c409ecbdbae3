"""ray_tpu_torch stands alone: no JAX, nothing of ray_tpu, CUDA by default.

- An AST scan of the port's sources and chip_smoke.py finds no import of
  jax/jaxlib or of ray_tpu (ray_tpu_torch itself is allowed), no string
  constant that names a ray_tpu module (a `-m ray_tpu.core.worker_main` left
  in a copied spawn would start the JAX package's worker) or the JAX
  package's session root, and no ray_tpu_torch import or module-path string
  that does not resolve to a file of the port.
- A fresh interpreter that imports every ray_tpu_torch module adds no jax or
  ray_tpu module to sys.modules.
- With no CUDA device, the default-device entry points raise instead of
  running on the CPU.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _constants(tree):
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _port_file(module: str):
    path = ROOT.joinpath(*module.split("."))
    for cand in (path / "__init__.py", path.with_suffix(".py")):
        if cand.is_file():
            return cand
    return None


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_ray_tpu_module(path):
    bad = [c for c in _constants(ast.parse(path.read_text(), filename=str(path)))
           if c.startswith("ray_tpu.") or c.rstrip("/") == "/tmp/ray_tpu"]
    assert not bad, f"{path} names {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_fixed_temp_path(path):
    """Files the port writes live under tempfile.gettempdir(), which
    honours TMPDIR, so two checkouts on one machine never share them."""
    bad = [c for c in _constants(ast.parse(path.read_text(), filename=str(path)))
           if c.startswith(("/tmp", "/var/tmp", "/dev/shm"))]
    assert not bad, f"{path} writes under a fixed path: {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_every_port_import_resolves_to_the_port(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = list(path.relative_to(ROOT).parts[:-1])  # the package a relative import starts from
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(pkg[: len(pkg) - node.level + 1] + ([node.module] if node.module else []))
            named.append(base)
            # `from pkg import sub` may name a submodule
            named += [f"{base}.{a.name}" for a in node.names if _port_file(f"{base}.{a.name}")]
    # module paths spelled as strings (`-m ray_tpu_torch.core.worker_main`)
    named += [c for c in _constants(tree) if re.fullmatch(r"ray_tpu_torch(\.\w+)+", c)]
    missing = sorted({m for m in named if m.split(".")[0] == "ray_tpu_torch" and _port_file(m) is None})
    assert not missing, f"{path} names modules the port lacks: {missing}"


def test_importing_every_module_loads_no_jax():
    code = """
import pkgutil, importlib, sys
before = set(sys.modules)
import ray_tpu_torch
for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
print(len([m for m in new if m.startswith("ray_tpu_torch")]), bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_port, bad = out.stdout.split(" ", 1)
    assert int(n_port) >= 75 and bad.strip() == "[]", out.stdout


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step, synthetic_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPT2Config.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT2Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(GPT2Model(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_batch(torch.Generator(), 2, 8, 16)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_control_plane_imports_no_torch():
    """The serve controller and HTTP proxy run in pool workers, as CPU
    actors: the serve package they import (api, controller, handle,
    batching, schema, tracing) and the state API load no torch; only
    `serve.llm`, which a replica imports, does."""
    code = """
import sys
import ray_tpu_torch.serve, ray_tpu_torch.serve.controller, ray_tpu_torch.serve.handle
import ray_tpu_torch.serve.tracing, ray_tpu_torch.experimental.state
print("torch" in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


STEP_DAG_MODULES = (
    "ray_tpu_torch.dag",
    "ray_tpu_torch.dag.node",
    "ray_tpu_torch.dag.channel",
    "ray_tpu_torch.dag.executor",
    "ray_tpu_torch.dag.compiled",
    "ray_tpu_torch.train.torch.step_dag",
)


def test_step_dag_modules_stand_alone():
    """The compiled DAGs and the step DAG are among the sources scanned
    above, and importing them, as a worker does on its first DAG_SETUP and
    a driver on compile, loads no jax or ray_tpu module (the JAX package's
    executor imports that package's analyzer, graftsan; the port's does
    not)."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in STEP_DAG_MODULES:
        assert str(_port_file(mod).relative_to(ROOT)) in scanned, mod
    code = f"""
import importlib, sys
for m in {STEP_DAG_MODULES!r}:
    importlib.import_module(m)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
