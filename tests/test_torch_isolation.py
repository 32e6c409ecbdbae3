"""ray_tpu_torch stands alone: no JAX, nothing of ray_tpu, CUDA by default.

- An AST scan of the port's sources and chip_smoke.py finds no import of
  jax/jaxlib or of ray_tpu (ray_tpu_torch itself is allowed).
- A fresh interpreter that imports every ray_tpu_torch module adds no jax or
  ray_tpu module to sys.modules.
- With no CUDA device, the default-device entry points raise instead of
  running on the CPU.
"""

import ast
import os
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
    assert int(n_port) >= 10 and bad.strip() == "[]", out.stdout


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
