"""Checkpoint: one object interconvertible between dict / directory / bytes
/ object ref.

Analog of the reference's air.Checkpoint (reference:
python/ray/air/checkpoint.py — from_dict/to_dict:849-total,
from_directory/to_directory, from_object_ref).  The extra:
`from_pytree`/`to_pytree` store a nested dict/list/tuple of tensors (a
state dict, an optimizer state) with every tensor detached and on the CPU,
so the checkpoint pickles out of band and never holds device memory.
"""

from __future__ import annotations

import io
import os
import pickle
import shutil
import tarfile
import tempfile
from typing import Any, Dict, Optional


def _to_host(tree: Any) -> Any:
    """`tree` with every torch.Tensor leaf copied, detached, to the CPU."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)  # a snapshot, not a view
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpoint:
    def __init__(self, data: Optional[dict] = None, directory: Optional[str] = None):
        self._data = data
        self._dir = directory

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls(data=pickle.loads(blob))

    @classmethod
    def from_pytree(cls, tree: Any, **extra) -> "Checkpoint":
        """Checkpoint of a nested dict/list/tuple whose tensor leaves are
        kept as detached CPU tensors (device tensors pulled to host)."""
        return cls(data={"__pytree__": _to_host(tree), **extra})

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        import ray_tpu_torch

        return cls(data=ray_tpu_torch.get(ref))

    # -- converters ----------------------------------------------------------

    def to_dict(self) -> dict:
        if self._data is not None:
            return self._data
        # Walk the whole tree (orbax-style layouts are nested); keys are
        # "/"-joined paths relative to the checkpoint root.
        out = {}
        for dirpath, _, filenames in os.walk(self._dir):
            rel = os.path.relpath(dirpath, self._dir)
            for name in filenames:
                key = name if rel == "." else "/".join([*rel.split(os.sep), name])
                with open(os.path.join(dirpath, name), "rb") as f:
                    out[key] = f.read()
        return out

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.to_dict())

    def to_pytree(self):
        data = self.to_dict()
        if "__pytree__" in data:
            return data["__pytree__"]
        raise ValueError("checkpoint does not carry a pytree")

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._dir is not None:
            if os.path.abspath(self._dir) != os.path.abspath(path):
                shutil.copytree(self._dir, path, dirs_exist_ok=True)
            return path
        with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
            pickle.dump(self._data, f)
        return path

    def to_object_ref(self):
        import ray_tpu_torch

        return ray_tpu_torch.put(self.to_dict())

    # -- misc ----------------------------------------------------------------

    def __getitem__(self, key):
        return self.to_dict()[key]

    def get(self, key, default=None):
        return self.to_dict().get(key, default)

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._dir}"
        return f"Checkpoint({kind})"
