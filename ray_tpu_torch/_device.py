"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """`device` as a `torch.device`.  CUDA is the default; it raises when no
    CUDA device is present instead of running on the CPU.  The CPU is used
    only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch: a CUDA device was requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"ray_tpu_torch runs on 'cuda' or 'cpu', not {dev.type!r}")
    return dev
