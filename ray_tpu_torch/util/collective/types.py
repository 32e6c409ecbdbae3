"""Collective op descriptors (analog: reference
python/ray/util/collective/types.py — ReduceOp, AllReduceOptions, …)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "prod"
    MIN = "min"
    MAX = "max"


class Backend:
    """Backend names.  The reference ships NCCL/GLOO
    (collective_group/nccl_collective_group.py, gloo_collective_group.py);
    here the pair is ICI (the in-process device backend, not ported yet:
    NCCL comes with multi-GPU) and DCN (cross-process TCP ring)."""

    ICI = "ici"
    DCN = "dcn"
    # aliases accepted for reference-compat call sites
    NCCL = "ici"
    GLOO = "dcn"

    @staticmethod
    def resolve(name: str) -> str:
        name = (name or "dcn").lower()
        mapping = {"ici": "ici", "nccl": "ici", "dcn": "dcn", "gloo": "dcn", "tcp": "dcn"}
        if name not in mapping:
            raise ValueError(f"unknown collective backend {name!r}")
        return mapping[name]


@dataclass
class GroupInfo:
    group_name: str
    world_size: int
    rank: int
    backend: str
