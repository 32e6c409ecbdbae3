"""Run/scaling/failure configs (analog: reference python/ray/air/config.py
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    # the reference's use_gpu; True by default because the port runs on
    # the card unless asked otherwise (use_gpu=False: CPU pool workers)
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # GPUs per worker actor (one card owns all of a worker's work today)
    gpus_per_worker: int = 1

    def worker_resources(self) -> Dict[str, float]:
        from ray_tpu_torch._private.config import RayConfig

        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault(RayConfig.gpu_resource_name, float(self.gpus_per_worker))
        return res

    def as_placement_group_bundles(self):
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
