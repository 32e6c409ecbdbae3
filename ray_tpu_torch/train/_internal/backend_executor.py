"""BackendExecutor: PG + WorkerGroup + backend setup + training drive loop.

Analog of the reference's BackendExecutor (reference:
python/ray/train/_internal/backend_executor.py — start:93,
_create_placement_group:137, start_training:275, get_next_results:362,
restart-on-failure :462,512).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, ScalingConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group


def _start_session(worker, train_loop, config, ckpt):
    from ray_tpu_torch.train._internal.session import TrainSession

    worker.session = TrainSession(
        train_loop,
        config,
        world_rank=worker.world_rank,
        world_size=worker.world_size,
        loaded_checkpoint=Checkpoint.from_dict(ckpt) if ckpt else None,
    )
    return True


def _poll_session(worker, timeout):
    if worker.session is None:
        return ("error", "session not started")
    return worker.session.next_report(timeout)


class BackendExecutor:
    def __init__(
        self,
        backend_config,
        scaling_config: ScalingConfig,
        failure_config: Optional[FailureConfig] = None,
    ):
        self.backend_config = backend_config
        self.scaling = scaling_config
        self.failure_config = failure_config or FailureConfig()
        self.worker_group: Optional[WorkerGroup] = None
        self.pg = None
        self._restarts = 0

    def start(self):
        bundles = self.scaling.as_placement_group_bundles()
        self.pg = placement_group(bundles, strategy=self.scaling.placement_strategy)
        if not self.pg.ready(timeout=120):
            remove_placement_group(self.pg)
            raise TimeoutError(
                f"placement group for {self.scaling.num_workers} train workers "
                f"({bundles[0]} each) not placeable"
            )
        self.worker_group = WorkerGroup(
            self.scaling.num_workers, self.scaling.worker_resources(), self.pg
        )
        backend = self.backend_config.backend_cls()(self.backend_config)
        backend.on_start(self.worker_group, self.backend_config)
        self._backend = backend

    def start_training(
        self,
        train_loop: Callable,
        config: Dict[str, Any],
        checkpoint: Optional[Checkpoint] = None,
    ):
        ckpt_data = checkpoint.to_dict() if checkpoint else None
        self.worker_group.execute(_start_session, train_loop, config, ckpt_data)

    def get_next_results(self, timeout: float = 600.0) -> Optional[List[tuple]]:
        """One synchronized round of per-worker events; None once all done
        (reference: get_next_results backend_executor.py:362)."""
        results = self.worker_group.execute(_poll_session, timeout, timeout=timeout + 30)
        if all(kind == "done" for kind, _ in results):
            return None
        for kind, payload in results:
            if kind == "error":
                raise RuntimeError(f"training worker failed:\n{payload}")
        return results

    def shutdown(self):
        backend = getattr(self, "_backend", None)
        if backend is not None and self.worker_group is not None:
            try:
                backend.on_shutdown(self.worker_group, self.backend_config)
            except Exception:
                pass
        if self.worker_group is not None:
            self.worker_group.shutdown()
            self.worker_group = None
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
