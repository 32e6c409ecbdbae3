"""BaseTrainer + DataParallelTrainer.

Analog of the reference's trainer stack (reference:
python/ray/train/base_trainer.py:339 fit, train/data_parallel_trainer.py:52
DataParallelTrainer → BackendExecutor → WorkerGroup → Backend.on_start →
per-worker sessions).  The reference routes fit() through Tune
(base_trainer.py:339-365 as_trainable); we run the executor directly.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.backend_executor import BackendExecutor
from ray_tpu_torch.train.backend import BackendConfig


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap into a Tune Trainable (reference: base_trainer.py:365).
        Tune is not ported yet."""
        raise NotImplementedError("Tune is not ported yet (ROADMAP, Queue 1)")


class DataParallelTrainer(BaseTrainer):
    """Runs `train_loop_per_worker` on N worker actors
    (reference: data_parallel_trainer.py:52)."""

    def __init__(
        self,
        train_loop_per_worker: Optional[Callable] = None,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        train_step_spec=None,  # TrainStepSpec (train/torch/step_dag.py)
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        if (train_loop_per_worker is None) == (train_step_spec is None):
            raise ValueError(
                "pass exactly one of train_loop_per_worker (the classic "
                "session loop) or train_step_spec (the per-step spec the "
                "resident DAG / eager step paths both drive)"
            )
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.train_step_spec = train_step_spec
        self.backend_config = backend_config or BackendConfig()
        self.datasets = datasets or {}

    def fit(self) -> Result:
        self._check_placeable()
        if self.train_step_spec is not None:
            # spec-driven training owns its own gang-granular restart loop
            # (checkpoint-respawn at exact step boundaries)
            from ray_tpu_torch.train.torch.step_dag import fit_spec

            return fit_spec(self)
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        latest_checkpoint: Optional[Checkpoint] = self.resume_from_checkpoint
        while True:
            try:
                return self._fit_once(latest_checkpoint)
            except RuntimeError as e:
                attempt += 1
                if attempt > max_failures:
                    raise
                # elastic recovery at group granularity: rebuild the whole
                # worker gang and resume from the last checkpoint
                # (reference: backend_executor.py:462,512 _restart)
                time.sleep(1.0)

    def _check_placeable(self):
        """Fail at once, not after the placement group's timeout, when the
        workers ask for a GPU and the cluster has none."""
        from ray_tpu_torch._private.config import RayConfig
        from ray_tpu_torch._private.worker import _require_connected

        key = RayConfig.gpu_resource_name
        want = self.scaling_config.worker_resources().get(key, 0)
        if not want:
            return
        have = _require_connected().cluster_resources().get(key, 0)
        if have < want:
            raise RuntimeError(
                f"ScalingConfig(use_gpu=True) asks {want:g} {key} per worker, "
                f"but the cluster has {have:g}: start it where a CUDA device is "
                "visible (or pass num_gpus to init), or pass use_gpu=False to "
                "train on CPU workers"
            )

    def _fit_once(self, checkpoint: Optional[Checkpoint]) -> Result:
        executor = BackendExecutor(
            self.backend_config, self.scaling_config, self.run_config.failure_config
        )
        metrics_history = []
        last_metrics: Dict[str, Any] = {}
        last_checkpoint = checkpoint
        try:
            executor.start()
            executor.start_training(self.train_loop, self.train_loop_config, checkpoint)
            while True:
                round_results = executor.get_next_results()
                if round_results is None:
                    break
                reports = [p for kind, p in round_results if kind == "report"]
                if not reports:
                    continue
                # rank-0's metrics are the canonical row (reference behavior)
                metrics, ckpt_data = reports[0]
                metrics_history.append(metrics)
                last_metrics = metrics
                for m, cd in reports:
                    if cd is not None:
                        last_checkpoint = Checkpoint.from_dict(cd)
            return Result(
                metrics=last_metrics,
                checkpoint=last_checkpoint,
                metrics_history=metrics_history,
            )
        finally:
            executor.shutdown()


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch backend default (reference:
    train/torch/torch_trainer.py:208).  Workers claim a GPU unless
    ``ScalingConfig(use_gpu=False)``."""

    def __init__(self, train_loop_per_worker: Optional[Callable] = None, **kwargs):
        from ray_tpu_torch.train.torch.config import TorchConfig

        kwargs.setdefault("backend_config", TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)
