"""WorkerGroup: a gang of training worker actors.

Analog of the reference's WorkerGroup (reference:
python/ray/train/_internal/worker_group.py:91 WorkerGroup, :185 start —
BaseWorkerMixin actors that execute arbitrary callables).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch


class TrainWorker:
    """The actor body: executes callables shipped from the driver and hosts
    the per-worker train session (reference: BaseWorkerMixin)."""

    def __init__(self, world_rank: int, world_size: int):
        self.world_rank = world_rank
        self.world_size = world_size
        self.session = None
        self._train_dag = None  # _WorkerTrainState (train/torch/step_dag.py)
        self._env: Dict[str, Any] = {}

    def execute(self, fn, *args, **kwargs):
        return fn(self, *args, **kwargs)

    # -- resident train-step DAG (ray_tpu_torch/train/torch/step_dag.py) --
    # dag_shard / dag_step / dag_fold are the compiled-DAG stage methods
    # (bound via actor.method.bind at compile); dag_tick is the preserved
    # eager path over the same stage functions; build/snapshot/finish are
    # eager control calls.  All logic lives in step_dag — these are the
    # bindable actor-method surface.

    def dag_train_build(self, spec, checkpoint, start_step):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_build(self, spec, checkpoint, start_step)

    def dag_shard(self, idx):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_shard(self, idx)

    def dag_step(self, idx):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_step(self, idx)

    def dag_fold(self, idx):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_fold(self, idx)

    def dag_tick(self, idx):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_tick(self, idx)

    def dag_train_snapshot(self):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_snapshot(self)

    def dag_train_finish(self):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_finish(self)

    def dag_train_records(self):
        from ray_tpu_torch.train.torch import step_dag

        return step_dag.worker_records(self)

    def set_env(self, **kv):
        self._env.update(kv)
        import os

        for k, v in kv.items():
            os.environ[str(k)] = str(v)

    def ping(self):
        return "ok"


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_group=None,
    ):
        self.num_workers = num_workers
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        self.workers = []
        for rank in range(num_workers):
            opts: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1),
                "resources": {
                    k: v for k, v in resources_per_worker.items() if k not in ("CPU",)
                },
            }
            if placement_group is not None:
                opts["placement_group"] = placement_group
                opts["placement_group_bundle_index"] = rank
            self.workers.append(actor_cls.options(**opts).remote(rank, num_workers))

    def execute(self, fn: Callable, *args, timeout: Optional[float] = 600, **kwargs) -> List[Any]:
        """Run fn(worker_self, *args) on every worker, gathering results."""
        refs = [w.execute.remote(fn, *args, **kwargs) for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, timeout: Optional[float] = 600, **kwargs):
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs), timeout=timeout)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []

    def __len__(self):
        return self.num_workers
