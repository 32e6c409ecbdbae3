"""TorchConfig backend: the worker-group setup of `TorchTrainer`.

The reference's torch backend picks MASTER_ADDR/PORT on rank 0 and calls
torch.distributed.init_process_group("nccl") on every worker actor
(reference: python/ray/train/torch/config.py:69,120-174).  Here, as in the
JAX package's backend, there is one regime so far:

- single host, N worker actors: each actor is its own process; cross-actor
  gradient DP uses the `dcn` collective ring (ray_tpu_torch.util.collective),
  joined here at on_start, exactly where torch ran init_process_group.

The multi-process device regime (an NCCL process group spanning the
workers' cards, the analog of the JAX package's `use_jax_distributed` pod
regime) comes with multi-GPU (ROADMAP, Queue 1).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ray_tpu_torch.train.backend import Backend, BackendConfig

TRAIN_GROUP = "_train_dp"


def _join_collective(worker, world_size, rank, backend, group_name, nonce=""):
    from ray_tpu_torch.util.collective import init_collective_group

    init_collective_group(
        world_size, rank, backend=backend, group_name=group_name,
        rendezvous_nonce=nonce,
    )
    return True


def _leave_collective(worker, group_name):
    from ray_tpu_torch.util.collective import destroy_collective_group

    try:
        destroy_collective_group(group_name)
    except Exception:
        pass
    return True


@dataclass
class TorchConfig(BackendConfig):
    collective_backend: str = "dcn"  # cross-actor grad reduction transport
    group_name: str = TRAIN_GROUP
    # Drive a TrainStepSpec through the gang-scheduled resident DAG loop
    # (train/torch/step_dag.py): per-step driver cost is one channel write,
    # host input pipelines double-buffer against device compute.  False
    # keeps the eager per-step actor-call path over the SAME spec
    # functions (the bit-identical reference).  Ignored for classic
    # train_loop_per_worker trainers.
    use_step_dag: bool = False

    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    def on_start(self, worker_group, config: TorchConfig):
        n = len(worker_group)
        if n > 1:
            import ray_tpu_torch

            # per-incarnation rendezvous nonce: a RESPAWNED gang (the
            # classic restart path) must never rendezvous against the
            # addr/token KV entries its dead predecessor left under the
            # same group name
            nonce = os.urandom(8).hex()
            refs = [
                w.execute.remote(
                    _join_collective, n, rank, config.collective_backend,
                    config.group_name, nonce,
                )
                for rank, w in enumerate(worker_group.workers)
            ]
            ray_tpu_torch.get(refs, timeout=300)

    def on_shutdown(self, worker_group, config: TorchConfig):
        if len(worker_group) > 1:
            try:
                worker_group.execute(_leave_collective, config.group_name, timeout=30)
            except Exception:
                pass
