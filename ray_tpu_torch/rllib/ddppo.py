"""DDPPO: decentralized distributed PPO — no central learner.

The port of the JAX package's `rllib/ddppo.py` (reference:
rllib/algorithms/ddppo/ddppo.py:92,226,271,289 — each rollout worker runs
its own SGD with a torch.distributed allreduce inside the worker; the
driver only coordinates rounds and aggregates metrics).  The out-of-band
allreduce is the port's collective library: the worker actors (CPU
actors, as in the JAX package: this path has no device code) join a dcn
ring group (head-KV rendezvous) and synchronize per-minibatch gradients
themselves; weights never cross the driver.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, make_workers


@dataclass
class DDPPOConfig(AlgorithmConfig):
    collective_backend: str = "dcn"

    def build(self) -> "DDPPO":
        return DDPPO(self)


class DDPPO(Algorithm):
    def __init__(self, config: DDPPOConfig):
        super().__init__(config)
        from ray_tpu_torch.util.collective import create_collective_group

        policy_config = config.policy_config()
        # SAME policy seed everywhere: identical initial params + identical
        # allreduced updates = permanently synchronized replicas
        self.workers = make_workers(
            config,
            policy_config,
            [{"seed": config.seed, "env_seed": config.seed + 1000 * (i + 1)} for i in range(config.num_rollout_workers)],
        )
        # unique per instance: a reused name would let fresh ranks read a
        # DEAD run's rendezvous keys (stale addr/token) out of the head KV
        self._group = f"_ddppo_{uuid.uuid4().hex[:8]}"
        create_collective_group(
            self.workers,
            world_size=len(self.workers),
            ranks=list(range(len(self.workers))),
            backend=config.collective_backend,
            group_name=self._group,
        )

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        steps_per_worker = max(
            cfg.rollout_fragment_length,
            cfg.train_batch_size // max(len(self.workers), 1),
        )
        # every worker MUST run the same schedule — the in-worker
        # allreduces are a barrier per minibatch
        results = ray_tpu_torch.get(
            [
                w.learn_local.remote(
                    steps_per_worker,
                    self._group,
                    sgd_minibatch_size=cfg.sgd_minibatch_size,
                    num_sgd_iter=cfg.num_sgd_iter,
                    seed=cfg.seed + self.iteration,
                )
                for w in self.workers
            ],
            timeout=600,
        )
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_this_iter": int(sum(r["timesteps"] for r in results)),
            "episode_reward_mean": float(
                np.mean([r["episode_reward_mean"] for r in results if r["episodes"] > 0] or [0.0])
            ),
            "episodes_total": int(sum(r["episodes"] for r in results)),
            "time_this_iter_s": time.time() - t0,
            "total_loss": float(np.mean([r.get("total_loss", 0.0) for r in results])),
        }

    def stop(self):
        super().stop()
        # reclaim the rendezvous keys (workers are gone; nobody else will)
        try:
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod._require_connected().kv_del(f"collective:{self._group}:", prefix=True)
        except Exception:  # noqa: BLE001 — best effort: the cluster may be gone
            pass
