"""Rollout actor for TD3/DDPG: SACWorker's sampling loop (raw-action
storage, truncation-aware bootstrapping) with the deterministic
TD3Policy on the CPU — acting noise lives in the policy (reference
analog: the shared off-policy RolloutWorker sampling path).  The port of
the JAX package's `rllib/td3_worker.py`."""

from __future__ import annotations

from ray_tpu_torch.rllib.sac import SACWorker
from ray_tpu_torch.rllib.td3 import TD3Policy


class TD3Worker(SACWorker):
    def __init__(self, env_creator, policy_config, seed=0, num_envs: int = 1, num_threads: int = 1):
        super().__init__(
            env_creator, policy_config, seed=seed, num_envs=num_envs, policy_cls=TD3Policy,
            num_threads=num_threads,
        )
