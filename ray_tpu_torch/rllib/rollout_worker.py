"""RolloutWorker: env-stepping actor producing SampleBatches.

The port of the JAX package's `rllib/rollout_worker.py` (reference:
rllib/evaluation/rollout_worker.py:127 init, :792 sample; GAE
post-processing from rllib/evaluation/postprocessing.py
compute_advantages; vector envs rllib/env/vector_env.py:23).  One worker
steps a VectorEnv of ``num_envs`` envs per policy forward.

Rollout workers are CPU actors: pool workers see
``CUDA_VISIBLE_DEVICES=""``, so the worker builds its policy with
``device="cpu"``, and runs torch on ``num_threads`` intra-op threads (the
CPUs it was granted) instead of every core of the host, which two workers
and the learner would oversubscribe.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    RETURNS,
    REWARDS,
    VALUES,
    SampleBatch,
)


def compute_gae(batch: SampleBatch, last_value, gamma: float, lam: float) -> SampleBatch:
    """GAE over [T] (scalar) or [T, N] (vector) rollouts; ``last_value``
    is the bootstrap V of the state after the final step (scalar / [N])."""
    rewards = np.asarray(batch[REWARDS], np.float32)
    values = np.asarray(batch[VALUES], np.float32)
    dones = np.asarray(batch[DONES], np.float32)
    n = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_gae = np.zeros_like(np.asarray(last_value, np.float32))
    next_value = np.asarray(last_value, np.float32)
    for t in reversed(range(n)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    batch[ADVANTAGES] = adv
    batch[RETURNS] = adv + values
    return batch


class RolloutWorker:
    """Actor: owns a VectorEnv + a CPU policy copy for acting."""

    def __init__(
        self,
        env_creator: Callable,
        policy_config: Dict[str, Any],
        seed: int = 0,
        env_seed: Optional[int] = None,
        num_envs: int = 1,
        num_threads: int = 1,
    ):
        import torch

        from ray_tpu_torch.rllib.env import make_vector_env
        from ray_tpu_torch.rllib.policy import TorchPolicy

        torch.set_num_threads(max(1, int(num_threads)))
        self.env = make_vector_env(
            env_creator, num_envs, seed=env_seed if env_seed is not None else seed
        )
        self.num_envs = self.env.num_envs
        obs_space = self.env.observation_space
        act_space = self.env.action_space
        # DDPPO passes the SAME policy seed to every worker (identical
        # initial params are what keep decentralized updates in sync) with
        # distinct env seeds for decorrelated rollouts
        self.policy = TorchPolicy(
            obs_shape=tuple(obs_space.shape),
            num_actions=int(act_space.n),
            seed=seed,
            device="cpu",
            **policy_config,
        )
        self._obs = self.env.reset(seed=env_seed if env_seed is not None else seed)
        self.gamma = policy_config.get("gamma", 0.99)  # GAE discount
        self.lam = 0.95
        self.episode_rewards = []
        self._ep_reward = np.zeros(self.num_envs, np.float64)
        self._rollout_s = 0.0  # seconds of the last rollout

    def _rollout(self, num_steps: int):
        """num_steps PER ENV.  Returns a [T, N]-shaped batch and the [N]
        bootstrap values (squeezed to legacy flat [T] + float when N==1)."""
        t0 = time.perf_counter()
        N = self.num_envs
        rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VALUES)}
        for _ in range(num_steps):
            obs = self._obs
            action, logp, value = self.policy.compute_actions(obs)
            next_obs, rewards, dones, _infos = self.env.step(action)
            rows[OBS].append(obs)
            rows[ACTIONS].append(action)
            rows[REWARDS].append(rewards)
            rows[DONES].append(dones)
            rows[LOGPS].append(logp)
            rows[VALUES].append(value)
            self._ep_reward += rewards
            if dones.any():
                for i in np.nonzero(dones)[0]:
                    self.episode_rewards.append(float(self._ep_reward[i]))
                    self._ep_reward[i] = 0.0
            self._obs = next_obs
        batch = SampleBatch({k: np.stack(v) for k, v in rows.items()})
        # bootstrap value for each env's unfinished tail
        _, _, last_value = self.policy.compute_actions(self._obs)
        self._rollout_s = time.perf_counter() - t0
        if N == 1:
            batch = SampleBatch({k: np.asarray(v)[:, 0] for k, v in batch.items()})
            return batch, float(last_value[0])
        return batch, np.asarray(last_value, np.float32)

    def sample(self, num_steps: int) -> SampleBatch:
        """GAE-postprocessed batch, flattened to [T*N] rows for SGD."""
        batch, last_value = self._rollout(num_steps)
        batch = compute_gae(batch, last_value, self.gamma, self.lam)
        if self.num_envs > 1:
            batch = SampleBatch(
                {
                    k: np.asarray(v).reshape(-1, *np.asarray(v).shape[2:])
                    for k, v in batch.items()
                }
            )
        return batch

    def sample_fragment(self, num_steps: int):
        """IMPALA/APPO: raw time-ordered fragment + bootstrap value, no
        GAE — the learner applies V-trace with the recorded behavior
        logps.  Shape [T] (scalar env) or [T, N] (vector env)."""
        return self._rollout(num_steps)

    def learn_local(
        self,
        num_steps: int,
        group_name: str,
        sgd_minibatch_size: int = 128,
        num_sgd_iter: int = 8,
        seed: int = 0,
    ):
        """DDPPO: sample locally, then run synchronized SGD — each
        minibatch's gradients allreduce across the worker group (the dcn
        collective) before applying, so every worker steps identically with
        NO central learner (reference: rllib/algorithms/ddppo/ddppo.py:226,
        271 — torch.distributed allreduce inside the rollout worker).  Every
        worker MUST make the same number of calls per round (same
        num_steps / minibatch config) or the collective deadlocks."""
        from ray_tpu_torch.util import collective

        batch = self.sample(num_steps)
        adv = batch[ADVANTAGES]
        batch[ADVANTAGES] = (adv - adv.mean()) / max(adv.std(), 1e-6)
        world = collective.get_collective_group_size(group_name)
        rng = np.random.default_rng(seed)
        metrics = {}
        mb_size = min(sgd_minibatch_size, len(batch))
        for _ in range(num_sgd_iter):
            shuffled = batch.shuffle(rng)
            for mb in shuffled.minibatches(mb_size):
                flat, metrics = self.policy.compute_grads(mb)
                reduced = collective.allreduce(flat, group_name=group_name) / world
                self.policy.apply_flat_grads(reduced)
        return {**metrics, **self.episode_stats(), "timesteps": len(batch)}

    def set_weights(self, weights):
        self.policy.set_weights(weights)
        return True

    def set_flat_weights(self, flat):
        """Weights as ONE flat vector (the learner's `get_flat_weights`),
        unflattened into this worker's policy."""
        self.policy.set_flat_weights(flat)
        return True

    def sample_as_ref(self, num_steps: int):
        """The JAX package returns the OBS block as a device-tier ref when
        its device tier is on.  The port has no device tier (ROADMAP, Queue
        1: the device tier and GPU gauges), so this is the tier-off path there: a plain
        inline batch and no ref."""
        return dict(self.sample(num_steps)), None

    def get_weights(self):
        return self.policy.get_weights()

    def episode_stats(self, last_n: int = 20):
        recent = self.episode_rewards[-last_n:]
        return {
            "episodes": len(self.episode_rewards),
            "episode_reward_mean": float(np.mean(recent)) if recent else 0.0,
            "rollout_s": self._rollout_s,
        }

    def worker_info(self):
        return worker_info(self.policy)


def worker_info(policy) -> Dict[str, Any]:
    """What a rollout worker's process is: pid, the card it sees, its torch
    threads, its policy's device and the top-level modules it has loaded."""
    import torch

    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_available": torch.cuda.is_available(),
        "torch_threads": torch.get_num_threads(),
        "policy_device": str(policy.device),
        "modules": sorted({m.split(".")[0] for m in sys.modules}),
    }
