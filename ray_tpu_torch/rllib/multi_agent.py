"""Multi-agent envs + multi-policy PPO.

Analog of the reference's multi-agent stack (reference:
rllib/env/multi_agent_env.py:30 MultiAgentEnv — dict-keyed obs/action/
reward per agent, "__all__" done flag — and the per-policy batch routing
in rllib/evaluation/sample_batch_builder.py + policy_map).  Each policy
is a full TorchPolicy; a ``policy_mapping_fn`` routes agents to policies;
rollouts produce one SampleBatch per policy and the trainer updates each
on its own data.  The port of the JAX package's `rllib/multi_agent.py`:
the learners live in the driver on `AlgorithmConfig.learner_device`, the
rollout workers' policies on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, episode_summary
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VALUES,
    SampleBatch,
)


class MultiAgentEnv:
    """Interface: reset() -> ({agent: obs}, info); step({agent: action})
    -> ({agent: obs}, {agent: reward}, {agent: done, "__all__": bool},
    info).  Agents may come and go between steps."""

    observation_spaces: Dict[str, Any]
    action_spaces: Dict[str, Any]

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentRolloutWorker:
    """Steps a MultiAgentEnv with one policy per policy-id, routing each
    agent through policy_mapping_fn; emits per-POLICY batches.  Its
    policies act on the CPU with ``num_threads`` torch threads."""

    def __init__(
        self,
        env_creator: Callable[[], MultiAgentEnv],
        policy_specs: Dict[str, dict],  # policy_id -> TorchPolicy kwargs
        policy_mapping_fn: Callable[[str], str],
        seed: int = 0,
        num_threads: int = 1,
    ):
        import torch

        torch.set_num_threads(max(1, int(num_threads)))
        self.env = env_creator()
        self.mapping = policy_mapping_fn
        self.policies: Dict[str, TorchPolicy] = {
            pid: TorchPolicy(seed=seed + i, device="cpu", **spec)
            for i, (pid, spec) in enumerate(sorted(policy_specs.items()))
        }
        self._obs, _ = self.env.reset(seed=seed)
        self.gamma = 0.99
        self.lam = 0.95
        self.episode_rewards: List[float] = []
        self._ep_reward = 0.0

    def sample(self, num_steps: int) -> Dict[str, SampleBatch]:
        # trajectories are PER AGENT: GAE bootstraps values along one
        # agent's timeline, so interleaving agents sharing a policy would
        # corrupt the targets — rows key on (policy, agent) and only the
        # post-GAE batches concatenate per policy
        rows: Dict[tuple, Dict[str, list]] = {}

        def agent_rows(pid, aid):
            key = (pid, aid)
            if key not in rows:
                rows[key] = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VALUES)}
            return rows[key]

        for _ in range(num_steps):
            actions: Dict[str, Any] = {}
            acted: Dict[str, tuple] = {}
            for aid, obs in self._obs.items():
                pid = self.mapping(aid)
                a, logp, v = self.policies[pid].compute_actions(
                    np.asarray(obs, np.float32)[None]
                )
                actions[aid] = int(a[0])
                acted[aid] = (pid, obs, int(a[0]), float(logp[0]), float(v[0]))
            next_obs, rewards, dones, _info = self.env.step(actions)
            for aid, (pid, obs, a, logp, v) in acted.items():
                r = agent_rows(pid, aid)
                r[OBS].append(np.asarray(obs, np.float32))
                r[ACTIONS].append(a)
                r[REWARDS].append(float(rewards.get(aid, 0.0)))
                r[DONES].append(bool(dones.get(aid, False)))
                r[LOGPS].append(logp)
                r[VALUES].append(v)
            self._ep_reward += float(sum(rewards.values()))
            if dones.get("__all__"):
                self.episode_rewards.append(self._ep_reward)
                self._ep_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = next_obs
        per_policy: Dict[str, list] = {}
        for (pid, _aid), r in rows.items():
            if not r[OBS]:
                continue
            batch = SampleBatch({k: np.asarray(v) for k, v in r.items()})
            per_policy.setdefault(pid, []).append(
                compute_gae(batch, 0.0, self.gamma, self.lam)
            )
        return {
            pid: SampleBatch.concat_samples(batches)
            for pid, batches in per_policy.items()
        }

    def set_weights(self, weights: Dict[str, Any]):
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)
        return True

    def episode_stats(self, last_n: int = 20):
        recent = self.episode_rewards[-last_n:]
        return {
            "episodes": len(self.episode_rewards),
            "episode_reward_mean": float(np.mean(recent)) if recent else 0.0,
        }


@dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    # policy_id -> TorchPolicy kwargs (obs_shape/num_actions/lr/...), no device
    policies: Dict[str, dict] = field(default_factory=dict)
    policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, policies: Dict[str, dict], policy_mapping_fn) -> "MultiAgentPPOConfig":
        self.policies = policies
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO(Algorithm):
    def __init__(self, config: MultiAgentPPOConfig):
        super().__init__(config)
        if not config.policies:
            raise ValueError("multi_agent(policies=...) is required")
        self.policies = {
            pid: TorchPolicy(seed=config.seed + i, device=config.learner_device, **spec)
            for i, (pid, spec) in enumerate(sorted(config.policies.items()))
        }
        worker_cls = ray_tpu_torch.remote(MultiAgentRolloutWorker).options(num_cpus=config.num_cpus_per_worker)
        self.workers = [
            worker_cls.remote(
                config.env_creator,
                config.policies,
                config.policy_mapping_fn,
                seed=config.seed + 100 * i,
                num_threads=config.num_cpus_per_worker,
            )
            for i in range(config.num_rollout_workers)
        ]
        self._rng = np.random.default_rng(config.seed)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        weights_ref = ray_tpu_torch.put({pid: p.get_weights() for pid, p in self.policies.items()})
        ray_tpu_torch.get([w.set_weights.remote(weights_ref) for w in self.workers], timeout=300)
        per_worker = max(
            cfg.rollout_fragment_length,
            cfg.train_batch_size // max(len(self.workers), 1),
        )
        many = ray_tpu_torch.get([w.sample.remote(per_worker) for w in self.workers], timeout=600)
        metrics: Dict[str, Any] = {}
        steps = 0
        for pid, policy in self.policies.items():
            batches = [m[pid] for m in many if pid in m]
            if not batches:
                continue
            batch = SampleBatch.concat_samples(batches)
            steps += len(batch)
            adv = batch[ADVANTAGES]
            batch[ADVANTAGES] = (adv - adv.mean()) / max(adv.std(), 1e-6)
            staged = policy.load_batch(batch)
            m = policy.learn_on_loaded_batch(
                staged, cfg.num_sgd_iter, min(cfg.sgd_minibatch_size, len(batch)),
                seed=cfg.seed,
            )
            metrics[pid] = m["total_loss"]
        stats = ray_tpu_torch.get([w.episode_stats.remote() for w in self.workers], timeout=120)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_this_iter": steps,
            **episode_summary(stats),
            "time_this_iter_s": time.time() - t0,
            "policy_loss": metrics,
        }
