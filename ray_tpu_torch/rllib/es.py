"""Evolution Strategies: gradient-free, embarrassingly parallel RL.

Analog of the reference's ES (reference: rllib/algorithms/es/es.py —
Salimans et al.: antithetic Gaussian perturbations of a deterministic
policy, episode returns rank-normalized into a search-gradient update;
workers only EVALUATE, so the fan-out is pure stateless tasks).  Here
each perturbation evaluation is a ray_tpu_torch task reconstructing the noise
from a seed (the reference's shared noise table trick: seeds travel,
never perturbation vectors), and the update happens driver-side in one
vectorized numpy step.  A numpy copy of the JAX package's `rllib/es.py`
(it runs no model on the card); theta travels through the object store's
host tier, the port having no device tier.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


def _flat_policy_apply(theta: np.ndarray, obs: np.ndarray, sizes) -> np.ndarray:
    """Tiny deterministic tanh MLP over a FLAT parameter vector — the
    evaluation path must be cheap numpy (it runs inside fan-out tasks)."""
    h = obs
    off = 0
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = theta[off : off + fi * fo].reshape(fi, fo)
        off += fi * fo
        b = theta[off : off + fo]
        off += fo
        h = h @ w + b
        if i < len(sizes) - 2:
            h = np.tanh(h)
    return np.tanh(h)


def _param_count(sizes) -> int:
    return sum(fi * fo + fo for fi, fo in zip(sizes[:-1], sizes[1:]))


def evaluate_perturbation(
    env_creator: Callable,
    theta: np.ndarray,
    seed: int,
    sign: float,
    sigma: float,
    sizes,
    episode_horizon: int,
    action_low,
    action_high,
) -> float:
    """One fan-out task: reconstruct the noise from its seed, roll ONE
    episode per sub-env with the perturbed policy, return the mean
    FIRST-episode return (auto-reset rewards past a sub-env's first done
    must not leak into its fitness)."""
    from ray_tpu_torch.rllib.env import make_vector_env

    noise = np.random.default_rng(seed).standard_normal(theta.shape[0])
    th = theta + sign * sigma * noise
    env = make_vector_env(env_creator, 1, seed=seed)
    obs = env.reset(seed=seed)
    n = env.num_envs
    scale = (np.asarray(action_high) - np.asarray(action_low)) / 2.0
    center = (np.asarray(action_high) + np.asarray(action_low)) / 2.0
    totals = np.zeros(n)
    finished = np.zeros(n, bool)
    for _ in range(episode_horizon):
        a = _flat_policy_apply(th, np.asarray(obs, np.float64), sizes)
        obs, rew, done, _ = env.step(center + scale * a)
        totals += np.where(finished, 0.0, np.asarray(rew, np.float64))
        finished |= np.asarray(done, bool)
        if finished.all():
            break
    return float(totals.mean())


@dataclass
class ESConfig(AlgorithmConfig):
    population: int = 16  # antithetic pairs = population/2
    sigma: float = 0.1
    step_size: float = 0.05
    hidden: tuple = (32,)
    episode_horizon: int = 200
    l2_coeff: float = 0.005

    def build(self) -> "ES":
        return ES(self)


class ES(Algorithm):
    """Driver holds theta; each iteration fans out population/2
    antithetic PAIRS as stateless tasks (each task ships only theta +
    a seed), then applies the rank-normalized search gradient."""

    def __init__(self, config: ESConfig):
        super().__init__(config)
        from ray_tpu_torch.rllib.env import make_vector_env

        env = make_vector_env(config.env_creator, 1)
        obs_dim = int(np.prod(env.observation_space.shape))
        act_dim = int(np.prod(env.action_space.shape))
        self._low = env.action_space.low
        self._high = env.action_space.high
        self._envs_per_eval = env.num_envs
        del env
        self.sizes = (obs_dim, *config.hidden, act_dim)
        rng = np.random.default_rng(config.seed)
        self.theta = 0.1 * rng.standard_normal(_param_count(self.sizes))
        self._eval_task = ray_tpu_torch.remote(evaluate_perturbation)
        self._seed_rng = np.random.default_rng(config.seed + 1)
        self.total_episodes = 0

    def _save_extra_state(self):
        out = super()._save_extra_state()
        out["theta"] = self.theta
        return out

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        pairs = max(1, cfg.population // 2)
        seeds = [int(s) for s in self._seed_rng.integers(0, 2**31 - 1, pairs)]
        # theta ships ONCE per iteration (the broadcast pattern PPO uses
        # for weights), not re-pickled into each of the 2*pairs tasks
        theta_ref = ray_tpu_torch.put(self.theta)
        refs = []
        for s in seeds:
            for sign in (1.0, -1.0):
                refs.append(
                    self._eval_task.remote(
                        cfg.env_creator,
                        theta_ref,
                        s,
                        sign,
                        cfg.sigma,
                        self.sizes,
                        cfg.episode_horizon,
                        self._low,
                        self._high,
                    )
                )
        returns = np.array(ray_tpu_torch.get(refs, timeout=1200)).reshape(pairs, 2)
        self.total_episodes += 2 * pairs * self._envs_per_eval

        # rank normalization (reference: es utils compute_centered_ranks)
        flat = returns.reshape(-1)
        ranks = np.empty_like(flat)
        ranks[np.argsort(flat)] = np.arange(flat.size)
        centered = (ranks / (flat.size - 1) - 0.5).reshape(pairs, 2)
        weights = centered[:, 0] - centered[:, 1]  # antithetic difference

        grad = np.zeros_like(self.theta)
        for w, s in zip(weights, seeds):
            noise = np.random.default_rng(s).standard_normal(self.theta.shape[0])
            grad += w * noise
        grad /= pairs * cfg.sigma
        self.theta = (
            self.theta
            + cfg.step_size * grad
            - cfg.step_size * cfg.l2_coeff * self.theta
        )
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episodes_total": self.total_episodes,
            "episode_reward_mean": float(returns.mean()),
            "episode_reward_max": float(returns.max()),
            "time_this_iter_s": time.time() - t0,
        }
