"""Algorithm + AlgorithmConfig + PPO.

The port of the JAX package's `rllib/algorithm.py` (reference:
rllib/algorithms/algorithm.py:145 Algorithm(Trainable), algorithms/ppo/
ppo.py:401 training_step — synchronous_parallel_sample over the WorkerSet,
SGD epochs on the collected batch, weight broadcast back to workers).
The learner lives in the driver process on `AlgorithmConfig.learner_device`
("cuda" by default: it raises without a card); rollout workers are CPU
actors.  The device is never part of `policy_config`, which goes to the
learner and to every worker alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.sample_batch import ADVANTAGES, SampleBatch


@dataclass
class AlgorithmConfig:
    env_creator: Optional[Callable] = None
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 1
    rollout_fragment_length: int = 200
    train_batch_size: int = 400
    sgd_minibatch_size: int = 128
    num_sgd_iter: int = 8
    lr: float = 3e-4
    gamma: float = 0.99
    clip_param: float = 0.2
    entropy_coeff: float = 0.0
    seed: int = 0
    num_learner_devices: int = 1
    # model catalog config (reference: rllib/models/catalog.py), e.g.
    # {"type": "cnn", "compute_dtype": "bfloat16"}; "auto" picks CNN for
    # rank-3 obs
    model: Optional[Dict[str, Any]] = None
    # the learner's device, in the driver process ("cuda" or "cpu")
    learner_device: str = "cuda"
    # CPUs each rollout worker actor holds; its torch runs that many threads
    num_cpus_per_worker: int = 1

    def environment(self, env_creator: Callable) -> "AlgorithmConfig":
        self.env_creator = env_creator
        return self

    def rollouts(
        self, num_rollout_workers: int, num_envs_per_worker: int = 1
    ) -> "AlgorithmConfig":
        self.num_rollout_workers = num_rollout_workers
        self.num_envs_per_worker = num_envs_per_worker
        return self

    def training(self, **kw) -> "AlgorithmConfig":
        for k, v in kw.items():
            setattr(self, k, v)
        return self

    def build(self) -> "PPO":
        return PPO(self)

    def policy_config(self) -> Dict[str, Any]:
        """What the learner and every rollout worker build their policy from
        (no device: each process names its own)."""
        return {
            "lr": self.lr,
            "clip_param": self.clip_param,
            "entropy_coeff": self.entropy_coeff,
            "gamma": self.gamma,
            "model_config": self.model,
        }


def spaces(config: AlgorithmConfig):
    """(obs shape, number of actions) of the config's env."""
    env = config.env_creator()
    return tuple(env.observation_space.shape), int(env.action_space.n)


def make_workers(
    config: AlgorithmConfig, policy_config: Dict[str, Any], seeds: List[Dict[str, int]], worker_body=None
):
    """One rollout worker actor (`worker_body`, RolloutWorker by default)
    per entry of `seeds` (its `seed` and optional `env_seed`), each holding
    `num_cpus_per_worker` CPUs and running that many torch threads."""
    if worker_body is None:
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker as worker_body

    worker_cls = ray_tpu_torch.remote(worker_body).options(num_cpus=config.num_cpus_per_worker)
    return [
        worker_cls.remote(
            config.env_creator,
            policy_config,
            num_envs=config.num_envs_per_worker,
            num_threads=config.num_cpus_per_worker,
            **seed,
        )
        for seed in seeds
    ]


def episode_summary(stats: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "episode_reward_mean": float(
            np.mean([s["episode_reward_mean"] for s in stats if s["episodes"] > 0] or [0.0])
        ),
        "episodes_total": int(sum(s["episodes"] for s in stats)),
    }


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        raise NotImplementedError

    def stop(self):
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — a dead worker needs no kill
                pass

    # --------------------------------------------------- checkpointing
    # (reference: Algorithm.save/restore, algorithm.py save_checkpoint —
    # policy weights + training progress to a directory; restore rebuilds
    # into a live algorithm of the same config)

    def save(self, checkpoint_dir: str) -> str:
        import os
        import pickle

        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        policy = getattr(self, "policy", None)
        state = {
            "iteration": self.iteration,
            # FULL learner state (parameters, critics, target nets,
            # temperature, Adam's moments and count): restoring only the
            # weights would restart the optimizer against fresh critics
            "policy_state": policy.get_state() if policy is not None else None,
            "extra": self._save_extra_state(),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=5)
        os.replace(tmp, path)
        return path

    def restore(self, checkpoint_path: str):
        import os
        import pickle

        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path, "algorithm_state.pkl")
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        policy = getattr(self, "policy", None)
        if state["policy_state"] is not None and policy is not None:
            policy.set_state(state["policy_state"])
        for k, v in state.get("extra", {}).items():
            setattr(self, k, v)
        return self

    def _save_extra_state(self) -> Dict[str, Any]:
        """Progress counters, and what a policy-less algorithm (ES) learns;
        `restore` sets each back as an attribute."""
        return {attr: getattr(self, attr) for attr in ("total_steps", "total_episodes") if hasattr(self, attr)}


class PPO(Algorithm):
    def __init__(self, config: AlgorithmConfig):
        super().__init__(config)
        from ray_tpu_torch.rllib.policy import TorchPolicy

        obs_shape, num_actions = spaces(config)
        policy_config = config.policy_config()
        # the learner lives driver-side (BASELINE config #3's accelerator
        # learner), rollout workers are cpu actors
        self.policy = TorchPolicy(
            obs_shape=obs_shape,
            num_actions=num_actions,
            seed=config.seed,
            num_devices=config.num_learner_devices,
            device=config.learner_device,
            **policy_config,
        )
        self.workers = make_workers(
            config, policy_config, [{"seed": config.seed + i} for i in range(config.num_rollout_workers)]
        )

    def train(self) -> Dict[str, Any]:
        """One iteration: weights out, every worker samples in parallel, one
        host→device copy of the batch, all SGD epochs on the device.  The
        result carries the iteration's seconds: `rollout_s` (the slowest
        worker's own rollout), `transfer_s` (the rest of the sampling wall:
        the calls and the batches' way through the object store), `h2d_s`
        (the copy to the learner's device) and `learn_s`."""
        cfg = self.config
        t0 = time.perf_counter()
        weights_ref = ray_tpu_torch.put(self.policy.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights_ref) for w in self.workers], timeout=300)
        steps_per_worker = max(
            cfg.rollout_fragment_length, cfg.train_batch_size // max(len(self.workers), 1)
        )
        # sample() takes PER-ENV steps; a vector env contributes
        # num_envs rows per step
        per_env = max(1, -(-steps_per_worker // cfg.num_envs_per_worker))
        t_sample = time.perf_counter()
        batches = ray_tpu_torch.get([w.sample.remote(per_env) for w in self.workers], timeout=600)
        t_sampled = time.perf_counter()
        batch = SampleBatch.concat_samples(batches)
        # advantage normalization (reference: ppo standardize_fields)
        adv = batch[ADVANTAGES]
        batch[ADVANTAGES] = (adv - adv.mean()) / max(adv.std(), 1e-6)

        # one host→device copy for the whole iteration; every SGD epoch
        # and minibatch runs on the device (reference analog: the
        # load_batch_into_buffer / learn_on_loaded_batch split)
        t_load = time.perf_counter()
        staged = self.policy.load_batch(batch)
        _synchronize(self.policy.device)
        t_learn = time.perf_counter()
        metrics = self.policy.learn_on_loaded_batch(
            staged,
            cfg.num_sgd_iter,
            min(cfg.sgd_minibatch_size, len(batch)),
            seed=cfg.seed,
        )
        t_learned = time.perf_counter()

        stats = ray_tpu_torch.get([w.episode_stats.remote() for w in self.workers], timeout=120)
        self.iteration += 1
        rollout_s = max(s["rollout_s"] for s in stats)
        return {
            "training_iteration": self.iteration,
            "timesteps_this_iter": len(batch),
            **episode_summary(stats),
            "time_this_iter_s": time.perf_counter() - t0,
            "rollout_s": rollout_s,
            "transfer_s": t_sampled - t_sample - rollout_s,
            "h2d_s": t_learn - t_load,
            "learn_s": t_learned - t_learn,
            **metrics,
        }


def _synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
