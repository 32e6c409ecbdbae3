"""DQN: off-policy Q-learning with replay + target network.

The port of the JAX package's `rllib/dqn.py` (reference:
rllib/algorithms/dqn/dqn.py:332 training_step — sample rollouts → store
in replay buffer → sample minibatches → TD update → periodic
target-network sync; double-DQN per Hasselt).  The Q-network comes from
the model catalog (the "logits" head IS the Q-values; the value head is
unused), so flat envs get the MLP and pixel envs the conv net; uint8
frames stay uint8 up to the model.  The learner lives in the driver on
`AlgorithmConfig.learner_device` ("cuda" by default); rollout workers act
epsilon-greedily on the CPU with numpy draws, as the reference's.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, episode_summary, make_workers
from ray_tpu_torch.rllib.models import get_model
from ray_tpu_torch.rllib.policy import adam_state, load_adam_state, load_params, params_numpy
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.rollout_worker import worker_info
from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch


class DQNPolicy:
    """Q-network + target copy; epsilon-greedy acting, double-DQN TD
    update."""

    def __init__(
        self,
        obs_shape,
        num_actions: int,
        lr: float = 1e-3,
        gamma: float = 0.99,
        seed: int = 0,
        model_config: Optional[Dict[str, Any]] = None,
        hidden=(64, 64),
        device: Device = "cuda",
    ):
        self.device = resolve_device(device)
        cfg = dict(model_config or {})
        if "hidden" not in cfg and len(tuple(obs_shape)) == 1:
            cfg["hidden"] = hidden
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.gamma = gamma
        self.model = get_model(self.obs_shape, num_actions, cfg, generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.lr = lr
        self._optimizer = None
        self._rng = np.random.default_rng(seed + 1)

    @property
    def optimizer(self) -> torch.optim.Adam:
        """Made at the first update: a worker only acts."""
        if self._optimizer is None:
            self._optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr)
        return self._optimizer

    def _obs(self, obs) -> torch.Tensor:
        """Observations on the device: uint8 frames as uint8 (the model
        divides by 255), anything else as float32."""
        obs = np.asarray(obs)
        if obs.dtype != np.uint8:
            obs = obs.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)

    def compute_actions(self, obs: np.ndarray, epsilon: float = 0.0):
        with torch.no_grad():
            greedy = self.model(self._obs(obs))[0].argmax(-1).cpu().numpy()
        if epsilon > 0:
            n = len(greedy)
            explore = self._rng.random(n) < epsilon
            rand = self._rng.integers(0, self.num_actions, n)
            return np.where(explore, rand, greedy)
        return greedy

    def _update(self, obs, actions, rewards, next_obs, dones, weights):
        """One double-DQN step on tensors on the policy's device: the online
        net picks a', the target net evaluates it; the Huber loss (delta 1,
        optax's `huber_loss`) weighted by the PER weights.  Returns (loss,
        |td|)."""
        with torch.no_grad():
            a_star = self.model(next_obs)[0].argmax(-1, keepdim=True)
            q_next = self.target_model(next_obs)[0].gather(1, a_star)[:, 0]
            target = rewards + self.gamma * (1.0 - dones) * q_next
        q_sa = self.model(obs)[0].gather(1, actions[:, None])[:, 0]
        loss = (weights * F.huber_loss(q_sa, target, reduction="none", delta=1.0)).mean()
        optimizer = self.optimizer
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), (q_sa.detach() - target).abs()

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        weights = batch.get("weights")
        if weights is None:
            weights = np.ones(len(batch), np.float32)

        def column(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(batch[key], dtype)).to(self.device)

        loss, td = self._update(
            self._obs(batch[OBS]),
            column(ACTIONS, np.int64),
            column(REWARDS, np.float32),
            self._obs(batch[NEXT_OBS]),
            column(DONES, np.float32),
            torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(self.device),
        )
        return {"loss": float(loss), "td_error": td.cpu().numpy()}

    @torch.no_grad()
    def sync_target(self):
        for t, p in zip(self.target_model.parameters(), self.model.parameters()):
            t.copy_(p)

    def get_weights(self):
        return params_numpy(self.model)

    def set_weights(self, weights):
        load_params(self.model, weights)

    def get_state(self):
        return {
            "params": params_numpy(self.model),
            "target_params": params_numpy(self.target_model),
            "opt_state": adam_state(self._optimizer, self.model.named_parameters()),
        }

    def set_state(self, state):
        load_params(self.model, state["params"])
        load_params(self.target_model, state["target_params"])
        load_adam_state(self.optimizer, self.model.named_parameters(), state["opt_state"])


class DQNWorker:
    """Rollout actor for off-policy collection: epsilon-greedy stepping
    over a VectorEnv on the CPU, emitting (obs, action, reward, next_obs,
    done) transitions (reference analog: RolloutWorker sampling into the
    local replay actor, rllib/algorithms/dqn/dqn.py:332).  Runs
    ``num_threads`` torch threads (the CPUs it holds)."""

    def __init__(self, env_creator, policy_config, seed=0, num_envs: int = 1, num_threads: int = 1):
        from ray_tpu_torch.rllib.env import make_vector_env

        torch.set_num_threads(max(1, int(num_threads)))
        self.env = make_vector_env(env_creator, num_envs, seed=seed)
        self.num_envs = self.env.num_envs
        self.policy = DQNPolicy(
            obs_shape=tuple(self.env.observation_space.shape),
            num_actions=int(self.env.action_space.n),
            seed=seed,
            device="cpu",
            **policy_config,
        )
        self._obs = self.env.reset(seed=seed)
        self.episode_rewards = []
        self._ep_reward = np.zeros(self.num_envs, np.float64)

    def sample(self, num_steps: int, epsilon: float) -> SampleBatch:
        rows = {k: [] for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES)}
        for _ in range(num_steps):
            obs = self._obs
            actions = self.policy.compute_actions(obs, epsilon)
            next_obs, rewards, dones, _ = self.env.step(actions)
            rows[OBS].append(obs)
            rows[ACTIONS].append(actions)
            rows[REWARDS].append(rewards)
            rows[NEXT_OBS].append(next_obs)
            rows[DONES].append(dones)
            self._ep_reward += rewards
            for i in np.nonzero(dones)[0]:
                self.episode_rewards.append(float(self._ep_reward[i]))
                self._ep_reward[i] = 0.0
            self._obs = next_obs
        # flatten [T, N] -> [T*N]
        return SampleBatch({k: np.stack(v).reshape(-1, *np.asarray(v[0]).shape[1:]) for k, v in rows.items()})

    def set_weights(self, weights):
        self.policy.set_weights(weights)
        return True

    def episode_stats(self, last_n: int = 20):
        recent = self.episode_rewards[-last_n:]
        return {
            "episodes": len(self.episode_rewards),
            "episode_reward_mean": float(np.mean(recent)) if recent else 0.0,
        }

    def worker_info(self):
        return worker_info(self.policy)


@dataclass
class DQNConfig(AlgorithmConfig):
    buffer_size: int = 50_000
    prioritized_replay: bool = False
    learning_starts: int = 1_000
    target_network_update_freq: int = 500  # env steps between target syncs
    train_batch_size: int = 64
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.02
    epsilon_timesteps: int = 10_000
    num_train_per_iter: int = 32  # TD updates per train()
    lr: float = 1e-3

    def build(self) -> "DQN":
        return DQN(self)


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        super().__init__(config)
        env = config.env_creator()
        obs_shape = tuple(env.observation_space.shape)
        num_actions = int(env.action_space.n)
        del env
        policy_config = {"lr": config.lr, "gamma": config.gamma, "model_config": config.model}
        # the learner first: without a card the default device raises
        # before any worker starts
        self.policy = DQNPolicy(
            obs_shape=obs_shape, num_actions=num_actions, seed=config.seed, device=config.learner_device,
            **policy_config,
        )
        self.workers = make_workers(
            config, policy_config, [{"seed": config.seed + i} for i in range(config.num_rollout_workers)], DQNWorker
        )
        self.buffer = (
            PrioritizedReplayBuffer(config.buffer_size, seed=config.seed)
            if config.prioritized_replay
            else ReplayBuffer(config.buffer_size, seed=config.seed)
        )
        self.total_steps = 0
        self._steps_since_sync = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.total_steps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        weights_ref = ray_tpu_torch.put(self.policy.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights_ref) for w in self.workers], timeout=300)
        eps = self._epsilon()
        per_env = max(1, -(-cfg.rollout_fragment_length // cfg.num_envs_per_worker))
        batches = ray_tpu_torch.get([w.sample.remote(per_env, eps) for w in self.workers], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self.total_steps += len(b)
            self._steps_since_sync += len(b)

        metrics: Dict[str, float] = {}
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_train_per_iter):
                mb = self.buffer.sample(cfg.train_batch_size)
                out = self.policy.learn_on_batch(mb)
                if cfg.prioritized_replay:
                    self.buffer.update_priorities(mb["batch_indexes"], out["td_error"])
                metrics = {"loss": out["loss"]}
                updates += 1
            if self._steps_since_sync >= cfg.target_network_update_freq:
                self.policy.sync_target()
                self._steps_since_sync = 0

        stats = ray_tpu_torch.get([w.episode_stats.remote() for w in self.workers], timeout=120)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.total_steps,
            "num_td_updates": updates,
            "epsilon": eps,
            **episode_summary(stats),
            "time_this_iter_s": time.time() - t0,
            **metrics,
        }
