"""SAC: off-policy continuous control with twin Q and learned temperature.

The port of the JAX package's `rllib/sac.py` (reference:
rllib/algorithms/sac/sac.py — replay-driven training_step;
rllib/algorithms/sac/sac_torch_policy.py: actor_critic_loss with twin Q,
tanh-squashed Gaussian actor and entropy-temperature auto-tuning).  The
learner lives in the driver on `AlgorithmConfig.learner_device` ("cuda"
by default); rollout workers act on the CPU.

One update (`SACPolicy._update`) is a function on tensors that takes its
two noise tensors as arguments, in the reference's order: the critics
against the target twins with the OLD temperature, the actor against the
UPDATED critics (only the actor's parameters take a gradient), the
temperature from the actor step's log-probs, then the polyak update of
the Q targets.  Three `torch.optim.Adam`s with optax `adam`'s defaults,
made at the first update: a worker only acts.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, episode_summary, make_workers
from ray_tpu_torch.rllib.distributions import squashed_mode, squashed_sample_logp
from ray_tpu_torch.rllib.models import GaussianMLPModel, TwinQ
from ray_tpu_torch.rllib.policy import adam_state, load_adam_state, load_params, params_numpy
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rollout_worker import worker_info
from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

TRANSITION = (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES)


def action_affine(act_dim: int, low, high):
    """(center, scale): env_action = center + scale * a for a in (-1, 1)."""
    low = np.full(act_dim, -1.0) if low is None else np.asarray(low)
    high = np.full(act_dim, 1.0) if high is None else np.asarray(high)
    return ((high + low) / 2.0).astype(np.float32), ((high - low) / 2.0).astype(np.float32)


def transition_tensors(batch, device: torch.device):
    """A replay minibatch's (obs, actions, rewards, next_obs, dones) as
    float32 tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)).to(device) for k in TRANSITION)


@torch.no_grad()
def polyak(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, in place."""
    t, o = list(target.parameters()), list(online.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, o, alpha=tau)


def floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d metric tensors as floats, in one copy to the host."""
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


class SACPolicy:
    """Squashed-Gaussian actor + twin Q critics + learned alpha."""

    def __init__(
        self,
        obs_shape,
        act_dim: int,
        action_low: Optional[np.ndarray] = None,
        action_high: Optional[np.ndarray] = None,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        alpha_lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        hidden=(256, 256),
        target_entropy: Optional[float] = None,
        seed: int = 0,
        device: Device = "cuda",
    ):
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.act_dim = int(act_dim)
        self.gamma = gamma
        self.tau = tau
        self.target_entropy = float(target_entropy) if target_entropy is not None else -float(act_dim)
        self._center, self._scale = action_affine(self.act_dim, action_low, action_high)

        gen = torch.Generator().manual_seed(seed)
        self.actor = GaussianMLPModel(self.obs_shape, act_dim, hidden=tuple(hidden), generator=gen).to(self.device)
        self.critic = TwinQ(self.obs_dim + act_dim, tuple(hidden), gen).to(self.device)
        self.q_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        # the actor's loss reaches the distribution heads, not the value tower
        self._actor_named = [(n, p) for n, p in self.actor.named_parameters() if not n.startswith("vf.")]
        self._lrs = (actor_lr, critic_lr, alpha_lr)
        self._optimizers = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    @property
    def optimizers(self):
        """(actor, critic, alpha) Adams, made at the first update: the
        constructor imports torch._dynamo (seconds), which a worker that
        only acts never needs."""
        if self._optimizers is None:
            actor_lr, critic_lr, alpha_lr = self._lrs
            self._optimizers = (
                torch.optim.Adam([p for _, p in self._actor_named], lr=actor_lr),
                torch.optim.Adam(self.critic.parameters(), lr=critic_lr),
                torch.optim.Adam([self.log_alpha], lr=alpha_lr),
            )
        return self._optimizers

    # --------------------------------------------------------------- acting

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        """Returns (env_actions, raw_actions): raw in (-1,1) is what the
        learner stores; env units go to the env."""
        obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self.device)
        mean, log_std = self.actor.dist_inputs(obs)
        raw = squashed_mode(mean) if deterministic else squashed_sample_logp(mean, log_std, self._gen)[0]
        raw = raw.cpu().numpy()
        return self._center + self._scale * raw, raw

    # -------------------------------------------------------------- learning

    def _update(self, obs, act, rew, next_obs, done, noise_next, noise_pi) -> Dict[str, torch.Tensor]:
        """One SAC update on tensors on the policy's device; `noise_next`
        and `noise_pi` ([B, act_dim] standard normals) sample the next
        action of the critics' target and the actor's action."""
        actor_opt, critic_opt, alpha_opt = self.optimizers
        alpha = self.log_alpha.detach().exp()

        # --- critics: TD target from the target twins + entropy bonus
        with torch.no_grad():
            a2, logp2 = squashed_sample_logp(*self.actor.dist_inputs(next_obs), noise=noise_next)
            t1, t2 = self.q_target(next_obs, a2)
            backup = rew + self.gamma * (1.0 - done) * (torch.minimum(t1, t2) - alpha * logp2)
        q1, q2 = self.critic(obs, act)
        critic_loss = ((q1 - backup) ** 2 + (q2 - backup) ** 2).mean()
        critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        critic_opt.step()

        # --- actor: maximize min-Q of the reparameterized action - alpha*logp,
        # against the updated critics; the gradient goes to the actor alone
        a_pi, logp = squashed_sample_logp(*self.actor.dist_inputs(obs), noise=noise_pi)
        p1, p2 = self.critic(obs, a_pi)
        actor_loss = (alpha * logp - torch.minimum(p1, p2)).mean()
        params = [p for _, p in self._actor_named]
        for p, g in zip(params, torch.autograd.grad(actor_loss, params)):
            p.grad = g
        actor_opt.step()

        # --- temperature: match the entropy target
        logp = logp.detach()
        alpha_loss = -(self.log_alpha * (logp + self.target_entropy)).mean()
        alpha_opt.zero_grad(set_to_none=True)
        alpha_loss.backward()
        alpha_opt.step()

        polyak(self.q_target, self.critic, self.tau)
        return {
            "critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(),
            "alpha_loss": alpha_loss.detach(),
            "alpha": alpha,
            "entropy": -logp.mean(),
            "q1_mean": q1.detach().mean(),
            "q2_mean": q2.detach().mean(),
        }

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        cols = transition_tensors(batch, self.device)
        noise = torch.randn((2, cols[0].shape[0], self.act_dim), generator=self._gen, device=self.device)
        return floats(self._update(*cols, noise[0], noise[1]))

    def get_weights(self):
        return params_numpy(self.actor)

    def set_weights(self, weights):
        load_params(self.actor, weights)

    def get_state(self):
        """FULL learner state for checkpointing (critics, targets, alpha,
        optimizer moments — not just the actor), as host numpy: a
        checkpoint taken on the card restores on the CPU."""
        opts = self._optimizers or (None, None, None)
        return {
            "actor_params": params_numpy(self.actor),
            "q_params": params_numpy(self.critic),
            "q_target": params_numpy(self.q_target),
            "log_alpha": self.log_alpha.detach().cpu().numpy().copy(),
            "actor_opt_state": adam_state(opts[0], self._actor_named),
            "critic_opt_state": adam_state(opts[1], self.critic.named_parameters()),
            "alpha_opt_state": adam_state(opts[2], [("log_alpha", self.log_alpha)]),
        }

    @torch.no_grad()
    def set_state(self, state):
        load_params(self.actor, state["actor_params"])
        load_params(self.critic, state["q_params"])
        load_params(self.q_target, state["q_target"])
        self.log_alpha.copy_(torch.as_tensor(np.asarray(state["log_alpha"])))
        actor_opt, critic_opt, alpha_opt = self.optimizers
        load_adam_state(actor_opt, self._actor_named, state["actor_opt_state"])
        load_adam_state(critic_opt, self.critic.named_parameters(), state["critic_opt_state"])
        load_adam_state(alpha_opt, [("log_alpha", self.log_alpha)], state["alpha_opt_state"])


class SACWorker:
    """Rollout actor for the off-policy continuous-control family:
    policy-driven stepping over a VectorEnv on the CPU, storing RAW (-1,1)
    actions so the learner's log-probs/critics line up.  ``policy_cls``
    parameterizes the family — SAC by default, TD3/DDPG reuse the same
    sampling loop (truncation-aware bootstrapping included) with their
    own policy.  Runs ``num_threads`` torch threads (the CPUs it holds)."""

    def __init__(
        self, env_creator, policy_config, seed=0, num_envs: int = 1, policy_cls=None, num_threads: int = 1
    ):
        from ray_tpu_torch.rllib.env import make_vector_env

        torch.set_num_threads(max(1, int(num_threads)))
        self.env = make_vector_env(env_creator, num_envs, seed=seed)
        self.num_envs = self.env.num_envs
        space = self.env.action_space
        self.policy = (policy_cls or SACPolicy)(
            obs_shape=tuple(self.env.observation_space.shape),
            act_dim=int(np.prod(space.shape)),
            action_low=space.low,
            action_high=space.high,
            seed=seed,
            device="cpu",
            **policy_config,
        )
        self._obs = self.env.reset(seed=seed)
        self.episode_rewards = []
        self._ep_reward = np.zeros(self.num_envs, np.float64)
        self._rng = np.random.default_rng(seed + 10_000)

    def sample(self, num_steps: int, random_actions: bool = False) -> SampleBatch:
        rows = {k: [] for k in TRANSITION}
        rng = self._rng  # persistent: warmup calls must not replay draws
        for _ in range(num_steps):
            obs = self._obs
            if random_actions:
                raw = rng.uniform(-1, 1, (self.num_envs, self.policy.act_dim)).astype(np.float32)
                env_actions = self.policy._center + self.policy._scale * raw
            else:
                env_actions, raw = self.policy.compute_actions(obs)
            next_obs, rewards, dones, infos = self.env.step(env_actions)
            # bootstrap through time-limit cuts: a truncated episode's
            # state is NOT terminal, so the TD target must keep its value —
            # and must bootstrap from the TRUE final obs, not the
            # auto-reset obs (gym "TimeLimit.truncated"/"final_observation"
            # conventions; reference SAC treats truncation as non-terminal)
            store_next = next_obs
            terminated = np.asarray(dones, bool).copy()
            for i, d in enumerate(dones):
                if not d:
                    continue
                info = infos[i] or {}
                if info.get("TimeLimit.truncated", False):
                    terminated[i] = False
                fo = info.get("final_observation")
                if fo is not None:
                    if store_next is next_obs:
                        store_next = next_obs.copy()
                    store_next[i] = fo
            rows[OBS].append(obs)
            rows[ACTIONS].append(raw)
            rows[REWARDS].append(rewards)
            rows[NEXT_OBS].append(store_next)
            rows[DONES].append(terminated)
            self._ep_reward += rewards
            for i in np.nonzero(dones)[0]:
                self.episode_rewards.append(float(self._ep_reward[i]))
                self._ep_reward[i] = 0.0
            self._obs = next_obs
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
class SACConfig(AlgorithmConfig):
    buffer_size: int = 100_000
    learning_starts: int = 1_000
    train_batch_size: int = 256
    num_train_per_iter: int = 64  # gradient steps per train()
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    tau: float = 0.005
    hidden: tuple = (256, 256)
    target_entropy: Optional[float] = None

    def build(self) -> "SAC":
        return SAC(self)


class SAC(Algorithm):
    """Replay-driven training loop (reference: sac.py training_step):
    rollout workers push transitions; the driver-side learner takes
    num_train_per_iter gradient steps per iteration on its device.

    The loop is the whole off-policy continuous-control family's:
    subclasses (TD3/DDPG) override POLICY_CLS / _worker_factory /
    _policy_config and inherit train()/stop() unchanged."""

    POLICY_CLS = SACPolicy

    def _policy_config(self, config) -> Dict[str, Any]:
        return {
            "actor_lr": config.actor_lr,
            "critic_lr": config.critic_lr,
            "alpha_lr": config.alpha_lr,
            "gamma": config.gamma,
            "tau": config.tau,
            "hidden": tuple(config.hidden),
            "target_entropy": config.target_entropy,
        }

    def _worker_factory(self):
        """The rollout worker's class."""
        return SACWorker

    def __init__(self, config):
        super().__init__(config)
        env = config.env_creator()
        obs_shape = tuple(env.observation_space.shape)
        space = env.action_space
        del env
        policy_config = self._policy_config(config)
        # the learner first: without a card the default device raises
        # before any worker starts
        self.policy = self.POLICY_CLS(
            obs_shape=obs_shape,
            act_dim=int(np.prod(space.shape)),
            action_low=space.low,
            action_high=space.high,
            seed=config.seed,
            device=config.learner_device,
            **policy_config,
        )
        self.workers = make_workers(
            config,
            policy_config,
            [{"seed": config.seed + i} for i in range(config.num_rollout_workers)],
            self._worker_factory(),
        )
        self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self.total_steps = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        weights_ref = ray_tpu_torch.put(self.policy.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights_ref) for w in self.workers], timeout=300)
        per_env = max(1, -(-cfg.rollout_fragment_length // cfg.num_envs_per_worker))
        warmup = len(self.buffer) < cfg.learning_starts
        batches = ray_tpu_torch.get([w.sample.remote(per_env, warmup) for w in self.workers], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self.total_steps += len(b)

        metrics: Dict[str, float] = {}
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_train_per_iter):
                metrics = self.policy.learn_on_batch(self.buffer.sample(cfg.train_batch_size))
                updates += 1

        stats = ray_tpu_torch.get([w.episode_stats.remote() for w in self.workers], timeout=120)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.total_steps,
            "num_grad_updates": updates,
            **episode_summary(stats),
            "time_this_iter_s": time.time() - t0,
            **metrics,
        }
