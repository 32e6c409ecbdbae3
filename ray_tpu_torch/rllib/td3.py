"""TD3 (+DDPG as its special case): deterministic continuous control.

The port of the JAX package's `rllib/td3.py` (reference:
rllib/algorithms/td3/td3.py — DDPG with twin Q, delayed policy updates
and target policy smoothing; rllib/algorithms/ddpg/ddpg_torch_policy.py).
Shares the replay/rollout machinery with SAC.  One update is the twin-Q
TD step, then on every `policy_delay`-th call the actor step and the
polyak update of BOTH target nets.  Where the JAX package masks the
delayed step with a traced `where` (no recompile), this is a Python
branch on the update count: the results are the same.  The actor's loss
is computed on every call, as a metric.

DDPG = TD3Config(policy_delay=1, twin_q=False, smoothing_sigma=0).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import TwinQ, mlp_init, relu_mlp
from ray_tpu_torch.rllib.policy import adam_state, load_adam_state, load_params, params_numpy
from ray_tpu_torch.rllib.sac import SAC, action_affine, floats, polyak, transition_tensors
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class TD3Policy:
    """Deterministic tanh actor + twin Q critics, delayed actor updates,
    target policy smoothing."""

    def __init__(
        self,
        obs_shape,
        act_dim: int,
        action_low: Optional[np.ndarray] = None,
        action_high: Optional[np.ndarray] = None,
        actor_lr: float = 1e-3,
        critic_lr: float = 1e-3,
        gamma: float = 0.99,
        tau: float = 0.005,
        hidden=(256, 256),
        policy_delay: int = 2,
        smoothing_sigma: float = 0.2,
        smoothing_clip: float = 0.5,
        twin_q: bool = True,
        exploration_sigma: float = 0.1,
        seed: int = 0,
        device: Device = "cuda",
    ):
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.act_dim = int(act_dim)
        self.gamma = gamma
        self.tau = tau
        self.policy_delay = max(1, int(policy_delay))
        self.smoothing_sigma = smoothing_sigma
        self.smoothing_clip = smoothing_clip
        self.twin_q = twin_q
        self.exploration_sigma = exploration_sigma
        self._center, self._scale = action_affine(self.act_dim, action_low, action_high)

        gen = torch.Generator().manual_seed(seed)
        # the actor is a bare layer list, as the JAX tree's root: `0.weight`, ...
        self.actor = mlp_init((self.obs_dim, *hidden, act_dim), gen).to(self.device)
        self.critic = TwinQ(self.obs_dim + act_dim, tuple(hidden), gen, twin=twin_q).to(self.device)
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.q_target = copy.deepcopy(self.critic).requires_grad_(False)
        self._lrs = (actor_lr, critic_lr)
        self._optimizers = None
        self.update_count = 0
        self._rng = np.random.default_rng(seed + 1)  # exploration noise, as the reference's
        self._gen = torch.Generator(device=self.device).manual_seed(seed)  # target smoothing

    @property
    def optimizers(self):
        """(actor, critic) Adams, made at the first update."""
        if self._optimizers is None:
            actor_lr, critic_lr = self._lrs
            self._optimizers = (
                torch.optim.Adam(self.actor.parameters(), lr=actor_lr),
                torch.optim.Adam(self.critic.parameters(), lr=critic_lr),
            )
        return self._optimizers

    @staticmethod
    def pi(actor, obs):
        return torch.tanh(relu_mlp(actor, obs))

    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        with torch.no_grad():
            obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self.device)
            raw = self.pi(self.actor, obs).cpu().numpy()
        if not deterministic and self.exploration_sigma > 0:
            raw = np.clip(raw + self._rng.normal(0.0, self.exploration_sigma, raw.shape), -1, 1).astype(np.float32)
        return self._center + self._scale * raw, raw

    def _update(self, obs, act, rew, next_obs, done, noise) -> Dict[str, torch.Tensor]:
        """One TD3 update at `update_count` on tensors on the policy's
        device; `noise` ([B, act_dim] standard normals, or None when
        smoothing_sigma is 0) smooths the target policy's action."""
        actor_opt, critic_opt = self.optimizers

        # --- critics: TD target with the smoothed target-policy action
        with torch.no_grad():
            a2 = self.pi(self.actor_target, next_obs)
            if noise is not None:
                smooth = torch.clamp(self.smoothing_sigma * noise, -self.smoothing_clip, self.smoothing_clip)
                a2 = torch.clamp(a2 + smooth, -1.0, 1.0)
            t1, t2 = self.q_target(next_obs, a2)
            backup = rew + self.gamma * (1.0 - done) * torch.minimum(t1, t2)
        q1, q2 = self.critic(obs, act)
        critic_loss = ((q1 - backup) ** 2).mean()
        if self.twin_q:
            critic_loss = critic_loss + ((q2 - backup) ** 2).mean()
        critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        critic_opt.step()

        # --- the actor against the updated critics: stepped, with BOTH
        # target nets, only on the delayed steps (Fujimoto TD3 / reference
        # td3.py — gating just the actor target would double the critic
        # target's effective tau at delay=2); its loss is a metric always
        do_actor = self.update_count % self.policy_delay == 0
        with torch.enable_grad() if do_actor else torch.no_grad():
            actor_loss = -self.critic(obs, self.pi(self.actor, obs))[0].mean()
        if do_actor:
            params = list(self.actor.parameters())
            for p, g in zip(params, torch.autograd.grad(actor_loss, params)):
                p.grad = g
            actor_opt.step()
            polyak(self.actor_target, self.actor, self.tau)
            polyak(self.q_target, self.critic, self.tau)
        self.update_count += 1
        return {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach(), "q1_mean": q1.detach().mean()}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        cols = transition_tensors(batch, self.device)
        noise = None
        if self.smoothing_sigma > 0:
            noise = torch.randn((cols[0].shape[0], self.act_dim), generator=self._gen, device=self.device)
        return floats(self._update(*cols, noise))

    def get_weights(self):
        return params_numpy(self.actor)

    def set_weights(self, weights):
        load_params(self.actor, weights)

    def get_state(self):
        opts = self._optimizers or (None, None)
        return {
            "actor_params": params_numpy(self.actor),
            "q_params": params_numpy(self.critic),
            "actor_target": params_numpy(self.actor_target),
            "q_target": params_numpy(self.q_target),
            "actor_opt_state": adam_state(opts[0], self.actor.named_parameters()),
            "critic_opt_state": adam_state(opts[1], self.critic.named_parameters()),
            "update_count": self.update_count,
        }

    def set_state(self, state):
        load_params(self.actor, state["actor_params"])
        load_params(self.critic, state["q_params"])
        load_params(self.actor_target, state["actor_target"])
        load_params(self.q_target, state["q_target"])
        actor_opt, critic_opt = self.optimizers
        load_adam_state(actor_opt, self.actor.named_parameters(), state["actor_opt_state"])
        load_adam_state(critic_opt, self.critic.named_parameters(), state["critic_opt_state"])
        self.update_count = state["update_count"]


@dataclass
class TD3Config(AlgorithmConfig):
    buffer_size: int = 100_000
    learning_starts: int = 1_000
    train_batch_size: int = 256
    num_train_per_iter: int = 64
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    tau: float = 0.005
    hidden: tuple = (256, 256)
    policy_delay: int = 2
    smoothing_sigma: float = 0.2
    smoothing_clip: float = 0.5
    twin_q: bool = True
    exploration_sigma: float = 0.1

    def build(self) -> "TD3":
        return TD3(self)


@dataclass
class DDPGConfig(TD3Config):
    """DDPG is TD3 without its three tricks (reference:
    rllib/algorithms/ddpg)."""

    policy_delay: int = 1
    smoothing_sigma: float = 0.0
    twin_q: bool = False

    def build(self) -> "DDPG":
        return DDPG(self)


class TD3(SAC):
    """SAC's replay-driven loop with the TD3 policy/worker pair —
    train()/stop() inherited unchanged."""

    POLICY_CLS = TD3Policy

    def _policy_config(self, config) -> Dict[str, Any]:
        return {
            "actor_lr": config.actor_lr,
            "critic_lr": config.critic_lr,
            "gamma": config.gamma,
            "tau": config.tau,
            "hidden": tuple(config.hidden),
            "policy_delay": config.policy_delay,
            "smoothing_sigma": config.smoothing_sigma,
            "smoothing_clip": config.smoothing_clip,
            "twin_q": config.twin_q,
            "exploration_sigma": config.exploration_sigma,
        }

    def _worker_factory(self):
        from ray_tpu_torch.rllib.td3_worker import TD3Worker

        return TD3Worker


class DDPG(TD3):
    pass
