"""TorchPolicy: actor-critic policy with the PPO and V-trace losses.

The port of the JAX package's `JaxPolicy` (`ray_tpu/rllib/policy.py`;
reference: rllib/policy/torch_policy.py:60, learn_on_loaded_batch:538).
A model from the catalog (MLP or Atari-style CNN,
`ray_tpu_torch/rllib/models.py`) with ONE joint forward for π and V, a
categorical head, the clipped-surrogate PPO loss and the IMPALA/APPO
V-trace loss, on an explicit `device` ("cuda" by default: it raises
without a card unless the caller names the CPU).  `torch.optim.Adam` has
optax `adam`'s defaults (b1 0.9, b2 0.999, eps 1e-8) and formula.

Where the JAX policy runs one jitted program (the minibatch loop of
`learn_on_loaded_batch` as a `lax.scan`, the V-trace recursion as a
reverse scan), this one runs a plain loop on the device.  The optimizer
writes the parameters in place, so every optimizer step and every weight
read (`get_weights`, `get_flat_weights`, `get_state`) takes one lock: a
reader on another thread (IMPALA's driver, while the learner thread
updates) gets all parameters from one update, never a mix of two.  On
the card the step's kernels and the reader's copies queue on the same
stream in the order the lock gave them.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.rllib.models import get_model
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, DONES, LOGPS, OBS, RETURNS, REWARDS


class TorchPolicy:
    def __init__(
        self,
        obs_dim: Optional[int] = None,
        num_actions: int = 2,
        hidden: Tuple[int, ...] = (64, 64),
        lr: float = 3e-4,
        clip_param: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.0,
        gamma: float = 0.99,
        seed: int = 0,
        num_devices: int = 1,
        obs_shape: Optional[Tuple[int, ...]] = None,
        model_config: Optional[Dict[str, Any]] = None,
        vtrace_clip: bool = False,
        device: Device = "cuda",
    ):
        self.device = resolve_device(device)
        if num_devices > 1:
            raise NotImplementedError(
                "a learner over several devices is not ported yet (ROADMAP, Queue 1: Multi-GPU)"
            )
        if obs_shape is None:
            if obs_dim is None:
                raise ValueError("TorchPolicy needs obs_shape or obs_dim")
            obs_shape = (int(obs_dim),)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.num_actions = num_actions
        cfg = dict(model_config or {})
        if "hidden" not in cfg and len(self.obs_shape) == 1:
            cfg["hidden"] = hidden
        self.model = get_model(self.obs_shape, num_actions, cfg, generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.lr = lr
        self._optimizer = None
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.gamma = gamma
        self.vtrace_clip = vtrace_clip
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._lock = threading.Lock()  # optimizer steps vs weight reads
        self._loaded_seq = 0

    @property
    def optimizer(self) -> torch.optim.Adam:
        """Made at the first update: its constructor imports torch._dynamo
        (seconds), which a rollout worker that only acts never needs."""
        if self._optimizer is None:
            self._optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr)
        return self._optimizer

    # ----------------------------------------------------------------- losses

    def _ppo_loss(self, obs, actions, old_logp, advantages, returns, mask):
        """Clipped-surrogate PPO loss, SHARED by the central learner and
        the DDPPO grad path so the objectives can never diverge.  Masked
        means: a row of weight 0 counts nowhere."""

        def wmean(x):
            return (x * mask).sum() / mask.sum()

        logits, value = self.model(obs)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param)
        pi_loss = -wmean(torch.minimum(ratio * advantages, clipped * advantages))
        vf_loss = wmean((value - returns) ** 2)
        entropy = wmean(-(torch.exp(logp_all) * logp_all).sum(-1))
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(), "entropy": entropy.detach()}

    def _vtrace_loss(self, obs, actions, behavior_logp, rewards, dones, bootstrap):
        """V-trace with ρ̄ = c̄ = 1 over a [T, N] fragment (env axis batched),
        the recursion over T as a reverse loop; targets and advantages are
        fixed (no gradient).  APPO (`vtrace_clip`): the clipped surrogate on
        the V-trace advantages (reference: rllib/algorithms/appo/
        appo_torch_policy.py)."""
        T, N = actions.shape
        logits, values = self.model(obs.reshape(T * N, *self.obs_shape))
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, actions.reshape(-1, 1))[:, 0].reshape(T, N)
        values = values.reshape(T, N)
        with torch.no_grad():
            v = values.detach()
            rho = torch.clamp(torch.exp(logp.detach() - behavior_logp), max=1.0)
            c = torch.clamp(rho, max=1.0)
            nonterminal = 1.0 - dones
            next_values = torch.cat([v[1:], bootstrap[None, :]])
            deltas = rho * (rewards + self.gamma * nonterminal * next_values - v)
            # vs_t = V_t + delta_t + gamma*nt_t*c_t*(vs_{t+1} - V_{t+1})
            acc = torch.zeros_like(bootstrap)
            accs = [None] * T
            for t in range(T - 1, -1, -1):
                acc = deltas[t] + self.gamma * nonterminal[t] * c[t] * acc
                accs[t] = acc
            vs = v + torch.stack(accs)
            next_vs = torch.cat([vs[1:], bootstrap[None, :]])
            pg_adv = rho * (rewards + self.gamma * nonterminal * next_vs - v)
        if self.vtrace_clip:
            ratio = torch.exp(logp - behavior_logp)
            clipped = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param)
            pi_loss = -torch.minimum(ratio * pg_adv, clipped * pg_adv).mean()
        else:
            pi_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(), "entropy": entropy.detach()}

    def _step(self, loss_fn, *args) -> Dict[str, torch.Tensor]:
        """One optimizer update on `loss_fn(*args)`; metrics stay tensors."""
        self.model.zero_grad(set_to_none=True)
        total, metrics = loss_fn(*args)
        total.backward()
        with self._lock:
            self.optimizer.step()
        metrics["total_loss"] = total.detach()
        return metrics

    @staticmethod
    def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------- serving

    def compute_actions(self, obs: np.ndarray):
        """obs: [B, *obs_shape] — dtype passes through untouched (uint8
        pixel frames are normalized inside the model, saving 4x on the
        host→device copy).  Actions are drawn from the policy's own
        generator."""
        with torch.no_grad():
            logits, value = self.model(torch.as_tensor(np.asarray(obs)).to(self.device))
            logp_all = F.log_softmax(logits, dim=-1)
            action = torch.multinomial(torch.exp(logp_all), 1, generator=self._gen)
            logp = logp_all.gather(1, action)[:, 0]
        return action[:, 0].cpu().numpy(), logp.cpu().numpy(), value.cpu().numpy()

    def _obs_np(self, obs):
        obs = np.asarray(obs)
        if obs.dtype != np.uint8:
            obs = obs.astype(np.float32)
        return obs.reshape(-1, *self.obs_shape)

    def _tensors(self, batch):
        """The PPO columns of `batch` on the device, with a mask of ones."""
        obs = self._obs_np(batch[OBS])
        arrays = (
            obs,
            np.asarray(batch[ACTIONS], np.int64),
            np.asarray(batch[LOGPS], np.float32),
            np.asarray(batch[ADVANTAGES], np.float32),
            np.asarray(batch[RETURNS], np.float32),
            np.ones(len(obs), np.float32),
        )
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def learn_on_batch(self, batch) -> Dict[str, float]:
        return self._floats(self._step(self._ppo_loss, *self._tensors(batch)))

    def load_batch(self, batch):
        """Stage a (GAE-postprocessed, advantage-normalized) batch onto the
        learner's device ONCE — reference analog:
        TorchPolicy.load_batch_into_buffer (torch_policy.py:480)."""
        return self._tensors(batch)

    def learn_on_loaded_batch(
        self, staged, num_sgd_iter: int, minibatch_size: int, seed: int = 0
    ) -> Dict[str, float]:
        """All SGD epochs over the staged batch, no host↔device traffic
        inside the loop but the row indices, sent once (reference analog:
        TorchPolicy.learn_on_loaded_batch, torch_policy.py:538).  The
        minibatches are the JAX policy's, row for row: the same numpy
        permutations from `default_rng(seed + call count)`.  Returns the
        last minibatch's metrics."""
        n = int(staged[0].shape[0])
        mb = min(minibatch_size, n)
        n_mb = max(1, n // mb)
        rng = np.random.default_rng(seed + self._loaded_seq)
        self._loaded_seq += 1
        idx = np.stack(
            [rng.permutation(n)[: n_mb * mb].reshape(n_mb, mb) for _ in range(num_sgd_iter)]
        ).reshape(num_sgd_iter * n_mb, mb)
        metrics = {}
        for sel in torch.from_numpy(idx).to(self.device):
            metrics = self._step(self._ppo_loss, *(a.index_select(0, sel) for a in staged))
        return self._floats(metrics)

    def _column(self, x, dtype: torch.dtype) -> torch.Tensor:
        """A fragment column on the device: tensors the IMPALA loader staged
        stay where they are."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def learn_on_fragment(self, batch, bootstrap_value) -> Dict[str, float]:
        """IMPALA/V-trace update on one time-ordered rollout fragment
        (off-policy: behavior logps correct the policy lag).  Accepts
        [T]-shaped scalar-env fragments or [T, N] vector-env fragments
        (bootstrap scalar or [N]), as numpy arrays or device tensors.
        Reference analog: the IMPALA learner's vtrace loss consumed by
        rllib/execution/learner_thread.py:17."""
        obs = batch[OBS]
        pixels = obs.dtype == (torch.uint8 if isinstance(obs, torch.Tensor) else np.uint8)
        obs = self._column(obs, torch.uint8 if pixels else torch.float32)
        actions = self._column(batch[ACTIONS], torch.int64)
        logps = self._column(batch[LOGPS], torch.float32)
        rewards = self._column(batch[REWARDS], torch.float32)
        dones = self._column(batch[DONES], torch.float32)
        if actions.ndim == 1:  # scalar-env fragment: lift to [T, 1]
            T, N = actions.shape[0], 1
        else:
            T, N = actions.shape
        bootstrap = self._column(np.asarray(bootstrap_value, np.float32).reshape(N), torch.float32)
        metrics = self._step(
            self._vtrace_loss,
            obs.reshape(T, N, *self.obs_shape),
            actions.reshape(T, N),
            logps.reshape(T, N),
            rewards.reshape(T, N),
            dones.reshape(T, N),
            bootstrap,
        )
        return self._floats(metrics)

    def compute_grads(self, batch):
        """PPO gradients WITHOUT applying them, flattened to one float32
        vector in the order of `model.parameters()` (the same on every
        policy of one configuration) — the unit a decentralized learner
        allreduces out-of-band (reference analog: DDPPO's in-worker grad
        step, rllib/algorithms/ddppo/ddppo.py:226)."""
        self.model.zero_grad(set_to_none=True)
        total, _metrics = self._ppo_loss(*self._tensors(batch))
        total.backward()
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in self.model.parameters()
        ])
        return flat.cpu().numpy().astype(np.float32), {"total_loss": float(total.detach())}

    def apply_flat_grads(self, flat):
        """Apply a (possibly allreduced) flat gradient vector."""
        flat = torch.as_tensor(np.asarray(flat, np.float32)).to(self.device)
        offset = 0
        for p in self.model.parameters():
            p.grad = flat[offset : offset + p.numel()].view_as(p).clone()
            offset += p.numel()
        with self._lock:
            self.optimizer.step()

    # ------------------------------------------------------------- weights

    def get_weights(self) -> Dict[str, np.ndarray]:
        """{parameter name: numpy copy}, in the port's layout."""
        with self._lock:
            return params_numpy(self.model)

    def set_weights(self, weights):
        with self._lock:
            load_params(self.model, weights)

    def get_flat_weights(self) -> torch.Tensor:
        """Policy weights as ONE contiguous vector on the policy's device,
        in the order of `model.parameters()`."""
        with self._lock:
            return torch.cat([p.detach().reshape(-1) for p in self.model.parameters()])

    @torch.no_grad()
    def set_flat_weights(self, flat):
        """Inverse of get_flat_weights (a tensor or a numpy vector)."""
        flat = torch.as_tensor(flat).to(self.device, torch.float32)
        with self._lock:
            offset = 0
            for p in self.model.parameters():
                p.copy_(flat[offset : offset + p.numel()].view_as(p))
                offset += p.numel()

    def get_state(self):
        """Full learner state (parameters, Adam's moments and count) for
        Algorithm.save checkpoints."""
        with self._lock:
            named = list(self.model.named_parameters())
            return {"params": params_numpy(self.model), "opt_state": adam_state(self._optimizer, named)}

    @torch.no_grad()
    def set_state(self, state):
        self.set_weights(state["params"])
        with self._lock:
            load_adam_state(self.optimizer, self.model.named_parameters(), state["opt_state"])


def params_numpy(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{parameter name: a numpy copy on the host}."""
    return {name: p.detach().to("cpu", copy=True).numpy() for name, p in module.named_parameters()}


@torch.no_grad()
def load_params(module: torch.nn.Module, arrays) -> None:
    """Copy {name: array} into `module`'s parameters, on their device."""
    for name, p in module.named_parameters():
        p.copy_(torch.as_tensor(np.asarray(arrays[name])))


def adam_state(optimizer: Optional[torch.optim.Adam], named) -> Dict[str, Any]:
    """An Adam's moments and count over the (name, parameter) pairs `named`,
    as host numpy keyed by name: a checkpoint taken on the card loads on the
    CPU.  A parameter that never had a gradient has no moments (the JAX
    package's are zeros there, which move nothing), and an optimizer not
    made yet (None) has count 0."""
    named = list(named)
    opt = [optimizer.state.get(p, {}) if optimizer is not None else {} for _, p in named]
    steps = [int(s["step"]) for s in opt if "step" in s]
    return {
        "count": steps[0] if steps else 0,
        "exp_avg": {name: s["exp_avg"].to("cpu", copy=True).numpy() for (name, _), s in zip(named, opt) if s},
        "exp_avg_sq": {name: s["exp_avg_sq"].to("cpu", copy=True).numpy() for (name, _), s in zip(named, opt) if s},
    }


@torch.no_grad()
def load_adam_state(optimizer: torch.optim.Adam, named, state: Dict[str, Any]) -> None:
    """Inverse of adam_state: the moments onto the parameters' device."""
    optimizer.state.clear()
    if not state["count"]:
        return
    for name, p in named:
        if name in state["exp_avg"]:
            optimizer.state[p] = {
                "step": torch.tensor(float(state["count"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(state["exp_avg"][name]).to(p.device),
                "exp_avg_sq": torch.as_tensor(state["exp_avg_sq"][name]).to(p.device),
            }
