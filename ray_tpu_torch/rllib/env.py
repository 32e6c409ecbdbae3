"""Vector envs: batched env stepping for rollout workers.

Analog of the reference's vector env stack (reference:
rllib/env/vector_env.py:23 VectorEnv / :191 _VectorizedGymEnv wrapping N
scalar gym envs with auto-reset).  The policy forward has a fixed cost a
call (kernel launches on the card, operator dispatch on the CPU) that
dominates at batch 1 — N envs stepped per forward amortize it N-fold,
which is what makes env-steps/s a real number (BASELINE config #3).

A numpy copy of the JAX package's `rllib/env.py`: the same seed gives the
same frames, byte for byte.

Two flavors:
- ``SyncVectorEnv`` wraps N independent scalar (gymnasium-API) envs.
- Natively vectorized envs (e.g. ``SyntheticPixelEnv``) implement the
  whole batch in numpy — no per-env Python loop at all.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np


class Box:
    """Minimal box-space stand-in (shape + dtype [+ bounds]).  With
    low/high set it also serves as a continuous ACTION space (reference
    analog: gym.spaces.Box used by SAC/DDPG action heads)."""

    def __init__(self, shape: Tuple[int, ...], dtype=np.float32, low=None, high=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.low = None if low is None else np.broadcast_to(low, self.shape).astype(np.float32)
        self.high = None if high is None else np.broadcast_to(high, self.shape).astype(np.float32)


class Discrete:
    """Minimal action-space stand-in (n actions)."""

    def __init__(self, n: int):
        self.n = int(n)


class VectorEnv:
    """Batched env interface.  reset() -> obs[N]; step(actions[N]) ->
    (obs[N], rewards[N], dones[N], infos) with AUTO-RESET: a done env's
    returned obs is its next episode's first observation, and its
    terminal reward/done are reported for that step."""

    num_envs: int
    observation_space: Any
    action_space: Any

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError


class SyncVectorEnv(VectorEnv):
    """N scalar gymnasium-style envs stepped in a Python loop (reference
    analog: rllib/env/vector_env.py:191 _VectorizedGymEnv)."""

    def __init__(self, envs: List[Any]):
        assert envs
        self.envs = envs
        self.num_envs = len(envs)
        self.observation_space = envs[0].observation_space
        self.action_space = envs[0].action_space

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            o, _info = e.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions: np.ndarray):
        obs_out, rews, dones, infos = [], [], [], []
        for e, a in zip(self.envs, np.asarray(actions)):
            o, r, terminated, truncated, info = e.step(a.item() if hasattr(a, "item") else a)
            done = bool(terminated or truncated)
            if done:
                o, _ = e.reset()
            obs_out.append(o)
            rews.append(float(r))
            dones.append(done)
            infos.append(info)
        return (
            np.stack(obs_out),
            np.asarray(rews, np.float32),
            np.asarray(dones, bool),
            infos,
        )


def make_vector_env(env_creator: Callable, num_envs: int, seed: int = 0) -> VectorEnv:
    """env_creator() returning a VectorEnv is used as-is (natively
    vectorized); a scalar env gets wrapped with N-1 more instances."""
    first = env_creator()
    if isinstance(first, VectorEnv):
        return first
    envs = [first] + [env_creator() for _ in range(num_envs - 1)]
    v = SyncVectorEnv(envs)
    v.reset(seed=seed)
    return v


class PendulumEnv(VectorEnv):
    """Natively vectorized classic pendulum swing-up (the Pendulum-v1
    dynamics, gymnasium/envs/classic_control/pendulum.py, re-realized as
    one numpy batch — no per-env Python loop): obs [cos θ, sin θ, θ̇],
    torque action in [-max_torque, max_torque], reward
    -(θ² + 0.1 θ̇² + 0.001 u²), 200-step episodes with auto-reset.
    The continuous-control benchmark env for SAC (reference analog:
    Pendulum-v1 in rllib/algorithms/sac tuned examples)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    HORIZON = 200

    def __init__(self, num_envs: int = 16, seed: int = 0):
        self.num_envs = int(num_envs)
        self.observation_space = Box((3,), np.float32)
        self.action_space = Box(
            (1,), np.float32, low=-self.MAX_TORQUE, high=self.MAX_TORQUE
        )
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros(self.num_envs, np.float64)
        self._thdot = np.zeros(self.num_envs, np.float64)
        self._t = np.zeros(self.num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        return np.stack(
            [np.cos(self._th), np.sin(self._th), self._thdot], axis=-1
        ).astype(np.float32)

    def _spawn(self, idx: np.ndarray):
        k = len(idx)
        if not k:
            return
        self._th[idx] = self._rng.uniform(-np.pi, np.pi, k)
        self._thdot[idx] = self._rng.uniform(-1.0, 1.0, k)
        self._t[idx] = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._spawn(np.arange(self.num_envs))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(
            np.asarray(actions, np.float64).reshape(self.num_envs, -1)[:, 0],
            -self.MAX_TORQUE,
            self.MAX_TORQUE,
        )
        th_norm = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        rewards = -(th_norm**2 + 0.1 * self._thdot**2 + 0.001 * u**2)
        # g=10, m=1, l=1 dynamics
        self._thdot = np.clip(
            self._thdot
            + (1.5 * self.G * np.sin(self._th) + 3.0 * u) * self.DT,
            -self.MAX_SPEED,
            self.MAX_SPEED,
        )
        self._th = self._th + self._thdot * self.DT
        self._t += 1
        dones = self._t >= self.HORIZON
        # pendulum episodes only ever end by TIME LIMIT — flag it plus the
        # pre-reset observation (gym conventions) so off-policy learners
        # can bootstrap through the cut from the TRUE final state instead
        # of treating it as terminal or bootstrapping off the reset obs
        final = self._obs() if dones.any() else None
        self._spawn(np.nonzero(dones)[0])
        infos = [
            {"TimeLimit.truncated": True, "final_observation": final[i]}
            if d
            else {}
            for i, d in enumerate(dones)
        ]
        return self._obs(), rewards.astype(np.float32), dones, infos


class SyntheticPixelEnv(VectorEnv):
    """Natively vectorized 'Catch' at Atari frame geometry: 84x84x4 uint8
    frames, a ball falls from the top, a paddle at the bottom moves
    left/stay/right; reward lands when the ball does.  Synthetic stand-in
    for an Atari pixel env (no ROMs in the image) with the same
    obs/action contract as the reference's Atari preprocessing output
    (84x84 stacked frames, rllib/env/wrappers/atari_wrappers.py).

    shaped=True adds a dense per-step alignment bonus (fast learning for
    CI-sized tests); the terminal +1/-1 stays either way.
    """

    SIZE = 84
    BALL = 4  # ball block size (px)
    PADDLE_W = 12
    PADDLE_H = 3

    def __init__(
        self,
        num_envs: int = 16,
        frames: int = 4,
        fall_px: int = 4,
        shaped: bool = False,
        seed: int = 0,
    ):
        self.num_envs = int(num_envs)
        self.frames = int(frames)
        self.fall_px = int(fall_px)
        self.shaped = shaped
        self.observation_space = Box((self.SIZE, self.SIZE, frames), np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(seed)
        n = self.num_envs
        self._ball_r = np.zeros(n, np.int32)
        self._ball_c = np.zeros(n, np.int32)
        self._drift = np.zeros(n, np.int32)
        self._paddle = np.zeros(n, np.int32)
        self._stack = np.zeros((n, self.SIZE, self.SIZE, self.frames), np.uint8)

    # ------------------------------------------------------------ internals

    def _spawn(self, idx: np.ndarray):
        k = len(idx)
        if not k:
            return
        self._ball_r[idx] = 0
        self._ball_c[idx] = self._rng.integers(0, self.SIZE - self.BALL, k)
        self._drift[idx] = self._rng.integers(-1, 2, k)
        self._paddle[idx] = (self.SIZE - self.PADDLE_W) // 2

    def _render(self) -> np.ndarray:
        """One [N, 84, 84] uint8 frame from current state."""
        n = self.num_envs
        frame = np.zeros((n, self.SIZE, self.SIZE), np.uint8)
        rows = np.clip(self._ball_r, 0, self.SIZE - self.BALL)
        # block writes per env (N is small; the per-env work is a tiny slice)
        for i in range(n):
            r, c, p = rows[i], self._ball_c[i], self._paddle[i]
            frame[i, r : r + self.BALL, c : c + self.BALL] = 255
            frame[i, self.SIZE - self.PADDLE_H :, p : p + self.PADDLE_W] = 128
        return frame

    def _push_frame(self):
        self._stack[..., :-1] = self._stack[..., 1:]
        self._stack[..., -1] = self._render()

    # ------------------------------------------------------------- interface

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._spawn(np.arange(self.num_envs))
        self._stack[:] = 0
        self._push_frame()
        return self._stack.copy()

    def step(self, actions: np.ndarray):
        a = np.asarray(actions, np.int32)
        move = a - 1  # {0,1,2} -> {-1,0,+1}
        self._paddle = np.clip(
            self._paddle + move * 3, 0, self.SIZE - self.PADDLE_W
        )
        self._ball_r = self._ball_r + self.fall_px
        self._ball_c = np.clip(
            self._ball_c + self._drift, 0, self.SIZE - self.BALL
        )
        landed = self._ball_r >= self.SIZE - self.PADDLE_H - self.BALL
        ball_mid = self._ball_c + self.BALL // 2
        paddle_mid = self._paddle + self.PADDLE_W // 2
        dx = np.abs(ball_mid - paddle_mid)
        caught = dx <= self.PADDLE_W // 2
        rewards = np.where(landed, np.where(caught, 1.0, -1.0), 0.0).astype(np.float32)
        if self.shaped:
            rewards = rewards + 0.05 * (1.0 - dx / (self.SIZE / 2)).astype(np.float32)
        dones = landed
        # auto-reset landed envs (new ball, cleared stack for that env)
        idx = np.nonzero(landed)[0]
        if len(idx):
            self._spawn(idx)
            self._stack[idx] = 0
        self._push_frame()
        return self._stack.copy(), rewards, dones, [{}] * self.num_envs
