"""Replay buffers: uniform ring + proportional prioritized.

Analog of the reference's replay buffers (reference:
rllib/utils/replay_buffers/replay_buffer.py:68 ReplayBuffer — ring of
SampleBatches with uniform sampling — and
prioritized_replay_buffer.py PrioritizedReplayBuffer over a segment
tree).  Columnar storage here: one preallocated numpy array per key,
so sampling a minibatch is one fancy-index per column (feeds the
learner without per-row Python work), and pixel observations stay uint8
end-to-end.

A numpy copy of the JAX package's `rllib/replay_buffer.py`: the same seed
draws the same indexes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer of transitions (columnar)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch):
        n = len(batch)
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]), v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, batch_size)
        return SampleBatch({k: c[idx] for k, c in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ∝ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max w (reference:
    rllib/utils/replay_buffers/prioritized_replay_buffer.py).  Priorities
    live in a flat array; sampling normalizes once per draw — O(N) per
    sample instead of a segment tree's O(log N), which at RL batch sizes
    is a single vectorized numpy pass and wins in practice."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._prio = np.zeros(self.capacity, np.float64)
        self._max_prio = 1.0

    def add(self, batch: SampleBatch):
        idx = super().add(batch)
        if idx is not None:
            self._prio[idx] = self._max_prio**self.alpha
        return idx

    def sample(self, batch_size: int, beta: float = 0.4):
        p = self._prio[: self._size]
        probs = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = SampleBatch({k: c[idx] for k, c in self._cols.items()})
        out["weights"] = weights
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._prio[np.asarray(idx)] = priorities**self.alpha
        self._max_prio = max(self._max_prio, float(priorities.max()))
