"""SampleBatch: columnar rollout storage.

Analog of the reference's SampleBatch (reference:
rllib/policy/sample_batch.py — dict of parallel arrays with
concat_samples / slicing; standard keys OBS/ACTIONS/REWARDS/DONES/...).
A numpy copy of the JAX package's `rllib/sample_batch.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGPS = "action_logp"
VALUES = "vf_preds"
ADVANTAGES = "advantages"
RETURNS = "value_targets"


class SampleBatch(dict):
    """dict[str, np.ndarray] with aligned first dims."""

    def __len__(self):
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([np.asarray(b[k]) for b in batches]) for k in keys}
        )

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        idx = rng.permutation(len(self))
        return SampleBatch({k: np.asarray(v)[idx] for k, v in self.items()})

    def minibatches(self, size: int):
        n = len(self)
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: np.asarray(v)[start : start + size] for k, v in self.items()})
