"""APPO: asynchronous PPO — IMPALA's actor-learner pipeline with the
clipped-surrogate objective on V-trace-corrected advantages.

The port of the JAX package's `rllib/appo.py` (reference:
rllib/algorithms/appo/appo.py — "IMPALA + PPO surrogate loss"; the torch
loss combines the PPO clip with V-trace targets in appo_torch_policy.py).
Everything structural — async fragment streaming, loader thread, learner
thread — is inherited from `ray_tpu_torch.rllib.impala.IMPALA`; the only
delta is the policy's ``vtrace_clip`` objective switch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig


@dataclass
class APPOConfig(IMPALAConfig):
    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    def _extra_policy_config(self) -> Dict[str, Any]:
        return {"vtrace_clip": True}
