"""Action distributions for continuous control.

The port of the JAX package's `rllib/distributions.py` (reference:
rllib/models/torch/torch_action_dist.py:236 TorchDiagGaussian, :316
TorchSquashedGaussian).  Plain functions on (mean, log_std) tensors.  A
sample takes its standard normals as `noise`, or draws them from
`generator` on the mean's device: the caller decides where randomness
comes from, so a test can inject the JAX package's own normals.

The squashed form is the SAC actor: a = tanh(u), u ~ N(mean, std), with
the exact change-of-variables correction
    log p(a) = log N(u) - sum_i log(1 - tanh(u_i)^2)
computed in the numerically-stable softplus form
    log(1 - tanh(u)^2) = 2 * (log 2 - u - softplus(-2u)),
finite where the naive form gives -inf (|u| > 9 in float32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def standard_normal(like: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normals of `like`'s shape, dtype and device, from `generator`."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def diag_gaussian_sample(mean, log_std, generator=None, noise=None):
    """mean + exp(log_std) * noise; noise drawn from `generator` if not given."""
    if noise is None:
        noise = standard_normal(mean, generator)
    return mean + torch.exp(log_std) * noise


def diag_gaussian_logp(x, mean, log_std):
    """log N(x; mean, exp(log_std)) summed over the action dim."""
    z = (x - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z**2 - log_std - _HALF_LOG_2PI, dim=-1)


def diag_gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 + _HALF_LOG_2PI, dim=-1)


def _log1m_tanh2(u):
    """log(1 - tanh(u)^2), stable for large |u| (softplus form)."""
    return 2.0 * (_LOG_2 - u - F.softplus(-2.0 * u))


def squashed_sample_logp(mean, log_std, generator=None, noise=None):
    """Reparameterized tanh-Gaussian sample in (-1, 1) and its log-prob.

    Returns (a, logp): a = tanh(u) with u = mean + std*noise (gradients flow
    through a), logp = log N(u) - sum log(1 - tanh(u)^2)."""
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    u = diag_gaussian_sample(mean, log_std, generator, noise)
    a = torch.tanh(u)
    logp = diag_gaussian_logp(u, mean, log_std) - torch.sum(_log1m_tanh2(u), dim=-1)
    return a, logp


def squashed_logp(a, mean, log_std, eps: float = 1e-6):
    """log-prob of a GIVEN squashed action in (-1, 1)."""
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    u = torch.atanh(torch.clamp(a, -1.0 + eps, 1.0 - eps))
    return diag_gaussian_logp(u, mean, log_std) - torch.sum(_log1m_tanh2(u), dim=-1)


def squashed_mode(mean):
    """Deterministic (evaluation) action."""
    return torch.tanh(mean)
