"""Model catalog: policy/value networks for TorchPolicy, as nn.Modules.

Analog of the reference's model catalog (reference:
rllib/models/catalog.py — picks fcnet vs visionnet from the obs space;
conv defaults in rllib/models/utils.py get_filter_config and the torch
vision net rllib/models/torch/visionnet.py).  The port of the JAX
package's `rllib/models.py`: each model's forward returns BOTH policy
logits and value so the trunk is computed once, and the catalog keys are
the same (`type`, `hidden`, `conv_filters`, `compute_dtype`).

Layouts are the port's own: `nn.Linear` weights are [out, in], conv
kernels OIHW, and the CNN flattens its last feature map in NCHW order
(c, h, w).  `ray_tpu_torch.models.convert.rllib_params_from_jax` turns
a JAX policy's parameter tree into these state dicts.  Weights are
drawn from the reference's distributions (normal with variance
scale / fan_in, zero biases) by an explicit `torch.Generator`; JAX's
threefry streams are not reproduced.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _linear(fan_in: int, fan_out: int, gen: torch.Generator, scale: float = 2.0) -> nn.Linear:
    layer = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(fan_out, fan_in, generator=gen) * (scale / fan_in) ** 0.5)
        layer.bias.zero_()
    return layer


def mlp_init(sizes: Sequence[int], generator: torch.Generator) -> nn.ModuleList:
    """A dense stack as a layer list, named `0`, `1`, ... as the JAX tree's
    list (shared by the catalog models and the off-policy actors and
    critics)."""
    return nn.ModuleList(_linear(fi, fo, generator) for fi, fo in zip(sizes[:-1], sizes[1:]))


def relu_mlp(layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    """ReLU between the layers and none after the last: the JAX package's
    `sac._mlp_apply`, which SAC's critics and TD3's actor and critics use
    (the catalog's towers use tanh)."""
    for i, layer in enumerate(layers):
        h = layer(h)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


class TwinQ(nn.Module):
    """Two Q critics over concat(obs, action), as the JAX tree
    `{"q1": [...], "q2": [...]}`.  With `twin=False` (DDPG) q2 is kept
    but unused and forward returns (q1, q1), as the reference does."""

    def __init__(self, in_dim: int, hidden: Sequence[int], generator: torch.Generator, twin: bool = True):
        super().__init__()
        self.twin = twin
        self.q1 = mlp_init((in_dim, *hidden, 1), generator)
        self.q2 = mlp_init((in_dim, *hidden, 1), generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act], dim=-1)
        q1 = relu_mlp(self.q1, x)[..., 0]
        return (q1, relu_mlp(self.q2, x)[..., 0]) if self.twin else (q1, q1)


def _tanh_stack(layers: nn.ModuleList, h: torch.Tensor, last_act: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = layer(h)
        if last_act or i < len(layers) - 1:
            h = torch.tanh(h)
    return h


class MLPModel(nn.Module):
    """Separate pi / vf towers of tanh dense layers."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 hidden: Sequence[int] = (64, 64), generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.pi = mlp_init((self.obs_dim, *self.hidden, num_actions), gen)
        self.vf = mlp_init((self.obs_dim, *self.hidden, 1), gen)

    def forward(self, obs: torch.Tensor):
        x = obs.reshape(obs.shape[0], -1).float()
        return _tanh_stack(self.pi, x, False), _tanh_stack(self.vf, x, False)[..., 0]


class CNNModel(nn.Module):
    """Shared conv trunk + linear pi/vf heads (nature-CNN shape).

    Observations arrive NHWC (uint8 frames stay uint8 through the
    host-to-device copy, 4x smaller, and are divided by 255 on the device)
    and are viewed as NCHW by a permute: a channels-last tensor, which
    cuDNN takes without a copy.  `compute_dtype="bfloat16"` casts the
    weights at each use, runs the activations in bf16 and returns float32
    logits and value."""

    def __init__(
        self,
        obs_shape: Tuple[int, int, int],
        num_actions: int,
        conv_filters: Sequence[Tuple[int, int, int]] = ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
        hidden: int = 512,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(obs_shape) != 3:
            raise ValueError(f"CNNModel wants HWC obs, got {obs_shape}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, not {compute_dtype!r}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.conv_filters = tuple(tuple(f) for f in conv_filters)
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        h, w, c_in = obs_shape
        convs = []
        for c_out, k, s in self.conv_filters:
            conv = nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=s)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(c_out, c_in, k, k, generator=gen) * (2.0 / (k * k * c_in)) ** 0.5)
                conv.bias.zero_()
            convs.append(conv)
            h, w, c_in = (h - k) // s + 1, (w - k) // s + 1, c_out
        self.conv = nn.ModuleList(convs)
        self.out_hwc = (h, w, c_in)  # the last feature map (VALID padding)
        self.trunk = _linear(h * w * c_in, hidden, gen)
        # small-scale heads (standard PPO init: policy logits start ~0)
        self.pi = _linear(hidden, num_actions, gen, scale=0.02)
        self.vf = _linear(hidden, 1, gen, scale=1.0)

    def forward(self, obs: torch.Tensor):
        dtype = _DTYPES[self.compute_dtype]
        x = obs.float()
        if obs.dtype == torch.uint8:
            x = x / 255.0
        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC memory viewed as NCHW
        for conv in self.conv:
            x = F.relu(F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=conv.stride))
        x = x.reshape(x.shape[0], -1)  # (c, h, w) order
        x = F.relu(F.linear(x, self.trunk.weight.to(dtype), self.trunk.bias.to(dtype)))
        logits = F.linear(x, self.pi.weight.to(dtype), self.pi.bias.to(dtype)).float()
        value = F.linear(x, self.vf.weight.to(dtype), self.vf.bias.to(dtype)).float()[..., 0]
        return logits, value


class GaussianMLPModel(nn.Module):
    """Continuous-action actor: tanh MLP trunk → (mean, log_std) heads, plus
    a separate value tower (reference analog: the catalog wiring a
    DiagGaussian head for Box action spaces, rllib/models/catalog.py).
    forward returns ((mean, log_std), value)."""

    def __init__(self, obs_shape: Tuple[int, ...], act_dim: int,
                 hidden: Sequence[int] = (64, 64), generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.act_dim = int(act_dim)
        self.hidden = tuple(hidden)
        self.trunk = mlp_init((self.obs_dim, *self.hidden), gen)
        self.mean = _linear(self.hidden[-1], self.act_dim, gen, scale=0.02)
        self.log_std = _linear(self.hidden[-1], self.act_dim, gen, scale=0.02)
        self.vf = mlp_init((self.obs_dim, *self.hidden, 1), gen)

    def forward(self, obs: torch.Tensor):
        x = obs.reshape(obs.shape[0], -1).float()
        return self.dist_inputs(x), _tanh_stack(self.vf, x, False)[..., 0]

    def dist_inputs(self, obs: torch.Tensor):
        """(mean, log_std) alone: SAC's actor, which has no use for the value
        tower."""
        h = _tanh_stack(self.trunk, obs.reshape(obs.shape[0], -1).float(), True)
        return self.mean(h), self.log_std(h)


def get_model(
    obs_shape: Tuple[int, ...],
    num_actions: int,
    model_config: Optional[Dict[str, Any]] = None,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Pick a model from the obs shape (reference analog:
    rllib/models/catalog.py ModelCatalog.get_model_v2): rank-3 obs get the
    conv net, flat obs the MLP.  model_config keys: type ("auto" | "mlp" |
    "cnn" | "gaussian_mlp"), hidden, conv_filters, compute_dtype.  The
    model's weights are drawn from `generator` on the CPU."""
    cfg = dict(model_config or {})
    kind = cfg.pop("type", "auto")
    if kind == "auto":
        kind = "cnn" if len(obs_shape) == 3 else "mlp"
    if kind == "cnn":
        return CNNModel(obs_shape, num_actions, generator=generator, **cfg)
    if kind == "mlp":
        return MLPModel(obs_shape, num_actions, hidden=cfg.pop("hidden", (64, 64)), generator=generator)
    if kind == "gaussian_mlp":
        return GaussianMLPModel(obs_shape, num_actions, hidden=cfg.pop("hidden", (64, 64)), generator=generator)
    raise ValueError(f"unknown model type {kind!r}")
