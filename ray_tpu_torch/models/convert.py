"""Weights across frameworks: the JAX GPT-2 parameter pytree <-> GPT2Model.

The JAX model (`ray_tpu/models/gpt2.py`) keeps numpy-convertible leaves with
the layers stacked on a leading [n_layer] axis and matmul weights in
`x @ W` layout ([in, out]); the port keeps one block per layer and
nn.Linear's [out, in] layout.  These functions move whole trees between the
two, so both frameworks can run from the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.gpt2 import GPT2Model

# stacked JAX leaf -> (block attribute path, transpose to [out, in])
_LAYER_LEAVES = {
    "ln1_scale": ("ln1.weight", False),
    "ln1_bias": ("ln1.bias", False),
    "ln2_scale": ("ln2.weight", False),
    "ln2_bias": ("ln2.bias", False),
    "qkv_w": ("qkv.weight", True),
    "qkv_b": ("qkv.bias", False),
    "proj_w": ("proj.weight", True),
    "proj_b": ("proj.bias", False),
    "mlp_in_w": ("mlp_in.weight", True),
    "mlp_in_b": ("mlp_in.bias", False),
    "mlp_out_w": ("mlp_out.weight", True),
    "mlp_out_b": ("mlp_out.bias", False),
}


@torch.no_grad()
def gpt2_from_jax_params(params_np: Mapping, model: GPT2Model) -> GPT2Model:
    """Copy a JAX GPT-2 pytree (numpy leaves, as `GPT2Model.init` makes it)
    into `model`, in place; returns `model`."""
    state = model.state_dict()

    def put(name: str, value) -> None:
        dst = state[name]
        src = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != port shape {tuple(dst.shape)}")
        dst.copy_(src)

    put("wte", params_np["wte"])
    put("wpe", params_np["wpe"])
    put("ln_f.weight", params_np["ln_f"]["scale"])
    put("ln_f.bias", params_np["ln_f"]["bias"])
    layers = params_np["layers"]
    for leaf, (attr, transpose) in _LAYER_LEAVES.items():
        stacked = np.asarray(layers[leaf])
        for i in range(model.config.n_layer):
            put(f"blocks.{i}.{attr}", stacked[i].T if transpose else stacked[i])
    return model


def jax_params_from_state(state: Mapping[str, torch.Tensor], n_layer: int) -> Dict:
    """A JAX-layout pytree of float32 numpy arrays from port tensors keyed by
    parameter name: `dict(model.named_parameters())` for the weights, or the
    same names mapped to `.grad` for the gradients."""

    def get(name: str) -> np.ndarray:
        return state[name].detach().float().cpu().numpy()

    layers = {}
    for leaf, (attr, transpose) in _LAYER_LEAVES.items():
        per_layer = [get(f"blocks.{i}.{attr}") for i in range(n_layer)]
        layers[leaf] = np.stack([w.T if transpose else w for w in per_layer])
    return {
        "wte": get("wte"),
        "wpe": get("wpe"),
        "ln_f": {"scale": get("ln_f.weight"), "bias": get("ln_f.bias")},
        "layers": layers,
    }


def gpt2_to_jax_params(model: GPT2Model) -> Dict:
    """The inverse of `gpt2_from_jax_params`: `model`'s weights as a JAX
    GPT-2 pytree of float32 numpy arrays."""
    return jax_params_from_state(dict(model.named_parameters()), model.config.n_layer)
