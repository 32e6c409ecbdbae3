"""Weights across frameworks: the JAX parameter pytrees -> the port's models.

GPT-2: the JAX model (`ray_tpu/models/gpt2.py`) keeps numpy-convertible
leaves with the layers stacked on a leading [n_layer] axis and matmul
weights in `x @ W` layout ([in, out]); the port keeps one block per layer
and nn.Linear's [out, in] layout.  These functions move whole trees between
the two, so both frameworks can run from the same weights.

Llama: the port's `LlamaModel` keeps the JAX layout itself (stacked layers,
[in, out] weights), so `llama_params_from_jax` only renames leaves and
keeps each dtype.
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


def _tensor(value) -> torch.Tensor:
    """A numpy array (or anything np.asarray takes) as a CPU tensor of the
    same dtype; bfloat16 arrays (ml_dtypes) move bit for bit."""
    arr = np.array(value)  # a writable contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def llama_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX Llama parameter pytree (`ray_tpu/models/llama.py`, numpy
    leaves) as the port's `LlamaModel` state: a dict keyed by parameter
    name (`tok_emb`, `out_head`, `final_norm`, `layers.<leaf>`) of CPU
    tensors, with the stacked [L, ...] layout and each dtype kept.  Load it
    with `LlamaModel.load_state_dict` or pass it as `ShardedLLM(init=...)`."""
    state = {name: _tensor(params[name]) for name in ("tok_emb", "out_head", "final_norm")}
    state.update({f"layers.{leaf}": _tensor(value) for leaf, value in params["layers"].items()})
    return state


def rllib_params_from_jax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX RLlib policy's parameter tree (`JaxPolicy.params` or
    `get_weights()`, numpy leaves; `ray_tpu/rllib/models.py`) as `model`'s
    state dict of float32 CPU tensors, for `model.load_state_dict`.

    A layer `{"w", "b"}` at tree path `a/0` becomes `a.0.weight` and
    `a.0.bias` (at `0`, the root of a layer list, `0.weight`): dense `w` [in, out] is transposed to `nn.Linear`'s
    [out, in], conv `w` HWIO to OIHW.  The CNN trunk's input rows are
    permuted once from the reference's NHWC flatten order (h, w, c) to the
    port's NCHW order (c, h, w), so the port's forward stays NCHW.  The map
    is linear, so a gradient tree converts the same way."""
    from ray_tpu_torch.rllib.models import CNNModel

    state: Dict[str, torch.Tensor] = {}

    def weight(w: np.ndarray, name: str) -> np.ndarray:
        if w.ndim == 4:  # HWIO -> OIHW
            return w.transpose(3, 2, 0, 1)
        if name == "trunk" and isinstance(model, CNNModel):
            h, wd, c = model.out_hwc
            w = w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(h * wd * c, -1)
        return w.T

    def walk(node, name: str) -> None:
        if isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, f"{name}.{i}" if name else str(i))
        elif "w" in node:
            state[f"{name}.weight"] = torch.from_numpy(np.array(weight(np.asarray(node["w"], np.float32), name)))
            state[f"{name}.bias"] = torch.from_numpy(np.array(node["b"], np.float32))
        else:
            for key, sub in node.items():
                walk(sub, f"{name}.{key}" if name else key)

    walk(params, "")
    return state
