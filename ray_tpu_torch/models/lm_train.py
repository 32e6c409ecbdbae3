"""LM training step: the port of `ray_tpu/models/lm_train.py` on one device.

`make_train_step` returns the same (init, step) bundle as the JAX version:
global-norm clipping as `optax.clip_by_global_norm` computes it, then AdamW
as `optax.adamw` does it (b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay
on every parameter), and metrics {"loss", "grad_norm"} with the norm taken
before clipping.  PyTorch updates the module in place; `step` returns it so
that callers read the same as with the JAX bundle.  A mesh (dp/fsdp/tp) is
a later slice of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.gpt2 import GPT2Model


class TrainStepBundle(NamedTuple):
    init: Callable[..., Tuple[GPT2Model, torch.optim.Optimizer]]  # (seed) -> (params, opt_state)
    # (params, opt_state, tokens, targets) -> (params, opt_state, metrics)
    step: Callable[..., Tuple[GPT2Model, torch.optim.Optimizer, Dict[str, torch.Tensor]]]
    device: torch.device


def make_train_step(
    model: GPT2Model,
    *,
    device: Device = "cuda",
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> TrainStepBundle:
    dev = resolve_device(device)
    model.to(dev)

    def init(seed: int = 0) -> Tuple[GPT2Model, torch.optim.Optimizer]:
        """Fresh weights from `seed` and a fresh optimizer state."""
        model.init_weights(seed)
        opt = torch.optim.AdamW(
            model.parameters(),
            lr=learning_rate,
            betas=(0.9, 0.95),
            eps=1e-8,
            weight_decay=weight_decay,
        )
        return model, opt

    def step(params: GPT2Model, opt_state: torch.optim.Optimizer, tokens, targets):
        opt_state.zero_grad(set_to_none=True)
        loss = params.loss(tokens, targets)
        loss.backward()
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax.clip_by_global_norm: g * (clip / norm) once the norm reaches
        # clip, untouched below (clip_grad_norm_ would add 1e-6 to the norm)
        coef = torch.where(gnorm < grad_clip, torch.ones_like(gnorm), grad_clip / gnorm)
        for g in grads:
            g.mul_(coef)
        opt_state.step()
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStepBundle(init, step, dev)


def synthetic_batch(
    generator: torch.Generator, batch: int, seq: int, vocab: int, device: Device = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic synthetic LM batch: (tokens, targets), each [batch, seq]
    int64, the targets shifted one place.  Drawn on the generator's device."""
    dev = resolve_device(device)
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=generator, device=generator.device)
    tokens = tokens.to(dev)
    return tokens[:, :-1], tokens[:, 1:]
