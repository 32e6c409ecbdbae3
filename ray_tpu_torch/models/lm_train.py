"""LM training step: the port of `ray_tpu/models/lm_train.py` on one device.

`make_train_step` returns the same (init, step) bundle as the JAX version:
global-norm clipping as `optax.clip_by_global_norm` computes it, then AdamW
as `optax.adamw` does it (b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay
on every parameter), and metrics {"loss", "grad_norm"} with the norm taken
before clipping.  PyTorch updates the module in place; `step` returns it so
that callers read the same as with the JAX bundle.  A mesh (dp/fsdp/tp) is
a later slice of the port.

`make_lm_step_spec` and its stage functions (`_lm_build` … `_lm_restore`)
port the JAX module's step spec: the run that the eager per-step path and
the resident step DAG (train/torch/step_dag.py) both drive, in float32
compute with plain Adam.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model


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


# ---------------------------------------------------------------- step spec


def _deterministic_on_the_card() -> None:
    """Make every CUDA op of the step run the same sums in the same order
    from run to run, as the reference's XLA step does: the attention
    kernels add dq in a fixed order already; this picks PyTorch's
    deterministic algorithms (and raises on an op that has none) and a fixed
    cuBLAS workspace, which torch requires for deterministic matmuls across
    streams.  Process-wide, in the worker that trains; set before its first
    cuBLAS call.  Uninitialized memory is not filled: that is a debugging
    aid, and the kernels write every element they return."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def _lm_build(config, rank, world):
    """Worker-side build for the LM TrainStepSpec: the model in float32
    compute and plain Adam (optax.adam's formula and defaults: b1 0.9, b2
    0.999, eps 1e-8), params device-resident from here on.  Same init seed
    on every rank (the DP contract).  On the card the step is made
    deterministic (`_deterministic_on_the_card`), so that the eager path and
    the step DAG give bit-equal losses and weights."""
    dev = resolve_device(config["device"])
    if dev.type == "cuda":
        _deterministic_on_the_card()
    cfg = getattr(GPT2Config, config["model"])(compute_dtype=torch.float32)
    model = GPT2Model(cfg, device=dev, seed=int(config["init_seed"]))
    opt = torch.optim.Adam(model.parameters(), lr=float(config["lr"]), betas=(0.9, 0.999), eps=1e-8)
    return {
        "cfg": cfg,
        "model": model,
        "opt": opt,
        "device": dev,
        "rank": rank,
        "world": world,
        "batch": int(config["batch"]),
        "seq": int(config["seq"]),
        "sync_grads": bool(config["sync_grads"]),
        "data_seed": int(config["data_seed"]),
        "group": str(config.get("collective_group", "_train_dp")),
    }


def _lm_data(state, idx):
    """Deterministic in (rank, step_idx), drawn on the host: checkpoint-
    resume replays the exact stream, which is what makes resumed weights
    bit-identical.  `_lm_h2d` moves the batch to the device."""
    gen = torch.Generator().manual_seed(state["data_seed"] + idx * 1000 + state["rank"])
    return synthetic_batch(gen, state["batch"], state["seq"], state["cfg"].vocab_size, device="cpu")


def _lm_h2d(state, batch):
    return tuple(t.to(state["device"]) for t in batch)


def _lm_step(state, batch):
    tokens, targets = batch
    model, opt = state["model"], state["opt"]
    opt.zero_grad(set_to_none=True)
    loss = model.loss(tokens, targets)
    loss.backward()
    if state["world"] > 1 and state["sync_grads"]:
        from ray_tpu_torch.train.torch.train_loop_utils import all_reduce_tensors

        params = [p for p in model.parameters() if p.grad is not None]
        reduced = all_reduce_tensors([p.grad for p in params], state["world"], group_name=state["group"])
        for p, g in zip(params, reduced):
            p.grad = g
    opt.step()
    return {"loss": loss.detach()}


def _lm_fold(state, metrics):
    return {"loss": float(metrics["loss"])}


def _lm_snapshot(state):
    """Params and Adam state as host numpy, keyed by parameter name; the
    Adam step count as optax's `count`."""
    model, opt = state["model"], state["opt"]
    named = list(model.named_parameters())
    per = [opt.state.get(p, {}) for _, p in named]

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "params": {n: host(p) for n, p in named},
        "opt_state": {
            "count": np.asarray(int(per[0]["step"]) if per[0] else 0, dtype=np.int32),
            "mu": {n: host(s["exp_avg"]) for (n, _), s in zip(named, per) if s},
            "nu": {n: host(s["exp_avg_sq"]) for (n, _), s in zip(named, per) if s},
        },
    }


@torch.no_grad()
def _lm_restore(state, snap):
    model, opt = state["model"], state["opt"]
    dev = state["device"]
    count = int(snap["opt_state"]["count"])
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.asarray(snap["params"][name])))
        if count:
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.from_numpy(np.array(snap["opt_state"]["mu"][name])).to(dev),
                "exp_avg_sq": torch.from_numpy(np.array(snap["opt_state"]["nu"][name])).to(dev),
            }


def make_lm_step_spec(
    model: str = "tiny",
    *,
    batch: int = 4,
    seq: Optional[int] = None,
    steps: int = 10,
    learning_rate: float = 1e-2,
    checkpoint_every: int = 0,
    sync_grads: bool = True,
    init_seed: int = 0,
    data_seed: int = 1,
    collective_group: str = "_train_dp",
    name: str = "lm_train_dag",
    device: Device = "cuda",
):
    """A GPT-2 training run as a ``TrainStepSpec`` (train/torch/step_dag.py):
    the SAME stage functions drive both the eager per-step path and the
    gang-scheduled resident DAG, so eager-vs-dag weight equality is a
    property of the system, not the workload.  ``device`` is where each
    worker trains: the card unless the caller asks for "cpu"."""
    from ray_tpu_torch.train.torch.step_dag import TrainStepSpec

    cfg = getattr(GPT2Config, model)()
    seq = seq or cfg.block_size
    return TrainStepSpec(
        build=_lm_build,
        data=_lm_data,
        step=_lm_step,
        fold=_lm_fold,
        h2d=_lm_h2d,
        snapshot=_lm_snapshot,
        restore=_lm_restore,
        steps=steps,
        checkpoint_every=checkpoint_every,
        config={
            "model": model,
            "batch": batch,
            "seq": seq,
            "lr": learning_rate,
            "sync_grads": sync_grads,
            "init_seed": init_seed,
            "data_seed": data_seed,
            # must match TorchConfig.group_name (default TRAIN_GROUP): the
            # step stage reduces on this group, the backend creates it
            "collective_group": collective_group,
            "device": str(device),
        },
        name=name,
        flops_per_step=cfg.flops_per_token() * batch * seq,
    )
