"""Helpers for user train loops (the prepare_model/prepare_data_loader
analogs — reference: python/ray/train/torch/train_loop_utils.py:56,132).

The loop gets (a) its data shard bounds and (b) a cross-worker gradient
allreduce over the dcn ring, for workers that are separate processes.
The device mesh of a worker's cards (`local_mesh`) waits for the port of
`parallel/` (ROADMAP, Queue 1: multi-GPU).
"""

from __future__ import annotations

from ray_tpu_torch.air import session


def local_mesh(config=None):
    """Mesh over the devices this worker owns: not ported yet."""
    raise NotImplementedError(
        "local_mesh waits for the port of parallel/ (ROADMAP, Queue 1: multi-GPU)"
    )


def get_data_shard(n_items: int):
    """[start, end) of this worker's shard (DistributedSampler analog)."""
    rank = session.get_world_rank()
    world = session.get_world_size()
    per = n_items // world
    start = rank * per
    end = start + per if rank < world - 1 else n_items
    return start, end


def all_reduce_gradients(grads, group_name: str = "_train_dp"):
    """Mean-allreduce gradients across the train worker group, over the
    dcn ring.  ``grads`` is a list or a dict of tensors (e.g.
    ``[p.grad for p in model.parameters()]``); the same container comes
    back, each tensor with its own dtype and device."""
    return all_reduce_tensors(grads, session.get_world_size(), group_name=group_name)


def all_reduce_tensors(grads, world: int, group_name: str = "_train_dp"):
    """Session-free mean-allreduce over an explicit world size;
    ``all_reduce_gradients`` is the session-bound wrapper."""
    import numpy as np
    import torch

    if world <= 1:
        return grads
    from ray_tpu_torch.util import collective

    keys = list(grads) if isinstance(grads, dict) else None
    leaves = [grads[k] for k in keys] if keys is not None else list(grads)
    # pack into one flat f32 buffer: one ring pass instead of one per tensor
    flat = torch.cat([t.detach().reshape(-1).to("cpu", torch.float32) for t in leaves])
    reduced = collective.allreduce(flat.numpy(), group_name=group_name)
    reduced = torch.from_numpy(np.ascontiguousarray(reduced, dtype=np.float32)) / world
    out = []
    off = 0
    for t in leaves:
        n = t.numel()
        out.append(reduced[off : off + n].reshape(t.shape).to(t.device, t.dtype))
        off += n
    if keys is not None:
        return type(grads)(zip(keys, out))
    return type(grads)(out)
