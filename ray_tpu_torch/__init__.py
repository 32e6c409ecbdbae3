"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside `ray_tpu` that imports `torch` and nothing of JAX or of
`ray_tpu`.  Its entry points run on the CUDA device unless the caller asks
for the CPU (`device="cpu"`), where every kernel is replaced by its plain
PyTorch version.

Layout mirrors `ray_tpu`: `ops/` holds the attention kernels and the fused
cross entropy, `models/` the GPT-2 model, its training step and the weight
converter from the JAX package's parameter pytree.  The runtime core (head,
raylet, core worker, zygote, object store, collectives) and the trainer
(`train.TorchTrainer` → `BackendExecutor` → a GPU worker actor) keep the JAX
package's layout and public API: `init`, `remote`, `get`, `put`, actors,
placement groups.  `serve` (deployments, handles, the controller, the HTTP
proxy and `serve.llm`'s Llama deployment) keeps the JAX package's layout
too, and `rllib` holds RLlib's on-policy family (PPO with its learner on
the card, rollout workers as CPU actors; IMPALA, APPO, DDPPO).  Head,
raylet and zygote never import torch; a worker imports it when its task
does.
"""

__version__ = "0.1.0"

from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch._private.worker import (  # noqa: F401
    cancel,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction, remote  # noqa: F401
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401


def __getattr__(name):
    # resolve_device imports torch: loaded on first use, so the head, the
    # raylet and the zygote (which import this package) stay torch-free
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device

        return resolve_device
    # `ray_tpu_torch.serve` without an import of its own, loaded on first use
    if name == "serve":
        import importlib

        return importlib.import_module("ray_tpu_torch.serve")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def cluster_resources():
    from ray_tpu_torch._private import worker as _w

    return _w._require_connected().cluster_resources()


def available_resources():
    from ray_tpu_torch._private import worker as _w

    return _w._require_connected().available_resources()


def timeline(filename=None):
    """Chrome-trace events of recent task executions (reference:
    ray.timeline / `ray timeline`).  Load the file in chrome://tracing."""
    import json as _json

    from ray_tpu_torch._private import worker as _w
    from ray_tpu_torch._private.protocol import MsgType as _M

    events = _w._require_connected().request(_M.TIMELINE, {})["events"]
    if filename:
        with open(filename, "w") as f:
            _json.dump(events, f)
    return events


def nodes():
    from ray_tpu_torch._private import worker as _w

    out = []
    for n in _w._require_connected().list_nodes():
        out.append(
            {
                "NodeID": n["node_id"].hex(),
                "Alive": n["alive"],
                "Resources": n["resources"],
                "Available": n["available"],
                "Labels": n.get("labels", {}),
            }
        )
    return out


# Submodules commonly accessed as attributes (ray.util.*, ray.air.* style)
from ray_tpu_torch import util  # noqa: F401, E402

__all__ = [
    "ObjectRef", "available_resources", "cancel", "cluster_resources", "get",
    "get_actor", "get_runtime_context", "init", "is_initialized", "kill",
    "nodes", "put", "remote", "resolve_device", "serve", "shutdown", "timeline", "wait",
]
