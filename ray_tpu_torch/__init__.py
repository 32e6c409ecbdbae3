"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside `ray_tpu` that imports `torch` and nothing of JAX or of
`ray_tpu`.  Its entry points run on the CUDA device unless the caller asks
for the CPU (`device="cpu"`), where every kernel is replaced by its plain
PyTorch version.

Layout mirrors `ray_tpu`: `ops/` holds the attention kernels and the fused
cross entropy, `models/` the GPT-2 model, its training step and the weight
converter from the JAX package's parameter pytree.
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
