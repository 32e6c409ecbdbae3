"""Ops of the port: causal attention (hand-written CUDA kernels with a plain
PyTorch version) and the fused linear-head cross entropy."""
