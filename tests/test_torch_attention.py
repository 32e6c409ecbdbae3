"""ray_tpu_torch causal attention against the JAX package's.

On the CPU every impl name of the port runs its plain version, so these
tests hold that version (and the impl dispatch around it) against
`ray_tpu.ops.attention._xla_causal_attention` and against the real splash
kernel run in Pallas interpret mode.  The CUDA kernels themselves are held
against the plain version on the card by chip_smoke.py.

Tolerances: f32 forward 2e-6 and grads 2e-5 absolute (outputs and grads are
O(1); the two frameworks sum the S=256 dot products in different orders,
which costs a few f32 ulps per element).  bf16: 1e-2 absolute, two bf16
ulps at O(1) magnitudes, for roundings placed differently by XLA and torch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _xla_causal_attention
from ray_tpu_torch.ops import attention as port

B, S, H = 2, 256, 2


def _inputs(D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_xla(D):
    q, k, v, do = _inputs(D)
    out, vjp = jax.vjp(lambda q, k, v: _xla_causal_attention(q, k, v, D**-0.5), q, k, v)
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _port(D, impl, dtype=torch.float32, scores_dtype=torch.float32):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(D))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = port.causal_attention(q, k, v, impl=impl, scores_dtype=scores_dtype)
    out.backward(do)
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("impl", port.IMPLS)
def test_every_impl_matches_jax_xla_f32(impl, D):
    for name, got, want, tol in zip(
        ("out", "dq", "dk", "dv"), _port(D, impl), _jax_xla(D), (2e-6, 2e-5, 2e-5, 2e-5)
    ):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("scores", ["f32", "bf16"])
def test_plain_matches_jax_xla_bf16(scores):
    D = 64
    sd_jax, sd_torch = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[scores]
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(D))
    out, vjp = jax.vjp(
        lambda q, k, v: _xla_causal_attention(q, k, v, D**-0.5, sd_jax), q, k, v
    )
    want = [np.asarray(t, np.float32) for t in (out, *vjp(do))]
    got = _port(D, "xla", torch.bfloat16, sd_torch)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_interpret_mode_splash(D):
    """The splash kernel the JAX package launches on a TPU, run in interpret
    mode with `_splash_kernel`'s BlockSizes fields at block 128 and vmapped
    over batch on pre-scaled q, as `_splash_causal_attention` does."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
        splash_attention_mask as smask,
    )

    blk = 128
    mask = smask.MultiHeadMask([smask.CausalMask((S, S)) for _ in range(H)])
    bs = sk.BlockSizes(
        block_q=blk,
        block_kv=blk,
        block_kv_compute=blk,
        block_q_dkv=blk,
        block_kv_dkv=blk,
        block_kv_dkv_compute=blk,
        use_fused_bwd_kernel=True,
        k_layout=sk.QKVLayout.SEQ_MINOR,
        v_layout=sk.QKVLayout.SEQ_MINOR,
    )
    kernel = sk.make_splash_mha(mask, block_sizes=bs, head_shards=1, q_seq_shards=1, interpret=True)

    def splash(q, k, v):
        qt = (q * q.dtype.type(D**-0.5)).transpose(0, 2, 1, 3)
        out = jax.vmap(kernel)(qt, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3))
        return out.transpose(0, 2, 1, 3)

    q, k, v, do = _inputs(D)
    out, vjp = jax.vjp(splash, q, k, v)
    want = [np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do)))]
    for name, got, w, tol in zip(
        ("out", "dq", "dk", "dv"), _port(D, "splash"), want, (2e-6, 2e-5, 2e-5, 2e-5)
    ):
        np.testing.assert_allclose(got, w, rtol=0, atol=tol, err_msg=name)


def test_kernel_input_checks():
    q = torch.zeros(1, 8, 2, 64)
    port._check_kernel_inputs(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 8, 2, 32)
        port._check_kernel_inputs(x, x, x)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        x = q.half()
        port._check_kernel_inputs(x, x, x)
    with pytest.raises(ValueError, match="impl"):
        port.causal_attention(q, q, q, impl="pallas")
