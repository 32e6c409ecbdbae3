"""ray_tpu_torch fused linear cross entropy against the JAX op.

The two cases of tests/test_ops.py: a chunk that divides the sequence and one
that does not (48 % 32 != 0 falls back to chunk 16).  Same inputs, drawn with
numpy, through `ray_tpu.ops.cross_entropy.fused_linear_cross_entropy` and the
port's autograd Function; loss, dx and dW compared in f32.  Tolerance: 1e-5
relative on the loss, 1e-5 absolute on grads (both sum the same f32 products
in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.cross_entropy import fused_linear_cross_entropy as jax_fused
from ray_tpu_torch.ops.cross_entropy import _num_chunks, fused_linear_cross_entropy


@pytest.mark.parametrize(
    "B,S,E,V,valid,chunk",
    [
        (2, 64, 16, 128, 100, 16),  # even chunks, padded vocab tail
        (2, 48, 16, 64, 60, 32),  # uneven: 48 % 32 != 0 -> chunk 16
    ],
)
def test_fused_ce_matches_jax(B, S, E, V, valid, chunk):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, E), dtype=np.float32)
    w = rng.standard_normal((V, E), dtype=np.float32)
    t = rng.integers(0, valid, (B, S))

    loss_j, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jax_fused(x, w, jnp.asarray(t, jnp.int32), valid, chunk), argnums=(0, 1)
    )(x, w)

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss_t = fused_linear_cross_entropy(xt, wt, torch.from_numpy(t), valid, chunk)
    loss_t.backward()

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seq,chunk", [(64, 16), (48, 32), (1024, 455), (7, 4)])
def test_num_chunks_matches_jax(seq, chunk):
    from ray_tpu.ops.cross_entropy import _num_chunks as jax_num_chunks

    assert _num_chunks(seq, chunk) == jax_num_chunks(seq, chunk)
