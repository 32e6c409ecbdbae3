"""ray_tpu_torch make_train_step against the JAX bundle, step by step.

The JAX bundle runs on a one-device CPU mesh; its init weights are carried
into the port, both optimizers start from zero moments, and both take four
steps on one numpy batch at the default learning rate.  Loss and grad_norm
are compared at every step, in f32 compute.  grad_clip 1.0 is the default;
0.05 forces the clipping branch on every step.  Tolerance 2e-6 relative: the
two sides differ by f32 rounding (a few 1e-7 per step).  The key bias's
gradient is zero in exact arithmetic (softmax ignores a shift shared by all
keys), so Adam turns its rounding noise into updates of up to lr; these move
neither the loss nor grad_norm, but at lr 1e-2 the loss drifts 1e-4 apart
within four steps, so the test keeps the default rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.gpt2 import GPT2Config as JaxConfig
from ray_tpu.models.gpt2 import GPT2Model as JaxModel
from ray_tpu.models.lm_train import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch.models.convert import gpt2_from_jax_params
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from ray_tpu_torch.models.lm_train import make_train_step, synthetic_batch

STEPS = 4


@pytest.mark.parametrize("grad_clip", [1.0, 0.05])
def test_train_steps_match_jax(grad_clip):
    jcfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    mesh = make_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jb = jax_make_train_step(JaxModel(jcfg), mesh, grad_clip=grad_clip)
    jparams, jopt = jb.init(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jparams)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, jcfg.block_size + 1))
    tok, tgt = tokens[:, :-1], tokens[:, 1:]

    model = GPT2Model(GPT2Config.tiny(compute_dtype=torch.float32), device="cpu")
    bundle = make_train_step(model, device="cpu", grad_clip=grad_clip)
    params, opt = bundle.init(0)
    gpt2_from_jax_params(start, params)

    for i in range(STEPS):
        jparams, jopt, jm = jb.step(jparams, jopt, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
        params, opt, m = bundle.step(params, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=2e-6, err_msg=f"step {i} {key}")
    if grad_clip == 0.05:
        assert m["grad_norm"].item() > grad_clip  # the clipping branch ran


def test_synthetic_batch_shifts_targets():
    gen = torch.Generator().manual_seed(0)
    tok, tgt = synthetic_batch(gen, 3, 16, 100, device="cpu")
    assert tok.shape == tgt.shape == (3, 16)
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    assert int(tok.max()) < 100 and tok.dtype == torch.int64
