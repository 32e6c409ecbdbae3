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

The step spec that the eager path and the resident step DAG drive
(`make_lm_step_spec`: float32 compute, plain Adam) is held against the JAX
package's the same way: `_lm_step` against `_lm_step`, below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.gpt2 import GPT2Config as JaxConfig
from ray_tpu.models.gpt2 import GPT2Model as JaxModel
from ray_tpu.models import lm_train as jax_lm
from ray_tpu.models.lm_train import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch.models import lm_train
from ray_tpu_torch.models.convert import gpt2_from_jax_params, gpt2_to_jax_params
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


PARITY_STEPS = 3
# 1e-3, not the spec's default 1e-2: Adam normalizes each gradient, so the
# f32 rounding of small gradients reaches the weights at ~7e-6 of each
# leaf's norm within three steps at 1e-3, and up to 1.5e-5 at 1e-2
PARITY_LR = 1e-3


def test_lm_step_matches_jax_lm_step():
    """The port's `_lm_step` against the JAX package's on the CPU, in f32:
    JAX's init weights carried across by `models/convert.py`, both Adams
    from zero moments, the same JAX batches (`_lm_data`) for three steps.
    Loss within 1e-5 relative at every step; every weight leaf within 1e-5
    of its norm.  The key third of `qkv_b` is held to |diff| <= 2 * steps *
    lr instead: its gradient is zero in exact arithmetic (a key bias shifts
    every score of a query alike), so each side's Adam steps on its own
    rounding noise."""
    kw = dict(batch=2, steps=PARITY_STEPS, learning_rate=PARITY_LR)
    jspec = jax_lm.make_lm_step_spec("tiny", **kw)
    spec = lm_train.make_lm_step_spec("tiny", device="cpu", **kw)
    assert spec.config["model"] == jspec.config["model"] and spec.config["seq"] == jspec.config["seq"]
    jstate = jspec.build(dict(jspec.config), 0, 1)
    state = spec.build(dict(spec.config), 0, 1)
    gpt2_from_jax_params(jax.tree.map(np.asarray, jstate["params"]), state["model"])
    for idx in range(PARITY_STEPS):
        jbatch = jspec.data(jstate, idx)
        batch = tuple(torch.from_numpy(np.asarray(x).astype(np.int64)) for x in jbatch)
        jloss = jspec.fold(jstate, jspec.step(jstate, jbatch))["loss"]
        loss = spec.fold(state, spec.step(state, spec.h2d(state, batch)))["loss"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, err_msg=f"step {idx} loss")
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(gpt2_to_jax_params(state["model"]))
    assert list(got) == list(want)
    E = state["cfg"].n_embd
    for key, w in want.items():
        g = got[key]
        if key.endswith("qkv_b"):
            k_diff = np.abs(g[:, E : 2 * E] - w[:, E : 2 * E]).max()
            assert k_diff <= 2 * PARITY_STEPS * PARITY_LR, f"key bias differs by {k_diff}"
            g, w = np.delete(g, np.s_[E : 2 * E], axis=1), np.delete(w, np.s_[E : 2 * E], axis=1)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-5, f"{key}: {rel:.3e} of its norm apart"
    # the Adam step count is the checkpoint's `count`, as optax's
    snap = spec.snapshot(state)
    assert int(snap["opt_state"]["count"]) == PARITY_STEPS


def test_lm_snapshot_restore_resumes_bit_for_bit():
    """`_lm_restore` of a step-3 `_lm_snapshot` into a fresh build, then
    steps 3..5, equals six uninterrupted steps bit for bit (the data stream
    is a function of the step index, so the resume replays it exactly)."""
    spec = lm_train.make_lm_step_spec("tiny", batch=2, steps=6, device="cpu")

    def run(state, idxs):
        return [spec.fold(state, spec.step(state, spec.h2d(state, spec.data(state, i)))) for i in idxs]

    whole = spec.build(dict(spec.config), 0, 1)
    want = run(whole, range(6))
    first = spec.build(dict(spec.config), 0, 1)
    run(first, range(3))
    snap = spec.snapshot(first)
    assert int(snap["opt_state"]["count"]) == 3
    resumed = spec.build(dict(spec.config), 0, 1)
    spec.restore(resumed, snap)
    assert run(resumed, range(3, 6)) == want[3:]
    got, ref = _leaves(spec.snapshot(resumed)), _leaves(spec.snapshot(whole))
    assert list(got) == list(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
