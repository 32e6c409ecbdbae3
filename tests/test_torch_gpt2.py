"""ray_tpu_torch GPT-2 against the JAX package's GPT2Model.

Both run from the same weights: the JAX model's init, perturbed with numpy
noise so that biases and LayerNorm parameters are not trivially 0/1, carried
into the port by models/convert.py.  Loss and every gradient leaf are held
against `jax.value_and_grad(GPT2Model.loss)` on GPT2Config.tiny().

Tolerances, each grad leaf's relative to that leaf's largest magnitude
(leaves range from 3e-3 to 0.1 here).  float32 compute: loss 1e-6 relative,
grads 1e-5 (measured up to 5e-7: the frameworks sum in other orders).
bfloat16 compute: loss 1e-4 relative, grads 3e-2 (measured up to 1.7e-2):
bf16 keeps 8 bits, and XLA and torch round the bf16 matmul outputs, bias
adds and residual adds at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.gpt2 import GPT2Config as JaxConfig
from ray_tpu.models.gpt2 import GPT2Model as JaxModel
from ray_tpu_torch.models.convert import gpt2_from_jax_params, gpt2_to_jax_params, jax_params_from_state
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

B, S = 2, 64
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_params(cfg):
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params
    )


def _batch(vocab):
    rng = np.random.default_rng(2)
    return rng.integers(0, vocab, (B, S)), rng.integers(0, vocab, (B, S))


def _port_model(jax_params, **kw):
    model = GPT2Model(GPT2Config.tiny(**kw), device="cpu")
    return gpt2_from_jax_params(jax_params, model)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize(
    "dtype,loss_impl,remat",
    [
        ("f32", "naive", False),
        ("f32", "fused", True),
        ("f32", "auto", True),
        ("bf16", "naive", True),
        ("bf16", "fused", False),
    ],
)
def test_loss_and_every_grad_match_jax(dtype, loss_impl, remat):
    jd, td = _DTYPES[dtype]
    kw = dict(loss_impl=loss_impl, loss_chunk=16, remat=remat)
    jcfg = JaxConfig.tiny(compute_dtype=jd, **kw)
    params = _jax_params(jcfg)
    tok, tgt = _batch(jcfg.vocab_size)
    jm = JaxModel(jcfg)
    loss_j, grads_j = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(tok), jnp.asarray(tgt)))(
        jax.tree.map(jnp.asarray, params)
    )

    model = _port_model(params, compute_dtype=td, **kw)
    loss_t = model.loss(torch.from_numpy(tok), torch.from_numpy(tgt))
    loss_t.backward()
    grads_t = jax_params_from_state({n: p.grad for n, p in model.named_parameters()}, jcfg.n_layer)

    loss_tol, grad_tol = (1e-6, 1e-5) if dtype == "f32" else (1e-4, 3e-2)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=loss_tol)
    got, want = _flat(grads_t), _flat(grads_j)
    assert got.keys() == want.keys()
    for name in want:
        atol = grad_tol * np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)


def test_logits_and_backbone_match_jax():
    jcfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    params = _jax_params(jcfg)
    tok, _ = _batch(jcfg.vocab_size)
    jp = jax.tree.map(jnp.asarray, params)
    model = _port_model(params, compute_dtype=torch.float32)
    with torch.no_grad():
        logits = model.apply(torch.from_numpy(tok)).numpy()
        hidden = model.backbone(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(logits, np.asarray(JaxModel(jcfg).apply(jp, jnp.asarray(tok))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hidden, np.asarray(JaxModel(jcfg).backbone(jp, jnp.asarray(tok))), rtol=0, atol=1e-5)


def test_converter_round_trip_is_exact():
    params = _jax_params(JaxConfig.tiny())
    back = gpt2_to_jax_params(_port_model(params))
    want = _flat(params)
    got = _flat(back)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_config_matches_jax():
    for preset in ("gpt2_124m", "gpt2_350m", "gpt2_774m", "gpt2_1p5b", "tiny"):
        j, t = getattr(JaxConfig, preset)(), getattr(GPT2Config, preset)()
        assert (t.n_layer, t.n_head, t.n_embd, t.block_size, t.vocab_size) == (
            j.n_layer, j.n_head, j.n_embd, j.block_size, j.vocab_size
        )
        assert (t.padded_vocab, t.head_dim, t.num_params(), t.flops_per_token()) == (
            j.padded_vocab, j.head_dim, j.num_params(), j.flops_per_token()
        )


def test_port_init_distribution():
    cfg = GPT2Config.tiny(n_layer=4, n_embd=128, vocab_size=4096)
    model = GPT2Model(cfg, device="cpu", seed=3)
    assert abs(model.wte.std().item() - 0.02) < 1e-3
    proj_std = 0.02 / np.sqrt(2 * cfg.n_layer)
    assert abs(model.blocks[0].proj.weight.std().item() - proj_std) < 1e-3
    assert torch.equal(model.blocks[1].ln2.weight, torch.ones(cfg.n_embd))
    again = GPT2Model(cfg, device="cpu", seed=3)
    assert torch.equal(model.wte, again.wte)


@pytest.mark.parametrize("kw", [{"use_ring_attention": True}, {"moe_experts": 4}])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError):
        GPT2Model(GPT2Config.tiny(**kw), device="cpu")


def test_mesh_raises():
    model = GPT2Model(GPT2Config.tiny(), device="cpu")
    tok = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        model.loss(tok, tok, mesh=object())
