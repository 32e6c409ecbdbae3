"""GPT-2's remat policies in ray_tpu_torch against the JAX package's.

The port follows `GPT2Config.remat_policy`: "dots" keeps the linears'
matmul outputs and the attention op's (o, lse), "lite" keeps everything but
`ln1_out`, `ln2_out` and `gelu_out` (both recompute the LayerNorms and the
GELU in the backward, nothing else), any other policy recomputes the whole
block, and `remat=False` recomputes nothing.  Checked on GPT2Config.tiny in
float32, on weights carried from the JAX model (as tests/test_torch_gpt2.py
does):

- loss and every gradient under each policy equal JAX's under the same
  policy, within test_torch_gpt2.py's float32 tolerances (loss 1e-6
  relative, each grad leaf 1e-5 of its largest magnitude);
- per training step (forward and backward, counted at the dispatcher) the
  attention op runs n_layer times under "dots", "lite" and no remat, and
  2 n_layer times under full remat; "dots" and "lite" run no matmul twice,
  and both recompute the LayerNorms and GELUs the JAX policies recompute.
- the attention op's plain version on the CPU gives the plain attention's
  output and gradients bit for bit, and the logsumexp of its scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models.gpt2 import GPT2Config as JaxConfig
from ray_tpu.models.gpt2 import GPT2Model as JaxModel
from ray_tpu_torch.models.convert import gpt2_from_jax_params, jax_params_from_state
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from ray_tpu_torch.ops import attention as att

B, S = 2, 64
POLICIES = [("dots", True), ("lite", True), ("full", True), ("dots", False)]
IDS = ["dots", "lite", "full", "none"]
MM = torch.ops.aten.addmm.default
LN = torch.ops.aten.native_layer_norm.default
GELU = torch.ops.aten.gelu.default


class _OpCounts(TorchDispatchMode):
    """Counts every op that reaches the dispatcher below autograd."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _jax_params(cfg):
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _batch(vocab):
    rng = np.random.default_rng(2)
    return rng.integers(0, vocab, (B, S)), rng.integers(0, vocab, (B, S))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _step(policy, remat, params, tok, tgt):
    """One loss forward and backward of the port; (loss, grads, op counts)."""
    model = gpt2_from_jax_params(
        params, GPT2Model(GPT2Config.tiny(compute_dtype=torch.float32, remat=remat, remat_policy=policy), device="cpu")
    )
    counts = _OpCounts()
    with counts:
        loss = model.loss(torch.from_numpy(tok), torch.from_numpy(tgt))
        loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, counts.n


@pytest.mark.parametrize("policy,remat", POLICIES, ids=IDS)
def test_loss_and_grads_match_jax_under_each_policy(policy, remat):
    jcfg = JaxConfig.tiny(compute_dtype=jnp.float32, remat=remat, remat_policy=policy)
    params = _jax_params(jcfg)
    tok, tgt = _batch(jcfg.vocab_size)
    jm = JaxModel(jcfg)
    loss_j, grads_j = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(tok), jnp.asarray(tgt)))(
        jax.tree.map(jnp.asarray, params)
    )
    loss_t, grads, _ = _step(policy, remat, params, tok, tgt)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-6)
    got, want = _flat(jax_params_from_state(grads, jcfg.n_layer)), _flat(grads_j)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5 * np.abs(want[name]).max(), err_msg=name)


@pytest.mark.parametrize("policy,remat", POLICIES, ids=IDS)
def test_ops_run_per_step_under_each_policy(policy, remat):
    cfg = JaxConfig.tiny()
    tok, tgt = _batch(cfg.vocab_size)
    _, _, n = _step(policy, remat, _jax_params(cfg), tok, tgt)
    L = cfg.n_layer
    full = remat and policy == "full"
    assert n.get(att.ATTENTION_OP, 0) == (2 if full else 1) * L
    if full:
        assert n[MM] > 4 * L
        return
    assert n[MM] == 4 * L  # qkv, proj, mlp_in, mlp_out: each matmul once
    recomputed = 1 if remat else 0  # LayerNorm and GELU: "dots" and "lite" recompute both
    assert n[LN] == 2 * L * (1 + recomputed) + 1  # + the final LayerNorm
    assert n[GELU] == L * (1 + recomputed)


def test_policies_give_the_same_step():
    """Remat changes what is stored, never what is computed: every policy's
    loss and gradients equal the no-remat step's bit for bit."""
    cfg = JaxConfig.tiny()
    params = _jax_params(cfg)
    tok, tgt = _batch(cfg.vocab_size)
    loss0, grads0, _ = _step("dots", False, params, tok, tgt)
    for policy in ("dots", "lite", "full"):
        loss, grads, _ = _step(policy, True, params, tok, tgt)
        assert loss == loss0
        assert all(torch.equal(grads[n], grads0[n]) for n in grads0), policy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_plain_version_on_the_cpu(dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 32, generator=gen).to(dtype).requires_grad_() for _ in range(3))
    do = torch.randn(2, 16, 2, 32, generator=gen).to(dtype)
    scale = 32**-0.5
    o = att.causal_attention(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    o_ref = att.plain_causal_attention(q, k, v, scale)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    assert torch.equal(o, o_ref)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_ref))
    _, lse = att._attention_op(q, k, v, scale, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=0, atol=1e-5)
