"""ray_tpu_torch.rllib against ray_tpu.rllib on the CPU, same inputs and weights.

Inputs come from numpy seeds; every policy pair starts from one JAX
parameter tree carried across by `models.convert.rllib_params_from_jax`
(JAX's threefry init is not reproduced).  Gradients and flat vectors are
compared in the port's layout: the JAX tree goes through the same
converter, which is linear.

Tolerances:
- env frames, rewards and GAE: equal (the same numpy code);
- MLP and CNN forward in float32: 1e-5 absolute;
- the CNN at compute_dtype="bfloat16": its error against the float32
  reference at most twice the reference's own bf16 error, plus 1e-3
  (both round to bf16 at the same points, the convolutions sum in other
  orders);
- `_ppo_loss` metrics and gradients, one V-trace update's metrics, the
  DDPPO flat gradient: 1e-5 relative (gradients relative to each leaf's
  largest element);
- parameters after one update (`learn_on_batch`, one V-trace update,
  `apply_flat_grads`) and the MLP's after `learn_on_loaded_batch` (2
  calls of 2 epochs, the same permutations): 1e-5 absolute, at the
  policy's default learning rate 3e-4;
- the CNN after `learn_on_loaded_batch`: metrics within 1e-2 relative,
  the learned action probabilities on the batch within 1e-3, values
  within 2e-2 of their largest magnitude.  Adam's step is
  lr * g / (|g| + 1e-8): a gradient element near 1e-8, where float32
  rounding decides its size or sign (a ReLU unit at its threshold, a
  trunk input that is almost always zero), moves by up to 2 lr whatever
  the implementation, and every later step carries the difference on.
  Over 6 batch seeds the two packages' CNN parameters after 16 steps
  differed by 1.5e-6 to 1.4e-3 (3 of 6 above 1e-5; the MLP by at most
  3.6e-7), the probabilities by at most 1.2e-4, the values by 5.1e-3 of
  the largest, the metrics by 8.9e-4 relative; the port's own float32
  and float64 runs diverge the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu.rllib.rollout_worker import compute_gae as jax_gae
from ray_tpu_torch.models.convert import rllib_params_from_jax
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    RETURNS,
    REWARDS,
    VALUES,
    SampleBatch,
)

SMALL_CNN = {"type": "cnn", "conv_filters": ((16, 8, 4), (32, 4, 2))}
MODELS = {
    "mlp": dict(obs_shape=(4,), num_actions=2),
    "cnn": dict(obs_shape=(42, 42, 4), num_actions=3, model_config=SMALL_CNN),
}


def _pair(kind, **kw):
    """(JaxPolicy, TorchPolicy on the CPU with the JAX policy's weights)."""
    kw = {**MODELS[kind], **kw}
    jp = JaxPolicy(**kw)
    tp = TorchPolicy(device="cpu", **kw)
    tp.model.load_state_dict(rllib_params_from_jax(jax.device_get(jp.params), tp.model))
    return jp, tp


def _obs(rng, n, obs_shape):
    if len(obs_shape) == 3:
        return rng.integers(0, 256, (n, *obs_shape), dtype=np.uint8)
    return rng.standard_normal((n, *obs_shape)).astype(np.float32)


def _batch(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    cfg = MODELS[kind]
    return SampleBatch({
        OBS: _obs(rng, n, cfg["obs_shape"]),
        ACTIONS: rng.integers(0, cfg["num_actions"], n),
        LOGPS: (np.log(1 / cfg["num_actions"]) + 0.1 * rng.standard_normal(n)).astype(np.float32),
        ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        RETURNS: rng.standard_normal(n).astype(np.float32),
    })


def _fragment(kind, T=12, N=3, seed=1):
    """A [T, N] vector-env fragment and its [N] bootstrap values."""
    rng = np.random.default_rng(seed)
    cfg = MODELS[kind]
    obs = _obs(rng, T * N, cfg["obs_shape"]).reshape(T, N, *cfg["obs_shape"])
    batch = SampleBatch({
        OBS: obs,
        ACTIONS: rng.integers(0, cfg["num_actions"], (T, N)),
        LOGPS: (np.log(1 / cfg["num_actions"]) + 0.1 * rng.standard_normal((T, N))).astype(np.float32),
        REWARDS: rng.standard_normal((T, N)).astype(np.float32),
        DONES: rng.random((T, N)) < 0.15,
    })
    return batch, rng.standard_normal(N).astype(np.float32)


def _converted(tree, model):
    return {k: v.numpy() for k, v in rllib_params_from_jax(jax.device_get(tree), model).items()}


def _port_params(tp):
    return {k: v.detach().numpy() for k, v in tp.model.named_parameters()}


def _assert_params(jp, tp, atol=1e-5):
    want = _converted(jp.params, tp.model)
    got = _port_params(tp)
    assert set(want) == set(got)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)


def _assert_metrics(want, got, rtol=1e-5):
    assert set(want) == set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-7), (k, want[k], got[k])


def _assert_grads(want, got, rtol=1e-5):
    """`want`, `got`: {name: array} in the port's layout; each leaf within
    rtol of its largest element."""
    assert set(want) == set(got)
    for name in want:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=rtol * scale + 1e-12, err_msg=name)


def _unflatten(flat, tp):
    out, offset = {}, 0
    for name, p in tp.model.named_parameters():
        out[name] = np.asarray(flat[offset : offset + p.numel()]).reshape(p.shape)
        offset += p.numel()
    assert offset == len(flat)
    return out


# ------------------------------------------------------------------- envs


def test_pixel_env_frames_and_rewards_equal():
    args = dict(num_envs=4, frames=4, shaped=True, seed=3)
    je, te = jenv.SyntheticPixelEnv(**args), tenv.SyntheticPixelEnv(**args)
    oj, ot = je.reset(seed=3), te.reset(seed=3)
    assert oj.dtype == ot.dtype == np.uint8 and oj.tobytes() == ot.tobytes()
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(50):
        a = rng.integers(0, 3, 4)
        (oj, rj, dj, _), (ot, rt, dt, _) = je.step(a), te.step(a)
        assert oj.tobytes() == ot.tobytes() and rj.tobytes() == rt.tobytes() and (dj == dt).all()
        dones += int(dt.sum())
    assert dones > 0  # autoreset ran


def test_pendulum_and_sync_vector_env_equal():
    je, te = jenv.PendulumEnv(num_envs=5, seed=2), tenv.PendulumEnv(num_envs=5, seed=2)
    assert je.reset(seed=2).tobytes() == te.reset(seed=2).tobytes()
    rng = np.random.default_rng(1)
    for _ in range(210):  # past the 200-step horizon: autoreset
        a = rng.uniform(-2, 2, (5, 1)).astype(np.float32)
        (oj, rj, dj, _), (ot, rt, dt, _) = je.step(a), te.step(a)
        assert oj.tobytes() == ot.tobytes() and rj.tobytes() == rt.tobytes() and (dj == dt).all()

    def cartpole():
        import gymnasium as gym

        return gym.make("CartPole-v1")

    vj, vt = jenv.make_vector_env(cartpole, 3, seed=4), tenv.make_vector_env(cartpole, 3, seed=4)
    assert vj.reset(seed=4).tobytes() == vt.reset(seed=4).tobytes()
    for _ in range(60):
        a = rng.integers(0, 2, 3)
        (oj, rj, dj, _), (ot, rt, dt, _) = vj.step(a), vt.step(a)
        assert oj.tobytes() == ot.tobytes() and rj.tobytes() == rt.tobytes() and (dj == dt).all()


@pytest.mark.parametrize("shape", [(12,), (12, 3)])
def test_compute_gae_equal(shape):
    rng = np.random.default_rng(0)
    cols = {
        REWARDS: rng.standard_normal(shape).astype(np.float32),
        VALUES: rng.standard_normal(shape).astype(np.float32),
        DONES: rng.random(shape) < 0.2,
    }
    last = rng.standard_normal(shape[1:]).astype(np.float32) if len(shape) == 2 else 0.7
    want = jax_gae(SampleBatch({k: v.copy() for k, v in cols.items()}), last, 0.99, 0.95)
    got = compute_gae(SampleBatch({k: v.copy() for k, v in cols.items()}), last, 0.99, 0.95)
    for k in (ADVANTAGES, RETURNS):
        assert want[k].tobytes() == got[k].tobytes()


# ---------------------------------------------------------------- models


def test_gaussian_mlp_forward_matches():
    from ray_tpu.rllib.models import GaussianMLPModel as JaxGaussian
    from ray_tpu_torch.rllib.models import get_model

    jm = JaxGaussian((3,), 2, hidden=(32, 32))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = get_model((3,), 2, {"type": "gaussian_mlp", "hidden": (32, 32)})
    tm.load_state_dict(rllib_params_from_jax(params, tm))
    obs = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    (jmean, jlog_std), jv = jm.apply(params, obs)
    with torch.no_grad():
        (mean, log_std), v = tm(torch.from_numpy(obs))
    for got, want in ((mean, jmean), (log_std, jlog_std), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["mlp", "cnn", "nature_cnn"])
def test_forward_matches(kind):
    if kind == "nature_cnn":
        kw = dict(obs_shape=(84, 84, 4), num_actions=3, model_config={"type": "cnn"})
        jp = JaxPolicy(**kw)
        tp = TorchPolicy(device="cpu", **kw)
        tp.model.load_state_dict(rllib_params_from_jax(jax.device_get(jp.params), tp.model))
        obs = _obs(np.random.default_rng(5), 16, (84, 84, 4))
    else:
        jp, tp = _pair(kind)
        obs = _batch(kind, n=16)[OBS]
    lj, vj = jp.model.apply(jp.params, obs)
    with torch.no_grad():
        lt, vt = tp.model(torch.from_numpy(obs))
    assert lt.dtype == vt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)


def test_cnn_bfloat16_within_twice_the_references_error():
    jp, tp = _pair("cnn")
    jb = JaxPolicy(**{**MODELS["cnn"], "model_config": {**SMALL_CNN, "compute_dtype": "bfloat16"}})
    tb = TorchPolicy(device="cpu", **{**MODELS["cnn"], "model_config": {**SMALL_CNN, "compute_dtype": "bfloat16"}})
    tb.model.load_state_dict(tp.model.state_dict())
    obs = _batch("cnn", n=32)[OBS]
    ref_l, ref_v = (np.asarray(x) for x in jp.model.apply(jp.params, obs))  # float32 reference
    bl, bv = (np.asarray(x) for x in jb.model.apply(jp.params, obs))  # the reference in bf16
    with torch.no_grad():
        tl, tv = tb.model(torch.from_numpy(obs))
    assert tl.dtype == tv.dtype == torch.float32  # bf16 activations, f32 outputs
    for got, ref, jax_bf16 in ((tl.numpy(), ref_l, bl), (tv.numpy(), ref_v, bv)):
        ref_err = np.abs(jax_bf16 - ref).max()
        assert ref_err > 0  # the reference really ran in bf16
        assert np.abs(got - ref).max() <= 2 * ref_err + 1e-3


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_ppo_loss_metrics_and_grads(kind):
    jp, tp = _pair(kind, entropy_coeff=0.01)
    b = _batch(kind)
    mask = np.ones(len(b), np.float32)
    cols = (b[OBS], b[ACTIONS].astype(np.int32), b[LOGPS], b[ADVANTAGES], b[RETURNS], mask)
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jp._ppo_loss(p, *cols), has_aux=True)(jp.params)
    total, metrics = tp._ppo_loss(*tp._tensors(b))
    total.backward()
    _assert_metrics({**{k: float(v) for k, v in jmetrics.items()}, "total": float(jtotal)},
                    {**{k: float(v) for k, v in metrics.items()}, "total": float(total.detach())})
    _assert_grads(_converted(jgrads, tp.model),
                  {k: p.grad.numpy() for k, p in tp.model.named_parameters()})


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_learn_on_loaded_batch_same_minibatches(kind):
    """Two calls of 2 epochs of 4 minibatches (the second call draws the
    next permutation).  The MLP's parameters within 1e-5; the CNN's learned
    policy on the batch (its ReLU trunk has gradient elements in float32
    rounding ties near Adam's eps, see the module docstring)."""
    jp, tp = _pair(kind)
    b = _batch(kind, n=800)
    for call in range(2):
        mj = jp.learn_on_loaded_batch(jp.load_batch(b), 2, 200, seed=0)
        mt = tp.learn_on_loaded_batch(tp.load_batch(b), 2, 200, seed=0)
        _assert_metrics(mj, mt, rtol=1e-4 if kind == "mlp" else 1e-2)
    if kind == "mlp":
        _assert_params(jp, tp)
        return
    lj, vj = (np.asarray(x, np.float64) for x in jp.model.apply(jp.params, b[OBS]))
    with torch.no_grad():
        lt, vt = (x.double() for x in tp.model(torch.from_numpy(b[OBS])))
    pj = torch.softmax(torch.from_numpy(lj), -1)
    assert float((torch.softmax(lt, -1) - pj).abs().max()) <= 1e-3
    assert float((vt - torch.from_numpy(vj)).abs().max()) <= 2e-2 * np.abs(vj).max()


def test_learn_on_batch_matches():
    jp, tp = _pair("mlp")
    b = _batch("mlp")
    _assert_metrics(jp.learn_on_batch(b), tp.learn_on_batch(b))
    _assert_params(jp, tp)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
@pytest.mark.parametrize("vtrace_clip", [False, True], ids=["impala", "appo"])
@pytest.mark.parametrize("layout", ["vector", "scalar"])
def test_vtrace_update(kind, vtrace_clip, layout):
    jp, tp = _pair(kind, vtrace_clip=vtrace_clip, entropy_coeff=0.01)
    batch, bootstrap = _fragment(kind, N=1 if layout == "scalar" else 3)
    if layout == "scalar":
        batch = SampleBatch({k: np.asarray(v)[:, 0] for k, v in batch.items()})
        bootstrap = float(bootstrap[0])
    _assert_metrics(jp.learn_on_fragment(batch, bootstrap), tp.learn_on_fragment(batch, bootstrap))
    _assert_params(jp, tp)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_compute_grads_and_apply_flat_grads(kind):
    jp, tp = _pair(kind)
    b = _batch(kind)
    jflat, jm = jp.compute_grads(b)
    tflat, tm = tp.compute_grads(b)
    assert tflat.dtype == np.float32 and tflat.shape == jflat.shape
    _assert_metrics(jm, tm)
    _, unravel = ravel_pytree(jp.params)
    want = _converted(unravel(jnp.asarray(jflat)), tp.model)
    _assert_grads(want, _unflatten(tflat, tp))
    # the same (reference) gradient applied by both
    jp.apply_flat_grads(jnp.asarray(jflat))
    tp.apply_flat_grads(np.concatenate([want[name].reshape(-1) for name, _ in tp.model.named_parameters()]))
    _assert_params(jp, tp)


# ----------------------------------------------------------------- state


def test_get_state_set_state_round_trip():
    _, tp = _pair("cnn")
    b = _batch("cnn", n=128)
    tp.learn_on_loaded_batch(tp.load_batch(b), 2, 32)
    state = tp.get_state()
    assert state["opt_state"]["count"] == 8
    assert set(state["params"]) == set(state["opt_state"]["exp_avg"]) == set(dict(tp.model.named_parameters()))
    fresh = TorchPolicy(device="cpu", seed=9, **MODELS["cnn"])
    fresh.set_state(state)
    fresh._loaded_seq = tp._loaded_seq
    for name, value in fresh.get_state()["params"].items():
        assert value.tobytes() == state["params"][name].tobytes()
    # both continue identically: the moments and the count came across
    tp.learn_on_loaded_batch(tp.load_batch(b), 1, 32)
    fresh.learn_on_loaded_batch(fresh.load_batch(b), 1, 32)
    for name, value in fresh.get_weights().items():
        assert value.tobytes() == tp.get_weights()[name].tobytes(), name
    # weights read out are copies, not views of the live parameters
    w = tp.get_weights()
    tp.learn_on_batch(b)
    assert not np.array_equal(w["trunk.weight"], tp.get_weights()["trunk.weight"])


def test_flat_weights_round_trip():
    _, tp = _pair("mlp")
    _, other = _pair("mlp", seed=4)
    other.set_flat_weights(tp.get_flat_weights().numpy())
    for name, value in other.get_weights().items():
        assert value.tobytes() == tp.get_weights()[name].tobytes()


def test_multi_device_learner_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        TorchPolicy(device="cpu", num_devices=2, **MODELS["mlp"])
