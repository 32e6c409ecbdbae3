"""ray_tpu_torch.rllib's off-policy family against ray_tpu.rllib on the CPU.

Replay buffers, distributions, and the SAC, TD3, DDPG and DQN learners and
workers, with no cluster.  Inputs come from numpy seeds; each policy pair
starts from one JAX parameter tree carried across by
`models.convert.rllib_params_from_jax` (JAX's threefry init is not
reproduced), and every update takes the JAX package's own normals: the
port's `_update` takes its noise as arguments, drawn here with the keys
the JAX policy splits for that update.

Tolerances:
- replay buffers and PER (indexes, batches, weights, priorities), worker
  warm-up batches, stored terminals and `final_observation` rows,
  epsilon-greedy actions: equal;
- distribution functions on the same inputs and noise: 1e-6 relative;
- one update of SAC, TD3 (step 0: the actor and both targets move; step
  1: they stay byte-equal), DDPG and DQN (MLP, a narrow CNN, PER weights):
  metrics within 1e-5 relative, parameters within 1e-5 absolute;
- SAC over 8 updates: metrics within 1e-3 relative;
- TD3 workers' raw actions (float32 forward plus numpy exploration
  noise): 1e-6 absolute.
The nature CNN (84x84x4) is left out of the one-step parameter rule: its
first Adam step lr * g / (|g| + 1e-8) moves an element whose float32
gradient is rounding noise near 1e-8 by up to 2 lr whatever the backend
(3 seeds gave 8.4e-6, 5.1e-5, 1.2e-5 at lr 1e-3, the narrow CNN at most
3.6e-6); see tests/test_torch_rllib.py.

SAC's learning bar of tests/test_rllib_continuous.py (the vectorized
Pendulum) runs here at the same configuration, the learner on the CPU;
TD3's, through `_pendulum_learning`, in tests/test_torch_rllib_extras.py.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrllib
import ray_tpu_torch.rllib as trllib
from ray_tpu.rllib import distributions as jdist
from ray_tpu.rllib.dqn import DQNPolicy as JaxDQNPolicy
from ray_tpu.rllib.dqn import DQNWorker as JaxDQNWorker
from ray_tpu.rllib.replay_buffer import PrioritizedReplayBuffer as JaxPER
from ray_tpu.rllib.replay_buffer import ReplayBuffer as JaxReplay
from ray_tpu.rllib.sac import SACPolicy as JaxSACPolicy
from ray_tpu.rllib.sac import SACWorker as JaxSACWorker
from ray_tpu.rllib.td3 import TD3Policy as JaxTD3Policy
from ray_tpu.rllib.td3_worker import TD3Worker as JaxTD3Worker
from ray_tpu_torch.models.convert import rllib_params_from_jax
from ray_tpu_torch.rllib import distributions as tdist
from ray_tpu_torch.rllib.dqn import DQNPolicy, DQNWorker
from ray_tpu_torch.rllib.env import PendulumEnv
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.sac import SACPolicy, SACWorker, floats, transition_tensors
from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch
from ray_tpu_torch.rllib.td3 import TD3Policy
from ray_tpu_torch.rllib.td3_worker import TD3Worker

OBS_DIM, ACT_DIM, HIDDEN, B = 5, 2, (32, 32), 64
SMALL_CNN = {"type": "cnn", "conv_filters": ((16, 8, 4), (32, 4, 2))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread in this process: the learners' operations
    are small, and the test sweep runs several files at once on the same
    cores, where a pool of spinning threads per process slows every one of
    them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def _pendulum():
    return PendulumEnv(num_envs=2, seed=0)


def _jax_pendulum():
    from ray_tpu.rllib.env import PendulumEnv as JaxPendulumEnv

    return JaxPendulumEnv(num_envs=2, seed=0)


def _transitions(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        ACTIONS: rng.uniform(-1, 1, (n, ACT_DIM)).astype(np.float32),
        REWARDS: rng.standard_normal(n).astype(np.float32),
        NEXT_OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        DONES: (rng.random(n) < 0.2).astype(np.float32),
    })


def _load(module, tree):
    module.load_state_dict(rllib_params_from_jax(jax.device_get(tree), module))


def _assert_close(module, tree, atol=1e-5):
    want = rllib_params_from_jax(jax.device_get(tree), module)
    got = dict(module.named_parameters())
    assert set(want) == set(got)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=name)


def _assert_metrics(want, got, rtol=1e-5):
    assert set(want) == set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-7), (k, want[k], got[k])


def _snapshot(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _same_bytes(module, snap):
    return all(torch.equal(p.detach(), snap[n]) for n, p in module.named_parameters())


# ------------------------------------------------------------- the package


def test_exports_every_name_of_the_jax_package():
    jax_names = {n for n in dir(jrllib) if not n.startswith("_") and not isinstance(getattr(jrllib, n), type(jrllib))}
    port_names = {n for n in dir(trllib) if not n.startswith("_") and not isinstance(getattr(trllib, n), type(trllib))}
    assert jax_names - {"JaxPolicy"} <= port_names, sorted(jax_names - port_names)
    assert "TorchPolicy" in port_names and "JaxPolicy" not in port_names


def test_converter_names_a_list_root_without_a_dot():
    jp = JaxTD3Policy((OBS_DIM,), ACT_DIM, hidden=HIDDEN)
    names = set(rllib_params_from_jax(jax.device_get(jp.actor_params), TD3Policy((OBS_DIM,), ACT_DIM, hidden=HIDDEN,
                                                                                 device="cpu").actor))
    assert names == {"0.weight", "0.bias", "1.weight", "1.bias", "2.weight", "2.bias"}


# ---------------------------------------------------------- replay buffers


def test_replay_buffer_same_indexes_and_batches():
    jb, tb = JaxReplay(capacity=100, seed=3), ReplayBuffer(capacity=100, seed=3)
    for start in range(0, 250, 50):
        batch = SampleBatch({OBS: np.arange(start, start + 50, dtype=np.float32).reshape(50, 1),
                             ACTIONS: np.arange(start, start + 50) % 3})
        ij, it = jb.add(batch), tb.add(batch)
        assert ij.tobytes() == it.tobytes()
    assert len(jb) == len(tb) == 100
    for _ in range(3):
        sj, st = jb.sample(64), tb.sample(64)
        assert set(sj) == set(st) and all(sj[k].tobytes() == st[k].tobytes() for k in sj)
    assert st[OBS].min() >= 150  # the ring keeps the newest 100 rows


def test_prioritized_replay_same_draws_weights_and_priorities():
    jb, tb = JaxPER(capacity=64, alpha=0.6, seed=1), PrioritizedReplayBuffer(capacity=64, alpha=0.6, seed=1)
    batch = SampleBatch({OBS: np.arange(48, dtype=np.float32).reshape(48, 1)})
    jb.add(batch), tb.add(batch)
    rng = np.random.default_rng(0)
    for _ in range(3):
        sj, st = jb.sample(32, beta=0.4), tb.sample(32, beta=0.4)
        assert set(sj) == set(st) and all(sj[k].tobytes() == st[k].tobytes() for k in sj)
        td = rng.standard_normal(32)
        jb.update_priorities(sj["batch_indexes"], td)
        tb.update_priorities(st["batch_indexes"], td)
        assert jb._prio.tobytes() == tb._prio.tobytes() and jb._max_prio == tb._max_prio
    jb.add(batch), tb.add(batch)  # new rows at the running max priority
    assert jb._prio.tobytes() == tb._prio.tobytes()


# ------------------------------------------------------------ distributions


def _dist_inputs(seed=0, n=16, scale=1.0):
    rng = np.random.default_rng(seed)
    mean = (scale * rng.standard_normal((n, 3))).astype(np.float32)
    log_std = rng.uniform(-3, 1, (n, 3)).astype(np.float32)
    return mean, log_std


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-6))


def test_distribution_functions_match():
    mean, log_std = _dist_inputs()
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))
    tm, ts, tn = (torch.from_numpy(np.array(x)) for x in (mean, log_std, noise))
    _close(tdist.diag_gaussian_sample(tm, ts, noise=tn), jdist.diag_gaussian_sample(key, mean, log_std))
    x = np.random.default_rng(1).standard_normal(mean.shape).astype(np.float32)
    _close(tdist.diag_gaussian_logp(torch.from_numpy(x), tm, ts), jdist.diag_gaussian_logp(x, mean, log_std))
    _close(tdist.diag_gaussian_entropy(ts), jdist.diag_gaussian_entropy(log_std))
    a, logp = tdist.squashed_sample_logp(tm, ts, noise=tn)
    ja, jlogp = jdist.squashed_sample_logp(key, mean, log_std)
    _close(a, ja)
    _close(logp, jlogp)
    _close(tdist.squashed_logp(torch.from_numpy(np.array(ja)), tm, ts), jdist.squashed_logp(ja, mean, log_std))
    _close(tdist.squashed_mode(tm), jdist.squashed_mode(mean))
    # the clip of log_std to [-20, 2] on both sides
    wide = np.array([[-30.0, 0.0, 5.0]], np.float32).repeat(16, 0)
    _close(tdist.squashed_sample_logp(tm, torch.from_numpy(wide), noise=tn)[1],
           jdist.squashed_sample_logp(key, mean, wide)[1])


def test_squashed_logp_finite_at_large_u():
    """|u| about 20: tanh(u) rounds to +-1 in float32, and the naive
    log(1 - tanh(u)^2) is -inf; the softplus form stays finite and equal to
    the reference's."""
    mean = np.array([[20.0, -20.0, 9.5]] * 4, np.float32)
    log_std = np.full((4, 3), -4.0, np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))
    tm, ts, tn = (torch.from_numpy(np.array(x)) for x in (mean, log_std, noise))
    _, logp = tdist.squashed_sample_logp(tm, ts, noise=tn)
    assert torch.isfinite(logp).all()
    with np.errstate(divide="ignore"):
        assert not np.isfinite(np.log(1 - np.tanh(mean) ** 2).sum())
    _close(logp, jdist.squashed_sample_logp(key, mean, log_std)[1])
    _close(tdist._log1m_tanh2(tm), jdist._log1m_tanh2(mean))


# --------------------------------------------------------------------- SAC


def _sac_pair(**kw):
    jp = JaxSACPolicy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, **kw)
    tp = SACPolicy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, device="cpu", **kw)
    _load(tp.actor, jp.actor_params)
    _load(tp.critic, jp.q_params)
    _load(tp.q_target, jp.q_target)
    return jp, tp


def _sac_step(jp, tp, batch):
    """One update of each with the JAX policy's normals for this update."""
    _, key = jax.random.split(jp._rng)
    k_next, k_pi = jax.random.split(key)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, (len(batch), ACT_DIM), np.float32)))
             for k in (k_next, k_pi)]
    return jp.learn_on_batch(batch), floats(tp._update(*transition_tensors(batch, tp.device), *noise))


def test_sac_one_update_matches():
    jp, tp = _sac_pair()
    vf = _snapshot(tp.actor.vf)
    mj, mt = _sac_step(jp, tp, _transitions())
    _assert_metrics(mj, mt)
    _assert_close(tp.actor, jp.actor_params)
    _assert_close(tp.critic, jp.q_params)
    _assert_close(tp.q_target, jp.q_target)
    assert float(tp.log_alpha.detach()) == pytest.approx(float(jp.log_alpha), abs=1e-7)
    assert _same_bytes(tp.actor.vf, vf)  # the actor's loss never reaches the value tower


def test_sac_actor_step_leaves_the_critics_gradient_alone():
    """The actor's loss is taken against the updated critics, and only the
    actor's parameters receive its gradient: the critics' .grad after an
    update is the critic step's own, recomputed here from a second copy of
    the same policy."""
    _, tp = _sac_pair()
    _, ref = _sac_pair()
    obs, act, rew, next_obs, done = transition_tensors(_transitions(), tp.device)
    noise = torch.randn(2, B, ACT_DIM, generator=torch.Generator().manual_seed(0))
    tp._update(obs, act, rew, next_obs, done, *noise)
    with torch.no_grad():  # the critic step at alpha = exp(0)
        a2, logp2 = tdist.squashed_sample_logp(*ref.actor.dist_inputs(next_obs), noise=noise[0])
        backup = rew + ref.gamma * (1 - done) * (torch.minimum(*ref.q_target(next_obs, a2)) - logp2)
    q1, q2 = ref.critic(obs, act)
    (((q1 - backup) ** 2 + (q2 - backup) ** 2).mean()).backward()
    for n, p in ref.critic.named_parameters():
        assert torch.equal(dict(tp.critic.named_parameters())[n].grad, p.grad), n


def test_sac_eight_updates_metrics():
    jp, tp = _sac_pair()
    for seed in range(8):
        mj, mt = _sac_step(jp, tp, _transitions(seed))
        _assert_metrics(mj, mt, rtol=1e-3)


def test_sac_state_round_trip_and_actions():
    _, tp = _sac_pair()
    for seed in range(2):
        tp.learn_on_batch(_transitions(seed))
    state = tp.get_state()
    assert set(state) == {"actor_params", "q_params", "q_target", "log_alpha", "actor_opt_state",
                          "critic_opt_state", "alpha_opt_state"}
    assert state["critic_opt_state"]["count"] == state["alpha_opt_state"]["count"] == 2
    fresh = SACPolicy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, device="cpu", seed=9)
    fresh.set_state(state)
    obs = _transitions(5)[OBS]
    assert fresh.compute_actions(obs, deterministic=True)[0].tobytes() == \
        tp.compute_actions(obs, deterministic=True)[0].tobytes()
    # both continue identically: moments, counts, targets and alpha came across
    cols = transition_tensors(_transitions(6), tp.device)
    noise = torch.randn(2, B, ACT_DIM, generator=torch.Generator().manual_seed(0))
    assert floats(fresh._update(*cols, *noise)) == floats(tp._update(*cols, *noise))
    for name, value in fresh.get_state()["q_target"].items():
        assert value.tobytes() == tp.get_state()["q_target"][name].tobytes(), name


def test_sac_compute_actions_deterministic_and_sampled():
    jp, tp = _sac_pair()
    obs = _transitions(2)[OBS]
    env_j, raw_j = jp.compute_actions(obs, deterministic=True)
    env_t, raw_t = tp.compute_actions(obs, deterministic=True)
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(env_t, env_j, rtol=0, atol=1e-6)
    env, raw = tp.compute_actions(obs)
    assert raw.shape == (B, ACT_DIM) and np.all(np.abs(raw) < 1)


# --------------------------------------------------------------- TD3, DDPG


def _td3_pair(**kw):
    jp = JaxTD3Policy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, **kw)
    tp = TD3Policy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, device="cpu", **kw)
    for module, tree in ((tp.actor, jp.actor_params), (tp.critic, jp.q_params),
                         (tp.actor_target, jp.actor_target), (tp.q_target, jp.q_target)):
        _load(module, tree)
    return jp, tp


def _td3_step(jp, tp, batch):
    noise = None
    if tp.smoothing_sigma > 0:
        noise = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(jp.update_count), (len(batch), ACT_DIM))))
    return jp.learn_on_batch(batch), floats(tp._update(*transition_tensors(batch, tp.device), noise))


def _assert_td3_close(jp, tp):
    for module, tree in ((tp.actor, jp.actor_params), (tp.critic, jp.q_params),
                         (tp.actor_target, jp.actor_target), (tp.q_target, jp.q_target)):
        _assert_close(module, tree)


def test_td3_delayed_updates_match():
    jp, tp = _td3_pair()
    before = {m: _snapshot(getattr(tp, m)) for m in ("actor", "actor_target", "q_target")}
    mj, mt = _td3_step(jp, tp, _transitions(0))  # step 0: the actor and both targets move
    _assert_metrics(mj, mt)
    _assert_td3_close(jp, tp)
    assert not any(_same_bytes(getattr(tp, m), before[m]) for m in before)
    before = {m: _snapshot(getattr(tp, m)) for m in ("actor", "actor_target", "q_target")}
    critic = _snapshot(tp.critic)
    mj, mt = _td3_step(jp, tp, _transitions(1))  # step 1: only the critics move
    _assert_metrics(mj, mt)
    _assert_td3_close(jp, tp)
    assert all(_same_bytes(getattr(tp, m), before[m]) for m in before)
    assert not _same_bytes(tp.critic, critic)
    assert jp.update_count == tp.update_count == 2
    assert tp.get_state()["actor_opt_state"]["count"] == 1


def test_ddpg_update_matches():
    jp, tp = _td3_pair(policy_delay=1, twin_q=False, smoothing_sigma=0.0)
    q2 = _snapshot(tp.critic.q2)
    for seed in range(2):
        mj, mt = _td3_step(jp, tp, _transitions(seed))
        _assert_metrics(mj, mt)
        _assert_td3_close(jp, tp)
    assert _same_bytes(tp.critic.q2, q2)  # one Q: q2 is kept but unused


def test_td3_state_round_trip():
    _, tp = _td3_pair()
    for seed in range(3):
        tp.learn_on_batch(_transitions(seed))
    state = tp.get_state()
    fresh = TD3Policy((OBS_DIM,), ACT_DIM, hidden=HIDDEN, device="cpu", seed=4)
    fresh.set_state(state)
    assert fresh.update_count == 3
    cols = transition_tensors(_transitions(7), tp.device)
    noise = torch.randn(B, ACT_DIM, generator=torch.Generator().manual_seed(0))
    assert floats(fresh._update(*cols, noise)) == floats(tp._update(*cols, noise))
    for part in ("actor_params", "actor_target", "q_target"):
        for name, value in fresh.get_state()[part].items():
            assert value.tobytes() == tp.get_state()[part][name].tobytes(), (part, name)


# --------------------------------------------------------------------- DQN


DQN_MODELS = {
    "mlp": dict(obs_shape=(4,), model_config=None),
    "cnn": dict(obs_shape=(42, 42, 4), model_config=SMALL_CNN),
}


def _dqn_batch(obs_shape, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    if len(obs_shape) == 3:
        obs, nxt = (rng.integers(0, 256, (B, *obs_shape), dtype=np.uint8) for _ in range(2))
    else:
        obs, nxt = (rng.standard_normal((B, *obs_shape)).astype(np.float32) for _ in range(2))
    batch = SampleBatch({OBS: obs, ACTIONS: rng.integers(0, 3, B), REWARDS: rng.standard_normal(B).astype(np.float32),
                         NEXT_OBS: nxt, DONES: rng.random(B) < 0.2})
    if weights:
        batch["weights"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return batch


@pytest.mark.parametrize("weights", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_dqn_one_update_matches(kind, weights):
    cfg = DQN_MODELS[kind]
    jp = JaxDQNPolicy(num_actions=3, **cfg)
    tp = DQNPolicy(num_actions=3, device="cpu", **cfg)
    _load(tp.model, jp.params)
    _load(tp.target_model, jp.target_params)
    batch = _dqn_batch(cfg["obs_shape"], weights=weights)
    mj, mt = jp.learn_on_batch(batch), tp.learn_on_batch(batch)
    assert mt["loss"] == pytest.approx(mj["loss"], rel=1e-5)
    np.testing.assert_allclose(mt["td_error"], mj["td_error"], rtol=1e-5, atol=1e-6)
    _assert_close(tp.model, jp.params)
    _assert_close(tp.target_model, jp.target_params)  # untouched until sync_target
    jp.sync_target(), tp.sync_target()
    _assert_close(tp.target_model, jp.target_params)


def test_dqn_state_round_trip():
    tp = DQNPolicy(num_actions=3, device="cpu", **DQN_MODELS["mlp"])
    tp.learn_on_batch(_dqn_batch((4,)))
    fresh = DQNPolicy(num_actions=3, device="cpu", seed=5, **DQN_MODELS["mlp"])
    fresh.set_state(tp.get_state())
    batch = _dqn_batch((4,), seed=1)
    assert fresh.learn_on_batch(batch)["loss"] == tp.learn_on_batch(batch)["loss"]
    for name, value in fresh.get_weights().items():
        assert value.tobytes() == tp.get_weights()[name].tobytes(), name


# ----------------------------------------------------------------- workers


def test_sac_worker_warmup_batches_equal():
    """Random warm-up actions from the worker's numpy draws, then past the
    200-step horizon: stored terminals (truncation is not terminal) and
    final_observation rows equal."""
    jw, tw = JaxSACWorker(_jax_pendulum, {"hidden": HIDDEN}, seed=3), SACWorker(_pendulum, {"hidden": HIDDEN}, seed=3)
    for steps in (150, 60):
        bj, bt = jw.sample(steps, random_actions=True), tw.sample(steps, random_actions=True)
        assert set(bj) == set(bt) and all(bj[k].tobytes() == bt[k].tobytes() for k in bj), steps
    assert bt[DONES].dtype == bool and not bt[DONES].any()  # two truncations stored as non-terminal
    # rows [t, env] flattened: a row's next obs is the next step's obs of its
    # env, two rows on, except where the episode was cut: there the true
    # final obs, not the reset obs
    cut = np.nonzero((bt[NEXT_OBS][:-2] != bt[OBS][2:]).any(-1))[0]
    assert len(cut) == 2 and cut.tolist() == np.nonzero(bt[NEXT_OBS][:-2, 0] != bt[OBS][2:, 0])[0].tolist()
    assert jw.episode_stats() == tw.episode_stats() and tw.episode_stats()["episodes"] == 2


def test_td3_worker_raw_actions_match():
    jw, tw = JaxTD3Worker(_jax_pendulum, {"hidden": HIDDEN}, seed=2), TD3Worker(_pendulum, {"hidden": HIDDEN}, seed=2)
    tw.set_weights(rllib_params_from_jax(jax.device_get(jw.policy.get_weights()), tw.policy.actor))
    bj, bt = jw.sample(12), tw.sample(12)
    np.testing.assert_allclose(bt[ACTIONS], bj[ACTIONS], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bt[OBS], bj[OBS], rtol=0, atol=1e-5)
    assert bt[ACTIONS].dtype == np.float32


def test_dqn_worker_epsilon_greedy_actions_equal():
    jw = JaxDQNWorker(_cartpole, {"lr": 1e-3}, seed=1, num_envs=3)
    tw = DQNWorker(_cartpole, {"lr": 1e-3}, seed=1, num_envs=3)
    tw.set_weights(rllib_params_from_jax(jax.device_get(jw.policy.get_weights()), tw.policy.model))
    for eps in (0.5, 0.0):
        bj, bt = jw.sample(20, eps), tw.sample(20, eps)
        assert set(bj) == set(bt) and all(bj[k].tobytes() == bt[k].tobytes() for k in bj), eps
    assert tw.worker_info()["policy_device"] == "cpu"


# --------------------------------------------------- learning (the JAX bars)


def _pendulum_learning(policy, horizon_aware):
    """tests/test_rllib_continuous.py's loop: 16 Pendulum envs, 1000
    random warm-up transitions, then 8 updates of 128 per env step, 900
    env steps; (first-10, last-20) episode reward means and the last
    metrics."""
    from ray_tpu_torch.rllib.env import PendulumEnv as Pendulum

    env = Pendulum(num_envs=16, seed=0)
    buf = ReplayBuffer(100_000, seed=0)
    obs = env.reset(seed=0)
    ep_rew, ep_hist = np.zeros(16), []
    rng = np.random.default_rng(0)
    metrics = {}
    for _ in range(900):
        if len(buf) < 1000:
            raw = rng.uniform(-1, 1, (16, 1)).astype(np.float32)
            env_a = policy._center + policy._scale * raw
        else:
            env_a, raw = policy.compute_actions(obs)
        nobs, rew, done, infos = env.step(env_a)
        term, nstore = done.copy(), nobs
        if horizon_aware:
            nstore = nobs.copy()
            for i, d in enumerate(done):
                if d:
                    term[i] = not infos[i].get("TimeLimit.truncated", False)
                    nstore[i] = infos[i].get("final_observation", nobs[i])
        buf.add(SampleBatch({OBS: obs, ACTIONS: raw, REWARDS: rew, NEXT_OBS: nstore, DONES: term.astype(np.float32)}))
        ep_rew += rew
        for i in np.nonzero(done)[0]:
            ep_hist.append(ep_rew[i])
            ep_rew[i] = 0.0
        obs = nobs
        if len(buf) >= 1000:
            for _ in range(8):
                metrics = policy.learn_on_batch(buf.sample(128))
    return float(np.mean(ep_hist[:10])), float(np.mean(ep_hist[-20:])), metrics


def test_sac_learns_pendulum():
    env = PendulumEnv(num_envs=1)
    policy = SACPolicy((3,), 1, action_low=env.action_space.low, action_high=env.action_space.high,
                       hidden=(128, 128), seed=0, device="cpu")
    first, last, metrics = _pendulum_learning(policy, horizon_aware=False)
    assert last > first + 400, f"no learning: first10={first:.0f} last20={last:.0f}"
    assert metrics["alpha"] > 0 and np.isfinite(metrics["critic_loss"])
