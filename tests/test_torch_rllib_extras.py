"""ray_tpu_torch.rllib's replay-driven algorithms and the rest of `rllib/` on a CPU cluster.

The cases of tests/test_rllib_cnn.py (DQN on CartPole, above 80),
tests/test_rllib_continuous.py (SAC, TD3 and DDPG end to end, ES on a
quadratic objective, TD3 learning Pendulum by its bar) and
tests/test_rllib_extras.py (multi-agent PPO, the policy server and
client, SAC's and ES's save/restore, offline JSON I/O), at the same
configurations, with the learner on the CPU (`learner_device="cpu"`, the
caller naming the CPU) and the rollout workers as CPU actors of one
module-scoped cluster.  Offline files written by either package are read
by the other.  Every cluster call carries a timeout.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.env import Box, PendulumEnv, VectorEnv
from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread for the learners in this process (the
    rollout workers run the one thread their CPU grants): the test sweep
    runs several files at once on the same cores, where a pool of spinning
    threads per process slows every one of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


# --------------------------------------------------------------------- DQN


def test_dqn_cartpole_learns(cluster):
    algo = (
        rllib.DQNConfig(learner_device="cpu")
        .environment(_cartpole)
        .rollouts(num_rollout_workers=2)
        .training(lr=1e-3, buffer_size=20_000, learning_starts=500, rollout_fragment_length=200,
                  target_network_update_freq=400, num_train_per_iter=64, epsilon_timesteps=4_000,
                  train_batch_size=64)
        .build()
    )
    try:
        infos = ray_tpu_torch.get([w.worker_info.remote() for w in algo.workers], timeout=60)
        assert all(i["policy_device"] == "cpu" and i["torch_threads"] == 1 for i in infos)
        assert not {"jax", "jaxlib", "ray_tpu"} & set().union(*(i["modules"] for i in infos))
        best = 0.0
        for _ in range(16):
            best = max(best, algo.train()["episode_reward_mean"])
            if best > 80:
                break
        assert best > 80, best  # random play is ~20
    finally:
        algo.stop()


def test_dqn_prioritized_replay_end_to_end(cluster):
    """PER through the algorithm: |td| of every update goes back to the
    buffer as priorities."""
    algo = (
        rllib.DQNConfig(learner_device="cpu", prioritized_replay=True)
        .environment(_cartpole)
        .rollouts(num_rollout_workers=1)
        .training(learning_starts=100, rollout_fragment_length=100, num_train_per_iter=4, train_batch_size=32)
        .build()
    )
    try:
        r = algo.train()
        assert r["num_td_updates"] == 4 and np.isfinite(r["loss"])
        prio = algo.buffer._prio[: len(algo.buffer)]
        assert len(np.unique(prio)) > 1  # no longer all at the initial max priority
    finally:
        algo.stop()


# ------------------------------------------------------------ SAC, TD3, DDPG


def _continuous(config_cls, **training):
    return (
        config_cls(learner_device="cpu")
        .environment(lambda: PendulumEnv(num_envs=8, seed=0))
        .rollouts(num_rollout_workers=1, num_envs_per_worker=8)
        .training(learning_starts=200, train_batch_size=64, num_train_per_iter=4, rollout_fragment_length=200,
                  hidden=(32, 32), **training)
        .build()
    )


@pytest.mark.parametrize("config_cls", [rllib.SACConfig, rllib.TD3Config, rllib.DDPGConfig],
                         ids=["sac", "td3", "ddpg"])
def test_continuous_algorithm_end_to_end(cluster, config_cls):
    """Real rollout actors: buffers fill, updates run, metrics flow."""
    algo = _continuous(config_cls)
    try:
        r1 = algo.train()
        r2 = algo.train()
        assert r2["timesteps_total"] > r1["timesteps_total"] >= 200
        assert r2["num_grad_updates"] == 4
        assert np.isfinite(r2["critic_loss"]) and r2["episodes_total"] >= 0
        info = ray_tpu_torch.get(algo.workers[0].worker_info.remote(), timeout=60)
        assert info["policy_device"] == "cpu" and info["pid"] != os.getpid()
    finally:
        algo.stop()
    if config_cls is rllib.DDPGConfig:
        assert not algo.policy.twin_q and algo.policy.policy_delay == 1 and algo.policy.smoothing_sigma == 0.0


def test_sac_save_restore(cluster, tmp_path):
    """Algorithm.save/restore keep the full learner state: the restored
    policy's actions and critics are the saved ones, training continues."""

    def make():
        return (
            rllib.SACConfig(learner_device="cpu")
            .environment(lambda: PendulumEnv(num_envs=4, seed=0))
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4)
            .training(learning_starts=50, train_batch_size=32, num_train_per_iter=2, rollout_fragment_length=60,
                      hidden=(16, 16))
            .build()
        )

    def q1(algo_):
        with torch.no_grad():
            return float(algo_.policy.critic(torch.zeros(1, 3), torch.zeros(1, 1))[0][0])

    obs = np.array([[0.1, -0.2, 0.3]], np.float32)
    algo = make()
    try:
        algo.train()
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        ref_actions, _ = algo.policy.compute_actions(obs, deterministic=True)
        q1_ref, it, steps = q1(algo), algo.iteration, algo.total_steps
        opt_count = algo.policy.get_state()["critic_opt_state"]["count"]
    finally:
        algo.stop()
    algo2 = make()
    try:
        algo2.restore(path)
        assert algo2.iteration == it and algo2.total_steps == steps
        actions2, _ = algo2.policy.compute_actions(obs, deterministic=True)
        assert actions2.tobytes() == ref_actions.tobytes()
        assert q1(algo2) == q1_ref  # the saved critics, not fresh ones
        assert algo2.policy.get_state()["critic_opt_state"]["count"] == opt_count > 0
        assert np.isfinite(algo2.train().get("critic_loss", 0.0))
    finally:
        algo2.stop()


def test_td3_learns_pendulum():
    """tests/test_rllib_continuous.py's TD3 bar: 16 Pendulum envs, 1000
    random warm-up transitions, 8 updates of 128 an env step for 900 env
    steps, the last 20 episodes more than 700 above the first 10."""
    from test_torch_rllib_offpolicy import _pendulum_learning

    env = PendulumEnv(num_envs=1)
    policy = rllib.TD3Policy((3,), 1, action_low=env.action_space.low, action_high=env.action_space.high,
                             hidden=(128, 128), seed=0, device="cpu")
    first, last, metrics = _pendulum_learning(policy, horizon_aware=True)
    assert last > first + 700, f"no learning: first10={first:.0f} last20={last:.0f}"
    assert np.isfinite(metrics["critic_loss"])


# ------------------------------------------------------------- multi-agent


class TwoArmEnv:
    """Two agents, each a contextual bandit: obs in {0,1}^2, the right
    action equals obs argmax; reward 1/0.  Episode = 8 steps."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.observation_spaces = {"a0": (2,), "a1": (2,)}
        self.action_spaces = {"a0": 2, "a1": 2}
        self.t = 0

    def _obs(self):
        out = {}
        for aid in ("a0", "a1"):
            v = np.zeros(2, np.float32)
            v[self.rng.integers(0, 2)] = 1.0
            out[aid] = v
        self._last = out
        return out

    def reset(self, seed=None):
        self.t = 0
        return self._obs(), {}

    def step(self, actions):
        rewards = {aid: float(actions[aid] == int(self._last[aid].argmax())) for aid in actions}
        self.t += 1
        done = self.t >= 8
        obs = self._obs()
        dones = {aid: done for aid in actions}
        dones["__all__"] = done
        return obs, rewards, dones, {}


def test_multi_agent_ppo_learns(cluster):
    spec = {"obs_shape": (2,), "num_actions": 2, "lr": 5e-2}
    algo = (
        rllib.MultiAgentPPOConfig(learner_device="cpu")
        .environment(lambda: TwoArmEnv(seed=3))
        .rollouts(num_rollout_workers=2)
        .training(train_batch_size=256, rollout_fragment_length=64, num_sgd_iter=4)
        .multi_agent(policies={"p0": spec, "p1": spec}, policy_mapping_fn=lambda aid: "p0" if aid == "a0" else "p1")
        .build()
    )
    try:
        assert all(p.device.type == "cpu" for p in algo.policies.values())
        best = 0.0
        for _ in range(10):
            r = algo.train()
            best = max(best, r["episode_reward_mean"])
            if best > 10.5:
                break
        assert set(r["policy_loss"]) == {"p0", "p1"}
        # random play: ~8 (16 decisions * 0.5); learned: toward 16
        assert best > 10.5, best
    finally:
        algo.stop()


# ---------------------------------------------------------------------- ES


def _quad_env():
    class QuadEnv(VectorEnv):
        """Reward peaks when the policy outputs a fixed target action — a
        deterministic 1-step objective that isolates the ES math."""

        def __init__(self):
            self.num_envs = 1
            self.observation_space = Box((2,), np.float32)
            self.action_space = Box((1,), np.float32, low=-1.0, high=1.0)
            self._obs = np.array([[0.3, -0.7]], np.float32)

        def reset(self, seed=None):
            return self._obs

        def step(self, actions):
            a = float(np.asarray(actions).reshape(-1)[0])
            return self._obs, np.array([-((a - 0.5) ** 2)], np.float32), np.array([True]), [{}]

    return QuadEnv


def test_es_improves_on_quadratic_env(cluster):
    algo = (
        rllib.ESConfig()
        .environment(_quad_env())
        .training(population=64, sigma=0.15, step_size=0.1, hidden=(8,), episode_horizon=1, seed=3)
        .build()
    )
    try:
        first = algo.train()["episode_reward_mean"]
        tail = [algo.train()["episode_reward_mean"] for _ in range(19)]
        # rank-based search gradients are noisy: judge the late-phase average
        late = float(np.mean(tail[-5:]))
        assert late > first + 0.05, (first, late)
        assert algo.total_episodes == 64 * 20
    finally:
        algo.stop()


def test_es_save_restore(cluster, tmp_path):
    def make():
        return (
            rllib.ESConfig()
            .environment(lambda: PendulumEnv(num_envs=2, seed=0))
            .training(population=4, episode_horizon=5, hidden=(4,))
            .build()
        )

    algo = make()
    algo.train()
    path = algo.save(str(tmp_path / "es_ckpt"))
    theta, episodes = algo.theta.copy(), algo.total_episodes
    algo.stop()
    algo2 = make()
    algo2.restore(path)
    assert algo2.theta.tobytes() == theta.tobytes()
    assert algo2.iteration == 1 and algo2.total_episodes == episodes
    algo2.stop()


# ------------------------------------------------------------- offline I/O


def _offline_batches(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [
        SampleBatch({
            OBS: rng.standard_normal((16, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, 16),
            REWARDS: rng.standard_normal(16).astype(np.float32),
            NEXT_OBS: rng.standard_normal((16, 4)).astype(np.float32),
            DONES: rng.random(16) < 0.1,
        })
        for _ in range(n)
    ]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_offline_json_round_trip_between_packages(tmp_path, writer):
    """Files one package writes are read by the other (and by itself),
    every column with its dtype; an offline batch feeds DQN's update."""
    from ray_tpu.rllib import offline as jax_offline
    from ray_tpu_torch.rllib import offline

    write_mod, read_mod = (offline, jax_offline) if writer == "port" else (jax_offline, offline)
    batches = _offline_batches()
    w = write_mod.JsonWriter(str(tmp_path / "out"))
    for b in batches:
        w.write(b)
    w.close()
    for reader in (read_mod.JsonReader, write_mod.JsonReader):
        back = reader(str(tmp_path / "out")).read_all()
        assert len(back) == 3
        for orig, rb in zip(batches, back):
            assert set(orig) == set(rb)
            for k in orig:
                assert np.asarray(rb[k]).dtype == orig[k].dtype and np.asarray(rb[k]).tobytes() == orig[k].tobytes()
    pol = rllib.DQNPolicy(obs_shape=(4,), num_actions=2, lr=1e-3, device="cpu")
    assert np.isfinite(pol.learn_on_batch(offline.JsonReader(str(tmp_path / "out")).read_all()[0])["loss"])


# ---------------------------------------------------------- policy server


def test_policy_server_client_round_trip():
    """An external env drives a TorchPolicy over HTTP; experience comes
    back as GAE'd batches and a policy update consumes them."""
    import gymnasium as gym

    policy = rllib.TorchPolicy(obs_dim=4, num_actions=2, lr=1e-3, device="cpu")
    server = rllib.PolicyServer(policy)
    addr = server.start()
    try:
        client = rllib.PolicyClient(addr)
        env = gym.make("CartPole-v1")
        total, steps = 0.0, 0
        for _ in range(3):
            eid = client.start_episode()
            obs, _ = env.reset(seed=0)
            for _step in range(60):
                a = client.get_action(eid, obs)
                assert a in (0, 1)
                obs, r, term, trunc, _ = env.step(a)
                client.log_returns(eid, r)
                total += r
                steps += 1
                if term or trunc:
                    break
            client.end_episode(eid)
        assert server.sample_batch(min_steps=steps + 1) is None  # not enough yet: nothing drained
        batch = server.sample_batch(min_steps=10)
        assert batch is not None and len(batch) == steps == server.total_steps
        assert abs(batch[REWARDS].sum() - total) < 1e-6 and batch[DONES].sum() == 3
        assert np.isfinite(policy.learn_on_batch(batch)["total_loss"])
    finally:
        server.stop()
