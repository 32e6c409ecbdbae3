"""ray_tpu_torch.rllib's algorithms on a CPU cluster, held to the JAX tests' bars.

The learning checks of tests/test_rllib.py (PPO, IMPALA, DDPPO on
CartPole) and tests/test_rllib_cnn.py (APPO on CartPole, PPO on the
pixel env with small filters), at the same configurations, with the
learner on the CPU (`learner_device="cpu"`, the caller naming the CPU)
and the rollout workers as CPU actors of one module-scoped cluster.
Then `save`/`restore` of the full learner state, and the default device:
without a card `TorchPolicy()` and `PPO` raise instead of running on the
CPU.  Every cluster call carries a timeout.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import APPOConfig, AlgorithmConfig, DDPPOConfig, IMPALAConfig, TorchPolicy
from ray_tpu_torch.rllib.env import SyntheticPixelEnv


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


def _best(algo, iters, bar):
    """(first, best) episode reward mean over at most `iters` iterations,
    stopping once `bar(first, best)` holds; stops the algorithm."""
    best, first = -np.inf, None
    try:
        for _ in range(iters):
            r = algo.train()
            if first is None and r["episodes_total"] > 0:
                first = r["episode_reward_mean"]
            best = max(best, r["episode_reward_mean"])
            if first is not None and bar(first, best):
                break
    finally:
        algo.stop()
    return first, best


def _over_60(first, best):
    return best > 60


def test_ppo_cartpole_learns(cluster):
    algo = (
        AlgorithmConfig(learner_device="cpu")
        .environment(_cartpole)
        .rollouts(num_rollout_workers=2)
        .training(train_batch_size=800, sgd_minibatch_size=128, num_sgd_iter=6, lr=5e-3, entropy_coeff=0.01)
        .build()
    )
    assert all(p.device.type == "cpu" for p in algo.policy.model.parameters())
    first, best = _best(algo, 12, _over_60)
    # CartPole random play ~20; must clearly improve within budget
    assert best > 60, f"PPO failed to learn: best {best}, first {first}"


def test_impala_cartpole_learns(cluster):
    algo = (
        IMPALAConfig(rollout_fragment_length=200, num_batches_per_iter=10, lr=5e-3, entropy_coeff=0.01,
                     learner_device="cpu")
        .environment(_cartpole)
        .rollouts(num_rollout_workers=2)
        .build()
    )
    _, best = _best(algo, 14, _over_60)
    assert best > 60, f"IMPALA failed to learn: best {best}"


def test_appo_cartpole_learns(cluster):
    algo = (
        APPOConfig(learner_device="cpu")
        .environment(_cartpole)
        .rollouts(num_rollout_workers=2)
        .training(lr=5e-3, rollout_fragment_length=100, entropy_coeff=0.01)
        .build()
    )
    assert algo.policy.vtrace_clip
    _, best = _best(algo, 20, _over_60)
    assert best > 60, best


def test_ddppo_decentralized_sync_and_learning(cluster):
    """Workers allreduce gradients among themselves (dcn ring, no central
    learner): the replicas stay synchronized and learn."""
    algo = (
        DDPPOConfig(rollout_fragment_length=300, train_batch_size=600, sgd_minibatch_size=128, num_sgd_iter=4,
                    lr=5e-3, entropy_coeff=0.01)
        .environment(_cartpole)
        .rollouts(num_rollout_workers=2)
        .build()
    )
    try:
        best = 0.0
        for _ in range(10):
            best = max(best, algo.train()["episode_reward_mean"])
            if best > 60:
                break
        w0, w1 = ray_tpu_torch.get([w.get_weights.remote() for w in algo.workers], timeout=60)
        assert set(w0) == set(w1)
        for name in w0:
            np.testing.assert_allclose(w0[name], w1[name], rtol=1e-5, atol=1e-6, err_msg=name)
        assert best > 60, f"DDPPO failed to learn: best {best}"
    finally:
        algo.stop()


def _pixels():
    return SyntheticPixelEnv(num_envs=8, shaped=True, seed=7)


def test_ppo_pixel_cnn_learns(cluster):
    """BASELINE config #3's shape: PPO with a CNN policy on a pixel env,
    rollout actors and a central learner, must improve."""
    algo = (
        AlgorithmConfig(learner_device="cpu")
        .environment(_pixels)
        .rollouts(num_rollout_workers=2, num_envs_per_worker=8)
        .training(lr=1e-3, train_batch_size=640, rollout_fragment_length=40, sgd_minibatch_size=160,
                  num_sgd_iter=4, model={"type": "cnn", "conv_filters": ((16, 8, 4), (32, 4, 2))})
        .build()
    )
    info = ray_tpu_torch.get(algo.workers[0].worker_info.remote(), timeout=60)
    assert info["policy_device"] == "cpu" and info["torch_threads"] == 1
    assert not {"jax", "jaxlib", "ray_tpu"} & set(info["modules"])
    first, best = _best(algo, 12, lambda first, best: best > first + 0.15)
    assert first is not None
    assert best > first + 0.15, (first, best)


def test_save_restore_round_trip(cluster, tmp_path):
    """`save` writes the full learner state (parameters, Adam's moments
    and count) and the iteration; `restore` brings all of it back after
    more training moved it on."""
    algo = (
        AlgorithmConfig(learner_device="cpu")
        .environment(_cartpole)
        .rollouts(num_rollout_workers=1)
        .training(train_batch_size=200, sgd_minibatch_size=64, num_sgd_iter=2)
        .build()
    )
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        saved = algo.policy.get_state()
        algo.train()
        assert algo.policy.get_state()["opt_state"]["count"] > saved["opt_state"]["count"] > 0
        algo.restore(str(tmp_path / "ckpt"))
        assert path.endswith("algorithm_state.pkl") and algo.iteration == 1
        got = algo.policy.get_state()
        assert got["opt_state"]["count"] == saved["opt_state"]["count"]
        for name, value in saved["params"].items():
            assert value.tobytes() == got["params"][name].tobytes(), name
        for part in ("exp_avg", "exp_avg_sq"):
            for name, value in saved["opt_state"][part].items():
                assert value.tobytes() == got["opt_state"][part][name].tobytes(), name
        assert algo.train()["training_iteration"] == 2
    finally:
        algo.stop()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchPolicy(obs_dim=4)
    # PPO builds its learner before any worker: no cluster is touched
    with pytest.raises(RuntimeError, match="CUDA"):
        AlgorithmConfig().environment(_cartpole).build()
