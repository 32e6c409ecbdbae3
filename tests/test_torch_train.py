"""ray_tpu_torch's trainer on the CPU: TorchTrainer → BackendExecutor →
worker actors, held against the JAX package where both compute.

The four cases of tests/test_train.py with torch loops and CPU workers
(`use_gpu=False`); GPT-2 tiny through TorchTrainer against the JAX bundle
from the same weights (2e-6 relative, the tolerance of
test_torch_lm_train.py: the two sides differ by f32 rounding); 2-worker data
parallelism against one worker on the joined batch (identical bits on both
ranks; loss and grad_norm at 1e-5 relative, and each averaged gradient and
each weight tensor after the AdamW step at 1e-5 relative in norm: the mean
of two half-batch gradients equals the joined batch's gradient up to f32
summation order, and Adam's first step divides each gradient element by its
own magnitude, which turns that rounding in near-zero elements into single
elements off by ~1% of the step, so the weights are held per tensor, not per
element); a GPU-less cluster refusing the default `use_gpu=True` at once;
and StepProbe's stats keys against the JAX package's.

One cluster for the module, always shut down.  Every fit() is bounded by the
executor's own timeouts and every get() by TIMEOUT.  The train loops live
at module level and import what they need inside, so a worker that imports
this module by reference loads neither jax nor ray_tpu.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.train import ScalingConfig, TorchTrainer

TIMEOUT = 60
CPU = ScalingConfig(num_workers=1, use_gpu=False)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


# ---------------------------------------------------------------- loops


def _mlp_loop(config):
    import torch

    from ray_tpu_torch.air import session

    gen = torch.Generator().manual_seed(0)
    params = {
        "w1": (torch.randn(784, 128, generator=gen) * 0.05).requires_grad_(),
        "b1": torch.zeros(128, requires_grad=True),
        "w2": (torch.randn(128, 10, generator=gen) * 0.05).requires_grad_(),
        "b2": torch.zeros(10, requires_grad=True),
    }
    x = torch.randn(256, 784, generator=gen)
    y = torch.randint(0, 10, (256,), generator=gen)
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    for epoch in range(config["epochs"]):
        h = torch.relu(x @ params["w1"] + params["b1"])
        loss = torch.nn.functional.cross_entropy(h @ params["w2"] + params["b2"], y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        session.report({"loss": loss.item(), "epoch": epoch})


def _linear_dp_loop(config):
    import json
    import os

    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train.torch import all_reduce_gradients

    rank = session.get_world_rank()
    params = {"w": torch.ones(4, 4, requires_grad=True), "b": torch.zeros(4, requires_grad=True)}
    opt = torch.optim.SGD(params.values(), lr=0.1)
    x = torch.full((8, 4), float(rank + 1))  # deliberately different data per rank
    sums = []
    for i in range(3):
        loss = ((x @ params["w"] + params["b"]) ** 2).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = all_reduce_gradients(grads, group_name=config["group"])
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        sums.append(params["w"].sum().item())
        session.report({"step": i, "w_sum": sums[-1], "rank": rank})
    with open(os.path.join(config["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(sums, f)


def _checkpoint_loop(config):
    import torch

    from ray_tpu_torch.air import Checkpoint, session

    loaded = session.get_checkpoint()
    start = loaded["step"] if loaded else 0
    params = {"w": torch.full((2, 2), float(start), requires_grad=True)}
    session.report({"start": start}, checkpoint=Checkpoint.from_pytree(params, step=start + 1))


def _gpt2_tiny_dp_loop(config):
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import synthetic_batch
    from ray_tpu_torch.train.torch import all_reduce_gradients

    cfg = GPT2Config.tiny(compute_dtype=torch.float32)
    model = GPT2Model(cfg, device="cpu", seed=0)  # same init on all ranks
    rank = session.get_world_rank()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    tok, tgt = synthetic_batch(torch.Generator().manual_seed(rank), 4, 32, cfg.vocab_size, device="cpu")
    params = list(model.parameters())
    for _ in range(2):
        loss = model.loss(tok, tgt)
        grads = all_reduce_gradients(list(torch.autograd.grad(loss, params)))
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        session.report({"loss": loss.item(), "wte0": model.wte[0, 0].item()})


def _gpt2_jax_weights_loop(config):
    """GPT-2 tiny f32 from JAX weights: make_train_step for len(batches) steps."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.convert import gpt2_from_jax_params
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step

    model = GPT2Model(GPT2Config.tiny(compute_dtype=torch.float32), device="cpu")
    bundle = make_train_step(model, device="cpu")
    params, opt = bundle.init(0)
    gpt2_from_jax_params(config["params"], params)
    for tok, tgt in config["batches"]:
        params, opt, m = bundle.step(params, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
        session.report({k: v.item() for k, v in m.items()})


def _gpt2_joined_batch_loop(config):
    """One AdamW step (clipping as make_train_step does it) on this rank's
    rows of config["tokens"], gradients averaged over the group; writes the
    new weights and the loss to out_dir."""
    import os

    import numpy as np
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from ray_tpu_torch.models.lm_train import make_train_step
    from ray_tpu_torch.train.torch import all_reduce_gradients, get_data_shard

    rank, world = session.get_world_rank(), session.get_world_size()
    model = GPT2Model(GPT2Config.tiny(compute_dtype=torch.float32), device="cpu")
    params, opt = make_train_step(model, device="cpu").init(0)
    tokens = torch.from_numpy(config["tokens"].copy())
    lo, hi = get_data_shard(tokens.shape[0])
    tok, tgt = tokens[lo:hi, :-1], tokens[lo:hi, 1:]
    ps = list(params.parameters())
    loss = params.loss(tok, tgt)
    grads = all_reduce_gradients(list(torch.autograd.grad(loss, ps)))
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.where(gnorm < 1.0, torch.ones_like(gnorm), 1.0 / gnorm)
    for p, g in zip(ps, grads):
        p.grad = g * coef
    opt.step()
    losses = all_reduce_gradients([loss.detach().reshape(1)])[0]
    out = {k: v.detach().numpy() for k, v in params.state_dict().items()}
    out.update({f"grad:{n}": g.numpy() for (n, _), g in zip(params.named_parameters(), grads)})
    np.savez(os.path.join(config["out_dir"], f"world{world}_rank{rank}.npz"), **out)
    session.report({"loss": losses.item(), "grad_norm": gnorm.item()})


def _noop_loop(config):
    from ray_tpu_torch.air import session

    session.report({"ok": True})


# ---------------------------------------------------------------- tests


def test_single_worker_mlp(cluster):
    """MNIST-shaped MLP on synthetic data, 1 worker: the loss falls."""
    result = TorchTrainer(_mlp_loop, train_loop_config={"epochs": 5}, scaling_config=CPU).fit()
    assert len(result.metrics_history) == 5
    assert result.metrics_history[-1]["loss"] < result.metrics_history[0]["loss"]


def test_two_worker_dp_gradient_sync(cluster, tmp_path):
    """2-worker DP with the dcn ring: identical params on both ranks after
    every step, equal to the single-process mean-gradient reference."""
    trainer = TorchTrainer(
        _linear_dp_loop,
        train_loop_config={"group": "_train_dp", "out_dir": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
    )
    result = trainer.fit()
    assert len(result.metrics_history) == 3
    sums0 = json.loads((tmp_path / "rank0.json").read_text())
    sums1 = json.loads((tmp_path / "rank1.json").read_text())
    np.testing.assert_allclose(sums0, sums1, rtol=1e-6)

    params = {"w": torch.ones(4, 4, requires_grad=True), "b": torch.zeros(4, requires_grad=True)}
    opt = torch.optim.SGD(params.values(), lr=0.1)
    expected = []
    for _ in range(3):
        per_rank = []
        for rank in range(2):
            x = torch.full((8, 4), float(rank + 1))
            per_rank.append(torch.autograd.grad(((x @ params["w"] + params["b"]) ** 2).mean(), list(params.values())))
        for p, g0, g1 in zip(params.values(), *per_rank):
            p.grad = (g0 + g1) / 2
        opt.step()
        expected.append(params["w"].sum().item())
    np.testing.assert_allclose(sums0, expected, rtol=1e-5)


def test_checkpoint_roundtrip(cluster):
    result = TorchTrainer(_checkpoint_loop, scaling_config=CPU).fit()
    assert result.checkpoint is not None and result.checkpoint.get("step") == 1
    w = result.checkpoint.to_pytree()["w"]
    assert isinstance(w, torch.Tensor) and not w.requires_grad and w.device.type == "cpu"
    result2 = TorchTrainer(_checkpoint_loop, scaling_config=CPU, resume_from_checkpoint=result.checkpoint).fit()
    assert result2.metrics["start"] == 1


def test_gpt2_tiny_dp_two_workers(cluster):
    """GPT-2 tiny data-parallel across 2 worker actors, gradients averaged
    over the dcn ring each step."""
    result = TorchTrainer(_gpt2_tiny_dp_loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=False)).fit()
    assert len(result.metrics_history) == 2
    assert result.metrics["loss"] > 0


def test_gpt2_tiny_through_trainer_matches_jax(cluster):
    """GPT-2 tiny f32, 3 steps, 1 worker, from the JAX bundle's init weights:
    loss and grad_norm at every step against the JAX bundle's."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config as JaxConfig
    from ray_tpu.models.gpt2 import GPT2Model as JaxModel
    from ray_tpu.models.lm_train import make_train_step as jax_make_train_step
    from ray_tpu.parallel.mesh import MeshConfig, make_mesh

    jcfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    jb = jax_make_train_step(JaxModel(jcfg), make_mesh(MeshConfig(dp=1), jax.devices()[:1]))
    jparams, jopt = jb.init(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, (2, jcfg.block_size + 1))
        batches.append((tokens[:, :-1].copy(), tokens[:, 1:].copy()))
    want = []
    for tok, tgt in batches:
        jparams, jopt, jm = jb.step(jparams, jopt, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
        want.append({k: float(jm[k]) for k in ("loss", "grad_norm")})

    result = TorchTrainer(
        _gpt2_jax_weights_loop, train_loop_config={"params": start, "batches": batches}, scaling_config=CPU
    ).fit()
    assert len(result.metrics_history) == 3
    for i, (got, ref) in enumerate(zip(result.metrics_history, want)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=2e-6, err_msg=f"step {i} {key}")


def test_dp_step_equals_one_worker_on_the_joined_batch(cluster, tmp_path):
    tokens = np.random.default_rng(1).integers(0, 512, (4, 65))
    cfg = {"tokens": tokens, "out_dir": str(tmp_path)}
    two = TorchTrainer(_gpt2_joined_batch_loop, train_loop_config=cfg,
                       scaling_config=ScalingConfig(num_workers=2, use_gpu=False)).fit()
    one = TorchTrainer(_gpt2_joined_batch_loop, train_loop_config=cfg, scaling_config=CPU).fit()
    np.testing.assert_allclose(two.metrics["loss"], one.metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(two.metrics["grad_norm"], one.metrics["grad_norm"], rtol=1e-5)
    r0, r1, ref = (np.load(tmp_path / n) for n in ("world2_rank0.npz", "world2_rank1.npz", "world1_rank0.npz"))
    assert sorted(r0.files) == sorted(ref.files)
    for name in ref.files:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)  # identical on both ranks
        # the averaged gradients and the weights after AdamW, tensor by tensor
        err = np.linalg.norm(r0[name] - ref[name]) / max(np.linalg.norm(ref[name]), 1e-30)
        assert err <= 1e-5, (name, err)


def test_default_use_gpu_without_a_gpu_raises_at_once(cluster):
    assert ScalingConfig().use_gpu is True
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="GPU"):
        TorchTrainer(_noop_loop).fit()
    assert time.monotonic() - t0 < 5


def test_cut_entry_points_raise(cluster):
    # the step DAG is ported: a spec reaches fit_spec, which checks it
    from ray_tpu_torch.models.lm_train import make_lm_step_spec

    with pytest.raises(ValueError, match="steps must be positive"):
        TorchTrainer(
            train_step_spec=make_lm_step_spec(steps=0, device="cpu"),
            scaling_config=ScalingConfig(use_gpu=False),
        ).fit()
    with pytest.raises(NotImplementedError, match="Tune"):
        TorchTrainer(_noop_loop).as_trainable()
    from ray_tpu_torch.train.torch import local_mesh

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        local_mesh()


def test_step_probe_stats_keys_match_jax():
    from ray_tpu.train.jax.step_probe import StepProbe as JaxStepProbe
    from ray_tpu_torch.train.torch import StepProbe

    stats = []
    for cls in (JaxStepProbe, StepProbe):
        probe = cls("keys", flops_per_step=1e9, peak_flops_per_device=1e12)
        probe.enabled = True
        for _ in range(3):
            with probe.step():
                with probe.phase("compute"):
                    probe.block({"loss": torch.ones(2)} if cls is StepProbe else None)
        stats.append(probe.stats())
    assert sorted(stats[0]) == sorted(stats[1])
    assert {"p50_s", "p99_s", "jitter_pct", "mfu"} <= set(stats[1]) and stats[1]["steps"] == 3


def test_checkpoint_from_pytree_detaches_to_cpu():
    w = torch.ones(2, requires_grad=True)
    ck = Checkpoint.from_pytree({"a": [w, (w * 2,)], "n": 3}, step=7)
    tree = ck.to_pytree()
    a0, (a1,) = tree["a"]
    assert not a0.requires_grad and not a1.requires_grad and tree["n"] == 3 and ck["step"] == 7
    with torch.no_grad():
        w.add_(1)
    assert torch.equal(a0, torch.ones(2))  # a snapshot, not a view
