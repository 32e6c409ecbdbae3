"""chip_smoke.py's contract where there is no card, and its bound arithmetic.

The script must exit non-zero and print no result line when CUDA is absent,
from the repo root and from a directory that holds nothing else of the repo.
Its least-time bounds and the forward's operation count (for its TFLOP/s)
are checked against hand-counted bytes and operations at GPT-2 124M's
attention shape.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_cuda(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run(
        [sys.executable, str(script)],
        cwd=script.parent,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_attention_bounds_at_gpt2_shape():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    bounds = chip_smoke.attention_bounds(B, S, H, D)
    pairs = B * H * S * (S + 1) // 2
    tensor = B * S * H * D * 2
    fwd_bytes = 4 * tensor + B * H * S * 4  # q, k, v, o in bf16; lse in f32
    bwd_flops = 10 * D * pairs  # five causal products, 2 FLOP per MAC
    assert bounds["causal_attention_fwd"] == (pytest.approx(fwd_bytes / 3.35e12 * 1e3), "bytes")
    assert bounds["causal_attention_bwd"] == (pytest.approx(bwd_flops / 989e12 * 1e3), "operations")


@pytest.mark.parametrize("name", ["LLAMA_LONG_ATTN", "LLAMA_ATTN"])
def test_attention_bounds_at_llama_shapes(name):
    """Llama-2-7B's attention at LlamaConfig's default max_seq_len (B=1,
    S=2048, H=32, D=128) is bound by operations in both directions: 3.4e10
    FLOP forward and 8.6e10 backward over the causal pairs, against 67 MB
    and 134 MB.  At the prefill shape (S=256) the forward is bound by its
    bytes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    shape = getattr(chip_smoke, name)
    bounds = chip_smoke.attention_bounds(*shape)
    if name == "LLAMA_LONG_ATTN":
        assert shape == (1, 2048, 32, 128)
        assert bounds["causal_attention_fwd"] == (pytest.approx(0.0348, abs=5e-5), "operations")
        assert bounds["causal_attention_bwd"] == (pytest.approx(0.0869, abs=5e-5), "operations")
        flops = chip_smoke.attention_flops(*shape, products=5)
        assert bounds["causal_attention_bwd"][0] == pytest.approx(flops / 989e12 * 1e3)
    else:
        assert shape == (1, 256, 32, 128)
        fwd_bytes = 4 * 256 * 32 * 128 * 2 + 32 * 256 * 4  # q, k, v, o in bf16; lse in f32
        assert bounds["causal_attention_fwd"] == (pytest.approx(0.0025, abs=5e-5), "bytes")
        assert bounds["causal_attention_fwd"][0] == pytest.approx(fwd_bytes / 3.35e12 * 1e3)


def test_attention_flops_at_gpt2_shape():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    # Q K^T and P V, 2 FLOP per multiply-add, over the S(S+1)/2 causal pairs
    assert chip_smoke.attention_flops(B, S, H, D) == 2 * 2 * D * B * H * S * (S + 1) // 2
    ops_ms = chip_smoke.attention_flops(B, S, H, D) / 989e12 * 1e3
    assert chip_smoke.attention_bounds(B, S, H, D)["causal_attention_fwd"][0] >= ops_ms


def test_backward_flops_give_the_backward_bound():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    # five products (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) over the causal pairs
    flops = chip_smoke.attention_flops(B, S, H, D, products=5)
    assert flops == 2 * 5 * D * B * H * S * (S + 1) // 2
    assert chip_smoke.attention_bounds(B, S, H, D)["causal_attention_bwd"][0] == pytest.approx(flops / 989e12 * 1e3)


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FAILED", [])
    return chip_smoke


def test_llama_and_serve_phases_rehearsal(monkeypatch, capsys):
    """Phases (f) and (g) on the CPU at the `tiny` config: (f) reports its
    keys and the B=1 tokens; (g) runs the whole serving path (a cluster
    counting one logical GPU, the replica as a GPU worker on the CPU) and
    reports its keys, serves (f)'s tokens (one request, and a batch of 8
    row for row), and a failed check in it makes
    the script's ending return 1 without the result line."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import attention as att

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setenv("RAY_TPU_GPUS", "1")
    tiny = LlamaConfig.tiny(param_dtype=torch.bfloat16)
    launches, report, direct = cs.llama_phase(att, "cpu", model=tiny, device="cpu")
    assert set(launches) == set(cs.COUNTERS)
    for key in ("apply_err", "apply_plain_err", "prefill_err", "prefill_f32_err", "bound_ms", "b1", "b8", "profile"):
        assert key in report, key
    assert {"ms_per_step", "tpot_ms", "bound_share", "tokens_per_s", "peak_memory_gib"} <= set(report["b8"])
    assert {"idle_share", "k4_share", "k4_ms_per_step"} <= set(report["profile"])
    assert len(direct[1]) == 1 and len(direct[cs.LLAMA_BATCH]) == cs.LLAMA_BATCH
    assert all(len(row) == cs.LLAMA_NEW for rows in direct.values() for row in rows)
    # on the CPU no kernel launches, so exactly the launch and trace checks fail
    assert all("launches" in name or "profile" in name for name in cs.FAILED), cs.FAILED
    cs.FAILED.clear()

    wrong = {**direct, 1: [[(t + 1) % tiny.vocab_size for t in direct[1][0]]]}
    serve = cs.serve_phase("cpu", "cpu", wrong, model=tiny, device="cpu", timeout=120)
    assert serve["first"] == direct[1][0]  # the served request equals (f)'s direct generate
    assert serve["batch"] == direct[cs.LLAMA_BATCH]  # and the batch of 8, row for row
    assert set(serve["loads"]) == set(cs.SERVE_LOADS)
    for row in serve["loads"].values():
        assert row["answered"] == row["requests"] and {"tokens_per_s", "p50_ms", "p99_ms"} <= set(row)
    assert serve["ttft"]["count"] >= 1 and serve["tpot"]["count"] >= 1
    assert cs.FAILED == ["serve (g) one request equals (f)'s direct B=1 generate"]
    capsys.readouterr()
    assert cs.finish([], "cpu") == 1
    out = capsys.readouterr().out
    assert '"kernels"' in out and '"ok"' not in out


def test_leftover_counts_only_what_the_phase_left(monkeypatch):
    """The no-process-left check of phases (e) and (g): a cluster process
    still alive and a process that appeared below the script during the
    phase count; a child the script had before the phase does not."""
    import os
    import subprocess

    cs = _chip_smoke(monkeypatch)
    old = subprocess.Popen(["sleep", "60"])
    try:
        before = cs.session_processes(os.getpid())
        assert cs.leftover({}, before) == []
        new = subprocess.Popen(["sleep", "60"])
        try:
            assert cs.leftover({}, before) == [new.pid]
            cluster = {new.pid: cs._proc_stat(new.pid)[2]}
            assert cs.leftover(cluster, cs.session_processes(os.getpid())) == [new.pid]
        finally:
            new.kill()
            new.wait(timeout=10)
        assert cs.leftover(cluster, before) == []
    finally:
        old.kill()
        old.wait(timeout=10)


def test_step_dag_phase_rehearsal(monkeypatch, capsys):
    """Phase (h) on the CPU at the `tiny` config: a cluster counting one
    logical GPU, the eager fit and the DAG fit each in a GPU worker on the
    CPU, the checks and the process scan after shutdown.  On the CPU the two
    runs agree bit for bit in every loss and weight; no kernel launches, so
    exactly the launch checks fail."""
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setenv("RAY_TPU_GPUS", "1")
    runs = cs.step_dag_phase("cpu", "cpu", model="tiny", batch=2, seq=None, device="cpu")
    eager, dag = runs["eager"], runs["dag"]
    assert len(eager["losses"]) == len(dag["losses"]) == cs.STEP_DAG_STEPS
    assert eager["losses"] == dag["losses"]
    pe, pd = eager["snap"]["lm"]["params"], dag["snap"]["lm"]["params"]
    assert all((pe[n] == pd[n]).all() for n in pd)
    assert eager["ms_per_step"] > 0 and dag["ms_per_step"] > 0
    assert cs.FAILED == [f"step DAG (h) {name} launches all on the sm90_f32 kernels" for name in ("eager", "dag")], cs.FAILED
    capsys.readouterr()


def test_engine_phase_rehearsal(monkeypatch, capsys):
    """Phase (i) on the CPU at the `tiny` config: (i1) the engine in this
    process on mixed prompt lengths against generate, one shape per
    program; (i2) the served engine (a cluster counting one logical GPU,
    the replica a GPU worker on the CPU) under the three loads, buffered and
    streamed, an SSE stream, the overload burst's 503, then the direct
    generate.  On the CPU every check passes: no kernel is on this path."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setenv("RAY_TPU_GPUS", "1")
    tiny = LlamaConfig.tiny(param_dtype=torch.bfloat16)
    cs.engine_check_phase("cpu", model=tiny, device="cpu")
    assert cs.FAILED == []
    static = {"loads": {c: {"tokens_per_s": 1.0, "p50_ms": 1.0, "p99_ms": 1.0} for c in cs.SERVE_LOADS}}
    report = cs.engine_serve_phase("cpu", "cpu", static, model=tiny, device="cpu", timeout=120)
    assert cs.FAILED == []
    assert set(report["loads"]) == set(cs.SERVE_LOADS)
    for row in report["loads"].values():
        assert row["requests"] > 0 and row["tokens_per_s"] > 0 and row["pages_used_max"] > 0
    assert report["stats"]["compile_prefill"] == 1 and report["stats"]["pages_used"] == 0
    assert report["ttft"]["count"] >= 1 and report["engine"]["kv_pages:total"] > 0
    capsys.readouterr()


def test_rllib_phase_rehearsal(monkeypatch, capsys):
    """Phase (j) on the CPU at a tiny size (small filters, 2 workers x 2
    envs, the learner on the CPU): (j1) the learner against itself on the
    CPU, (j2) PPO through a cluster (the rollout workers' process checks,
    the timings, the learner-only rate, the profile), (j3) IMPALA and APPO,
    then the process scan after shutdown.  On the CPU the profile holds no
    device kernel, so exactly that check fails."""
    cs = _chip_smoke(monkeypatch)
    small = {"conv_filters": ((16, 8, 4), (32, 4, 2))}
    j1 = cs.rllib_learner_phase("cpu", device="cpu", model=small, rows=cs.RL_CHECK_MINIBATCH)
    assert j1["grad_err"] == j1["param_err"] == j1["prob_err"] == 0.0
    assert cs.FAILED == []
    report = cs.rllib_phase("cpu", device="cpu", model=small, workers=2, envs=2, fragment=8, minibatch=16, iters=1,
                            async_envs=2, worker_cpus=1, cluster_cpus=4)
    ppo = report["ppo"]
    assert ppo["env_steps_per_s"] > 0 and ppo["learner_only"]["env_steps_per_s"] > 0
    assert {"rollout_s", "transfer_s", "h2d_s", "learn_s"} <= set(ppo["mean_s"])
    assert 0 < ppo["profile"]["traced_ms"]
    assert report["async"]["IMPALA"]["updates"] >= cs.RL_ASYNC_ITERS * cs.RL_ASYNC_BATCHES
    assert cs.FAILED == ["rllib (j2) profile holds device kernels"], cs.FAILED
    out = capsys.readouterr().out
    assert "rllib (j2) rollout worker pid" in out and "rllib (j3) APPO" in out


def test_offpolicy_phase_rehearsal(monkeypatch, capsys):
    """Phase (k) on the CPU at a tiny size (narrow MLPs, small filters, 2
    workers x 2 envs, the learner on the CPU): (k1) each learner against
    itself on the CPU, (k2) the SAC loop with its profile, (k3) SAC, TD3,
    DDPG and DQN through a cluster, then the process scan after shutdown.
    On the CPU the profile holds no device kernel, so exactly that check
    fails."""
    cs = _chip_smoke(monkeypatch)
    small = {"conv_filters": ((16, 8, 4), (32, 4, 2))}
    tiny = ((3,), 1, (16, 16), 16)
    k1 = cs.offpolicy_learner_phase("cpu", device="cpu", sac=tiny, td3=tiny, dqn_batch=8, dqn_model=small)
    assert all(r["metric_err"] == r["param_err"] == 0.0 for r in k1.values())
    assert cs.FAILED == []
    k2 = cs.sac_bench_phase("cpu", device="cpu", iters=5, profile_iters=2, alone=3, sac=tiny)
    assert k2["env_steps_per_s"] > 0 and k2["updates_per_s"] > 0 and k2["alpha"] > 0
    assert cs.FAILED == ["offpolicy (k2) profile holds device kernels"], cs.FAILED
    k3 = cs.offpolicy_cluster_phase("cpu", device="cpu", envs=2, fragment=8, iters=2, updates=2, hidden=(16, 16),
                                    dqn_model=small, worker_cpus=1, cluster_cpus=4)
    assert {name: r["updates"] for name, r in k3.items()} == {"SAC": 4, "TD3": 4, "DDPG": 4, "DQN": 4}
    assert cs.FAILED == ["offpolicy (k2) profile holds device kernels"], cs.FAILED
    out = capsys.readouterr().out
    assert "offpolicy (k3) DQN rollout worker pid" in out and "offpolicy (k1) TD3" in out
