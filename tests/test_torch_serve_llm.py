"""ray_tpu_torch's LLM serving on the CPU against the JAX package's.

The cases of tests/test_serve_llm.py that run on one device: the port's
`ShardedLLM.generate` (fused and split) returns the JAX `ShardedLLM`'s
greedy tokens on the same weights (carried across by
`llama_params_from_jax`), its "cheap" init fills the JAX values, and
`llm_deployment(..., num_gpus=0, device="cpu")` through `serve.run` returns
the direct path's tokens.  Traced requests leave TTFT and TPOT in
`summarize_workloads("serve")`.  Sharding over several devices (tp > 1) and
the continuous-batching engine are not ported and raise.

Configs are `tiny` at f32 compute, where both packages do the same
arithmetic: tokens must be equal token for token.  Every cluster call
carries a timeout and every cluster is shut down.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import LlamaModel as JaxLlamaModel
from ray_tpu.serve.llm import ShardedLLM as JaxShardedLLM
from ray_tpu_torch import serve
from ray_tpu_torch._private.slo import parse_specs
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.serve import llm as llm_mod
from ray_tpu_torch.serve.llm import ShardedLLM

PROMPTS = np.array([[5, 7, 9], [3, 2, 1]], np.int32)


@pytest.fixture(scope="module")
def jax_weights():
    cfg = JaxLlamaConfig.tiny(compute_dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, JaxLlamaModel(cfg).init(jax.random.PRNGKey(0)))


@pytest.fixture
def cluster():
    info = rt.init(num_cpus=4)
    try:
        yield info
    finally:
        rt.shutdown()


def _cfg(**kw):
    return LlamaConfig.tiny(compute_dtype=torch.float32, **kw)


def test_generate_matches_jax_sharded_llm(jax_weights):
    jcfg, params = jax_weights
    want = JaxShardedLLM(jcfg, tp=1, init=params).generate(PROMPTS, 6)
    eng = ShardedLLM(_cfg(), init=llama_params_from_jax(params), device="cpu")
    stages = []
    fused = eng.generate(PROMPTS, 6)
    split = eng.generate(PROMPTS, 6, stage_cb=stages.append)
    assert fused.shape == (2, 6) and fused.dtype == np.int32
    assert fused.tolist() == want.tolist()
    assert split.tolist() == want.tolist()
    assert stages == ["serve_prefill_start", "serve_first_token", "serve_decode_end"]


def test_cheap_init_matches_jax(jax_weights):
    jcfg, _ = jax_weights
    jeng = JaxShardedLLM(jcfg, tp=1, init="cheap")
    eng = ShardedLLM(_cfg(), init="cheap", device="cpu")
    want = llama_params_from_jax(jax.tree.map(np.asarray, jeng.params))
    for name, p in eng.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    toks = eng.generate(np.array([[1, 2, 3]], np.int32), 4)
    assert toks.tolist() == jeng.generate(np.array([[1, 2, 3]], np.int32), 4).tolist()


def test_param_count_and_shard_stats():
    eng = ShardedLLM(_cfg(), device="cpu")
    assert eng.param_count() == eng.cfg.num_params()
    st = eng.shard_stats()
    assert st["total_bytes"] == 4 * eng.cfg.num_params()
    assert st["per_device_bytes"] == {"cpu": st["total_bytes"]}
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(np.zeros((1, 60), np.int32), 8)


def test_not_ported_paths_raise():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ShardedLLM(_cfg(), tp=2, device="cpu")
    with pytest.raises(ValueError, match="The serve fleet plane: scale_on_slo and the fleet directives"):
        parse_specs([{"name": "ttft", "kind": "latency", "metric": "m", "threshold_ms": 1, "scale_on_slo": "llm"}])
    with pytest.raises(ValueError):
        ShardedLLM(_cfg(), init="zeros", device="cpu")


def test_resolve_cfg_and_prompt_spec():
    cfg = llm_mod._resolve_cfg("llama2_7b", None)
    assert (cfg.dim, cfg.n_layers, cfg.max_seq_len, cfg.param_dtype) == (4096, 32, 256, torch.bfloat16)
    assert llm_mod._resolve_cfg(_cfg(), 32).max_seq_len == 32
    assert llm_mod._parse_prompt_spec(300, 256, 4) == ([44], 4, None)
    assert llm_mod._parse_prompt_spec({"prompt": [1, 2], "max_new_tokens": 3, "eos_token": 7}, 256, 4) == ([1, 2], 3, 7)


def test_batched_generation_deployment(cluster):
    """tests/test_serve_llm.py::test_llama_generation_deployment: a
    @serve.batch method decodes the coalesced batch with the port's model."""

    @serve.deployment(name="llm")
    class LlamaService:
        def __init__(self):
            from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

            self.cfg = LlamaConfig.tiny(compute_dtype=torch.float32)
            self.model = LlamaModel(self.cfg, device="cpu")

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        async def generate(self, prompts):
            B = len(prompts)
            cache = self.model.init_cache(B)
            token = torch.tensor([[p % self.cfg.vocab_size] for p in prompts])
            outs = [[] for _ in range(B)]
            with torch.no_grad():
                for t in range(6):
                    logits, cache = self.model.decode_step(cache, token, t)
                    token = logits.argmax(-1, keepdim=True)
                    for b in range(B):
                        outs[b].append(int(token[b, 0]))
            return outs

        async def __call__(self, prompt_token):
            return await self.generate(prompt_token)

    handle = serve.run(LlamaService.bind())
    results = rt.get([handle.remote(i) for i in range(4)], timeout=300)
    assert len(results) == 4
    assert all(len(seq) == 6 and all(isinstance(t, int) for t in seq) for seq in results)


def test_llm_deployment_through_serve(cluster, jax_weights):
    """handle → controller → replica → @serve.batch → ShardedLLM on the CPU,
    token-equal to the direct path and to the JAX ShardedLLM on the same
    weights; traced requests leave TTFT/TPOT in the serve summary."""
    from ray_tpu_torch.experimental.state import summarize_workloads

    jcfg, params = jax_weights
    init = llama_params_from_jax(params)
    dep = llm_mod.llm_deployment(_cfg(), max_seq_len=32, new_tokens=4, max_batch_size=4, num_gpus=0,
                                 tp=1, device="cpu", init=init)
    handle = serve.run(dep.bind())
    prompts = [3, 17, 200]
    served = rt.get([handle.remote(p) for p in prompts], timeout=300)
    direct = ShardedLLM(_cfg(max_seq_len=32), init=init, device="cpu").generate(np.array([[p] for p in prompts], np.int32), 4)
    want = JaxShardedLLM(jcfg, tp=1, init=params).generate(np.array([[p] for p in prompts], np.int32), 4)
    assert served == direct.tolist() == want.tolist()
    info = rt.get(serve.get_deployment_handle("llm").method("info").remote(), timeout=60)
    assert info["tp"] == 1 and info["platform"] == "cpu" and info["shards"]["total_bytes"] > 0

    # records ship batched from the replica: a later request flushes the
    # tail; poll the head until the deployment's TTFT/TPOT show
    deadline = time.time() + 60
    summary = {}
    while time.time() < deadline:
        summary = summarize_workloads("serve", limit=20)
        if summary.get("total_records", 0) >= 3 and "llm" in summary.get("tpot", {}):
            break
        time.sleep(0.3)
        rt.get(handle.remote(1), timeout=60)
    assert summary["ttft"]["llm"]["count"] >= 1, summary
    assert summary["tpot"]["llm"]["count"] >= 1, summary
    stages = {row["stage"] for row in summary["summary"] if row["deployment"] == "llm"}
    assert {"serve_prefill", "serve_decode", "serve_queue_wait", "serve_e2e"} <= stages
    rec = [r for r in summary["records"] if r["name"] == "serve:llm"][0]
    assert 0.0 <= rec["ttft_s"] < rec["durations"]["serve_e2e"]
