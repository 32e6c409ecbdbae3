"""ray_tpu_torch's continuous-batching engine on the CPU, against the JAX
package's.

- The paged programs (`init_pages`, `prefill_chunk_paged`,
  `decode_step_paged`) against the JAX model's on the same weights
  (carried across by `llama_params_from_jax`), in the MHA form and in a
  GQA form: page tables with -1 entries, an inactive slot, padded tail
  chunks.  Next tokens must be equal; the pools within 1e-5 absolute (both
  compute in float32; the frameworks sum in other orders, measured up to
  1.2e-7).
- The port's engine on a mixed-length fleet gives the JAX engine's tokens
  and the port's static `generate`'s, with one input shape per program.
- The cases of tests/test_serve_engine.py, run on the port: allocator,
  cache, scheduler, stream state and hub, eos, pool pressure, typed
  overload, defrag in flight, tracing stamps; then on a tiny cluster
  (`engine_llm_deployment(..., num_gpus=0, device="cpu")`) buffered and
  mixed calls, ordered incremental `stream_tokens`, the pull fallback,
  abandonment freeing the slot, TTFT and the engine gauges in
  `summarize_workloads`, a replica killed mid-stream, and proxy SSE with
  503 shedding.

Configs are `tiny` in float32.  Every cluster call carries a timeout and
the cluster is shut down.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import LlamaModel as JaxLlamaModel
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import EngineOverloadedError, EngineStreamError
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.serve import llm as llm_mod
from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.serve.llm import ShardedLLM

pytestmark = pytest.mark.serve_engine

POOL_TOL = 1e-5
MIXED = [[5, 7, 9], [3], list(range(1, 12)), [4, 4], [9, 8, 7, 6, 5, 4, 3], [200]]


def _jax_params(n_kv_heads=2):
    cfg = dataclasses.replace(JaxLlamaConfig.tiny(compute_dtype=jnp.float32), n_kv_heads=n_kv_heads)
    return cfg, jax.tree.map(np.asarray, JaxLlamaModel(cfg).init(jax.random.PRNGKey(0)))


def _cfg(**kw):
    return LlamaConfig.tiny(compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def jax_weights():
    return _jax_params()


@pytest.fixture(scope="module")
def tiny_llm(jax_weights):
    return ShardedLLM(_cfg(), init=llama_params_from_jax(jax_weights[1]), device="cpu")


# ------------------------------------------------------- paged programs


@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_paged_programs_match_jax(n_kv_heads):
    jcfg, params = _jax_params(n_kv_heads)
    jm = JaxLlamaModel(jcfg)
    tm = LlamaModel(dataclasses.replace(_cfg(), n_kv_heads=n_kv_heads), device="cpu")
    tm.load_state_dict(llama_params_from_jax(params))
    NP, PS, C = 12, 4, 4
    # slot 0 holds 3 pages, slot 1 two, slot 2 four; -1 marks the rest
    tables = np.array([[5, 2, 9, -1], [0, 7, -1, -1], [1, 3, 4, 6]], np.int32)
    jpages, tpages = jm.init_pages(NP, PS), tm.init_pages(NP, PS)
    rng = np.random.default_rng(0)
    for slot, plen in ((0, 7), (1, 3), (2, 5)):  # every prompt ends in a padded chunk
        prompt = rng.integers(0, jcfg.vocab_size, plen)
        for start in range(0, plen, C):
            n = min(C, plen - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = prompt[start : start + n]
            jt, jpages = jm.prefill_chunk_paged(params, jpages, tables[slot], chunk, np.int32(start), np.int32(n), PS)
            tt, tpages = tm.prefill_chunk_paged(tpages, tables[slot], chunk, start, n, PS)
            assert int(tt) == int(jt), (slot, start)
    tokens = np.array([3, 9, 11], np.int32)
    positions = np.array([7, 3, 5], np.int32)
    active = np.array([True, True, False])  # slot 2 sits out: its row is written nowhere
    for _ in range(5):
        jt, jpages = jm.decode_step_paged(params, jpages, tables, tokens, positions, active, PS)
        tt, tpages = tm.decode_step_paged(tpages, tables, tokens, positions, active, PS)
        np.testing.assert_array_equal(tt.numpy()[active], np.asarray(jt)[active])
        tokens, positions = np.asarray(jt).astype(np.int32), positions + 1
    for jp, tp in zip(jpages, tpages):
        assert tp.shape == jp.shape
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=POOL_TOL)


def test_paged_write_drops_unallocated_and_inactive_rows():
    """Rows the reference's scatter drops (an inactive slot, a position
    whose page is unallocated, a chunk's padding) leave the pool as it
    was, and the pool keeps its shape: no spare page."""
    m = LlamaModel(_cfg(), device="cpu")
    kp, vp = m.init_pages(6, 4)
    kp.fill_(7.0)
    vp.fill_(7.0)
    tables = np.array([[0, -1], [1, 2]], np.int32)
    # slot 0 writes position 5: its logical page 1 is unallocated; slot 1 is inactive
    m.decode_step_paged((kp, vp), tables, [1, 2], [5, 0], [True, False], 4)
    assert (kp == 7.0).all() and (vp == 7.0).all() and kp.shape == (2, 6, 4, 2, 16)
    # a chunk of 4 with one valid token writes exactly one row per layer
    m.prefill_chunk_paged((kp, vp), tables[1], np.array([3, 0, 0, 0], np.int32), 0, 1, 4)
    assert int((kp != 7.0).any(-1).any(-1).sum()) == 2  # layer 0 and 1, page 1 offset 0
    assert (kp[:, 1, 0] != 7.0).any() and (kp[:, 1, 1:] == 7.0).all() and (kp[:, 2] == 7.0).all()


# ------------------------------------------------- engine against JAX's


def test_engine_mixed_lengths_match_jax_engine_and_static_path(jax_weights, tiny_llm):
    from ray_tpu.serve.engine import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.engine import InferenceEngine as JaxInferenceEngine
    from ray_tpu.serve.llm import ShardedLLM as JaxShardedLLM

    jcfg, params = jax_weights
    kw = dict(num_slots=4, page_size=4, max_seq_len=48, prefill_chunk=4, max_new_tokens=6)
    jeng = JaxInferenceEngine(JaxShardedLLM(jcfg, tp=1, init=params), JaxEngineConfig(**kw), deployment="t")
    try:
        want = [r.sink.result(timeout=300) for r in [jeng.submit(p, 6) for p in MIXED]]
    finally:
        jeng.shutdown()
    eng = InferenceEngine(tiny_llm, EngineConfig(**kw), deployment="t")
    try:
        got = [r.sink.result(timeout=120) for r in [eng.submit(p, 6) for p in MIXED]]
        assert eng.compile_stats() == {"prefill": 1, "decode": 1}
    finally:
        eng.shutdown()
    assert got == want
    for p, o in zip(MIXED, got):
        assert o == tiny_llm.generate(np.asarray([p], np.int32), 6)[0].tolist()


# --------------------------------------------------------- page allocator


def test_page_allocator_alloc_free_reuse():
    from ray_tpu_torch.serve.engine import PageAllocator

    a = PageAllocator(num_pages=8, page_size=4)
    p1 = a.alloc(3)
    assert p1 == [0, 1, 2]  # lowest-first keeps the pool dense
    p2 = a.alloc(5)
    assert sorted(p2) == [3, 4, 5, 6, 7]
    assert a.alloc(1) is None  # exhausted: None, never an exception
    a.free(p1)
    assert a.available == 3
    p3 = a.alloc(2)
    assert set(p3) <= set(p1)  # freed pages are reused
    assert a.pages_for(9) == 3 and a.pages_for(1) == 1


def test_page_allocator_guards():
    from ray_tpu_torch.serve.engine import PageAllocator

    a = PageAllocator(num_pages=4, page_size=4)
    pages = a.alloc(2)
    a.free(pages)
    with pytest.raises(ValueError):
        a.free(pages)  # double free
    with pytest.raises(ValueError):
        a.free([99])  # outside the pool


def test_page_allocator_fragmentation_and_compaction():
    from ray_tpu_torch.serve.engine import PageAllocator

    a = PageAllocator(num_pages=8, page_size=4)
    held = [a.alloc(2) for _ in range(4)]  # pages 0..7
    assert a.fragmentation() == 0.0
    a.free(held[0])  # free 0,1
    a.free(held[2])  # free 4,5 -> two separate runs
    assert a.fragmentation() > 0.0
    allocated = held[1] + held[3]  # 2,3,6,7
    moves = a.compaction_plan(allocated)
    # plan relocates the allocated set onto ids 0..3
    assert sorted({d for _, d in moves} | (set(allocated) - {s for s, _ in moves})) == [0, 1, 2, 3]
    a.apply_compaction(4)
    assert a.fragmentation() == 0.0
    assert a.available == 4


def test_paged_cache_reserve_release():
    from ray_tpu_torch.serve.engine import PagedKVCache

    c = PagedKVCache(num_slots=2, pages_per_slot=4, num_pages=6, page_size=4)
    assert c.reserve(0, 16)  # 4 pages
    assert not c.reserve(1, 12)  # 3 pages > 2 left: admission must wait
    assert c.reserve(1, 8)  # 2 pages fit
    assert (c.tables[0] >= 0).all()
    c.release(0)
    assert (c.tables[0] == -1).all()
    assert c.reserve(1, 16)  # grows in place after the release
    with pytest.raises(ValueError):
        c.reserve(1, 999)  # beyond the slot's logical span: a bug, not pressure


# ------------------------------------------------------------- scheduler


def _sched(slots=2, pages=8, page_size=4, max_queue=4):
    from ray_tpu_torch.serve.engine import EngineScheduler, PagedKVCache

    cache = PagedKVCache(slots, 4, pages, page_size)
    return EngineScheduler(cache, max_queue=max_queue, prefill_chunk=2)


def test_scheduler_admit_retire_recycles_slots():
    s = _sched()
    r1 = s.submit([1, 2, 3], 4)
    r2 = s.submit([5], 4)
    r3 = s.submit([7, 8], 4)
    assert [r.rid for r in s.admit()] == [r1.rid, r2.rid]  # FCFS, 2 slots
    assert s.admit() == []  # no free slot for r3
    req, start, toks = s.next_prefill()
    assert req is r1 and start == 0 and toks == [1, 2]
    assert not s.note_prefill(r1, 2)
    req, start, toks = s.next_prefill()
    assert req is r1 and start == 2 and toks == [3]
    assert s.note_prefill(r1, 1)  # prompt resident
    s.retire(r1)
    assert r1.done and r1.slot == -1
    assert [r.rid for r in s.admit()] == [r3.rid]


def test_scheduler_eos_and_budget_retirement():
    s = _sched()
    r = s.submit([1], 3, eos_token=42)
    s.admit()
    assert not s.note_token(r, 7)
    assert s.note_token(r, 42)  # EOS retires before the budget
    assert r.out == [7, 42]
    r2 = s.submit([1], 2)
    s.admit()
    assert not s.note_token(r2, 1)
    assert s.note_token(r2, 1)  # budget retires


def test_scheduler_admission_blocked_not_crashed_on_page_pressure():
    s = _sched(slots=2, pages=2, page_size=4)  # pool covers ONE 2+4-token request
    r1 = s.submit([1, 2], 4)
    r2 = s.submit([3, 4], 4)
    assert [r.rid for r in s.admit()] == [r1.rid]  # r2 blocked on pages
    assert s.queue and s.queue[0] is r2
    s.retire(r1)
    assert [r.rid for r in s.admit()] == [r2.rid]  # unblocked by recycling


def test_scheduler_bounded_queue_overload():
    s = _sched(max_queue=2)
    s.submit([1], 2)
    s.submit([1], 2)
    with pytest.raises(EngineOverloadedError) as ei:
        s.submit([1], 2)
    assert ei.value.retry_after_s > 0
    with pytest.raises(ValueError):
        s.submit(list(range(100)), 100)  # beyond per-sequence capacity


# ------------------------------------------------------ stream transport


def test_stream_state_backpressure_sever_is_typed_on_pull_path():
    from ray_tpu_torch.serve.engine.transport import StreamState

    st = StreamState(sid=1, outbox_limit=3)
    for i in range(3):
        st.emit({"t": [i], "done": False, "error": None})
    st.emit({"t": [99], "done": False, "error": None})  # over the bound: sever
    assert st.closed
    frames, done = st.pull(max_frames=16, timeout=1.0)
    assert done
    assert [f for f in frames if f.get("error")], "sever must surface as an error frame"


def test_stream_hub_create_reaps_severed_streams():
    from ray_tpu_torch.serve.engine import transport

    h = transport.StreamHub()
    st = h.create(outbox_limit=1)
    st.fail("test sever")
    st2 = h.create()
    assert h.get(st.sid) is None  # severed stream reaped on next create
    assert h.get(st2.sid) is st2


# ------------------------------------------------- engine loop (in-process)


def _engine(llm, **kw):
    kw = {"num_slots": 2, "page_size": 4, "max_seq_len": 32, "prefill_chunk": 4, **kw}
    return InferenceEngine(llm, EngineConfig(**kw), deployment="t")


def test_engine_second_wave_reuses_programs(tiny_llm):
    eng = _engine(tiny_llm, num_slots=4, max_seq_len=48, max_new_tokens=6)
    try:
        for r in [eng.submit(p, 6) for p in MIXED[:4]]:
            r.sink.result(timeout=60)
        assert len(eng.submit([9, 8, 7], 4).sink.result(timeout=60)) == 4
        assert eng.compile_stats() == {"prefill": 1, "decode": 1}
    finally:
        eng.shutdown()


def test_engine_eos_truncates(tiny_llm):
    eng = _engine(tiny_llm)
    try:
        full = eng.submit([5, 7, 9], 6).sink.result(timeout=60)
        out = eng.submit([5, 7, 9], 6, eos_token=full[1]).sink.result(timeout=60)
        assert out == full[:2]  # stops AT the eos token
    finally:
        eng.shutdown()


def test_engine_admission_blocks_on_pool_pressure_then_completes(tiny_llm):
    eng = _engine(tiny_llm, num_slots=4, max_seq_len=16, num_pages=4, max_new_tokens=4)
    try:
        # the pool holds about 2 sequences; 6 requests finish by waiting
        # for recycled pages: blocked, never crashed
        outs = [r.sink.result(timeout=60) for r in [eng.submit([i + 1, i + 2], 4) for i in range(6)]]
        assert all(len(o) == 4 for o in outs)
        st = eng.stats()
        assert st["requests_done"] == 6.0 and st["requests_failed"] == 0.0
        assert st["pages_used"] == 0.0  # everything recycled
    finally:
        eng.shutdown()


def test_engine_overload_is_typed_and_immediate(tiny_llm):
    eng = _engine(tiny_llm, num_slots=1, max_seq_len=16, num_pages=1, max_new_tokens=4, max_queue=2)
    try:
        with pytest.raises(EngineOverloadedError):
            for _ in range(30):
                eng.submit([1, 2], 4)
    finally:
        eng.shutdown()


def test_engine_defrag_mid_flight_preserves_decode(tiny_llm):
    """Retiring interleaved sequences fragments the pool; compaction moves
    live pages (in place, on the engine thread) without corrupting the
    context of a sequence still decoding."""
    eng = _engine(tiny_llm, num_slots=3, max_new_tokens=16)
    try:
        ref = tiny_llm.generate(np.asarray([[5, 7, 9]], np.int32), 16)[0].tolist()
        long_req = eng.submit([5, 7, 9], 16)
        for r in [eng.submit([i + 1], 2) for i in range(2)]:
            r.sink.result(timeout=60)  # retire -> holes in the pool
        eng.defrag()
        assert long_req.sink.result(timeout=60) == ref
    finally:
        eng.shutdown()


def test_engine_update_weights_between_iterations(jax_weights):
    """A state dict staged with update_weights is what the next requests
    decode with: the tokens of a fresh ShardedLLM holding those weights."""
    other = llama_params_from_jax(jax.tree.map(np.asarray, JaxLlamaModel(jax_weights[0]).init(jax.random.PRNGKey(1))))
    llm = ShardedLLM(_cfg(), init=llama_params_from_jax(jax_weights[1]), device="cpu")
    eng = _engine(llm)
    try:
        before = eng.submit([5, 7, 9], 6).sink.result(timeout=60)
        with pytest.raises(ValueError):
            eng.update_weights({"tok_emb": other["tok_emb"]})  # not the model's full state
        eng.update_weights({n: t.numpy() for n, t in other.items()})
        after = eng.submit([5, 7, 9], 6).sink.result(timeout=60)
        assert eng.weight_updates == 1
    finally:
        eng.shutdown()
    want = ShardedLLM(_cfg(), init=other, device="cpu").generate(np.asarray([[5, 7, 9]], np.int32), 6)[0].tolist()
    assert after == want and before != after


def test_engine_no_stamps_when_events_disabled(tiny_llm):
    from ray_tpu_torch._private import task_events
    from ray_tpu_torch.serve import tracing as serve_tracing

    old = task_events.enabled
    task_events.set_enabled(False)
    try:
        assert serve_tracing.new_request("x") is None
        eng = _engine(tiny_llm, max_seq_len=16)
        try:
            req = eng.submit([1, 2], 3, trace=serve_tracing.new_request("x"))
            assert req.trace is None
            assert len(req.sink.result(timeout=60)) == 3
            assert not serve_tracing._buf  # nothing buffered for shipping
        finally:
            eng.shutdown()
    finally:
        task_events.set_enabled(old)


def test_engine_tracing_stamps_and_single_seal(tiny_llm):
    from ray_tpu_torch._private import task_events
    from ray_tpu_torch.serve import tracing as serve_tracing

    old = task_events.enabled
    task_events.set_enabled(True)
    shipped = []
    orig_ship = serve_tracing._ship
    serve_tracing._ship = lambda batch: shipped.extend(batch)
    eng = _engine(tiny_llm, max_seq_len=16)
    try:
        trace = serve_tracing.new_request("t")
        eng.submit([1, 2, 3], 4, trace=trace).sink.result(timeout=60)
        serve_tracing.finish_request(trace, error=False)  # the handler's finally: deferred, no seal
        serve_tracing.flush()
        assert len(shipped) == 1  # exactly one seal
        rec = shipped[0]
        ph = rec["phases"]
        for stage in ("serve_engine_submit", "serve_engine_admit", "serve_prefill_start", "serve_first_token",
                      "serve_decode_end"):
            assert stage in ph, stage
        assert ph["serve_engine_submit"] <= ph["serve_engine_admit"] <= ph["serve_first_token"]
        assert rec["ttft_s"] is not None and rec["tpot_s"] is not None
        assert rec["tokens"] == 4
        assert not any(k.startswith("_") for k in rec)
    finally:
        serve_tracing._ship = orig_ship
        eng.shutdown()
        task_events.set_enabled(old)


def test_engine_refuses_a_missing_card():
    """No fallback: a ShardedLLM asked for CUDA without CUDA raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ShardedLLM(_cfg())


# --------------------------------------------------------- serve e2e paths


def _deploy(name, cfg, **kw):
    dep = llm_mod.engine_llm_deployment(cfg, num_gpus=0, device="cpu", name=name, **kw)
    return serve.run(dep.bind())


@pytest.fixture(scope="module")
def engine_cluster():
    rt.init(num_cpus=4)
    try:
        handle = _deploy("llm", _cfg(max_seq_len=64), new_tokens=6, num_slots=4, page_size=4, prefill_chunk=4, max_queue=8)
        rt.get(handle.remote(5), timeout=120)
        yield handle
        serve.shutdown()
    finally:
        rt.shutdown()


def _stats():
    return rt.get(serve.get_deployment_handle("llm").method("engine_stats").remote(), timeout=60)


def test_engine_deployment_buffered_and_mixed(engine_cluster):
    handle = engine_cluster
    assert len(rt.get(handle.remote(5), timeout=60)) == 6
    refs = [handle.remote({"prompt": list(range(1, n + 1)), "max_new_tokens": 5}) for n in (1, 3, 9, 2)]
    assert all(len(o) == 5 for o in rt.get(refs, timeout=120))
    stats = _stats()
    assert stats["compile_prefill"] == 1.0 and stats["compile_decode"] == 1.0


def test_stream_tokens_incremental_and_ordered(engine_cluster):
    handle = engine_cluster
    frames = list(handle.stream_tokens({"prompt": [1, 2, 3], "max_new_tokens": 8}, timeout=60))
    toks = [t for fr in frames for t in fr]
    assert len(toks) == 8
    assert len(frames) >= 2  # tokens arrived as several frames, not one blob
    assert rt.get(handle.remote({"prompt": [1, 2, 3], "max_new_tokens": 8}), timeout=60) == toks


def test_stream_tokens_pull_fallback(engine_cluster, monkeypatch):
    """With the direct transport unavailable the same stream flows over
    the actor-call pull path."""
    from ray_tpu_torch.serve.engine import transport

    def _no_transport(*a, **k):
        raise EngineStreamError("transport disabled for test")

    monkeypatch.setattr(transport, "open_token_stream", _no_transport)
    frames = list(engine_cluster.stream_tokens({"prompt": [2, 4], "max_new_tokens": 5}, timeout=60))
    assert [t for fr in frames for t in fr] == rt.get(
        engine_cluster.remote({"prompt": [2, 4], "max_new_tokens": 5}), timeout=60
    )


def test_stream_abandon_releases_engine_slot(engine_cluster):
    it = engine_cluster.stream_tokens({"prompt": [1, 2], "max_new_tokens": 6}, timeout=60)
    next(it)  # first frame only
    it.close()  # abandon mid-stream
    deadline = time.time() + 30
    while time.time() < deadline and _stats()["slots_active"] != 0.0:
        time.sleep(0.2)
    assert _stats()["slots_active"] == 0.0


def test_summary_serve_reports_ttft_and_engine_gauges(engine_cluster):
    from ray_tpu_torch.experimental.state import summarize_workloads

    rt.get(engine_cluster.remote({"prompt": [3, 1], "max_new_tokens": 4}), timeout=60)
    deadline = time.time() + 30
    s = {}
    while time.time() < deadline:
        s = summarize_workloads("serve")
        if s.get("ttft", {}).get("llm") and "llm" in (s.get("engine") or {}):
            break
        time.sleep(0.5)
    assert s.get("ttft", {}).get("llm"), "TTFT percentiles missing from summary serve"
    eng = s["engine"]["llm"]
    assert eng.get("kv_pages:total", 0) > 0 and "slots:total" in eng
    assert "llm" in (summarize_workloads("memory").get("serve_engine") or {})


@pytest.mark.chaos
def test_replica_kill_mid_stream_typed_error_or_failover(engine_cluster):
    """A replica killed mid-stream surfaces EngineStreamError at the
    consumer, typed and prompt, or the stream fails over to a survivor and
    finishes with the tokens of an uninterrupted run: never a hang."""
    handle = _deploy("llm_kill", _cfg(max_seq_len=512), new_tokens=256, num_slots=2, page_size=16, prefill_chunk=16)
    try:
        _, replica = handle._pick_replica()
        it = handle.stream_tokens({"prompt": [1, 2, 3], "max_new_tokens": 256}, timeout=60)
        got = list(next(it))
        assert got
        rt.kill(replica)
        deadline = time.time() + 60
        try:
            for frame in it:
                got += frame
                assert time.time() < deadline, "stream neither failed nor finished"
        except EngineStreamError:
            return
        want = rt.get(handle.remote({"prompt": [1, 2, 3], "max_new_tokens": 256}), timeout=120)
        assert got == want
    finally:
        serve.delete("llm_kill")


def test_proxy_sse_streams_and_503_sheds(engine_cluster):
    """HTTP: SSE token frames then the done event, the tokens of the
    buffered call; a full admission queue answers 503 with Retry-After."""
    handle = _deploy("llm_http", _cfg(max_seq_len=512), new_tokens=8, num_slots=1, page_size=16, prefill_chunk=16,
                     max_queue=1)
    url = serve.start_http_proxy(0)
    try:
        rt.get(handle.remote(1), timeout=60)
        body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 6}).encode()
        req = urllib.request.Request(f"{url}/llm_http?stream=sse", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            text = r.read().decode()
        frames = [line for line in text.splitlines() if line.startswith('data: {"t"')]
        toks = [t for line in frames for t in json.loads(line[len("data: "):])["t"]]
        assert toks == rt.get(handle.remote({"prompt": [1, 2, 3], "max_new_tokens": 6}), timeout=60)
        assert "event: done" in text

        # a long request into the one slot, then one into the 1-deep queue
        # (each sent once the engine reports the last one placed: two sent
        # together could both land in the queue), then expect a 503 at once
        stats = serve.get_deployment_handle("llm_http").method("engine_stats")
        refs = []
        for want_queued in (0, 1):
            refs.append(handle.remote({"prompt": [1, 2], "max_new_tokens": 500}))
            deadline = time.time() + 60
            while time.time() < deadline:
                st = rt.get(stats.remote(), timeout=30)
                if st["slots_active"] == 1 and st["queue_depth"] == want_queued:
                    break
                time.sleep(0.05)
            assert st["slots_active"] == 1 and st["queue_depth"] == want_queued, st
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                urllib.request.Request(f"{url}/llm_http", data=json.dumps({"prompt": [5], "max_new_tokens": 4}).encode(),
                                       headers={"Content-Type": "application/json"}),
                timeout=30,
            )
        assert err.value.code == 503 and int(err.value.headers["Retry-After"]) >= 1
        # the long requests are left to serve.delete, which kills the replica
    finally:
        serve.delete("llm_http")
