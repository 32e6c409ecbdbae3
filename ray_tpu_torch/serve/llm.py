"""LLM serving on one GPU: `ShardedLLM` and the `llm_deployment` and
`engine_llm_deployment` factories.

Port of `ray_tpu/serve/llm.py`.  A static replica hosts one
`ShardedLLM`: a Llama model (`models/llama.py`) on one CUDA device and a
greedy generator over a contiguous [L, B, S, KV, D] KV cache.  `generate`
prefills with the teacher-forced loop of `decode_step` over the prompt
positions (the JAX package's `lax.scan` of `decode_step`), then decodes
greedily; the cache is allocated once per call and written in place.
`engine_llm_deployment` hosts the continuous-batching engine instead
(`serve/engine/`), over `ShardedLLM.engine_programs`: the model's paged
programs on its device.

tp > 1 (weights and cache sharded over several cards) waits for the
multi-GPU slice of the port and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

__all__ = ["ShardedLLM", "llm_deployment", "engine_llm_deployment"]

_MULTI_GPU = "ROADMAP, Queue 1: multi-GPU"


def _resolve_cfg(model, max_seq_len):
    """LlamaConfig from a constructor name or an instance (worker-side —
    shared by the static and engine deployment factories).  Named configs
    keep their weights in bf16."""
    if isinstance(model, LlamaConfig):
        return model if max_seq_len is None else dataclasses.replace(model, max_seq_len=max_seq_len)
    return getattr(LlamaConfig, model)(max_seq_len=max_seq_len or 256, param_dtype=torch.bfloat16)


def _parse_prompt_spec(spec, vocab_size: int, default_new: int):
    """Normalize the three accepted request shapes into
    (prompt_ids, max_new_tokens, eos_token):

    - int seed       -> one-token prompt (the static path's wire shape)
    - [ids...]       -> explicit prompt
    - {"prompt": int|[ids...], "max_new_tokens": n, "eos_token": t}
    """
    max_new, eos = default_new, None
    if isinstance(spec, dict):
        max_new = int(spec.get("max_new_tokens") or default_new)
        eos = spec.get("eos_token")
        eos = None if eos is None else int(eos)
        spec = spec.get("prompt", 0)
    if isinstance(spec, (list, tuple)):
        ids = [int(t) % vocab_size for t in spec]
    else:
        ids = [int(spec) % vocab_size]
    return ids, max_new, eos


@torch.no_grad()
def _cheap_fill(name: str, p: torch.Tensor) -> None:
    """The JAX ShardedLLM's deterministic "cheap" init: norm scales 1, every
    other leaf a pattern over its last two dims (broadcast over the leading
    ones), salted by the leaf's name, computed in float64 and cast."""
    if "norm" in name:
        p.fill_(1.0)
        return
    salt = zlib.crc32(name.encode())
    j = torch.arange(p.shape[-1], dtype=torch.int64, device=p.device)
    col = ((j * 2654435761 + salt) % 1009).double() / 1009.0 - 0.5
    if p.dim() >= 2:
        i = torch.arange(p.shape[-2], dtype=torch.int64, device=p.device)
        row = ((i * 40503 + salt) % 997).double() / 997.0 - 0.5
        mat = (col[None, :] + row[:, None]) * 0.02
    else:
        mat = col * 0.02
    p.copy_(mat.expand(p.shape))


def prefill(model: LlamaModel, cache, prompts: torch.Tensor) -> torch.Tensor:
    """Teacher-forced loop of decode_step over the prompt positions
    (prompts [B, P]), writing the cache; the last position's logits."""
    for t in range(prompts.shape[1]):
        logits, cache = model.decode_step(cache, prompts[:, t : t + 1], t)
    return logits


class EngineProgram:
    """One engine program over the model: runs it in inference mode and
    records the input-shape signature of each call (the pool's shape and
    dtype, each host array's)."""

    def __init__(self, fn):
        self.fn = fn
        self.signatures = set()

    def __call__(self, pages, *args):
        sig = tuple((tuple(t.shape), str(t.dtype)) for t in pages)
        self.signatures.add(sig + tuple((np.shape(a), np.asarray(a).dtype.str) for a in args))
        with torch.inference_mode():
            return self.fn(pages, *args)

    def cache_size(self) -> int:
        """Distinct input-shape signatures seen so far."""
        return len(self.signatures)


class ShardedLLM:
    """A llama-family model on one CUDA device, ready to decode.

    device: CUDA unless the caller names the CPU (`device="cpu"`); raises
      without CUDA.
    tp: 1 (or None).  Sharding over several cards is not ported yet.
    init:
      "random" — normal(0, 0.02) weights from `seed` (serving without a
                 checkpoint)
      "cheap"  — the JAX package's deterministic pattern fill
      dict     — parameters by name (`models/convert.py`'s
                 `llama_params_from_jax`), copied onto the device
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        tp: Optional[int] = None,
        init: Any = "random",
        seed: int = 0,
        *,
        device: Optional[Device] = None,
    ):
        if tp not in (None, 1):
            raise NotImplementedError(f"tp={tp}: a model sharded over several GPUs is not ported yet ({_MULTI_GPU})")
        if not (isinstance(init, dict) or init in ("random", "cheap")):
            raise ValueError(f"unknown init {init!r}")
        self.device = resolve_device("cuda" if device is None else device)
        self.cfg = cfg
        self.tp = 1
        self.model = LlamaModel(cfg, device=self.device, seed=seed)
        if isinstance(init, dict):
            self.model.load_state_dict(init)
        elif init == "cheap":
            for name, p in self.model.named_parameters():
                _cheap_fill(name.rsplit(".", 1)[-1], p)

    # ------------------------------------------------------------------ api

    def _decode(self, cache, logits, start_pos: int, n_new: int) -> torch.Tensor:
        """Greedy decode of n_new tokens from the prefill's logits, over
        the static path's unmasked padded vocab; [B, n_new] on the device
        (no host sync inside the loop)."""
        tok = logits.argmax(-1, keepdim=True)
        out = [tok]
        for t in range(start_pos, start_pos + n_new - 1):
            logits, cache = self.model.decode_step(cache, tok, t)
            tok = logits.argmax(-1, keepdim=True)
            out.append(tok)
        return torch.cat(out, dim=1)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int, stage_cb=None) -> np.ndarray:
        """prompts [B, P] int32 → generated tokens [B, n_new] (greedy).

        ``stage_cb(phase)`` opts into the SPLIT prefill/decode pair with the
        first token a host-visible boundary: the callback fires with
        ``serve_prefill_start`` / ``serve_first_token`` /
        ``serve_decode_end`` (canonical task_events names — the serve
        tracer's stamp_batch slots straight in).  Without it prefill and
        decode run back to back with no host sync until the end."""
        prompts = np.asarray(prompts, np.int32)
        B, P_len = prompts.shape
        if P_len + n_new > self.cfg.max_seq_len:
            raise ValueError(f"prompt {P_len} + new {n_new} exceeds max_seq_len {self.cfg.max_seq_len}")
        cache = self.model.init_cache(B)
        ids = torch.from_numpy(prompts.astype(np.int64)).to(self.device)
        if stage_cb is None:
            logits = prefill(self.model, cache, ids)
            return self._decode(cache, logits, P_len, int(n_new)).cpu().numpy().astype(np.int32)
        stage_cb("serve_prefill_start")
        logits = prefill(self.model, cache, ids)
        # first token's logits resident = TTFT endpoint
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stage_cb("serve_first_token")
        toks = self._decode(cache, logits, P_len, int(n_new)).cpu().numpy()  # device→host: decode done
        stage_cb("serve_decode_end")
        return toks.astype(np.int32)

    def engine_programs(self, *, num_pages: int, page_size: int) -> Dict[str, Any]:
        """The continuous-batching engine's programs over this model on its
        device: "init" (the page pool, allocated once), "prefill" (one
        prompt chunk), "decode" (one step over every slot), "move_pages"
        (the defrag's copy).  Each writes the pool in place.  The paged
        programs are shaped by the pool's geometry only, so a mixed-length
        fleet runs each with one input shape: "prefill" and "decode" count
        the distinct input-shape signatures they see (`cache_size()`, the
        reference's jit cache size behind the engine's `compile_stats`)."""
        model = self.model

        @torch.inference_mode()
        def init():
            return model.init_pages(num_pages, page_size)

        @torch.inference_mode()
        def move_pages(pages, srcs, dsts):
            # every source page is read before any write (the right side
            # is a copy), so overlapping moves are safe
            src, dst = (torch.as_tensor(i, dtype=torch.int64).to(self.device) for i in (srcs, dsts))
            for buf in pages:
                buf[:, dst] = buf[:, src]

        return {
            "init": init,
            "prefill": EngineProgram(functools.partial(model.prefill_chunk_paged, page_size=page_size)),
            "decode": EngineProgram(functools.partial(model.decode_step_paged, page_size=page_size)),
            "move_pages": move_pages,
        }

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def shard_stats(self) -> Dict[str, Any]:
        """Total parameter bytes and resident bytes per device (one here)."""
        total = sum(p.numel() * p.element_size() for p in self.model.parameters())
        return {"total_bytes": total, "per_device_bytes": {str(self.device): total}}


def llm_deployment(
    model="llama_3b",
    *,
    max_seq_len: Optional[int] = None,
    new_tokens: int = 32,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.02,
    num_gpus: int = 1,
    tp: Optional[int] = None,
    autoscaling_config: Optional[dict] = None,
    prompt_pad: Optional[int] = None,
    device: Device = "cuda",
    init: Any = "random",
):
    """Build a Serve deployment wrapping a ShardedLLM replica.

    ``model`` is a LlamaConfig constructor name ("llama_3b", "llama2_7b",
    ...) or a LlamaConfig INSTANCE (resolved worker-side either way).  The
    replica claims ``num_gpus`` cards and runs on ``device`` there: CUDA
    unless the caller names the CPU (with ``num_gpus=0``).  ``init`` is
    ShardedLLM's: "random" (seed 0), "cheap", or a parameter dict."""
    from ray_tpu_torch import serve

    @serve.deployment(
        name="llm",
        ray_actor_options={"num_gpus": num_gpus},
        max_concurrent_queries=64,
        autoscaling_config=autoscaling_config
        or {
            "min_replicas": 1,
            "max_replicas": 1,
            "target_num_ongoing_requests_per_replica": 32,
        },
    )
    class LLMDeployment:
        def __init__(self):
            # an explicit max_seq_len overrides; otherwise the instance's
            # own value stands
            cfg = _resolve_cfg(model, max_seq_len)
            self.engine = ShardedLLM(cfg, tp=tp, init=init, device=device)
            self.platform = self.engine.device.type

        @serve.batch(max_batch_size=max_batch_size, batch_wait_timeout_s=batch_wait_timeout_s)
        async def generate(self, prompts):
            from ray_tpu_torch.serve import tracing as serve_tracing

            # run the EXACT batch: a padding row would be decoded at full
            # cost.  Multi-token prompts pad to the LONGEST prompt in the
            # coalesced batch (or the fixed ``prompt_pad``) — whole-request
            # batching's intrinsic cost: every short row pays the longest
            # row's prefill AND waits out its decode.  The continuous-
            # batching engine exists to remove exactly this.
            vocab = self.engine.cfg.vocab_size
            rows = []
            for p in prompts:
                if isinstance(p, dict):
                    p = p.get("prompt", 0)
                if isinstance(p, (list, tuple)):
                    rows.append([int(t) % vocab for t in p])
                else:
                    rows.append([int(p) % vocab])
            P = prompt_pad or max(len(r) for r in rows)
            ids = np.zeros((len(rows), P), np.int32)
            for b, r in enumerate(rows):
                ids[b, : min(len(r), P)] = r[:P]
            if serve_tracing.batch_active():
                # traced batch: stamp assembly + run the split
                # prefill/decode pair so TTFT/TPOT are real measurements
                serve_tracing.stamp_batch("serve_batch_assembled")
                serve_tracing.set_batch_tokens(new_tokens)
                out = self.engine.generate(ids, new_tokens, stage_cb=serve_tracing.stamp_batch)
            else:
                out = self.engine.generate(ids, new_tokens)
            return [out[b].tolist() for b in range(len(prompts))]

        async def __call__(self, prompt):
            return await self.generate(prompt)

        def info(self):
            import os

            dev = self.engine.device
            return {
                "platform": self.platform,
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "pid": os.getpid(),
                "params_b": round(self.engine.cfg.num_params() / 1e9, 2),
                "tp": self.engine.tp,
                "shards": self.engine.shard_stats(),
            }

    return LLMDeployment


def engine_llm_deployment(
    model="llama_3b",
    *,
    max_seq_len: Optional[int] = None,
    new_tokens: int = 32,
    num_slots: int = 8,
    page_size: int = 16,
    num_pages: int = 0,
    prefill_chunk: int = 32,
    max_queue: int = 256,
    num_gpus: int = 1,
    tp: Optional[int] = None,
    name: str = "llm",
    autoscaling_config: Optional[dict] = None,
    device: Device = "cuda",
    init: Any = "random",
):
    """Continuous-batching counterpart of :func:`llm_deployment`: the
    replica hosts a resident :class:`~ray_tpu_torch.serve.engine.InferenceEngine`
    (iteration-level scheduling over a paged KV cache) instead of the
    whole-request ``@serve.batch`` path.  Requests of any prompt length
    admit/retire per token step, tokens stream incrementally over
    dag-channel token streams (``handle.stream_tokens`` / SSE at the
    proxy), and a full admission queue rejects FAST with
    ``EngineOverloadedError`` (the proxy's 503).  Accepts the same
    prompt wire shapes as the static path plus
    ``{"prompt": [...], "max_new_tokens": n, "eos_token": t}`` dicts.
    The replica claims ``num_gpus`` cards and runs on ``device`` there:
    CUDA unless the caller names the CPU (with ``num_gpus=0``); the
    engine never moves to the CPU on its own.  ``init`` is ShardedLLM's."""
    from ray_tpu_torch import serve

    @serve.deployment(
        name=name,
        ray_actor_options={"num_gpus": num_gpus},
        max_concurrent_queries=max(256, max_queue),
        autoscaling_config=autoscaling_config
        or {
            "min_replicas": 1,
            "max_replicas": 1,
            "target_num_ongoing_requests_per_replica": 64,
        },
    )
    class LLMEngineDeployment:
        def __init__(self):
            from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

            cfg = _resolve_cfg(model, max_seq_len)
            self.llm = ShardedLLM(cfg, tp=tp, init=init, device=device)
            self.engine = InferenceEngine(
                self.llm,
                EngineConfig(
                    num_slots=num_slots,
                    page_size=page_size,
                    max_seq_len=cfg.max_seq_len,
                    num_pages=num_pages,
                    prefill_chunk=prefill_chunk,
                    max_queue=max_queue,
                    max_new_tokens=new_tokens,
                ),
                deployment=name,
            )
            self.platform = self.llm.device.type

        def _submit(self, prompt, max_new_tokens=None, eos_token=None, sink=None):
            from ray_tpu_torch.serve import tracing as serve_tracing

            ids, spec_new, spec_eos = _parse_prompt_spec(
                prompt, self.llm.cfg.vocab_size, new_tokens
            )
            return self.engine.submit(
                ids,
                max_new_tokens if max_new_tokens is not None else spec_new,
                eos_token=eos_token if eos_token is not None else spec_eos,
                trace=serve_tracing.current_request(),
                sink=sink,
            )

        async def __call__(self, prompt):
            """Buffered (non-streaming) callers: submit and await the full
            sequence without blocking the replica's event loop — the
            engine thread resolves the future at retirement."""
            import asyncio

            from ray_tpu_torch.exceptions import EngineStreamError

            req = self._submit(prompt)
            loop = asyncio.get_running_loop()
            fut = loop.create_future()

            def _done(sink):
                def _fin():
                    if fut.done():
                        return
                    if sink.error is not None:
                        fut.set_exception(EngineStreamError(sink.error))
                    else:
                        fut.set_result(list(sink.tokens))

                loop.call_soon_threadsafe(_fin)

            req.sink.add_done_callback(_done)
            return await fut

        # ---- streaming: dag-channel attach with an actor-call fallback

        def engine_stream_start(self, prompt, max_new_tokens=None, eos_token=None):
            import os

            from ray_tpu_torch.serve.engine import transport

            st = transport.hub().create(
                outbox_limit=self.engine.cfg.stream_outbox_limit
            )
            try:
                req = self._submit(
                    prompt, max_new_tokens, eos_token=eos_token, sink=st
                )
            except BaseException:
                # rejected submit (overload/capacity): reap the stream
                # NOW — gc_finished only sweeps closed streams, and this
                # one would otherwise sit open in the hub forever under
                # exactly the sustained-overload condition
                transport.hub().remove(st.sid)
                raise
            st.cancel_cb = lambda: self.engine.cancel(req)
            return {
                "sid": st.sid,
                "node_id": os.environ.get("RAY_TPU_NODE_ID", ""),
            }

        async def engine_stream_next(self, sid, max_frames=16, timeout=30.0):
            """Pull-path fallback (no direct-call transport): drain the
            stream's outbox through the normal actor-call path.  Runs the
            blocking wait on an executor so concurrent requests keep
            flowing through the replica's loop."""
            import asyncio

            from ray_tpu_torch.serve.engine import transport

            st = transport.hub().get(int(sid))
            if st is None:
                return [], True
            frames, done = await asyncio.get_running_loop().run_in_executor(
                None, st.pull, int(max_frames), float(timeout)
            )
            if done:
                transport.hub().remove(int(sid))
            return frames, done

        def engine_stream_state(self, sid):
            """Stream delivery introspection (ops/debug surface): outbox
            depth, writer/ring state, wire cursor."""
            from ray_tpu_torch.serve.engine import transport

            st = transport.hub().get(int(sid))
            if st is None:
                return {"gone": True}
            out = {
                "frames_queued": len(st._frames),
                "attached": st._writer is not None,
                "seq": st._seq,
                "closed": st.closed,
                "finished": st.finished,
            }
            w = st._writer
            if w is not None:
                out.update(
                    {
                        "ring": w._ring is not None,
                        "ring_unusable": w._ring_unusable,
                        "broken": w.broken,
                        "co_located": w._co_located,
                    }
                )
                if w._ring is not None:
                    out["ring_seqs"] = w._ring._seqs()
            return out

        def engine_stream_cancel(self, sid):
            from ray_tpu_torch.serve.engine import transport

            st = transport.hub().get(int(sid))
            if st is not None and st.cancel_cb is not None:
                st.cancel_cb()
            transport.hub().remove(int(sid))
            return True

        # ---- observe / manage

        def engine_stats(self):
            return self.engine.stats()

        def engine_load(self):
            """Cheap pressure snapshot for least-pressure routing
            (serve/FLEET.md): queue depth, slot occupancy, and KV-page
            fraction.  The Replica wrapper merges this into its load()
            report, which the controller piggybacks onto routing
            publishes — called at the load-poll period, so it must stay
            allocation-light."""
            st = self.engine.stats()
            pages_total = float(st.get("pages_total", 0.0) or 0.0)
            return {
                "queue_depth": float(st.get("queue_depth", 0.0)),
                "slots_active": float(st.get("slots_active", 0.0)),
                "slots_total": float(st.get("slots_total", 0.0)),
                "kv_page_frac": (
                    float(st.get("pages_used", 0.0)) / pages_total
                    if pages_total > 0
                    else 0.0
                ),
            }

        def engine_idle(self):
            """Drain-completion predicate (serve/FLEET.md): True only
            when the scheduler holds no queued or running requests AND
            every hub stream's consumer finished draining its outbox —
            a replica torn down earlier would drop frames a slow client
            had not pulled yet."""
            from ray_tpu_torch.serve.engine import transport

            st = self.engine.stats()
            busy = st.get("queue_depth", 0.0) or st.get("slots_active", 0.0)
            return not busy and transport.hub().busy_count() == 0

        def defrag(self):
            return self.engine.defrag()

        def reconfigure(self, user_config):
            """Live knobs only (queue bound for load shedding); geometry
            is baked into compiled programs."""
            if user_config and "max_queue" in user_config:
                self.engine.reconfigure(max_queue=int(user_config["max_queue"]))

        def info(self):
            import os

            dev = self.llm.device
            return {
                "platform": self.platform,
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "pid": os.getpid(),
                "params_b": round(self.llm.cfg.num_params() / 1e9, 2),
                "tp": self.llm.tp,
                "engine": self.engine.stats(),
                "shards": self.llm.shard_stats(),
            }

    return LLMEngineDeployment
