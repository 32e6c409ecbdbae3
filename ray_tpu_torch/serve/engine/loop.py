"""The resident decode loop: one engine thread per replica, one device
program per iteration step.

The scarce resource is per-step dispatch latency, so the engine is a
loop that lives inside the replica actor and whose host work per token
step is small: build four small int arrays, call ONE program over the
model on its card (active-slot masking covers empty slots), read S ints
back.  That device→host read is deliberate — it is the host-visible
token frontier that makes per-request TTFT/TPOT real measurements and
feeds every stream its next frame; batching it per step (not per
request) is what keeps the loop O(1) in concurrency.

Iteration shape (scheduler.py decides, this module executes):

    admit  →  [one prefill chunk]  →  [one decode step over the fleet]
           →  deliver frames  →  retire / recycle slots

Nothing here talks to the head: token frames leave through delivery
sinks (buffered result, or dag-channel streams via engine/transport.py)
and observability leaves through the serve tracer's batched SERVE_TRACE
frames plus ``ray_tpu_torch_serve_engine_*`` gauges.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.exceptions import EngineStreamError
from ray_tpu_torch.serve.engine.kv_cache import PagedKVCache
from ray_tpu_torch.serve.engine.scheduler import (
    DECODE,
    EngineRequest,
    EngineScheduler,
)
from ray_tpu_torch.util.lockwitness import named_lock, named_rlock

__all__ = ["EngineConfig", "InferenceEngine", "BufferSink"]


@dataclass(frozen=True)
class EngineConfig:
    """Engine geometry.  Every field here shapes a program's inputs or a
    pool size — all of them are fixed at engine construction (the
    one-shape invariant); only ``max_queue`` may be reconfigured live."""

    num_slots: int = 8  # concurrent sequences per replica
    page_size: int = 16  # tokens per KV page
    max_seq_len: int = 256  # per-sequence logical capacity (prompt + generated)
    # physical pool size; 0 = full residency (num_slots * pages_per_slot).
    # Undersize it to overcommit: admission then blocks on pool pressure
    num_pages: int = 0
    prefill_chunk: int = 32  # prompt tokens per prefill program call
    max_queue: int = 256  # bounded admission queue (overflow -> 503)
    max_new_tokens: int = 32  # default token budget per request
    # a consumer this many frames behind its stream is broken, not slow
    stream_outbox_limit: int = 4096
    gauge_period_s: float = 0.5

    @property
    def pages_per_slot(self) -> int:
        return max(1, math.ceil(self.max_seq_len / self.page_size))

    def pool_pages(self) -> int:
        return int(self.num_pages) or self.num_slots * self.pages_per_slot


class BufferSink:
    """Delivery sink for non-streaming callers: collect every token,
    fire done callbacks once, raise typed errors from ``result``."""

    def __init__(self):
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.overloaded = False
        self._done = threading.Event()
        self._cbs: List[Any] = []
        self._lock = named_lock("BufferSink._lock")

    def emit(self, frame: dict) -> None:
        """Engine-thread only (single producer)."""
        self.tokens.extend(frame.get("t") or [])
        if frame.get("error"):
            self.error = str(frame["error"])
        if frame.get("done"):
            with self._lock:
                self._done.set()
                cbs, self._cbs = self._cbs, []
            for cb in cbs:
                cb(self)

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if not self._done.is_set():
                self._cbs.append(cb)
                return
        cb(self)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("engine request did not complete in time")
        if self.error is not None:
            raise EngineStreamError(self.error)
        return list(self.tokens)


class InferenceEngine:
    """Continuous-batching engine over a paged LLM on one device.

    ``llm`` is a ``ShardedLLM`` (serve/llm.py) — its ``engine_programs``
    builds the three programs (pool init, prefill chunk, decode step) over
    the model on its device; everything else here is host-side.
    """

    def __init__(self, llm, config: Optional[EngineConfig] = None, deployment: str = "llm"):
        cfg = config or EngineConfig()
        if cfg.max_seq_len > llm.cfg.max_seq_len:
            raise ValueError(
                f"engine max_seq_len {cfg.max_seq_len} exceeds the model's "
                f"{llm.cfg.max_seq_len}"
            )
        self.cfg = cfg
        self.llm = llm
        self.deployment = deployment
        self._programs = llm.engine_programs(
            num_pages=cfg.pool_pages(), page_size=cfg.page_size
        )
        self._pages = self._programs["init"]()
        self.cache = PagedKVCache(
            cfg.num_slots, cfg.pages_per_slot, cfg.pool_pages(), cfg.page_size
        )
        self.sched = EngineScheduler(
            self.cache, max_queue=cfg.max_queue, prefill_chunk=cfg.prefill_chunk
        )
        self._lock = named_rlock("InferenceEngine._lock")
        # stream sinks with frames still queued for the wire: the ring is
        # finite, so streams longer than it need flush retries after the
        # consumer drains slots — the loop (and the idle tick) provide them
        self._laggards: set = set()
        # parked defrag requests, executed by the loop at iteration
        # boundaries (see defrag())
        self._defrag_reqs: List = []
        # staged weight hot-swap (update_weights): applied atomically at
        # the next iteration boundary so no prefill/decode program ever
        # sees a half-swapped tree
        self._pending_params = None
        self.weight_updates = 0
        self._wake = threading.Event()
        self._stop = False
        self._fatal: Optional[str] = None
        self._gauges = None
        self._last_gauges = 0.0
        self._tokens_reported = 0
        self.iterations = 0
        self._thread = threading.Thread(
            target=self._run, name=f"engine-{deployment}", daemon=True
        )
        self._thread.start()

    # -------------------------------------------------------------- intake

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: Optional[int] = None,
        eos_token: Optional[int] = None,
        trace: Optional[dict] = None,
        sink=None,
    ) -> EngineRequest:
        """Enqueue one request.  Raises EngineOverloadedError on a full
        queue (the bounded failure mode), ValueError on capacity misuse,
        EngineStreamError after a fatal engine stop."""
        from ray_tpu_torch.serve import tracing as serve_tracing

        serve_tracing.stamp(trace, "serve_engine_submit")
        with self._lock:
            # stop checked UNDER the lock: a submit racing the loop's
            # fatal teardown must either see _stop here or land in the
            # queue before fail_all drains it — never slip in after and
            # hang its caller on a queue nobody services
            if self._stop:
                raise EngineStreamError(self._fatal or "engine stopped")
            req = self.sched.submit(
                prompt,
                max_new_tokens if max_new_tokens is not None else self.cfg.max_new_tokens,
                eos_token=eos_token,
                trace=trace,
                sink=sink if sink is not None else BufferSink(),
            )
        # only an ACCEPTED request defers sealing to the engine — a
        # rejected one (overload/capacity) must still be sealed by the
        # submitting handler's finally, or its record would never ship
        serve_tracing.defer_finish(trace)
        self._wake.set()
        return req

    def cancel(self, req: EngineRequest) -> None:
        """Consumer abandoned the request: retire it at the next
        iteration boundary (mid-step cancel would desync the fleet)."""
        req.cancelled = True
        self._wake.set()

    # ------------------------------------------------------------ the loop

    def _run(self) -> None:
        # the resident loop is its own profiler role: sampled stacks from
        # this thread aggregate under "engine", not the host worker, so
        # `ray-tpu profile` separates decode-step time from actor-call
        # time on the same process (one dict write; no-op when the
        # profiler plane is hard-off)
        from ray_tpu_torch._private import profiler

        profiler.set_thread_role("engine")
        try:
            while not self._stop:
                with self._lock:
                    busy = self.sched.has_work()
                if not busy:
                    self._run_defrags()
                    self._flush_laggards()
                    self._maybe_gauges()
                    fast = any(
                        getattr(s, "flushable", lambda: False)()
                        for s in self._laggards
                    )
                    self._wake.wait(0.002 if fast else 0.05)
                    self._wake.clear()
                    continue
                self._iteration()
        except BaseException as e:  # noqa: BLE001 -- a dead loop must fail every caller, typed
            self._fatal = f"engine loop died: {type(e).__name__}: {e}"
            import logging

            logging.getLogger(__name__).exception("inference engine loop died")
        finally:
            self._stop = True
            reason = self._fatal or "engine shut down"
            with self._lock:
                victims = self.sched.fail_all(reason)
                parked, self._defrag_reqs = self._defrag_reqs, []
            for req in victims:
                self._deliver(req, [], done=True, error=reason)
            for done, result in parked:  # never strand a defrag waiter
                result.update({"moves": 0, "error": reason})
                done.set()
            self._maybe_gauges(force=True)

    def update_weights(self, params=None, *, ref=None) -> None:
        """Stage a live weight hot-swap; applied at the next iteration
        boundary (decode never sees a half-swapped model).

        ``params`` is a state dict of the model (parameter name → torch
        tensor or numpy array); ``ref`` is an ObjectRef to one, resolved
        here (a trainer's ``put`` of its numpy arrays).  Names and shapes
        are checked now, so a mismatch raises at the caller instead of in
        the loop."""
        if (params is None) == (ref is None):
            raise ValueError("update_weights wants exactly one of params=/ref=")
        if ref is not None:
            import ray_tpu_torch

            params = ray_tpu_torch.get(ref, timeout=300)
        import torch

        want = {n: tuple(p.shape) for n, p in self.llm.model.state_dict().items()}
        new = {n: torch.as_tensor(v) for n, v in dict(params).items()}
        got = {n: tuple(t.shape) for n, t in new.items()}
        if got != want:
            bad = sorted(n for n in set(want) | set(got) if want.get(n) != got.get(n))
            raise ValueError(f"update_weights: names or shapes differ from the model's: {bad}")
        with self._lock:
            self._pending_params = new
        self._wake.set()

    def _apply_pending_params(self) -> None:
        with self._lock:
            new, self._pending_params = self._pending_params, None
        if new is None:
            return
        self.llm.model.load_state_dict(new)  # copied in place, cast to each parameter's dtype
        self.weight_updates += 1

    def _iteration(self) -> None:
        from ray_tpu_torch.serve import tracing as serve_tracing

        self.iterations += 1
        self._apply_pending_params()
        self._run_defrags()
        with self._lock:
            self._reap_cancelled()
            admitted = self.sched.admit()
        for req in admitted:
            serve_tracing.stamp(req.trace, "serve_engine_admit")

        # -- one prefill chunk (chunked: decode never waits on a whole prompt)
        with self._lock:
            pf = self.sched.next_prefill()
        if pf is not None:
            self._prefill_chunk(*pf)

        # -- one decode step over the whole fleet: ONE program, any mix of
        # sequence lengths, inactive slots masked
        fleet = self.sched.decode_fleet()
        if fleet:
            self._decode_step(fleet)
        self._flush_laggards()
        self._maybe_gauges()

    def _reap_cancelled(self) -> None:
        """Lock held.  Retire cancelled running requests at the iteration
        boundary — and seal their (deferred) trace records: a cancelled
        request still happened."""
        from ray_tpu_torch.serve import tracing as serve_tracing

        victims = [r for r in self.running_snapshot() if r.cancelled]
        for req in victims:
            self.sched.retire(req, error=None)
        victims += self.sched.drop_cancelled_queued()
        for req in victims:
            if req.trace is not None:
                req.trace["tokens"] = len(req.out)
            serve_tracing.finish_request(req.trace, error=False, final=True)
            self._deliver(req, [], done=True, error=None)

    def running_snapshot(self) -> List[EngineRequest]:
        return list(self.sched.running.values())

    def _prefill_chunk(self, req: EngineRequest, start: int, toks: List[int]) -> None:
        from ray_tpu_torch.serve import tracing as serve_tracing

        if start == 0:
            serve_tracing.stamp(req.trace, "serve_prefill_start")
        C = self.cfg.prefill_chunk
        n_valid = len(toks)
        chunk = np.zeros(C, np.int32)
        chunk[:n_valid] = toks
        first, self._pages = self._programs["prefill"](
            self._pages,
            np.ascontiguousarray(self.cache.tables[req.slot]),
            chunk,
            np.int32(start),
            np.int32(n_valid),
        )
        if not self.sched.note_prefill(req, n_valid):
            return
        # prompt fully resident: the chunk's sampled token IS the first
        # generated token, host-visible right here — the TTFT endpoint
        tok0 = int(first.item())
        serve_tracing.stamp(req.trace, "serve_first_token")
        req.state = DECODE
        with self._lock:
            finished = self.sched.note_token(req, tok0)
        if finished:
            self._retire(req, last_tokens=[tok0])
        else:
            self._deliver(req, [tok0])

    def _decode_step(self, fleet: List[EngineRequest]) -> None:
        S = self.cfg.num_slots
        tokens = np.zeros(S, np.int32)
        positions = np.zeros(S, np.int32)
        active = np.zeros(S, bool)
        for req in fleet:
            s = req.slot
            tokens[s] = req.out[-1]
            positions[s] = req.prompt_len + len(req.out) - 1
            active[s] = True
        nxt, self._pages = self._programs["decode"](
            self._pages,
            np.ascontiguousarray(self.cache.tables),
            tokens,
            positions,
            active,
        )
        nxt = nxt.cpu().numpy()  # the per-step host sync: the token frontier
        for req in fleet:
            tok = int(nxt[req.slot])
            with self._lock:
                finished = self.sched.note_token(req, tok)
            if finished:
                self._retire(req, last_tokens=[tok])
            else:
                self._deliver(req, [tok])

    # ----------------------------------------------------------- delivery

    def _retire(self, req: EngineRequest, last_tokens: Optional[List[int]] = None) -> None:
        from ray_tpu_torch.serve import tracing as serve_tracing

        serve_tracing.stamp(req.trace, "serve_decode_end")
        if req.trace is not None:
            req.trace["tokens"] = len(req.out)
        with self._lock:
            self.sched.retire(req)
        serve_tracing.finish_request(req.trace, error=False, final=True)
        self._deliver(req, last_tokens or [], done=True)

    def _deliver(
        self,
        req: EngineRequest,
        toks: List[int],
        done: bool = False,
        error: Optional[str] = None,
    ) -> None:
        from ray_tpu_torch.serve import tracing as serve_tracing

        if error is not None:
            serve_tracing.stamp(req.trace, "serve_decode_end")
            serve_tracing.finish_request(req.trace, error=True, final=True)
        sink = req.sink
        if sink is None:
            return
        try:
            sink.emit({"t": toks, "done": bool(done), "error": error})
            if getattr(sink, "needs_flush", None) is not None and sink.needs_flush():
                self._laggards.add(sink)
        except Exception:  # noqa: BLE001 -- a broken consumer must not stall the fleet
            req.sink = None

    def _flush_laggards(self) -> None:
        """Re-flush streams whose channel ring was full at emit time —
        the consumer drains slots at its own pace, so delivery of a
        sequence longer than the ring depth completes here."""
        for sink in list(self._laggards):
            try:
                sink.flush()
                if not sink.needs_flush():
                    self._laggards.discard(sink)
            except Exception:  # noqa: BLE001 -- broken stream: its consumer sees the typed error
                self._laggards.discard(sink)

    # -------------------------------------------------------------- defrag

    def defrag(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Compact the page pool: move allocated pages to the lowest
        physical ids and rewrite the page tables.  The device copy runs
        ON THE ENGINE THREAD at an iteration boundary — the loop runs its
        programs outside the lock, writing the pool in place, so any other
        thread touching ``self._pages`` would race a step mid-write; this
        call just parks a request and waits."""
        done = threading.Event()
        result: Dict[str, Any] = {}
        with self._lock:
            if self._stop:
                raise EngineStreamError(self._fatal or "engine stopped")
            self._defrag_reqs.append((done, result))
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError("defrag did not run within the timeout")
        return result

    def _run_defrags(self) -> None:
        """Engine thread, iteration boundary: the one place where no
        program is mid-flight over the pool."""
        with self._lock:
            reqs, self._defrag_reqs = self._defrag_reqs, []
        if not reqs:
            return
        with self._lock:
            moves = self.cache.compaction_plan()
            if moves:
                self._programs["move_pages"](self._pages, [m[0] for m in moves], [m[1] for m in moves])
                self.cache.apply_compaction(moves)
            frag = self.cache.allocator.fragmentation()
        for done, result in reqs:
            result.update({"moves": len(moves), "fragmentation": frag})
            done.set()

    # ------------------------------------------------------------- observe

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = self.sched.stats()
            out.update(self.cache.stats())
        out["iterations"] = float(self.iterations)
        out.update({f"compile_{k}": v for k, v in self.compile_stats().items()})
        return out

    def compile_stats(self) -> Dict[str, int]:
        """Distinct input-shape signatures each program has run with — the
        reference's jit cache sizes, the no-recompilation assertion
        surface: after warmup each stays at 1 no matter the length mix."""
        return {name: self._programs[name].cache_size() for name in ("prefill", "decode")}

    def _maybe_gauges(self, force: bool = False) -> None:
        """Publish slot/page occupancy gauges at most every
        ``gauge_period_s`` (off the per-token path).  Outside a connected
        worker (unit tests drive the engine bare) this is a no-op."""
        now = time.monotonic()
        if not force and now - self._last_gauges < self.cfg.gauge_period_s:
            return
        self._last_gauges = now
        try:
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod._require_connected()
        except Exception:  # noqa: BLE001 -- bare engine: no metrics plane to publish to
            return
        try:
            g, c = self._ensure_gauges()
            st = self.stats()
            dep = {"deployment": self.deployment}
            g["slots"].set(st["slots_active"], {**dep, "kind": "active"})
            g["slots"].set(st["slots_decode"], {**dep, "kind": "decode"})
            g["slots"].set(st["slots_prefill"], {**dep, "kind": "prefill"})
            g["slots"].set(st["slots_total"], {**dep, "kind": "total"})
            g["queue"].set(st["queue_depth"], dep)
            g["pages"].set(st["pages_used"], {**dep, "kind": "used"})
            g["pages"].set(st["pages_total"], {**dep, "kind": "total"})
            g["frag"].set(st["fragmentation"], dep)
            delta = int(st["tokens_generated"]) - self._tokens_reported
            if delta > 0:
                c.inc(delta, dep)
                self._tokens_reported += delta
        except Exception:  # noqa: BLE001 -- observability is best-effort; serving already progressed
            import logging

            logging.getLogger(__name__).debug(
                "engine gauge publish failed", exc_info=True
            )

    def _ensure_gauges(self):
        if self._gauges is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            self._gauges = (
                {
                    "slots": Gauge(
                        "ray_tpu_torch_serve_engine_slots",
                        "Engine slot occupancy by kind (active/prefill/decode/total)",
                        tag_keys=("deployment", "kind"),
                    ),
                    "queue": Gauge(
                        "ray_tpu_torch_serve_engine_queue_depth",
                        "Requests waiting in the engine's bounded admission queue",
                        tag_keys=("deployment",),
                    ),
                    "pages": Gauge(
                        "ray_tpu_torch_serve_engine_kv_pages",
                        "Paged KV cache pool occupancy (used/total pages)",
                        tag_keys=("deployment", "kind"),
                    ),
                    "frag": Gauge(
                        "ray_tpu_torch_serve_engine_page_fragmentation",
                        "Free-list fragmentation of the KV page pool (0=contiguous)",
                        tag_keys=("deployment",),
                    ),
                },
                Counter(
                    "ray_tpu_torch_serve_engine_tokens_total",
                    "Tokens generated by the continuous-batching engine",
                    tag_keys=("deployment",),
                ),
            )
        return self._gauges

    # ------------------------------------------------------------ teardown

    def reconfigure(self, max_queue: Optional[int] = None) -> None:
        """Live-adjustable knobs only (everything geometric is baked into
        compiled programs)."""
        if max_queue is not None:
            self.sched.max_queue = int(max_queue)

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout)
