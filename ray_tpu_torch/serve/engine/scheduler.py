"""Iteration-level admission/retirement for the continuous-batching engine.

The unit of scheduling is one TOKEN STEP, not one request (the
iteration-level batching of Orca/vLLM, vs. the whole-request
``@serve.batch`` path this engine replaces): every engine iteration the
scheduler admits queued requests into free slots (page reservation
gating), feeds at most one chunk of one prompt through prefill, decodes
every slot already streaming, and retires sequences that hit EOS or
their token budget — freeing the slot and its pages for the next queued
request in the same iteration.

Separation of concerns: this module is pure host-side bookkeeping (no
torch, no threads — the engine loop owns the lock and the device); that is
what makes admit/retire/EOS semantics unit-testable on nothing but a
fake clock.
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ray_tpu_torch.exceptions import EngineOverloadedError
from ray_tpu_torch.serve.engine.kv_cache import PagedKVCache

__all__ = ["EngineRequest", "EngineScheduler"]

# request lifecycle states
QUEUED = "QUEUED"  # accepted, waiting for a slot + pages
PREFILL = "PREFILL"  # slot assigned, prompt entering the cache chunk-wise
DECODE = "DECODE"  # first token produced, streaming one token per step
DONE = "DONE"  # retired: EOS / max tokens / cancelled
FAILED = "FAILED"  # retired with an error


@dataclass
class EngineRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    state: str = QUEUED
    slot: int = -1
    fill: int = 0  # prompt tokens already written to the cache
    out: List[int] = field(default_factory=list)
    trace: Optional[dict] = None
    sink: Optional[object] = None  # delivery sink (engine/loop.py)
    error: Optional[str] = None
    cancelled: bool = False
    t_submit: float = field(default_factory=time.time)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (DONE, FAILED)


class EngineScheduler:
    """Admission queue + per-slot run table.

    NOT thread-safe by itself: the engine serializes every call under its
    own lock (submit from actor threads, everything else from the loop
    thread)."""

    def __init__(
        self,
        cache: PagedKVCache,
        *,
        max_queue: int = 256,
        prefill_chunk: int = 32,
    ):
        self.cache = cache
        self.max_queue = int(max_queue)
        self.prefill_chunk = int(prefill_chunk)
        self.queue: Deque[EngineRequest] = collections.deque()
        self.running: Dict[int, EngineRequest] = {}  # slot -> request
        self._free_slots = list(range(cache.num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._rid = itertools.count(1)
        # counters for the stats/gauge plane
        self.n_done = 0
        self.n_failed = 0
        self.n_tokens = 0

    # ------------------------------------------------------------- intake

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        trace: Optional[dict] = None,
        sink=None,
    ) -> EngineRequest:
        """Accept a request into the bounded admission queue.  A full
        queue raises :class:`EngineOverloadedError` IMMEDIATELY — the
        bounded failure mode the HTTP proxy turns into 503+Retry-After
        (unbounded queueing is exactly the p99 cliff this engine exists
        to remove)."""
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + int(max_new_tokens)
        if total > self.cache.max_tokens_per_slot:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds the engine's per-sequence capacity "
                f"{self.cache.max_tokens_per_slot}"
            )
        if len(self.queue) >= self.max_queue:
            raise EngineOverloadedError(
                f"engine admission queue full ({self.max_queue} waiting)",
                retry_after_s=1.0,
            )
        req = EngineRequest(
            rid=next(self._rid),
            prompt=list(prompt),
            max_new_tokens=int(max_new_tokens),
            eos_token=eos_token,
            trace=trace,
            sink=sink,
        )
        self.queue.append(req)
        return req

    def admit(self) -> List[EngineRequest]:
        """Move queued requests into free slots while the page pool can
        cover their worst case.  FCFS with head-of-line blocking ON
        PURPOSE: skipping a big request to admit later small ones forever
        would starve it.  Out of pages → the head request WAITS (admission
        blocked, never a crash); retirement frees pages and unblocks it."""
        admitted: List[EngineRequest] = []
        while self.queue and self._free_slots:
            req = self.queue[0]
            slot = self._free_slots[-1]
            if not self.cache.reserve(slot, req.prompt_len + req.max_new_tokens):
                break  # pool pressure: block admission, keep the request queued
            self._free_slots.pop()
            self.queue.popleft()
            req.slot = slot
            req.state = PREFILL
            self.running[slot] = req
            admitted.append(req)
        return admitted

    # ------------------------------------------------------------- planning

    def next_prefill(self) -> Optional[Tuple[EngineRequest, int, List[int]]]:
        """The next prompt chunk to run: (request, start_pos, tokens),
        FCFS among PREFILL requests, at most ``prefill_chunk`` tokens — a
        long prompt runs as many chunks across many iterations, and the
        decode fleet advances between every pair (chunked prefill: long
        prompts never stall in-flight streams)."""
        cand = [r for r in self.running.values() if r.state == PREFILL]
        if not cand:
            return None
        req = min(cand, key=lambda r: r.rid)
        start = req.fill
        toks = req.prompt[start : start + self.prefill_chunk]
        return req, start, toks

    def note_prefill(self, req: EngineRequest, n_tokens: int) -> bool:
        """Advance a request's prefill cursor; True when the prompt is now
        fully resident (the chunk's sampled token becomes the first
        generated token and the request joins the decode fleet)."""
        req.fill += int(n_tokens)
        return req.fill >= req.prompt_len

    def decode_fleet(self) -> List[EngineRequest]:
        return [r for r in self.running.values() if r.state == DECODE]

    # ----------------------------------------------------------- lifecycle

    def note_token(self, req: EngineRequest, token: int) -> bool:
        """Record one generated token; True when the sequence retires
        (EOS or budget).  The caller delivers the token and, on True,
        calls :meth:`retire`."""
        req.out.append(int(token))
        self.n_tokens += 1
        if req.eos_token is not None and int(token) == int(req.eos_token):
            return True
        return len(req.out) >= req.max_new_tokens

    def drop_cancelled_queued(self) -> List[EngineRequest]:
        """Remove cancelled requests still waiting in the queue (the
        engine seals + delivers their done frames; dropping them here
        alone would strand their consumers)."""
        victims = [r for r in self.queue if r.cancelled]
        if victims:
            self.queue = collections.deque(r for r in self.queue if not r.cancelled)
            for req in victims:
                self._finish(req, DONE, error=None)
        return victims

    def retire(self, req: EngineRequest, error: Optional[str] = None) -> None:
        """Retire a running request: recycle its slot and pages so the
        next queued request can admit on the SAME iteration."""
        if req.slot >= 0:
            self.cache.release(req.slot)
            self.running.pop(req.slot, None)
            self._free_slots.append(req.slot)
            req.slot = -1
        self._finish(req, FAILED if error else DONE, error=error)

    def _finish(self, req: EngineRequest, state: str, error: Optional[str]) -> None:
        req.state = state
        req.error = error
        if state == FAILED:
            self.n_failed += 1
        else:
            self.n_done += 1

    def fail_all(self, reason: str) -> List[EngineRequest]:
        """Engine shutdown / fatal device error: retire everything with a
        typed error so no caller hangs on a silent stream."""
        victims = list(self.running.values()) + list(self.queue)
        self.queue.clear()
        for req in list(self.running.values()):
            self.retire(req, error=reason)
        for req in victims:
            if not req.done:
                self._finish(req, FAILED, error=reason)
        return victims

    # ------------------------------------------------------------- stats

    def depth(self) -> int:
        return len(self.queue)

    def active(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    def stats(self) -> Dict[str, float]:
        by_state: Dict[str, int] = {}
        for r in self.running.values():
            by_state[r.state] = by_state.get(r.state, 0) + 1
        return {
            "queue_depth": float(len(self.queue)),
            "slots_total": float(self.cache.num_slots),
            "slots_active": float(len(self.running)),
            "slots_prefill": float(by_state.get(PREFILL, 0)),
            "slots_decode": float(by_state.get(DECODE, 0)),
            "requests_done": float(self.n_done),
            "requests_failed": float(self.n_failed),
            "tokens_generated": float(self.n_tokens),
        }
