"""Serve request tracing: per-stage spans from ingress to last token.

Extends the task flight recorder (_private/task_events.py) to the serve
plane (reference analogs: the reference's serve request-context
propagation, python/ray/serve/_private/replica.py request metadata +
handle_request_streaming latency metrics; and vLLM-style TTFT/TPOT
accounting for LLM serving).  A request record is born at the ingress
(HTTP proxy or a bare DeploymentHandle), rides the call as a reserved
kwarg (``_serve_trace``) into the replica, picks up replica-side stamps
(queue wait, batch assembly, prefill, decode), and ships to the head on
a fire-and-forget ``SERVE_TRACE`` frame — batched, never a
per-request head round trip.  The head joins records next to the task
flight records: same ring, same timeline, per-stage
``ray_tpu_torch_serve_request_seconds{stage,deployment}`` histograms, plus
first-class TTFT/TPOT distributions for the LLM path.

Stage stamps come from the canonical ``task_events.PHASES`` vocabulary
(the ``serve_*`` block — graftlint GL008 checks literal stamp sites).

Overhead contract: when recording is off (``RAY_TPU_TASK_EVENTS=0``)
``new_request()`` returns None after one flag check, and every
downstream site gates on that None — no dict, no clock read, no extra
wire bytes (the reserved kwarg is only attached when a record exists).

Propagation inside the replica uses contextvars, so the batch queue and
the model engine stamp the right request(s) without threading a handle
through every call: ``request_scope`` installs the in-flight record,
``batch_scope`` installs the list of records coalesced into one model
invocation (``stamp_batch`` fans a stamp out to all of them).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import task_events

# the request currently being handled on this (asyncio) context
_current_request: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "serve_request_trace", default=None
)
# the requests coalesced into the model batch currently executing
_current_batch: contextvars.ContextVar[Optional[List[dict]]] = contextvars.ContextVar(
    "serve_batch_traces", default=None
)


def enabled() -> bool:
    return task_events.enabled


def new_request(deployment: str = "") -> Optional[dict]:
    """Fresh request record, or None when recording is off (the one flag
    check every downstream stamp site gates on)."""
    if not task_events.enabled:
        return None
    from ray_tpu_torch.util import tracing as span_tracing

    return {
        "deployment": deployment,
        "phases": {"serve_proxy_recv": time.time()},
        "trace": span_tracing.new_span_context() or {},
        "tokens": 0,
        "error": False,
    }


def stamp(trace: Optional[dict], phase: str) -> None:
    if trace is not None:
        trace["phases"][phase] = time.time()


def current_request() -> Optional[dict]:
    return _current_request.get()


@contextlib.contextmanager
def request_scope(trace: Optional[dict]):
    """Replica-side: install the in-flight request's record so the batch
    queue (and anything else downstream) can stamp it."""
    token = _current_request.set(trace)
    try:
        yield trace
    finally:
        _current_request.reset(token)


@contextlib.contextmanager
def batch_scope(traces: List[dict]):
    """Around one coalesced model invocation: ``stamp_batch`` inside the
    scope stamps every request in the batch."""
    token = _current_batch.set(traces)
    try:
        yield traces
    finally:
        _current_batch.reset(token)


def batch_active() -> bool:
    return bool(_current_batch.get())


def stamp_batch(phase: str) -> None:
    """Stamp `phase` on every request record in the executing batch (a
    no-op outside a batch_scope / with recording off)."""
    traces = _current_batch.get()
    if not traces:
        return
    now = time.time()
    for tr in traces:
        tr["phases"][phase] = now


def set_batch_tokens(n: int) -> None:
    """Record how many tokens each request in the batch received (the
    TPOT denominator)."""
    traces = _current_batch.get()
    if not traces:
        return
    for tr in traces:
        tr["tokens"] = int(n)


def derive(trace: dict) -> dict:
    """TTFT/TPOT for a sealed record: TTFT = receipt → first token; TPOT
    = decode window / (tokens - 1).  None when the path never generated
    (non-LLM deployments lack the prefill/decode stamps)."""
    ph = trace["phases"]
    out = {"ttft_s": None, "tpot_s": None}
    first = ph.get("serve_first_token")
    start = ph.get("serve_proxy_recv") or ph.get("serve_replica_recv")
    if first is not None and start is not None:
        out["ttft_s"] = max(0.0, first - start)
    decode_end = ph.get("serve_decode_end")
    tokens = int(trace.get("tokens") or 0)
    if first is not None and decode_end is not None and tokens > 1:
        out["tpot_s"] = max(0.0, decode_end - first) / (tokens - 1)
    return out


# ------------------------------------------------- replica-side shipping
# Batched fire-and-forget
# (reference analog: task_event_buffer.cc flushes on size/staleness,
# never per event).

_BATCH = 8
_FLUSH_S = 0.25
_buf_lock = threading.Lock()
_buf: List[dict] = []
_last_flush = 0.0


def defer_finish(trace: Optional[dict]) -> None:
    """Hand sealing ownership to a later finisher: the continuous-batching
    engine's requests OUTLIVE the actor method that submitted them (the
    handler returns while tokens still stream), so the replica's
    handle_request ``finally`` must not seal the record — the engine does,
    at retirement, with ``finish_request(trace, final=True)``."""
    if trace is not None:
        trace["_deferred"] = True


def finish_request(trace: Optional[dict], error: bool = False, final: bool = False) -> None:
    """Seal a request record (stamps serve_handler_end, derives
    TTFT/TPOT) and buffer it; a full or stale buffer ships as one
    SERVE_TRACE frame.  Idempotent: a record seals exactly once (the
    engine path has two finishers — the submitting handler's ``finally``
    and the engine's retirement — ``_deferred``/``_sealed`` arbitrate)."""
    global _buf, _last_flush
    if trace is None or trace.get("_sealed"):
        return
    if trace.get("_deferred") and not final:
        return  # the engine owns this record's seal
    trace["_sealed"] = True
    trace["phases"]["serve_handler_end"] = time.time()
    trace["error"] = bool(error)
    trace.update(derive(trace))
    trace["pid"] = os.getpid()
    # internal arbitration keys never ship
    record = {k: v for k, v in trace.items() if not k.startswith("_")}
    with _buf_lock:
        _buf.append(record)
        now = record["phases"]["serve_handler_end"]
        if len(_buf) < _BATCH and now - _last_flush < _FLUSH_S:
            return
        batch, _buf = _buf, []
        _last_flush = now
    _ship(batch)


def flush() -> None:
    """Ship whatever records remain (tests / replica teardown)."""
    global _buf
    with _buf_lock:
        batch, _buf = _buf, []
    if batch:
        _ship(batch)


def _ship(batch: List[dict]) -> None:
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.protocol import MsgType

    try:
        cw = worker_mod._require_connected()
        cw.io.spawn(
            cw.conn.send(
                MsgType.SERVE_TRACE,
                {"node_id": cw.node_id, "requests": batch},
            )
        )
    except Exception:  # graftlint: disable=silent-except -- observability is best-effort; the request result already left
        pass
