"""Task tracing: spans with parent propagation across task boundaries.

Analog of the reference's tracing helper (reference:
python/ray/util/tracing/tracing_helper.py — every remote call carries the
caller's span context in task metadata, _DictPropagator:160 /
_function_hydrate_span_args:190; the built-in timeline comes from
core_worker/profiling.cc events).  Opt-in: ``enable_tracing()`` (or env
RAY_TPU_TRACING=1).  When on, each submit mints a span whose parent is
the submitting context's span — including inside workers, so nested task
graphs chain into one trace.  Spans land in the head timeline (TASK_DONE
exec windows) and `ray-tpu timeline` exports them with trace/span ids as
Chrome-trace args.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, Optional

_state = threading.local()
_enabled: Optional[bool] = None


def enable_tracing():
    global _enabled
    _enabled = True


def disable_tracing():
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return bool(os.environ.get("RAY_TPU_TRACING"))


def current_context() -> Optional[Dict[str, str]]:
    return getattr(_state, "ctx", None)


def new_span_context() -> Optional[Dict[str, str]]:
    """Span for a task being submitted NOW, parented to the current one."""
    if not tracing_enabled():
        return None
    cur = current_context()
    return {
        "trace_id": (cur or {}).get("trace_id") or uuid.uuid4().hex[:16],
        "parent_span_id": (cur or {}).get("span_id", ""),
        "span_id": uuid.uuid4().hex[:16],
    }


class span_scope:
    """Worker-side: install the executing task's span as the current
    context so any nested submits chain under it."""

    def __init__(self, ctx: Optional[Dict[str, str]]):
        self.ctx = ctx
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_state, "ctx", None)
        if self.ctx:
            _state.ctx = self.ctx
        return self

    def __exit__(self, *exc):
        _state.ctx = self.prev
        return False
