"""Runtime lock-order witness — the dynamic half of graftsan GS003.

The static lock-order graph proves the SHIPPED nesting acyclic; this
module watches the orders that actually happen at runtime, including
ones the static pass cannot see (locks passed through callbacks,
acquisition orders that depend on data).  Both halves speak the same
vocabulary: a lock created as ``named_lock("CoreWorker._refs_lock")``
carries exactly the identity the static pass derives from
``self._refs_lock`` inside ``class CoreWorker``.

Disarmed (the default), the factories return plain ``threading``
primitives — no wrapper object, no per-acquire cost, nothing to audit
in production profiles.  Armed via ``RAY_TPU_LOCK_WITNESS=1`` in the
environment (the chaos and head-FT CI jobs run this way):

- every thread keeps a stack of witness locks it holds;
- acquiring B while holding A records the edge A→B the first time it
  is seen, together with the acquiring stack;
- an acquisition that would close a cycle in the recorded order graph
  raises ``LockOrderViolation`` immediately, on the thread that made
  the inversion, with both edges' stacks in the message — a deadlock
  report without needing the deadlock to actually strike.

Cost when armed: the common acquire (no other witness lock held) is a
thread-local list append; edge bookkeeping only runs while nested, and
takes the module graph lock only for a first-seen edge or a cycle
probe.  The witness-overhead test (tests/test_graftsan.py) holds the
armed/disarmed ratio on the tracked task-batch pair to <=5%.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "ARMED",
    "LockOrderViolation",
    "arm",
    "named_condition",
    "named_lock",
    "named_rlock",
    "order_edges",
    "reset",
]


class LockOrderViolation(AssertionError):
    """An acquisition closed a cycle in the observed lock-order graph."""


def _env_armed() -> bool:
    return os.environ.get("RAY_TPU_LOCK_WITNESS", "").strip().lower() not in (
        "",
        "0",
        "false",
        "off",
    )


ARMED = _env_armed()

_tls = threading.local()
_graph_lock = threading.Lock()
# (held, acquired) -> formatted stack of the acquisition that created it
_edges: Dict[Tuple[str, str], str] = {}
_adj: Dict[str, Set[str]] = {}


def arm(flag: bool = True) -> None:
    """Flip the witness for locks created AFTER this call (tests; the
    env var is the production switch).  Existing locks keep whatever
    shape they were created with."""
    global ARMED
    ARMED = flag


def reset() -> None:
    """Drop every recorded edge (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _adj.clear()


def order_edges() -> Dict[Tuple[str, str], str]:
    """Snapshot of the observed order graph (edge -> acquiring stack)."""
    with _graph_lock:
        return dict(_edges)


def _held_stack() -> List[str]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _path_exists(src: str, dst: str) -> bool:
    """DFS in the recorded graph; caller holds _graph_lock."""
    seen: Set[str] = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_adj.get(n, ()))
    return False


def _record_edges(held: List[str], name: str) -> None:
    """Record held→name edges (first-seen) and assert acyclicity."""
    for h in held:
        if h == name:
            continue  # reentrant same-lock: not an ordering edge
        key = (h, name)
        with _graph_lock:
            if key in _edges:
                continue
            if _path_exists(name, h):
                # reconstruct one offending path for the report
                prior = next(
                    (e for e in _edges if e[0] == name), None
                )
                prior_stack = _edges.get(prior, "") if prior else ""
                here = "".join(traceback.format_stack(limit=16))
                raise LockOrderViolation(
                    f"lock-order inversion: acquiring '{name}' while "
                    f"holding '{h}', but the witness has already seen "
                    f"'{name}' held before '{h}' (path {name} ~> {h}).\n"
                    f"--- this acquisition ---\n{here}"
                    f"--- first edge out of '{name}' "
                    f"({prior[0]} -> {prior[1] if prior else '?'}) ---\n"
                    f"{prior_stack}"
                )
            _edges[key] = "".join(traceback.format_stack(limit=16))
            _adj.setdefault(h, set()).add(name)


def _note_acquired(name: str) -> None:
    held = _held_stack()
    if held:
        _record_edges(held, name)
    held.append(name)


def _note_released(name: str) -> None:
    held = _held_stack()
    # release order may differ from acquire order: drop the LAST occurrence
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _WitnessLock:
    """threading.Lock wrapper that feeds the order graph."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._lock = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            try:
                _note_acquired(self.name)
            except LockOrderViolation:
                self._lock.release()
                raise
        return got

    def release(self) -> None:
        _note_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} {self._lock!r}>"


class _WitnessRLock(_WitnessLock):
    """threading.RLock wrapper; also speaks Condition's private protocol
    (_is_owned / _release_save / _acquire_restore) so it can back a
    ``threading.Condition`` — ``wait()`` pops every recursive hold from
    the witness stack and restores it on wakeup."""

    _factory = staticmethod(threading.RLock)

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    # -- Condition protocol -------------------------------------------------

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        held = _held_stack()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                n += 1
        return (state, n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        self._lock._acquire_restore(state)
        held = _held_stack()
        # wait() reacquires while possibly nested under other locks the
        # waiter took since; the reacquire is the SAME logical hold, so
        # restore without re-recording edges (they were recorded at the
        # original acquisition)
        held.extend([self.name] * n)


def named_lock(name: str):
    """A ``threading.Lock`` carrying a witness identity.  ``name`` must
    match the static id graftsan derives: ``Class._attr`` for instance
    locks, ``pkg.module._name`` for module globals."""
    return _WitnessLock(name) if ARMED else threading.Lock()


def named_rlock(name: str):
    return _WitnessRLock(name) if ARMED else threading.RLock()


def named_condition(name: str, lock=None):
    """A ``threading.Condition``; armed, it is backed by a witness RLock
    so waits and notifies participate in the order graph."""
    if lock is None and ARMED:
        lock = _WitnessRLock(name)
    return threading.Condition(lock)
