"""Deterministic, seed-driven fault injection across the three planes.

The recovery machinery this runtime ships (task retry, the actor FSM,
lineage reconstruction, WAL replay — PAPERS.md §1 Ray OSDI'18) is only
trustworthy if it is *exercised under injected failure*, not just hit
incidentally.  This module is the injection substrate:

- **wire plane**: named points in ``Connection.send/request/read_frame``
  (`wire.send.*`, `wire.request.*`, `wire.read.*`) that drop, delay,
  duplicate, or sever frames per :class:`MsgType` with a configured
  probability.
- **process plane**: kill/suspend helpers (:func:`kill_process`,
  :func:`suspend_process`) that tests drive through
  :mod:`ray_tpu_torch.util.chaos_api` to force actor restart, task retry, and
  replica respawn on demand.
- **disk plane**: points in the GCS WAL (`disk.wal.append.*`,
  `disk.wal.fsync.*`) and the spill path (`disk.spill.write.*`,
  `disk.spill.read.*`) for ENOSPC, torn writes, and slow IO.

Configuration rides :class:`RayConfig` (``RAY_TPU_CHAOS_SEED``,
``RAY_TPU_CHAOS_PLAN``, ``RAY_TPU_CHAOS_ENABLE`` env), so a plan set
before ``ray_tpu_torch.init()`` reaches every spawned process, and a runtime
control RPC (``MsgType.CHAOS_CTRL``) lets tests arm/disarm faults
cluster-wide from the driver.  Grammar, knobs, and the determinism
contract are documented in ``ray_tpu_torch/_private/CHAOS.md``.

Determinism contract: every (rule, process-scope) pair owns an
independent RNG stream seeded from ``(seed, role, nonce, point, action,
filter, rule-index)``.  The k-th operation matching a rule in a given
process scope therefore gets the same verdict on every run — same seed
+ same plan + same per-stream operation sequence ⇒ same fault sequence.
Cross-stream interleaving is NOT part of the contract.

When nothing is armed, every injection point compiles down to one module
attribute check (``chaos.wire_on`` / ``chaos.disk_on``), keeping the hot
paths unmeasurably close to free.

Alongside injection lives :class:`Backoff` — exponential backoff with
full jitter, the single retry-discipline implementation shared by
connect retry, head-object pulls, and anything else that must not
thundering-herd a recovering component (PAPERS.md §2, Pathways
MLSys'22).
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import signal
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig

logger = logging.getLogger(__name__)

_ROLES = ("driver", "worker", "raylet", "head")

# wire frames that must never be injected: the observability and control
# channels chaos itself rides on (values mirror protocol.MsgType
# RECORD_EVENT/CHAOS_CTRL; protocol.py owns the authoritative exemption
# set — this one covers direct users of wire_decide)
EXEMPT_MSG_TYPES = frozenset({78, 95})

# Module-level cheap flags consulted by the injection points.  False by
# default: the disabled path is one attribute load + branch.
wire_on = False
disk_on = False


# --------------------------------------------------------------------- backoff


class Backoff:
    """Exponential backoff with full jitter — the one retry discipline.

    delay_k = uniform(0, min(cap, base * factor**k)) (the "full jitter"
    schedule): retries from many clients spread instead of synchronizing
    into a thundering herd against a restarting component.

    ``next_delay()`` returns the next sleep in seconds, or ``None`` once
    the budget (``max_attempts`` and/or ``deadline_s``) is exhausted —
    callers sleep and retry while it returns a number.  ``max_attempts``
    bounds the number of delays GRANTED, i.e. retries — a caller making
    one initial attempt plus retries performs ``max_attempts + 1`` total
    attempts.  Pass a seeded ``rng`` for a deterministic schedule (the
    chaos suite asserts this).
    """

    def __init__(
        self,
        base: float = 0.05,
        factor: float = 2.0,
        cap: float = 2.0,
        max_attempts: Optional[int] = None,
        deadline_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ):
        self.base = base
        self.factor = factor
        self.cap = cap
        self.max_attempts = max_attempts
        self.deadline = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        self.attempt = 0
        self._rng = rng if rng is not None else random

    def next_delay(self) -> Optional[float]:
        self.attempt += 1
        if self.max_attempts is not None and self.attempt > self.max_attempts:
            return None
        if self.deadline is not None and time.monotonic() >= self.deadline:
            return None
        ceiling = min(self.cap, self.base * self.factor ** (self.attempt - 1))
        delay = self._rng.random() * ceiling
        if self.deadline is not None:
            delay = min(delay, max(0.0, self.deadline - time.monotonic()))
        return delay

    def next_delay_or(self, floor: float) -> float:
        """next_delay() with budget-exhaustion mapped to ``floor``.  A
        full-jitter sample can legitimately be 0.0 — callers using
        ``next_delay() or floor`` would silently coerce those to the
        floor, burning wall-clock their redial window can't spare."""
        d = self.next_delay()
        return floor if d is None else d


# ------------------------------------------------------------------ fault plan


class Rule:
    """One parsed plan entry: ``[role:]point.action[@MSG][#N]=rate[:param]``."""

    __slots__ = (
        "point",
        "action",
        "role",
        "msg_filter",
        "msg_value",
        "max_fires",
        "rate",
        "param",
        "fires",
        "index",
        "rng",
    )

    def __init__(
        self,
        point: str,
        action: str,
        role: Optional[str],
        msg_filter: Optional[str],
        max_fires: Optional[int],
        rate: float,
        param: float,
        index: int,
    ):
        self.point = point
        self.action = action
        self.role = role
        self.msg_filter = msg_filter
        self.msg_value: Optional[int] = None  # resolved lazily at arm time
        self.max_fires = max_fires
        self.rate = rate
        self.param = param
        self.fires = 0
        self.index = index
        self.rng: Optional[random.Random] = None


# point -> actions it supports (documentation + parse-time validation)
_POINT_ACTIONS: Dict[str, Tuple[str, ...]] = {
    "wire.send": ("drop", "delay", "dup", "sever"),
    "wire.request": ("fail", "delay"),
    "wire.read": ("drop", "delay", "sever"),
    "disk.wal.append": ("fail", "short", "delay"),
    "disk.wal.fsync": ("fail", "skip", "delay"),
    "disk.wal.compact": ("fail", "short", "delay"),
    "disk.spill.write": ("fail", "short", "delay"),
    "disk.spill.read": ("fail", "delay"),
}


def parse_plan(plan: str) -> List[Rule]:
    """Parse a plan string into rules.  Entries are ``;``/``,`` separated:

        worker:wire.send.sever@TASK_DONE#1=1.0
        disk.wal.fsync.fail=0.5
        wire.send.delay@HEARTBEAT=0.3:0.05

    Raises ``ValueError`` on malformed entries — a chaos plan with a typo
    must fail the test loudly, not silently inject nothing.
    """
    rules: List[Rule] = []
    for idx, raw in enumerate(
        e.strip() for chunk in plan.split(";") for e in chunk.split(",")
    ):
        if not raw:
            continue
        if "=" not in raw:
            raise ValueError(f"chaos plan entry {raw!r}: missing '=rate'")
        lhs, rhs = raw.split("=", 1)
        role = None
        if ":" in lhs:
            role, lhs = lhs.split(":", 1)
            if role not in _ROLES:
                raise ValueError(f"chaos plan entry {raw!r}: unknown role {role!r}")
        max_fires = None
        if "#" in lhs:
            lhs, max_s = lhs.rsplit("#", 1)
            max_fires = int(max_s)
        msg_filter = None
        if "@" in lhs:
            lhs, msg_filter = lhs.split("@", 1)
        point, _, action = lhs.rpartition(".")
        if point not in _POINT_ACTIONS:
            raise ValueError(f"chaos plan entry {raw!r}: unknown point {point!r}")
        if action not in _POINT_ACTIONS[point]:
            raise ValueError(
                f"chaos plan entry {raw!r}: point {point!r} has no action "
                f"{action!r} (supports {_POINT_ACTIONS[point]})"
            )
        if msg_filter is not None and not point.startswith("wire."):
            raise ValueError(f"chaos plan entry {raw!r}: @MSG filter is wire-only")
        parts = rhs.split(":", 1)
        rate = float(parts[0])
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos plan entry {raw!r}: rate must be in [0, 1]")
        param = float(parts[1]) if len(parts) > 1 else 0.05
        rules.append(Rule(point, action, role, msg_filter, max_fires, rate, param, idx))
    return rules


def stream_seed(
    seed: int,
    role: str,
    nonce: int,
    point: str,
    action: str,
    msg_filter: Optional[str],
    index: int,
) -> int:
    """Stable per-(rule, process-scope) RNG seed — the determinism anchor.
    Exposed so tests can predict verdicts and pick seeds that produce a
    wanted fail/succeed pattern across worker nonces."""
    key = f"{seed}/{role}/{nonce}/{point}.{action}@{msg_filter}/{index}"
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")


def stream_rng(
    seed: int,
    role: str,
    nonce: int,
    point: str,
    action: str,
    msg_filter: Optional[str] = None,
    index: int = 0,
) -> random.Random:
    return random.Random(stream_seed(seed, role, nonce, point, action, msg_filter, index))


# ------------------------------------------------------------------ controller


class ChaosController:
    """Holds the armed plan and makes (deterministic) fault decisions.

    Thread-safe: decisions come from io threads, user threads, and
    executor threads alike.  The fired-fault log is the process-local
    determinism witness (``fired()``); cluster-wide visibility rides the
    emitter callback (RECORD_EVENT → the head's event ring)."""

    def __init__(self, plan: str, seed: int, role: str, nonce: int):
        self.plan = plan
        self.seed = seed
        self.role = role
        self.nonce = nonce
        self._lock = threading.Lock()
        self._seq = 0
        self._log: deque = deque(maxlen=10000)
        self._rules: Dict[str, List[Rule]] = {}
        for rule in parse_plan(plan):
            if rule.role is not None and rule.role != role:
                continue  # other-role rules never fire here: drop at arm time
            rule.rng = stream_rng(
                seed, role, nonce, rule.point, rule.action, rule.msg_filter, rule.index
            )
            self._rules.setdefault(rule.point, []).append(rule)

    @property
    def wire_rules(self) -> bool:
        return any(p.startswith("wire.") for p in self._rules)

    @property
    def disk_rules(self) -> bool:
        return any(p.startswith("disk.") for p in self._rules)

    def _resolve_filter(self, rule: Rule) -> Optional[int]:
        if rule.msg_filter is None:
            return None
        if rule.msg_value is None:
            # lazy: protocol imports this module, so the reverse import must
            # happen after module load, and only for filtered wire rules
            from ray_tpu_torch._private.protocol import MsgType

            rule.msg_value = int(MsgType[rule.msg_filter])
        return rule.msg_value

    def decide(
        self, point: str, msg_type: Optional[int] = None
    ) -> Optional[Tuple[str, float]]:
        """First matching rule that draws a fire wins.  Each rule's RNG
        advances exactly once per operation matching its filter, so the
        verdict sequence per stream is reproducible."""
        fired = None
        with self._lock:
            for rule in self._rules.get(point, ()):
                if rule.msg_filter is not None and msg_type != self._resolve_filter(rule):
                    continue
                if rule.max_fires is not None and rule.fires >= rule.max_fires:
                    continue
                if rule.rng.random() >= rule.rate:
                    continue
                rule.fires += 1
                self._seq += 1
                fired = {
                    "seq": self._seq,
                    "point": point,
                    "action": rule.action,
                    "msg_type": msg_type,
                    "param": rule.param,
                }
                self._log.append(fired)
                verdict = (rule.action, rule.param)
                break
            else:
                return None
        _emit(fired)
        return verdict

    def fired(self) -> List[dict]:
        with self._lock:
            return list(self._log)

    def status(self) -> dict:
        with self._lock:
            return {
                "plan": self.plan,
                "seed": self.seed,
                "role": self.role,
                "nonce": self.nonce,
                "fired": self._seq,
            }


# ------------------------------------------------------------ module singleton

_ctl: Optional[ChaosController] = None
_role = "driver"
_nonce = 0
_emitter: Optional[Callable[[dict], None]] = None


def set_scope(role: str, nonce: Optional[int] = None) -> None:
    global _role, _nonce
    _role = role
    if nonce is not None:
        _nonce = nonce


def maybe_init_from_env(role: str) -> None:
    """Install this process's chaos scope and arm a plan if the config
    (env / _system_config) carries one.  Called once per process at
    runtime bring-up (CoreWorker init, raylet run, head start); a no-op
    beyond scope bookkeeping when no plan is configured."""
    set_scope(role, int(os.environ.get("RAY_TPU_CHAOS_NONCE", "0") or 0))
    plan = RayConfig.chaos_plan
    if plan:
        arm(plan, RayConfig.chaos_seed)


def aware() -> bool:
    """Should this process join the runtime chaos control channel?"""
    return bool(RayConfig.chaos_enable or RayConfig.chaos_plan)


def armed() -> bool:
    return _ctl is not None


def arm(plan: str, seed: int = 0) -> None:
    """Arm fault injection in THIS process.  Idempotent for an unchanged
    (plan, seed, scope): the cluster arm path both arms the driver locally
    AND echoes the plan back over pubsub — the echo must not reset RNG
    streams, #N fire budgets, or the fired() log mid-test.  To restart
    determinism from scratch, disarm() first."""
    global _ctl, wire_on, disk_on
    prev = _ctl
    if (
        prev is not None
        and prev.plan == plan
        and prev.seed == seed
        and prev.role == _role
        and prev.nonce == _nonce
    ):
        return
    ctl = ChaosController(plan, seed, _role, _nonce)
    _ctl = ctl
    wire_on = ctl.wire_rules
    disk_on = ctl.disk_rules
    logger.info(
        "chaos armed (role=%s nonce=%d seed=%d): %s", _role, _nonce, seed, plan
    )


def disarm() -> None:
    global _ctl, wire_on, disk_on
    _ctl = None
    wire_on = False
    disk_on = False


def apply_ctrl(msg: dict) -> None:
    """Apply a chaos control message (KV late-join sync or a live
    ``chaos`` pubsub push).  Runs on io threads — must never raise."""
    try:
        op = msg.get("op")
        if op == "arm":
            arm(str(msg.get("plan", "")), int(msg.get("seed", 0)))
        elif op == "disarm":
            disarm()
        else:
            logger.warning("ignoring unknown chaos control op %r", op)
    except Exception:  # noqa: BLE001
        logger.exception("invalid chaos control message %r", msg)


def set_emitter(cb: Optional[Callable[[dict], None]]) -> None:
    """Register the structured-event sink for fired faults.  The head
    passes its ``_record_event``; workers/raylets pass a fire-and-forget
    RECORD_EVENT send (exempt from injection, so emission can't recurse).
    Best-effort by design: a sever/kill fault can take the emitting
    channel down with it — the process-local ``fired()`` log is the
    authoritative witness."""
    global _emitter
    _emitter = cb


def _emit(fired: Optional[dict]) -> None:
    if fired is None or _emitter is None:
        return
    msg_type = fired.get("msg_type")
    detail = f"@{msg_type}" if msg_type is not None else ""
    try:
        _emitter(
            {
                "message": f"chaos fault fired: {fired['point']}.{fired['action']}{detail}",
                "fields": {
                    "point": fired["point"],
                    "action": fired["action"],
                    "fault_seq": fired["seq"],
                    "msg_type": msg_type,
                },
            }
        )
    except Exception:  # noqa: BLE001
        logger.exception("chaos event emitter raised")


def fired() -> List[dict]:
    """Process-local fired-fault log (the determinism witness)."""
    return _ctl.fired() if _ctl is not None else []


def status() -> dict:
    return _ctl.status() if _ctl is not None else {"plan": "", "fired": 0}


# ------------------------------------------------------------ injection probes


def wire_decide(point: str, msg_type: int) -> Optional[Tuple[str, float]]:
    """Verdict for one wire operation; None = proceed untouched.  Callers
    gate on the module flag first (``if chaos.wire_on``) so the disabled
    path stays a single attribute check."""
    ctl = _ctl
    if ctl is None or msg_type in EXEMPT_MSG_TYPES:
        return None
    return ctl.decide(point, msg_type)


def disk_decide(point: str) -> Optional[Tuple[str, float]]:
    ctl = _ctl
    if ctl is None:
        return None
    return ctl.decide(point)


# ------------------------------------------------------------- process plane


def kill_process(pid: int, sig: int = signal.SIGKILL) -> bool:
    """Chaos kill: deliver `sig` (default SIGKILL — no cleanup, the crash
    the FSM must absorb).  Returns False if the pid is already gone."""
    try:
        os.kill(pid, sig)
        return True
    except OSError:
        logger.info("chaos kill_process(%d): already gone", pid)
        return False


def suspend_process(pid: int) -> bool:
    """SIGSTOP-based stall: the process keeps its sockets open but goes
    silent — exactly the wedged-but-connected shape heartbeat expiry
    exists to catch."""
    try:
        os.kill(pid, signal.SIGSTOP)
        return True
    except OSError:
        logger.info("chaos suspend_process(%d): already gone", pid)
        return False


def resume_process(pid: int) -> bool:
    try:
        os.kill(pid, signal.SIGCONT)
        return True
    except OSError:
        logger.info("chaos resume_process(%d): already gone", pid)
        return False


def point_catalog() -> Dict[str, Tuple[str, ...]]:
    """The named injection points and their supported actions (the
    contract CHAOS.md documents; tests assert doc/code agreement)."""
    return dict(_POINT_ACTIONS)
