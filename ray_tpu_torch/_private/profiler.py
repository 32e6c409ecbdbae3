"""Cluster-wide wall-clock sampling profiler.

Pathways' core observation (PAPERS.md §2) is that per-step dispatch
latency — client-side host time — is the scarce resource of a
single-controller accelerator runtime, and you cannot move time off the critical
path before you can see where it goes *inside a process*.  The flight
recorder (task_events.py) answers "what happened between processes";
this module answers "where did the time go within one": a timer thread
samples ``sys._current_frames()`` at a fixed rate (default 67 Hz —
deliberately co-prime with common 10/50/100 Hz periodic work so the
sampler can't alias against it) and folds every thread's stack into
Brendan-Gregg collapsed form::

    role;pid;thread;frame;frame;...;leaf  count

The first three segments are synthetic root frames (role / pid /
thread-name), so one merged file flamegraphs per role and per process
out of the box.  Frame labels are ``func@file.py:defline`` (def line,
not current line, so a hot function is ONE frame regardless of which
statement the sample lands on).

Sampling is wall-clock: a thread blocked in user-code ``time.sleep`` or
a device ``block_until_ready`` is *spending wall time* and is counted.
Threads parked in the runtime's own wait primitives (epoll/selectors,
``threading`` condition waits, ``queue.get``) are idle scaffolding, not
workload, and are dropped by a leaf-frame filter — otherwise every
process's profile would be dominated by its io loop's epoll frame and a
planted hot function could never dominate its process.

Process model — who runs a sampler:

- every CoreWorker process (drivers, pool workers, actor workers —
  including zygote-forked ones: the env is re-read at ``CoreWorker``
  init, after the fork), the head, raylets, and via them the GCS shard
  loop threads, the serve-engine loop thread, and the dashboard actor
  thread.  Threads may carry their own role label
  (:func:`set_thread_role`: the engine loop registers "engine", the
  dashboard "dashboard") so their stacks aggregate under their own role
  even though they live inside a worker process.
- the zygote *parent* never samples (it must stay single-threaded for
  fork safety, GL001/GL010); its forked children sample normally.

Control plane (``util/profile_api.py``, same shape as chaos_api): a
``PROFILE_CTRL`` RPC to the head arms/disarms cluster-wide — the head
arms itself, stores the control record in KV ``profile:ctrl`` for late
joiners, and fans out over the ``profile`` pubsub channel.  Armed
processes ship folded-stack DELTAS to the head on fire-and-forget
batched ``PROFILE_STATS`` frames (one frame per flush window, never per
sample); the head aggregates per (role, node), exports
``ray_tpu_torch_profiler_samples_total{role,node}`` /
``ray_tpu_torch_profiler_overhead_ratio{role,node}``, and merges sampled-stack
slices into the chrome timeline.

Overhead contract:

- ``RAY_TPU_PROFILER=0``: the plane does not exist — one env read at
  process startup, no subscription, no thread, and (by construction —
  sampling is external to the code) zero stamps on any hot path.
- unset (default): same zero steady-state cost; the process additionally
  subscribes to the ``profile`` channel at startup so a runtime arm can
  reach it.  No sampling until armed.
- ``RAY_TPU_PROFILER=1``: sampling armed from startup at
  ``profiler_hz``.
- armed at the default 67 Hz the sampler must cost ≤5% on the tracked
  ``ray_perf`` pairs — asserted by ``tests/test_profiler.py`` both as a
  wall-clock A/B and on the sampler's own duty-cycle accounting
  (``overhead_s / wall_s``).

Device deep-capture: ``arm(deep=True)`` additionally brackets the armed
window with a ``torch.profiler`` trace (CPU and CUDA activity) on workers —
but only when ``RAY_TPU_PROFILER_DEVICE=1`` opted the worker in AND torch
is *already imported* in that process (the profiler must never be the
thing that imports torch or initialises CUDA).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig

DEFAULT_HZ = 67

# Leaf frames in these STDLIB files are runtime wait scaffolding
# (epoll/select, condition waits, queue gets), not workload wall time.
# Anchored to the actual stdlib directory (full-path match, not bare
# basename) so a user module that merely shares a name — projects ship
# their own queue.py/connection.py all the time — is never dropped.
_STDLIB_DIR = os.path.dirname(threading.__file__)
_IDLE_FILES = frozenset(
    {os.path.join(_STDLIB_DIR, name) for name in (
        "selectors.py",
        "threading.py",
        "queue.py",
        "socket.py",
        "ssl.py",
        "subprocess.py",
    )}
    | {
        # concurrent.futures executor workers block in SimpleQueue.get,
        # which is C-level and leaves no Python frame — an idle executor
        # thread therefore samples with `_worker@thread.py` as its leaf
        # and would otherwise dominate every process holding a pool
        os.path.join(_STDLIB_DIR, "concurrent", "futures", "thread.py"),
        os.path.join(_STDLIB_DIR, "multiprocessing", "connection.py"),
        os.path.join(_STDLIB_DIR, "multiprocessing", "synchronize.py"),
    }
)

_lock = threading.Lock()
_role = "driver"
_hard_off = False  # RAY_TPU_PROFILER=0: the plane does not exist
_initialized = False
_sampler: Optional["_Sampler"] = None
_emitter: Optional[Callable[[dict], None]] = None
_thread_roles: Dict[int, str] = {}  # thread ident -> role override
_deep_active = False
# the last arm ctrl applied (None after disarm): set_thread_role re-applies
# it so a role-filtered arm that arrived BEFORE the thread registered its
# role (e.g. `--role engine` landing while the engine loop is still
# starting) still takes effect once the role exists
_active_ctrl: Optional[dict] = None
# totals from retired sampler generations (disarm folds the current
# sampler's counts in here), so a lifetime view — the RAY_TPU_HEAD_PROFILE
# exit dump — survives mid-run disarm/arm cycles
_retired_totals: Dict[str, int] = {}


# ----------------------------------------------------------------- scope


def maybe_init_from_env(role: str) -> None:
    """Install this process's profiler scope — THE one flag check per
    process startup.  ``RAY_TPU_PROFILER=0`` hard-disables the plane;
    ``1`` arms sampling immediately; unset leaves the process armable at
    runtime over the ``profile`` channel.  Reads the env at call time
    (not import time) so zygote-forked workers see the env their fork
    request installed, not the zygote parent's."""
    global _role, _hard_off, _initialized
    with _lock:
        _role = role
        _hard_off = os.environ.get("RAY_TPU_PROFILER", "") in ("0", "false")
        _initialized = True
    if not _hard_off and os.environ.get("RAY_TPU_PROFILER", "") in ("1", "true"):
        arm(hz=RayConfig.profiler_hz)


def aware() -> bool:
    """Should this process join the profiler control channel?  True
    unless RAY_TPU_PROFILER=0 excised the plane."""
    return not _hard_off


def set_emitter(cb: Optional[Callable[[dict], None]]) -> None:
    """Register the stats sink: the head passes a loop-marshalled local
    ingest, workers/raylets a fire-and-forget PROFILE_STATS send.  Called
    from the sampler thread — must never block or raise."""
    global _emitter
    _emitter = cb


def set_thread_role(role: str, ident: Optional[int] = None) -> None:
    """Tag the calling thread (or ``ident``) with its own role label —
    the engine loop registers "engine", the dashboard "dashboard" — so
    its stacks aggregate under that role instead of the host process's.
    One dict write when nothing is armed; a no-op when the plane is
    hard-off.  If a role-filtered arm already landed (and this process
    sat out because the role didn't exist yet), registering the role
    re-applies it — `--role engine` must work regardless of whether the
    arm or the engine thread came first."""
    if _hard_off:
        return
    with _lock:
        _thread_roles[ident if ident is not None else threading.get_ident()] = role
        ctrl = _active_ctrl
    if ctrl is not None and ctrl.get("roles") and not sampling():
        apply_ctrl(ctrl)


# --------------------------------------------------------------- sampler


def _frame_label(code, cache: Dict[Any, str]) -> str:
    label = cache.get(code)
    if label is None:
        base = os.path.basename(code.co_filename or "?")
        label = f"{code.co_name}@{base}:{code.co_firstlineno}"
        # folded-stack syntax reserves ';' (frame separator) and the last
        # ' ' (count separator)
        label = label.replace(";", ":").replace(" ", "_")
        cache[code] = label
    return label


class _Sampler:
    """The timer thread plus its delta accumulator.  All mutable state is
    owned by the sampler thread; ``snapshot_totals`` reads under the
    instance lock (tests and the local-status path)."""

    def __init__(self, hz: int, roles: Optional[List[str]] = None):
        self.hz = max(1, int(hz))
        self.period = 1.0 / self.hz
        self.roles = list(roles) if roles else None
        self.stop_ev = threading.Event()
        self.lock = threading.Lock()
        self.delta: Dict[str, int] = {}
        self.totals: Dict[str, int] = {}
        self.samples = 0  # retained (non-idle) stack samples, lifetime
        self.idle = 0
        self.overhead_s = 0.0
        self.started_mono = time.monotonic()
        self.window_t0 = time.time()
        self._label_cache: Dict[Any, str] = {}
        self._thread_names: Dict[int, str] = {}
        self.thread = threading.Thread(
            target=self._run, name="ray_tpu_torch-profiler", daemon=True
        )

    def start(self):
        self.thread.start()

    # ------------------------------------------------------------- loop

    def _run(self):
        flush_period = RayConfig.profiler_flush_period_s
        next_flush = time.monotonic() + flush_period
        while not self.stop_ev.wait(self.period):
            t0 = time.perf_counter()
            try:
                self._sample_once()
            except Exception:  # graftlint: disable=silent-except -- a sampler crash must never take its host process's workload down; the overhead accounting below still ships
                pass
            self.overhead_s += time.perf_counter() - t0
            if time.monotonic() >= next_flush:
                self._flush()
                next_flush = time.monotonic() + flush_period
        self._flush()  # disarm: ship the final partial window

    def _thread_name(self, ident: int) -> str:
        name = self._thread_names.get(ident)
        if name is None:
            for t in threading.enumerate():
                self._thread_names[t.ident] = (t.name or "?").replace(
                    ";", ":"
                ).replace(" ", "_")
            name = self._thread_names.get(ident, str(ident))
        return name

    def _sample_once(self):
        me = threading.get_ident()
        frames = sys._current_frames()
        cache = self._label_cache
        with self.lock:
            for tid, frame in frames.items():
                if tid == me:
                    continue
                if frame.f_code.co_filename in _IDLE_FILES:
                    self.idle += 1
                    continue
                role = _thread_roles.get(tid, _role)
                if self.roles is not None and role not in self.roles:
                    continue
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < 128:
                    parts.append(_frame_label(f.f_code, cache))
                    f = f.f_back
                    depth += 1
                parts.reverse()
                key = (
                    f"{role};{os.getpid()};{self._thread_name(tid)};"
                    + ";".join(parts)
                )
                self.delta[key] = self.delta.get(key, 0) + 1
                self.totals[key] = self.totals.get(key, 0) + 1
                self.samples += 1

    def _flush(self):
        self._prune_dead_threads()
        with self.lock:
            delta, self.delta = self.delta, {}
            idle = self.idle
            overhead = self.overhead_s
            t0, self.window_t0 = self.window_t0, time.time()
        if not delta:
            return
        emit = _emitter
        if emit is None:
            return
        wall = max(1e-6, time.monotonic() - self.started_mono)
        try:
            emit(
                {
                    "role": _role,
                    "pid": os.getpid(),
                    "stacks": delta,
                    "samples": sum(delta.values()),
                    "idle": idle,
                    "overhead_s": overhead,
                    "wall_s": wall,
                    "hz": self.hz,
                    "t0": t0,
                    "t1": time.time(),
                }
            )
        except Exception:  # graftlint: disable=silent-except -- stats shipping is best-effort observability; the local totals remain the witness
            pass

    def _prune_dead_threads(self):
        """Drop role overrides and cached names for idents no longer
        alive (once per flush window): CPython recycles thread idents,
        so a stale entry would hand a dead engine/dashboard thread's
        role or name to an unrelated new thread."""
        alive = set(sys._current_frames())
        with self.lock:
            for tid in [t for t in self._thread_names if t not in alive]:
                del self._thread_names[tid]
        with _lock:
            for tid in [t for t in _thread_roles if t not in alive]:
                del _thread_roles[tid]

    def snapshot_totals(self) -> Dict[str, int]:
        with self.lock:
            return dict(self.totals)

    def duty_cycle(self) -> float:
        wall = max(1e-6, time.monotonic() - self.started_mono)
        return self.overhead_s / wall

    def stop(self, join: bool = True):
        self.stop_ev.set()
        if join and self.thread.is_alive():
            self.thread.join(timeout=2.0)


# ------------------------------------------------------------ arm/disarm


def arm(
    hz: Optional[int] = None,
    roles: Optional[List[str]] = None,
    deep: bool = False,
) -> bool:
    """Start sampling in THIS process.  Idempotent for unchanged
    (hz, roles): the cluster arm path arms the driver locally AND echoes
    over pubsub — the echo must not restart the window.  Returns whether
    a sampler is running after the call."""
    global _sampler
    if _hard_off:
        return False
    hz = int(hz or RayConfig.profiler_hz)
    if roles is not None:
        # a process arms when its own role — or a registered thread-role
        # living inside it — is in the filter (set_thread_role re-applies
        # the ctrl if a filtered role registers later)
        with _lock:
            mine = {_role} | set(_thread_roles.values())
        if not (mine & set(roles)):
            disarm()
            return False
    sampler = None
    with _lock:
        cur = _sampler
        if (
            cur is None
            or cur.stop_ev.is_set()
            or cur.hz != hz
            or cur.roles != (list(roles) if roles else None)
        ):
            if cur is not None and not cur.stop_ev.is_set():
                cur.stop(join=False)
                _retire_totals_locked(cur)
            sampler = _Sampler(hz, roles)
            _sampler = sampler
    if sampler is not None:
        sampler.start()
    # outside the idempotence check: a pubsub echo or a re-arm with
    # deep=True on an already-armed process must still start the device
    # trace (a startup-armed RAY_TPU_PROFILER=1 worker would otherwise
    # silently skip --deep forever)
    if deep:
        _maybe_start_device_trace()
    return True


def _retire_totals_locked(sampler: "_Sampler") -> None:
    """Fold a retiring sampler's cumulative counts into the module-level
    lifetime totals (caller holds _lock)."""
    for k, v in sampler.snapshot_totals().items():
        _retired_totals[k] = _retired_totals.get(k, 0) + v


def disarm() -> None:
    global _sampler
    with _lock:
        sampler, _sampler = _sampler, None
        if sampler is not None:
            _retire_totals_locked(sampler)
    if sampler is not None:
        # join=False: disarm may run on a pubsub io thread; the sampler
        # flushes its final window and exits on its own
        sampler.stop(join=False)
    _maybe_stop_device_trace()


def sampling() -> bool:
    s = _sampler
    return s is not None and not s.stop_ev.is_set()


def apply_ctrl(msg: dict) -> None:
    """Apply a profile control message (KV late-join sync or a live
    ``profile`` pubsub push).  Runs on io threads — must never raise."""
    global _active_ctrl
    try:
        op = msg.get("op")
        if op == "arm":
            _active_ctrl = dict(msg)
            arm(
                hz=int(msg.get("hz") or RayConfig.profiler_hz),
                roles=msg.get("roles") or None,
                deep=bool(msg.get("deep")),
            )
        elif op == "disarm":
            _active_ctrl = None
            disarm()
        elif op == "stacks":
            _ship_stack_dump()
        # unknown ops are ignored: an older process must tolerate a newer
        # control vocabulary
    except Exception:  # graftlint: disable=silent-except -- control application must never take down the io thread; status() exposes the armed state for diagnosis
        pass


def status() -> dict:
    s = _sampler
    out = {
        "role": _role,
        "pid": os.getpid(),
        "aware": aware(),
        "sampling": sampling(),
        "deep": _deep_active,
    }
    if s is not None:
        out.update(
            {
                "hz": s.hz,
                "samples": s.samples,
                "idle": s.idle,
                "duty_cycle": s.duty_cycle(),
            }
        )
    return out


def local_totals(lifetime: bool = False) -> Dict[str, int]:
    """This process's cumulative folded stacks (tests / unit mode).
    ``lifetime=True`` additionally folds in retired sampler generations,
    so a mid-run disarm/arm cycle (any `ray-tpu profile snapshot` against
    the cluster) can't empty the RAY_TPU_HEAD_PROFILE exit dump."""
    s = _sampler
    out = dict(s.snapshot_totals()) if s is not None else {}
    if lifetime:
        with _lock:
            for k, v in _retired_totals.items():
                out[k] = out.get(k, 0) + v
    return out


# ------------------------------------------------------- native stack dump


def dump_stacks() -> str:
    """Every thread's current Python stack, formatted — the payload of
    ``ray-tpu stacks`` and the SIGUSR1 faulthandler's in-band sibling."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [f"=== {_role} pid={os.getpid()} ==="]
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} (ident {tid})")
        lines.extend(
            line.rstrip("\n") for line in traceback.format_stack(frame)
        )
    return "\n".join(lines)


def _ship_stack_dump() -> None:
    emit = _emitter
    if emit is None:
        return
    emit(
        {
            "role": _role,
            "pid": os.getpid(),
            "stack_dump": dump_stacks(),
            "t0": time.time(),
        }
    )


def install_sigusr1() -> None:
    """Register the SIGUSR1 all-thread faulthandler dump (shared by
    worker, head, raylet, and dashboard mains): ``kill -USR1 <pid>``
    writes every thread's traceback to the process log — the zero-setup
    tool for "which process is wedged, and where"."""
    import faulthandler
    import signal as _signal

    try:
        faulthandler.register(_signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError, OSError):
        pass  # non-main thread / unsupported platform: debugging aid only


# --------------------------------------------------- device deep capture


_deep_prof = None  # the torch.profiler.profile of the armed window
_deep_logdir = ""


def _maybe_start_device_trace() -> None:
    """torch.profiler trace bracket for the armed window — workers only,
    double-gated: the RAY_TPU_PROFILER_DEVICE env must opt the process in
    AND torch must already be imported there (this module never imports
    torch, so deep capture can never be what initialises CUDA)."""
    global _deep_active, _deep_prof, _deep_logdir
    if _deep_active or _role != "worker":
        return
    if os.environ.get("RAY_TPU_PROFILER_DEVICE", "") not in ("1", "true"):
        return
    torch = sys.modules.get("torch")
    if torch is None:
        return
    _deep_logdir = os.environ.get(
        "RAY_TPU_PROFILER_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch_device_trace", str(os.getpid())),
    )
    try:
        import torch.profiler as tprof

        acts = [tprof.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tprof.ProfilerActivity.CUDA)
        os.makedirs(_deep_logdir, exist_ok=True)
        _deep_prof = tprof.profile(activities=acts)
        _deep_prof.start()
        _deep_active = True
    except Exception:  # graftlint: disable=silent-except -- deep capture is opt-in best-effort; the host-side sampler is the product, status() carries deep=False for diagnosis
        _deep_active = False
        _deep_prof = None


def _maybe_stop_device_trace() -> None:
    global _deep_active, _deep_prof
    if not _deep_active:
        return
    _deep_active = False
    prof, _deep_prof = _deep_prof, None
    if prof is None:
        return
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(_deep_logdir, "trace.json"))
    except Exception:  # graftlint: disable=silent-except -- trace already stopped / runtime torn down; nothing more to collect
        pass


# ----------------------------------------------------------- folded text


def folded_text(stacks: Dict[str, int]) -> str:
    """Render a folded-stack dict as flamegraph.pl-compatible collapsed
    text (one ``stack count`` line, count-descending)."""
    return "\n".join(
        f"{k} {v}"
        for k, v in sorted(stacks.items(), key=lambda kv: -kv[1])
    ) + ("\n" if stacks else "")
