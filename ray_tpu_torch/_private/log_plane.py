"""Structured log capture: the write side of the cluster log plane.

Reference analog: the reference stamps worker stdout/stderr with job /
worker / actor / task identity before it reaches the log files and the
GCS log pubsub (python/ray/_private/ray_logging.py + the worker's
``CoreWorker::SetCurrentTaskId`` context), so `ray logs` and the
dashboard can address lines by entity after the fact.  Here a thin
stream wrapper does the same for every process class: each completed
line becomes ONE structured record — a sentinel byte + compact JSON —
appended to the same per-process log file the raw line used to land in.

Record vocabulary (absent keys mean "not applicable", never null):

    ts      float   unix seconds, stamped at line completion
    job     str     job id hex — read from the running-task context
    node    str     node id hex[:8] ("head" for the head process)
    pid     int
    wid     str     worker id hex[:8] (worker processes only)
    actor   str     actor id hex (while an actor task is running)
    cls     str     actor class name (ditto — drives the (Cls pid=…) prefix)
    task    str     running task id hex
    trace   str     trace id (joins ray_tpu_torch.timeline() as instant markers)
    stream  "out" | "err"
    lvl     str     logging level name (records from the logging handler)
    logger  str     logger name (ditto)
    msg     str     the line, newline stripped

Context is two module dicts merged per line — O(1), no locks, no
syscalls beyond the write itself: ``_static`` is set once at install
(node/pid/wid), ``_task`` is swapped wholesale at task start/end by the
worker runtime (task_context()/clear_task_context()).  A bounded ring of
recent lines feeds crash forensics (the last-K tail shipped inside
ERROR_REPORT records and RayTaskError.log_tail).

Overhead contract when disabled: RAY_TPU_LOG_STRUCTURED=0 makes
install() a no-op — sys.stdout/sys.stderr stay the real streams and the
log files carry today's raw bytes, asserted stamp-free (same convention
as RAY_TPU_TASK_EVENTS=0, _private/task_events.py).
"""

from __future__ import annotations

import io
import json
import logging
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

# ASCII record separator: never appears in sane text output, so raw
# lines and structured records coexist in one file and the parser is a
# one-byte test.  Subprocesses inheriting the log fd bypass the wrapper
# and land raw — the read side treats those as stamp-free records.
SENTINEL = "\x1e"
SENTINEL_B = b"\x1e"

# Separates a head-sealed error string's reason from an appended JSON
# log tail (gcs/server.py seals `"ActorDiedError: reason"` strings into
# return objects; core_worker._error_from_string re-types them and this
# marker carries the victim's forensics across that string round-trip).
LOG_TAIL_MARKER = "\n\x1elog_tail="

# THE flag: capture sites check this module attribute directly (same
# idiom as task_events.enabled) so the disabled path costs one attribute
# load + truth test.
enabled: bool = os.environ.get("RAY_TPU_LOG_STRUCTURED", "1") not in (
    "0",
    "false",
    "",
)


def set_enabled(on: bool) -> None:
    """Flip capture for THIS process (tests / programmatic opt-out).
    Cluster-wide default comes from RAY_TPU_LOG_STRUCTURED in each
    process's environment.  Flipping after install() only gates NEW
    installs — an installed wrapper keeps stamping."""
    global enabled
    enabled = bool(on)


# Set once at install; never mutated per line.
_static: Dict[str, Any] = {}
# Swapped wholesale at task boundaries (assignment is atomic under the
# GIL; the emit path reads whichever dict is current).
_task: Dict[str, Any] = {}
# Crash forensics: last-N completed lines from THIS process, newest
# last.  Feeds ERROR_REPORT.log_tail / RayTaskError.log_tail.
_recent: deque = deque(maxlen=200)

_installed = False


def set_static(**fields) -> None:
    """Per-process identity (node/pid/wid/job) — call once at startup."""
    for k, v in fields.items():
        if v is None:
            _static.pop(k, None)
        else:
            _static[k] = v


def task_context(
    task: Optional[str] = None,
    trace: Optional[str] = None,
    job: Optional[str] = None,
    actor: Optional[str] = None,
    cls: Optional[str] = None,
) -> None:
    """Install the running-task context (worker runtime, at dispatch)."""
    global _task
    ctx: Dict[str, Any] = {}
    if task:
        ctx["task"] = task
    if trace:
        ctx["trace"] = trace
    if job:
        ctx["job"] = job
    if actor:
        ctx["actor"] = actor
    if cls:
        ctx["cls"] = cls
    _task = ctx


def clear_task_context() -> None:
    global _task
    _task = {}


def make_record(stream: str, msg: str, **extra) -> Dict[str, Any]:
    rec = {"ts": time.time(), "stream": stream, "msg": msg}
    rec.update(_static)
    rec.update(_task)
    if extra:
        rec.update(extra)
    return rec


def encode_record(rec: Dict[str, Any]) -> str:
    return SENTINEL + json.dumps(rec, ensure_ascii=False, separators=(",", ":")) + "\n"


def parse_line(line: str) -> Optional[Dict[str, Any]]:
    """One log-file line → record dict, or None if it's a raw line."""
    if not line.startswith(SENTINEL):
        return None
    try:
        rec = json.loads(line[1:])
    except ValueError:
        return None
    return rec if isinstance(rec, dict) and "msg" in rec else None


def recent_tail(k: int) -> List[str]:
    """Last k captured lines (plain text, oldest first) for forensics."""
    if k <= 0:
        return []
    items = list(_recent)
    return items[-k:]


def record_prefix(rec: Dict[str, Any], source: str = "") -> str:
    """The reference's ``(ClassName pid=… node=…)`` driver prefix."""
    who = rec.get("cls") or ("worker" if rec.get("wid") else "")
    pid = rec.get("pid")
    node = rec.get("node")
    if who and pid:
        tail = f" node={node}" if node else ""
        return f"({who} pid={pid}{tail})"
    if pid and node:
        return f"(pid={pid} node={node})"
    return f"({source})" if source else "(?)"


class StructuredStream(io.TextIOBase):
    """Line-buffering wrapper over a real text stream.

    Worker/head/raylet mode (``emit_to=None``): completed lines are
    written to ``raw`` as structured records — the per-process log file
    becomes a record stream.  Driver-tee mode (``emit_to=<file>``): the
    user's terminal sees every byte unchanged (partial lines included —
    progress bars keep working) while completed lines are ALSO appended
    to ``emit_to`` as records, making driver output retrievable by job.
    """

    def __init__(self, raw, stream_name: str, emit_to=None):
        self.raw = raw
        self.stream_name = stream_name
        self.emit_to = emit_to
        self._buf = ""

    def write(self, s) -> int:
        if not isinstance(s, str):
            s = str(s)
        if self.emit_to is not None:
            try:
                self.raw.write(s)
            except (OSError, ValueError):
                pass
        if "\n" not in s:
            self._buf += s
            return len(s)
        data = self._buf + s
        lines = data.split("\n")
        self._buf = lines[-1]
        out = []
        for line in lines[:-1]:
            # a raw line that is itself a record (nested wrap, subprocess
            # re-emitting captured output) passes through unchanged
            # rather than being double-wrapped
            if line.startswith(SENTINEL):
                out.append(line + "\n")
                continue
            _recent.append(line)
            out.append(encode_record(make_record(self.stream_name, line)))
        sink = self.emit_to if self.emit_to is not None else self.raw
        try:
            sink.write("".join(out))
            sink.flush()
        except (OSError, ValueError):
            pass  # sink gone (shutdown / rotated-away tee): drop, never raise into user code
        return len(s)

    def flush(self) -> None:
        try:
            self.raw.flush()
        except (OSError, ValueError):
            pass
        if self.emit_to is not None:
            try:
                self.emit_to.flush()
            except (OSError, ValueError):
                pass

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    # pass fd-level surface through so code doing sys.stdout.fileno()
    # (subprocess wiring, os.dup2) keeps talking to the real stream
    def fileno(self) -> int:
        return self.raw.fileno()

    def isatty(self) -> bool:
        try:
            return self.raw.isatty()
        except (OSError, ValueError):
            return False

    @property
    def encoding(self):
        return getattr(self.raw, "encoding", "utf-8")

    @property
    def errors(self):
        return getattr(self.raw, "errors", "strict")

    def writable(self) -> bool:
        return True


class LogPlaneHandler(logging.Handler):
    """Library-code path: logging records become structured records with
    level + logger name, bypassing the line wrapper (no double stamp —
    the handler writes records directly)."""

    def __init__(self, sink):
        super().__init__()
        self._sink = sink

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            for line in msg.split("\n"):
                _recent.append(line)
                rec = make_record(
                    "err", line, lvl=record.levelname, logger=record.name
                )
                self._sink.write(encode_record(rec))
            self._sink.flush()
        except Exception:  # graftlint: disable=silent-except -- a logging handler must never raise back into the caller (stdlib Handler.emit contract), and logging the failure from inside the log path would recurse
            pass


def install(
    node: Optional[str] = None,
    wid: Optional[str] = None,
    job: Optional[str] = None,
    logging_handler: bool = True,
    wrap_stdout: bool = True,
) -> bool:
    """Wrap this process's stdout/stderr for structured capture.

    No-op (returns False) when RAY_TPU_LOG_STRUCTURED=0 or already
    installed.  Worker/head/raylet call sites: output goes to the
    per-process log file as records.  ``wrap_stdout=False`` leaves
    sys.stdout untouched for processes whose stdout is a protocol
    channel, not a log (the head's ``PORT <n>`` handshake pipe).
    """
    global _installed
    if not enabled or _installed:
        return False
    set_static(node=node, wid=wid, job=job, pid=os.getpid())
    raw_err = sys.stderr
    if wrap_stdout:
        sys.stdout = StructuredStream(sys.stdout, "out")
    sys.stderr = StructuredStream(raw_err, "err")
    if logging_handler:
        # library code logging below WARNING never reached the files
        # before; route everything a logger emits through the plane at
        # its configured level, writing records straight to the raw
        # stream (the wrapper would stamp them again)
        logging.getLogger().addHandler(LogPlaneHandler(raw_err))
    _installed = True
    return True


def install_driver_tee(path: str, job: Optional[str] = None) -> bool:
    """Driver capture: terminal bytes unchanged, records teed to `path`
    so driver output is retrievable by job like any worker's."""
    global _installed
    if not enabled or _installed:
        return False
    try:
        sink = open(path, "a", encoding="utf-8")  # graftlint: disable=resource-hygiene -- handed to the StructuredStream wrappers below as emit_to; owned for the process lifetime, closed by uninstall()
    except OSError:
        return False
    set_static(job=job, pid=os.getpid())
    sys.stdout = StructuredStream(sys.stdout, "out", emit_to=sink)
    sys.stderr = StructuredStream(sys.stderr, "err", emit_to=sink)
    _installed = True
    return True


def uninstall() -> None:
    """Test hook: unwind the wrappers installed by install()/tee."""
    global _installed
    for name in ("stdout", "stderr"):
        stream = getattr(sys, name)
        if isinstance(stream, StructuredStream):
            if stream.emit_to is not None:
                try:
                    stream.emit_to.close()
                except OSError:
                    pass
            setattr(sys, name, stream.raw)
    root = logging.getLogger()
    for h in list(root.handlers):
        if isinstance(h, LogPlaneHandler):
            root.removeHandler(h)
    _installed = False
    _task.clear()
    _static.clear()
    _recent.clear()
