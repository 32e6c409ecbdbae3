"""Log plane, read side: tailing, rotation, retrieval, driver sink.

Analog of the reference's log_monitor process (reference:
python/ray/_private/log_monitor.py — tails per-process files in the
session tmp dir and publishes via GCS pubsub; the driver prints them
with a (pid=…) prefix).  Here a tailer thread runs inside the head
process (and inside each raylet for its node's workers) publishing to
the ``logs`` pubsub channel; drivers subscribe at init when
log_to_driver.

v2 (util/OBSERVABILITY.md "Logs"):

* Lines are parsed into structured records (_private/log_plane.py
  sentinel + JSON; raw lines become minimal ``{"msg": …}`` records), so
  the head can scope streaming per job — two concurrent drivers each
  see only their own workers' lines.
* The tailer owns size-capped rotation (``log_rotation_bytes`` /
  ``log_rotation_backups``): copytruncate, safe because every writer
  opens the log O_APPEND.
* ``tail_file_records`` / ``read_new_records`` are the per-node log
  agent's disk reads behind the LOG_FETCH RPC — tail-N across the
  rotation seam, then cursor-ranged follow reads.
* ``DriverLogSink`` is the driver's flood-controlled printer:
  consecutive identical lines collapse into one ``… repeated N×`` line
  and a per-source token bucket caps sustained line rate, so a worker
  stuck in a print loop can't wedge every driver's terminal.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import log_plane


def _to_record(line: str, src: str) -> dict:
    """One decoded log line → record dict (raw lines stay stamp-free)."""
    rec = log_plane.parse_line(line)
    if rec is None:
        rec = {"msg": line}
    rec["src"] = src
    return rec


class LogTailer(threading.Thread):
    """Polls ``<dir>/<pattern>`` files, publishes new complete lines via
    ``publish({source, lines, records})``, and rotates any file that
    grows past ``rotation_bytes`` (0 = rotation off)."""

    def __init__(
        self,
        log_dir: str,
        publish: Callable[[dict], None],
        pattern: str = "worker-*.log",
        poll_s: float = 0.5,
        rotation_bytes: int = 0,
        rotation_backups: int = 2,
    ):
        super().__init__(name="log-monitor", daemon=True)
        self.log_dir = log_dir
        self.patterns = [p for p in pattern.split("|") if p]
        self.publish = publish
        self.poll_s = poll_s
        self.rotation_bytes = int(rotation_bytes)
        self.rotation_backups = max(1, int(rotation_backups))
        self.stopped = threading.Event()
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}

    def run(self):
        last_err = None
        while not self.stopped.wait(self.poll_s):
            try:
                self.scan_once()
                last_err = None
            except Exception as e:  # noqa: BLE001
                # keep tailing on transient scan errors (rotated file,
                # session dir teardown) — leave a trace, but only once per
                # distinct error so a persistent failure doesn't flood
                # stderr at the poll rate
                err = f"{type(e).__name__}: {e}"
                if err != last_err:
                    last_err = err
                    traceback.print_exc(file=sys.stderr)

    def _paths(self) -> List[str]:
        out: List[str] = []
        for pat in self.patterns:
            out.extend(glob.glob(os.path.join(self.log_dir, pat)))
        return out

    def scan_once(self):
        for path in self._paths():
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(path, 0)
            if off > size:
                # the file shrank under us (rotation, `>` truncation):
                # the stored offset points past EOF and v1 silently read
                # nothing forever.  Restart from 0 and drop the stale
                # partial-line buffer — it belongs to bytes that no
                # longer exist.
                off = 0
                self._offsets[path] = 0
                self._partial.pop(path, None)
            if size <= off:
                continue
            try:
                # binary reads: byte offsets never drift on multibyte
                # characters split across polls (decode happens per line)
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            self._offsets[path] = off + len(chunk)
            data = self._partial.pop(path, b"") + chunk
            parts = data.split(b"\n")
            if parts and parts[-1] != b"":
                self._partial[path] = parts[-1]
            src = os.path.basename(path)
            records = [
                _to_record(p.decode("utf-8", errors="replace"), src)
                for p in parts[:-1]
                if p
            ]
            if records:
                self.publish(
                    {
                        "source": src,
                        "lines": [r["msg"] for r in records],
                        "records": records,
                    }
                )
            if self.rotation_bytes and self._offsets[path] >= self.rotation_bytes:
                self._rotate(path)

    def _rotate(self, path: str):
        """Copytruncate rotation — the ONLY safe scheme here, because
        writers hold O_APPEND fds to `path` (a rename would carry their
        fds to the renamed inode and the live file would never shrink).
        The tailer does the rotating precisely because it just consumed
        to EOF: the unavoidable copy→truncate race window only covers
        bytes appended in the microseconds between the final read below
        and the truncate."""
        try:
            for i in range(self.rotation_backups - 1, 0, -1):
                b = f"{path}.{i}"
                if os.path.exists(b):
                    os.replace(b, f"{path}.{i + 1}")
            # drain any bytes that landed since scan_once's read so the
            # backup is complete up to the truncate point
            off = self._offsets.get(path, 0)
            with open(path, "rb") as f:
                f.seek(off)
                late = f.read()
            if late:
                data = self._partial.pop(path, b"") + late
                parts = data.split(b"\n")
                if parts and parts[-1] != b"":
                    self._partial[path] = parts[-1]
                src = os.path.basename(path)
                records = [
                    _to_record(p.decode("utf-8", errors="replace"), src)
                    for p in parts[:-1]
                    if p
                ]
                if records:
                    self.publish(
                        {
                            "source": src,
                            "lines": [r["msg"] for r in records],
                            "records": records,
                        }
                    )
            with open(path, "rb") as fsrc, open(f"{path}.1", "wb") as fdst:
                while True:
                    buf = fsrc.read(1 << 20)
                    if not buf:
                        break
                    fdst.write(buf)
            os.truncate(path, 0)
            self._offsets[path] = 0
        except OSError:
            pass  # rotation is best-effort; the tailer keeps tailing

    def stop(self):
        self.stopped.set()


# ---------------------------------------------------------------------------
# Log agent disk reads (behind the LOG_FETCH RPC)
# ---------------------------------------------------------------------------

# fresh tail reads are bounded: never pull more than this many bytes per
# file off disk for a tail-N request, however large the rotated chain is
_TAIL_READ_CAP = 4 << 20


def rotation_chain(path: str, backups: int = 9) -> List[str]:
    """`path`'s rotated chain, oldest first: path.N … path.1, path."""
    chain = [
        f"{path}.{i}" for i in range(backups, 0, -1) if os.path.exists(f"{path}.{i}")
    ]
    chain.append(path)
    return chain


def _read_tail_lines(path: str, max_bytes: int) -> List[str]:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            off = max(0, size - max_bytes)
            f.seek(off)
            data = f.read()
    except OSError:
        return []
    lines = data.split(b"\n")
    if off > 0 and lines:
        lines = lines[1:]  # drop the partial line the seek landed in
    return [ln.decode("utf-8", errors="replace") for ln in lines if ln]


def _matcher(grep: Optional[str]) -> Callable[[str], bool]:
    if not grep:
        return lambda s: True
    try:
        pat = re.compile(grep)
        return lambda s: pat.search(s) is not None
    except re.error:
        return lambda s: grep in s


def tail_file_records(
    paths: List[str],
    tail: int = 100,
    grep: Optional[str] = None,
    job: Optional[str] = None,
) -> Tuple[List[dict], Dict[str, int]]:
    """Tail-N across files (each read across its rotation seam).  Returns
    (records oldest-first, cursor {live_path: size}) — the cursor is
    what a follow poll passes to read_new_records."""
    match = _matcher(grep)
    records: List[dict] = []
    cursor: Dict[str, int] = {}
    for path in paths:
        src = os.path.basename(path)
        per_file: List[dict] = []
        for link in rotation_chain(path):
            for line in _read_tail_lines(link, _TAIL_READ_CAP):
                rec = _to_record(line, src)
                if job and rec.get("job") and rec["job"] != job:
                    continue
                if not match(rec["msg"]):
                    continue
                per_file.append(rec)
        records.extend(per_file[-tail:] if tail > 0 else per_file)
        try:
            cursor[path] = os.path.getsize(path)
        except OSError:
            cursor[path] = 0
    # interleave by stamp where we have one; raw records sort stably at
    # their file position (ts 0 keeps them ahead — the common case is a
    # single-file read where order is already right)
    if len(paths) > 1:
        records.sort(key=lambda r: r.get("ts", 0.0))
    if tail and len(records) > tail:
        records = records[-tail:]
    return records, cursor


def read_new_records(
    cursor: Dict[str, int],
    grep: Optional[str] = None,
    job: Optional[str] = None,
) -> Tuple[List[dict], Dict[str, int]]:
    """Follow poll: everything appended past `cursor`, plus the advanced
    cursor.  A file that shrank (rotation) restarts from 0."""
    match = _matcher(grep)
    records: List[dict] = []
    new_cursor: Dict[str, int] = {}
    for path, off in cursor.items():
        src = os.path.basename(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            new_cursor[path] = 0
            continue
        off = int(off)
        if off > size:
            off = 0  # rotated under the cursor
        if size > off:
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
            except OSError:
                new_cursor[path] = off
                continue
            # only complete lines advance the cursor: a partial tail line
            # is re-read whole on the next poll
            end = data.rfind(b"\n")
            if end < 0:
                new_cursor[path] = off
                continue
            for raw in data[: end + 1].split(b"\n"):
                if not raw:
                    continue
                rec = _to_record(raw.decode("utf-8", errors="replace"), src)
                if job and rec.get("job") and rec["job"] != job:
                    continue
                if match(rec["msg"]):
                    records.append(rec)
            new_cursor[path] = off + end + 1
        else:
            new_cursor[path] = off
    return records, new_cursor


# ---------------------------------------------------------------------------
# Driver sink: prefixes + flood control
# ---------------------------------------------------------------------------


class DriverLogSink:
    """Flood-controlled printer for the driver's ``logs`` subscription.

    Two independent guards, both off the hot path (they run in the
    driver, per delivered line, never in the producing worker):

    * collapse — consecutive identical lines from one source print once,
      then one ``… repeated N×`` line when the run breaks;
    * rate cap — a per-source token bucket (``rate_lines_s`` sustained,
      2× burst) drops the excess and prints one ``… N lines suppressed``
      notice when the flood subsides.
    """

    def __init__(
        self,
        write: Optional[Callable[[str], None]] = None,
        rate_lines_s: int = 1000,
        now: Callable[[], float] = time.monotonic,
    ):
        self._write = write or (lambda s: print(s, flush=True))
        self.rate = max(1, int(rate_lines_s))
        self.burst = self.rate * 2
        self._now = now
        # per-source: [last_line, repeat_count, tokens, last_refill, suppressed]
        self._state: Dict[str, list] = {}

    def feed(self, msg: dict) -> None:
        source = msg.get("source", "worker")
        records = msg.get("records")
        if records is None:
            records = [{"msg": ln} for ln in msg.get("lines", [])]
        for rec in records:
            self._feed_one(source, rec)

    def _feed_one(self, source: str, rec: dict) -> None:
        st = self._state.get(source)
        if st is None:
            st = self._state[source] = [None, 0, float(self.burst), self._now(), 0]
        prefix = log_plane.record_prefix(rec, source)
        line = f"{prefix} {rec['msg']}"
        # collapse identical runs before spending tokens: a print loop
        # repeating one line costs one token per run, not per line
        if line == st[0]:
            st[1] += 1
            return
        self._break_run(st)
        st[0] = line
        st[1] = 0
        # token bucket
        now = self._now()
        st[2] = min(float(self.burst), st[2] + (now - st[3]) * self.rate)
        st[3] = now
        if st[2] < 1.0:
            st[4] += 1
            return
        st[2] -= 1.0
        if st[4]:
            self._write(f"… {st[4]} line(s) suppressed (rate limit) …")
            st[4] = 0
        self._write(line)

    def _break_run(self, st: list) -> None:
        if st[1] > 0:
            self._write(f"… repeated {st[1] + 1}×")
            st[1] = 0

    def flush(self) -> None:
        """Emit any pending repeat summaries (shutdown / test boundary)."""
        for st in self._state.values():
            self._break_run(st)


def print_log_message(msg: dict):
    """Driver-side default sink: the reference's (pid=…) prefix style.
    Kept for non-flood-controlled consumers; structured records get the
    (ClassName pid=… node=…) prefix, raw lines the v1 (source) prefix."""
    src = msg.get("source", "worker")
    records = msg.get("records")
    if records is None:
        records = [{"msg": ln} for ln in msg.get("lines", [])]
    for rec in records:
        print(f"{log_plane.record_prefix(rec, src)} {rec['msg']}", flush=True)
