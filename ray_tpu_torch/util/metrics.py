"""Application metrics: Counter/Gauge/Histogram.

Analog of the reference's ray.util.metrics (reference:
python/ray/util/metrics.py backed by the Cython Metric → opencensus →
per-node agent → Prometheus).  Values aggregate in the head KV under
``metrics:*`` keys; the state API and CLI read them; a Prometheus-format
dump is exposed via `prometheus_text()` and served by every node's
metrics agent (raylet/metrics_agent.py).

Concurrency model: each process writes ONLY its own series — the KV key
carries a per-process suffix (this worker's id), so the read-modify-write
in ``_store`` races with nobody.  ``read_all()`` merges the per-process
series back into one logical series per (metric, tags): counters and
histograms sum, gauges take the freshest write.  This is the same
split-then-merge shape the reference gets from per-worker opencensus
exporters aggregated by the node agent, and it closes the lost-update
race two workers hit when they shared one KV record.

Histograms track real bucket counts against their declared boundaries and
render cumulative ``_bucket``/``_sum``/``_count`` series (plus ``# TYPE``
lines and label-value escaping) — a stock Prometheus scrape parses them.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
# metric names additionally must not contain ":" — it is the KV key field
# separator (metrics:<name>:<tags>:<series>), and Prometheus reserves ":"
# for recording rules anyway
_APP_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_PREFIX = "metrics:"


def _kv():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._require_connected()


def tag_string(tags: Optional[Dict[str, str]]) -> str:
    """Canonical sorted k=v form used inside the KV key (series identity
    only — rendering reads the tags dict stored IN the record)."""
    if not tags:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(tags.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label escaping: backslash, quote,
    newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_text(tags: Dict[str, str], extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = [(k, tags[k]) for k in sorted(tags)] + list(extra or [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs) + "}"


# --------------------------------------------------------- record helpers
# Pure functions over the JSON record shape, shared with the head server's
# flight-recorder histograms (gcs/server.py _observe_phase writes records
# straight into its kv dict — no Metric instance, no connected worker).


def new_histogram_record(description: str, boundaries: Sequence[float]) -> dict:
    bounds = sorted(float(b) for b in boundaries)
    return {
        "kind": "histogram",
        "description": description,
        "boundaries": bounds,
        "buckets": [0] * (len(bounds) + 1),  # last bucket = (+last, +Inf]
        "sum": 0.0,
        "count": 0,
        "value": 0.0,  # running mean, kept for the state-API/CLI views
        "ts": 0.0,
        "tags": {},
    }


def observe_into(record: dict, value: float) -> None:
    """Fold one observation into a histogram record (bisect over the
    sorted boundaries; the overflow bucket catches the rest)."""
    import bisect

    value = float(value)
    record["buckets"][bisect.bisect_left(record["boundaries"], value)] += 1
    record["sum"] += value
    record["count"] += 1
    record["value"] = record["sum"] / record["count"]
    record["ts"] = time.time()


def parse_series_key(key: str) -> Tuple[str, str, str]:
    """Split a full KV key (with or without the metrics: prefix) into
    (name, tag_str, series_suffix).  Legacy two-field keys (no suffix)
    parse with suffix ""."""
    if key.startswith(_PREFIX):
        key = key[len(_PREFIX):]
    parts = key.split(":")
    if len(parts) >= 3:
        return parts[0], ":".join(parts[1:-1]), parts[-1]
    if len(parts) == 2:
        return parts[0], parts[1], ""
    return parts[0], "", ""


def merge_records(cur: dict, rec: dict) -> None:
    """Fold `rec` into `cur` in place (same logical series).  Counters and
    histograms sum; gauges take the freshest ts.  Histogram shards whose
    boundary shapes disagree (e.g. a rolling restart changed the
    boundaries) still merge sum/count — those are boundary-independent —
    and keep cur's buckets, so _count/_sum never silently under-report;
    only the bucket split degrades to the surviving shape."""
    kind = rec.get("kind") or cur.get("kind")
    if kind == "histogram":
        if len(cur.get("buckets") or []) == len(rec.get("buckets") or []):
            cur["buckets"] = [
                a + b for a, b in zip(cur["buckets"], rec["buckets"])
            ]
        cur["sum"] = cur.get("sum", 0.0) + rec.get("sum", 0.0)
        cur["count"] = cur.get("count", 0) + rec.get("count", 0)
        if cur["count"]:
            cur["value"] = cur["sum"] / cur["count"]
    elif kind == "gauge":
        if rec.get("ts", 0.0) >= cur.get("ts", 0.0):
            cur["value"] = rec.get("value", 0.0)
    else:  # counter (and legacy records without kind)
        cur["value"] = cur.get("value", 0.0) + rec.get("value", 0.0)
    cur["ts"] = max(cur.get("ts", 0.0), rec.get("ts", 0.0))
    if not cur.get("description") and rec.get("description"):
        cur["description"] = rec["description"]


def merge_series(raw: Dict[str, dict]) -> Dict[str, dict]:
    """Merge per-process series (keys WITHOUT the metrics: prefix) into
    one logical record per (name, tags).  Output keys are `name:tag_str`
    — the shape read_all() has always returned."""
    out: Dict[str, dict] = {}
    for key, rec in raw.items():
        name, tag_str, _series = parse_series_key(key)
        mkey = f"{name}:{tag_str}"
        cur = out.get(mkey)
        if cur is None:
            merged = dict(rec)
            merged["tags"] = dict(rec.get("tags") or {})
            if rec.get("kind") == "histogram":
                merged["buckets"] = list(rec.get("buckets") or [])
            out[mkey] = merged
            continue
        merge_records(cur, rec)
    return out


def render_prometheus(merged: Dict[str, dict]) -> str:
    """Prometheus exposition text for merged records (read_all() shape).
    Emits # HELP / # TYPE once per family, cumulative _bucket/_sum/_count
    for histograms, and escapes label values."""
    families: Dict[str, List[Tuple[str, dict]]] = {}
    for key, rec in sorted(merged.items()):
        name, _, _ = parse_series_key(key)
        families.setdefault(name, []).append((key, rec))
    lines: List[str] = []
    for name, series in families.items():
        kind = series[0][1].get("kind") or "gauge"
        desc = next((r.get("description") for _, r in series if r.get("description")), "")
        if desc:
            lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")
        for _, rec in series:
            tags = dict(rec.get("tags") or {})
            if kind == "histogram":
                cum = 0
                bounds = rec.get("boundaries") or []
                buckets = rec.get("buckets") or []
                for b, c in zip(list(bounds) + ["+Inf"], buckets):
                    cum += c
                    le = "+Inf" if b == "+Inf" else repr(float(b))
                    lines.append(
                        f"{name}_bucket{_labels_text(tags, [('le', le)])} {cum}"
                    )
                lines.append(f"{name}_sum{_labels_text(tags)} {rec.get('sum', 0.0)}")
                lines.append(f"{name}_count{_labels_text(tags)} {rec.get('count', 0)}")
            else:
                lines.append(f"{name}{_labels_text(tags)} {rec.get('value', 0.0)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- public API

# process-local series records (this process is their only writer), with a
# PER-KEY lock serializing same-series writers — ordering within a series
# needs the ship inside the lock, but a slow head RPC on one series must
# not stall threads writing other metrics; see Metric._store
_records_cache: Dict[str, dict] = {}
_records_locks: Dict[str, threading.Lock] = {}
_records_guard = threading.Lock()  # protects the two dicts above


def _series_lock(key: str) -> threading.Lock:
    with _records_guard:
        lock = _records_locks.get(key)
        if lock is None:
            lock = _records_locks[key] = threading.Lock()
        return lock


class Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Tuple[str, ...] = ()):
        if not _APP_NAME_RE.match(name or ""):
            raise ValueError(
                f"invalid metric name {name!r}: must match "
                "[a-zA-Z_][a-zA-Z0-9_]*"
            )
        if isinstance(tag_keys, str) or not all(
            isinstance(k, str) for k in tag_keys
        ):
            raise TypeError("tag_keys must be a tuple of strings")
        self.name = name
        self.description = description
        self._tag_keys: Tuple[str, ...] = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def _validate_tags(self, tags: Dict[str, str]):
        """Declared tag_keys are a contract (reference semantics:
        python/ray/util/metrics.py raises on undeclared tag keys): a tag
        the family never declared silently forks series and breaks
        aggregation, so reject it loudly."""
        undeclared = set(tags) - set(self._tag_keys)
        if undeclared:
            raise ValueError(
                f"tag keys {sorted(undeclared)} were not declared for "
                f"metric {self.name!r} (declared: {list(self._tag_keys)})"
            )

    def set_default_tags(self, tags: Dict[str, str]):
        self._validate_tags(tags)
        self._default_tags = tags
        return self

    def _series_suffix(self, cw) -> str:
        # per-process series id: two workers inc'ing the same counter write
        # DIFFERENT keys, so the non-atomic KV read-modify-write below can
        # never lose an increment (merged back in read_all)
        return cw.worker_id.binary().hex()[:12]

    def _new_record(self) -> dict:
        return {
            "kind": "counter",
            "value": 0.0,
            "ts": 0.0,
            "description": self.description,
            "tags": {},
        }

    def _store(self, value: float, tags, mode: str):
        tags = {**self._default_tags, **(tags or {})}
        self._validate_tags(tags)
        cw = _kv()
        key = f"{_PREFIX}{self.name}:{tag_string(tags)}:{self._series_suffix(cw)}"
        # this process is the ONLY writer of its series, so the local cache
        # is authoritative: no kv read-back per write (one RPC, not two),
        # and the per-key lock closes the update race between threads of
        # one process (concurrent actors share the worker-id series)
        with _series_lock(key):
            with _records_guard:
                record = _records_cache.get(key)
                if record is None:
                    record = _records_cache[key] = self._new_record()
            if mode == "inc":
                record["value"] += value
            elif mode == "set":
                record["kind"] = "gauge"
                record["value"] = value
            else:  # observe
                observe_into(record, value)
            record["ts"] = time.time()
            record["description"] = self.description
            record["tags"] = tags
            blob = json.dumps(record).encode()
            # ship under the lock: a reordered pair of puts would let a
            # stale snapshot overwrite a newer one
            cw.kv_put(key, blob)


class Counter(Metric):
    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        self._store(value, tags, "inc")


class Gauge(Metric):
    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._store(value, tags, "set")


class Histogram(Metric):
    def __init__(self, name, description="", boundaries=None, tag_keys=()):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            raise ValueError(
                f"Histogram {name!r} requires non-empty boundaries"
            )
        self.boundaries = sorted(float(b) for b in boundaries)

    def _new_record(self) -> dict:
        return new_histogram_record(self.description, self.boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._store(value, tags, "observe")


def read_all() -> Dict[str, dict]:
    """All metric series, merged across the per-process writers.  Keys are
    `name:tag_str`; records keep a scalar "value" for every kind (mean for
    histograms) so existing table views stay simple.  One prefix-ranged
    multi-get round trip, not 1+N (the series split multiplies key count
    by writer-process count)."""
    from ray_tpu_torch._private.protocol import MsgType

    cw = _kv()
    reply = cw.request(MsgType.KV_KEYS, {"prefix": _PREFIX, "values": True})
    raw: Dict[str, dict] = {}
    for key, blob in (reply.get("values") or {}).items():
        try:
            raw[str(key)[len(_PREFIX):]] = json.loads(bytes(blob))
        except (ValueError, TypeError):
            continue
    return merge_series(raw)


def prometheus_text() -> str:
    """Prometheus exposition format (the exporter surface of the
    reference's metrics agent)."""
    return render_prometheus(read_all())


def raw_records_from_kv(kv: Dict[str, bytes]) -> Dict[str, dict]:
    """Decode metrics records straight from a kv mapping — the head
    process serves its own /metrics from this without being a connected
    worker."""
    out: Dict[str, dict] = {}
    for key, blob in list(kv.items()):
        if not key.startswith(_PREFIX):
            continue
        try:
            out[key[len(_PREFIX):]] = json.loads(blob)
        except (ValueError, TypeError):
            continue
    return out
