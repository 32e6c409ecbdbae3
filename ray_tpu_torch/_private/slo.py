"""SLO specs + rolling-window evaluation over histogram snapshots.

The policy half of the observability plane (ROADMAP item 5: autoscaling
and preemption "triggered by flight-recorder queue-wait SLOs rather than
raw resource demand" — reference analogs: the multi-window burn-rate
alerting of the Google SRE workbook, and the reference's serve
autoscaling policies keyed on measured latency).  Pure functions +
a small evaluator class so the window math is unit-testable without a
cluster; the head's watchdog loop (gcs/server.py ``_workload_observer_
loop``) drives one evaluator per spec against its aggregated
``metrics:*`` histogram records.

Spec format (JSON list, stored under the ``slo:specs`` KV key by
``ray_tpu_torch.util.slo_api.set_slos`` or seeded from ``RAY_TPU_SLO_SPECS``):

    {"name": "serve_p99_ms",                 # unique id, label value
     "metric": "ray_tpu_torch_serve_request_seconds",   # histogram family
     "tags": {"stage": "serve_e2e"},         # subset-match on series tags
     "quantile": 0.99,                       # objective quantile
     "threshold_ms": 500,                    # objective bound
     "window_s": 60}                         # rolling evaluation window

Gauge specs watch a scalar instead (e.g. step jitter):

    {"name": "train_step_jitter_pct",
     "gauge": "ray_tpu_torch_train_step_jitter_pct",
     "tags": {}, "max": 25.0, "window_s": 60}

Evaluation: per tick the evaluator snapshots the merged bucket counts of
every series matching (metric, tags ⊆ series tags), keeps a deque of
(t, buckets, sum, count), and diffs the newest against the oldest inside
the window — so the verdict reflects ONLY requests observed in the
window, not lifetime history.  From the delta:

- value   = quantile estimate (linear interpolation inside the bucket)
- ok      = value <= threshold
- burn_rate = violating_fraction / (1 - quantile): 1.0 burns the error
  budget exactly as fast as the objective allows, >1 is a breach in the
  burn-rate sense even before the quantile crosses.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


def parse_specs(blob) -> List[dict]:
    """Decode + validate a spec list (JSON text/bytes or an already
    decoded list).  Invalid entries raise ValueError — a silently dropped
    SLO is worse than a loud config error."""
    if isinstance(blob, (bytes, bytearray)):
        blob = bytes(blob).decode()
    if isinstance(blob, str):
        blob = json.loads(blob) if blob.strip() else []
    if not isinstance(blob, list):
        raise ValueError("SLO specs must be a JSON list")
    out = []
    for spec in blob:
        if not isinstance(spec, dict) or not spec.get("name"):
            raise ValueError(f"SLO spec needs a name: {spec!r}")
        if bool(spec.get("metric")) == bool(spec.get("gauge")):
            raise ValueError(
                f"SLO spec {spec['name']!r} needs exactly one of "
                "'metric' (histogram) or 'gauge'"
            )
        if spec.get("metric"):
            q = float(spec.get("quantile", 0.99))
            if not 0.0 < q < 1.0:
                raise ValueError(f"SLO {spec['name']!r}: quantile must be in (0,1)")
            if "threshold_ms" not in spec and "threshold_s" not in spec:
                raise ValueError(f"SLO {spec['name']!r}: missing threshold_ms")
        else:
            if "max" not in spec:
                raise ValueError(f"SLO {spec['name']!r}: gauge spec needs 'max'")
        if float(spec.get("window_s", 60.0)) <= 0:
            raise ValueError(f"SLO {spec['name']!r}: window_s must be > 0")
        if "preempt_below_band" in spec:
            # policy output: a sustained burn on this SLO preempts work
            # whose priority band is strictly below this value, and holds
            # re-admission of parked preempted actors until recovery
            # (gcs/server.py _apply_slo_policy)
            try:
                band = int(spec["preempt_below_band"])
            except (TypeError, ValueError):
                raise ValueError(
                    f"SLO {spec['name']!r}: preempt_below_band must be an int"
                )
            if band < 0:
                raise ValueError(
                    f"SLO {spec['name']!r}: preempt_below_band must be >= 0"
                )
        if "scale_on_slo" in spec:
            raise ValueError(
                f"SLO {spec['name']!r}: scale_on_slo (the fleet scale directives) is not "
                "ported yet (ROADMAP, Queue 1: The serve fleet plane: scale_on_slo and the fleet directives)"
            )
        out.append(spec)
    return out


def threshold_s(spec: dict) -> float:
    if "threshold_s" in spec:
        return float(spec["threshold_s"])
    return float(spec["threshold_ms"]) / 1e3


def tags_match(spec_tags: Optional[Dict[str, str]], series_tags: Dict[str, str]) -> bool:
    """Subset match: every spec tag must equal the series tag."""
    for k, v in (spec_tags or {}).items():
        if series_tags.get(k) != str(v):
            return False
    return True


def estimate_quantile(
    boundaries: Sequence[float], buckets: Sequence[float], q: float
) -> Optional[float]:
    """Quantile from per-bucket (non-cumulative) counts, linearly
    interpolated inside the winning bucket (Prometheus histogram_quantile
    semantics).  The overflow bucket clamps to its lower bound.  None
    when the window saw no observations."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, count in enumerate(buckets):
        if count <= 0:
            continue
        if cum + count >= rank:
            lo = boundaries[i - 1] if i > 0 else 0.0
            if i >= len(boundaries):
                return float(boundaries[-1]) if boundaries else None
            hi = boundaries[i]
            frac = (rank - cum) / count
            return lo + (hi - lo) * frac
        cum += count
    return float(boundaries[-1]) if boundaries else None


def violating_fraction(
    boundaries: Sequence[float], buckets: Sequence[float], threshold: float
) -> float:
    """Fraction of window observations above `threshold`, counting the
    bucket containing the threshold pro-rata (uniform-in-bucket
    assumption, conservative enough for burn rates)."""
    total = sum(buckets)
    if total <= 0:
        return 0.0
    over = 0.0
    for i, count in enumerate(buckets):
        lo = boundaries[i - 1] if i > 0 else 0.0
        hi = boundaries[i] if i < len(boundaries) else float("inf")
        if lo >= threshold:
            over += count
        elif hi > threshold and hi != float("inf"):
            over += count * (hi - threshold) / (hi - lo)
        elif hi == float("inf") and lo < threshold:
            # overflow bucket straddling the threshold: count it all
            # (can't interpolate an unbounded bucket; errs toward alerting)
            over += count
    return min(1.0, over / total)


def burn_rate(violating: float, quantile: float) -> float:
    """Error-budget burn: 1.0 consumes the (1-q) budget exactly."""
    budget = max(1e-9, 1.0 - quantile)
    return violating / budget


class SloEvaluator:
    """Rolling-window evaluator for ONE spec.  Feed it the merged
    metrics view each tick; read back the verdict dict."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.window_s = float(spec.get("window_s", 60.0))
        # (t, buckets, sum, count) snapshots of the matched+merged series
        self._snaps: "deque" = deque()

    def _merged_histogram(
        self, merged: Dict[str, dict]
    ) -> Tuple[List[float], List[float], float, float]:
        """Sum the bucket arrays of every series of the spec's family
        whose tags superset-match the spec tags."""
        boundaries: List[float] = []
        buckets: List[float] = []
        total_sum = 0.0
        total_count = 0.0
        for rec in merged.values():
            if rec.get("kind") != "histogram":
                continue
            name = rec.get("name") or ""
            if name != self.spec["metric"]:
                continue
            if not tags_match(self.spec.get("tags"), rec.get("tags") or {}):
                continue
            b = list(rec.get("boundaries") or [])
            c = list(rec.get("buckets") or [])
            if not boundaries:
                boundaries, buckets = b, c
            elif b == boundaries and len(c) == len(buckets):
                buckets = [x + y for x, y in zip(buckets, c)]
            total_sum += float(rec.get("sum", 0.0))
            total_count += float(rec.get("count", 0))
        return boundaries, buckets, total_sum, total_count

    def evaluate(self, merged: Dict[str, dict], now: float) -> dict:
        """One tick.  `merged` is the read_all()-shaped metrics view with
        a "name" key on each record (the head adds it when rendering)."""
        spec = self.spec
        out: Dict[str, Any] = {
            "name": spec["name"],
            "window_s": self.window_s,
            "ok": True,
            "burn_rate": 0.0,
            "value": None,
            "samples": 0,
        }
        if spec.get("gauge"):
            out["threshold"] = float(spec["max"])
            # a "max" bound over a gauge means NO matching series may
            # exceed it: aggregate the WORST value across series whose
            # last report falls inside the window (loose tags can match
            # several runs — an arbitrary or merely-freshest pick would
            # let a healthy run mask a breaching one; staleness gating
            # keeps dead runs from pinning a breach forever)
            val = None
            matched = 0
            for rec in merged.values():
                if (rec.get("name") or "") != spec["gauge"]:
                    continue
                if not tags_match(spec.get("tags"), rec.get("tags") or {}):
                    continue
                v = rec.get("value")
                ts = float(rec.get("ts", 0.0) or 0.0)
                if v is None or now - ts > self.window_s:
                    continue
                matched += 1
                if val is None or float(v) > val:
                    val = float(v)
            if val is not None:
                out["value"] = val
                out["samples"] = matched
                out["ok"] = val <= float(spec["max"])
                out["burn_rate"] = (
                    val / float(spec["max"]) if float(spec["max"]) > 0 else 0.0
                )
            return out

        thr = threshold_s(spec)
        q = float(spec.get("quantile", 0.99))
        out["threshold"] = thr
        out["quantile"] = q
        boundaries, buckets, h_sum, h_count = self._merged_histogram(merged)
        self._snaps.append((now, buckets, h_sum, h_count))
        while len(self._snaps) > 1 and now - self._snaps[0][0] > self.window_s:
            self._snaps.popleft()
        base = self._snaps[0]
        if not boundaries:
            return out
        if len(base[1]) == len(buckets):
            delta = [max(0.0, a - b) for a, b in zip(buckets, base[1])]
        else:
            delta = list(buckets)  # boundary shape changed: use lifetime
        # the oldest snapshot IS the newest on the first tick → delta is
        # all zeros; fall back to lifetime so a fresh head still reports
        if sum(delta) <= 0 and len(self._snaps) == 1:
            delta = list(buckets)
        n = sum(delta)
        out["samples"] = int(n)
        if n <= 0:
            return out
        est = estimate_quantile(boundaries, delta, q)
        viol = violating_fraction(boundaries, delta, thr)
        out["value"] = est
        out["ok"] = bool(est is not None and est <= thr)
        out["burn_rate"] = burn_rate(viol, q)
        return out
