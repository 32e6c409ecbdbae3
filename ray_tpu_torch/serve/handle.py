"""DeploymentHandle: client-side router to replicas.

Analog of the reference's handle/router pair (reference:
python/ray/serve/handle.py:225 RayServeHandle.remote →
_private/router.py:221 ReplicaSet.assign_replica; config fan-out via
LongPollClient, _private/long_poll.py:67).  Fleet behaviors live here
(serve/FLEET.md):

- in-flight accounting resolves on the core worker's io loop via
  on_object_done (no thread per request);
- replica membership is PUSH-invalidated: the controller publishes on the
  ``serve:<deployment>`` pubsub channel at every version bump, the handle
  marks itself stale and re-pulls on the next request — long-poll
  semantics without a poll loop.  Load snapshots piggyback on the same
  channel and are absorbed WITHOUT a re-pull;
- routing is power-of-two-choices least-pressure over local in-flight +
  fleet-reported queue depth and KV-page pressure, locality as tiebreak;
- all replicas saturated raises a typed ``DeploymentBackpressureError``
  (the proxy maps it to 503 + Retry-After) instead of over-admitting;
- ``stream_tokens`` fails over mid-stream: a dead replica's stream is
  resubmitted to a survivor and resumed from the delivered-token
  frontier with duplicates suppressed (greedy decoding makes the replay
  bit-identical), so clients see a latency blip, not an error.
"""

from __future__ import annotations

import itertools
import random
import threading
from typing import Any, Dict, List

_FAILOVER_ATTEMPTS = 3  # replica deaths one stream absorbs before erroring

# process-wide failover counter: handles live in driver/proxy processes
_failovers_counter = None
_failovers_lock = threading.Lock()


def _count_failover(deployment: str):
    global _failovers_counter
    try:
        with _failovers_lock:
            if _failovers_counter is None:
                from ray_tpu_torch.util import metrics as metrics_mod

                _failovers_counter = metrics_mod.Counter(
                    "ray_tpu_torch_serve_fleet_failovers_total",
                    description="mid-stream replica failovers (handle resubmits)",
                    tag_keys=("deployment",),
                )
        _failovers_counter.inc(1.0, tags={"deployment": deployment})
    except Exception:
        pass  # metrics plane down: the failover itself still happened


def _fleet_event(message: str, **fields):
    """source=serve_fleet timeline event, fire-and-forget (failover is a
    data-path action — bookkeeping must not add a blocking head RPC)."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.protocol import MsgType

    try:
        cw = worker_mod._require_connected()
    except Exception:
        return
    payload = {
        "severity": "WARNING",
        "source": "serve_fleet",
        "message": message,
        "fields": fields,
    }

    async def _send():
        try:
            await cw.conn.send(MsgType.RECORD_EVENT, payload)
        except (ConnectionError, OSError):
            pass

    try:
        cw.io.spawn(_send())
    except Exception:  # event bookkeeping is best-effort; the failover already landed
        pass


def _unwrap_cause(exc, types, limit: int = 8):
    """First exception of `types` on the cause chain (RayTaskError keeps
    the remote exception under .cause; __cause__ covers local re-raises).
    Same walk the proxy uses for Retry-After extraction."""
    e, seen = exc, 0
    while e is not None and seen < limit:
        if isinstance(e, types):
            return e
        e = getattr(e, "cause", None) or getattr(e, "__cause__", None)
        seen += 1
    return None


def _rebuild_handle(name: str) -> "DeploymentHandle":
    from ray_tpu_torch.serve.api import get_deployment_handle

    return get_deployment_handle(name)


class DeploymentHandle:
    # push is the fast path; this pull interval is the self-heal fallback
    # for a missed publish (failed subscribe, dropped PUBLISH RPC)
    PULL_FALLBACK_S = 5.0

    def __init__(self, deployment_name: str, controller):
        self._name = deployment_name
        self._controller = controller
        self._replicas: List = []
        self._replica_nodes: List[str] = []
        self._replica_names: List[str] = []
        # replica name -> load snapshot; REPLACED whole (never mutated) by
        # the pubsub callback, so readers need no lock
        self._loads: Dict[str, dict] = {}
        self._my_node = self._resolve_my_node()
        self._max_inflight = 100
        self._version = -1
        self._rr = itertools.count()
        self._rng = random.Random()
        # keyed by replica actor id (NOT slot index): releases after a
        # membership change must decrement the replica that actually served
        self._inflight: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._stale = threading.Event()
        self._last_refresh = 0.0
        self._last_refresh_attempt = 0.0
        # LAZY first refresh: a handle may deserialize inside the
        # controller itself (deployment-graph args) — an eager get_handles
        # RPC there would be the controller calling its own busy self
        self._stale.set()
        self._subscribe_updates()

    def _subscribe_updates(self):
        """Controller pushes version bumps; the callback only flips a flag
        (it runs on the io thread and must not block).  Held via weakref so
        discarded handles don't accumulate in the worker's subscription
        list forever — a dead handle's callback prunes itself on the next
        publish."""
        import weakref

        from ray_tpu_torch._private import worker as worker_mod

        try:
            cw = worker_mod._require_connected()
        except Exception:
            return  # pull path still works, just without push invalidation
        wself = weakref.ref(self)
        channel = f"serve:{self._name}"

        def _cb(_msg):
            h = wself()
            if h is None:
                subs = cw._subscriptions.get(channel, [])
                if _cb in subs:
                    subs.remove(_cb)
                return
            if isinstance(_msg, dict):
                # load snapshots piggyback on every publish (controller
                # poller, ~1 Hz): absorb them here — dict REPLACEMENT, io
                # thread never blocks — and only force a membership
                # re-pull when the version actually moved; a load-only
                # publish must not turn push-invalidation into 1 Hz
                # controller RPCs per handle
                loads = _msg.get("loads")
                if isinstance(loads, dict):
                    h._loads = dict(loads)
                if _msg.get("version", -2) == h._version:
                    return
            h._stale.set()

        try:
            cw.subscribe(channel, _cb)
        except Exception:
            pass

    def _refresh(self):
        import time as _time

        import ray_tpu_torch

        info = ray_tpu_torch.get(self._controller.get_handles.remote(self._name), timeout=30)
        if info is None:
            raise ValueError(f"no deployment named {self._name!r}")
        with self._lock:
            # identity-keyed counters survive membership changes untouched;
            # drop entries for replicas that left the set
            self._replicas = info["replicas"]
            self._replica_nodes = info.get("replica_nodes") or [""] * len(
                self._replicas
            )
            self._replica_names = info.get("replica_names") or [""] * len(
                self._replicas
            )
            if isinstance(info.get("replica_loads"), dict):
                self._loads = dict(info["replica_loads"])
            self._max_inflight = info["max_concurrent_queries"]
            self._version = info["version"]
            live = {self._rid(r) for r in self._replicas}
            self._inflight = {
                k: v for k, v in self._inflight.items() if k in live
            }
        self._last_refresh = _time.monotonic()
        self._stale.clear()

    @staticmethod
    def _rid(replica):
        return getattr(replica, "_actor_id", id(replica))

    @staticmethod
    def _resolve_my_node() -> str:
        import os

        nid = os.environ.get("RAY_TPU_NODE_ID", "")
        if nid:
            return nid
        try:
            from ray_tpu_torch._private import worker as worker_mod

            return bytes(worker_mod._require_connected().node_id).hex()
        except Exception:
            return ""

    def _pressure(self, idx: int) -> float:
        """Routing pressure for replica slot ``idx``: what THIS handle has
        in flight there, plus the fleet-reported queue depth and KV-page
        pressure from the controller's piggybacked load snapshots.
        max(local, reported-inflight) because the report already counts
        our own in-flight work — summing would double-charge it."""
        rid = self._rid(self._replicas[idx])
        local = float(self._inflight.get(rid, 0))
        ld = {}
        if idx < len(self._replica_names):
            ld = self._loads.get(self._replica_names[idx]) or {}
        reported = float(ld.get("inflight", 0.0) or 0.0)
        queue = float(ld.get("queue_depth", 0.0) or 0.0)
        page_frac = float(ld.get("kv_page_frac", 0.0) or 0.0)
        # page pressure scales by the admission cap so a nearly-full KV
        # pool weighs like a nearly-full queue, not like one request
        return max(local, reported) + queue + page_frac * self._max_inflight

    def _pick_replica(self, exclude=frozenset()):
        """Least-pressure routing with power-of-two-choices: sample two
        eligible replicas, take the lower pressure, locality breaking
        ties (tiebreak, NOT filter — a saturated local replica loses to
        an idle remote one).  Eligible = under this handle's in-flight
        cap, not reported draining, not in ``exclude`` (the failover
        loop's dead-replica set).  Nothing eligible raises a typed
        ``DeploymentBackpressureError`` — the cap is a real bound, not a
        suggestion; the proxy maps it to 503 + Retry-After."""
        import time as _time

        from ray_tpu_torch.exceptions import DeploymentBackpressureError

        now = _time.monotonic()
        need = self._stale.is_set() or now - self._last_refresh > self.PULL_FALLBACK_S
        # attempt backoff: a dead controller must not add a blocking RPC to
        # every request while the stale flag is stuck set
        if need and now - self._last_refresh_attempt > 1.0:
            self._last_refresh_attempt = now
            try:
                self._refresh()  # clears _stale on success
            except Exception:
                pass  # a later request (post-backoff) retries
        with self._lock:
            n = len(self._replicas)
        if n == 0 and self._last_refresh == 0:
            # lazy handle that never managed a refresh: one blocking
            # attempt so the caller sees the real error (unknown name /
            # controller down) — still backoff-gated so a dead controller
            # can't add a long RPC to every request
            if _time.monotonic() - self._last_refresh_attempt > 1.0:
                self._last_refresh_attempt = _time.monotonic()
                self._refresh()
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError(f"deployment {self._name} has no replicas")
            loads = self._loads  # replacement-dict snapshot
            cands = []
            for i in range(n):
                rid = self._rid(self._replicas[i])
                if rid in exclude:
                    continue
                if self._inflight.get(rid, 0) >= self._max_inflight:
                    continue
                rn = self._replica_names[i] if i < len(self._replica_names) else ""
                if (loads.get(rn) or {}).get("draining"):
                    continue  # mid-drain: admits nothing new
                cands.append(i)
            if not cands:
                raise DeploymentBackpressureError(
                    f"deployment {self._name}: all {n} replicas saturated "
                    f"(cap {self._max_inflight})",
                    retry_after_s=1.0,
                )
            if len(cands) > 2:
                cands = self._rng.sample(cands, 2)
            local_n = len(self._replica_nodes)

            def _key(i):
                is_remote = 1
                if self._my_node and i < local_n:
                    is_remote = 0 if self._replica_nodes[i] == self._my_node else 1
                return (self._pressure(i), is_remote, i)

            idx = min(cands, key=_key)
            rid = self._rid(self._replicas[idx])
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
            return rid, self._replicas[idx]

    def _release(self, rid):
        with self._lock:
            if rid in self._inflight:
                self._inflight[rid] = max(0, self._inflight[rid] - 1)

    def remote(self, *args, **kwargs):
        """Async submit; returns an ObjectRef."""
        return self.method("__call__").remote(*args, **kwargs)

    def stream(self, *args, **kwargs):
        """Call a GENERATOR deployment method and iterate its chunks as
        they are produced (reference: serve streaming responses).  The
        stream is pinned to ONE replica (the generator lives there);
        chunks are pulled in batches through the normal actor-call path.

        for token in handle.stream(prompt): ...
        """
        return self.method("__call__").stream(*args, **kwargs)

    def stream_tokens(
        self,
        prompt,
        *,
        max_new_tokens=None,
        eos_token=None,
        timeout: float = 600.0,
    ):
        """Stream token frames from a continuous-batching engine
        deployment (serve/engine/): yields lists of token ids AS THE
        ENGINE PRODUCES THEM — the first frame lands after the prompt's
        final prefill chunk, long before the sequence completes.

        Transport: one ``engine_stream_start`` actor call, then frames
        ride a dag channel straight from the replica (shm ring when
        co-located — no per-token RPC, no head hop).  Falls back to
        pulling the stream's outbox over the normal actor-call path when
        the direct transport is unavailable (client mode, feature off).

        Mid-stream replica death FAILS OVER (serve/FLEET.md): the
        ORIGINAL request is resubmitted to a surviving replica and the
        first ``delivered`` tokens of the replay are suppressed — greedy
        decoding over identical weights makes them bit-identical, so the
        resumed stream continues exactly where the dead one stopped.  A
        replica-local overload or drain rejection retries the
        next-least-loaded sibling without counting as a failover.  Only
        when no survivor remains does the typed error (``EngineStream
        Error`` / ``DeploymentBackpressureError``) reach the caller."""
        from ray_tpu_torch.exceptions import (
            DeploymentBackpressureError,
            EngineOverloadedError,
            EngineStreamError,
            RayActorError,
            ReplicaDrainingError,
            WorkerCrashedError,
        )

        delivered = 0
        excluded = set()
        failovers = 0
        last_err = None
        while True:
            try:
                rid, replica = self._pick_replica(exclude=frozenset(excluded))
            except DeploymentBackpressureError:
                if last_err is not None:
                    raise last_err  # survivors exhausted: the stream death wins
                raise
            try:
                skip = delivered
                for frame in self._stream_once(
                    replica, prompt, max_new_tokens, eos_token, timeout
                ):
                    if skip:
                        # resumed stream: drop the already-delivered
                        # prefix (bit-identical replay under greedy)
                        if skip >= len(frame):
                            skip -= len(frame)
                            continue
                        frame = frame[skip:]
                        skip = 0
                    delivered += len(frame)
                    yield frame
                return
            except GeneratorExit:
                raise  # consumer walked away: no retry on its behalf
            except Exception as e:
                retriable = _unwrap_cause(
                    e, (EngineOverloadedError, ReplicaDrainingError)
                )
                if retriable is not None and delivered == 0:
                    # admission-time rejection: try the next-least-loaded
                    # sibling before shedding — a single replica's
                    # overload is a routing miss, not a fleet 503
                    excluded.add(rid)
                    last_err = e
                    continue
                # WorkerCrashedError: the kill landed while the replica
                # was still executing the submission call itself — same
                # death, earlier phase, same failover
                dead = _unwrap_cause(
                    e,
                    (
                        EngineStreamError,
                        RayActorError,
                        WorkerCrashedError,
                        ConnectionError,
                    ),
                )
                if dead is None or failovers >= _FAILOVER_ATTEMPTS:
                    raise
                failovers += 1
                excluded.add(rid)
                last_err = e
                self._stale.set()  # membership likely changed: re-pull
                _count_failover(self._name)
                _fleet_event(
                    f"serve fleet failover: {self._name} stream resumed at "
                    f"token {delivered}",
                    deployment=self._name,
                    delivered=delivered,
                    attempt=failovers,
                    error=type(dead).__name__,
                )
            finally:
                self._release(rid)

    def _stream_once(self, replica, prompt, max_new_tokens, eos_token, timeout):
        """One streaming attempt against ONE replica; yields token-id
        lists.  Replica death surfaces as a raised typed error — the
        failover loop in stream_tokens owns retries and accounting."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import EngineStreamError
        from ray_tpu_torch.serve import tracing as serve_tracing
        from ray_tpu_torch.serve.engine import transport as engine_transport

        trace = serve_tracing.new_request(self._name)
        serve_tracing.stamp(trace, "serve_route")
        kwargs = {"max_new_tokens": max_new_tokens, "eos_token": eos_token}
        if trace is not None:
            kwargs["_serve_trace"] = trace
        start = ray_tpu_torch.get(
            replica.handle_request.remote("engine_stream_start", (prompt,), kwargs),
            timeout=600,
        )
        try:
            ts = engine_transport.open_token_stream(replica, start, timeout=timeout)
        except EngineStreamError:
            ts = None  # no direct transport here: pull path below
        if ts is not None:
            yield from ts
            return
        sid = start["sid"]
        finished = False
        try:
            while True:
                frames, done = ray_tpu_torch.get(
                    replica.handle_request.remote("engine_stream_next", (sid,), {}),
                    timeout=timeout,
                )
                for f in frames:
                    if f.get("error"):
                        finished = True
                        raise EngineStreamError(str(f["error"]))
                    if f.get("t"):
                        yield list(f["t"])
                    if f.get("done"):
                        finished = True
                if finished or done:
                    return
        finally:
            if not finished:
                # abandoned mid-stream: free the replica-side request
                try:
                    replica.handle_request.remote("engine_stream_cancel", (sid,), {})
                except Exception:
                    pass

    def method(self, method_name: str):
        handle = self

        class _Method:
            def remote(self, *args, **kwargs):
                from ray_tpu_torch._private import worker as worker_mod
                from ray_tpu_torch.serve import tracing as serve_tracing

                # serve request tracing: adopt the ingress's record (the
                # HTTP proxy passes one) or mint one here for bare-handle
                # callers; the replica pops the reserved kwarg before the
                # user callable ever sees kwargs.  With recording off the
                # trace is None and nothing is attached (one flag check).
                trace = kwargs.pop("_serve_trace", None)
                if trace is None:
                    trace = serve_tracing.new_request(handle._name)
                elif not trace.get("deployment"):
                    trace["deployment"] = handle._name
                idx, replica = handle._pick_replica()
                serve_tracing.stamp(trace, "serve_route")
                if trace is not None:
                    kwargs = {**kwargs, "_serve_trace": trace}
                ref = replica.handle_request.remote(method_name, args, kwargs)
                # decrement when the result resolves — an io-loop callback,
                # NOT a thread per request (r2 weak #6)
                try:
                    cw = worker_mod._require_connected()
                    cw.on_object_done(ref, lambda: handle._release(idx))
                except Exception:
                    handle._release(idx)  # fail open: don't wedge the cap
                return ref

            def stream(self, *args, **kwargs):
                import ray_tpu_torch

                idx, replica = handle._pick_replica()
                sid = None
                finished = False
                try:
                    sid = ray_tpu_torch.get(
                        replica.handle_stream_start.remote(method_name, args, kwargs),
                        timeout=600,
                    )
                    # adaptive batch: first pull returns on the FIRST chunk
                    # (token latency), later pulls grow toward 16 so fast
                    # generators aren't RPC-bound per item
                    batch = 1
                    while True:
                        chunks, stream_done = ray_tpu_torch.get(
                            replica.handle_stream_next.remote(sid, batch),
                            timeout=600,
                        )
                        batch = min(batch * 2, 16)
                        for c in chunks:
                            yield c
                        if stream_done:
                            finished = True
                            return
                finally:
                    if sid is not None and not finished:
                        # abandoned mid-stream (break / timeout): release
                        # the replica-side generator + inflight slot
                        try:
                            replica.handle_stream_cancel.remote(sid)
                        except Exception:
                            pass
                    handle._release(idx)

        return _Method()

    def __reduce__(self):
        # handles cross process boundaries (deployment-graph composition
        # ships a dependency's handle into the parent replica's __init__):
        # rebuild fresh in the destination, resolving the controller there
        return (_rebuild_handle, (self._name,))

    def refresh_if_stale(self):
        """Refresh only when the push marked us stale — NO per-request
        controller RPC (that hop is what push-invalidation removes; missed
        pushes are healed by _pick_replica's PULL_FALLBACK_S timer)."""
        if self._stale.is_set():
            try:
                self._refresh()
            except Exception:
                pass
