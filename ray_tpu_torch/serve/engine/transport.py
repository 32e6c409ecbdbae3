"""Token streaming over compiled-DAG channels.

Per-step token frames leave the engine on the SAME transport the
compiled-DAG subsystem proved out (dag/channel.py): the consumer (HTTP
proxy or a bare DeploymentHandle) dials the replica's direct-call server
once, sends one ``ENGINE_STREAM`` attach frame, and from then on every
frame is a ``ChannelWriter.write`` — a shm-ring slot for co-located
pairs (no socket frame at all on the hot path), an inline ``DAG_PUSH``
cross-node.  No head round-trip, no per-frame actor RPC: the per-token
delivery cost is ~zero host dispatch.

Backpressure: a co-located consumer that stops draining fills its ring;
the engine's flush uses ``try_write`` (never blocks the decode fleet on
one slow stream) and parks the frames in a bounded outbox.  A consumer
that stays behind past the bound is BROKEN by contract: the stream's
conn is severed, which surfaces as a typed
:class:`~ray_tpu_torch.exceptions.EngineStreamError` at the consumer — same
fail-loud philosophy as the DAG channels' no-retransmit rule.

Failure: a killed replica (or any transport loss) fires the consumer
conn's close callback → the reader wakes broken → the iterator raises
``EngineStreamError``.  Never a hang.

The fallback for environments without direct-call servers (client mode,
tests with the feature off) is the pull path: the same outbox served by
the ``engine_stream_next`` actor method.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.exceptions import EngineStreamError
from ray_tpu_torch.util.lockwitness import named_condition, named_lock

__all__ = ["StreamHub", "StreamState", "TokenStream", "hub", "open_token_stream"]


class StreamState:
    """One stream's delivery state: the engine's sink AND the wire end.

    Engine thread: ``emit`` / ``flush``.  Worker io loop: ``attach`` /
    ``detach``.  Actor executor threads: ``pull`` (fallback path).  The
    outbox deque + condvar serialize all of them.
    """

    def __init__(self, sid: int, outbox_limit: int = 4096):
        self.sid = sid
        self._limit = int(outbox_limit)
        self._frames: collections.deque = collections.deque()
        self._cv = named_condition("StreamState._cv")
        self._flush_lock = named_lock("StreamState._flush_lock")
        self._writer = None
        self._conn = None
        self._seq = 0
        self.closed = False
        self.finished = False  # done frame queued (and, once flushed, sent)
        self.cancel_cb = None  # engine wires this to cancel the request

    # ------------------------------------------------------------- engine

    def emit(self, frame: dict) -> None:
        """Engine-side sink: queue one frame and push it toward the
        consumer.  Raising here tells the engine loop to drop the sink;
        a past-the-bound outbox severs the stream instead (typed error at
        the consumer) so the engine keeps a strict delivery bound."""
        with self._cv:
            if self.closed:
                return
            self._frames.append(frame)
            if frame.get("done"):
                self.finished = True
            over = len(self._frames) > self._limit
            self._cv.notify_all()
        if over:
            self.fail("stream consumer fell behind the backpressure bound")
            return
        self.flush()

    def needs_flush(self) -> bool:
        """Frames waiting for the wire?  The engine polls this to keep
        re-flushing streams whose ring filled (try_write returned False):
        the ring is only ``dag_channel_slots`` deep, so any stream longer
        than the ring NEEDS these retries once the consumer drains slots —
        emit() alone stops flushing the moment generation finishes."""
        with self._cv:
            return bool(self._frames) and not self.closed

    def flushable(self) -> bool:
        """True when a flush can make progress RIGHT NOW (writer
        attached).  Pull-path streams queue frames without a writer —
        they drain via pull(), so the engine's fast retry tick skips
        them."""
        return self._writer is not None

    def flush(self) -> None:
        """Drain queued frames into the channel writer (no-op before
        attach / on the pull path).  try_write keeps this non-blocking:
        a full ring leaves the frame queued for the next flush."""
        from ray_tpu_torch.dag.channel import ChannelBrokenError, encode_value

        writer = self._writer
        if writer is None:
            return
        with self._flush_lock:
            while True:
                with self._cv:
                    if not self._frames:
                        return
                    frame = self._frames[0]
                try:
                    wire, nbytes = encode_value(frame)
                    if not writer.try_write(self._seq, wire, nbytes):
                        return  # ring full: retry on the next emit/tick
                except ChannelBrokenError:
                    self.close()
                    return
                self._seq += 1
                with self._cv:
                    self._frames.popleft()
                if frame.get("done"):
                    # do NOT close here: the done frame may still be
                    # sitting unread in the ring (a fast sequence finishes
                    # before the attach reply even reaches the consumer),
                    # and closing the writer would delete the unpinned
                    # ring with every frame in it.  The consumer drains at
                    # its own pace; its conn close (TokenStream.close →
                    # hub.on_conn_lost) reclaims the writer and ring.
                    return

    # ----------------------------------------------------------- transport

    def attach(self, writer, conn) -> dict:
        """io-loop: a consumer attached a dag channel.  First flush runs
        here so frames buffered pre-attach go out immediately."""
        with self._cv:
            if self.closed:
                return {"ok": False, "error": "stream already closed"}
            if self._writer is not None:
                return {"ok": False, "error": "stream already has a consumer"}
            self._writer = writer
            self._conn = conn
        self.flush()
        return {"ok": True}

    def fail(self, reason: str) -> None:
        """Sever the stream: the consumer's conn-loss callback turns this
        into a typed EngineStreamError (never a silent stall).  A pull
        consumer has no conn to lose, so the error travels as a final
        frame in the outbox — pull() drains it and the client raises,
        instead of mistaking the truncated stream for a clean finish."""
        with self._cv:
            if not self.closed:
                self._frames.append({"t": [], "done": True, "error": reason})
            self._cv.notify_all()
        conn = self._conn
        self.close()
        if conn is not None and not getattr(conn, "closed", False):
            try:
                from ray_tpu_torch._private import worker as worker_mod

                worker_mod._require_connected().io.loop.call_soon_threadsafe(conn.close)
            except Exception:  # noqa: BLE001 -- teardown path; consumer still sees conn loss
                pass

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._cv.notify_all()
        writer, self._writer = self._writer, None
        self._conn = None
        if writer is not None:
            writer.close()

    # ------------------------------------------------------ fallback pull

    def pull(self, max_frames: int = 16, timeout: float = 30.0) -> Tuple[List[dict], bool]:
        """Fallback consumer path (engine_stream_next actor method):
        block for the next frame(s); (frames, stream_done)."""
        out: List[dict] = []
        with self._cv:
            if not self._frames and not self.closed:
                self._cv.wait(timeout)
            while self._frames and len(out) < max_frames:
                out.append(self._frames.popleft())
            done = (self.closed and not self._frames) or any(
                f.get("done") for f in out
            )
        return out, done


class StreamHub:
    """Per-process registry: stream id → StreamState.  The worker's
    direct-call server routes ENGINE_STREAM frames here (one hub per
    process, engines register their streams on it)."""

    def __init__(self):
        self._streams: Dict[int, StreamState] = {}
        self._lock = named_lock("StreamHub._lock")
        self._next = 1

    def create(self, outbox_limit: int = 4096, cancel_cb=None) -> StreamState:
        self.gc_finished()  # reap streams severed without a conn (overflow fail)
        with self._lock:
            sid = self._next
            self._next += 1
            st = StreamState(sid, outbox_limit)
            st.cancel_cb = cancel_cb
            self._streams[sid] = st
            return st

    def get(self, sid: int) -> Optional[StreamState]:
        with self._lock:
            return self._streams.get(sid)

    def remove(self, sid: int) -> None:
        with self._lock:
            st = self._streams.pop(sid, None)
        if st is not None:
            st.close()

    def on_conn_lost(self, conn) -> None:
        """Worker io loop: a consumer conn died (orderly close after the
        done frame, or a vanished client).  Close and drop every stream
        riding it — this is where writers and rings are reclaimed."""
        with self._lock:
            victims = [
                sid for sid, st in self._streams.items() if st._conn is conn
            ]
            states = [self._streams.pop(sid) for sid in victims]
        for st in states:
            cb = st.cancel_cb
            if cb is not None and not st.finished:
                try:
                    cb()  # consumer vanished mid-stream: stop generating
                except Exception:  # noqa: BLE001 -- engine may already have retired it
                    pass
            st.close()

    def gc_finished(self) -> None:
        with self._lock:
            dead = [sid for sid, st in self._streams.items() if st.closed]
            for sid in dead:
                self._streams.pop(sid, None)

    def busy_count(self) -> int:
        """Streams whose consumer has not finished draining — the drain
        protocol's wait condition (serve/FLEET.md): a replica may not
        tear down while a live stream's queued frames could still be
        lost.  A finished-but-unclosed stream counts: its done frame is
        out, but the consumer may still be pulling the ring tail."""
        self.gc_finished()
        with self._lock:
            return len(self._streams)


_hub: Optional[StreamHub] = None
_hub_lock = named_lock("engine.transport._hub_lock")


def hub() -> StreamHub:
    global _hub
    with _hub_lock:
        if _hub is None:
            _hub = StreamHub()
        return _hub


def conn_lost(conn) -> None:
    """Direct-server hook (core/worker_main.py): reclaim streams whose
    consumer conn just died.  No-op in processes that never hosted an
    engine (the caller guards on the module being imported at all)."""
    h = _hub
    if h is not None:
        h.on_conn_lost(conn)


async def handle_frame(payload: dict, conn) -> dict:
    """Worker io-loop entry point: one ENGINE_STREAM control frame from a
    consumer-dialed conn (core/worker_main.py routes here)."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.dag.channel import ChannelWriter

    op = str(payload.get("op", ""))
    sid = int(payload.get("sid", 0))
    h = _hub
    st = h.get(sid) if h is not None else None
    if op == "cancel":
        if st is not None:
            cb = st.cancel_cb
            if cb is not None:
                try:
                    cb()
                except Exception:  # noqa: BLE001 -- consumer is leaving either way
                    pass
            st.close()
        return {"ok": True}
    if op != "attach":
        return {"ok": False, "error": f"unknown engine-stream op {op!r}"}
    if st is None:
        return {"ok": False, "error": f"no stream {sid} in this process"}
    cw = worker_mod._require_connected()
    writer = ChannelWriter(
        str(payload.get("chan", "")),
        cw.io,
        conn,
        store=cw.store,
        co_located=bool(payload.get("co")),
    )
    return st.attach(writer, conn)


# --------------------------------------------------------------- consumer


class TokenStream:
    """Consumer end of an engine token stream: iterate token-frame lists
    as the engine produces them.  Transport loss or a replica death
    raises :class:`EngineStreamError`; ``close()`` cancels an abandoned
    stream replica-side."""

    def __init__(self, cw, conn, reader, sid: int, timeout: float = 600.0):
        self._cw = cw
        self._conn = conn
        self._reader = reader
        self._sid = sid
        self._timeout = timeout
        self._finished = False

    def __iter__(self):
        from ray_tpu_torch.dag.channel import ChannelBrokenError, ChannelClosedError

        try:
            while True:
                try:
                    is_err, frame = self._reader.get(timeout=self._timeout)
                except ChannelClosedError:
                    return
                except ChannelBrokenError as e:
                    raise EngineStreamError(
                        f"token stream broke mid-flight: {e}"
                    ) from e
                except TimeoutError as e:
                    raise EngineStreamError(
                        f"token stream stalled for {self._timeout}s"
                    ) from e
                if is_err:
                    raise EngineStreamError(str(frame))
                if frame.get("error"):
                    raise EngineStreamError(str(frame["error"]))
                toks = frame.get("t") or []
                if toks:
                    yield list(toks)
                if frame.get("done"):
                    self._finished = True
                    return
        finally:
            self.close()

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if not self._finished:
            # abandoned mid-stream: release the replica-side request
            try:
                self._cw.dag_rpc(
                    conn,
                    _engine_stream_msgtype(),
                    {"op": "cancel", "sid": self._sid},
                    5.0,
                )
            except Exception:  # noqa: BLE001 -- replica may already be gone
                pass
        try:
            self._reader.close()
        except Exception:  # noqa: BLE001 -- ring already reclaimed
            pass
        try:
            self._cw.close_dag_conn(conn)
        except RuntimeError:
            pass  # io loop already stopped


def _engine_stream_msgtype():
    from ray_tpu_torch._private.protocol import MsgType

    return MsgType.ENGINE_STREAM


def open_token_stream(replica_handle, start_info: dict, timeout: float = 600.0) -> TokenStream:
    """Wire a dag-channel token stream to a replica for a stream the
    caller already started (``engine_stream_start`` returned
    ``start_info = {"sid", "node_id"}``).  Raises EngineStreamError when
    the transport can't be established — callers fall back to the pull
    path."""
    import os

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.protocol import MsgType
    from ray_tpu_torch.dag.channel import ChannelReader

    cw = worker_mod._require_connected()
    sid = int(start_info["sid"])
    aid = getattr(replica_handle, "_actor_id", b"") or b""
    try:
        reply = cw.request(MsgType.ACTOR_STATE, {"actor_id": aid})
    except Exception as e:
        raise EngineStreamError(f"cannot resolve replica: {e}") from e
    addr = reply.get("direct_addr")
    if not addr or reply.get("state") != "ALIVE":
        raise EngineStreamError(
            f"replica not streamable (state={reply.get('state')}, "
            f"direct_addr={addr!r})"
        )
    my_node = "" if cw.is_client else bytes(cw.node_id or b"").hex()
    co = (
        bool(my_node)
        and my_node == str(start_info.get("node_id") or "")
        and cw.store is not None
    )
    chan = f"eng:{bytes(aid).hex()[:12]}:{sid}:{os.getpid()}"
    reader = ChannelReader(chan, store=cw.store, co_located=co)

    def _on_push(payload):
        if payload.get("c") == chan:
            reader.push(payload)

    def _on_close():
        reader.wake_broken("replica connection lost")

    conn = cw.open_dag_conn(addr, on_push=_on_push, on_close=_on_close)
    try:
        ack = cw.dag_rpc(
            conn,
            MsgType.ENGINE_STREAM,
            {"op": "attach", "sid": sid, "chan": chan, "co": co},
            30.0,
        )
    except Exception as e:
        cw.close_dag_conn(conn)
        raise EngineStreamError(f"stream attach failed: {e}") from e
    if not ack.get("ok"):
        cw.close_dag_conn(conn)
        raise EngineStreamError(f"stream attach rejected: {ack.get('error')}")
    return TokenStream(cw, conn, reader, sid, timeout=timeout)
