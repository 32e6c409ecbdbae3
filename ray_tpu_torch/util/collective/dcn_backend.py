"""DCN backend: cross-process collectives over TCP with KV rendezvous.

The analog of the reference's GLOO backend
(reference: python/ray/util/collective/collective_group/
gloo_collective_group.py, 565 LoC pygloo ring collectives; rendezvous via a
named store).  Used for out-of-band tensor movement between worker actors
on different hosts, and between the worker processes of one host until an
NCCL backend exists (ROADMAP, Queue 1: multi-GPU).  Rendezvous goes through the head's KV (the reference used a named
NCCLUniqueIDStore actor, collective_group/util.py:9; GCS KV is the
centralized equivalent, exactly what SURVEY §2.4 prescribes).

Topology: every rank listens; rank i connects to (i+1) % n forming a
ring.  Algorithms: ring allreduce (reduce-scatter + allgather over
chunks), ring allgather, tree broadcast via ring rotation — bandwidth
optimal for large tensors over slow links.  Arbitrary-pair send/recv
(reference: util/collective/collective.py:531,594) dials direct cached
connections through the same rendezvous addresses, admitted by a
standing accept loop.
"""

from __future__ import annotations

import os
import secrets
import select
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.util.collective.types import ReduceOp

_LEN = struct.Struct("<Q")
_U16 = struct.Struct("<H")
_U8 = struct.Struct("<B")
_IO_CHUNK = 1 << 20  # bounded per-syscall transfer so send/recv interleave


def _configure_socket(sock: socket.socket) -> None:
    """Data-plane socket tuning: NODELAY (frame latency) + kernel buffer
    sizing from config.  The default 128-208KB SO_SNDBUF is what capped
    the p2p obs path around ~20MB/s — each sendall round-trips the
    application once per buffer-full; multi-MB buffers let the kernel
    stream a whole pipelined window per wakeup."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        from ray_tpu_torch._private.config import RayConfig

        size = int(RayConfig.collective_socket_buffer_bytes)
    except Exception:  # graftlint: disable=silent-except -- config not importable in stripped test harnesses; kernel defaults are functional
        size = 0
    if size > 0:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, size)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, size)
        except OSError:
            pass  # kernel clamp (rmem_max/wmem_max); the clamped value still helps


def _send_view_chunked(sock: socket.socket, view: memoryview, chunk: int = 0) -> None:
    """Pipelined zero-copy send of a raw byte view: bounded memoryview
    slices straight from the source buffer — no tobytes()/full-array
    materialization ever, and per-syscall chunks small enough that the
    receiver's recv_into drains concurrently (the pipelining half of the
    p2p throughput fix; _configure_socket is the buffer half)."""
    chunk = chunk if chunk > 0 else _IO_CHUNK
    n = view.nbytes
    off = 0
    while off < n:
        sock.sendall(view[off : off + chunk])
        off += chunk


def _self_ip() -> str:
    """The address other processes reach us at when RAY_TPU_NODE_IP is
    unset: loopback, since the port's clusters run on one host.  No route
    probe toward an outside address is made."""
    return "127.0.0.1"


def _send_msg(sock: socket.socket, payload: bytes):
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_bounded_msg(sock: socket.socket, max_len: int) -> bytes:
    """Like _recv_msg but refuses oversized frames BEFORE allocating —
    for reads from unverified peers."""
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    if n > max_len:
        raise ConnectionError(f"frame too large from unverified peer ({n} bytes)")
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> bytes:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("collective peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(1 << 20, n - got))
        if r == 0:
            raise ConnectionError("collective peer closed")
        got += r
    return bytes(buf)


def _encode_array(arr: np.ndarray):
    """One length-prefixed frame per array.  Fixed struct header (dtype str +
    shape) — no pickle on the wire, so a peer can never inject code via the
    header.  Returns (prefix_bytes, data_view); data is not copied."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str.encode("ascii")
    shape = arr.shape
    header = (
        _U16.pack(len(dt))
        + dt
        + _U8.pack(len(shape))
        + struct.pack(f"<{len(shape)}q", *shape)
    )
    data = memoryview(arr).cast("B")
    prefix = _LEN.pack(len(header) + len(data)) + header
    return prefix, data


def _decode_array(payload) -> np.ndarray:
    view = memoryview(payload)
    (dt_len,) = _U16.unpack_from(view, 0)
    off = _U16.size
    dtype = np.dtype(view[off : off + dt_len].tobytes().decode("ascii"))
    off += dt_len
    (ndim,) = _U8.unpack_from(view, off)
    off += _U8.size
    shape = struct.unpack_from(f"<{ndim}q", view, off)
    off += 8 * ndim
    return np.frombuffer(view[off:], dtype=dtype).reshape(shape)


def _send_array(sock: socket.socket, arr: np.ndarray):
    prefix, data = _encode_array(arr)
    sock.sendall(prefix)
    _send_view_chunked(sock, data)


def _recv_payload(sock: socket.socket) -> bytearray:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("collective peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(_IO_CHUNK, n - got))
        if r == 0:
            raise ConnectionError("collective peer closed")
        got += r
    return buf


def _recv_array(sock: socket.socket) -> np.ndarray:
    return _decode_array(_recv_payload(sock))


def _exchange_array(
    send_sock: socket.socket, recv_sock: socket.socket, arr: np.ndarray, timeout: float = 600.0
) -> np.ndarray:
    """Full-duplex: send `arr` on send_sock while receiving one array from
    recv_sock, interleaved via select with bounded per-syscall transfers.

    This is what makes the ring safe for arbitrarily large tensors: a naive
    sendall-then-recv has every rank blocking in send once a chunk exceeds
    the kernel TCP buffers (all ranks send simultaneously, nobody drains).
    NCCL/pygloo rings pipeline segments for the same reason."""
    pending = [m for m in _encode_array(arr) if len(m)]
    pending = [memoryview(m) for m in pending]
    recv_hdr = bytearray()
    recv_buf: Optional[bytearray] = None
    recv_view: Optional[memoryview] = None
    recv_got = 0
    recv_need = -1
    send_sock.setblocking(False)
    try:
        deadline = time.time() + timeout
        while pending or recv_need != 0:
            if time.time() > deadline:
                raise TimeoutError("collective exchange timed out")
            rlist = [recv_sock] if recv_need != 0 else []
            wlist = [send_sock] if pending else []
            readable, writable, _ = select.select(rlist, wlist, [], 10.0)
            if writable:
                head = pending[0]
                try:
                    sent = send_sock.send(head[:_IO_CHUNK])
                except (BlockingIOError, InterruptedError):
                    sent = 0
                if sent:
                    if sent == len(head):
                        pending.pop(0)
                    else:
                        pending[0] = head[sent:]
            if readable:
                if recv_need < 0:
                    chunk = recv_sock.recv(_LEN.size - len(recv_hdr))
                    if not chunk:
                        raise ConnectionError("collective peer closed")
                    recv_hdr += chunk
                    if len(recv_hdr) == _LEN.size:
                        (recv_need,) = _LEN.unpack(recv_hdr)
                        recv_buf = bytearray(recv_need)
                        recv_view = memoryview(recv_buf)
                elif recv_need > 0:
                    r = recv_sock.recv_into(
                        recv_view[recv_got:], min(_IO_CHUNK, recv_need - recv_got)
                    )
                    if r == 0:
                        raise ConnectionError("collective peer closed")
                    recv_got += r
                    if recv_got == recv_need:
                        recv_need = 0
    finally:
        send_sock.setblocking(True)
    return _decode_array(recv_buf)


def _reduce_arrays(a: np.ndarray, b: np.ndarray, op: ReduceOp) -> np.ndarray:
    if op == ReduceOp.SUM:
        return a + b
    if op == ReduceOp.PRODUCT:
        return a * b
    if op == ReduceOp.MIN:
        return np.minimum(a, b)
    if op == ReduceOp.MAX:
        return np.maximum(a, b)
    raise ValueError(op)


class DcnGroup:
    """One rank's membership in a TCP ring collective group."""

    def __init__(self, group_name: str, world_size: int, rank: int, kv, nonce: str = ""):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._kv = kv  # callable interface: kv_put(key, value), kv_get(key, wait, timeout)
        # rendezvous namespace: a caller-supplied per-incarnation nonce
        # keeps a respawned gang's rendezvous disjoint from a dead
        # predecessor's — without it, kv_get(wait=True) happily returns the
        # STALE addr/token a crashed same-name group left behind and the
        # fresh ring dials corpses until the accept deadline (the exact
        # checkpoint-respawn hang train/torch/step_dag.py must never have)
        self._ns = f"{group_name}:{nonce}" if nonce else group_name
        self._next_sock: Optional[socket.socket] = None
        self._prev_sock: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # arbitrary-pair p2p: dial-by-rank connections on demand (the
        # rendezvous already publishes every rank's addr), accepted by a
        # standing thread for the group's lifetime
        self._p2p_out: Dict[int, socket.socket] = {}
        self._p2p_in: Dict[int, socket.socket] = {}
        self._p2p_cv = threading.Condition()
        # per-source recv serialization (mirrors the ring path's
        # self._lock): two threads recv()ing from one src must not
        # interleave frame reads on the same socket
        self._p2p_recv_locks: Dict[int, threading.Lock] = {}
        self._p2p_token: Optional[str] = None
        self._closed = False
        if world_size > 1:
            self._build_ring()
            threading.Thread(target=self._p2p_accept_loop, daemon=True).start()

    # ------------------------------------------------------------- topology

    def _kv_key(self, rank: int) -> str:
        return f"collective:{self._ns}:addr:{rank}"

    def _token_key(self, rank: int) -> str:
        return f"collective:{self._ns}:token:{rank}"

    def _build_ring(self):
        """Every rank listens; rank i dials rank (i+1) % n.  Addresses and
        per-rank join tokens are published through the head KV (rendezvous);
        an inbound connection is admitted only after a hello frame carrying
        (group, rank, token) matches the KV-published token — a stray or
        malicious connection cannot occupy a ring slot, and the hello is a
        fixed text frame, never unpickled."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(4)
        self._listener = listener
        port = listener.getsockname()[1]
        # advertise an address other hosts can dial, not the bind wildcard:
        # RAY_TPU_NODE_IP wins, else loopback (single-host)
        host = os.environ.get("RAY_TPU_NODE_IP") or _self_ip()
        token = secrets.token_hex(16)
        self._p2p_token = token  # p2p dialers prove KV access with OUR token
        self._kv.kv_put(self._token_key(self.rank), token.encode())
        self._kv.kv_put(self._kv_key(self.rank), f"{host}:{port}".encode())

        next_rank = (self.rank + 1) % self.world_size
        prev_rank = (self.rank - 1) % self.world_size
        # Every rank publishes before waiting on anything, so these two gets
        # cannot deadlock; fetching the expected token here (main thread)
        # keeps KV access out of the accept thread.
        expected = self._kv.kv_get(self._token_key(prev_rank), wait=True, timeout=120)
        if expected is None:
            raise TimeoutError(f"rendezvous timed out for rank {prev_rank} token")
        expected_hello = f"{self.group_name}\n{prev_rank}\n{expected.decode()}".encode()

        # accept from prev in a thread while dialing next (avoids deadlock)
        accepted: List[socket.socket] = []

        def _accept():
            deadline = time.time() + 120
            listener.settimeout(10)
            while time.time() < deadline:
                try:
                    sock, _ = listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                _configure_socket(sock)
                try:
                    # Bounded hello read: length is attacker-controlled until
                    # verified, so never allocate it blindly, and give slow
                    # strays only a short window so they can't exhaust the
                    # rendezvous deadline.
                    sock.settimeout(5)
                    hello = _recv_bounded_msg(sock, max_len=4096)
                    sock.settimeout(None)
                except Exception:
                    sock.close()
                    continue
                if hello != expected_hello:
                    sock.close()
                    continue
                accepted.append(sock)
                return

        t = threading.Thread(target=_accept, daemon=True)
        t.start()

        addr = self._kv.kv_get(self._kv_key(next_rank), wait=True, timeout=120)
        if addr is None:
            raise TimeoutError(f"rendezvous timed out for rank {next_rank}")
        nhost, nport = addr.decode().rsplit(":", 1)
        deadline = time.time() + 120
        while True:
            try:
                s = socket.create_connection((nhost, int(nport)), timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        _configure_socket(s)
        _send_msg(s, f"{self.group_name}\n{self.rank}\n{token}".encode())
        self._next_sock = s
        t.join(timeout=120)
        if not accepted:
            raise TimeoutError("ring accept timed out (no verified peer)")
        self._prev_sock = accepted[0]

    # ----------------------------------------------------------- primitives

    def send_next(self, arr: np.ndarray):
        _send_array(self._next_sock, arr)

    def recv_prev(self) -> np.ndarray:
        return _recv_array(self._prev_sock)

    # -------------------------------------------------------- arbitrary p2p

    def _p2p_accept_loop(self):
        """Standing accept loop for the group's lifetime: admits dial-by-
        rank p2p connections (hello: p2p\\n<group>\\n<src>\\n<our token>,
        acked with "ok" so the dialer knows it wasn't consumed by a stray
        ring-build accept) and registers them by source rank."""
        listener = self._listener
        if listener is None:
            return
        listener.settimeout(1.0)
        while not self._closed:
            try:
                sock, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                _configure_socket(sock)
                sock.settimeout(5)
                parts = _recv_bounded_msg(sock, max_len=4096).decode().split("\n")
                if (
                    len(parts) == 4
                    and parts[0] == "p2p"
                    and parts[1] == self.group_name
                    and parts[3] == self._p2p_token
                ):
                    src = int(parts[2])
                    sock.settimeout(None)
                    _send_msg(sock, b"ok")
                    with self._p2p_cv:
                        old = self._p2p_in.pop(src, None)
                        self._p2p_in[src] = sock
                        self._p2p_cv.notify_all()
                    if old is not None:
                        old.close()
                else:
                    sock.close()
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass

    def _p2p_connect(self, dst_rank: int) -> socket.socket:
        """Get-or-dial a direct connection to dst_rank (cached).  Retries
        until the destination's standing accept loop admits us — a dial
        racing the ring build may be consumed and closed there."""
        sock = self._p2p_out.get(dst_rank)
        if sock is not None:
            return sock
        addr = self._kv.kv_get(self._kv_key(dst_rank), wait=True, timeout=120)
        token = self._kv.kv_get(self._token_key(dst_rank), wait=True, timeout=120)
        if addr is None or token is None:
            raise TimeoutError(f"p2p rendezvous timed out for rank {dst_rank}")
        host, port = addr.decode().rsplit(":", 1)
        hello = f"p2p\n{self.group_name}\n{self.rank}\n{token.decode()}".encode()
        deadline = time.time() + 120
        while True:
            s = None
            try:
                s = socket.create_connection((host, int(port)), timeout=10)
                _configure_socket(s)
                _send_msg(s, hello)
                s.settimeout(10)
                if _recv_bounded_msg(s, max_len=16) == b"ok":
                    s.settimeout(None)
                    self._p2p_out[dst_rank] = s
                    return s
                s.close()
            except (OSError, ConnectionError):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            if time.time() > deadline:
                raise TimeoutError(f"p2p connect to rank {dst_rank} timed out")
            time.sleep(0.1)

    # ----------------------------------------------------------- collectives

    def allreduce(self, arr: np.ndarray, op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
        """Ring allreduce: n-1 reduce-scatter steps + n-1 allgather steps on
        equal chunks — 2(n-1)/n × data moved per link."""
        n = self.world_size
        if n == 1:
            return arr.copy()
        with self._lock:
            flat = np.ascontiguousarray(arr).reshape(-1)
            chunks = np.array_split(flat, n)
            chunks = [c.copy() for c in chunks]
            # reduce-scatter (full-duplex per step: all ranks send+recv
            # simultaneously, so the exchange must interleave — see
            # _exchange_array)
            for step in range(n - 1):
                send_idx = (self.rank - step) % n
                recv_idx = (self.rank - step - 1) % n
                # graftsan: disable=GS002 -- _lock serializes whole collectives on this group's ring sockets (a dedicated data-plane thread); socket IO under it IS the collective, bounded by the socket timeout
                incoming = _exchange_array(self._next_sock, self._prev_sock, chunks[send_idx])
                chunks[recv_idx] = _reduce_arrays(chunks[recv_idx], incoming, op)
            # allgather
            for step in range(n - 1):
                send_idx = (self.rank + 1 - step) % n
                recv_idx = (self.rank - step) % n
                # graftsan: disable=GS002 -- same contract as the reduce-scatter phase above
                chunks[recv_idx] = _exchange_array(
                    self._next_sock, self._prev_sock, chunks[send_idx]
                )
            out = np.concatenate(chunks)
            return out.reshape(arr.shape).astype(arr.dtype, copy=False)

    def reduce(self, arr: np.ndarray, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
        out = self.allreduce(arr, op)
        return out if self.rank == dst_rank else arr

    def broadcast(self, arr: np.ndarray, src_rank: int = 0, topology: str = "ring") -> np.ndarray:
        """Broadcast from src_rank.  ``topology="ring"`` rotates around the
        ring (n-1 serial hops — bandwidth-fine, latency O(n)); ``"tree"``
        runs a binomial tree over the p2p links (O(log n) depth, and every
        internal rank re-serves its subtree so aggregate bandwidth stops
        being bottlenecked on the source's single uplink — the fan-out
        shape the device tier's one-producer-many-consumer pulls use)."""
        n = self.world_size
        if n == 1:
            return arr
        if topology == "tree":
            return self._broadcast_tree(arr, src_rank)
        with self._lock:
            if self.rank == src_rank:
                self.send_next(arr)
                return arr
            data = self.recv_prev()
            if (self.rank + 1) % n != src_rank:
                self.send_next(data)
            return data

    def _broadcast_tree(self, arr: np.ndarray, src_rank: int) -> np.ndarray:
        """Binomial-tree broadcast (MPICH shape): rank r relative to the
        source receives once from r minus its lowest set bit, then forwards
        to r + mask for every mask below the receive bit."""
        n = self.world_size
        rel = (self.rank - src_rank) % n
        data = arr
        mask = 1
        while mask < n:
            if rel & mask:
                data = self.recv((self.rank - mask) % n)
                break
            mask <<= 1
        mask >>= 1
        while mask > 0:
            if rel + mask < n:
                self.send(np.asarray(data), (self.rank + mask) % n)
            mask >>= 1
        return data

    def allgather(self, arr: np.ndarray) -> List[np.ndarray]:
        n = self.world_size
        if n == 1:
            return [arr.copy()]
        with self._lock:
            pieces: Dict[int, np.ndarray] = {self.rank: np.ascontiguousarray(arr)}
            current = pieces[self.rank]
            cur_rank = self.rank
            for _ in range(n - 1):
                # graftsan: disable=GS002 -- same contract as allreduce: collectives serialize on _lock by design
                current = _exchange_array(self._next_sock, self._prev_sock, current)
                cur_rank = (cur_rank - 1) % n
                pieces[cur_rank] = current
            return [pieces[i] for i in range(n)]

    def reducescatter(self, arr: np.ndarray, op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
        full = self.allreduce(arr, op)
        flat = full.reshape(-1)
        return np.array_split(flat, self.world_size)[self.rank]

    def barrier(self):
        self.allreduce(np.zeros(1, dtype=np.float32))

    def send(self, arr: np.ndarray, dst_rank: int):
        """Point-to-point send to ANY rank (reference analog:
        util/collective/collective.py:531 send).  Ring neighbors reuse the
        ring link (zero extra connections on the hot path); other pairs
        dial a direct cached connection via the rendezvous addresses."""
        if dst_rank == self.rank:
            raise ValueError("p2p send to self")
        if dst_rank == (self.rank + 1) % self.world_size:
            with self._lock:
                self.send_next(arr)
        else:
            _send_array(self._p2p_connect(dst_rank), arr)

    def recv(self, src_rank: int) -> np.ndarray:
        """Point-to-point receive from ANY rank (reference analog:
        util/collective/collective.py:594 recv).

        The read itself holds a per-source lock — concurrent recv() from
        one src must not interleave frames on the shared socket — and
        retries once when the socket failed because the accept loop
        replaced it mid-read (peer redial closes the old socket under
        us; the replacement carries the fresh stream)."""
        if src_rank == self.rank:
            raise ValueError("p2p recv from self")
        if src_rank == (self.rank - 1) % self.world_size:
            with self._lock:
                return self.recv_prev()
        deadline = time.time() + 120
        with self._p2p_cv:
            lock = self._p2p_recv_locks.setdefault(src_rank, threading.Lock())
        with lock:
            sock = self._wait_p2p_sock(src_rank, deadline)
            try:
                return _recv_array(sock)
            except OSError:
                with self._p2p_cv:
                    cur = self._p2p_in.get(src_rank)
                if cur is None or cur is sock or self._closed:
                    raise  # genuine transport failure, no replacement
                return _recv_array(cur)

    def _wait_p2p_sock(self, src_rank: int, deadline: float) -> socket.socket:
        with self._p2p_cv:
            while src_rank not in self._p2p_in:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._p2p_cv.wait(min(remaining, 5.0)):
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"p2p recv: rank {src_rank} never connected"
                        )
            return self._p2p_in[src_rank]

    def destroy(self):
        self._closed = True
        with self._p2p_cv:
            # snapshot under the cv: the accept loop mutates _p2p_in
            p2p = list(self._p2p_out.values()) + list(self._p2p_in.values())
        for s in (self._next_sock, self._prev_sock, self._listener, *p2p):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
