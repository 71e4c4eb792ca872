"""TCP socket transport for the storage gateway.

The gateway's framed wire codec and in-process channel already have
exactly the contract a socket needs (``request(frame) -> ReplyFuture``);
this module carries those same frames over a real stream so clients in
other processes/hosts reach the gateway — and their hash bursts still fuse on
one shared engine (the paper's cross-client offload argument only pays
off when many *remote* clients' requests coalesce on one device).

Stream framing is length-prefixed: every codec frame is sent as a
``!I`` byte-count header followed by the frame bytes.  The length
prefix is attacker-controlled on the server side, so both ends refuse
to allocate past ``max_frame_bytes`` — a hostile prefix kills the
connection instead of the process.

  SocketChannel  — client endpoint.  ``request(frame)`` registers the
                   frame's rid, sends it, and returns a
                   :class:`ReplyFuture`; a reader thread matches
                   response frames back to futures by rid (responses
                   may arrive out of request order — the gateway
                   completes tenants independently).  Abrupt disconnect
                   resolves every in-flight future with an ``ST_ERROR``
                   (``ConnectionError``) frame; graceful ``close()``
                   half-closes the write side and drains outstanding
                   replies before tearing down.
  GatewayServer  — accept loop + per-connection reader/writer threads.
                   The reader decodes stream frames and feeds
                   ``gateway.handle_frame``; the writer sends each
                   connection's replies back in request order.  A
                   client half-close (EOF after its last request) still
                   gets all pending responses; an abrupt disconnect
                   just drains the futures without writing.  Server
                   ``close()`` stops accepting, half-closes every
                   connection, and joins the drain.

``GatewayClient`` works unchanged over either transport — pass it a
``GatewayServer``/``SocketChannel``/address instead of a
``StorageGateway``.
"""
from __future__ import annotations

import queue
import select
import socket
import struct
import threading
from typing import Dict, Optional, Tuple, Union

from repro_torch.obs import MetricsRegistry
from repro_torch.serve.storage_service import (MAX_FRAME_BYTES, ST_ERROR,
                                               ReplyFuture, StorageGateway,
                                               _REQ_HDR, _RSP_HDR,
                                               encode_response)

_LEN = struct.Struct("!I")

# per-call non-blocking send flag (Linux/BSD; 0 elsewhere degrades the
# server writer's abortable send back to a blocking one)
_MSG_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)

if hasattr(select, "poll"):
    # poll has no FD_SETSIZE ceiling — select.select raises ValueError
    # for fds >= 1024, which a busy server crosses routinely
    def _wait_writable(sock: socket.socket, timeout_s: float) -> bool:
        p = select.poll()
        p.register(sock.fileno(), select.POLLOUT)
        return bool(p.poll(timeout_s * 1000.0))
else:                                             # pragma: no cover
    def _wait_writable(sock: socket.socket, timeout_s: float) -> bool:
        _r, w, _x = select.select([], [sock], [], timeout_s)
        return bool(w)

Address = Union[str, Tuple[str, int]]


class FrameError(ConnectionError):
    """The stream violated the framing protocol (oversized length
    prefix, or EOF in the middle of a frame)."""


def parse_address(address: Address) -> Tuple[str, int]:
    """``(host, port)`` pass through; strings split on the LAST colon,
    with IPv6 literals in brackets (``[::1]:8080``).  An unbracketed
    multi-colon host is rejected rather than guessed at."""
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        elif ":" in host:
            raise ValueError(
                f"ambiguous IPv6 address {address!r}; use [host]:port")
        if not host or not port.isdigit():
            raise ValueError(f"bad address {address!r}; want host:port")
        return host, int(port)
    host, port = address
    return host, int(port)


def send_frame(sock: socket.socket, frame: bytes,
               max_frame_bytes: int = MAX_FRAME_BYTES,
               sendall=None):
    """Callers must serialize sends per socket (client write lock /
    single server writer thread) — the prefix and body are two writes
    for large frames, so interleaved senders would corrupt the stream.
    ``sendall`` overrides how the bytes go out (the server writer
    passes its abortable send) without duplicating the framing
    policy."""
    if sendall is None:
        sendall = sock.sendall
    if len(frame) > max_frame_bytes:
        raise FrameError(
            f"refusing to send {len(frame)}-byte frame "
            f"(max_frame_bytes={max_frame_bytes})")
    if len(frame) <= 1 << 16:
        sendall(_LEN.pack(len(frame)) + frame)
    else:
        # don't copy a large payload just to prepend 4 bytes
        sendall(_LEN.pack(len(frame)))
        sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary,
    FrameError on EOF mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise FrameError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket,  # ra: decode-boundary
               max_frame_bytes: int = MAX_FRAME_BYTES
               ) -> Optional[bytes]:
    """Read one length-prefixed frame; None on clean EOF.  The length
    prefix is validated BEFORE any allocation — a hostile peer cannot
    make us reserve an unbounded buffer."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > max_frame_bytes:
        raise FrameError(
            f"peer announced {n}-byte frame "
            f"(max_frame_bytes={max_frame_bytes})")
    if n == 0:
        return b""
    got = _recv_exact(sock, n)
    if got is None:
        raise FrameError("connection closed mid-frame")
    return got


# ----------------------------------------------------------------------
# client endpoint
# ----------------------------------------------------------------------
class SocketChannel:
    """Client side of one TCP connection to a :class:`GatewayServer`.

    Implements the in-process ``GatewayChannel`` contract —
    ``request(frame) -> ReplyFuture`` — so :class:`~repro_torch.serve.
    storage_client.GatewayClient` is transport-agnostic.  Request ids
    must be unique per connection (``GatewayClient`` already counts
    them per session); replies are matched by rid, so they may resolve
    in any order.
    """

    def __init__(self, address: Address,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 connect_timeout_s: float = 10.0):
        self._max = max_frame_bytes
        self._sock = socket.create_connection(parse_address(address),
                                              timeout=connect_timeout_s)
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        self._pending: Dict[int, Tuple[int, ReplyFuture]] = {}  # guarded by self._lock
        self._closing = False  # no NEW requests; guarded by self._lock
        self._dead = False  # reader gone, nothing in flight; guarded by self._lock
        self._reader = threading.Thread(target=self._reader_loop,
                                        daemon=True,
                                        name="socket-channel-rx")
        self._reader.start()

    # -- transport contract --------------------------------------------
    def request(self, frame: bytes) -> ReplyFuture:
        op, _session, rid, _trace = _REQ_HDR.unpack_from(frame)  # ra: disable=RA03(frame was encoded by our own codec one call up; not wire bytes)
        reply = ReplyFuture()
        with self._lock:
            if self._closing or self._dead:
                reply._resolve(self._error_frame(
                    op, rid, "socket channel is closed"))
                return reply
            if rid in self._pending:
                raise ValueError(f"duplicate in-flight rid {rid}")
            self._pending[rid] = (op, reply)
        try:
            with self._wlock:
                send_frame(self._sock, frame, self._max)  # ra: disable=RA04(_wlock exists solely to serialise frame writes; never nested)
        except OSError as e:
            with self._lock:
                self._pending.pop(rid, None)
            reply._resolve(self._error_frame(op, rid, f"send failed: {e}"))
        return reply

    def close(self, timeout_s: float = 10.0):
        """Graceful: half-close the write side so the server sees EOF
        after our last request, wait for it to drain our outstanding
        replies, then release the socket.  Idempotent."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        with self._wlock:        # let an in-progress send finish: a
            try:                 # mid-frame SHUT_WR would look like a
                self._sock.shutdown(socket.SHUT_WR)   # protocol abort
            except OSError:      # to the server and drop that reply
                pass
        self._reader.join(timeout=timeout_s)
        try:
            self._sock.close()
        except OSError:
            pass

    # -- internals -----------------------------------------------------
    @staticmethod
    def _error_frame(op: int, rid: int, msg: str) -> bytes:
        return encode_response(ST_ERROR, op, rid,
                               errtype="ConnectionError", msg=msg)

    def _reader_loop(self):  # ra: disable=RA05(per-connection thread; lifetime == socket lifetime, exits on EOF)
        why = "server closed the connection"
        try:
            while True:
                frame = recv_frame(self._sock, self._max)
                if frame is None:
                    break
                if len(frame) < _RSP_HDR.size:
                    why = "short response frame"
                    break
                _status, _op, rid = _RSP_HDR.unpack_from(frame)
                with self._lock:
                    entry = self._pending.pop(rid, None)
                if entry is not None:
                    entry[1]._resolve(frame)
        except (OSError, FrameError) as e:
            why = f"connection lost: {e}"
        finally:
            with self._lock:
                self._dead = True
                stranded = list(self._pending.items())
                self._pending.clear()
            # abrupt disconnect: every in-flight future resolves to an
            # ST_ERROR frame instead of hanging its waiter forever
            for rid, (op, reply) in stranded:
                reply._resolve(self._error_frame(op, rid, why))


# ----------------------------------------------------------------------
# server
# ----------------------------------------------------------------------
class _Connection:
    # writer send-poll interval: an abort (server close kicking a
    # connection wedged on a non-draining client) is noticed within
    # this long even while the peer's receive window is closed
    SEND_POLL_S = 0.2

    def __init__(self, server: "GatewayServer", sock: socket.socket,
                 peer):
        self.server = server
        self.sock = sock
        self.peer = peer
        self.aborted = False           # peer vanished: drain, don't send
        # bounded: once max_pipeline replies are queued ahead of the
        # writer the reader blocks in put() and stops pulling frames off
        # the socket — TCP flow control pushes back on the client, so a
        # connection that pipelines requests without draining responses
        # holds at most max_pipeline reply frames of server memory
        # instead of growing without bound
        self.writeq: "queue.Queue" = queue.Queue(
            maxsize=server.max_pipeline)
        self.reader = threading.Thread(target=self._reader_loop,
                                       daemon=True,
                                       name=f"gw-conn-rx-{peer}")
        self.writer = threading.Thread(target=self._writer_loop,
                                       daemon=True,
                                       name=f"gw-conn-tx-{peer}")
        self.reader.start()
        self.writer.start()

    def _reader_loop(self):  # ra: disable=RA05(per-connection thread; lifetime == socket lifetime, exits on EOF)
        srv = self.server
        try:
            while True:
                frame = recv_frame(self.sock, srv.max_frame_bytes)
                if frame is None:      # half-close: no more requests,
                    break              # writer still drains responses
                srv.stats.inc("frames")
                # owner=self: sessions opened on this connection are
                # usable only from this connection — another client
                # naming the same session id gets UnknownSession
                self.writeq.put(srv.gateway.handle_frame(frame,
                                                         owner=self))
        except FrameError:
            # protocol violation (hostile length prefix, EOF mid-frame):
            # stop reading and tell the writer to drain in-flight
            # replies without touching the untrusted stream
            self.aborted = True
            srv.stats.inc("frame_errors")
        except OSError:
            # routine abrupt disconnect (RST, crashed client) — not a
            # protocol violation; counted separately so frame_errors
            # stays a clean hostile-peer signal
            self.aborted = True
            srv.stats.inc("disconnects")
        finally:
            self.writeq.put(None)

    def _send_abortable(self, data: bytes):
        """sendall that a concurrent abort (server close) can interrupt:
        a blocking send() to a client that stopped draining its replies
        queues the whole buffer before returning and shutdown() cannot
        wake it, so it would wedge this thread forever.  Instead wait
        for writability in short slices, checking ``aborted`` between
        them, and send without blocking (MSG_DONTWAIT where available —
        a per-call flag, since O_NONBLOCK on a dup'd fd would leak to
        the reader's shared file description)."""
        view = memoryview(data)
        while view:
            if self.aborted:
                raise OSError("connection aborted during send")
            if not _wait_writable(self.sock, self.SEND_POLL_S):
                continue
            try:
                view = view[self.sock.send(view, _MSG_DONTWAIT):]
            except BlockingIOError:
                continue               # lost the race for buffer space

    def _writer_loop(self):  # ra: disable=RA05(per-connection thread; bounded writeq, exits on sentinel)
        srv = self.server
        got_sentinel = False
        try:
            while True:
                reply = self.writeq.get()
                if reply is None:
                    got_sentinel = True
                    break
                try:
                    frame = reply.result(timeout=srv.reply_timeout_s)
                except TimeoutError:
                    # a stuck gateway reply: the connection is wedged
                    # (responses are written in request order); abort
                    self.aborted = True
                    break
                if self.aborted:
                    continue           # keep draining futures
                try:
                    send_frame(self.sock, frame, srv.max_frame_bytes,
                               sendall=self._send_abortable)
                except OSError:
                    self.aborted = True
        finally:
            self.half_close(read=True)
            try:
                self.sock.close()
            except OSError:
                pass
            # on a timeout/abort exit the bounded writeq may still be
            # full with the reader blocked in put(); keep consuming
            # until the reader's sentinel so it can observe the closed
            # socket and exit instead of hanging forever
            while not got_sentinel:
                got_sentinel = self.writeq.get() is None
            # the connection's sessions die with it — the ids must not
            # stay live in the gateway table after the authenticated
            # connection is gone
            srv.gateway.drop_sessions(self)
            srv._forget(self)

    def half_close(self, read: bool = True):
        try:
            self.sock.shutdown(socket.SHUT_RD if read
                               else socket.SHUT_WR)
        except OSError:
            pass

    def join(self, timeout_s: float):
        self.reader.join(timeout=timeout_s)
        self.writer.join(timeout=timeout_s)


class GatewayServer:
    """Accept loop serving a :class:`StorageGateway` over TCP.

    ``port=0`` binds an ephemeral port; ``address`` is the bound
    ``(host, port)``.  ``connect()`` returns a :class:`SocketChannel`
    to this server, so ``GatewayClient(server, ...)`` works exactly
    like ``GatewayClient(gateway, ...)``.  The server owns its
    connections but NOT the gateway (callers may front one gateway
    with several listeners, or keep serving in-process clients).

    Sessions are connection-scoped: each frame is handled with its
    connection as the session owner, so a session id opened on one
    connection is dead weight on every other — guessing another
    client's (small, sequential) session id gets ``UnknownSession``,
    and a connection's sessions are dropped when it goes away.
    """

    def __init__(self, gateway: StorageGateway, host: str = "127.0.0.1",
                 port: int = 0,
                 max_frame_bytes: Optional[int] = None,
                 backlog: int = 64, reply_timeout_s: float = 600.0,
                 max_pipeline: int = 32):
        self.gateway = gateway
        self.max_frame_bytes = (gateway.cfg.max_frame_bytes
                                if max_frame_bytes is None
                                else max_frame_bytes)
        self.reply_timeout_s = reply_timeout_s
        # per-connection cap on replies queued ahead of the writer; the
        # worst case a non-draining client can pin is roughly
        # max_pipeline * max_frame_bytes of this server's memory
        if max_pipeline < 1:
            raise ValueError("max_pipeline must be >= 1")
        self.max_pipeline = max_pipeline
        self._lock = threading.Lock()
        self._conns: set = set()  # guarded by self._lock
        self._closed = False  # guarded by self._lock
        # atomic counters: connection reader threads bump these without
        # taking the server lock
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.group(
            ("connections", "frames", "frame_errors", "disconnects"))
        # resolve the bind family from the host (AF_INET6 for IPv6
        # literals/names) instead of hard-coding AF_INET; "" means
        # wildcard, which getaddrinfo only understands as None
        family, _, _, _, sockaddr = socket.getaddrinfo(
            host or None, port, type=socket.SOCK_STREAM,
            flags=socket.AI_PASSIVE)[0]
        self._lsock = socket.socket(family, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if family == socket.AF_INET6:
            # dual-stack where the platform allows it: a wildcard or
            # hostname bind that resolved to v6 must not silently stop
            # serving IPv4 clients (v6only defaults vary by platform)
            try:
                self._lsock.setsockopt(socket.IPPROTO_IPV6,
                                       socket.IPV6_V6ONLY, 0)
            except (OSError, AttributeError):
                pass
        self._lsock.bind(sockaddr)
        self._lsock.listen(backlog)
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True,
                                          name="gw-server-accept")
        self._acceptor.start()

    def connect(self) -> SocketChannel:
        return SocketChannel(self.address,
                             max_frame_bytes=self.max_frame_bytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _accept_loop(self):  # ra: disable=RA05(accept loop blocks in the kernel, not on our queues; exits on close)
        while True:
            try:
                sock, peer = self._lsock.accept()
            except OSError:            # listener closed
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                self.stats.inc("connections")
                self._conns.add(_Connection(self, sock, peer))

    def _forget(self, conn: _Connection):
        with self._lock:
            self._conns.discard(conn)

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            return {**self.stats, "open_connections": len(self._conns)}

    def close(self, timeout_s: float = 30.0):
        """Graceful: stop accepting, half-close every connection's read
        side (reader sees EOF), and join the writers — each drains its
        in-flight replies before the socket closes.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        try:
            # close() alone does not wake a thread blocked in accept()
            # on Linux (the join below would wait out its timeout);
            # shutdown() does
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._acceptor.join(timeout=timeout_s)
        for conn in conns:
            conn.half_close(read=True)
        for conn in conns:
            conn.join(timeout_s)
            if conn.reader.is_alive() or conn.writer.is_alive():
                # the graceful drain didn't finish — e.g. the writer is
                # wedged sending to a client that pipelined big reads
                # and stopped draining (which also wedges the reader in
                # the bounded writeq).  Flag the abort: the writer's
                # send loop polls it (SEND_POLL_S), switches to
                # draining, and runs the teardown (session drop,
                # _forget); shutdown is a backstop for a reader still
                # blocked in recv.
                conn.aborted = True
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.join(timeout_s)
