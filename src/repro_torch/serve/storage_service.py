"""Multi-tenant storage gateway: the serving front end for the store.

The paper evaluates its GPU-offloaded storage prototype under competing
concurrent applications (§V, Figures 12-17) and argues the offload layer
can be shared transparently.  This module is the serving subsystem that
makes that sharing real for *many clients of the storage system itself*:
instead of every client owning an :class:`repro_torch.core.sai.SAI`,
clients open sessions against one :class:`StorageGateway` and submit framed
``write`` / ``read`` / ``delete`` / ``stat`` requests.

Layering:

  wire codec        — every request/response crosses the transport as a
                      framed byte string (``encode_request`` /
                      ``decode_response`` ...).  The bundled transport is
                      in-process (``GatewayChannel.request(frame) ->
                      ReplyFuture``), but the contract is exactly what a
                      socket transport would implement, so one is a
                      drop-in follow-up.
  admission control — per-tenant outstanding-request and queued-byte
                      budgets.  Over budget => an ``ST_RETRY`` response
                      (client-side :class:`~repro_torch.serve.storage_client.
                      RetryLater`) instead of unbounded queueing: a
                      flooding tenant gets backpressure, not a growing
                      queue.
  fair-share        — weighted deficit round-robin over per-tenant
    scheduler         queues: each round a tenant's deficit grows by
                      ``quantum_bytes * weight`` and it may dispatch
                      requests whose byte cost fits the deficit, so
                      equal-weight tenants get equal *bytes* of service
                      regardless of how unequal their offered load is.
                      ``max_inflight`` bounds per-tenant dispatched
                      concurrency so the scheduler — not arrival order —
                      decides who runs next.
  cross-client      — every tenant's SAI shares the gateway's offload
    coalescing        engine, so hash requests from *different clients*
                      fuse into common batch launches.  The signature is
                      ``engine launches < total client requests`` for a
                      concurrent burst (``snapshot_stats()['launches'] <
                      ...['jobs']``) — the ROADMAP's "cross-process
                      (serve-side) coalescing" open item.
  QoS classes       — ``interactive`` / ``batch`` / ``scrub`` map onto
                      the engine's priority lanes (``fg`` > ``batch`` >
                      ``scrub``), so a batch tenant's hashing yields to
                      interactive tenants at the device queue too.
  gateway-owned     — ``GatewayConfig(scrub=True)`` makes the gateway
    cluster runtime   own a :class:`repro_torch.core.noderuntime.
                      ClusterRuntime` (integrity scrubbing, repair, GC)
                      on the same engine, started and stopped with the
                      gateway.

``snapshot_stats()`` publishes per-tenant throughput/queue/rejection
counters plus the engine's fused-launch counters; the
``benchmarks/gateway_saturation.py`` run consumes it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import struct
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.core import crystal as crystal_mod
from repro_torch.core.castore import MetadataManager, open_durable_store
from repro_torch.core.crystal import CrystalGPU
from repro_torch.core.noderuntime import ClusterRuntime, NodeRuntimeConfig
from repro_torch.core.sai import SAI, SAIConfig
from repro_torch.obs import (HealthConfig, HealthEngine,
                             HealthHTTPServer, HeartbeatBoard,
                             MetricsRegistry, MetricsSampler, Trace, Tracer,
                             truncate_tree)
from repro_torch.serve.auth import AuthError, TokenAuthenticator

# ----------------------------------------------------------------------
# wire-format codec: framed requests/responses (transport-independent)
# ----------------------------------------------------------------------
(OP_OPEN, OP_WRITE, OP_READ, OP_DELETE, OP_STAT, OP_CLOSE, OP_STATS,
 OP_HEALTH) = range(8)
ST_OK, ST_RETRY, ST_ERROR = range(3)

# Default cap on a single codec frame.  The socket transport refuses to
# allocate a receive buffer past this from a wire length prefix, and
# ``decode_request`` enforces it again at the codec layer so a hostile
# peer can't push an oversized frame through any transport.
MAX_FRAME_BYTES = 64 << 20

OP_NAMES = {OP_OPEN: "open", OP_WRITE: "write", OP_READ: "read",
            OP_DELETE: "delete", OP_STAT: "stat", OP_CLOSE: "close",
            OP_STATS: "stats", OP_HEALTH: "health"}

# QoS class -> engine priority lane (repro_torch.core.crystal.LANES order)
QOS_LANES = {"interactive": "fg", "batch": "batch", "scrub": "scrub"}

# Every request header carries a trace id (0 = untraced): clients mint
# one per request and the gateway records per-stage spans against it.
_REQ_HDR = struct.Struct("!BIQQ")      # op, session, rid, trace
_RSP_HDR = struct.Struct("!BBQ")       # status, op, rid
_U16 = struct.Struct("!H")
_U32 = struct.Struct("!I")
_I32 = struct.Struct("!i")
_U64 = struct.Struct("!Q")
_F64 = struct.Struct("!d")


class CodecError(ValueError):
    pass


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise CodecError("string field too long")
    return _U16.pack(len(b)) + b


def _pack_bytes(data) -> bytes:
    # the length check runs BEFORE struct packs it: data >= 4 GiB must
    # raise CodecError, not leak struct.error out of the codec
    if len(data) > 0xFFFFFFFF:
        raise CodecError(
            f"payload too large for u32 length ({len(data)} bytes)")
    return _U32.pack(len(data)) + data


def _pack_bytes16(data: bytes) -> bytes:
    if len(data) > 0xFFFF:
        raise CodecError(f"short byte field too long ({len(data)})")
    return _U16.pack(len(data)) + data


def _take_bytes16(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,), off = _take(buf, off, _U16)
    if off + n > len(buf):
        raise CodecError("truncated short byte field")
    return bytes(buf[off:off + n]), off + n


def _take(buf: bytes, off: int, st: struct.Struct):
    if off + st.size > len(buf):
        raise CodecError("truncated frame")
    return st.unpack_from(buf, off), off + st.size


def _take_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,), off = _take(buf, off, _U16)
    if off + n > len(buf):
        raise CodecError("truncated string")
    try:
        s = buf[off:off + n].decode("utf-8")
    except UnicodeDecodeError as e:
        # wire bytes are untrusted: decode failures are codec errors,
        # same contract as truncation
        raise CodecError(f"invalid utf-8 in string field: {e}") from None
    return s, off + n


def _take_bytes(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,), off = _take(buf, off, _U32)
    if off + n > len(buf):
        raise CodecError("truncated payload")
    return bytes(buf[off:off + n]), off + n


def encode_request(op: int, session: int, rid: int, **f: Any) -> bytes:
    head = _REQ_HDR.pack(op, session, rid, int(f.get("trace", 0)))
    if op == OP_OPEN:
        return head + _pack_str(f["tenant"]) + _pack_str(f["qos"]) \
            + _F64.pack(float(f.get("weight", 1.0))) \
            + _pack_bytes16(f.get("token", b""))
    if op == OP_WRITE:
        return head + _pack_str(f["path"]) + _pack_bytes(f["data"])
    if op == OP_READ:
        return head + _pack_str(f["path"]) \
            + _I32.pack(int(f.get("version", -1))) \
            + struct.pack("!B", 1 if f.get("verify", True) else 0)
    if op in (OP_DELETE, OP_STAT):
        return head + _pack_str(f["path"])
    if op in (OP_CLOSE, OP_STATS, OP_HEALTH):
        return head
    raise CodecError(f"unknown opcode {op}")


def decode_request(frame: bytes,
                   max_frame_bytes: Optional[int] = MAX_FRAME_BYTES):
    """-> (op, session, rid, fields).

    ``max_frame_bytes`` bounds the whole frame (pass ``None`` to
    disable): the socket transport already refuses oversized length
    prefixes, but enforcing the cap here too means no transport can
    hand the gateway an unbounded buffer."""
    if max_frame_bytes is not None and len(frame) > max_frame_bytes:
        raise CodecError(
            f"frame of {len(frame)} bytes exceeds max_frame_bytes "
            f"({max_frame_bytes})")
    (op, session, rid, trace), off = _take(frame, 0, _REQ_HDR)
    f: Dict[str, Any] = {}
    if trace:
        # omitted when 0 so encode(**decode(frame)) round-trips for
        # untraced frames
        f["trace"] = trace
    if op == OP_OPEN:
        f["tenant"], off = _take_str(frame, off)
        f["qos"], off = _take_str(frame, off)
        (f["weight"],), off = _take(frame, off, _F64)
        f["token"], off = _take_bytes16(frame, off)
    elif op == OP_WRITE:
        f["path"], off = _take_str(frame, off)
        f["data"], off = _take_bytes(frame, off)
    elif op == OP_READ:
        f["path"], off = _take_str(frame, off)
        (f["version"],), off = _take(frame, off, _I32)
        (v,), off = _take(frame, off, struct.Struct("!B"))
        f["verify"] = bool(v)
    elif op in (OP_DELETE, OP_STAT):
        f["path"], off = _take_str(frame, off)
    elif op in (OP_CLOSE, OP_STATS, OP_HEALTH):
        pass
    else:
        raise CodecError(f"unknown opcode {op}")
    if off != len(frame):
        raise CodecError("trailing bytes in request frame")
    return op, session, rid, f


def encode_response(status: int, op: int, rid: int, **f: Any) -> bytes:
    head = _RSP_HDR.pack(status, op, rid)
    if status == ST_RETRY:
        return head + _pack_str(f.get("reason", "over budget"))
    if status == ST_ERROR:
        return head + _pack_str(f["errtype"]) + _pack_str(f.get("msg", ""))
    if op == OP_OPEN:
        return head + _U32.pack(f["session"])
    if op == OP_WRITE:
        return head + _U64.pack(f["total_bytes"]) \
            + _U64.pack(f["new_bytes"]) + _U32.pack(f["new_blocks"]) \
            + _U32.pack(f["dup_blocks"])
    if op == OP_READ:
        return head + _pack_bytes(f["data"])
    if op == OP_DELETE:
        return head + _U32.pack(f["orphans"])
    if op == OP_STAT:
        return head + _U32.pack(f["versions"]) + _U64.pack(f["total_len"]) \
            + _U32.pack(f["blocks"])
    if op in (OP_STATS, OP_HEALTH):
        # JSON snapshot/report rides as an opaque length-prefixed payload
        return head + _pack_bytes(f["data"])
    if op == OP_CLOSE:
        return head
    raise CodecError(f"unknown opcode {op}")


def decode_response(frame: bytes):
    """-> (status, op, rid, fields)."""
    (status, op, rid), off = _take(frame, 0, _RSP_HDR)
    f: Dict[str, Any] = {}
    if status == ST_RETRY:
        f["reason"], off = _take_str(frame, off)
    elif status == ST_ERROR:
        f["errtype"], off = _take_str(frame, off)
        f["msg"], off = _take_str(frame, off)
    elif op == OP_OPEN:
        (f["session"],), off = _take(frame, off, _U32)
    elif op == OP_WRITE:
        (f["total_bytes"],), off = _take(frame, off, _U64)
        (f["new_bytes"],), off = _take(frame, off, _U64)
        (f["new_blocks"],), off = _take(frame, off, _U32)
        (f["dup_blocks"],), off = _take(frame, off, _U32)
    elif op == OP_READ:
        f["data"], off = _take_bytes(frame, off)
    elif op == OP_DELETE:
        (f["orphans"],), off = _take(frame, off, _U32)
    elif op == OP_STAT:
        (f["versions"],), off = _take(frame, off, _U32)
        (f["total_len"],), off = _take(frame, off, _U64)
        (f["blocks"],), off = _take(frame, off, _U32)
    elif op in (OP_STATS, OP_HEALTH):
        f["data"], off = _take_bytes(frame, off)
    elif op == OP_CLOSE:
        pass
    else:
        raise CodecError(f"unknown opcode {op}")
    if off != len(frame):
        raise CodecError("trailing bytes in response frame")
    return status, op, rid, f


# ----------------------------------------------------------------------
# transport
# ----------------------------------------------------------------------
class ReplyFuture:
    """Resolves to a raw response frame (bytes)."""

    def __init__(self):
        self._done = threading.Event()
        self._frame: Optional[bytes] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> bytes:
        if not self._done.wait(timeout):
            raise TimeoutError("gateway reply still in flight")
        return self._frame

    def _resolve(self, frame: bytes):
        self._frame = frame
        self._done.set()


class GatewayChannel:
    """In-process client endpoint: ``request`` takes a request frame and
    returns a :class:`ReplyFuture` resolving to a response frame — the
    exact contract a socket transport would implement, so the framed
    codec is exercised end-to-end even in-process."""

    def __init__(self, gateway: "StorageGateway"):
        self._gateway = gateway

    def request(self, frame: bytes) -> ReplyFuture:
        # owner=None: in-process callers are trusted and share one
        # session namespace (sessions bound by OP_OPEN, not channels)
        return self._gateway.handle_frame(frame)

    def close(self):
        """No connection to tear down in-process; present so clients
        can close any channel (socket or not) uniformly."""


# ----------------------------------------------------------------------
# gateway
# ----------------------------------------------------------------------
@dataclasses.dataclass
class GatewayConfig:
    quantum_bytes: int = 256 << 10    # WDRR service quantum per weight
    max_inflight: int = 4             # per-tenant dispatched concurrency
    max_outstanding: int = 32         # per-tenant inflight + queued cap
    max_queued_bytes: int = 8 << 20   # per-tenant queued byte budget
    sai: Optional[SAIConfig] = None   # per-tenant SAI template (lane is
    #                                   overridden by the tenant's QoS)
    scrub: bool = False               # own + run a ClusterRuntime
    runtime: Optional[NodeRuntimeConfig] = None
    idle_poll_s: float = 0.05         # scheduler idle wakeup
    auth: Optional[TokenAuthenticator] = None  # None = trusted (e.g.
    #                                   in-process); set => OP_OPEN must
    #                                   carry a valid signed token and
    #                                   the session binds to the token's
    #                                   tenant, not the claimed name
    max_frame_bytes: int = MAX_FRAME_BYTES
    adaptive_fusion: bool = True      # when the gateway resolves the
    #                                   process-default engine itself,
    #                                   turn measured fusion-cap tuning
    #                                   on (an explicitly passed engine
    #                                   is never touched — its owner
    #                                   decides)
    data_dir: Optional[str] = None    # durable mode: open a WAL-backed
    #                                   store here instead of taking a
    #                                   caller-owned manager; the
    #                                   gateway owns its lifecycle
    #                                   (recovery at start, close on
    #                                   shutdown) and hands recovery
    #                                   suspects to the scrub runtime
    n_nodes: int = 4                  # durable-mode store shape
    replication: int = 1
    trace_ring: int = 256             # completed-trace ring capacity
    slow_request_s: float = 1.0       # traces at/over this land in the
    #                                   slow-request log with full span
    #                                   trees
    health: bool = False              # run the continuous health plane
    #                                   (background MetricsSampler +
    #                                   HealthEngine re-evaluated every
    #                                   tick); OP_HEALTH works without it
    #                                   by sampling on demand
    metrics_port: Optional[int] = None  # HTTP scrape endpoint serving
    #                                   /metrics, /health, /slowlog on
    #                                   127.0.0.1 (0 = ephemeral port,
    #                                   exposed as gateway.http.port);
    #                                   setting it implies health=True
    sample_interval_s: float = 0.25   # sampler tick
    sample_capacity: int = 240        # sampler ring entries
    sample_window_s: float = 5.0      # rate/delta lookback window
    health_config: Optional[HealthConfig] = None  # verdict rule knobs


@dataclasses.dataclass
class _Work:
    op: int
    rid: int
    fields: Dict[str, Any]
    cost: int
    reply: ReplyFuture
    trace: Optional[Trace] = None
    t_admit: float = 0.0


class _Tenant:
    def __init__(self, name: str, weight: float, qos: str, sai: SAI,
                 registry: MetricsRegistry):
        self.name = name
        self.weight = max(float(weight), 1e-6)
        self.qos = qos
        self.sai = sai
        self.queue: Deque[_Work] = deque()
        self.queued_bytes = 0
        self.inflight = 0
        self.deficit = 0.0
        self.completion_q: "queue.Queue" = queue.Queue()
        self.completer: Optional[threading.Thread] = None
        # atomic counters (completer/scheduler/handler threads all
        # bump); still reads like the old plain dict
        self.stats = registry.group(
            ("submitted", "completed", "rejected", "errors",
             "bytes_in", "bytes_out"), prefix=f"tenant/{name}/")


class StorageGateway:
    """Fronts one :class:`MetadataManager` + shared offload engine for
    many concurrent client sessions (see module docstring).

    Sessions are opened by an ``OP_OPEN`` frame naming a tenant, weight,
    and QoS class; any number of sessions may join the same tenant (its
    weight/QoS are fixed by the first open).  Each tenant gets its own
    :class:`SAI` — its ``write_async`` / ``read_async`` pipelines are
    reused verbatim — but every SAI shares the gateway's engine, which
    is what fuses different clients' hash bursts into common launches.
    """

    def __init__(self, manager: Optional[MetadataManager] = None,
                 engine: Optional[CrystalGPU] = None,
                 config: Optional[GatewayConfig] = None):
        self.cfg = config or GatewayConfig()
        self.recovery_report = None
        self._owns_store = False
        if manager is None:
            if self.cfg.data_dir is None:
                raise ValueError(
                    "StorageGateway needs a manager or "
                    "GatewayConfig(data_dir=...)")
            manager, _, self.recovery_report = open_durable_store(
                self.cfg.data_dir, n_nodes=self.cfg.n_nodes,
                replication=self.cfg.replication)
            self._owns_store = True
        elif self.cfg.data_dir is not None:
            raise ValueError("pass a manager OR data_dir, not both")
        self.manager = manager
        self._engine = engine

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tenants: Dict[str, _Tenant] = {}  # guarded by self._cv
        self._order: List[_Tenant] = []  # WDRR visit order; guarded by self._cv
        # session id -> (tenant, owner).  ``owner`` is the opaque
        # transport identity that opened the session (the socket
        # connection object; None for trusted in-process callers) —
        # every later frame must come from the SAME owner, so a TCP
        # client can't act on a session id it merely guessed.
        self._sessions: Dict[int, Tuple[_Tenant, Any]] = {}  # guarded by self._cv
        self._next_session = 1  # guarded by self._cv
        self._rr = 0  # guarded by self._cv
        self._closed = False  # guarded by self._cv
        self._stop = threading.Event()
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.group(
            ("frames", "dispatched", "admission_rejections",
             "stats_truncated"))
        self.tracer = Tracer(capacity=self.cfg.trace_ring,
                             slow_threshold_s=self.cfg.slow_request_s)
        # request latency (admission -> reply) per data verb, plus WDRR
        # queue wait (admission -> dispatch)
        self._hist_write = self.metrics.histogram("request_s/write")
        self._hist_read = self.metrics.histogram("request_s/read")
        self._hist_queue = self.metrics.histogram("queue_wait_s")
        # per-QoS-class latency (raw buckets ride the snapshot so the
        # health plane can compute windowed SLO violation rates)
        self._hist_qos = {q: self.metrics.histogram(f"qos_s/{q}")
                          for q in QOS_LANES}
        self.metrics.gauge(
            "sessions",
            # ra: disable=RA01(len() on a dict is atomic in CPython; advisory gauge)
            fn=lambda: len(self._sessions))
        self.heartbeats = HeartbeatBoard()
        self.runtime: Optional[ClusterRuntime] = None
        if self.cfg.scrub:
            self.runtime = ClusterRuntime(manager, engine=self.engine,
                                          config=self.cfg.runtime)
            if self.recovery_report is not None \
                    and self.recovery_report.suspects:
                # recovery IS a scrub workload: engine-verify the
                # trailing blocks the crash left unproven before
                # background sweeps resume
                self.runtime.scrub_suspects(self.recovery_report.suspects)
            self.runtime.start()
        self._scheduler = threading.Thread(target=self._scheduler_loop,
                                           daemon=True,
                                           name="gateway-sched")
        self._scheduler.start()
        # continuous health plane: the sampler snapshots the BASE tree
        # (no timeseries/health blocks — those derive from the ring, so
        # sampling the full tree would be self-referential), the health
        # engine re-evaluates after every tick, and the optional HTTP
        # endpoint serves scrapes without a wire session
        self.sampler = MetricsSampler(
            self._base_stats, interval_s=self.cfg.sample_interval_s,
            capacity=self.cfg.sample_capacity,
            window_s=self.cfg.sample_window_s)
        self.health = HealthEngine(self.sampler,
                                   self.cfg.health_config)
        self.http: Optional[HealthHTTPServer] = None
        if self.cfg.health or self.cfg.metrics_port is not None:
            self.sampler.add_listener(self.health.evaluate)
            self.sampler.start()
        if self.cfg.metrics_port is not None:
            self.http = HealthHTTPServer(
                stats_fn=self.snapshot_stats,
                health_fn=self.health_report,
                slowlog_fn=self.tracer.slow_entries,
                port=self.cfg.metrics_port)

    # -- plumbing ------------------------------------------------------
    @property
    def engine(self) -> CrystalGPU:
        """The engine every tenant SAI shares.  Resolved to the
        process-wide default only when none was supplied; a dead engine
        is NOT silently replaced — existing tenants hold it, and a new
        one would split coalescing (and stats) across two engines.
        Submitting to a shut-down engine fails loudly instead."""
        if self._engine is None:
            self._engine = crystal_mod.default_engine()
            if self.cfg.adaptive_fusion:
                # gateway default (ROADMAP item 3 follow-on): measured
                # fusion caps on for the shared engine we resolved
                self._engine.policy.adaptive = True
        return self._engine

    def connect(self) -> GatewayChannel:
        """Open a transport endpoint (the in-process analog of a TCP
        connect; sessions are bound by OP_OPEN frames, not channels)."""
        return GatewayChannel(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- frame entry point ---------------------------------------------
    def handle_frame(self, frame: bytes,
                     owner: Any = None) -> ReplyFuture:
        """Serve one request frame.  ``owner`` is the transport identity
        the frame arrived on (the socket transport passes its connection
        object; in-process callers pass nothing).  Sessions are bound to
        the owner that opened them — frames naming another owner's
        session are answered exactly like an unknown session, so session
        ids carry no authority across connections."""
        t_rx = time.perf_counter()
        reply = ReplyFuture()
        try:
            op, session, rid, f = decode_request(
                frame, max_frame_bytes=self.cfg.max_frame_bytes)
        except Exception as e:
            # salvage op/rid from the fixed header when present: over a
            # socket the rid is the reply routing key, and a rid=0 error
            # would be undeliverable — the client would time out instead
            # of seeing the CodecError
            op = rid = 0
            if len(frame) >= _REQ_HDR.size:
                op, _session, rid, _trace = _REQ_HDR.unpack_from(frame)
            reply._resolve(encode_response(ST_ERROR, op, rid,
                                           errtype="CodecError",
                                           msg=str(e)))
            return reply
        # (trace_id, rx timestamp, decoded timestamp): becomes the
        # request's root Trace if it survives admission
        trace_id = f.pop("trace", 0)
        tctx = (trace_id, t_rx, time.perf_counter()) if trace_id else None
        try:
            self._handle(op, session, rid, f, reply, owner, tctx)
        except BaseException as e:
            reply._resolve(encode_response(ST_ERROR, op, rid,
                                           errtype=type(e).__name__,
                                           msg=str(e)))
        return reply

    def _handle(self, op: int, session: int, rid: int,
                f: Dict[str, Any], reply: ReplyFuture, owner: Any,
                tctx: Optional[Tuple[int, float, float]] = None):
        self.stats.inc("frames")
        if op == OP_OPEN:
            return self._open_session(rid, f, reply, owner)
        with self._cv:
            entry = self._sessions.get(session)
        # a foreign-owner session gets the SAME reply as a nonexistent
        # one: a probing connection learns nothing about which small
        # integer ids happen to be other clients' live sessions
        if entry is None or entry[1] is not owner:
            reply._resolve(encode_response(
                ST_ERROR, op, rid, errtype="UnknownSession",
                msg=f"session {session} is not open"))
            return
        tenant = entry[0]
        if op == OP_CLOSE:
            with self._cv:
                self._sessions.pop(session, None)
            reply._resolve(encode_response(ST_OK, OP_CLOSE, rid))
            return
        if op == OP_STAT:
            return self._stat(tenant, rid, f, reply)
        if op == OP_STATS:
            return self._stats_op(tenant, rid, reply)
        if op == OP_HEALTH:
            return self._health_op(tenant, rid, reply)
        if op == OP_DELETE:
            return self._delete(tenant, rid, f, reply)
        if op in (OP_WRITE, OP_READ):
            return self._admit(tenant, op, rid, f, reply, tctx)
        reply._resolve(encode_response(ST_ERROR, op, rid,
                                       errtype="CodecError",
                                       msg=f"unhandled opcode {op}"))

    def _open_session(self, rid: int, f: Dict[str, Any],
                      reply: ReplyFuture, owner: Any):
        if self.cfg.auth is not None:
            # authenticate BEFORE anything else: the session's tenant is
            # whatever the verified token says, never the claimed field
            try:
                f["tenant"] = self.cfg.auth.verify(
                    f.get("token", b""), claimed=f["tenant"])
            except AuthError as e:
                reply._resolve(encode_response(
                    ST_ERROR, OP_OPEN, rid, errtype="AuthError",
                    msg=str(e)))
                return
        qos = f["qos"]
        if qos not in QOS_LANES:
            reply._resolve(encode_response(
                ST_ERROR, OP_OPEN, rid, errtype="ValueError",
                msg=f"unknown qos {qos!r}"))
            return
        weight = f["weight"]
        # a wire frame can carry weight=0, negative, or NaN; any of
        # those zeroes (or poisons) quantum_bytes * weight and the
        # tenant's WDRR deficit never grows — it would starve forever
        if not math.isfinite(weight) or weight <= 0.0:
            reply._resolve(encode_response(
                ST_ERROR, OP_OPEN, rid, errtype="ValueError",
                msg=f"tenant weight must be finite and > 0, "
                    f"got {weight!r}"))
            return
        with self._cv:
            if self._closed:
                reply._resolve(encode_response(
                    ST_ERROR, OP_OPEN, rid, errtype="RuntimeError",
                    msg="gateway is closed"))
                return
            tenant = self._tenants.get(f["tenant"])
            if tenant is None:
                sai_cfg = dataclasses.replace(
                    self.cfg.sai or SAIConfig(), lane=QOS_LANES[qos])
                tenant = _Tenant(f["tenant"], f["weight"], qos,
                                 SAI(self.manager, sai_cfg,
                                     crystal=self.engine),
                                 self.metrics)
                tenant.completer = threading.Thread(
                    target=self._completer_loop, args=(tenant,),
                    daemon=True, name=f"gateway-done-{tenant.name}")
                tenant.completer.start()
                self._tenants[tenant.name] = tenant
                self._order.append(tenant)
            sid = self._next_session
            self._next_session += 1
            self._sessions[sid] = (tenant, owner)
        reply._resolve(encode_response(ST_OK, OP_OPEN, rid, session=sid))

    def drop_sessions(self, owner: Any) -> int:
        """Close every session bound to ``owner`` (a disconnecting
        transport connection): its ids must not stay live — or leak —
        after the connection that authenticated them is gone.  Returns
        the number dropped.  In-flight work already dispatched for the
        tenant completes normally."""
        with self._cv:
            dead = [sid for sid, (_t, own) in self._sessions.items()
                    if own is owner]
            for sid in dead:
                del self._sessions[sid]
        return len(dead)

    # -- metadata ops (cheap: served inline, no queueing) --------------
    def _stat(self, tenant: _Tenant, rid: int, f: Dict[str, Any],
              reply: ReplyFuture):
        st = self.manager.stat_file(f["path"])
        if st is None:
            reply._resolve(encode_response(
                ST_ERROR, OP_STAT, rid, errtype="FileNotFoundError",
                msg=f["path"]))
            return
        tenant.stats.inc("submitted")
        tenant.stats.inc("completed")
        reply._resolve(encode_response(ST_OK, OP_STAT, rid, **st))

    def _bounded_json(self, tree: Dict[str, Any]) -> bytes:
        """Serialize a stats/health tree, truncating it (deepest
        subtrees first) when the JSON would overflow the response frame
        cap — an overgrown tree must degrade, not kill the connection
        with an undecodable oversized frame."""
        payload = json.dumps(tree, sort_keys=True).encode("utf-8")
        # headroom for the response header + payload length prefix
        budget = max(1024, self.cfg.max_frame_bytes - 256)
        if len(payload) > budget:
            tree, _dropped = truncate_tree(tree, budget)
            self.stats.inc("stats_truncated")
            payload = json.dumps(tree, sort_keys=True).encode("utf-8")
        return payload

    def _stats_op(self, tenant: _Tenant, rid: int, reply: ReplyFuture):
        """OP_STATS admin verb: the live ``snapshot_stats()`` tree as a
        JSON payload.  Session-gated like every non-OPEN op, so with
        ``GatewayConfig(auth=...)`` set it requires an authenticated
        session."""
        tenant.stats.inc("submitted")
        payload = self._bounded_json(self.snapshot_stats())
        tenant.stats.inc("completed")
        reply._resolve(encode_response(ST_OK, OP_STATS, rid,
                                       data=payload))

    def _health_op(self, tenant: _Tenant, rid: int, reply: ReplyFuture):
        """OP_HEALTH admin verb: the health report as a JSON payload
        (same shape the ``/health`` HTTP route serves), session-gated
        like OP_STATS."""
        tenant.stats.inc("submitted")
        payload = self._bounded_json(self.health_report())
        tenant.stats.inc("completed")
        reply._resolve(encode_response(ST_OK, OP_HEALTH, rid,
                                       data=payload))

    def _delete(self, tenant: _Tenant, rid: int, f: Dict[str, Any],
                reply: ReplyFuture):
        orphans = self.manager.delete_file(f["path"])
        tenant.stats.inc("submitted")
        tenant.stats.inc("completed")
        reply._resolve(encode_response(ST_OK, OP_DELETE, rid,
                                       orphans=len(orphans)))

    # -- admission control ---------------------------------------------
    def _cost_of(self, op: int, f: Dict[str, Any]) -> int:
        if op == OP_WRITE:
            return max(len(f["data"]), 1)
        st = self.manager.stat_file(f["path"], f.get("version", -1))
        return max(st["total_len"], 1) if st else 1

    def _admit(self, tenant: _Tenant, op: int, rid: int,
               f: Dict[str, Any], reply: ReplyFuture,
               tctx: Optional[Tuple[int, float, float]] = None):
        cost = self._cost_of(op, f)
        cfg = self.cfg
        with self._cv:
            if self._closed:
                reply._resolve(encode_response(
                    ST_RETRY, op, rid, reason="gateway closing"))
                return
            outstanding = tenant.inflight + len(tenant.queue)
            # an oversized request is admissible when the tenant queue
            # is empty (it can always make progress alone); otherwise
            # the byte budget bounds queue growth
            over_bytes = tenant.queue and \
                tenant.queued_bytes + cost > cfg.max_queued_bytes
            if outstanding >= cfg.max_outstanding or over_bytes:
                tenant.stats.inc("rejected")
                self.stats.inc("admission_rejections")
                reply._resolve(encode_response(
                    ST_RETRY, op, rid,
                    reason=f"tenant {tenant.name} over budget "
                           f"({outstanding} outstanding, "
                           f"{tenant.queued_bytes} B queued)"))
                return
            trace = None
            if tctx is not None:
                # root spans from frame arrival so every child span
                # nests inside [trace.t0, trace.t1]
                trace = self.tracer.start(tctx[0], OP_NAMES[op],
                                          t0=tctx[1],
                                          tenant=tenant.name)
                trace.add_span("transport/decode", tctx[1], tctx[2])
            tenant.queue.append(_Work(op, rid, f, cost, reply,
                                      trace=trace,
                                      t_admit=time.perf_counter()))
            tenant.queued_bytes += cost
            tenant.stats.inc("submitted")
            self._cv.notify_all()

    # -- fair-share scheduler (weighted deficit round-robin) -----------
    def _eligible_locked(self) -> bool:
        return any(t.queue and t.inflight < self.cfg.max_inflight
                   for t in self._order)

    def _drained_locked(self) -> bool:
        return all(not t.queue and t.inflight == 0 for t in self._order)

    def _pick_locked(self) -> List[Tuple[_Tenant, _Work]]:
        """One WDRR round: visit every tenant once in rotating order,
        top its deficit up by ``quantum_bytes * weight``, and dispatch
        head-of-queue requests while their byte cost fits the deficit
        (and the tenant's inflight cap allows).  Idle tenants' deficits
        reset so service credit never accumulates while unused."""
        cfg = self.cfg
        picks: List[Tuple[_Tenant, _Work]] = []
        n = len(self._order)
        for k in range(n):
            t = self._order[(self._rr + k) % n]
            if not t.queue:
                t.deficit = 0.0
                continue
            if t.inflight >= cfg.max_inflight:
                continue
            t.deficit += cfg.quantum_bytes * t.weight
            while (t.queue and t.inflight < cfg.max_inflight
                   and t.queue[0].cost <= t.deficit):
                w = t.queue.popleft()
                t.deficit -= w.cost
                t.queued_bytes -= w.cost
                t.inflight += 1
                picks.append((t, w))
            if not t.queue:
                t.deficit = 0.0
        if n:
            self._rr = (self._rr + 1) % n
        self.stats.inc("dispatched", len(picks))
        return picks

    def _scheduler_loop(self):
        hb = self.heartbeats.heartbeat("scheduler")
        try:
            while True:
                hb.beat()
                with self._cv:
                    while not self._stop.is_set() \
                            and not self._eligible_locked():
                        hb.beat()   # idle polls are forward progress
                        self._cv.wait(self.cfg.idle_poll_s)
                    if self._stop.is_set() \
                            and not self._eligible_locked():
                        return
                    picks = self._pick_locked()
                for tenant, work in picks:
                    self._dispatch(tenant, work)
        finally:
            hb.park()

    def _dispatch(self, tenant: _Tenant, work: _Work):
        now = time.perf_counter()
        self._hist_queue.record(now - work.t_admit)
        if work.trace is not None:
            work.trace.add_span("gateway/queue", work.t_admit, now,
                                tenant=tenant.name)
        try:
            if work.op == OP_WRITE:
                fut = tenant.sai.write_async(work.fields["path"],
                                             work.fields["data"],
                                             trace=work.trace)
            else:
                fut = tenant.sai.read_async(work.fields["path"],
                                            work.fields["version"],
                                            work.fields["verify"],
                                            trace=work.trace)
        except BaseException as e:
            self._finish(tenant, work, encode_response(
                ST_ERROR, work.op, work.rid, errtype=type(e).__name__,
                msg=str(e)), error=True)
            return
        tenant.completion_q.put((work, fut))

    # -- completion ----------------------------------------------------
    def _completer_loop(self, tenant: _Tenant):
        """Per-tenant completion drain: waits dispatch-order futures and
        frames the responses.  Per-tenant (not gateway-wide) so one
        tenant's slow read never head-of-line blocks another tenant's
        finished requests."""
        hb = self.heartbeats.heartbeat(f"completer_{tenant.name}")
        while True:
            hb.park()                # idle until the next completion
            item = tenant.completion_q.get()
            if item is None:
                return               # heartbeat stays parked
            hb.beat()
            work, fut = item
            nbytes = {}
            try:
                res = fut.result(timeout=600)
                if work.op == OP_WRITE:
                    frame = encode_response(
                        ST_OK, OP_WRITE, work.rid,
                        total_bytes=res.total_bytes,
                        new_bytes=res.new_bytes,
                        new_blocks=res.new_blocks,
                        dup_blocks=res.dup_blocks)
                    nbytes["bytes_in"] = res.total_bytes
                else:
                    frame = encode_response(ST_OK, OP_READ, work.rid,
                                            data=res)
                    nbytes["bytes_out"] = len(res)
                self._finish(tenant, work, frame, **nbytes)
            except BaseException as e:
                self._finish(tenant, work, encode_response(
                    ST_ERROR, work.op, work.rid,
                    errtype=type(e).__name__, msg=str(e)), error=True)

    def _finish(self, tenant: _Tenant, work: _Work, frame: bytes,
                error: bool = False, **nbytes: int):
        now = time.perf_counter()
        hist = self._hist_write if work.op == OP_WRITE else self._hist_read
        hist.record(now - work.t_admit)
        self._hist_qos[tenant.qos].record(now - work.t_admit)
        if work.trace is not None:
            work.trace.meta["error"] = bool(error)
            self.tracer.finish(work.trace, now)
        work.reply._resolve(frame)
        tenant.stats.inc("errors" if error else "completed")
        for k, v in nbytes.items():
            tenant.stats.inc(k, v)
        with self._cv:
            tenant.inflight -= 1
            self._cv.notify_all()

    # -- observability -------------------------------------------------
    def _base_stats(self) -> Dict[str, Any]:
        """The point-in-time stats tree (what the MetricsSampler
        snapshots): per-tenant throughput/queue/rejection counters, the
        engine's launch/coalesce counters (``launches < jobs`` across a
        concurrent burst is the cross-client coalescing signature), the
        owned runtime's counters when scrubbing is on, and every
        layer's thread heartbeats."""
        with self._cv:
            tenants = {
                t.name: {**t.stats, "queue_depth": len(t.queue),
                         "queued_bytes": t.queued_bytes,
                         "inflight": t.inflight, "weight": t.weight,
                         "qos": t.qos,
                         "heartbeats": t.sai.heartbeats.snapshot()}
                for t in self._order}
            out: Dict[str, Any] = {
                "tenants": tenants,
                "sessions": len(self._sessions),
                "frames": self.stats["frames"],
                "dispatched": self.stats["dispatched"],
                "admission_rejections":
                    self.stats["admission_rejections"],
                "stats_truncated": self.stats["stats_truncated"],
            }
        out["heartbeats"] = self.heartbeats.snapshot()
        eng = self._engine
        if eng is not None and eng._alive:
            es = eng.snapshot_stats()
            out["engine"] = es
            out["jobs"] = es["jobs"]
            out["launches"] = es["launches"]
            out["queue_depths"] = {lane: eng.queue_depth(lane)
                                   for lane in crystal_mod.LANES}
        if self.runtime is not None:
            out["runtime"] = self.runtime.snapshot_stats()
        out["obs"] = {
            "request": {"write": self._hist_write.summary(),
                        "read": self._hist_read.summary(),
                        "queue_wait": self._hist_queue.summary()},
            "qos": {q: {**h.summary(), "buckets": list(h.buckets())}
                    for q, h in self._hist_qos.items()},
            "traces": self.tracer.stats(),
        }
        wal = getattr(self.manager, "wal", None)
        if wal is not None:
            out["wal"] = wal.snapshot_stats()
        stores = [n.store for n in getattr(self.manager, "nodes", [])
                  if getattr(n, "store", None) is not None]
        if stores:
            agg: Dict[str, int] = {}
            for st in stores:
                for k, v in st.stats.items():
                    agg[k] = agg.get(k, 0) + v
            out["blockstore"] = agg
        return out

    def snapshot_stats(self) -> Dict[str, Any]:
        """The base tree plus the health plane's derived blocks: a
        ``timeseries`` block of windowed rates and a ``health`` block
        with the latest rule verdicts (present once the sampler has at
        least one sample)."""
        out = self._base_stats()
        if self.sampler.samples:
            out["timeseries"] = self.sampler.snapshot()
            out["health"] = self.health.snapshot()
        return out

    def health_report(self) -> Dict[str, Any]:
        """Fresh health verdicts.  With the background plane running
        this evaluates against the live ring; without it, each call
        takes one sample first, so repeated OP_HEALTH polls still
        accumulate a window."""
        if not self.sampler.running:
            self.sampler.sample_once()
        return self.health.evaluate()

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 60.0):
        """Graceful shutdown: stop admitting (late requests get
        ``ST_RETRY``), drain every queued/in-flight request, then stop
        the scheduler, completers, tenant SAIs, and the owned runtime.
        The engine is NOT shut down — the gateway shares it with other
        users (callers that created a private engine own its shutdown).
        Idempotent."""
        with self._cv:
            already = self._closed
            self._closed = True
            tenants = list(self._order)  # snapshot: teardown below is unlocked
            if not already:
                deadline = time.monotonic() + timeout
                while not self._drained_locked() \
                        and time.monotonic() < deadline:
                    self._cv.wait(0.1)
                # drain deadline expired with work still queued: bounce
                # it with RetryLater now, BEFORE the completer sentinels
                # go in — a reply must never be left unresolved behind a
                # stopping scheduler
                for t in self._order:
                    while t.queue:
                        w = t.queue.popleft()
                        t.queued_bytes -= w.cost
                        t.stats.inc("rejected")
                        w.reply._resolve(encode_response(
                            ST_RETRY, w.op, w.rid,
                            reason="gateway closing"))
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._scheduler.join(timeout=10)
        if already:
            return
        # tear the health plane down before the layers it samples
        if self.http is not None:
            self.http.close()
        self.sampler.stop()
        for t in tenants:
            t.completion_q.put(None)
        for t in tenants:
            if t.completer is not None:
                t.completer.join(timeout=10)
            t.sai.close()
        if self.runtime is not None:
            self.runtime.stop()
        if self._owns_store:
            self.manager.close()
