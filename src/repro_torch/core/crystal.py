"""CrystalGPU — the generalized offload engine, on CUDA devices.

The paper's CrystalGPU layer sits between the storage system and the GPU
runtime and provides application-agnostic optimizations that make hashing
offload pay off:
  (1) buffer reuse   — amortize (pinned) staging-buffer allocation across
                       a stream of hashing jobs,
  (2) transfer/compute overlap — pipeline H2D copy of job i+1 with the
                       kernel of job i,
  (3) transparent multi-device — an *engine mesh*: every device owns a
                       manager thread and a private lane queue, and jobs
                       are placed by a load-aware dispatch score instead
                       of blind round-robin,
  (4) request coalescing — fuse many small outstanding hash requests
                       (concurrent writers, checkpoint leaves, read-path
                       verification) into ONE padded batch kernel launch,
                       so per-launch overhead is amortized over the whole
                       burst.  This covers every job kind: ``direct``
                       rows stack into one [B, W] batch, and bursts of
                       same-config ``sliding`` stream jobs stack into one
                       padded [B, L] multi-row launch of
                       ``sliding_md5.sliding_md5_words``.

Engine mesh (this module's multi-device structure):

  dispatch   — each submitted job carries a cost estimate from the
               :class:`KernelCostModel` (seconds ~ overhead +
               sec_per_byte * padded_bytes, started from static values
               and EWMA-regressed online from measured launch wall
               times).
               The dispatcher scores every device by
               ``pending_s * slowdown`` — its queued model-seconds
               backlog times an EWMA of observed-vs-estimated launch
               latency — and routes to the cheapest device, with a
               fuse-key affinity exception: a job whose fuse key matches
               a device's most recent submission lands there when that
               device's backlog is within one job-cost of the best, so
               coalescable bursts stay fused instead of spraying across
               the mesh.  Ties break round-robin.
  sharding   — a whale job (padded staging footprint >=
               ``shard_min_bytes`` with >= 2 devices) is split into
               per-device sub-launches via the pure planning helpers in
               ``ops`` (``shard_row_ranges`` for direct row ranges,
               ``stream_shard_plan`` for stride-aligned sliding
               slices) and the child digests
               are reassembled in submission order into the parent
               job's result — one whale checkpoint leaf no longer
               serializes on a single manager while other devices idle.
               Counted by ``sharded_jobs`` / ``shards``.
  adaptive   — with ``adaptive_fusion=True`` the :class:`FusionPolicy`
    fusion     retunes ``max_fused_rows`` / ``max_fused_bytes`` from
               the measured cost model (grow the fused batch until
               launch overhead is ~25% of the launch, shrink it when
               the latency target ``target_launch_s`` binds) and widens
               or narrows the stream octave-class span when launches
               are overhead-dominated or padding-wasteful.  The
               constructor caps act as the starting point; adapted
               values stay within a bounded window around them and are
               exposed via ``snapshot_stats()["policy"]``.
  resilience — a manager thread that dies on an unexpected exception no
               longer strands its queue: the in-flight (picked) jobs'
               futures fail with the exception, the still-queued jobs
               are re-dispatched to surviving devices, the manager loop
               restarts, and ``manager_restarts`` counts the event.

``snapshot_stats()`` exposes the flat engine counters plus
``per_device`` (jobs, launches, bytes, EWMA launch latency overall and
per ``(kind, width-bucket)``, queue depth, queued padded bytes, pending
model-seconds, slowdown, restarts), ``policy`` (current caps + octave
span), and ``sharded_jobs`` / ``shards`` / ``manager_restarts``.
``queue_depth(lane, device=...)`` reads one device's backlog;
without ``device`` it sums the mesh (the node runtime's scrub backoff
and the gateway read it).

Devices and streams: ``devices`` is a list of ``torch.device``; by
default every CUDA device, and with none the constructor raises (pass
``devices=[torch.device("cpu")]`` to run the kernels' plain versions on
the host, as the tests do).  A device listed twice gets two managers.
Each manager owns one CUDA stream and hands it to every copy and kernel
it issues, so managers never serialise on a default stream.  Hosts fill
reused pinned staging buffers (the paper's buffer reuse), copy them to
the card on the manager's stream, launch the kernel there, and pull back
only the digests or window hashes.  With ``overlap=False`` the manager
synchronises its stream after every stage, mirroring the paper's staged
Table-1 execution.

Job normal forms
----------------
  'direct'  : data = [n, w] uint8 rows (w % 4 == 0) and meta['lens'] =
              [n] byte lengths (multiples of 4, <= w); result [n, 16]
              uint8 digests.  Legacy form: data = flat uint8 buffer plus
              meta['seg_bytes'] — split into fixed segments, word-aligned
              tail.  Coalescing fuses any mix of direct jobs: rows are
              padded to the widest row in the batch (digests are
              length-bound, so bytes past a row's length never change
              them).
  'sliding' : data = flat uint8 buffer, meta {'window', 'stride'};
              result [n_offsets] uint32 window hashes.
  'gear'    : not yet ported; ``submit`` raises NotImplementedError.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import md5, ops, sliding_md5
from repro_torch.obs import HeartbeatBoard
from repro_torch.obs import metrics as metrics_mod


LANES = ("fg", "batch", "scrub")       # dequeue priority, highest first


class LaneQueue:
    """Priority job queue: lanes dequeue strictly in ``LANES`` order —
    interactive foreground traffic first, then ``batch`` (throughput
    tenants behind the storage gateway), then ``scrub`` (background
    scrub/repair traffic from the node runtime) — and shutdown sentinels
    (``None``) dequeue only once every lane is empty, so ``shutdown()``
    still drains queued background jobs instead of orphaning their
    waiters.  API mirrors the subset of ``queue.Queue`` the managers use
    (put/get/get_nowait)."""

    def __init__(self):
        self._cv = threading.Condition()
        # guarded by self._cv
        self._lanes: Dict[str, collections.deque] = \
            {lane: collections.deque() for lane in LANES}
        self._sentinels = 0  # guarded by self._cv

    def put(self, item, lane: str = "fg"):
        with self._cv:
            if item is None:
                self._sentinels += 1
            else:
                self._lanes[lane].append(item)
            self._cv.notify()

    def _pop_locked(self):
        for lane in LANES:
            if self._lanes[lane]:
                return self._lanes[lane].popleft()
        self._sentinels -= 1            # caller checked _sentinels > 0
        return None

    def _nonempty(self) -> bool:  # ra: holds self._cv
        return bool(self._sentinels
                    or any(self._lanes[lane] for lane in LANES))

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._cv.wait_for(self._nonempty, timeout):
                raise queue.Empty
            return self._pop_locked()

    def get_nowait(self):
        with self._cv:
            if not self._nonempty():
                raise queue.Empty
            return self._pop_locked()

    def depth(self, lane: Optional[str] = None) -> int:
        """Queued jobs in one lane (or all lanes) — the load signal the
        node runtime's scrub backoff and the gateway stats read."""
        with self._cv:
            if lane is None:
                return sum(len(q) for q in self._lanes.values())
            return len(self._lanes[lane])

    def qsize(self) -> int:
        return self.depth()


@dataclass(eq=False)                   # identity semantics: jobs hold
class Job:                             # numpy fields, and the manager's
    # running-list membership/removal must never compare array contents
    kind: str                          # 'direct' | 'sliding'
    data: Optional[np.ndarray] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    callback: Optional[Callable] = None
    result: Any = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)
    timings: Dict[str, float] = field(default_factory=dict)
    # normalized 'direct' payload (set at submit time)
    rows: Optional[np.ndarray] = None
    lens: Optional[np.ndarray] = None
    # jobs with equal fuse keys may share one kernel launch
    fuse_key: tuple = ()
    # 'fg' = interactive client traffic; 'batch' = throughput traffic
    # (gateway batch-QoS tenants) that yields to interactive jobs;
    # 'scrub' = lowest-priority background traffic (node-runtime
    # scrub/repair) tracked by the scrub_* stats counters
    lane: str = "fg"
    # pow2-padded staging shape, used to bound fused-batch memory:
    # the fused matrix is (sum n_rows) x (max staged_width) bytes
    n_rows: int = 1
    staged_width: int = 0
    # cost-model estimate charged to the dispatch target's backlog
    # clock at submit and credited back when the launch retires
    cost_est: float = 0.0
    device_index: int = -1
    # trace stamps (perf_counter): dispatch enqueue, batch launch
    # start/end — consumers (SAI) turn these into engine queue/launch
    # spans after wait()
    t_submit: float = 0.0
    t_exec0: float = 0.0
    t_exec1: float = 0.0

    def wait(self):
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def padded_bytes(self) -> int:
        return self.n_rows * max(self.staged_width, 1)


def _normalize_direct(data: np.ndarray, meta: Dict[str, Any]):
    """Return (rows [n, w] uint8, lens [n] int64) for a direct request."""
    data = np.asarray(data)
    if data.ndim == 2:
        rows = data.astype(np.uint8, copy=False)
        lens = meta.get("lens")
        if lens is None:
            lens = np.full((rows.shape[0],), rows.shape[1], np.int64)
        else:
            lens = np.asarray(lens, np.int64)
        return rows, lens
    seg = int(meta.get("seg_bytes", 4096))
    flat = data.reshape(-1).astype(np.uint8, copy=False)
    n = max((flat.size + seg - 1) // seg, 1)
    rows = np.zeros((n, seg), np.uint8)
    rows.reshape(-1)[:flat.size] = flat
    lens = np.full((n,), seg, np.int64)
    tail = flat.size - (n - 1) * seg
    lens[-1] = (tail + 3) // 4 * 4
    return rows, lens


# kind -> (sec_per_byte, launch_overhead_s): static start values for the
# cost model, not measurements.  They only order the first dispatch
# decisions; the online EWMA regression of measured launch wall times
# replaces them after two launches of a kind.
_COST_DEFAULT = (1e-9, 1e-3)
_COST_START = {kind: _COST_DEFAULT for kind in ("direct", "sliding")}


class KernelCostModel:
    """Online launch-cost model: ``wall ~= overhead + sec_per_byte *
    padded_bytes`` per job kind.  Parameters come from an EWMA linear
    regression of measured launch wall time on padded staging bytes,
    started from static values (``_COST_START``) until two launches of
    a kind were measured.  When the observed byte sizes are degenerate
    (every launch the same size) the slope stays at the start value and
    only the intercept is measured."""

    def __init__(self, seeds: Optional[Dict[str, Tuple[float, float]]]
                 = None, alpha: float = 0.2):
        self.alpha = alpha
        self._seed = dict(seeds or {})
        # kind -> [n, E[b], E[w], E[b^2], E[b*w]]  (EWMA moments)
        self._m: Dict[str, List[float]] = {}

    def observe(self, kind: str, nbytes: int, wall_s: float):
        b, w = float(nbytes), float(wall_s)
        m = self._m.get(kind)
        if m is None:
            self._m[kind] = [1, b, w, b * b, b * w]
            return
        a = self.alpha
        m[0] += 1
        m[1] += a * (b - m[1])
        m[2] += a * (w - m[2])
        m[3] += a * (b * b - m[3])
        m[4] += a * (b * w - m[4])

    def params(self, kind: str) -> Tuple[float, float]:
        """(overhead_s, sec_per_byte) for ``kind``."""
        seed_spb, seed_oh = self._seed.get(kind, _COST_DEFAULT)
        m = self._m.get(kind)
        if m is None or m[0] < 2:
            return seed_oh, seed_spb
        var = m[3] - m[1] * m[1]
        cov = m[4] - m[1] * m[2]
        if var <= max(1e-6 * m[3], 1e-9):
            spb = seed_spb                  # degenerate byte variance
        else:
            spb = cov / var
        spb = min(max(spb, 1e-13), 1.0)
        oh = max(m[2] - spb * m[1], 0.0)
        return oh, spb

    def estimate(self, kind: str, nbytes: int) -> float:
        oh, spb = self.params(kind)
        return oh + spb * float(nbytes)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for kind in set(self._seed) | set(self._m):
            oh, spb = self.params(kind)
            out[kind] = {"overhead_s": oh, "sec_per_byte": spb,
                         "observations": self._m.get(kind, [0])[0]}
        return out


class FusionPolicy:
    """Fusion caps + stream octave classes, optionally retuned online.

    Static mode (``adaptive=False``, the default): ``cur_rows`` /
    ``cur_bytes`` stay at the constructor values — existing engines
    behave exactly as before.  Adaptive mode grows the fused-batch byte
    budget until launch overhead is ~25% of the modeled launch time
    (``B_opt = 3 * overhead / sec_per_byte``), shrinks it when the
    ``target_launch_s`` latency bound binds, rounds to a power of two
    with 2x hysteresis, and keeps the result inside a bounded window
    around the configured caps (so explicit small caps remain
    meaningful bounds).  The row cap follows from the byte budget and
    the EWMA padded-bytes-per-row of recent launches.

    The stream octave class is the true power-of-two octave
    ``size.bit_length() // octave_span`` (span 1 = one class per
    power of two); adaptive mode widens the span (fuse across more
    size octaves) when launches are overhead-dominated and padding is
    cheap, and narrows it when padding waste dominates."""

    def __init__(self, max_fused_rows: int, max_fused_bytes: int,
                 adaptive: bool = False, target_launch_s: float = 0.25,
                 octave_span: int = 1):
        self.adaptive = bool(adaptive)
        self.target_launch_s = float(target_launch_s)
        self.base_rows = max(1, int(max_fused_rows))
        self.base_bytes = max(1, int(max_fused_bytes))
        self.cur_rows = self.base_rows
        self.cur_bytes = self.base_bytes
        self.rows_floor = max(1, self.base_rows // 8)
        self.rows_ceil = self.base_rows * 8
        self.bytes_floor = max(4096, self.base_bytes // 64)
        self.bytes_ceil = self.base_bytes * 8
        self.octave_span = max(1, min(int(octave_span), 3))
        self._pad_ratio = 1.0
        self._row_bytes = 0.0
        self._wall = 0.0
        self._obs = 0

    def octave_class(self, size: int) -> int:
        return max(int(size), 1).bit_length() // self.octave_span

    def observe(self, padded: int, actual: int, n_rows: int,
                wall_s: float, overhead_s: float, sec_per_byte: float):
        """Feed one retired launch (caller holds the engine lock)."""
        a = 0.25
        self._pad_ratio += a * (padded / max(actual, 1) - self._pad_ratio)
        if n_rows:
            rb = padded / n_rows
            self._row_bytes = rb if not self._row_bytes \
                else self._row_bytes + a * (rb - self._row_bytes)
        self._wall = wall_s if not self._wall \
            else self._wall + a * (wall_s - self._wall)
        self._obs += 1
        if not self.adaptive:
            return
        spb = max(sec_per_byte, 1e-13)
        oh = max(overhead_s, 0.0)
        want = 3.0 * oh / spb            # overhead down to ~25%/launch
        if self.target_launch_s > oh:
            want = min(want, (self.target_launch_s - oh) / spb)
        want = min(max(want, self.bytes_floor), self.bytes_ceil)
        want = 1 << (max(int(want), 1) - 1).bit_length()
        want = min(want, self.bytes_ceil)
        if want >= 2 * self.cur_bytes or 2 * want <= self.cur_bytes:
            self.cur_bytes = want        # 2x hysteresis
        rb = max(self._row_bytes, 64.0)
        n = min(max(int(self.cur_bytes / rb), self.rows_floor),
                self.rows_ceil)
        self.cur_rows = min(1 << (max(n, 1) - 1).bit_length(),
                            self.rows_ceil)
        if self._obs % 16 == 0:
            body = spb * max(self.cur_bytes, 1)
            if oh > body and self._pad_ratio < 4.0:
                self.octave_span = min(self.octave_span + 1, 3)
            elif self._pad_ratio > 6.0 and self.octave_span > 1:
                self.octave_span -= 1

    def snapshot(self) -> Dict[str, float]:
        return {"adaptive": int(self.adaptive),
                "max_fused_rows": self.cur_rows,
                "max_fused_bytes": self.cur_bytes,
                "octave_span": self.octave_span,
                "pad_ratio": self._pad_ratio,
                "ewma_launch_s": self._wall}


class _DeviceState:
    """Per-device mesh state: a private lane queue, the backlog signals
    the dispatcher scores (queued padded bytes + pending model-seconds +
    EWMA observed/estimated slowdown), the picked list crash recovery
    fails over, and per-(kind, width-bucket) launch-latency EWMAs.
    Mutable fields are guarded by the engine lock; the queue has its own
    condition variable (never acquired while holding the engine lock in
    a blocking wait)."""

    __slots__ = ("index", "device", "stream", "queue", "queued_bytes",
                 "pending_s", "slowdown", "last_fuse_key", "picked",
                 "ewma_launch_s", "ewma_bucket_s", "jobs", "launches",
                 "bytes", "restarts", "launch_hist")

    def __init__(self, index: int, device: torch.device, launch_hist=None):
        self.index = index
        self.device = device
        # the manager's own stream: every copy and launch goes on it, so
        # managers (even two on one card) never serialise on a default
        # stream
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.queue = LaneQueue()
        self.queued_bytes = 0
        self.pending_s = 0.0
        self.slowdown = 1.0
        self.last_fuse_key: Optional[tuple] = None
        self.picked: List[Job] = []
        self.ewma_launch_s = 0.0
        self.ewma_bucket_s: Dict[tuple, float] = {}
        self.jobs = 0
        self.launches = 0
        self.bytes = 0
        self.restarts = 0
        # full launch-latency distribution (p50/p95/p99), not just the
        # EWMA mean the dispatcher scores with
        self.launch_hist = launch_hist if launch_hist is not None \
            else metrics_mod.Histogram(f"device{index}/launch_s")

    def load_score(self) -> float:
        return self.pending_s * self.slowdown

    def on_device(self):
        """Context that makes this manager's device and stream current."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def sync(self):
        if self.stream is not None:
            self.stream.synchronize()

    def stats_row(self) -> Dict[str, Any]:
        return {"jobs": self.jobs, "launches": self.launches,
                "bytes": self.bytes,
                "ewma_launch_s": self.ewma_launch_s,
                "ewma_bucket_s": {f"{k}/{w}": v for (k, w), v
                                  in self.ewma_bucket_s.items()},
                "launch_hist": self.launch_hist.summary(),
                "queue_depth": self.queue.depth(),
                "queued_bytes": self.queued_bytes,
                "pending_s": self.pending_s,
                "slowdown": self.slowdown,
                "manager_restarts": self.restarts}


def _resolve_devices(devices) -> List[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CrystalGPU found no CUDA device; pass "
            "devices=[torch.device('cpu')] to run the kernels' plain "
            "versions on the host")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class CrystalGPU:
    """Coalescing offload engine mesh for hashing jobs.

    Parameters mirror the paper's ablation switches plus coalescing:
      buffer_reuse:      keep and reuse pinned staging buffers (idle
                         slots) instead of allocating per launch
      overlap:           no per-stage stream synchronisation
      devices:           devices forming the mesh (default: every CUDA
                         device; raises when there is none); each entry
                         gets its own manager thread, CUDA stream and
                         lane queue, and jobs are placed by the
                         load-aware dispatch score (see module docstring)
      coalesce:          fuse queued same-fuse-key jobs into one batch
                         launch — 'direct' with 'direct', 'sliding' with
                         identical window/stride (stream jobs
                         additionally only fuse within the
                         same buffer-size octave class, so a tiny CDC
                         job never pads out to a huge neighbour)
      max_batch:         max jobs fused into a single launch
      max_fused_rows:    cap on total direct rows in one fused launch —
                         bounds the padded [B, W] staging matrix when
                         many multi-row jobs (e.g. read-path verify
                         slices) queue up at once
      max_fused_bytes:   cap on one fused launch's padded staging matrix
                         (total rows x widest pow2 row, direct AND
                         stream): a burst of wide jobs stops fusing
                         before the batch matrix grows past this budget
      coalesce_window_s: extra wait for stragglers once the queue is
                         empty.  Default 0: fusion only captures jobs
                         already queued behind a running launch, so a
                         lone synchronous write never stalls waiting
                         for writers that don't exist; raise it for
                         bursty many-writer workloads.
      adaptive_fusion:   let the measured cost model retune the fusion
                         caps and octave span at runtime (FusionPolicy);
                         off by default — static engines behave exactly
                         as before
      target_launch_s:   adaptive-fusion latency bound: stop growing the
                         fused batch once its modeled launch time would
                         exceed this
      shard_min_bytes:   padded staging footprint above which a single
                         job is sharded across the mesh (>= 2 devices);
                         per-device sub-launches reassemble into the
                         parent result in submission order

    Priority lanes (``LANES`` order): ``lane='batch'`` queues behind
    every interactive ``fg`` job (the gateway's throughput QoS class),
    and ``lane='scrub'`` queues behind both — background integrity
    scrubbing and repair verification (the node runtime) share
    the engine without delaying client writes/reads.  Scrub-lane
    traffic is tracked by the ``scrub_jobs`` / ``scrub_launches`` /
    ``scrub_coalesced`` counters; ``queue_depth(lane)`` exposes the
    per-lane backlog (the node runtime's load-aware scrub backoff and
    the gateway's stats read it), summed across the mesh unless a
    ``device`` index is given.
    """

    def __init__(self, devices=None, buffer_reuse: bool = True,
                 overlap: bool = True, n_slots: int = 8,
                 coalesce: bool = True,
                 max_batch: int = 64, coalesce_window_s: float = 0.0,
                 max_fused_rows: int = 4096,
                 max_fused_bytes: int = 64 << 20,
                 adaptive_fusion: bool = False,
                 target_launch_s: float = 0.25,
                 shard_min_bytes: int = 8 << 20):
        self.devices = _resolve_devices(devices)
        self.buffer_reuse = buffer_reuse
        self.overlap = overlap
        self.coalesce = coalesce
        self.max_batch = max(1, int(max_batch))
        self.coalesce_window_s = coalesce_window_s
        self.shard_min_bytes = max(1, int(shard_min_bytes))
        self.policy = FusionPolicy(max_fused_rows, max_fused_bytes,
                                   adaptive=adaptive_fusion,
                                   target_launch_s=target_launch_s)
        self.cost = KernelCostModel(_COST_START)
        # jobs submitted while the mesh has no devices park here (their
        # depth still shows in queue_depth); nothing drains them — same
        # semantics as the former shared queue with zero managers
        self.outstanding: LaneQueue = LaneQueue()
        # slot: staging-buffer cache by (role, shape, dtype); LIFO so the
        # most recently used (already allocated) slot is reused first
        self.idle: "queue.LifoQueue[dict]" = queue.LifoQueue()
        for _ in range(n_slots):
            self.idle.put({})
        self._pin = any(d.type == "cuda" for d in self.devices)
        self.running: List[Job] = []  # guarded by self._lock
        self._lock = threading.Lock()
        self._rr = 0  # guarded by self._lock
        self.metrics = metrics_mod.MetricsRegistry()
        # atomic counters: manager threads and submitters bump these
        # concurrently; reads keep the old plain-dict shape
        self.stats = self.metrics.group(
            ("jobs", "bytes", "launches", "coalesced", "max_fused",
             "scrub_jobs", "scrub_launches", "scrub_coalesced",
             "sharded_jobs", "shards", "manager_restarts"))
        # test hooks: _fault_hook(dev_index, batch) runs after a batch is
        # drained but OUTSIDE the launch try (an exception there kills
        # the manager thread -> crash-recovery path); _launch_hook runs
        # INSIDE it (injected latency counts as measured launch wall,
        # an exception fails only that batch)
        self._fault_hook: Optional[Callable] = None
        self._launch_hook: Optional[Callable] = None
        self._dev_states = [
            _DeviceState(i, d,
                         self.metrics.histogram(f"device{i}/launch_s"))
            for i, d in enumerate(self.devices)]
        # per-manager liveness: beats per loop iteration, parks while
        # blocked on an empty lane queue (idle mesh reads healthy)
        self.heartbeats = HeartbeatBoard()
        self._managers = [
            threading.Thread(target=self._manager_main, args=(s,),
                             daemon=True, name=f"crystal-mgr-{s.index}")
            for s in self._dev_states]
        self._alive = True
        self._shutdown_started = False  # guarded by self._lock
        for t in self._managers:
            t.start()

    # backward-compatible views of the (possibly adapted) fusion caps
    @property
    def max_fused_rows(self) -> int:
        return self.policy.cur_rows

    @property
    def max_fused_bytes(self) -> int:
        return self.policy.cur_bytes

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(self, kind: str, data: np.ndarray, meta=None,
               callback=None, lane: str = "fg") -> Job:
        """Submit one hashing job.  ``lane='batch'`` queues behind
        interactive ``fg`` traffic (the gateway's throughput QoS);
        ``lane='scrub'`` marks background node-runtime traffic that
        queues behind both and is tracked by the ``scrub_*`` stats
        counters.  Any lane's job fuses with any same-fuse-key job once
        a manager picks it up.  Jobs whose padded staging footprint
        reaches ``shard_min_bytes`` on a >= 2 device mesh are sharded
        into per-device sub-launches (child jobs appear in the stats;
        the returned parent resolves when all shards do)."""
        if not self._alive:
            raise RuntimeError("CrystalGPU engine is shut down")
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}")
        if kind == "gear":
            raise NotImplementedError(
                "gear hashing is not ported yet: it comes with the gear "
                "CDC slice (ca='cdc-gear')")
        job = self._make_job(kind, np.asarray(data), meta or {},
                             callback, lane)
        plan = self._shard_plan(job)
        if plan is not None:
            return self._submit_sharded(job, plan)
        self._dispatch(job)
        return job

    def map_stream(self, kind: str, buffers, meta=None) -> List[Job]:
        """Submit a stream of jobs back-to-back (the paper's batched
        streaming workload) and return the job list."""
        return [self.submit(kind, b, meta) for b in buffers]

    def _make_job(self, kind: str, data: np.ndarray, meta: Dict[str, Any],
                  callback, lane: str, rows: Optional[np.ndarray] = None,
                  lens: Optional[np.ndarray] = None) -> Job:
        job = Job(kind=kind, data=data, meta=meta, callback=callback,
                  lane=lane)
        if kind == "direct":
            if rows is None:
                rows, lens = _normalize_direct(job.data, job.meta)
            job.rows, job.lens = rows, lens
            job.fuse_key = ("direct",)
            n, w = rows.shape
            job.n_rows = n
            job.staged_width = 1 << (max(w, 4) - 1).bit_length()
        elif kind == "sliding":
            # stream jobs fuse only within a buffer-size octave class:
            # rows pad to the batch max, so fusing a 4 KB CDC job with a
            # 64 MB one would hash ~16000x padding for the small job —
            # the class bound keeps fusion for genuinely similar bursts
            octave = self.policy.octave_class(job.data.size)
            job.fuse_key = ("sliding", int(job.meta.get("window", 48)),
                            int(job.meta.get("stride", 4)), octave)
            n_words = (max(job.data.size, 1) + 3) // 4
            job.staged_width = 4 << (max(n_words, 4) - 1).bit_length()
        else:
            job.fuse_key = (kind, id(job))      # never fuses; error later
        return job

    # ------------------------------------------------------------------
    # load-aware dispatch
    # ------------------------------------------------------------------
    def _dispatch(self, job: Job, exclude: Optional[int] = None,
                  spread: bool = False) -> Job:
        """Place one job on the mesh: cheapest device by
        ``pending_s * slowdown``, with fuse-key affinity (a coalescable
        job follows its burst while the affine device's backlog stays
        within one job-cost of the best) and round-robin tie-breaking.
        ``exclude`` skips a device being crash-recovered; ``spread``
        disables the affinity pull (shard children were split to run on
        *different* devices — affinity would fuse them right back)."""
        with self._lock:
            job.cost_est = self.cost.estimate(job.kind, job.padded_bytes)
            states = self._dev_states
            cands = [s for s in states if s.index != exclude] or states
            if not cands:
                self.outstanding.put(job, lane=job.lane)
                return job
            self._rr = (self._rr + 1) % len(cands)
            rr = self._rr
            best = min(cands, key=lambda s: (s.load_score(),
                                             (s.index - rr) % len(cands)))
            tgt = best
            if self.coalesce and job.fuse_key and not spread:
                for s in cands:
                    if (s.last_fuse_key == job.fuse_key
                            and s.load_score() <= best.load_score()
                            + job.cost_est * max(s.slowdown, 1.0)):
                        tgt = s
                        break
            tgt.pending_s += job.cost_est
            tgt.queued_bytes += job.padded_bytes
            tgt.last_fuse_key = job.fuse_key
            job.device_index = tgt.index
            q = tgt.queue
        job.t_submit = time.perf_counter()
        q.put(job, lane=job.lane)
        return job

    # ------------------------------------------------------------------
    # whale-job sharding
    # ------------------------------------------------------------------
    def _shard_plan(self, job: Job):
        """Per-device sub-launch plan for a whale job, or None."""
        if len(self._dev_states) < 2:
            return None
        padded = job.padded_bytes
        if padded < self.shard_min_bytes:
            return None
        n_dev = len(self._dev_states)
        k = min(n_dev, max(2, padded // max(self.shard_min_bytes // 2, 1)))
        if job.kind == "direct":
            if job.n_rows < 2:
                return None
            k = min(k, job.n_rows)
            return [("rows", a, b, 0)
                    for a, b in ops.shard_row_ranges(job.n_rows, k)]
        if job.kind == "sliding":
            plan = ops.stream_shard_plan(
                int(job.data.size), job.kind, k,
                window=int(job.meta.get("window", 48)),
                stride=int(job.meta.get("stride", 4)))
            if plan is None:
                return None
            return [("span", a, b, drop) for a, b, drop in plan]
        return None

    def _submit_sharded(self, parent: Job, plan) -> Job:
        """Split ``parent`` into child sub-launches, one per plan entry;
        the last-finishing child's callback assembles the digests back
        into the parent's result in submission order."""
        k = len(plan)
        results: List[Optional[Job]] = [None] * k
        drops = [spec[3] for spec in plan]
        state_lock = threading.Lock()
        remaining = [k]

        def child_cb(i):
            def cb(child):
                with state_lock:
                    results[i] = child
                    remaining[0] -= 1
                    last = remaining[0] == 0
                if last:
                    self._assemble_shards(parent, results, drops)
            return cb

        flat = None if parent.kind == "direct" \
            else parent.data.reshape(-1)
        children = []
        for i, spec in enumerate(plan):
            _, a, b, _ = spec
            if parent.kind == "direct":
                child = self._make_job(
                    "direct", parent.rows[a:b], dict(parent.meta),
                    child_cb(i), parent.lane,
                    rows=parent.rows[a:b], lens=parent.lens[a:b])
            else:
                child = self._make_job(parent.kind, flat[a:b],
                                       dict(parent.meta), child_cb(i),
                                       parent.lane)
            children.append(child)
        self.stats.inc("sharded_jobs")
        self.stats.inc("shards", k)
        for child in children:
            self._dispatch(child, spread=True)
        return parent

    def _assemble_shards(self, parent: Job, results: List[Job], drops):
        err = next((c.error for c in results if c.error is not None),
                   None)
        if err is not None:
            parent.error = err
        else:
            try:
                if parent.kind == "direct":
                    parent.result = np.concatenate(
                        [c.result for c in results], axis=0)
                else:
                    parent.result = np.concatenate(
                        [c.result[d:] for c, d in zip(results, drops)])
            except BaseException as e:
                parent.error = e
        merged: Dict[str, float] = {}
        for c in results:                 # shards overlap: max per stage
            for kk, v in (c.timings or {}).items():
                merged[kk] = max(merged.get(kk, 0.0), v)
        parent.timings = merged
        # trace stamps span the union of the children's execution
        executed = [c for c in results if c.t_exec1 > 0.0]
        if executed:
            parent.t_submit = min(c.t_submit for c in executed)
            parent.t_exec0 = min(c.t_exec0 for c in executed)
            parent.t_exec1 = max(c.t_exec1 for c in executed)
        parent.done.set()
        if parent.callback is not None:
            try:
                parent.callback(parent)
            except Exception:
                pass

    # ------------------------------------------------------------------
    # stats / introspection
    # ------------------------------------------------------------------
    def snapshot_stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.stats)
            out["per_device"] = {s.index: s.stats_row()
                                 for s in self._dev_states}
            out["policy"] = self.policy.snapshot()
            out["cost_model"] = self.cost.snapshot()
        out["heartbeats"] = self.heartbeats.snapshot()
        return out

    def queue_depth(self, lane: Optional[str] = None,
                    device: Optional[int] = None) -> int:
        """Jobs queued (not yet picked up by a manager) in ``lane`` (or
        every lane when None) — on one device's queue when ``device``
        is an index, else summed across the mesh."""
        if device is not None:
            return self._dev_states[device].queue.depth(lane)
        return (sum(s.queue.depth(lane) for s in self._dev_states)
                + self.outstanding.depth(lane))

    def shutdown(self):
        """Stop the managers after every queue drains.  Idempotent: only
        the first call posts shutdown sentinels and joins — repeat calls
        (interpreter-exit atexit hook racing an explicit shutdown, a
        gateway closing over an already-stopped engine) return at once
        instead of double-posting sentinels."""
        with self._lock:
            first = not self._shutdown_started
            self._shutdown_started = True
            self._alive = False
        if not first:
            return
        for s in self._dev_states:
            s.queue.put(None)
        for t in self._managers:
            t.join(timeout=10)

    # ------------------------------------------------------------------
    # manager internals
    # ------------------------------------------------------------------
    def _get_slot(self) -> dict:
        if self.buffer_reuse:
            return self.idle.get()
        return {}

    def _put_slot(self, slot: dict):
        if self.buffer_reuse:
            self.idle.put(slot)

    def _stage_sync(self, dev: _DeviceState):
        """Baseline (no overlap): force completion at stage boundary."""
        if not self.overlap:
            dev.sync()

    def _staging(self, slot: dict, role: str, shape,
                 dtype: torch.dtype) -> torch.Tensor:
        """Pinned host staging buffer: reused from the slot cache, or a
        fresh allocation per job (the paper's unoptimized
        malloc-per-task).

        A reused buffer is not cleared: bytes past a row's length are
        never part of a kept result (digests are length-bound, and a kept
        window lies inside its job's bytes).  A slot returns to ``idle``
        only after its launch's output was pulled to the host, which
        synchronises the manager's stream after the copies that read the
        slot, so no later fill can overwrite a copy still in flight."""
        if not self.buffer_reuse:
            return torch.empty(shape, dtype=dtype, pin_memory=self._pin)
        key = (role, shape, dtype)
        buf = slot.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self._pin)
            slot[key] = buf
        return buf

    def _note_picked(self, dev: _DeviceState, job: Job):
        with self._lock:
            dev.picked.append(job)
            dev.queued_bytes = max(dev.queued_bytes - job.padded_bytes, 0)

    def _drain_batch(self, dev: _DeviceState, first: Job):
        """Greedy coalescing on one device's queue: pull queued jobs
        with ``first``'s fuse key behind it (direct with direct, sliding
        with identical window/stride).  Returns (batch,
        carry) where carry is a non-fusable job that was popped and must
        be executed next."""
        batch = [first]
        if not (self.coalesce and first.kind in ("direct", "sliding")):
            return batch, None
        rows, width = first.n_rows, first.staged_width
        max_rows = self.policy.cur_rows
        max_bytes = self.policy.cur_bytes
        deadline = time.perf_counter() + self.coalesce_window_s
        while len(batch) < self.max_batch:
            try:
                nxt = dev.queue.get_nowait()
            except queue.Empty:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = dev.queue.get(timeout=wait)
                except queue.Empty:
                    break
            if nxt is None:               # shutdown token: repost + stop
                dev.queue.put(None)
                break
            self._note_picked(dev, nxt)
            if nxt.fuse_key != first.fuse_key:
                return batch, nxt
            # cap the fused launch by its actual padded staging matrix
            # (every row pads to the batch-max width) and, for direct,
            # by total rows — not just by job count: many multi-row or
            # wide jobs must not stack into an unbounded batch
            new_width = max(width, nxt.staged_width)
            if (rows + nxt.n_rows) * new_width > max_bytes:
                return batch, nxt
            if nxt.kind == "direct" and rows + nxt.n_rows > max_rows:
                return batch, nxt
            rows += nxt.n_rows
            width = new_width
            batch.append(nxt)
        return batch, None

    def _manager_main(self, dev: _DeviceState):
        """Crash-resilient wrapper: an exception escaping the manager
        loop fails the picked in-flight jobs, re-dispatches the queued
        remainder to surviving devices, counts ``manager_restarts``,
        and restarts the loop — the queue is never stranded."""
        while True:
            try:
                self._manager_loop(dev)
                return                    # clean sentinel exit
            except BaseException as e:
                self._recover_manager(dev, e)

    def _manager_loop(self, dev: _DeviceState):
        # terminates only on its shutdown token, never on the _alive
        # flag: a carried (popped-but-unfused) job must still execute
        # even if shutdown() lands while the previous batch runs
        hb = self.heartbeats.heartbeat(f"manager{dev.index}")
        carry: Optional[Job] = None
        while True:
            hb.beat()
            if carry is not None:
                job, carry = carry, None
            else:
                hb.park()       # indefinite block on an empty lane queue
                job = dev.queue.get()
                if job is None:
                    hb.park()   # clean shutdown: stay dormant
                    return
                hb.beat()
                self._note_picked(dev, job)
            batch, carry = self._drain_batch(dev, job)
            if self._fault_hook is not None:
                self._fault_hook(dev.index, batch)
            slot = self._get_slot()
            wall0 = time.perf_counter()
            failed = False
            try:
                with self._lock:
                    self.running.extend(batch)
                if self._launch_hook is not None:
                    self._launch_hook(dev.index, batch)
                if job.kind == "direct":
                    self._execute_direct(dev, slot, batch)
                else:
                    self._execute_stream_batch(dev, slot, batch)
            except BaseException as e:          # surfaced via wait()
                failed = True
                for j in batch:
                    j.error = e
            finally:
                wall1 = time.perf_counter()
                self._retire(dev, batch, wall1 - wall0, failed)
                self._put_slot(slot)
                for j in batch:
                    j.t_exec0, j.t_exec1 = wall0, wall1
                    j.done.set()
                    if j.callback is not None:
                        try:
                            j.callback(j)
                        except Exception:
                            pass

    def _retire(self, dev: _DeviceState, batch: List[Job], wall_s: float,
                failed: bool):
        """Credit the backlog clock, feed the cost model + fusion policy
        with the measured launch wall time, and update the per-device
        latency EWMAs (successful launches only)."""
        kind = batch[0].kind
        padded = sum(j.padded_bytes for j in batch)
        if kind == "direct":
            actual = sum(int(j.lens.sum()) for j in batch
                         if j.lens is not None)
            n_rows = sum(j.n_rows for j in batch)
        else:
            actual = sum(int(j.data.size) for j in batch)
            n_rows = len(batch)
        wbucket = max(j.staged_width for j in batch)
        with self._lock:
            for j in batch:
                if j in self.running:
                    self.running.remove(j)
                if j in dev.picked:
                    dev.picked.remove(j)
                dev.pending_s = max(dev.pending_s - j.cost_est, 0.0)
            if failed or kind not in ("direct", "sliding"):
                return
            est = max(self.cost.estimate(kind, padded), 1e-9)
            self.cost.observe(kind, padded, wall_s)
            oh, spb = self.cost.params(kind)
            self.policy.observe(padded, actual, n_rows, wall_s, oh, spb)
            dev.launch_hist.record(wall_s)
            key = (kind, wbucket)
            prev = dev.ewma_bucket_s.get(key)
            dev.ewma_bucket_s[key] = wall_s if prev is None \
                else 0.75 * prev + 0.25 * wall_s
            dev.ewma_launch_s = wall_s if not dev.ewma_launch_s \
                else 0.75 * dev.ewma_launch_s + 0.25 * wall_s
            ratio = min(max(wall_s / est, 0.05), 50.0)
            dev.slowdown = min(max(0.7 * dev.slowdown + 0.3 * ratio,
                                   0.05), 50.0)

    def _recover_manager(self, dev: _DeviceState, err: BaseException):
        """Fail the picked in-flight jobs with ``err``, move the queued
        remainder to surviving devices (back onto our own queue when the
        mesh has no other device), and count the restart."""
        with self._lock:
            picked, dev.picked = dev.picked, []
            self.stats.inc("manager_restarts")
            dev.restarts += 1
            for j in picked:
                dev.pending_s = max(dev.pending_s - j.cost_est, 0.0)
                if j in self.running:
                    self.running.remove(j)
        for j in picked:
            if not j.done.is_set():
                j.error = err
                j.done.set()
                if j.callback is not None:
                    try:
                        j.callback(j)
                    except Exception:
                        pass
        moved: List[Job] = []
        while True:                       # sentinel dequeues only once
            try:                          # the lanes are empty, so this
                item = dev.queue.get_nowait()   # drains every queued job
            except queue.Empty:
                break
            if item is None:
                dev.queue.put(None)       # keep our shutdown token
                break
            moved.append(item)
        exclude = dev.index if len(self._dev_states) > 1 else None
        for j in moved:
            with self._lock:
                dev.pending_s = max(dev.pending_s - j.cost_est, 0.0)
                dev.queued_bytes = max(dev.queued_bytes - j.padded_bytes,
                                       0)
            self._dispatch(j, exclude=exclude)

    def _account(self, dev: _DeviceState, n_jobs: int, nbytes: int,
                 n_scrub: int = 0):
        self.stats.inc("jobs", n_jobs)
        self.stats.inc("bytes", nbytes)
        self.stats.inc("launches")
        self.stats.inc("coalesced", n_jobs - 1)
        self.stats.max_update("max_fused", n_jobs)
        with self._lock:
            dev.jobs += n_jobs
            dev.launches += 1
            dev.bytes += nbytes
        if n_scrub:
            # a launch containing any scrub job counts once, so
            # scrub_launches < scrub_jobs is the fused-scrub signature
            self.stats.inc("scrub_jobs", n_scrub)
            self.stats.inc("scrub_launches")
            self.stats.inc("scrub_coalesced", n_scrub - 1)

    # -- fused direct batch --------------------------------------------
    def _execute_direct(self, dev: _DeviceState, slot: dict,
                        batch: List[Job]):
        t0 = time.perf_counter()
        # stage 1-2: staging + transfer in.  One padded [B, W] batch for
        # the whole burst; rows are length-bound so padding to the widest
        # row never changes a digest.  B and W are bucketed to powers of
        # two so a few staging shapes serve every ragged burst.
        W = max(j.rows.shape[1] for j in batch)
        W = 1 << (max(W, 4) - 1).bit_length()
        n_rows = sum(j.rows.shape[0] for j in batch)
        B = 1 << (max(n_rows, 1) - 1).bit_length()
        staging = self._staging(slot, "direct", (B, W), torch.uint8)
        rows = staging.numpy()
        lens = np.zeros((B,), np.int64)
        r = 0
        for j in batch:
            n, w = j.rows.shape
            rows[r:r + n, :w] = j.rows
            lens[r:r + n] = j.lens
            r += n
        lens_w = torch.from_numpy((lens // 4).astype(np.int32))
        with dev.on_device():
            dev_words = staging.view(torch.uint32).to(dev.device,
                                                      non_blocking=True)
            self._stage_sync(dev)
            t1 = time.perf_counter()
            # stage 3: ONE kernel launch for the fused batch
            dig = md5.md5_words(dev_words, lens_w, stream=dev.stream)
            self._stage_sync(dev)
            t2 = time.perf_counter()
            # stage 4: transfer out (digests only — 16 B per row); the
            # copy synchronises the manager's stream
            host = ops.digest_bytes(dig)
        t3 = time.perf_counter()
        timings = {"in": t1 - t0, "kernel": t2 - t1, "out": t3 - t2}
        r = 0
        for j in batch:
            n = j.rows.shape[0]
            j.result = host[r:r + n].copy()
            j.timings = dict(timings)       # batch-wide stage times
            r += n
        self._account(dev, len(batch), int(np.sum(lens)),
                      sum(j.lane == "scrub" for j in batch))

    # -- fused streaming batch (sliding) -------------------------------
    def _pull(self, slot: dict, dev: _DeviceState,
              out: torch.Tensor) -> np.ndarray:
        """Copy a kernel output to the host through a reused pinned
        buffer and synchronise the manager's stream."""
        if dev.stream is None:
            return out.numpy()
        buf = self._staging(slot, "out", tuple(out.shape), out.dtype)
        buf.view(torch.int32).copy_(out.view(torch.int32),
                                    non_blocking=True)
        dev.sync()
        return buf.numpy()

    def _execute_stream_batch(self, dev: _DeviceState, slot: dict,
                              batch: List[Job]):
        """Execute a burst of same-config stream jobs as ONE padded
        [B, L] multi-row kernel launch.  Rows are padded to the widest
        buffer; B and the word width are bucketed to powers of two.  Each
        job's hashes are sliced out of the fused phase-matrix output."""
        kind = batch[0].kind
        if kind != "sliding":
            raise ValueError(f"unknown job kind {kind!r}")
        t0 = time.perf_counter()
        flats = [j.data.reshape(-1).astype(np.uint8, copy=False)
                 for j in batch]
        lens = [f.size for f in flats]
        n_words = (max(max(lens), 1) + 3) // 4
        Wb = 1 << (max(n_words, 4) - 1).bit_length()
        B = 1 << (len(batch) - 1).bit_length()
        staging = self._staging(slot, "stream", (B, Wb * 4), torch.uint8)
        rows_u8 = staging.numpy()
        for i, f in enumerate(flats):
            rows_u8[i, :f.size] = f
        window = int(batch[0].meta.get("window", 48))
        stride = int(batch[0].meta.get("stride", 4))
        phases = sliding_md5.phases_for(stride)
        with dev.on_device():
            dev_words = staging.view(torch.uint32).to(dev.device,
                                                      non_blocking=True)
            self._stage_sync(dev)
            t1 = time.perf_counter()
            out = sliding_md5.sliding_md5_words(dev_words, window // 4,
                                                stride, stream=dev.stream)
            self._stage_sync(dev)
            t2 = time.perf_counter()
            host = self._pull(slot, dev, out)            # [B, R, Wb]
        for i, j in enumerate(batch):
            n_off = (lens[i] - window) // stride + 1
            j.result = ops.sliding_finish(host[i], phases, n_off)
        t3 = time.perf_counter()
        timings = {"in": t1 - t0, "kernel": t2 - t1, "out": t3 - t2}
        for j in batch:
            j.timings = dict(timings)       # batch-wide stage times
        self._account(dev, len(batch), int(sum(lens)),
                      sum(j.lane == "scrub" for j in batch))


# ----------------------------------------------------------------------
# process-wide default engine: shared across SAIs so concurrent writers'
# requests coalesce into common launches
# ----------------------------------------------------------------------
_DEFAULT: Optional[CrystalGPU] = None
_DEFAULT_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False


def _shutdown_default_engine():
    """atexit hook: interpreter exit must never race live manager
    threads (daemon threads dying mid-launch while CUDA tears down)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        eng, _DEFAULT = _DEFAULT, None
    if eng is not None:
        eng.shutdown()                 # idempotent: explicit shutdowns ok


def default_engine() -> CrystalGPU:
    """The process-wide shared offload engine (created on first use,
    recreated if a previous default was shut down).  The first creation
    registers an ``atexit`` shutdown hook so engines left running at
    interpreter exit are drained and joined cleanly."""
    global _DEFAULT, _ATEXIT_REGISTERED
    with _DEFAULT_LOCK:
        if _DEFAULT is None or not _DEFAULT._alive:
            if not _ATEXIT_REGISTERED:
                atexit.register(_shutdown_default_engine)
                _ATEXIT_REGISTERED = True
            _DEFAULT = CrystalGPU()
        return _DEFAULT
