"""Client System Access Interface (SAI) — the MosaStore client analog.

Implements the paper's write path (Figure 3): buffered writes are chunked
(fixed-size or content-based via the accelerator), chunk hashes are
computed by the CUDA hashing kernels through the CrystalGPU offload
engine, compared
against the block registry's indexed digest->locations map for similarity
detection, and only novel blocks are striped over the storage nodes.  The
read path re-hashes fetched blocks (the paper's "traditional system that
uses hashing to preserve data integrity") and falls back to block
replicas on node failure.

All hashing — direct block digests, sliding-window CDC, gear CDC, and
read-path verification — flows through the offload engine
(``SAI.engine``); an SAI constructed without an explicit engine shares
the process-wide default so concurrent writers' and readers' hash
requests coalesce into common batch launches.

Async write pipeline (paper Table 1, overlapped execution):
``write_async`` returns a :class:`WriteFuture` and runs chunk -> hash ->
store as staged pipeline threads, so the chunk/hash stages of write i+1
overlap the store stage of write i, and the engine fuses the resulting
burst of hash requests into batched kernel launches.  The store stage is
sharded into per-path commit lanes (``SAIConfig.store_lanes``) hashed by
path, so concurrent writers to different paths no longer serialize on a
single store worker while commits stay in submission order per path.

Read/verify pipeline: ``read`` gathers all fetched blocks and verifies
them with ONE fused ``direct`` hash request (digest comparison on the
host — zero per-block ``hashlib`` calls on the engine path), instead of the
per-block host hashing the paper shows must be amortized via batching.
``read_async`` returns a :class:`ReadFuture` and runs fetch -> verify ->
assemble as staged pipeline threads with replica failover retained:
verify of read i overlaps fetch of read i+1, and concurrent readers'
verify requests coalesce across SAIs through the shared engine.

``read_range(path, offset, length)`` is the Merkle-proof partial read:
only the covering blocks are fetched, and each is verified against the
version's stored ``merkle_root`` via ``integrity.merkle_proof`` instead
of re-reading (or re-hashing) the whole version.

A verify failure no longer kills the read outright: the corrupt copy is
reported to the metadata manager as a quarantine hint (feeding the node
runtime's repair pipeline) and the block is
speculatively re-fetched from the next replica; IOError is raised only
when every replica fails its digest check.  An optional block-level LRU
read cache (``SAIConfig.read_cache_bytes``, default off) serves repeat
reads of hot verified blocks without touching the nodes or the engine
(hit/miss counters in ``SAI.read_stats``).

Configurations mirror the paper's evaluation matrix:
  ca='none'                 -> non-CA (direct write, no hashing)
  ca='fixed'                -> fixed-size blocks + direct hashing
  ca='cdc'                  -> content-based chunking (sliding-window MD5)
  ca='cdc-gear'             -> beyond-paper gear-hash CDC
  ca='fastcdc'              -> FastCDC (Xia et al., USENIX ATC 2016): the
        gear hash under a strict mask (``mask_s``) up to ``avg_chunk``
        and a loose one (``mask_l``) after it, normalized chunking
  hasher='gpu' | 'cpu'      ('tpu' is accepted as another name for 'gpu',
        so configurations move between the JAX package and this one; the
        port has no CA-Infinite oracle: 'infinite' is refused, since a
        traced write's sai/hash span shows the hash time it would hide)
"""
from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core import chunking
from repro_torch.core import crystal as crystal_mod
from repro_torch.core import integrity
from repro_torch.core.castore import BlockMeta, MetadataManager, NodeFailure
from repro_torch.core.crystal import CrystalGPU
from repro_torch.obs import HeartbeatBoard, MetricsRegistry, Trace


# hasher names that hash through the offload engine ('tpu' is the JAX
# package's name for the same path)
ENGINE_HASHERS = ("gpu", "tpu")
# chunking modes (SAIConfig.ca)
CA_MODES = ("none", "fixed", "cdc", "cdc-gear", "fastcdc")


@dataclass
class SAIConfig:
    ca: str = "fixed"                 # one of CA_MODES
    block_size: int = 1 << 20         # fixed-size block bytes
    avg_chunk: int = 1 << 20          # CDC target chunk
    min_chunk: int = 256 << 10
    max_chunk: int = 4 << 20
    window: int = 48
    stride: int = 4
    mask_s: int = 0                   # ca='fastcdc': the 32-bit strict
    mask_l: int = 0                   # and loose masks over the gear hash
    hasher: str = "gpu"               # gpu (alias tpu) | cpu
    stripe_width: int = 4
    store_lanes: int = 4              # parallel per-path commit lanes
    read_cache_bytes: int = 0         # block-level LRU read cache budget
    #                                   (0 = off); hits skip fetch+verify
    lane: str = "fg"                  # engine priority lane for every
    #                                   hash submission: 'fg' | 'batch' |
    #                                   'scrub' (gateway QoS classes map
    #                                   tenants onto these)
    durable_sync: bool = True         # with a WAL-backed manager, block
    #                                   each write until its commit
    #                                   record (and the block bytes it
    #                                   references) survive a crash —
    #                                   one group-commit fsync wait, not
    #                                   per-block fsyncs.  False =
    #                                   eventual durability (the flush
    #                                   interval).  No-op for in-memory
    #                                   stores.

    def __post_init__(self):
        if self.hasher not in ENGINE_HASHERS + ("cpu",):
            raise ValueError(
                f"hasher={self.hasher!r}: the port hashes with 'gpu' "
                f"(alias 'tpu') or 'cpu' and has no CA-Infinite oracle")
        if self.ca not in CA_MODES:
            raise ValueError(f"ca={self.ca!r}: expected one of {CA_MODES}")
        if self.ca == "fastcdc":
            for name in ("mask_s", "mask_l"):
                if not 0 < getattr(self, name) < 2 ** 32:
                    raise ValueError(f"ca='fastcdc' needs {name}, a nonzero "
                                     f"32-bit mask over the gear hash")
            # a cut's hash then covers a whole window of the chunk's bytes
            if not chunking.GEAR_WINDOW <= self.min_chunk \
                    <= self.avg_chunk <= self.max_chunk:
                raise ValueError(
                    f"ca='fastcdc' needs {chunking.GEAR_WINDOW} <= "
                    f"min_chunk <= avg_chunk <= max_chunk")


@dataclass
class WriteStats:
    total_bytes: int = 0
    new_bytes: int = 0
    new_blocks: int = 0
    dup_blocks: int = 0

    @property
    def similarity(self) -> float:
        total = self.new_blocks + self.dup_blocks
        return self.dup_blocks / total if total else 0.0


class StoreIOError(IOError):
    """A store-stage block write failed (disk full, permissions, torn
    device).  Carries the failing path/digest/node so a
    ``WriteFuture.result()`` raises actionable context instead of the
    bare OSError the pipeline thread caught."""

    def __init__(self, path: str, digest: bytes, node_id: int,
                 cause: BaseException):
        super().__init__(
            f"store stage failed for {path!r} block {digest.hex()} "
            f"on node {node_id}: {cause}")
        self.path = path
        self.digest = digest
        self.node_id = node_id
        self.cause = cause


class WriteFuture:
    """Handle for an in-flight pipelined write; resolves to WriteStats."""

    def __init__(self):
        self._done = threading.Event()
        self._stats: Optional[WriteStats] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> WriteStats:
        if not self._done.wait(timeout):
            raise TimeoutError("write still in flight")
        if self._error is not None:
            raise self._error
        return self._stats

    wait = result

    def _resolve(self, stats: WriteStats):
        self._stats = stats
        self._done.set()

    def _fail(self, error: BaseException):
        self._error = error
        self._done.set()


class ReadFuture:
    """Handle for an in-flight pipelined read; resolves to the file
    bytes (verified when the read was submitted with verify=True)."""

    def __init__(self):
        self._done = threading.Event()
        self._data: Optional[bytes] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> bytes:
        if not self._done.wait(timeout):
            raise TimeoutError("read still in flight")
        if self._error is not None:
            raise self._error
        return self._data

    wait = result

    def _resolve(self, data: bytes):
        self._data = data
        self._done.set()

    def _fail(self, error: BaseException):
        self._error = error
        self._done.set()


class _HashHandle:
    """Uniform handle over an in-flight chunk-digest computation: either
    host digests computed eagerly (cpu / empty input) or one
    or more offload-engine jobs — a whale submission splits into
    independently packed chunk groups (see ``SAI._submit_hash``) —
    whose digests are materialized in submission order on wait()."""

    def __init__(self, jobs: Optional[List[crystal_mod.Job]] = None,
                 digests: Optional[List[bytes]] = None):
        self._jobs = jobs or []
        self._digests = digests

    def wait(self) -> List[bytes]:
        if self._digests is None:
            out: List[bytes] = []
            for job in self._jobs:
                rows = job.wait()                   # [n, 16] uint8
                out.extend(rows[i].tobytes()
                           for i in range(rows.shape[0]))
            self._digests = out
        return self._digests


def _trace_engine_jobs(trace: "Trace", handle: _HashHandle,
                       parent: str) -> None:
    """Turn the engine jobs' t_submit/t_exec stamps into
    engine/queue + engine/launch spans, and their stages into
    engine/stage, engine/wait and engine/finish (per device, per lane),
    each caused by ``parent``.  Only meaningful after ``handle.wait()``;
    the cpu hasher has no engine jobs and contribute no spans."""
    for job in handle._jobs:
        if job.t_exec1 <= 0.0:
            continue
        if job.t_submit > 0.0:
            trace.add_span("engine/queue", job.t_submit, job.t_exec0,
                           parent, device=job.device_index, lane=job.lane)
        trace.add_span("engine/launch", job.t_exec0, job.t_exec1, parent,
                       device=job.device_index, lane=job.lane)
        _trace_engine_stages(trace, job, parent)


def _trace_engine_stages(trace: "Trace", job: crystal_mod.Job,
                         parent: str) -> None:
    """engine/stage [t_exec0, t_staged] (the pinned staging filled, the
    H2D enqueued), engine/wait [t_staged, t_waited] (the kernel enqueued,
    the output's D2H synchronised) and engine/finish [t_waited, t_exec1]
    (results cut per job, the launch retired) of one executed job: what
    the host does, not what the card does.  A fused launch stamps each
    of its jobs alike."""
    if job.t_waited <= 0.0:
        return
    for name, t0, t1 in (("engine/stage", job.t_exec0, job.t_staged),
                         ("engine/wait", job.t_staged, job.t_waited),
                         ("engine/finish", job.t_waited, job.t_exec1)):
        trace.add_span(name, t0, t1, parent, device=job.device_index,
                       lane=job.lane)


_ORACLE_COUNTER = [0]
_ORACLE_LOCK = threading.Lock()
# ca='none' digests are synthetic, not content-derived: a per-process
# nonce keeps a restarted process from colliding with raw digests a
# durable store persisted under the previous process's counter values
_ORACLE_NONCE = os.urandom(4)


class SAI:
    def __init__(self, manager: MetadataManager, config: SAIConfig,
                 crystal: Optional[CrystalGPU] = None):
        self.manager = manager
        self.cfg = config
        self.crystal = crystal
        # block-level LRU read cache (digest -> verified bytes), active
        # when cfg.read_cache_bytes > 0; hits skip fetch AND re-verify
        # (entries are inserted only after a digest check passed)
        self._cache: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._cache_used = 0
        self._cache_lock = threading.Lock()
        # atomic counters: concurrent read_async verify/fetch threads
        # bump these without holding the cache lock
        self.metrics = MetricsRegistry()
        self.read_stats = self.metrics.group(
            ("cache_hits", "cache_misses", "refetches",
             "cache_invalidations"))
        # a quarantine anywhere in a digest's replica set condemns the
        # cached copy too: the entry was verified at insertion, but its
        # provenance is now suspect, so the next read must re-fetch and
        # re-verify against the surviving replicas instead of serving
        # it.  Registered lazily on first cache use and removed by
        # close(), so closed SAIs don't leak into a long-lived
        # manager's listener list.
        self._cache_listener_on = False
        # pipeline-stage liveness: each stage thread beats per item and
        # parks across its blocking queue get (idle pipeline = healthy)
        self.heartbeats = HeartbeatBoard()
        self._pipe_lock = threading.Lock()
        self._chunk_q: Optional[queue.Queue] = None
        self._store_qs: Optional[List[queue.Queue]] = None
        self._fetch_q: Optional[queue.Queue] = None
        self._verify_q: Optional[queue.Queue] = None
        self._pipe_threads: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # hashing backends — everything flows through the offload engine
    # ------------------------------------------------------------------
    @property
    def engine(self) -> CrystalGPU:
        """The offload engine: the explicit one, else the process-wide
        shared default (so independent writers coalesce)."""
        if self.crystal is None:
            self.crystal = crystal_mod.default_engine()
        return self.crystal

    def _pack_chunks(self, chunks: List[bytes]):
        return pack_blocks(chunks)

    def _submit_hash(self, chunks: List[bytes]) -> _HashHandle:
        """Start hashing separate blocks (read-verify, refetch); non-
        blocking on the engine path.  Each group of ``_shard_groups`` is
        packed into rows (``pack_blocks``) and submitted as one row job:
        it pads only to its own widest chunk, hashing of group i overlaps
        the packing of group i+1, and the engine's load-aware dispatch
        spreads the groups across the device mesh.  Digest order is
        preserved — groups are contiguous and the handle concatenates
        them in submission order."""
        if not chunks:
            return _HashHandle(digests=[])
        if self.cfg.hasher == "cpu":
            return _HashHandle(digests=[block_digest_cpu(c)
                                        for c in chunks])
        eng = self.engine
        jobs = []
        for lo, hi in self._shard_groups(chunks, eng):
            rows, lens = self._pack_chunks(chunks[lo:hi])
            jobs.append(eng.submit("direct", rows, {"lens": lens},
                                   lane=self.cfg.lane))
        return _HashHandle(jobs=jobs)

    def _submit_spans(self, data: bytes, ends: List[int],
                      chunks: List[bytes],
                      trace: Optional[Trace] = None) -> _HashHandle:
        """Start hashing one write's ``chunks``, cut from ``data`` at
        ``ends``; non-blocking on the engine path.  On the engine the
        write is one spans job over its own image: the engine copies the
        image once and the kernel reads each chunk where it lies, so no
        row is packed, and the engine shards a whale image across a
        device mesh itself (the groups of ``_shard_groups`` saved
        padding only for rows).  ``hasher='cpu'`` hashes ``chunks`` with
        ``hashlib``.  ``trace`` takes one sai/hash/pack span, the job's
        preparation (meta ``chunks``, ``bytes``, and ``rows``, the
        digests the job returns, as when each chunk was a row)."""
        if self.cfg.hasher == "cpu" or not ends:
            return self._submit_hash(chunks)
        t0 = time.perf_counter()
        image = np.frombuffer(data, np.uint8)
        ends = np.asarray(ends, np.int64)
        if trace is not None:
            trace.add_span("sai/hash/pack", t0, time.perf_counter(),
                           "sai/hash", chunks=int(ends.size),
                           bytes=int(ends[-1]), rows=int(ends.size))
        return _HashHandle(jobs=[self.engine.submit(
            "direct", image[:int(ends[-1])], {"ends": ends},
            lane=self.cfg.lane)])

    @staticmethod
    def _shard_groups(chunks: List[bytes], eng) -> List[tuple]:
        """Contiguous ``(lo, hi)`` chunk-index groups for one hash
        submission: a single group normally, several balanced-byte
        groups for whale leaves (big checkpoint tensors) so the engine
        mesh can hash them in parallel."""
        total = sum(len(c) for c in chunks)
        shard = int(getattr(eng, "shard_min_bytes", 0) or 0)
        n_dev = max(len(getattr(eng, "devices", ())), 1)
        if len(chunks) < 2 or shard <= 0 or total < 2 * shard:
            return [(0, len(chunks))]
        n_groups = min(len(chunks), max(2, total // shard), 4 * n_dev)
        target = total / n_groups
        groups = []
        lo = acc = 0
        for i, c in enumerate(chunks):
            acc += len(c)
            if acc >= target and len(groups) < n_groups - 1:
                groups.append((lo, i + 1))
                lo, acc = i + 1, 0
        if lo < len(chunks):
            groups.append((lo, len(chunks)))
        return groups

    def _hash_chunks(self, chunks: List[bytes]) -> List[bytes]:
        return self._submit_hash(chunks).wait()

    def _boundaries(self, data: bytes,
                    trace: Optional[Trace] = None) -> List[int]:
        """Chunk ends of ``data``.  For content-defined chunking on the
        engine, the window-hash job tests the boundary rule on the card
        and returns only the candidate windows, which the host walks;
        ``hasher='cpu'`` hashes every window on the host and tests the
        rule there.  ``trace`` takes the window-hash job
        (sai/chunk/slide, with that job's engine stages, the rule test
        and compaction included) and the walk (sai/chunk/scan, with the
        candidates walked and the cuts forced at ``max_chunk``)."""
        cfg = self.cfg
        if len(data) == 0:
            return []
        if cfg.ca == "fixed":
            n = (len(data) + cfg.block_size - 1) // cfg.block_size
            return [min((i + 1) * cfg.block_size, len(data))
                    for i in range(n)]
        if cfg.ca not in ("cdc", "cdc-gear", "fastcdc"):
            raise ValueError(self.cfg.ca)
        if cfg.ca == "cdc":
            kind, window, stride = "sliding", cfg.window, cfg.stride
            meta = {"window": window, "stride": stride}
        else:
            kind, window, stride, meta = "gear", 1, 1, {}
        if cfg.ca == "fastcdc":
            # FastCDC cuts where the masked bits are all zero
            rule = (cfg.mask_s, 0, cfg.mask_l, 0)
        else:
            rule = chunking.boundary_rule(cfg.avg_chunk)
        t0 = time.perf_counter()
        job = None
        if cfg.hasher in ENGINE_HASHERS:
            job = self.engine.submit(
                kind, np.frombuffer(data, np.uint8),
                {**meta, **dict(zip(("mask", "magic", "mask2", "magic2"),
                                    rule))}, lane=cfg.lane)
            found = job.wait()
        else:
            hashes = _cpu_sliding(data, window, stride) \
                if kind == "sliding" else _cpu_gear(data)
            found = chunking.host_candidates(hashes, *rule)
        t1 = time.perf_counter()
        sizes = dict(avg_chunk=cfg.avg_chunk, min_chunk=cfg.min_chunk,
                     max_chunk=cfg.max_chunk)
        if cfg.ca == "fastcdc":
            bounds, forced = chunking.walk_normalized(found, len(data),
                                                      **sizes)
        else:
            bounds, forced = chunking.boundaries_from_candidates(
                found, len(data), window=window, stride=stride, **sizes)
        if trace is not None:
            trace.add_span("sai/chunk/slide", t0, t1, "sai/chunk",
                           bytes=len(data))
            if job is not None:
                _trace_engine_stages(trace, job, "sai/chunk/slide")
            trace.add_span("sai/chunk/scan", t1, time.perf_counter(),
                           "sai/chunk", chunks=len(bounds),
                           candidates=len(found), forced=forced)
        return bounds

    # ------------------------------------------------------------------
    # store stage (shared by sync write, async pipeline, checkpointer)
    # ------------------------------------------------------------------
    def _store_chunks(self, path: str, total_len: int,
                      chunks: List[bytes], digests: List[bytes],
                      stats: WriteStats,
                      trace: Optional[Trace] = None) -> WriteStats:
        """Dedup against the indexed digest->locations registry, store
        novel blocks, commit the block-map.

        Dedup is race-free across store lanes and concurrent SAIs: one
        atomic ``claim_blocks`` decides per digest whether it is already
        stored, ours to store, or being stored by a concurrent writer.
        All own claims are stored (and released) before waiting on other
        writers' claims — a writer never holds an unfinished claim while
        waiting, so claim waits cannot deadlock.

        Every digest is pinned for the whole claim -> store -> commit
        span, so the runtime GC can never reclaim a dedup-hit (or
        freshly stored) block before the block-map referencing it is
        committed.  ``trace`` takes sai/store/claim, sai/store/put,
        sai/store/commit (the block map built and committed) and
        sai/store/unpin."""
        mgr = self.manager
        t_claim = time.perf_counter()
        mgr.pin_blocks(digests)
        try:
            locmap, claimed, waits = mgr.claim_blocks(digests)
            t_put = time.perf_counter()
            if trace is not None:
                trace.add_span("sai/store/claim", t_claim, t_put,
                               "sai/store")
            new_idx = set()
            try:
                for i, (chunk, digest) in enumerate(zip(chunks, digests)):
                    if digest in claimed:
                        locs = mgr.place(digest)
                        self._put_block(path, digest, chunk, locs)
                        mgr.finish_claim(digest, locs)
                        claimed.remove(digest)
                        locmap[digest] = locs
                        new_idx.add(i)
            finally:
                for digest in list(claimed):         # error path: release
                    mgr.finish_claim(digest, None)
            t_commit = time.perf_counter()
            if trace is not None:
                trace.add_span("sai/store/put", t_put, t_commit,
                               "sai/store", blocks=len(new_idx))
            blocks: List[BlockMeta] = []
            for i, (chunk, digest) in enumerate(zip(chunks, digests)):
                locs = locmap.get(digest)
                if locs is None:
                    waits[digest].wait()
                    locs, is_new = self._resolve_block(path, digest, chunk)
                    if is_new:
                        new_idx.add(i)
                    locmap[digest] = locs
                if i in new_idx:
                    stats.new_blocks += 1
                    stats.new_bytes += len(chunk)
                else:
                    stats.dup_blocks += 1
                blocks.append(BlockMeta(digest, len(chunk), tuple(locs)))
            seq = mgr.commit_blockmap(path, blocks, total_len)
            if self.cfg.durable_sync and seq is not None:
                t_wal = time.perf_counter()
                mgr.wait_durable(seq)
                if trace is not None:
                    trace.add_span("wal/commit", t_wal, time.perf_counter(),
                                   "sai/store/commit", seq=seq)
            if trace is not None:
                trace.add_span("sai/store/commit", t_commit,
                               time.perf_counter(), "sai/store")
        finally:
            t_unpin = time.perf_counter()
            mgr.unpin_blocks(digests)
            if trace is not None:
                trace.add_span("sai/store/unpin", t_unpin,
                               time.perf_counter(), "sai/store")
        return stats

    def _put_block(self, path: str, digest: bytes, chunk: bytes, locs):
        """Store one block on its replica nodes, wrapping I/O failures
        with the failing path/digest (StoreIOError) so pipeline threads
        surface actionable errors on the WriteFuture."""
        for nid in locs:
            try:
                self.manager.nodes[nid].put(digest, chunk)
            except OSError as e:
                raise StoreIOError(path, digest, nid, e) from e

    def _resolve_block(self, path: str, digest: bytes, chunk: bytes):
        """Dup-or-store one block through the claim protocol (used when
        a concurrent writer's claim we waited on aborted): loops until
        the digest is either registered by someone (dup) or claimed and
        stored by us.  Returns (locations, is_new)."""
        mgr = self.manager
        while True:
            locmap, claimed, waits = mgr.claim_blocks([digest])
            if locmap:
                return locmap[digest], False
            if claimed:
                try:
                    locs = mgr.place(digest)
                    self._put_block(path, digest, chunk, locs)
                except BaseException:
                    mgr.finish_claim(digest, None)
                    raise
                mgr.finish_claim(digest, locs)
                return locs, True
            waits[digest].wait()

    def _write_raw(self, path: str, data: bytes) -> WriteStats:
        """ca='none': direct striping, no hashing (synthetic digests)."""
        cfg, mgr = self.cfg, self.manager
        stats = WriteStats(total_bytes=len(data))
        bs = cfg.block_size
        blocks = []
        pinned: List[bytes] = []
        try:
            for i in range(0, max(len(data), 1), bs):
                chunk = data[i:i + bs]
                with _ORACLE_LOCK:
                    _ORACLE_COUNTER[0] += 1
                    n = _ORACLE_COUNTER[0]
                digest = b"raw!" + _ORACLE_NONCE + n.to_bytes(8, "little")
                mgr.pin_blocks([digest])     # GC guard until commit
                pinned.append(digest)
                locs = mgr.place(digest)
                self._put_block(path, digest, chunk, locs)
                mgr.register_block(digest, locs)
                blocks.append(BlockMeta(digest, len(chunk), locs))
                stats.new_blocks += 1
                stats.new_bytes += len(chunk)
            seq = mgr.commit_blockmap(path, blocks, len(data))
            if self.cfg.durable_sync and seq is not None:
                mgr.wait_durable(seq)
        finally:
            mgr.unpin_blocks(pinned)
        return stats

    # ------------------------------------------------------------------
    # write paths
    # ------------------------------------------------------------------
    def write(self, path: str, data: bytes) -> WriteStats:
        cfg = self.cfg
        if cfg.ca == "none":
            return self._write_raw(path, data)
        stats = WriteStats(total_bytes=len(data))
        bounds = self._boundaries(data)
        chunks = chunking.split_chunks(data, bounds)
        digests = self._submit_spans(data, bounds, chunks).wait()
        return self._store_chunks(path, len(data), chunks, digests, stats)

    def write_async(self, path: str, data: bytes,
                    trace: Optional[Trace] = None) -> WriteFuture:
        """Pipelined write: chunk+hash of this write overlap the store
        stage of the previous one (and hash requests from back-to-back
        writes coalesce in the engine).  The store stage is sharded into
        per-path commit lanes, so writers to different paths commit in
        parallel; commit order matches submission order per path, so
        versioning is identical to sequential sync writes.

        ``trace`` (an ``obs.Trace``) rides the pipeline queues and
        collects sai/queue, sai/chunk, sai/hash and sai/store spans,
        their stages, the engine's and wal/commit (docs/TRACING_TORCH.md
        has the tree)."""
        t_queued = time.perf_counter() if trace is not None else 0.0
        fut = WriteFuture()
        with self._pipe_lock:
            self._ensure_pipeline()
            self._chunk_q.put((fut, path, bytes(data), trace, t_queued))  # ra: disable=RA04(unbounded queue: put cannot block; hoisting it would race close)
        return fut

    def flush(self):
        """Block until every pipelined write and read has completed."""
        with self._pipe_lock:
            chunk_q, store_qs = self._chunk_q, self._store_qs
            fetch_q, verify_q = self._fetch_q, self._verify_q
        if chunk_q is not None:
            chunk_q.join()
            for q in store_qs:
                q.join()
        if fetch_q is not None:
            fetch_q.join()
            verify_q.join()

    def close(self):
        """Drain and stop the pipeline threads (idempotent).  In-flight
        writes/reads complete first; a later write_async / read_async
        restarts its pipeline.  SAIs that only use sync ``write`` /
        ``read`` have no threads."""
        with self._pipe_lock:
            chunk_q, fetch_q = self._chunk_q, self._fetch_q
            threads = self._pipe_threads
            self._chunk_q = self._store_qs = None
            self._fetch_q = self._verify_q = None
            self._pipe_threads = []
        if chunk_q is not None:
            chunk_q.put(None)        # chunk worker forwards to each lane
        if fetch_q is not None:
            fetch_q.put(None)        # fetch worker forwards to verify
        for t in threads:
            t.join(timeout=60)
        with self._cache_lock:
            listener_on = self._cache_listener_on
            self._cache_listener_on = False
        if listener_on:              # don't leak into the manager's
            self.manager.remove_quarantine_listener(  # listener list
                self._on_quarantine_evict)

    def _ensure_pipeline(self):
        # caller holds _pipe_lock
        if self._chunk_q is not None:
            return
        self._chunk_q = queue.Queue()
        n_lanes = max(1, int(self.cfg.store_lanes))
        self._store_qs = [queue.Queue() for _ in range(n_lanes)]
        threads = [threading.Thread(target=self._chunk_loop,
                                    args=(self._chunk_q, self._store_qs),
                                    daemon=True, name="sai-chunk")]
        threads += [
            threading.Thread(target=self._store_loop, args=(q, i),
                             daemon=True, name=f"sai-store-{i}")
            for i, q in enumerate(self._store_qs)]
        self._pipe_threads.extend(threads)
        for t in threads:
            t.start()

    def _chunk_loop(self, chunk_q, store_qs):
        hb = self.heartbeats.heartbeat("chunk")
        while True:
            hb.park()                    # indefinite block while idle
            item = chunk_q.get()
            if item is None:                         # close() sentinel
                for q in store_qs:
                    q.put(None)
                chunk_q.task_done()
                return                   # heartbeat stays parked
            hb.beat()
            fut, path, data, trace, t_queued = item
            t0 = time.perf_counter()
            if trace is not None:
                trace.add_span("sai/queue", t_queued, t0)
            # per-path lane: commits for one path stay FIFO while
            # different paths commit on parallel lanes
            store_q = store_qs[hash(path) % len(store_qs)]
            try:
                if self.cfg.ca == "none":
                    store_q.put((fut, path, data, None, None, 0.0, trace))
                    continue
                bounds = self._boundaries(data, trace)
                t_split = time.perf_counter()
                chunks = chunking.split_chunks(data, bounds)
                t1 = time.perf_counter()
                if trace is not None:
                    trace.add_span("sai/chunk/split", t_split, t1,
                                   "sai/chunk", chunks=len(chunks))
                    trace.add_span("sai/chunk", t0, t1,
                                   chunks=len(chunks))
                handle = self._submit_spans(data, bounds, chunks,
                                            trace)  # non-blocking (gpu)
                store_q.put((fut, path, data, chunks, handle, t1, trace))
            except BaseException as e:
                fut._fail(e)
            finally:
                chunk_q.task_done()

    def _store_loop(self, store_q, lane: int = 0):
        hb = self.heartbeats.heartbeat(f"store{lane}")
        while True:
            hb.park()
            item = store_q.get()
            if item is None:                         # close() sentinel
                store_q.task_done()
                return
            hb.beat()
            fut, path, data, chunks, handle, t_hash0, trace = item
            try:
                if handle is None:                   # ca='none'
                    fut._resolve(self._write_raw(path, data))
                    continue
                stats = WriteStats(total_bytes=len(data))
                digests = handle.wait()
                t2 = time.perf_counter()
                if trace is not None:
                    trace.add_span("sai/hash", t_hash0, t2)
                    _trace_engine_jobs(trace, handle, "sai/hash")
                self._store_chunks(path, len(data), chunks, digests,
                                   stats, trace=trace)
                if trace is not None:
                    trace.add_span("sai/store", t2, time.perf_counter())
                fut._resolve(stats)
            except BaseException as e:
                fut._fail(e)
            finally:
                store_q.task_done()

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    # -- block-level LRU read cache (digest -> verified bytes) ---------
    def _ensure_cache_listener(self):
        if self.cfg.read_cache_bytes <= 0:
            return
        with self._cache_lock:
            if self._cache_listener_on:
                return
            self._cache_listener_on = True
        self.manager.add_quarantine_listener(self._on_quarantine_evict)

    def _cache_get(self, digest: bytes) -> Optional[bytes]:
        if self.cfg.read_cache_bytes <= 0:
            return None
        self._ensure_cache_listener()
        with self._cache_lock:
            data = self._cache.get(digest)
            if data is None:
                self.read_stats.inc("cache_misses")
                return None
            self._cache.move_to_end(digest)
            self.read_stats.inc("cache_hits")
            return data

    def _on_quarantine_evict(self, digest: bytes, node_id: int,
                             remaining):
        with self._cache_lock:
            data = self._cache.pop(digest, None)
            if data is not None:
                self._cache_used -= len(data)
                self.read_stats.inc("cache_invalidations")

    def _cache_put(self, digest: bytes, data: bytes):
        cap = self.cfg.read_cache_bytes
        if cap <= 0 or len(data) > cap:
            return
        self._ensure_cache_listener()
        with self._cache_lock:
            if digest in self._cache:
                self._cache.move_to_end(digest)
                return
            self._cache[digest] = data
            self._cache_used += len(data)
            while self._cache_used > cap:
                _, old = self._cache.popitem(last=False)
                self._cache_used -= len(old)

    def _fetch_blocks(self, blocks, locmap=None):
        """Fetch every block of a file version with replica failover.
        ``locmap`` carries the replica locations resolved by
        ``get_read_plan`` under one lock; blocks missing from it fall
        back to the block-map's recorded nodes (quarantined replicas
        are deprioritized to last resort).  Returns ``(datas, srcs)``
        where ``srcs[i]`` is the node id that served block i, or None
        for a read-cache hit (already verified)."""
        if locmap is None:
            locmap = {}
        mgr = self.manager
        # snapshot reference, checked without the manager lock: a
        # quarantine landing mid-read at worst serves the corrupt copy,
        # which the verify + speculative-refetch path then catches
        qmap = mgr.quarantined

        def try_locs(digest, locs):
            err = None
            # healthy replicas first; quarantined copies only as a
            # last resort (unverified reads of fully-corrupt blocks)
            qset = qmap.get(digest) if qmap else None
            if qset:
                locs = sorted(locs, key=lambda nid: nid in qset)
            for nid in locs:
                try:
                    return mgr.nodes[nid].get(digest), nid, None
                except (NodeFailure, KeyError) as e:
                    err = e
            return None, None, err

        datas: List[bytes] = []
        srcs: List[Optional[int]] = []
        for b in blocks:
            cached = self._cache_get(b.digest)
            if cached is not None:
                datas.append(cached)
                srcs.append(None)
                continue
            data, src, last_err = try_locs(b.digest,
                                           locmap.get(b.digest) or b.nodes)
            if data is None:
                # the plan may have gone stale (a node failed and
                # re-replication moved the block after the snapshot):
                # retry with a fresh registry lookup before giving up
                data, src, err2 = try_locs(b.digest,
                                           mgr.lookup_block(b.digest))
                last_err = err2 or last_err
            if data is None:
                raise NodeFailure(
                    f"block {b.digest.hex()[:8]} unavailable: {last_err}")
            datas.append(data)
            srcs.append(src)
        return datas, srcs

    def _submit_verify(self, blocks, datas: List[bytes], srcs=None):
        """Start re-hashing the verifiable fetched blocks as fused
        direct requests (non-blocking on the engine path): at most
        ceil(n / max_batch) engine submissions, so one huge read never
        stages a single unbounded [n, W] padded matrix.  Synthetic
        ``raw!`` digests (ca='none') carry no content hash and cache
        hits were verified at insertion — both are skipped.  Returns
        ``(handles, idxs)`` with idxs the block indices under check."""
        idxs = [i for i, b in enumerate(blocks)
                if not b.digest.startswith(b"raw!")
                and (srcs is None or srcs[i] is not None)]
        group = self.engine.max_batch \
            if self.cfg.hasher in ENGINE_HASHERS \
            else max(len(idxs), 1)
        handles = [self._submit_hash([datas[i] for i in idxs[k:k + group]])
                   for k in range(0, len(idxs), group)]
        return handles, idxs

    @staticmethod
    def _gather_digests(handles) -> List[bytes]:
        return [d for h in handles for d in h.wait()]

    def _finish_verify(self, blocks, datas, srcs, handles, idxs,
                       locmap=None):
        """Compare recomputed digests; on mismatch, speculatively
        re-fetch the block from the next replica (reporting the corrupt
        copy to the metadata manager as a quarantine hint for the node
        runtime's repair pipeline) and only raise IOError once every
        replica is exhausted.  Verified bytes enter the read cache."""
        digests = self._gather_digests(handles)
        for i, digest in zip(idxs, digests):
            if digest != blocks[i].digest:
                self._refetch_block(blocks[i], i, datas, srcs, locmap)
        for i in idxs:
            self._cache_put(blocks[i].digest, datas[i])

    def _refetch_block(self, b: BlockMeta, i: int, datas, srcs,
                       locmap=None):
        """Speculative re-fetch: the copy from ``srcs[i]`` failed its
        digest check — quarantine it and try the remaining replicas
        (freshest registry view first, then the block-map's recorded
        nodes) until one verifies."""
        mgr = self.manager
        tried = set()
        if srcs[i] is not None:
            tried.add(srcs[i])
            mgr.quarantine_block(b.digest, srcs[i])
        candidates = [nid for nid in
                      (tuple(mgr.lookup_block(b.digest))
                       + tuple((locmap or {}).get(b.digest, ())) + b.nodes)
                      if nid not in tried]
        for nid in dict.fromkeys(candidates):     # dedup, keep order
            tried.add(nid)
            try:
                data = mgr.nodes[nid].get(b.digest)
            except (NodeFailure, KeyError):
                continue
            if self._hash_chunks([data])[0] == b.digest:
                self.read_stats.inc("refetches")
                datas[i] = data
                srcs[i] = nid
                return
            mgr.quarantine_block(b.digest, nid)   # this copy is bad too
        raise IOError(
            f"integrity check failed for {b.digest.hex()[:8]}")

    def read(self, path: str, version: int = -1,
             verify: bool = True) -> bytes:
        """Verified read: all fetched blocks are re-hashed by ONE fused
        engine request (per-block ``hashlib`` only on the cpu hasher),
        digests are compared on the host, and the file is assembled.
        A digest mismatch triggers speculative re-fetch from the next
        replica (plus a quarantine hint to the node runtime) before
        raising IOError."""
        fv, locmap = self.manager.get_read_plan(path, version)
        if fv is None:
            raise FileNotFoundError(path)
        datas, srcs = self._fetch_blocks(fv.blocks, locmap)
        if verify:
            handles, idxs = self._submit_verify(fv.blocks, datas, srcs)
            self._finish_verify(fv.blocks, datas, srcs, handles, idxs,
                                locmap)
        return b"".join(datas)[:fv.total_len]

    def read_range(self, path: str, offset: int, length: int,
                   version: int = -1, verify: bool = True) -> bytes:
        """Merkle-proof partial read: fetch ONLY the blocks covering
        ``[offset, offset+length)`` and verify each against the stored
        file-level ``FileVersion.merkle_root`` via a membership proof
        (``integrity.merkle_proof``) — no other block of the version is
        ever fetched or hashed.  The proof path is built from the
        block-map's leaf digests and anchored at the committed root, so
        a partial read detects both corrupt block bytes (recomputed
        digest breaks the proof; speculative re-fetch from the next
        replica, as in full reads) and a tampered block-map entry (the
        stored digest itself fails the proof => IOError).  The range
        end is clamped to the file length and ``offset == total_len``
        (exactly at EOF) reads empty, but an offset strictly past EOF
        raises ``ValueError`` — it names bytes that never existed,
        which is a caller bug, not a short read; ``raw!`` blocks
        (ca='none') carry no content hash and are served unverified, as
        in full reads."""
        if offset < 0 or length < 0:
            raise ValueError("offset and length must be non-negative")
        fv, locmap = self.manager.get_read_plan(path, version)
        if fv is None:
            raise FileNotFoundError(path)
        if offset > fv.total_len:
            raise ValueError(
                f"offset {offset} past EOF ({fv.total_len}) for {path}")
        end = min(offset + length, fv.total_len)
        if end <= offset:
            return b""
        first = None
        start0 = pos = 0
        cover: List[BlockMeta] = []
        for i, b in enumerate(fv.blocks):
            if pos + b.length > offset and pos < end:
                if first is None:
                    first, start0 = i, pos
                cover.append(b)
            pos += b.length
            if pos >= end:
                break
        datas, srcs = self._fetch_blocks(cover, locmap)
        if verify:
            handles, idxs = self._submit_verify(cover, datas, srcs)
            recomputed = dict(zip(idxs, self._gather_digests(handles)))
            leaves = [b.digest for b in fv.blocks]
            # every non-raw covering block is proof-checked — including
            # read-cache hits (their bytes were digest-verified at
            # insertion; the proof still anchors the digest to the
            # root, so a tampered block-map is caught warm or cold) —
            # and the tree is built ONCE for the whole range
            check = [k for k, b in enumerate(cover)
                     if not b.digest.startswith(b"raw!")]
            proofs = integrity.merkle_proofs(
                leaves, [first + k for k in check])
            for k in check:
                digest = recomputed.get(k)
                if digest is not None and digest != cover[k].digest:
                    # corrupt fetched copy: quarantine + next replica
                    # (the refetch re-verifies the content hash, so
                    # bytes match the stored digest from here on)
                    self._refetch_block(cover[k], k, datas, srcs, locmap)
                gi = first + k
                if not integrity.merkle_verify(cover[k].digest, gi,
                                               proofs[gi],
                                               fv.merkle_root):
                    raise IOError(
                        f"merkle proof failed for block {gi} of {path}")
            for k in idxs:
                self._cache_put(cover[k].digest, datas[k])
        buf = b"".join(datas)
        return buf[offset - start0:end - start0]

    def read_async(self, path: str, version: int = -1,
                   verify: bool = True,
                   trace: Optional[Trace] = None) -> ReadFuture:
        """Pipelined read: fetch -> verify -> assemble as staged threads.
        The verify stage of read i (waiting on the engine digest) overlaps
        the fetch stage of read i+1, and verify requests from concurrent
        readers coalesce into common batch launches through the shared
        engine.  ``trace`` collects sai/fetch, sai/verify/submit,
        sai/verify (with its engine spans) and sai/assemble spans."""
        fut = ReadFuture()
        with self._pipe_lock:
            self._ensure_read_pipeline()
            self._fetch_q.put((fut, path, version, verify, trace))  # ra: disable=RA04(unbounded queue: put cannot block; hoisting it would race close)
        return fut

    def _ensure_read_pipeline(self):
        # caller holds _pipe_lock
        if self._fetch_q is not None:
            return
        self._fetch_q = queue.Queue()
        self._verify_q = queue.Queue()
        threads = [
            threading.Thread(target=self._fetch_loop,
                             args=(self._fetch_q, self._verify_q),
                             daemon=True, name="sai-fetch"),
            threading.Thread(target=self._verify_loop,
                             args=(self._verify_q,),
                             daemon=True, name="sai-verify")]
        self._pipe_threads.extend(threads)
        for t in threads:
            t.start()

    def _fetch_loop(self, fetch_q, verify_q):
        hb = self.heartbeats.heartbeat("fetch")
        while True:
            hb.park()
            item = fetch_q.get()
            if item is None:                         # close() sentinel
                verify_q.put(None)
                fetch_q.task_done()
                return
            hb.beat()
            fut, path, version, verify, trace = item
            try:
                t0 = time.perf_counter()
                fv, locmap = self.manager.get_read_plan(path, version)
                if fv is None:
                    raise FileNotFoundError(path)
                datas, srcs = self._fetch_blocks(fv.blocks, locmap)
                if trace is not None:
                    trace.add_span("sai/fetch", t0, time.perf_counter(),
                                   blocks=len(fv.blocks))
                if verify:
                    t1 = time.perf_counter()
                    handles, idxs = self._submit_verify(fv.blocks, datas,
                                                        srcs)
                    if trace is not None:
                        trace.add_span("sai/verify/submit", t1,
                                       time.perf_counter())
                else:
                    handles, idxs = None, []
                verify_q.put((fut, fv, datas, srcs, handles, idxs,
                              locmap, trace))
            except BaseException as e:
                fut._fail(e)
            finally:
                fetch_q.task_done()

    def _verify_loop(self, verify_q):
        hb = self.heartbeats.heartbeat("verify")
        while True:
            hb.park()
            item = verify_q.get()
            if item is None:                         # close() sentinel
                verify_q.task_done()
                return
            hb.beat()
            fut, fv, datas, srcs, handles, idxs, locmap, trace = item
            try:
                if handles is not None:
                    t0 = time.perf_counter()
                    self._finish_verify(fv.blocks, datas, srcs, handles,
                                        idxs, locmap)
                    if trace is not None:
                        trace.add_span("sai/verify", t0,
                                       time.perf_counter())
                        for h in handles:
                            _trace_engine_jobs(trace, h, "sai/verify")
                t0 = time.perf_counter()
                data = b"".join(datas)[:fv.total_len]
                if trace is not None:
                    trace.add_span("sai/assemble", t0, time.perf_counter())
                fut._resolve(data)
            except BaseException as e:
                fut._fail(e)
            finally:
                verify_q.task_done()


def pack_blocks(chunks: List[bytes]):
    """Pack chunks into padded rows for a direct-hash request.

    Canonical block digest = MD5( zero-pad-to-word(data) ||
    u32_le(byte_length) ): the length trailer disambiguates chunks
    that differ only in trailing zero padding (CDC boundaries are
    byte-exact).  Row width is bucketed to a power of two to bound
    jit retraces across writes with ragged max-chunk lengths.  Serves
    callers that hold separate blocks: the SAI's read-verify and
    refetch and the node runtime's scrub/repair verification (a write
    holds one image and its chunk ends, and hashes them as spans,
    ``SAI._submit_spans``)."""
    seg = max(len(c) for c in chunks)
    seg = (seg + 3) // 4 * 4 + 4
    seg = 1 << (seg - 1).bit_length()
    rows = np.zeros((len(chunks), seg), np.uint8)
    lens = np.zeros((len(chunks),), np.int64)
    for i, c in enumerate(chunks):
        padded = (len(c) + 3) // 4 * 4
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
        rows[i, padded:padded + 4] = np.frombuffer(
            np.uint32(len(c)).tobytes(), np.uint8)
        lens[i] = padded + 4
    return rows, lens


def _pad4(data: bytes) -> bytes:
    return data + b"\x00" * ((-len(data)) % 4)


def block_digest_cpu(data: bytes) -> bytes:
    """Canonical block digest (hashlib path):
    MD5( pad4(data) || u32_le(len) ) — identical to the kernel path."""
    return hashlib.md5(
        _pad4(data) + np.uint32(len(data)).tobytes()).digest()


def _cpu_sliding(data: bytes, window: int, stride: int) -> np.ndarray:
    """Single-core CPU sliding-window hashing (the paper's CPU baseline)."""
    n = max((len(data) - window) // stride + 1, 0)
    out = np.empty((n,), np.uint32)
    view = memoryview(data)
    for i in range(n):
        o = i * stride
        out[i] = int.from_bytes(
            hashlib.md5(view[o:o + window]).digest()[:4], "little")
    return out


def _cpu_gear(data: bytes, vectorized: bool = True) -> np.ndarray:
    """Gear hash (FastCDC recurrence) on the CPU.

    ``vectorized`` uses the 32-tap convolution form (SIMD-style numpy —
    the optimized CPU implementation); ``vectorized=False`` runs the
    literal sequential recurrence (tests assert both are identical)."""
    import numpy as _np
    b = _np.frombuffer(data, _np.uint8).astype(_np.uint32) + 1
    # mix32
    x = b.copy()
    x ^= x >> 16
    x = (x * _np.uint32(0x85EBCA6B)) & _np.uint32(0xFFFFFFFF)
    x ^= x >> 13
    x = (x * _np.uint32(0xC2B2AE35)) & _np.uint32(0xFFFFFFFF)
    x ^= x >> 16
    if vectorized:
        h = x.copy()
        for j in range(1, 32):
            h[j:] += x[:-j] << _np.uint32(j)
        return h
    acc = 0
    out = _np.empty(len(b), _np.uint32)
    for i in range(len(b)):
        acc = ((acc << 1) + int(x[i])) & 0xFFFFFFFF
        out[i] = acc
    return out
