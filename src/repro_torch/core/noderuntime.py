"""Storage-node runtime: offloaded scrubbing, refcounted GC, repair.

The paper's Figure 2 shows storage nodes as *active* participants of the
distributed store — they "preserve data integrity" continuously rather
than waiting for a client read to trip over a corrupt or lost block.
This module is that node-side runtime, built on the same coalescing
offload engine (CrystalGPU) the client write/read paths use:

  NodeRuntime      — one per storage node (Figure 2's "storage node"
                     box): a background **integrity scrubber** that
                     periodically streams the node's resident blocks
                     through fused ``direct`` hash submissions on the
                     engine's low-priority scrub lane.  Digest mismatch
                     => the copy is quarantined (taint + registry
                     removal) and repair is triggered.
  ClusterRuntime   — the supervisor (Figure 2's "manager" side of the
                     control plane): owns the scrub threads, a
                     **repair/re-replication pipeline** that restores
                     the replica count of quarantined or
                     under-replicated digests from healthy copies
                     (verifying every repaired copy through the engine
                     before registering it), a **reference-counted GC**
                     fed by the metadata manager's retire events (a
                     block claimed or pinned by a concurrent writer is
                     never collected), and a **Merkle spot-checker**
                     that validates a sampled block against its
                     file-level root via ``integrity.merkle_proof``.

Foreground priority (the paper's "impact on competing applications"
evaluation, Figures 12-17): every scrub/repair hash request is submitted
on the engine's ``lane='scrub'`` low-priority lane — managers only drain
it when no foreground job is queued — and the background loops pace
their batch submissions (``scrub_interval_s``), so client write/read
traffic keeps engine priority while scrub bursts still coalesce into
fused launches (``scrub_launches < scrub_jobs``).  Scrubbing is also
*load-aware*: before each burst the runtime checks the engine's
foreground queue depth and backs off (``scrub_backoff_depth`` /
``scrub_backoff_s``, counted by ``scrub_backoffs``) while client
traffic is backlogged, abandoning the sweep until the next cycle when
the pressure persists.  The
``benchmarks/scrub_interference.py`` run measures exactly this:
foreground write latency with and without a scrubbing runtime.

The supervisor exposes ``start`` / ``pause`` / ``resume`` / ``drain`` /
``stop`` and ``snapshot_stats``; the ``*_once`` methods run one
synchronous cycle each (deterministic — what the tests drive).
"""
from __future__ import annotations

import queue
import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import integrity
from repro_torch.core.castore import (MetadataManager, NodeFailure,
                                      StorageNode)
from repro_torch.obs import HeartbeatBoard, MetricsRegistry
from repro_torch.core.crystal import CrystalGPU
from repro_torch.core import crystal as crystal_mod
from repro_torch.core.sai import pack_blocks


@dataclass
class NodeRuntimeConfig:
    scrub_batch_blocks: int = 16      # blocks per fused scrub burst
    scrub_interval_s: float = 0.02    # pace between scrub bursts (rate
    #                                   limit: keeps foreground priority)
    scrub_cycle_idle_s: float = 0.25  # pause between full node sweeps
    repair_poll_s: float = 0.05       # repair/GC maintenance cadence
    merkle_every_n: int = 4           # merkle spot-check every N
    #                                   maintenance cycles (0 = off)
    merkle_samples: int = 1           # sampled blocks per spot-check
    scrub_backoff_depth: int = 4      # pause scrubbing while the
    #                                   engine's foreground (fg+batch)
    #                                   queue is deeper than this (0=off)
    scrub_backoff_s: float = 0.02     # wait before re-checking the load
    underrep_scan_every_n: int = 16   # under-replication registry scan
    #                                   every N maintenance cycles (0=off)
    gc_full_scan_every_n: int = 64    # full-registry GC sweep every N
    #                                   cycles (retire events cover the
    #                                   common path; 0 = events only)
    seed: int = 0                     # sampling RNG seed


class NodeRuntime:
    """Background integrity scrubber for ONE storage node.

    ``scrub_once`` sweeps the node's resident (non-tainted, non-raw)
    blocks in batches: each block becomes one single-row ``direct``
    request on the engine's scrub lane, submitted back-to-back so the
    engine fuses the burst into one padded batch launch — the node-side
    mirror of the client write path's coalesced hashing.  A recomputed
    digest that differs from the content address quarantines that copy
    and hands the digest to the cluster repair pipeline."""

    def __init__(self, node: StorageNode, cluster: "ClusterRuntime"):
        self.node = node
        self.cluster = cluster

    def scrub_once(self, paced: bool = False, hb=None) -> Dict[str, int]:
        """One full sweep of this node.  Returns {scanned, corrupt}."""
        node = self.node
        digests = [] if node.failed else node.healthy_digests()
        return self.scrub_digests(digests, paced=paced, hb=hb)

    def scrub_digests(self, digests: List[bytes],
                      paced: bool = False, hb=None) -> Dict[str, int]:
        """Engine-verify a specific digest list on this node (the full
        sweep and the recovery suspect-scrub share this path).  Returns
        {scanned, corrupt}."""
        cl, node, cfg = self.cluster, self.node, self.cluster.cfg
        scanned = corrupt = 0
        for k in range(0, len(digests), cfg.scrub_batch_blocks):
            if not cl._gate(hb):
                break
            if not cl._load_gate():
                break                      # foreground busy: yield the
                #                            sweep, resume next cycle
            batch = []
            for d in digests[k:k + cfg.scrub_batch_blocks]:
                if d.startswith(b"raw!"):      # no content hash (ca=none)
                    continue
                try:
                    batch.append((d, node.get(d)))
                except (KeyError, NodeFailure):
                    continue                   # GC'd / failed meanwhile
            if not batch:
                continue
            # one job per block, submitted back-to-back: the engine
            # fuses the burst (plus any concurrent node's burst) into
            # common scrub-lane batch launches
            jobs = []
            for d, data in batch:
                rows, lens = pack_blocks([data])
                jobs.append(cl.engine.submit("direct", rows,
                                             {"lens": lens}, lane="scrub"))
            for (d, data), job in zip(batch, jobs):
                got = job.wait()[0].tobytes()
                scanned += 1
                if got != d:
                    corrupt += 1
                    cl._report_corruption(d, node.node_id)
            if paced and cfg.scrub_interval_s:
                cl._stop.wait(cfg.scrub_interval_s)
        cl._bump(scrubbed_blocks=scanned, corrupt_found=corrupt)
        return {"scanned": scanned, "corrupt": corrupt}


class ClusterRuntime:
    """Supervisor for the node-side background services.

    Owns one :class:`NodeRuntime` per storage node plus the shared
    repair/GC/Merkle maintenance machinery.  All hashing flows through
    the engine's low-priority scrub lane; the supervisor subscribes to
    the metadata manager's quarantine events (repair triggers — from its
    own scrubbers AND from client read-path verify failures) and retire
    events (GC candidates)."""

    def __init__(self, manager: MetadataManager,
                 engine: Optional[CrystalGPU] = None,
                 config: Optional[NodeRuntimeConfig] = None):
        self.manager = manager
        self._engine = engine
        self.cfg = config or NodeRuntimeConfig()
        self.node_runtimes = [NodeRuntime(n, self) for n in manager.nodes]
        self._repair_q: "queue.Queue[bytes]" = queue.Queue()
        self._gc_pending: List[bytes] = []
        self._rng = random.Random(self.cfg.seed)
        self._stop = threading.Event()
        self._resume = threading.Event()
        self._resume.set()
        self._threads: List[threading.Thread] = []
        self._stats_lock = threading.Lock()   # guards _gc_pending
        # per-loop liveness: beats between scrub bursts / maintenance
        # cycles, parks while paused (so pause() reads healthy-idle)
        self.heartbeats = HeartbeatBoard()
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.group(
            ("scrubbed_blocks", "corrupt_found", "repairs_enqueued",
             "repaired_copies", "repair_lost", "gc_collected",
             "merkle_checks", "merkle_failures", "scrub_backoffs"))
        manager.add_quarantine_listener(self._on_quarantine)
        manager.add_retire_listener(self._on_retire)

    # ------------------------------------------------------------------
    # engine access / shared helpers
    # ------------------------------------------------------------------
    @property
    def engine(self) -> CrystalGPU:
        if self._engine is None or not self._engine._alive:
            self._engine = crystal_mod.default_engine()
        return self._engine

    def _bump(self, **deltas: int):
        for k, v in deltas.items():
            self.stats.inc(k, v)

    def _gate(self, hb=None) -> bool:
        """Respect pause/stop between scrub bursts.  True = proceed.
        ``hb`` (a heartbeat) parks while paused so a deliberately
        suspended runtime never reads as a stalled thread."""
        while not self._stop.is_set():
            if self._resume.wait(timeout=0.05):
                if hb is not None:
                    hb.beat()
                return True
            if hb is not None:
                hb.park()
        return False

    def _foreground_depth(self) -> int:
        """Client-facing backlog queued at the engine (fg + batch lanes;
        the scrub lane's own backlog doesn't count against itself)."""
        eng = self.engine
        return eng.queue_depth("fg") + eng.queue_depth("batch")

    def _load_gate(self) -> bool:
        """Load-aware scrub backoff (ROADMAP open item): when the
        engine's foreground queue is deeper than
        ``scrub_backoff_depth``, wait ``scrub_backoff_s`` once and
        re-check; if the backlog persists, tell the caller to abandon
        the current sweep (it resumes on the next scrub cycle).  Every
        deferred burst bumps the ``scrub_backoffs`` counter — the proof
        the mechanism triggered.  True = proceed with the burst."""
        cfg = self.cfg
        if not cfg.scrub_backoff_depth:
            return True
        if self._foreground_depth() <= cfg.scrub_backoff_depth:
            return True
        self._bump(scrub_backoffs=1)
        self._stop.wait(cfg.scrub_backoff_s)
        return self._foreground_depth() <= cfg.scrub_backoff_depth

    def _digest_of(self, data: bytes) -> bytes:
        """Canonical block digest via a scrub-lane engine submission."""
        rows, lens = pack_blocks([data])
        job = self.engine.submit("direct", rows, {"lens": lens},
                                 lane="scrub")
        return job.wait()[0].tobytes()

    # ------------------------------------------------------------------
    # event listeners (metadata manager -> runtime)
    # ------------------------------------------------------------------
    def _on_quarantine(self, digest: bytes, node_id: int, remaining):
        self._repair_q.put(digest)
        self._bump(repairs_enqueued=1)

    def _on_retire(self, path: str, orphans: List[bytes]):
        if orphans:
            with self._stats_lock:
                self._gc_pending.extend(orphans)

    def _report_corruption(self, digest: bytes, node_id: int):
        # quarantine_block taints the node copy, strips the replica from
        # the registry, and fires _on_quarantine -> repair queue
        self.manager.quarantine_block(digest, node_id)

    # ------------------------------------------------------------------
    # synchronous one-cycle services (tests / drain drive these)
    # ------------------------------------------------------------------
    def scrub_once(self) -> Dict[str, int]:
        """Sweep every node once.  Returns merged {scanned, corrupt}."""
        out = {"scanned": 0, "corrupt": 0}
        for nr in self.node_runtimes:
            res = nr.scrub_once()
            out["scanned"] += res["scanned"]
            out["corrupt"] += res["corrupt"]
        return out

    def scrub_suspects(self,
                       suspects: Dict[int, List[bytes]]) -> Dict[str, int]:
        """Engine-verify the blocks a crash recovery flagged as suspect
        (the trailing, possibly-unsynced records of each node's final
        block-store segment — ``RecoveryReport.suspects``).  Recovery is
        a scrub workload: each suspect streams through the engine's
        scrub lane exactly like a sweep burst; mismatches quarantine the
        copy and enqueue repair.  Suspects no longer resident (already
        reclaimed by recovery's unregistered-resident pass) are skipped.
        Returns {scanned, corrupt, skipped}."""
        out = {"scanned": 0, "corrupt": 0, "skipped": 0}
        by_node = {nr.node.node_id: nr for nr in self.node_runtimes}
        for nid, digests in suspects.items():
            nr = by_node.get(nid)
            if nr is None or nr.node.failed:
                out["skipped"] += len(digests)
                continue
            live = [d for d in digests if nr.node.has(d)]
            out["skipped"] += len(digests) - len(live)
            res = nr.scrub_digests(live)
            out["scanned"] += res["scanned"]
            out["corrupt"] += res["corrupt"]
        return out

    def scan_under_replicated(self) -> int:
        """Enqueue digests whose healthy replica count is below the
        configured replication factor (node failures, quarantines that
        predate this runtime)."""
        mgr = self.manager
        n = 0
        for digest, locs in list(mgr.block_registry.items()):
            healthy = [nid for nid in locs if mgr.nodes[nid].has(digest)]
            if len(healthy) < mgr.replication:
                self._repair_q.put(digest)
                n += 1
        self._bump(repairs_enqueued=n)
        return n

    def repair_once(self) -> int:
        """Drain the repair queue, restoring replica counts.  Returns
        the number of replica copies created."""
        seen = set()
        placed = 0
        while True:
            try:
                digest = self._repair_q.get_nowait()
            except queue.Empty:
                break
            if digest in seen:
                continue
            seen.add(digest)
            placed += self._repair_block(digest)
        return placed

    def _repair_block(self, digest: bytes) -> int:
        """Re-replicate one digest from a healthy verified copy.  Every
        candidate source is re-hashed through the engine before it is
        trusted; sources that fail the check are quarantined in turn.
        Returns replica copies created."""
        mgr = self.manager
        locs = mgr.lookup_block(digest)
        live = [nid for nid in locs if mgr.nodes[nid].has(digest)]
        if len(live) >= mgr.replication:
            return 0                              # healed meanwhile
        src_data = None
        for nid in live:
            try:
                data = mgr.nodes[nid].get(digest)
            except (KeyError, NodeFailure):
                continue
            if digest.startswith(b"raw!") or \
                    self._digest_of(data) == digest:
                src_data = data
                break
            self._report_corruption(digest, nid)  # bad source copy
        if src_data is None:
            if mgr.lookup_block(digest) or digest in mgr.quarantined:
                self._bump(repair_lost=1)         # no healthy copy left
            return 0
        live = [nid for nid in mgr.lookup_block(digest)
                if mgr.nodes[nid].has(digest)]
        need = mgr.replication - len(live)
        placed = 0
        for node in mgr.nodes:
            if placed >= need:
                break
            if node.failed or node.has(digest):
                continue
            try:
                node.put(digest, src_data)
            except NodeFailure:
                continue
            mgr.register_block(digest, (node.node_id,))
            mgr.clear_quarantine(digest, node.node_id)
            placed += 1
        self._bump(repaired_copies=placed)
        return placed

    def gc_once(self, full: bool = True) -> int:
        """Collect retire-event orphans; ``full=True`` additionally
        sweeps the whole registry for refcount-zero digests (an
        O(registry) pass under the manager lock — the background loop
        runs it only every ``gc_full_scan_every_n`` cycles).
        Claimed/pinned digests are skipped by
        ``MetadataManager.gc_collect``; they are retried on the next
        cycle once the in-flight write commits or aborts."""
        with self._stats_lock:
            pending, self._gc_pending = self._gc_pending, []
        removed = self.manager.gc_collect(pending) if pending else 0
        if full:
            removed += self.manager.gc_collect()
        # candidates that survived only because of a transient pin/claim
        # stay pending for the next cycle; re-referenced digests drop out
        with self._stats_lock:
            reg = self.manager.block_registry
            refs = self.manager.block_refs
            self._gc_pending.extend(d for d in pending
                                    if d in reg and refs.get(d, 0) <= 0)
        self._bump(gc_collected=removed)
        return removed

    def merkle_check_once(self, samples: Optional[int] = None) -> int:
        """Spot-check sampled blocks against their file-level Merkle
        root: fetch one block of a random committed version, recompute
        its digest on the engine, and verify the membership proof from
        the version's leaf digests (``integrity.merkle_proof``).  A
        failed proof quarantines the fetched copy (=> repair).  Returns
        the number of failures found."""
        mgr = self.manager
        failures = 0
        for _ in range(samples or self.cfg.merkle_samples):
            files = mgr.list_files()
            if not files:
                break
            path = self._rng.choice(files)
            fv, locmap = mgr.get_read_plan(path)
            if fv is None or not fv.blocks:
                continue
            idx = self._rng.randrange(len(fv.blocks))
            b = fv.blocks[idx]
            if b.digest.startswith(b"raw!"):
                continue
            data = src = None
            for nid in locmap.get(b.digest) or b.nodes:
                try:
                    data, src = mgr.nodes[nid].get(b.digest), nid
                    break
                except (KeyError, NodeFailure):
                    continue
            if data is None:                     # no copy reachable
                self._repair_q.put(b.digest)
                self._bump(repairs_enqueued=1)
                continue
            leaves = [blk.digest for blk in fv.blocks]
            proof = integrity.merkle_proof(leaves, idx)
            ok = integrity.merkle_verify(self._digest_of(data), idx,
                                         proof, fv.merkle_root)
            self._bump(merkle_checks=1)
            if not ok:
                failures += 1
                self._bump(merkle_failures=1)
                self._report_corruption(b.digest, src)
        return failures

    # ------------------------------------------------------------------
    # supervisor lifecycle
    # ------------------------------------------------------------------
    def start(self):
        """Start the background threads: one scrub loop per node plus
        one maintenance loop (repair -> GC -> periodic Merkle)."""
        if self._threads:
            return
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._scrub_loop, args=(nr,),
                             daemon=True,
                             name=f"noderuntime-scrub-{nr.node.node_id}")
            for nr in self.node_runtimes]
        self._threads.append(
            threading.Thread(target=self._maintenance_loop, daemon=True,
                             name="noderuntime-maint"))
        for t in self._threads:
            t.start()

    def pause(self):
        """Suspend scrub/repair submission (in-flight bursts finish)."""
        self._resume.clear()

    def resume(self):
        self._resume.set()

    def drain(self):
        """Synchronously finish all pending repair + GC work."""
        self.repair_once()
        self.gc_once()

    def stop(self):
        """Stop and join the background threads (pending repairs are
        drained first so quarantined blocks aren't left under-replicated
        across a shutdown).  A thread that outlives the join timeout
        stays tracked with ``_stop`` still set, so it cannot resume and
        a later ``start()`` refuses until it exits."""
        self._stop.set()
        self._resume.set()
        for t in self._threads:
            t.join(timeout=60)
        self._threads = [t for t in self._threads if t.is_alive()]
        if not self._threads:
            self._stop.clear()
        self.drain()

    def snapshot_stats(self) -> Dict[str, int]:
        """Runtime counters merged with the engine's scrub-lane
        coalescing counters (scrub_jobs / scrub_launches /
        scrub_coalesced)."""
        out = dict(self.stats)
        out.update({"scrub_jobs": 0, "scrub_launches": 0,
                    "scrub_coalesced": 0})
        if self._engine is not None and self._engine._alive:
            es = self._engine.snapshot_stats()
            for k in ("scrub_jobs", "scrub_launches", "scrub_coalesced"):
                out[k] = es[k]
        out["heartbeats"] = self.heartbeats.snapshot()
        return out

    # ------------------------------------------------------------------
    # background loops
    # ------------------------------------------------------------------
    def _scrub_loop(self, nr: NodeRuntime):
        hb = self.heartbeats.heartbeat(f"scrub{nr.node.node_id}")
        try:
            while not self._stop.is_set():
                if not self._gate(hb):
                    return
                try:
                    nr.scrub_once(paced=True, hb=hb)
                except Exception:
                    pass                  # keep the scrubber thread up
                hb.beat()
                self._stop.wait(self.cfg.scrub_cycle_idle_s)
        finally:
            hb.park()                     # clean exit is dormancy

    def _maintenance_loop(self):
        hb = self.heartbeats.heartbeat("maint")
        cfg, cycle = self.cfg, 0
        try:
            self._maintenance_cycles(hb, cfg, cycle)
        finally:
            hb.park()

    def _maintenance_cycles(self, hb, cfg, cycle):
        while not self._stop.is_set():
            if not self._gate(hb):
                return
            try:
                cycle += 1
                self.repair_once()
                self.gc_once(full=(cfg.gc_full_scan_every_n > 0 and
                                   cycle % cfg.gc_full_scan_every_n == 0))
                if cfg.underrep_scan_every_n and \
                        cycle % cfg.underrep_scan_every_n == 0:
                    self.scan_under_replicated()
                if cfg.merkle_every_n and \
                        cycle % cfg.merkle_every_n == 0:
                    self.merkle_check_once()
            except Exception:
                pass                      # keep the maintenance loop up
            hb.beat()
            self._stop.wait(cfg.repair_poll_s)
