"""The port's storage-node runtime (``repro_torch.core.noderuntime``):
offloaded scrubbing, refcounted GC, repair/re-replication, on a
``CrystalGPU`` over ``torch.device("cpu")`` (the kernels' plain versions).
The cases and their assertions mirror the JAX package's
``tests/test_noderuntime.py``.

Covers the acceptance criteria: a corrupted-block injection is detected
by the scrubber via fused scrub-lane engine submissions, quarantined,
repaired back to full replica count from a healthy copy (verified
through the engine), and a subsequent read returns correct data; the
engine's scrub counters show coalescing (scrub_launches < scrub_jobs);
a block claimed/pinned by a concurrent writer is never garbage
collected; retire events drive refcounted GC; the Merkle spot-checker
flags corruption against the file-level root; and the background
supervisor lifecycle (start/pause/resume/stop) heals injected
corruption without synchronous driving.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (ClusterRuntime, CrystalGPU,
                              NodeRuntimeConfig, SAI, SAIConfig, integrity,
                              make_store)
from repro_torch.core.crystal import LaneQueue

CPU = torch.device("cpu")


def _cfg(hasher="cpu", **kw):
    return SAIConfig(ca="fixed", hasher=hasher, block_size=4096,
                     avg_chunk=4096, min_chunk=1024, max_chunk=16384, **kw)


def _corrupt(node, digest):
    blk = node.blocks[digest]
    node.blocks[digest] = bytes([blk[0] ^ 0xFF]) + blk[1:]


def test_scrub_detects_quarantines_and_repairs(rng):
    """The acceptance scenario: inject corruption into one replica,
    scrub detects it through fused scrub-lane submissions, repair
    restores the replica count from the healthy copy, and a subsequent
    read returns correct data without error."""
    mgr, nodes = make_store(4, replication=2)
    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.05)
    sai = SAI(mgr, _cfg(hasher="gpu"), crystal=eng)
    try:
        data = rng.integers(0, 256, 12 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        digest = next(iter(mgr.block_registry))
        bad_nid = mgr.block_registry[digest][0]
        _corrupt(nodes[bad_nid], digest)

        rt = ClusterRuntime(mgr, engine=eng)
        res = rt.scrub_once()
        assert res["corrupt"] == 1
        assert mgr.is_quarantined(digest, bad_nid)
        assert bad_nid not in mgr.lookup_block(digest)

        placed = rt.repair_once()
        assert placed >= 1
        healthy = [n for n in mgr.lookup_block(digest)
                   if mgr.nodes[n].has(digest)]
        assert len(healthy) >= 2          # replica count restored
        assert sai.read("/f") == data     # verified read, no error

        s = rt.snapshot_stats()
        assert s["corrupt_found"] == 1
        assert s["repaired_copies"] >= 1
        # fused background burst signature
        assert 0 < s["scrub_launches"] < s["scrub_jobs"]
    finally:
        sai.close()
        eng.shutdown()


def test_gc_never_collects_claimed_or_pinned_blocks(rng):
    """Regression for GC vs the claim protocol: a block pinned by an
    in-flight writer (the dedup claim -> store -> commit span) must
    never be collected even at refcount zero."""
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg())
    data = rng.integers(0, 256, 8 * 4096, dtype=np.uint8).tobytes()
    sai.write("/a", data)
    fv = mgr.get_blockmap("/a")
    digests = [b.digest for b in fv.blocks]

    # writer B is mid-flight: it pinned its digests (as _store_chunks
    # does) but has not committed yet; /a retires meanwhile
    mgr.pin_blocks(digests)
    mgr.delete_file("/a")
    assert mgr.gc_collect() == 0                  # pinned: survives
    assert all(mgr.lookup_block(d) for d in digests)

    # a digest actively claimed by a concurrent writer is skipped too
    claimed_digest = b"\x01" * 16
    _, claimed, _ = mgr.claim_blocks([claimed_digest])
    assert claimed_digest in claimed
    mgr.register_block(claimed_digest, (0,))
    mgr.nodes[0].put(claimed_digest, b"payload")
    assert mgr.gc_collect([claimed_digest]) == 0  # claimed: survives
    mgr.finish_claim(claimed_digest, (0,))

    # B commits: blocks are refcounted again and GC still spares them
    mgr.commit_blockmap("/b", fv.blocks, fv.total_len)
    mgr.unpin_blocks(digests)
    mgr.gc_collect()
    assert sai.read("/b") == data

    # only after /b retires do the blocks become collectible
    mgr.delete_file("/b")
    assert mgr.gc_collect() > 0
    assert not mgr.lookup_block(digests[0])


def test_concurrent_dedup_writes_survive_gc_loop(rng):
    """Chaos variant: a GC loop spins while writers dedup against
    retiring content; every committed file must remain readable."""
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg())
    data = rng.integers(0, 256, 6 * 4096, dtype=np.uint8).tobytes()
    sai.write("/seed", data)
    stop = threading.Event()

    def gc_loop():
        while not stop.is_set():
            mgr.gc_collect()

    t = threading.Thread(target=gc_loop)
    t.start()
    try:
        prev = "/seed"
        for i in range(8):
            sai.write(f"/gen{i}", data)   # dedup-claims retiring blocks
            mgr.delete_file(prev)
            prev = f"/gen{i}"
    finally:
        stop.set()
        t.join()
    assert sai.read(prev) == data


def test_retire_events_drive_runtime_gc(rng):
    """Version retirement reports orphans to the runtime, whose GC
    reclaims exactly the no-longer-referenced blocks."""
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg())
    rt = ClusterRuntime(mgr)              # subscribes to retire events
    v0 = rng.integers(0, 256, 12 * 4096, dtype=np.uint8).tobytes()
    v1 = v0[: 6 * 4096]                   # shares the first 6 blocks
    sai.write("/f", v0)
    sai.write("/f", v1)
    blocks_before = mgr.stats()["unique_blocks"]

    # keep_latest beyond the version count must retire nothing
    assert mgr.retire_versions("/f", keep_latest=5) == []
    assert sai.read("/f", version=0) == v0

    orphans = mgr.retire_versions("/f", keep_latest=1)
    assert len(orphans) == 6              # v0-only blocks
    removed = rt.gc_once()
    assert removed == 6
    assert mgr.stats()["unique_blocks"] == blocks_before - 6
    assert sai.read("/f") == v1           # latest version intact
    assert rt.snapshot_stats()["gc_collected"] == 6


def test_merkle_root_and_spot_check(rng):
    """commit_blockmap stores the file-level Merkle root; the runtime's
    spot-checker verifies sampled blocks against it via merkle_proof and
    flags corruption."""
    mgr, nodes = make_store(4, replication=1)
    eng = CrystalGPU(devices=[CPU])
    sai = SAI(mgr, _cfg(hasher="gpu"), crystal=eng)
    try:
        data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        fv = mgr.get_blockmap("/f")
        assert fv.merkle_root == integrity.merkle_root(
            [b.digest for b in fv.blocks])

        rt = ClusterRuntime(mgr, engine=eng)
        assert rt.merkle_check_once(samples=4) == 0
        assert rt.snapshot_stats()["merkle_checks"] == 4

        for b in fv.blocks:               # corrupt every copy
            for nid in mgr.lookup_block(b.digest):
                _corrupt(nodes[nid], b.digest)
        assert rt.merkle_check_once(samples=4) > 0
        assert rt.snapshot_stats()["merkle_failures"] > 0
        assert mgr.stats()["quarantined"] > 0
    finally:
        sai.close()
        eng.shutdown()


def test_under_replication_scan_and_repair(rng):
    """A silently lost replica (no failure event) is found by the
    under-replication scan and re-replicated from the surviving copy."""
    mgr, nodes = make_store(4, replication=2)
    eng = CrystalGPU(devices=[CPU])
    sai = SAI(mgr, _cfg(hasher="gpu"), crystal=eng)
    try:
        data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        digest = next(iter(mgr.block_registry))
        lost_nid = mgr.block_registry[digest][0]
        del nodes[lost_nid].blocks[digest]          # silent loss

        rt = ClusterRuntime(mgr, engine=eng)
        assert rt.scan_under_replicated() >= 1
        assert rt.repair_once() >= 1
        healthy = [n for n in mgr.lookup_block(digest)
                   if mgr.nodes[n].has(digest)]
        assert len(healthy) >= 2
        assert sai.read("/f") == data
    finally:
        sai.close()
        eng.shutdown()


def test_background_supervisor_heals_corruption(rng):
    """Lifecycle: start() alone detects and repairs injected corruption;
    pause/resume/stop work."""
    mgr, nodes = make_store(4, replication=2)
    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.02)
    sai = SAI(mgr, _cfg(hasher="gpu"), crystal=eng)
    rt = ClusterRuntime(
        mgr, engine=eng,
        config=NodeRuntimeConfig(scrub_interval_s=0.0,
                                 scrub_cycle_idle_s=0.01,
                                 repair_poll_s=0.01))
    try:
        data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        digest = next(iter(mgr.block_registry))
        bad_nid = mgr.block_registry[digest][0]
        _corrupt(nodes[bad_nid], digest)

        rt.start()
        deadline = time.time() + 120
        while time.time() < deadline:
            healthy = [n for n in mgr.lookup_block(digest)
                       if mgr.nodes[n].has(digest)]
            if rt.snapshot_stats()["corrupt_found"] >= 1 \
                    and len(healthy) >= 2:
                break
            time.sleep(0.05)
        rt.pause()
        rt.resume()
        healthy = [n for n in mgr.lookup_block(digest)
                   if mgr.nodes[n].has(digest)]
        assert rt.snapshot_stats()["corrupt_found"] >= 1
        assert len(healthy) >= 2
        assert sai.read("/f") == data
    finally:
        rt.stop()
        sai.close()
        eng.shutdown()


def test_lane_queue_priority_order():
    """Foreground jobs dequeue before batch jobs, batch before scrub;
    shutdown sentinels dequeue only once every lane is drained."""
    q = LaneQueue()
    q.put("s1", lane="scrub")
    q.put(None)                            # shutdown sentinel
    q.put("b1", lane="batch")
    q.put("f1")
    q.put("s2", lane="scrub")
    q.put("f2", lane="fg")
    assert [q.get_nowait() for _ in range(6)] == \
        ["f1", "f2", "b1", "s1", "s2", None]
    with pytest.raises(Exception):
        q.get_nowait()
    assert q.depth() == 0
    q.put("x", lane="batch")
    assert q.depth("batch") == 1 and q.depth("fg") == 0


def test_scrub_backs_off_under_foreground_load(rng):
    """Load-aware backoff: with the engine's foreground queue
    backlogged past scrub_backoff_depth, the scrubber defers its burst
    (scrub_backoffs counts the trigger) and scans nothing; with the
    backlog gone it scans normally."""
    mgr, _ = make_store(2)
    sai = SAI(mgr, _cfg(hasher="cpu"))
    data = rng.integers(0, 256, 8 * 4096, dtype=np.uint8).tobytes()
    sai.write("/f", data)
    # managerless engine: queued foreground jobs never drain, so the
    # backlog is a deterministic load signal (nothing waits on them)
    idle = CrystalGPU(devices=[])
    from repro_torch.core.sai import pack_blocks
    for _ in range(6):
        rows, lens = pack_blocks([b"load"])
        idle.submit("direct", rows, {"lens": lens})
    rt = ClusterRuntime(mgr, engine=idle, config=NodeRuntimeConfig(
        scrub_backoff_depth=2, scrub_backoff_s=0.01))
    res = rt.scrub_once()
    s = rt.snapshot_stats()
    assert res["scanned"] == 0                 # sweep yielded
    assert s["scrub_backoffs"] >= 1            # and the counter proves it
    idle.shutdown()

    eng = CrystalGPU(devices=[CPU])            # drained engine: no backoff
    rt2 = ClusterRuntime(mgr, engine=eng, config=NodeRuntimeConfig(
        scrub_backoff_depth=2, scrub_backoff_s=0.01))
    try:
        res2 = rt2.scrub_once()
        assert res2["scanned"] == 8
        assert rt2.snapshot_stats()["scrub_backoffs"] == 0
    finally:
        eng.shutdown()


def test_scrub_lane_yields_to_foreground(rng):
    """End-to-end lane behavior: with a busy scrub backlog queued, a
    foreground write still completes promptly and correctly."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    sai = SAI(mgr, _cfg(hasher="gpu"), crystal=eng)
    try:
        datas = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                 for _ in range(32)]
        from repro_torch.core.sai import pack_blocks
        jobs = []
        for d in datas:                    # pile up background traffic
            rows, lens = pack_blocks([d])
            jobs.append(eng.submit("direct", rows, {"lens": lens},
                                   lane="scrub"))
        data = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
        sai.write("/fg", data)             # foreground jumps the queue
        assert sai.read("/fg") == data
        for j in jobs:
            j.wait()                       # backlog still completes
        s = eng.snapshot_stats()
        assert s["scrub_jobs"] == 32
        assert s["scrub_launches"] < s["scrub_jobs"]
    finally:
        sai.close()
        eng.shutdown()
