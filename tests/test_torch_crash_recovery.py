"""Crash/restart matrix for the port's durable metadata WAL + block
stores, with the port's node runtime scrubbing on a ``CrystalGPU`` over
``torch.device("cpu")``.  The cases and their assertions mirror the JAX
package's ``tests/test_crash_recovery.py``.

Each scenario arms a deterministic fault (repro_torch.core.faultinject),
runs a workload until the injected "process death", reopens the same data
directory with a fresh object graph, and asserts the crash-consistency
invariants:

  * every version committed before the crash reads back verified;
  * ``resync_refcounts`` is a no-op (replay agrees with commit logic);
  * no committed block was GC'd, and retrying writers dedup against
    adopted claims instead of double-storing.
"""
import hashlib
import os
import time

import pytest
import torch

from repro_torch.core import (SAI, ClusterRuntime, CrashPoint, CrystalGPU,
                              FaultInjector, SAIConfig, StoreIOError,
                              make_store)
from repro_torch.core.castore import (REC_CLAIM_DONE, REC_COMMIT,
                                      open_durable_store)

CPU = torch.device("cpu")


def _open(td, fault=None, **kw):
    kw.setdefault("n_nodes", 3)
    kw.setdefault("replication", 2)
    kw.setdefault("flush_interval_s", 0)    # inline fsync: deterministic
    return open_durable_store(str(td), fault=fault, **kw)


def _cfg(**kw):
    kw.setdefault("ca", "fixed")
    kw.setdefault("hasher", "cpu")
    kw.setdefault("block_size", 1024)
    return SAIConfig(**kw)


def _kill(mgr):
    """Simulated SIGKILL for whatever the armed fault didn't take down:
    the durable state on disk stops changing from here."""
    mgr.wal.crash()
    for node in mgr.nodes:
        node.store.crash()


def _assert_consistent(mgr, sai, expect):
    """expect: {path: bytes} — committed data that must survive."""
    assert sorted(mgr.files) == sorted(expect)
    for path, data in expect.items():
        assert sai.read(path, verify=True) == data
    assert mgr.resync_refcounts() == 0


# ---------------------------------------------------------------------------
# baseline durability (no fault)
# ---------------------------------------------------------------------------

def test_durable_write_survives_reopen(tmp_path):
    mgr, nodes, rep0 = _open(tmp_path)
    sai = SAI(mgr, _cfg())
    payload = {f"/f{i}": os.urandom(3000 + 100 * i) for i in range(3)}
    for p, d in payload.items():
        sai.write(p, d)
    assert rep0.replayed == 0
    mgr.close()

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.refcount_drift == 0
    _assert_consistent(mgr2, sai2, payload)
    # reopen again through the compaction snapshot close() took: the
    # tail must be near-empty
    mgr2.close()
    mgr3, _, rep3 = _open(tmp_path)
    assert rep3.snapshot_seq > 0 and rep3.replayed == 0
    _assert_consistent(mgr3, SAI(mgr3, _cfg()), payload)
    mgr3.close()


def test_durable_rewrite_dedups_no_double_store(tmp_path):
    mgr, nodes, _ = _open(tmp_path)
    sai = SAI(mgr, _cfg())
    data = os.urandom(4096)
    sai.write("/a", data)
    puts_before = [n.store.stats["puts"] for n in nodes]
    st = sai.write("/b", data)              # same content, new path
    assert st.new_blocks == 0 and st.dup_blocks > 0
    assert [n.store.stats["puts"] for n in nodes] == puts_before
    _assert_consistent(mgr, sai, {"/a": data, "/b": data})
    mgr.close()


# ---------------------------------------------------------------------------
# the crash matrix
# ---------------------------------------------------------------------------

def test_crash_mid_claim_releases_unstored_claims(tmp_path):
    """Die during the store stage: the CLAIM record is durable, the
    block bytes and CLAIM_DONE are not.  Recovery must release the
    half-open claims so a retrying writer isn't blocked."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    keep = os.urandom(2500)
    sai.write("/keep", keep)
    # co-crash: the first block put dies, and the WAL dies with the
    # process before the abort CLAIM_DONE cleanup can reach disk
    fault.arm("blockstore.put", action="crash")
    fault.arm("wal.append", when={"kind": REC_CLAIM_DONE}, action="crash")
    with pytest.raises(CrashPoint):
        sai.write("/lost", os.urandom(3000))
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.released_claims and not rep.adopted_claims
    assert rep.dropped_pins > 0             # crashed writer's pins
    assert rep.refcount_drift == 0
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    retry = os.urandom(3000)
    sai2.write("/lost", retry)              # claims were released
    _assert_consistent(mgr2, sai2, {"/keep": keep, "/lost": retry})
    mgr2.close()


def test_crash_mid_claim_adopts_resident_block(tmp_path):
    """Die between storing a claimed block and logging CLAIM_DONE: the
    bytes are on disk but unregistered.  Recovery adopts the claim —
    registers the surviving locations — so a retrying writer dedups
    instead of double-storing."""
    mgr, nodes, _ = _open(tmp_path)
    data = os.urandom(2048)
    digest = hashlib.md5(data).digest()
    locmap, claimed, _ = mgr.claim_blocks([digest])
    assert digest in claimed
    for nid in (0, 1):
        nodes[nid].put(digest, data)
        nodes[nid].flush()                  # data durable...
    _kill(mgr)                              # ...but CLAIM_DONE is not

    mgr2, nodes2, rep = _open(tmp_path)
    assert rep.adopted_claims == [digest] and not rep.released_claims
    assert mgr2.lookup_block(digest) == (0, 1)
    assert rep.refcount_drift == 0
    # a retrying writer claiming the digest dedup-hits the adoption
    puts = [n.store.stats["puts"] for n in nodes2]
    locmap2, claimed2, _ = mgr2.claim_blocks([digest])
    assert locmap2 == {digest: (0, 1)} and not claimed2
    assert [n.store.stats["puts"] for n in nodes2] == puts
    mgr2.close()


def test_crash_mid_commit(tmp_path):
    """Die on the COMMIT append: blocks may be durable but the version
    must not exist after recovery — and must not poison refcounts."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    keep = os.urandom(5000)
    sai.write("/keep", keep)
    fault.kill_after("wal.append", 1, when={"kind": REC_COMMIT})
    with pytest.raises(CrashPoint):
        sai.write("/lost", os.urandom(4000))
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.refcount_drift == 0 and rep.dropped_pins > 0
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    # the committed file survives a full GC sweep: its blocks are
    # referenced; the crashed write's registered orphans are reclaimed
    mgr2.gc_unreferenced()
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    mgr2.close()


def test_crash_mid_gc(tmp_path):
    """Die between logging REC_GC and finishing the node-side drops:
    replay re-erases the registry entries and the recovery sweep
    reclaims whatever copies the crash left behind."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    keep = os.urandom(3000)
    dead = os.urandom(3000)
    sai.write("/keep", keep)
    sai.write("/dead", dead)
    orphans = mgr.delete_file("/dead")
    assert orphans
    fault.arm("blockstore.drop", action="crash")
    with pytest.raises(CrashPoint):
        mgr.gc_collect(orphans)
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.refcount_drift == 0
    for d in orphans:                       # gone from metadata AND disk
        assert mgr2.lookup_block(d) == ()
        assert not any(n.store.has(d) for n in nodes2)
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    mgr2.close()


def test_crash_mid_snapshot_falls_back_to_tail(tmp_path):
    """Die inside snapshot compaction: recovery must fall back to the
    previous snapshot (here: none) and a longer record tail."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault, snapshot_every=12)
    sai = SAI(mgr, _cfg())
    fault.arm("wal.snapshot", action="crash")
    committed = {}
    with pytest.raises(CrashPoint):
        for i in range(10):
            p, d = f"/f{i}", os.urandom(1500)
            sai.write(p, d)
            committed[p] = d                # durable_sync: commit is
            #                                 on disk once write returns
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.snapshot_seq == 0 and rep.replayed > 10
    assert rep.refcount_drift == 0
    # every write that returned before the crash is present; the write
    # the crash interrupted may have committed (the COMMIT record lands
    # before the snapshot attempt) — if so it must still verify
    assert set(committed) <= set(mgr2.files)
    for p, d in committed.items():
        assert sai2.read(p, verify=True) == d
    extra = set(mgr2.files) - set(committed)
    assert len(extra) <= 1
    for p in extra:
        sai2.read(p, verify=True)
    assert mgr2.resync_refcounts() == 0
    mgr2.close()


def test_crash_torn_commit_record(tmp_path):
    """A torn final COMMIT frame: recovery truncates the garbage and the
    half-written version never existed."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    keep = os.urandom(2200)
    sai.write("/keep", keep)
    fault.arm("wal.append", when={"kind": REC_COMMIT}, action="torn")
    with pytest.raises(CrashPoint):
        sai.write("/lost", os.urandom(2200))
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.torn_tail and rep.refcount_drift == 0
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    after = os.urandom(1000)
    sai2.write("/after", after)             # log resumes cleanly
    _assert_consistent(mgr2, sai2, {"/keep": keep, "/after": after})
    mgr2.close()


def test_crash_mid_repair(tmp_path):
    """Die while repair is re-replicating a quarantined block: after
    restart the quarantine is still known (REC_QUAR durable), the torn
    target segment is truncated, and a fresh runtime completes the
    repair."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    data = os.urandom(900)                  # single block
    sai.write("/f", data)
    digest = mgr.files["/f"][-1].blocks[0].digest
    locs = mgr.lookup_block(digest)
    bad = locs[0]
    garbage = bytes([data[0] ^ 0xFF]) + data[1:]
    nodes[bad].store.put(digest, garbage, replace=True)
    nodes[bad].blocks[digest] = garbage
    mgr.quarantine_block(digest, bad)       # REC_QUAR durable

    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.02)
    try:
        runtime = ClusterRuntime(mgr, engine=eng)
        assert runtime.scan_under_replicated() == 1
        fault.arm("blockstore.put", action="crash")
        with pytest.raises(CrashPoint):
            runtime.repair_once()
    finally:
        eng.shutdown()
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.refcount_drift == 0
    assert digest in mgr2.quarantined       # quarantine survived
    assert nodes2[bad].tainted == {digest}  # corrupt copy re-tainted
    eng2 = CrystalGPU(devices=[CPU], coalesce_window_s=0.02)
    try:
        runtime2 = ClusterRuntime(mgr2, engine=eng2)
        assert runtime2.scan_under_replicated() >= 1
        assert runtime2.repair_once() >= 1
    finally:
        eng2.shutdown()
    healthy = [nid for nid in mgr2.lookup_block(digest)
               if mgr2.nodes[nid].has(digest)]
    assert len(healthy) >= mgr2.replication
    _assert_consistent(mgr2, sai2, {"/f": data})
    mgr2.close()


def test_crash_after_fsync_lied(tmp_path):
    """A lying fsync drops the tail records with the process, but the
    surviving prefix is still consistent: lost commits vanish whole,
    and their now-unreferenced block bytes are swept."""
    fault = FaultInjector()
    mgr, nodes, _ = _open(tmp_path, fault=fault)
    sai = SAI(mgr, _cfg())
    keep = os.urandom(2000)
    sai.write("/keep", keep)
    fault.arm("wal.fsync", action="skip", times=10_000)
    lost = os.urandom(2000)
    sai.write("/lost", lost)                # "durable" per the disk
    assert sai.read("/lost") == lost        # visible pre-crash
    _kill(mgr)

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert rep.refcount_drift == 0
    assert rep.dropped_unregistered >= 1    # /lost's block bytes swept
    _assert_consistent(mgr2, sai2, {"/keep": keep})
    mgr2.close()


def test_recovery_scrub_suspects_catches_trailing_corruption(tmp_path):
    """End-to-end recovery scrub: corrupt a block in the final segment
    on disk, reopen, hand report.suspects to the engine scrubber — it
    must quarantine exactly the corrupt copy."""
    mgr, nodes, _ = _open(tmp_path)
    sai = SAI(mgr, _cfg())
    data = os.urandom(800)
    sai.write("/f", data)
    digest = mgr.files["/f"][-1].blocks[0].digest
    bad = mgr.lookup_block(digest)[0]
    nodes[bad].store.put(digest, b"\x00" * len(data), replace=True)
    nodes[bad].store.flush()
    mgr.wal.crash()                         # skip close-time compaction
    mgr.close()

    mgr2, nodes2, rep = _open(tmp_path)
    sai2 = SAI(mgr2, _cfg())
    assert digest in rep.suspects[bad]
    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.02)
    try:
        runtime = ClusterRuntime(mgr2, engine=eng)
        res = runtime.scrub_suspects(rep.suspects)
        assert res["corrupt"] == 1
        assert runtime.repair_once() >= 1   # and repair heals it
    finally:
        eng.shutdown()
    _assert_consistent(mgr2, sai2, {"/f": data})
    mgr2.close()


# ---------------------------------------------------------------------------
# durability error surfacing + recovery performance
# ---------------------------------------------------------------------------

def test_write_async_surfaces_store_ioerror(tmp_path):
    """Satellite: a failed block put during the async pipeline's store
    stage lands on the WriteFuture as StoreIOError naming the path and
    digest."""
    mgr, nodes = make_store(3, replication=2)
    sai = SAI(mgr, _cfg())
    boom = PermissionError("disk says no")

    def bad_put(digest, data):
        raise boom
    for n in nodes:
        n.put = bad_put
    fut = sai.write_async("/doomed", os.urandom(2048))
    with pytest.raises(StoreIOError) as ei:
        fut.result(timeout=30)
    err = ei.value
    assert err.path == "/doomed" and len(err.digest) == 16
    assert err.__cause__ is boom
    assert "/doomed" in str(err) and err.digest.hex() in str(err)
    sai.close()


def test_recovery_replays_1k_tail_under_1s(tmp_path):
    """Acceptance: cold recovery of a 1k-record tail in under a second."""
    mgr, nodes, _ = _open(tmp_path, flush_interval_s=0.002,
                          snapshot_every=10 ** 9)
    sai = SAI(mgr, _cfg(durable_sync=False))
    for i in range(180):                    # 6 records per write
        sai.write(f"/f{i}", os.urandom(1100))
    mgr.wait_durable()
    assert mgr.wal.last_seq >= 1000
    mgr.wal.crash()                         # no close-time compaction
    mgr.close()

    t0 = time.perf_counter()
    mgr2, _, rep = _open(tmp_path)
    wall = time.perf_counter() - t0
    assert rep.replayed >= 1000 and rep.refcount_drift == 0
    assert wall < 1.0, f"cold recovery took {wall:.3f}s"
    assert sorted(mgr2.files) == sorted(f"/f{i}" for i in range(180))
    mgr2.close()
