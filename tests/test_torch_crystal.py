"""The port's offload engine (``repro_torch.core.crystal.CrystalGPU``) on
host devices: queueing, callbacks, ablations, fusion, whale sharding
across a duplicated-device mesh, lane priority, and the JAX package's
own SAI driving it.  Digests are held against ``hashlib`` and the JAX
package's ``repro.kernels.ops``; every comparison is exact."""
import hashlib
import threading

import numpy as np
import pytest
import torch

from repro.core import SAI as RefSAI
from repro.core import SAIConfig as RefSAIConfig
from repro.core import make_store as ref_make_store
from repro.kernels import ops as jops
from repro_torch.core import crystal as crystal_mod
from repro_torch.core.crystal import CrystalGPU, LaneQueue
from repro_torch.core.sai import _cpu_sliding, block_digest_cpu, pack_blocks

CPU = torch.device("cpu")


def _engine(n=1, **kw):
    return CrystalGPU(devices=[CPU] * n, **kw)


def _md5_rows(rows):
    return np.stack([np.frombuffer(hashlib.md5(r.tobytes()).digest(),
                                   np.uint8) for r in rows])


@pytest.fixture(scope="module")
def crystal():
    c = _engine()
    yield c
    c.shutdown()


def test_no_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\[torch.device"):
        CrystalGPU()
    monkeypatch.setattr(crystal_mod, "_DEFAULT", None)
    with pytest.raises(RuntimeError):
        crystal_mod.default_engine()


def test_stream_of_jobs(crystal, rng):
    bufs = [rng.integers(0, 256, 8192, dtype=np.uint8) for _ in range(6)]
    jobs = crystal.map_stream("direct", bufs, {"seg_bytes": 4096})
    for j, b in zip(jobs, bufs):
        got = j.wait()
        np.testing.assert_array_equal(got, _md5_rows(b.reshape(2, 4096)))
        np.testing.assert_array_equal(got, jops.direct_hash(
            b.reshape(2, 4096)))
    assert crystal.stats["jobs"] >= 6


def test_callbacks_fire(crystal, rng):
    done = threading.Event()
    res = {}

    def cb(job):
        res["r"] = job.result
        done.set()

    buf = rng.integers(0, 256, 4096, dtype=np.uint8)
    crystal.submit("sliding", buf, {"window": 48, "stride": 4},
                   callback=cb)
    assert done.wait(timeout=60)
    assert res["r"].shape == ((4096 - 48) // 4 + 1,)


def test_error_propagation_and_gear_refused(crystal):
    job = crystal.submit("nonsense", np.zeros(4, np.uint8), {})
    with pytest.raises(ValueError):
        job.wait()
    depth = crystal.queue_depth()
    with pytest.raises(NotImplementedError, match="gear"):
        crystal.submit("gear", np.zeros(64, np.uint8), {})
    assert crystal.queue_depth() == depth      # nothing was parked


@pytest.mark.parametrize("reuse,overlap", [(True, True), (False, False),
                                           (True, False), (False, True)])
def test_ablations_equivalent_results(rng, reuse, overlap):
    c = _engine(buffer_reuse=reuse, overlap=overlap, n_slots=2)
    try:
        buf = rng.integers(0, 256, 8192, dtype=np.uint8)
        job = c.submit("sliding", buf, {"window": 48, "stride": 4})
        np.testing.assert_array_equal(
            job.wait(), jops.sliding_window_hash(buf.tobytes(), 48, 4))
        assert set(job.timings) == {"in", "kernel", "out"}
    finally:
        c.shutdown()


def test_coalesced_burst_digests_match_cpu(rng):
    """A burst of ragged direct requests fuses into fewer launches and
    every digest equals the per-chunk hashlib oracle; reused staging
    slots hold stale bytes that never change a digest."""
    eng = _engine(coalesce_window_s=0.1, max_batch=64, n_slots=1)
    try:
        for _ in range(2):
            sizes = [100, 4096, 377, 2048, 8191, 64, 1500, 4097]
            chunks = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
                      for s in sizes]
            jobs = []
            for c in chunks:
                rows, lens = pack_blocks([c])
                jobs.append(eng.submit("direct", rows, {"lens": lens}))
            for j, c in zip(jobs, chunks):
                assert j.wait()[0].tobytes() == block_digest_cpu(c)
        stats = eng.snapshot_stats()
        assert stats["jobs"] == 16
        assert stats["launches"] < stats["jobs"]
        assert stats["coalesced"] == stats["jobs"] - stats["launches"]
    finally:
        eng.shutdown()


def test_sliding_burst_coalesces(rng):
    eng = _engine(coalesce_window_s=0.2, max_batch=64)
    try:
        bufs = [rng.integers(0, 256, 2048 + 512 * i, dtype=np.uint8)
                for i in range(6)]
        jobs = [eng.submit("sliding", b, {"window": 48, "stride": 4})
                for b in bufs]
        for j, b in zip(jobs, bufs):
            np.testing.assert_array_equal(
                j.wait(), _cpu_sliding(b.tobytes(), 48, 4))
        stats = eng.snapshot_stats()
        assert stats["launches"] < stats["jobs"] == len(bufs)
    finally:
        eng.shutdown()


def test_short_stream_job_returns_empty():
    eng = _engine()
    try:
        job = eng.submit("sliding", np.frombuffer(b"tiny", np.uint8),
                         {"window": 48, "stride": 4})
        assert job.wait().shape == (0,)
    finally:
        eng.shutdown()


def test_sharded_direct_and_sliding_reassemble_in_order():
    """Whale jobs split across a four-entry mesh of one device come back
    byte-identical to the unsharded oracles, in submission order."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (16, 2048), np.uint8)
    sbuf = rng.integers(0, 256, (16 << 10) + 17, np.uint8)
    eng = _engine(4, shard_min_bytes=8 << 10)
    try:
        dj = eng.submit("direct", rows, {})
        sj = eng.submit("sliding", sbuf, {"window": 48, "stride": 4})
        np.testing.assert_array_equal(dj.wait(), _md5_rows(rows))
        np.testing.assert_array_equal(
            sj.wait(), _cpu_sliding(sbuf.tobytes(), 48, 4))
        st = eng.snapshot_stats()
        assert st["sharded_jobs"] == 2 and st["shards"] >= 4
        busy = [d for d in st["per_device"].values() if d["jobs"]]
        assert len(busy) >= 2, st["per_device"]
    finally:
        eng.shutdown()


def test_two_managers_share_one_device(rng):
    """[cpu, cpu] gives two managers; both serve and every digest is
    right."""
    eng = _engine(2, coalesce=False)
    try:
        assert len(eng.devices) == 2
        rows = rng.integers(0, 256, (1, 1024), np.uint8)
        jobs = [eng.submit("direct", rows, {}) for _ in range(12)]
        for j in jobs:
            np.testing.assert_array_equal(j.wait(), _md5_rows(rows))
        per = eng.snapshot_stats()["per_device"]
        assert sum(d["jobs"] for d in per.values()) == 12
    finally:
        eng.shutdown()


def test_lane_queue_priority_order():
    q = LaneQueue()
    q.put("s1", lane="scrub")
    q.put(None)
    q.put("b1", lane="batch")
    q.put("f1")
    q.put("s2", lane="scrub")
    q.put("f2", lane="fg")
    assert [q.get_nowait() for _ in range(6)] == \
        ["f1", "f2", "b1", "s1", "s2", None]


def test_foreground_jumps_scrub_backlog(rng):
    """With a manager busy, queued scrub jobs wait behind a later
    foreground job; the backlog still completes."""
    eng = _engine(max_batch=1)
    gate = threading.Event()
    order = []
    eng._launch_hook = lambda idx, batch: (gate.wait(10),
                                           order.extend(j.lane
                                                        for j in batch))
    try:
        rows = rng.integers(0, 256, (1, 256), np.uint8)
        first = eng.submit("direct", rows, {})
        scrub = [eng.submit("direct", rows, {}, lane="scrub")
                 for _ in range(4)]
        fg = eng.submit("direct", rows, {})
        gate.set()
        for j in [first, fg] + scrub:
            np.testing.assert_array_equal(j.wait(), _md5_rows(rows))
        assert order.index("fg", 1) < order.index("scrub")
        assert eng.snapshot_stats()["scrub_jobs"] == 4
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ca", ["fixed", "cdc"])
def test_reference_sai_drives_crystal_gpu(rng, ca):
    """The JAX package's SAI runs unchanged on the port's engine."""
    eng = _engine(coalesce_window_s=0.01)
    mgr, _ = ref_make_store(4, replication=2)
    sai = RefSAI(mgr, RefSAIConfig(ca=ca, block_size=4096, avg_chunk=4096,
                                   min_chunk=1024, max_chunk=16384),
                 crystal=eng)
    try:
        datas = [rng.integers(0, 256, 24 << 10, dtype=np.uint8).tobytes()
                 for _ in range(2)]
        futs = [sai.write_async("/f", d) for d in datas]
        for f in futs:
            f.result(timeout=120)
        for v, d in enumerate(datas):
            assert sai.read("/f", version=v) == d
        for digest in mgr.block_registry:
            node = mgr.nodes[mgr.block_registry[digest][0]]
            assert block_digest_cpu(node.get(digest)) == digest
        assert eng.snapshot_stats()["jobs"] > 0
    finally:
        sai.close()
        eng.shutdown()


def test_submit_after_shutdown_raises():
    eng = _engine()
    eng.shutdown()
    eng.shutdown()                       # idempotent
    with pytest.raises(RuntimeError):
        eng.submit("direct", np.zeros((1, 4), np.uint8), {})
