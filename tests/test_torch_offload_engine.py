"""The port's offload engine and async write pipeline, mirroring the JAX
package's ``tests/test_offload_engine.py``: coalesced batch digests equal
the per-chunk CPU oracle, ``write_async`` matches ``write``, dedup is
invariant under sync/async and 1-vs-N managers, fused launch counts stay
below request counts, empty writes commit an empty block map, and the
engine's lifecycle (shutdown, the process-wide default engine and its
atexit hook).

Every engine here runs on ``torch.device("cpu")`` entries (the plain
versions of the kernels).  ``default_engine()`` builds ``CrystalGPU()``,
which raises without a card, so the tests that use the shared default
engine patch it to a CPU engine inside the test.  Where the reference
asserts a launch count that does not depend on timing (coalescing off),
the JAX package's engine runs the same job stream and must give the same
count."""
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro_torch.core import CrystalGPU, SAI, SAIConfig, make_store
from repro_torch.core import crystal as crystal_mod
from repro_torch.core.sai import block_digest_cpu
from repro_torch.kernels import ops as port_ops
from repro_torch.train.checkpoint import CACheckpointer

CPU = torch.device("cpu")
# the single-job oracles: the port's ops on the CPU (the plain versions,
# held against the JAX package's ops in tests/test_torch_kernels_*.py)
ops = types.SimpleNamespace(**{
    name: functools.partial(getattr(port_ops, name), device=CPU)
    for name in ("direct_hash", "sliding_window_hash", "gear_hash")})
SAI_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "core" / "sai.py"


def _engine(n=1, **kw):
    return CrystalGPU(devices=[CPU] * n, **kw)


def _cfg(ca="fixed", hasher="gpu", **kw):
    return dict(ca=ca, hasher=hasher, block_size=4096, avg_chunk=4096,
                min_chunk=1024, max_chunk=16384, **kw)


def _sai(engine=None, ca="fixed", hasher="gpu", **kw):
    mgr, nodes = make_store(4)
    return SAI(mgr, SAIConfig(**_cfg(ca, hasher, **kw)),
               crystal=engine), mgr


@pytest.fixture
def cpu_default(monkeypatch):
    """The process-wide default engine, built on the CPU: the shared
    engine of SAIs given none (a fresh one for this test)."""
    monkeypatch.setattr(crystal_mod, "CrystalGPU",
                        lambda: CrystalGPU(devices=[CPU]))
    monkeypatch.setattr(crystal_mod, "_DEFAULT", None)
    yield
    crystal_mod._shutdown_default_engine()


# ----------------------------------------------------------------------
# engine: coalescing correctness + launch accounting
# ----------------------------------------------------------------------
def test_coalesced_burst_digests_match_cpu(rng):
    """A burst of ragged direct requests fuses into fewer launches and
    every digest equals the per-chunk hashlib oracle."""
    eng = _engine(coalesce_window_s=0.1, max_batch=64)
    sai, _ = _sai(engine=eng)
    try:
        sizes = [100, 4096, 377, 2048, 8191, 64, 1500, 4097]
        chunk_sets = [[rng.integers(0, 256, s, dtype=np.uint8).tobytes()]
                      for s in sizes]
        handles = [sai._submit_hash(cs) for cs in chunk_sets]
        for handle, cs in zip(handles, chunk_sets):
            assert handle.wait() == [block_digest_cpu(c) for c in cs]
        stats = eng.snapshot_stats()
        assert stats["jobs"] == len(sizes)
        assert stats["launches"] < stats["jobs"]
        assert stats["coalesced"] == stats["jobs"] - stats["launches"]
    finally:
        eng.shutdown()


def test_coalescing_off_launches_per_request(rng):
    datas = [rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
             for _ in range(3)]
    eng = _engine(coalesce=False)
    ref_eng = ref_core.CrystalTPU(coalesce=False)
    ref_mgr, _ = ref_core.make_store(4)
    ref_sai = ref_core.SAI(ref_mgr, ref_core.SAIConfig(**_cfg(hasher="tpu")),
                           crystal=ref_eng)
    counts = []
    try:
        for e, sai in ((eng, _sai(engine=eng)[0]), (ref_eng, ref_sai)):
            for d in datas:
                sai.write("/f", d)
            stats = e.snapshot_stats()
            assert stats["launches"] == stats["jobs"]
            assert stats["coalesced"] == 0
            counts.append((stats["jobs"], stats["launches"]))
    finally:
        eng.shutdown()
        ref_eng.shutdown()
    assert counts[0] == counts[1]     # the same stream in both packages


@pytest.mark.parametrize("kind,meta", [("sliding", {"window": 48,
                                                    "stride": 4}),
                                       ("gear", {})])
def test_stream_burst_coalesces(rng, kind, meta):
    """A burst of >= 4 same-config sliding/gear jobs fuses into one
    padded multi-row launch; every result matches the single-job ops
    oracle (acceptance criterion)."""
    eng = _engine(coalesce_window_s=0.2, max_batch=64)
    try:
        bufs = [rng.integers(0, 256, 2048 + 512 * i, dtype=np.uint8)
                for i in range(6)]
        jobs = [eng.submit(kind, b, dict(meta)) for b in bufs]
        for j, b in zip(jobs, bufs):
            if kind == "sliding":
                want = ops.sliding_window_hash(b.tobytes(), 48, 4)
            else:
                want = ops.gear_hash(b.tobytes())
            np.testing.assert_array_equal(j.wait(), want)
        stats = eng.snapshot_stats()
        assert stats["jobs"] == len(bufs)
        assert stats["launches"] < stats["jobs"], stats
        assert stats["coalesced"] == stats["jobs"] - stats["launches"]
    finally:
        eng.shutdown()


def test_mixed_config_sliding_jobs_never_fuse(rng):
    """Sliding jobs with different window/stride have different fuse
    keys: all results stay correct (via the carry path)."""
    eng = _engine(coalesce_window_s=0.05)
    try:
        buf = rng.integers(0, 256, 4096, dtype=np.uint8)
        configs = [(48, 4), (32, 4), (48, 2), (48, 4)]
        jobs = [eng.submit("sliding", buf, {"window": w, "stride": s})
                for w, s in configs]
        for j, (w, s) in zip(jobs, configs):
            np.testing.assert_array_equal(
                j.wait(), ops.sliding_window_hash(buf.tobytes(), w, s))
    finally:
        eng.shutdown()


def test_short_stream_job_returns_empty(rng):
    """len(data) < window yields an empty hash array, not a crash."""
    eng = _engine()
    try:
        job = eng.submit("sliding", np.frombuffer(b"tiny", np.uint8),
                         {"window": 48, "stride": 4})
        assert job.wait().shape == (0,)
        gj = eng.submit("gear", np.frombuffer(b"xy", np.uint8), {})
        assert gj.wait().shape == (2,)
    finally:
        eng.shutdown()


def test_concurrent_identical_content_never_double_stores(rng):
    """Store lanes racing on the same novel digests: the claim protocol
    guarantees exactly one lane stores each block — placement, stored
    bytes, and new/dup accounting stay exact."""
    sai, mgr = _sai(hasher="cpu", store_lanes=4)
    data = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    futs = [sai.write_async(f"/dup/p{i}", data) for i in range(8)]
    stats = [f.result(timeout=120) for f in futs]
    n_unique = len(mgr.block_registry)
    assert sum(s.new_blocks for s in stats) == n_unique
    total = sum(s.new_blocks + s.dup_blocks for s in stats)
    assert sum(s.dup_blocks for s in stats) == total - n_unique
    for locs in mgr.block_registry.values():
        assert len(locs) == 1              # replication=1: stored once
    assert mgr.stats()["stored_bytes"] == len(data)
    for i in range(8):
        assert sai.read(f"/dup/p{i}") == data
    sai.close()


def test_same_shape_jobs_across_managers_complete(rng):
    """Jobs must compare by identity, not array equality: two managers
    concurrently running same-shape jobs used to crash the manager
    thread on running-list membership (dataclass eq over numpy fields)
    and hang every waiter."""
    eng = _engine(2)
    try:
        data = rng.integers(0, 256, 8192, dtype=np.uint8)
        want = ops.direct_hash(data.reshape(2, 4096))
        jobs = [eng.submit("direct", data, {"seg_bytes": 4096})
                for _ in range(4)]
        for j in jobs:
            np.testing.assert_array_equal(j.wait(), want)
    finally:
        eng.shutdown()


def test_max_fused_bytes_caps_stream_batches(rng):
    """The staging-byte budget bounds stream fusion: 6 8KB jobs under a
    16KB budget need >= 3 launches, results intact."""
    eng = _engine(coalesce_window_s=0.2, max_fused_bytes=16 << 10)
    try:
        bufs = [rng.integers(0, 256, 8192, dtype=np.uint8)
                for _ in range(6)]
        jobs = [eng.submit("sliding", b, {"window": 48, "stride": 4})
                for b in bufs]
        for j, b in zip(jobs, bufs):
            np.testing.assert_array_equal(
                j.wait(), ops.sliding_window_hash(b.tobytes(), 48, 4))
        assert eng.snapshot_stats()["launches"] >= 3
    finally:
        eng.shutdown()


def test_max_fused_rows_caps_direct_batches(rng):
    """The fused-row cap bounds the padded staging matrix: 6 two-row
    jobs under a 4-row cap need at least 3 launches, results intact."""
    eng = _engine(coalesce_window_s=0.2, max_fused_rows=4)
    try:
        data = rng.integers(0, 256, 8192, dtype=np.uint8)
        jobs = [eng.submit("direct", data, {"seg_bytes": 4096})
                for _ in range(6)]
        want = ops.direct_hash(data.reshape(2, 4096))
        for j in jobs:
            np.testing.assert_array_equal(j.wait(), want)
        assert eng.snapshot_stats()["launches"] >= 3
    finally:
        eng.shutdown()


def test_store_lanes_commit_all_paths(rng):
    """Sharded store lanes: concurrent writers to many paths all commit,
    and per-path version order still matches submission order."""
    sai, mgr = _sai(hasher="cpu", store_lanes=3)
    payloads = [bytes([i]) * 4000 for i in range(9)]
    futs = [sai.write_async(f"/lane{i % 3}", p)
            for i, p in enumerate(payloads)]
    for f in futs:
        f.result(timeout=120)
    for p in range(3):
        assert mgr.num_versions(f"/lane{p}") == 3
        for v in range(3):
            assert sai.read(f"/lane{p}", version=v) == payloads[3 * v + p]
    sai.close()


def test_mixed_kind_burst_preserves_all_results(rng):
    """Direct jobs coalesce around interleaved sliding/gear jobs (the
    carry path) without losing or corrupting any result."""
    eng = _engine(coalesce_window_s=0.05)
    try:
        data = rng.integers(0, 256, 8192, dtype=np.uint8)
        jobs = []
        for i in range(3):
            jobs.append(("direct", eng.submit("direct", data,
                                              {"seg_bytes": 4096})))
            jobs.append(("gear", eng.submit("gear", data, {})))
        want_direct = ops.direct_hash(data.reshape(2, 4096))
        want_gear = ops.gear_hash(data.tobytes())
        for kind, job in jobs:
            got = job.wait()
            if kind == "direct":
                np.testing.assert_array_equal(got, want_direct)
            else:
                np.testing.assert_array_equal(got, want_gear)
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# write_async == write
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ca", ["fixed", "cdc-gear", "none"])
def test_write_async_equals_sync(rng, ca, cpu_default):
    datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (30_000, 10_000, 30_000)]   # third dups the first
    sai_s, mgr_s = _sai(ca=ca)
    sai_a, mgr_a = _sai(ca=ca)
    sync_stats = [sai_s.write(f"/f{i}", d) for i, d in enumerate(datas)]
    futs = [sai_a.write_async(f"/f{i}", d) for i, d in enumerate(datas)]
    async_stats = [f.result(timeout=120) for f in futs]
    for st_s, st_a in zip(sync_stats, async_stats):
        assert (st_s.total_bytes, st_s.new_bytes, st_s.new_blocks,
                st_s.dup_blocks) == (st_a.total_bytes, st_a.new_bytes,
                                     st_a.new_blocks, st_a.dup_blocks)
    for i, d in enumerate(datas):
        assert sai_a.read(f"/f{i}") == d
    assert mgr_s.stats()["stored_bytes"] == mgr_a.stats()["stored_bytes"]
    assert mgr_s.stats()["unique_blocks"] == mgr_a.stats()["unique_blocks"]


def test_write_async_orders_versions(rng):
    """Back-to-back async writes to one path commit in submission order."""
    sai, mgr = _sai(hasher="cpu")
    payloads = [bytes([i]) * 5000 for i in range(5)]
    futs = [sai.write_async("/v", p) for p in payloads]
    for f in futs:
        f.result(timeout=120)
    assert mgr.num_versions("/v") == 5
    for i, p in enumerate(payloads):
        assert sai.read("/v", version=i) == p


def test_dedup_invariant_across_devices_and_modes(rng):
    """Dedup ratio depends only on content — not on sync vs async nor on
    how many engine managers/devices service the hash requests."""
    base = rng.integers(0, 256, 50_000, dtype=np.uint8)
    mod = base.copy()
    mod[:5000] = rng.integers(0, 256, 5000, dtype=np.uint8)
    ratios = []
    for devices, use_async in (([CPU], False), ([CPU] * 3, False),
                               ([CPU], True)):
        eng = CrystalGPU(devices=devices, coalesce_window_s=0.02)
        sai, _ = _sai(engine=eng)
        try:
            if use_async:
                sai.write_async("/f", base.tobytes()).result(timeout=120)
                st = sai.write_async("/f", mod.tobytes()).result(timeout=120)
            else:
                sai.write("/f", base.tobytes())
                st = sai.write("/f", mod.tobytes())
            ratios.append((st.similarity, st.new_bytes, st.dup_blocks))
        finally:
            eng.shutdown()
    assert ratios[0] == ratios[1] == ratios[2]
    assert ratios[0][0] > 0.5          # most blocks unchanged -> dup


# ----------------------------------------------------------------------
# empty writes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ca", ["fixed", "cdc", "cdc-gear"])
def test_empty_write_commits_empty_blockmap(ca):
    sai, mgr = _sai(ca=ca, hasher="cpu")
    st = sai.write("/empty", b"")
    assert (st.new_blocks, st.dup_blocks, st.new_bytes) == (0, 0, 0)
    assert sai.read("/empty") == b""
    assert mgr.num_versions("/empty") == 1
    fut = sai.write_async("/empty", b"")
    assert fut.result(timeout=120).new_blocks == 0
    assert sai.read("/empty") == b""


def test_empty_write_tpu_path(cpu_default):
    sai, _ = _sai(ca="fixed", hasher="gpu",
                  engine=None)       # shared default engine
    assert sai.write("/e", b"").new_blocks == 0
    assert sai.read("/e") == b""


# ----------------------------------------------------------------------
# checkpoint save: batched streaming submission
# ----------------------------------------------------------------------
def test_checkpoint_save_coalesces_and_restores(rng):
    eng = _engine(coalesce_window_s=0.05)
    sai, _ = _sai(engine=eng, ca="fixed")
    try:
        params = {f"layer{i}": rng.standard_normal(3000).astype(np.float32)
                  for i in range(8)}
        ckpt = CACheckpointer(sai)
        rec = ckpt.save(11, params)
        stats = eng.snapshot_stats()
        # fused launch count < submitted request count (acceptance)
        assert stats["launches"] < stats["jobs"], stats
        assert rec["total_bytes"] == sum(p.nbytes for p in params.values())
        step, state, _ = ckpt.restore()
        assert step == 11
        for k, v in params.items():
            np.testing.assert_array_equal(state["params"][k], v)
    finally:
        eng.shutdown()


def test_submit_after_shutdown_raises():
    eng = _engine()
    eng.shutdown()
    with pytest.raises(RuntimeError):
        eng.submit("direct", np.zeros(8, np.uint8), {"seg_bytes": 4})


def test_default_engine_recreated_after_shutdown(cpu_default):
    from repro_torch.core.crystal import default_engine
    e1 = default_engine()
    e1.shutdown()
    e2 = default_engine()
    assert e2 is not e1 and e2._alive


def test_shutdown_idempotent(rng):
    """Repeat shutdown() calls are no-ops — no double-posted sentinels,
    no re-joins — and in-flight work still completes before the first
    shutdown drains the queue."""
    eng = _engine()
    data = rng.integers(0, 256, 4096, dtype=np.uint8)
    job = eng.submit("direct", data, {"seg_bytes": 4096})
    eng.shutdown()
    eng.shutdown()
    eng.shutdown()
    assert job.wait().shape == (1, 16)
    assert not eng._alive
    # managers joined exactly once; queue holds no stray sentinels
    assert all(not t.is_alive() for t in eng._managers)
    assert eng.outstanding._sentinels == 0
    assert all(d.queue._sentinels == 0 for d in eng._dev_states)


def test_default_engine_registers_atexit_shutdown(cpu_default):
    """Creating the process-wide default engine registers the atexit
    hook, so interpreter exit never races live manager threads; the hook
    itself is safe to run repeatedly and against an explicitly shut-down
    engine."""
    eng = crystal_mod.default_engine()
    assert crystal_mod._ATEXIT_REGISTERED
    crystal_mod._shutdown_default_engine()       # what atexit will run
    assert not eng._alive
    assert crystal_mod._DEFAULT is None
    crystal_mod._shutdown_default_engine()       # idempotent, no default
    e2 = crystal_mod.default_engine()            # recreated on next use
    assert e2._alive
    e2.shutdown()


def test_carried_job_completes_across_shutdown(rng):
    """A non-direct job popped as the coalescing carry must still run
    even if shutdown() lands while the fused batch executes."""
    eng = _engine(coalesce_window_s=0.2)
    data = rng.integers(0, 256, 4096, dtype=np.uint8)
    d1 = eng.submit("direct", data, {"seg_bytes": 4096})
    g = eng.submit("gear", data, {})          # becomes the carry
    d1.wait()
    eng.shutdown()                            # while/after batch runs
    assert g.wait().shape == (4096,)


def test_pipeline_close_and_restart(rng):
    sai, _ = _sai(hasher="cpu")
    sai.write_async("/a", b"x" * 10_000).result(timeout=120)
    sai.close()
    assert sai._pipe_threads == []
    sai.write_async("/b", b"y" * 10_000).result(timeout=120)
    assert sai.read("/b") == b"y" * 10_000
    sai.close()
    sai.close()                               # idempotent


def test_sai_has_no_direct_kernel_calls():
    """All hashing flows through the engine: the port's sai.py must not
    call the kernel ops layer directly (acceptance criterion)."""
    src = SAI_SRC.read_text()
    assert "ops.direct_hash" not in src
    assert "from repro_torch.kernels" not in src
