"""The port's read/verify pipeline, mirroring the JAX package's
``tests/test_read_path.py``: engine-verified reads are bit-identical to
hashlib-verified reads across ca modes, replica failover still verifies,
corrupted blocks raise IOError on sync and pipelined reads, a burst of
reads coalesces verify requests, a verified read of an n-block file is
one fused engine request, short CDC inputs fall back to one chunk, the
verified block cache (hits, LRU, invalidation on quarantine) and
Merkle-proof ``read_range``.

Engines run on ``torch.device("cpu")`` (the plain versions of the
kernels); ``hasher="gpu"`` is the port's name of the reference's
``hasher="tpu"`` (both are accepted).  A verified read of a 16-block
file is one job and one launch whatever the timing, so there the JAX
package's engine reads the same file and must give the same counts."""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro_torch.core import CrystalGPU, SAI, SAIConfig, make_store

CPU = torch.device("cpu")


def _engine(**kw):
    return CrystalGPU(devices=[CPU], **kw)


def _cfg(ca="fixed", hasher="gpu", **kw):
    return SAIConfig(ca=ca, hasher=hasher, block_size=4096, avg_chunk=4096,
                     min_chunk=1024, max_chunk=16384, **kw)


@pytest.mark.parametrize("ca", ["fixed", "cdc", "cdc-gear", "none"])
def test_tpu_read_bit_identical_to_cpu_read(rng, ca):
    """One store, two readers: engine-verified and hashlib-verified reads
    return identical bytes for every ca mode."""
    mgr, _ = make_store(4)
    data = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    SAI(mgr, _cfg(ca=ca, hasher="cpu")).write("/f", data)
    eng = _engine()
    try:
        got_tpu = SAI(mgr, _cfg(ca=ca, hasher="gpu"),
                      crystal=eng).read("/f")
        got_cpu = SAI(mgr, _cfg(ca=ca, hasher="cpu")).read("/f")
        assert got_tpu == got_cpu == data
    finally:
        eng.shutdown()


def test_replica_failover_still_verifies(rng):
    mgr, nodes = make_store(4, replication=2)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        nodes[0].fail()
        assert sai.read("/f") == data
        assert sai.read_async("/f").result(timeout=120) == data
    finally:
        sai.close()
        eng.shutdown()


def test_corrupted_block_raises_ioerror(rng):
    mgr, nodes = make_store(4)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        digest = next(iter(mgr.block_registry))
        for n in nodes:
            if digest in n.blocks:
                n.blocks[digest] = bytes(len(n.blocks[digest]))
        with pytest.raises(IOError):
            sai.read("/f")
        with pytest.raises(IOError):
            sai.read_async("/f").result(timeout=120)
        # unverified read still assembles the (corrupt) bytes
        assert len(sai.read("/f", verify=False)) == len(data)
    finally:
        sai.close()
        eng.shutdown()


def test_read_burst_coalesces_verify_requests(rng):
    """A burst of >= 4 pipelined reads fuses their verify hash requests:
    launches stay below submitted jobs (acceptance criterion)."""
    mgr, _ = make_store(4)
    eng = _engine(coalesce_window_s=0.2)
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        datas = [rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
                 for _ in range(6)]
        for i, d in enumerate(datas):
            sai.write(f"/f{i}", d)
        sai.read("/f0")                       # warm the verify shapes
        s0 = eng.snapshot_stats()
        futs = [sai.read_async(f"/f{i}") for i in range(6)]
        got = [f.result(timeout=120) for f in futs]
        assert got == datas
        s1 = eng.snapshot_stats()
        jobs = s1["jobs"] - s0["jobs"]
        launches = s1["launches"] - s0["launches"]
        assert jobs >= 6
        assert launches < jobs, (launches, jobs)
    finally:
        sai.close()
        eng.shutdown()


def _single_read_counts(eng, sai, data):
    """(jobs, launches) of one verified read of ``/f`` after a warm-up."""
    sai.write("/f", data)                 # 16 blocks
    sai.read("/f")                        # warm shapes
    s0 = eng.snapshot_stats()
    assert sai.read("/f") == data
    s1 = eng.snapshot_stats()
    return s1["jobs"] - s0["jobs"], s1["launches"] - s0["launches"]


def test_read_single_fused_launch_no_host_hashlib(rng, monkeypatch):
    """A verified read of an n-block file is ONE fused engine request —
    at most ceil(n / max_batch) launches and zero per-block host hashlib
    calls on the engine path."""
    mgr, _ = make_store(4)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    data = rng.integers(0, 256, 16 * 4096, dtype=np.uint8).tobytes()
    try:
        sai.write("/f", data)                 # 16 blocks
        sai.read("/f")                        # warm shapes
        import repro_torch.core.sai as sai_mod

        def _boom(_):
            raise AssertionError("host hashlib call on the engine read path")

        monkeypatch.setattr(sai_mod, "block_digest_cpu", _boom)
        s0 = eng.snapshot_stats()
        assert sai.read("/f") == data
        s1 = eng.snapshot_stats()
        n_blocks = 16
        max_launches = -(-n_blocks // eng.max_batch)    # ceil
        assert s1["launches"] - s0["launches"] <= max_launches
        assert s1["jobs"] - s0["jobs"] == 1
        port = (s1["jobs"] - s0["jobs"], s1["launches"] - s0["launches"])
    finally:
        sai.close()
        eng.shutdown()
    ref_mgr, _ = ref_core.make_store(4)
    ref_eng = ref_core.CrystalTPU()
    ref_sai = ref_core.SAI(ref_mgr, ref_core.SAIConfig(
        ca="fixed", hasher="tpu", block_size=4096, avg_chunk=4096,
        min_chunk=1024, max_chunk=16384), crystal=ref_eng)
    try:
        assert _single_read_counts(ref_eng, ref_sai, data) == port
    finally:
        ref_sai.close()
        ref_eng.shutdown()


@pytest.mark.parametrize("hasher", ["cpu", "tpu"])
def test_short_cdc_input_single_chunk(hasher):
    """len(data) < window: the sliding pass returns an empty hash array
    and boundary selection falls back to one whole-buffer chunk."""
    mgr, _ = make_store(4)
    eng = _engine() if hasher == "tpu" else None
    sai = SAI(mgr, _cfg(ca="cdc", hasher=hasher), crystal=eng)
    try:
        data = b"short-input!"                # 12 bytes < window 48
        st = sai.write("/tiny", data)
        assert st.new_blocks == 1
        assert sai.read("/tiny") == data
    finally:
        sai.close()
        if eng is not None:
            eng.shutdown()


def test_read_async_missing_file_fails():
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg(hasher="cpu"))
    try:
        with pytest.raises(FileNotFoundError):
            sai.read_async("/nope").result(timeout=120)
    finally:
        sai.close()


def test_checkpoint_restore_pipelined(rng):
    """Restore reads every leaf through read_async; verify requests from
    successive leaves coalesce and the state round-trips exactly."""
    from repro_torch.train.checkpoint import CACheckpointer
    mgr, _ = make_store(4)
    eng = _engine(coalesce_window_s=0.05)
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        params = {f"layer{i}": rng.standard_normal(2000).astype(np.float32)
                  for i in range(6)}
        ckpt = CACheckpointer(sai)
        ckpt.save(3, params)
        s0 = eng.snapshot_stats()
        step, state, _ = ckpt.restore()
        s1 = eng.snapshot_stats()
        assert step == 3
        for k, v in params.items():
            np.testing.assert_array_equal(state["params"][k], v)
        delta_jobs = s1["jobs"] - s0["jobs"]
        delta_launches = s1["launches"] - s0["launches"]
        assert delta_jobs >= len(params)
        assert delta_launches < delta_jobs, (delta_launches, delta_jobs)
    finally:
        sai.close()
        eng.shutdown()


def test_speculative_refetch_on_verify_failure(rng):
    """A verify mismatch retries the next replica instead of raising —
    the read succeeds, the corrupt copy is quarantined (repair hint), and
    later reads avoid it."""
    mgr, nodes = make_store(4, replication=2)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        digest = next(iter(mgr.block_registry))
        bad_nid = mgr.block_registry[digest][0]
        blk = nodes[bad_nid].blocks[digest]
        nodes[bad_nid].blocks[digest] = bytes([blk[0] ^ 0xFF]) + blk[1:]

        assert sai.read("/f") == data            # no IOError
        assert sai.read_stats["refetches"] >= 1
        assert mgr.is_quarantined(digest, bad_nid)
        assert bad_nid not in mgr.lookup_block(digest)
        assert sai.read_async("/f").result(timeout=120) == data
    finally:
        sai.close()
        eng.shutdown()


def test_read_cache_hits_skip_fetch_and_verify(rng, monkeypatch):
    """With read_cache_bytes set, a repeat read is served from the
    verified block cache — no node fetches, no re-hashing — and hit/miss
    counters track it."""
    mgr, nodes = make_store(4)
    sai = SAI(mgr, _cfg(hasher="cpu", read_cache_bytes=1 << 20))
    data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
    sai.write("/f", data)
    assert sai.read("/f") == data
    assert sai.read_stats["cache_misses"] == 4
    assert sai.read_stats["cache_hits"] == 0

    gets_before = sum(n.get_count for n in nodes)
    import repro_torch.core.sai as sai_mod

    def _boom(_):
        raise AssertionError("hash recomputed for a cached block")

    monkeypatch.setattr(sai_mod, "block_digest_cpu", _boom)
    assert sai.read("/f") == data                # pure cache hits
    assert sai.read_stats["cache_hits"] == 4
    assert sum(n.get_count for n in nodes) == gets_before


def test_read_cache_evicts_lru_and_defaults_off(rng):
    mgr, _ = make_store(4)
    # budget for two 4 KiB blocks
    sai = SAI(mgr, _cfg(hasher="cpu", read_cache_bytes=8192))
    data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
    sai.write("/f", data)
    assert sai.read("/f") == data
    assert len(sai._cache) <= 2
    assert sai._cache_used <= 8192

    sai_off = SAI(mgr, _cfg(hasher="cpu"))       # default: cache off
    assert sai_off.read("/f") == data
    assert sai_off.read("/f") == data
    assert sai_off.read_stats["cache_hits"] == 0
    assert sai_off.read_stats["cache_misses"] == 0


def test_read_cache_invalidated_on_quarantine(rng):
    """A cached block whose on-node copy is quarantined is evicted — the
    next read re-fetches and re-verifies from the surviving replicas
    instead of serving the stale entry."""
    mgr, nodes = make_store(4, replication=2)
    sai = SAI(mgr, _cfg(hasher="cpu", read_cache_bytes=1 << 20))
    data = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
    sai.write("/f", data)
    assert sai.read("/f") == data                # populate the cache
    digest = mgr.get_blockmap("/f").blocks[0].digest
    assert digest in sai._cache
    used = sai._cache_used

    bad_nid = mgr.block_registry[digest][0]
    mgr.quarantine_block(digest, bad_nid)
    assert digest not in sai._cache              # invalidated, not stale
    assert sai._cache_used < used
    assert sai.read_stats["cache_invalidations"] == 1

    gets_before = sum(n.get_count for n in nodes)
    assert sai.read("/f") == data                # re-fetch + re-verify
    assert sum(n.get_count for n in nodes) > gets_before
    assert digest in sai._cache                  # re-admitted verified


def test_read_cache_lru_eviction_order(rng):
    """LRU regression: touching an entry moves it to the MRU end, so a
    later insert evicts the genuinely least-recently-used block."""
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg(hasher="cpu", read_cache_bytes=8192))  # 2 blocks
    d1 = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
    d2 = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    sai.write("/f1", d1)
    sai.write("/f2", d2)
    assert sai.read("/f1") == d1                 # cache [A, B]
    dig_a, dig_b = [b.digest for b in mgr.get_blockmap("/f1").blocks]
    assert sai._cache_get(dig_a) is not None     # touch A: order [B, A]
    assert sai.read("/f2") == d2                 # insert C: evicts B
    dig_c = mgr.get_blockmap("/f2").blocks[0].digest
    assert dig_b not in sai._cache
    assert dig_a in sai._cache and dig_c in sai._cache


# ----------------------------------------------------------------------
# Merkle-proof partial reads
# ----------------------------------------------------------------------
def test_read_range_slices_and_fetches_only_covering_blocks(rng):
    """read_range returns the exact byte slice for aligned, straddling,
    tail-clamped, and out-of-range requests — and fetches ONLY the
    covering blocks (node get counts prove it)."""
    mgr, nodes = make_store(4)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 10 * 4096 + 123,
                            dtype=np.uint8).tobytes()
        sai.write("/f", data)
        for off, ln in [(0, 100), (4096, 4096), (5000, 9000),
                        (10 * 4096, 1000), (0, 1 << 40),
                        (len(data) - 10, 10), (3, 0)]:
            assert sai.read_range("/f", off, ln) == data[off:off + ln], \
                (off, ln)
        gets0 = sum(n.get_count for n in nodes)
        assert sai.read_range("/f", 4096, 4096) == data[4096:8192]
        assert sum(n.get_count for n in nodes) - gets0 == 1
        with pytest.raises(ValueError):
            sai.read_range("/f", -1, 10)
        with pytest.raises(FileNotFoundError):
            sai.read_range("/nope", 0, 10)
    finally:
        sai.close()
        eng.shutdown()


def test_read_range_verifies_against_merkle_root(rng):
    """A corrupt covering block is caught by the recomputed digest and
    healed from the next replica; a tampered block-map (stored root no
    longer matches the leaves) fails the membership proof with IOError
    even though the block bytes match their own digest."""
    mgr, nodes = make_store(4, replication=2)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 6 * 4096, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        fv = mgr.get_blockmap("/f")
        b = fv.blocks[2]
        bad_nid = mgr.block_registry[b.digest][0]
        blk = nodes[bad_nid].blocks[b.digest]
        nodes[bad_nid].blocks[b.digest] = bytes([blk[0] ^ 0xFF]) + blk[1:]
        # corrupt copy: speculative re-fetch (full-read semantics)
        assert sai.read_range("/f", 2 * 4096, 4096) == \
            data[2 * 4096:3 * 4096]
        assert sai.read_stats["refetches"] >= 1
        assert mgr.is_quarantined(b.digest, bad_nid)
        # metadata tamper: the stored root stops matching the leaves
        fv.merkle_root = b"\x00" * 16
        with pytest.raises(IOError):
            sai.read_range("/f", 0, 4096)
        # unverified range read still serves bytes
        assert sai.read_range("/f", 0, 4096, verify=False) == data[:4096]
    finally:
        sai.close()
        eng.shutdown()


def test_read_range_root_check_covers_cached_blocks(rng):
    """Regression: a warm read cache must not bypass the root check —
    a tampered block-map fails the membership proof even when every
    covering block is served from the verified cache."""
    mgr, _ = make_store(4)
    sai = SAI(mgr, _cfg(hasher="cpu", read_cache_bytes=1 << 20))
    data = rng.integers(0, 256, 4 * 4096, dtype=np.uint8).tobytes()
    sai.write("/f", data)
    assert sai.read("/f") == data                # warm the cache
    assert sai.read_range("/f", 4096, 4096) == data[4096:8192]
    mgr.get_blockmap("/f").merkle_root = b"\x00" * 16
    with pytest.raises(IOError):
        sai.read_range("/f", 4096, 4096)         # cache-warm, still caught


def test_read_range_eof_edges(rng):
    """EOF edge cases: offset exactly at EOF and zero-length reads return
    b'' (no block is fetched), a range ending inside the final partial
    block returns exactly the partial tail, and an offset strictly past
    EOF raises ValueError cleanly instead of silently reading empty."""
    mgr, nodes = make_store(4)
    eng = _engine()
    sai = SAI(mgr, _cfg(), crystal=eng)
    try:
        tail = 123                               # final partial block
        data = rng.integers(0, 256, 3 * 4096 + tail,
                            dtype=np.uint8).tobytes()
        sai.write("/f", data)
        gets0 = sum(n.get_count for n in nodes)
        assert sai.read_range("/f", len(data), 10) == b""    # at EOF
        assert sai.read_range("/f", len(data), 0) == b""
        assert sai.read_range("/f", 100, 0) == b""           # zero len
        assert sai.read_range("/f", 0, 0) == b""
        assert sum(n.get_count for n in nodes) == gets0      # no fetch
        # range ending inside the final partial block
        assert sai.read_range("/f", 3 * 4096 + 3, 40) == \
            data[3 * 4096 + 3:3 * 4096 + 43]
        # range extending past the partial tail clamps to it
        assert sai.read_range("/f", 3 * 4096, 4096) == data[3 * 4096:]
        for off in (len(data) + 1, len(data) + 5000, 1 << 40):
            with pytest.raises(ValueError):
                sai.read_range("/f", off, 10)
            with pytest.raises(ValueError):
                sai.read_range("/f", off, 0)     # past EOF beats len=0
    finally:
        sai.close()
        eng.shutdown()


def test_read_range_matches_full_read_across_ca_modes(rng):
    """Partial reads agree with full reads for CDC chunkings too (the
    covering-block walk handles ragged chunk lengths)."""
    for ca in ("fixed", "cdc", "cdc-gear"):
        mgr, _ = make_store(4)
        sai = SAI(mgr, _cfg(ca=ca, hasher="cpu"))
        data = rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
        sai.write("/f", data)
        for off, ln in [(0, 30_000), (1234, 5000), (17_000, 13_000)]:
            assert sai.read_range("/f", off, ln) == data[off:off + ln], \
                (ca, off, ln)
