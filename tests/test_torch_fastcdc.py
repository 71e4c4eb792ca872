"""FastCDC (``ca="fastcdc"``) on the port's write path: the two-rule
candidates of ``kernels/candidates.py`` against a numpy oracle, the
normalized walk (``chunking.walk_normalized``) against a literal
byte-by-byte loop of the paper's Algorithm 1, and writes through
``SAI.write`` / ``write_async`` (the offload engine on the CPU, and
``hasher="cpu"``) against the benchmark's plain reference,
``perfbench/chunkers/fastcdc.py``: boundaries, digests and dedup.

The literal loop takes the configuration's departures from Algorithm 1
(``perfbench/configs/cas-gear.json``): the fingerprint at every byte
covers its full 32-byte window (never restarted at a chunk's minimum),
and a chunk of length i ends after the byte whose fingerprint matched,
so length i tests byte i - 1.  Masks here have fewer one-bits than the
configuration's, scaled to kilobyte chunks, so both masks cut chunks."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SAI, CrystalGPU, SAIConfig, chunking, make_store
from repro_torch.core.sai import _cpu_gear
from repro_torch.kernels import candidates, ops
from repro_torch.obs import Trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import reference, traffic  # noqa: E402

# strict 12 and loose 8 one-bits, each with bit 31 set: about one strict
# hit in 4 KiB and one loose hit in 256 bytes
MASK_S = (1 << 31) | (1 << 29) | (1 << 26) | (1 << 24) | (1 << 21) \
    | (1 << 19) | (1 << 16) | (1 << 13) | (1 << 10) | (1 << 7) | (1 << 4) \
    | (1 << 1)
MASK_L = (1 << 31) | (1 << 28) | (1 << 24) | (1 << 20) | (1 << 16) \
    | (1 << 12) | (1 << 8) | (1 << 4)
SIZES = dict(avg_chunk=1024, min_chunk=256, max_chunk=4096)
CFG = dict(ca="fastcdc", mask_s=MASK_S, mask_l=MASK_L, **SIZES)
MASK = 0xFFFFFFFF


def fmix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & MASK
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


GEAR = [fmix32(b + 1) for b in range(256)]


def algorithm1(data: bytes, mask_s, mask_l, min_size, normal_size,
               max_size):
    """(chunk end offsets, cuts forced at the maximum before the end) by
    a literal loop of FastCDC's Algorithm 1, one chunk a pass of its
    body, one byte a step, with the two departures of the module
    docstring."""
    fp, h = 0, []
    for b in data:                      # never restarted
        fp = ((fp << 1) + GEAR[b]) & MASK
        h.append(fp)
    out, last, forced = [], 0, 0
    while last < len(data):
        n = len(data) - last
        normal = normal_size
        if n <= min_size:
            cut = n
        else:
            if n >= max_size:
                n = max_size
            elif n <= normal:
                normal = n
            i, cut = min_size, None
            while i < normal:
                if not h[last + i - 1] & mask_s:
                    cut = i
                    break
                i += 1
            while cut is None and i < n:
                if not h[last + i - 1] & mask_l:
                    cut = i
                i += 1
            if cut is None:
                cut = n
                forced += last + n < len(data)
        last += cut
        out.append(last)
    return out, forced


def _series(n_versions, size, seed):
    return traffic.checkpoint_series(n_versions, size, 0.15, 1500,
                                     seed=seed)


# ----------------------------------------------------------------------
# two-rule candidates
# ----------------------------------------------------------------------
@pytest.mark.parametrize("R,Wc", [(1, 4096), (4, 1027), (2, 2050)])
@pytest.mark.parametrize("rules", [(MASK_S, 0, MASK_L, 0),
                                   (15, 3, 0, 0), (0, 0, 2 ** 32 - 1, 7)])
def test_two_rule_candidates_plain_match_numpy(R, Wc, rules):
    """Each row's windows k < n_off that meet either rule, in window
    order, as 4 * k + flags: dense, sparse and overlapping rules."""
    rng = np.random.default_rng(R * Wc)
    h = rng.integers(0, 2 ** 32, (3, R, Wc), dtype=np.uint64)
    h = h.astype(np.uint32)
    h[1, :, :40] = 7
    n_off = [R * Wc, R * Wc - 37, 5]
    mask, magic, mask2, magic2 = rules
    found, counts = candidates.candidates_plain(torch.from_numpy(h), n_off,
                                                *rules)
    want = []
    for b in range(3):
        by_k = h[b].T.reshape(-1)[:n_off[b]].astype(np.int64)
        hit = (by_k & mask) == magic
        hit2 = (by_k & mask2) == magic2
        want.append([4 * k + hit[k] + 2 * hit2[k]
                     for k in range(by_k.size) if hit[k] or hit2[k]])
    assert counts.tolist() == [len(w) for w in want]
    assert found.tolist() == sum(want, [])
    k, first, second = candidates.decode(found.numpy())
    assert np.all(first | second)


def test_one_rule_candidates_stay_bare_indices():
    h = np.random.default_rng(3).integers(0, 2 ** 32, (2, 1, 5000),
                                          dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(h)
    found, _ = candidates.candidates_plain(t, [5000, 4000], 255, 0)
    both, _ = candidates.candidates_plain(t, [5000, 4000], 255, 0, 255, 0)
    assert torch.equal(both >> candidates.FLAG_BITS, found)
    assert torch.equal(both & 3, torch.full_like(found, 3))


# ----------------------------------------------------------------------
# the normalized walk
# ----------------------------------------------------------------------
def _buffers():
    rng = np.random.default_rng(8)
    return {"random": rng.integers(0, 256, 60001, np.uint8).tobytes(),
            "zeros": bytes(20000),
            "period-3": b"\x01\x02\x03" * 7001,
            "period-1000": rng.integers(0, 256, 1000,
                                        np.uint8).tobytes() * 31,
            "short": rng.integers(0, 256, 300, np.uint8).tobytes(),
            "tail-under-normal": rng.integers(0, 256, 1300,
                                              np.uint8).tobytes()}


@pytest.mark.parametrize("name", list(_buffers()))
@pytest.mark.parametrize("masks", [(MASK_S, MASK_L), (1 << 31, 1 << 31),
                                   (MASK, MASK)])
def test_walk_equals_algorithm1(name, masks):
    """Random, zero-filled and periodic inputs, inputs under the minimum
    and tails under the normal size; masks that cut chunks under both,
    cut half of all bytes, or never cut (every chunk forced at the
    maximum)."""
    data = _buffers()[name]
    h = _cpu_gear(data)
    found = chunking.host_candidates(h, masks[0], 0, masks[1], 0)
    got = chunking.walk_normalized(found, len(data), **SIZES)
    want = algorithm1(data, *masks, SIZES["min_chunk"], SIZES["avg_chunk"],
                      SIZES["max_chunk"])
    assert got == want
    if masks == (MASK, MASK):
        assert got[1] == max(len(data) - 1, 0) // SIZES["max_chunk"]


def test_walk_uses_both_masks():
    """On random bytes both masks cut chunks: some chunks end before the
    normal size (strict) and some after it (loose)."""
    data = _buffers()["random"]
    found = chunking.host_candidates(_cpu_gear(data), MASK_S, 0, MASK_L, 0)
    bounds, _ = chunking.walk_normalized(found, len(data), **SIZES)
    lens = np.diff([0] + bounds)[:-1]
    assert np.any(lens < SIZES["avg_chunk"])
    assert np.any(lens > SIZES["avg_chunk"])
    assert np.all(lens >= SIZES["min_chunk"])
    assert np.all(lens <= SIZES["max_chunk"])


@pytest.mark.parametrize("name", list(_buffers()))
def test_reference_equals_algorithm1(name):
    data = _buffers()[name]
    img = np.frombuffer(data, np.uint8)
    got = reference.chunk_bounds(img, {"ca": "fastcdc", **CFG}, "cpu")
    assert got == algorithm1(data, MASK_S, MASK_L, SIZES["min_chunk"],
                             SIZES["avg_chunk"], SIZES["max_chunk"])[0]


# ----------------------------------------------------------------------
# the SAI
# ----------------------------------------------------------------------
def test_construction_refuses_fastcdc_without_masks():
    with pytest.raises(ValueError, match="mask_s"):
        SAIConfig(ca="fastcdc", mask_l=MASK_L, **SIZES)
    with pytest.raises(ValueError, match="mask_l"):
        SAIConfig(ca="fastcdc", mask_s=MASK_S, **SIZES)
    with pytest.raises(ValueError, match="32-bit"):
        SAIConfig(ca="fastcdc", mask_s=2 ** 32, mask_l=MASK_L, **SIZES)
    with pytest.raises(ValueError, match="min_chunk"):
        SAIConfig(ca="fastcdc", mask_s=MASK_S, mask_l=MASK_L,
                  avg_chunk=1024, min_chunk=16, max_chunk=4096)
    with pytest.raises(ValueError, match="ca='nope'"):
        SAIConfig(ca="nope")
    SAIConfig(**CFG)


def _reference_writes(series):
    """(boundaries, digests, dedup counts) of each version written in
    order into one empty store, by the plain reference."""
    sai = {"ca": "fastcdc", **CFG}
    bounds = [reference.chunk_bounds(v, sai, "cpu") for v in series]
    digests = [reference.block_digests(v, b) for v, b in zip(series, bounds)]
    lens = [np.diff([0] + b).tolist() for b in bounds]
    return bounds, digests, reference.dedup_counts(digests, lens)


@pytest.mark.parametrize("hasher", ["gpu", "cpu"])
def test_sai_writes_equal_the_reference(hasher):
    """A version series with inserts and deletes, written through
    ``write_async`` (the engine on the CPU, or the host's gear): each
    version's block map, digests and dedup counts equal the plain
    reference's, and every version reads back."""
    series = _series(4, 48 << 10, seed=3)
    want_bounds, want_digests, want_dedup = _reference_writes(series)
    eng = CrystalGPU(devices=[torch.device("cpu")])
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(hasher=hasher, **CFG), crystal=eng)
    try:
        stats = [sai.write_async("/f", v.tobytes()).result(timeout=300)
                 for v in series]
        maps = [mgr.get_blockmap("/f", i) for i in range(len(series))]
        back = [sai.read("/f", version=i) for i in range(len(series))]
        st = eng.snapshot_stats()
    finally:
        sai.close()
        eng.shutdown()
    for i, v in enumerate(series):
        ends = np.cumsum([b.length for b in maps[i].blocks]).tolist()
        assert ends == want_bounds[i]
        assert [b.digest for b in maps[i].blocks] == want_digests[i]
        s = stats[i]
        assert (s.new_blocks, s.dup_blocks, s.new_bytes) == want_dedup[i]
        assert back[i] == v.tobytes()
    assert sum(s.dup_blocks for s in stats) > 0
    if hasher == "gpu":
        assert st["boundary_jobs"] == len(series)
        h = [ops.gear_hash(v, device="cpu") for v in series]
        assert st["boundary_strict"] == sum(
            int(np.count_nonzero((x & MASK_S) == 0)) for x in h)
    else:
        assert st["boundary_jobs"] == 0


def test_sai_write_sync_equals_async():
    v = _series(1, 20 << 10, seed=9)[0]
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(hasher="cpu", **CFG))
    try:
        sai.write("/s", v.tobytes())
        sai.write_async("/a", v.tobytes()).result(timeout=300)
        a, b = (mgr.get_blockmap(p, 0).blocks for p in ("/s", "/a"))
    finally:
        sai.close()
    assert [x.digest for x in a] == [x.digest for x in b]
    assert [x.digest for x in a] == [
        hashlib.md5(bytes(v[s:e]) + b"\0" * (-(e - s) % 4)
                    + (e - s).to_bytes(4, "little")).digest()
        for s, e in chunking.chunk_spans(
            reference.chunk_bounds(v, {"ca": "fastcdc", **CFG}, "cpu"))]


@pytest.mark.parametrize("ca", ["cdc", "cdc-gear", "fastcdc"])
@pytest.mark.parametrize("hasher", ["gpu", "cpu"])
def test_scan_span_counts_candidates_and_forced_cuts(ca, hasher):
    """Every CDC rule's sai/chunk/scan span carries the candidates it
    walked and the cuts forced at max_chunk: a zero-filled tail forces
    cuts under every rule."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, 30000, np.uint8).tobytes() + bytes(20000)
    cfg = dict(CFG, ca=ca, hasher=hasher, window=48, stride=1)
    eng = CrystalGPU(devices=[torch.device("cpu")])
    sai = SAI(make_store(4, replication=2)[0], SAIConfig(**cfg),
              crystal=eng)
    trace = Trace(1, "write")
    try:
        sai.write_async("/f", img, trace=trace).result(timeout=300)
        st = eng.snapshot_stats()
        bounds = sai._boundaries(img)
    finally:
        sai.close()
        eng.shutdown()
    scans = [s for s in trace.spans if s.name == "sai/chunk/scan"]
    assert len(scans) == 1
    meta = scans[0].meta
    assert meta["chunks"] == len(bounds)
    if hasher == "gpu":
        assert meta["candidates"] == st["boundary_candidates"]
    assert meta["candidates"] > 0
    lens = np.diff([0] + bounds)
    assert 0 < meta["forced"] <= int(np.sum(lens == SIZES["max_chunk"]))


def test_two_rule_jobs_fuse_only_with_their_rules():
    """Queued back to back on one manager, one-rule and two-rule gear
    jobs fuse each with their own kind, and each comes back in its own
    form."""
    rng = np.random.default_rng(6)
    bufs = [rng.integers(0, 256, 6000, np.uint8) for _ in range(4)]
    one = {"mask": MASK_L, "magic": 0}
    two = {"mask": MASK_S, "magic": 0, "mask2": MASK_L, "magic2": 0}
    eng = CrystalGPU(devices=[torch.device("cpu")], coalesce_window_s=0.2)
    try:
        jobs = [eng.submit("gear", bufs[0], one),
                eng.submit("gear", bufs[1], one),
                eng.submit("gear", bufs[2], two),
                eng.submit("gear", bufs[3], two)]
        got = [j.wait() for j in jobs]
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert jobs[0].fuse_key == jobs[1].fuse_key != jobs[2].fuse_key \
        == jobs[3].fuse_key
    assert st["launches"] == 2
    for b, g in zip(bufs, got[:2]):
        h = ops.gear_hash(b, device="cpu")
        np.testing.assert_array_equal(g, chunking.host_candidates(
            h, MASK_L, 0))
    for b, g in zip(bufs[2:], got[2:]):
        h = ops.gear_hash(b, device="cpu")
        np.testing.assert_array_equal(g, chunking.host_candidates(
            h, MASK_S, 0, MASK_L, 0))
    assert st["boundary_strict"] == sum(int(np.count_nonzero(g & 1))
                                        for g in got[2:])


def test_sharded_two_rule_job():
    """A whale two-rule job split across a four-entry mesh of one device
    comes back as the unsharded codes, in order."""
    buf = np.random.default_rng(1).integers(0, 256, (16 << 10) + 17,
                                            np.uint8)
    meta = {"mask": MASK_S >> 4, "magic": 0, "mask2": MASK_L, "magic2": 0}
    eng = CrystalGPU(devices=[torch.device("cpu")] * 4,
                     shard_min_bytes=8 << 10)
    whole = CrystalGPU(devices=[torch.device("cpu")])
    try:
        found = eng.submit("gear", buf, meta).wait()
        st = eng.snapshot_stats()
        want = whole.submit("gear", buf, meta).wait()
    finally:
        eng.shutdown()
        whole.shutdown()
    assert st["sharded_jobs"] == 1 and st["shards"] >= 2
    np.testing.assert_array_equal(found, want)
    assert np.any(found & 1) and np.any(found & 2)
