"""Boundary candidates on the card: the offload engine's candidate jobs
(``sliding``/``gear`` with a ``mask`` and ``magic``) and the compaction
kernel's wrapper (``kernels/candidates.py``).  The boundaries walked from
the candidates must equal ``chunking.select_boundaries`` over every window
hash and the benchmark's plain reference, exactly, on random buffers, a
checkpoint series, dense and empty candidate sets, inputs shorter than a
window, fused batches over stale staging bytes and sharded jobs.

Each test runs on the CPU (the plain versions) and, as its ``cuda`` twin,
on a card (the kernels); the twins skip without one.  Run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_boundary_candidates.py``.  The series and the sliding
reference are the benchmark's (``perfbench/``); the gear reference is the
JAX package's CPU baseline in the CPU tests (see ``_reference_bounds``);
the ``cuda`` twins import no JAX."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SAI, CrystalGPU, SAIConfig, chunking, make_store
from repro_torch.core.sai import _cpu_gear, _cpu_sliding
from repro_torch.kernels import candidates, ops
from repro_torch.obs import Trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import reference, traffic  # noqa: E402

SIZES = dict(avg_chunk=512, min_chunk=128, max_chunk=2048)
KINDS = [("sliding", 1), ("sliding", 2), ("sliding", 4), ("gear", 1)]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device and nvcc")
        return torch.device("cuda", 0)
    return torch.device("cpu")


def _engine(device, n=1, **kw):
    return CrystalGPU(devices=[device] * n, **kw)


def _geometry(kind, stride):
    """(window, stride) of a kind's candidate positions."""
    return (48, stride) if kind == "sliding" else (1, 1)


def _meta(kind, stride, avg_chunk):
    mask, magic = chunking.boundary_rule(avg_chunk)
    meta = {"window": 48, "stride": stride} if kind == "sliding" else {}
    return meta, {**meta, "mask": mask, "magic": magic}


def _all_hashes(kind, data: np.ndarray, stride, device):
    if kind == "sliding":
        return ops.sliding_window_hash(data, 48, stride, device=device)
    return ops.gear_hash(data, device=device)


def _reference_bounds(kind, data: np.ndarray, stride, sizes, device):
    """Boundaries from code outside the port's engine: the benchmark's
    plain reference for sliding MD5; for gear, in the CPU tests, the JAX
    package's CPU baseline (``SAI(ca="cdc-gear", hasher="cpu")
    ._boundaries``).  The JAX package runs only in the CPU tests, so a
    ``cuda`` twin holds gear to the port's host gear, which its CPU twin
    holds to the JAX package's on the same data (the tests' data does not
    depend on the device)."""
    if kind == "sliding":
        found = reference.chunk_candidates(
            torch.from_numpy(data.copy()), 48, stride, sizes["avg_chunk"])
        return reference.cdc_boundaries(found, data.size,
                                        sizes["min_chunk"],
                                        sizes["max_chunk"])
    if device.type != "cpu":
        return chunking.select_boundaries(_cpu_gear(data.tobytes()),
                                          data.size, window=1, stride=1,
                                          **sizes)
    import repro.core as ref_core
    sai = ref_core.SAI(ref_core.make_store(2)[0],
                       ref_core.SAIConfig(ca="cdc-gear", hasher="cpu",
                                          **sizes))
    try:
        return sai._boundaries(data.tobytes())
    finally:
        sai.close()


def _check(kind, stride, data, found, device, sizes=SIZES):
    """``found`` (a candidate job's result) is exactly the rule's hits
    over every hash, and its walk gives the full-hash and the reference
    boundaries.  Returns the boundaries."""
    mask, magic = chunking.boundary_rule(sizes["avg_chunk"])
    hashes = _all_hashes(kind, data, stride, device)
    assert found.dtype == np.int64
    np.testing.assert_array_equal(found,
                                  np.nonzero((hashes & mask) == magic)[0])
    window, step = _geometry(kind, stride)
    bounds, _ = chunking.boundaries_from_candidates(
        found, data.size, window=window, stride=step, **sizes)
    assert bounds == chunking.select_boundaries(
        hashes, data.size, window=window, stride=step, **sizes)
    assert bounds == _reference_bounds(kind, data, stride, sizes, device)
    return bounds


# ----------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------
def _interleaved_hits(h: np.ndarray, n_off, mask, magic):
    """Per row, the window indices k = q * R + i of [B, R, Wc] hashes
    under the rule, k < n_off, by the host's phase interleave."""
    B, R, Wc = h.shape
    rows = []
    for b in range(B):
        inter = ops.sliding_finish(h[b], tuple(range(R)),
                                   min(int(n_off[b]), R * Wc))
        rows.append(np.nonzero((inter & mask) == magic)[0])
    return rows


@pytest.mark.parametrize("R,Wc", [(4, 1100), (4, 1027), (2, 2050),
                                  (1, 1027), (1, 4096)])
@pytest.mark.parametrize("mask,magic", [(15, 3), (0, 0), (2 ** 32 - 1, 7)])
def test_wrapper_matches_phase_interleave(device, R, Wc, mask, magic):
    """Each row's hits under the rule and its n_off bound, ascending,
    with exact counts: dense (mask 0 keeps every window), sparse and
    empty rules; aligned and unaligned widths; n_off past the plane
    clamps.  On the card the kernel equals the plain version too."""
    rng = np.random.default_rng(R * Wc + mask)
    h = rng.integers(0, 2 ** 32, (4, R, Wc), dtype=np.uint64)
    h = h.astype(np.uint32)
    h[2, :, :40] = 7                 # a run of hits under (2**32 - 1, 7)
    n_off = [R * Wc, R * Wc - 37, 0, 10 ** 9]
    t = torch.from_numpy(h).to(device)
    before = candidates.LAUNCHES.value
    found, counts = candidates.boundary_candidates(t, n_off, mask, magic)
    want = _interleaved_hits(h, n_off, mask, magic)
    assert counts.tolist() == [len(w) for w in want]
    assert found.dtype == torch.int64 and found.device == t.device
    np.testing.assert_array_equal(found.cpu().numpy(),
                                  np.concatenate(want))
    if device.type == "cuda":
        # the count pass, and the scatter pass where a window is a hit
        assert candidates.LAUNCHES.value == before + 1 + bool(found.numel())
        plain, plain_counts = candidates.candidates_plain(t, n_off, mask,
                                                          magic)
        assert torch.equal(found, plain)
        assert plain_counts.tolist() == counts.tolist()


def test_wrapper_refuses_bad_shapes():
    h = torch.zeros((2, 3, 8), dtype=torch.uint32)
    with pytest.raises(ValueError, match="R in"):
        candidates.boundary_candidates(h, [1, 1], 1, 0)
    with pytest.raises(ValueError, match="n_off"):
        candidates.boundary_candidates(h[:, :2], [1], 1, 0)
    with pytest.raises(ValueError, match="32-bit"):
        candidates.boundary_candidates(h[:, :2], [1, 1], 2 ** 32, 0)


# ----------------------------------------------------------------------
# candidate jobs on the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,stride", KINDS)
def test_random_buffers(device, kind, stride):
    rng = np.random.default_rng(stride + len(kind))
    eng = _engine(device)
    try:
        for n in ((24 << 10) + 13, 5000):
            data = rng.integers(0, 256, n, np.uint8)
            _, cmeta = _meta(kind, stride, SIZES["avg_chunk"])
            found = eng.submit(kind, data, cmeta).wait()
            _check(kind, stride, data, found, device)
            assert found.size > 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kind", ["sliding", "gear"])
def test_checkpoint_series_versions(device, kind):
    """Two versions of the checkpoint series (an insert/delete shift
    between them) chunk alike on both paths and share most chunks."""
    v0, v1 = traffic.checkpoint_series(2, 48 << 10, 0.15, 4095, seed=5)
    eng = _engine(device)
    try:
        _, cmeta = _meta(kind, 1, SIZES["avg_chunk"])
        b0, b1 = (_check(kind, 1, v, eng.submit(kind, v, cmeta).wait(),
                         device) for v in (v0, v1))
    finally:
        eng.shutdown()
    digests = [{hashlib.md5(v[s:e].tobytes()).digest()
                for s, e in chunking.chunk_spans(b)}
               for v, b in ((v0, b0), (v1, b1))]
    assert len(digests[0] & digests[1]) > len(digests[1]) // 2


def _constant_window_hits(kind, byte, mask):
    if kind == "sliding":
        h = int.from_bytes(hashlib.md5(bytes([byte]) * 48).digest()[:4],
                           "little")
    else:
        h = int(_cpu_gear(bytes([byte]) * 64)[-1])
    return h & mask == 0


@pytest.mark.parametrize("kind", ["sliding", "gear"])
def test_dense_and_empty_candidates(device, kind):
    """A zero-filled buffer, a short repeating pattern, and constant
    buffers where every window is a candidate or none is (then only the
    max-chunk cuts apply)."""
    sizes = dict(avg_chunk=64, min_chunk=48, max_chunk=256)
    mask, _ = chunking.boundary_rule(64)
    every = next(b for b in range(256)
                 if _constant_window_hits(kind, b, mask))
    never = next(b for b in range(256)
                 if not _constant_window_hits(kind, b, mask))
    n = 4099
    bufs = {"zeros": np.zeros(n, np.uint8),
            "pattern": np.resize(np.frombuffer(b"\x01\x02\x03", np.uint8),
                                 n),
            "every": np.full(n, every, np.uint8),
            "never": np.full(n, never, np.uint8)}
    eng = _engine(device)
    _, cmeta = _meta(kind, 1, 64)
    try:
        found = {k: eng.submit(kind, v, cmeta).wait()
                 for k, v in bufs.items()}
    finally:
        eng.shutdown()
    got = {k: _check(kind, 1, bufs[k], found[k], device, sizes)
           for k in bufs}
    window = 48 if kind == "sliding" else 1
    first = 31 if kind == "gear" else 0     # gear's warm-up positions
    every = found["every"]
    assert every[every >= first].tolist() == list(
        range(first, n - window + 1))
    assert found["never"].size == 0
    assert got["never"] == list(range(256, n, 256)) + [n]


@pytest.mark.parametrize("kind,stride", KINDS)
def test_short_inputs(device, kind, stride):
    """Inputs shorter than one window give no candidate; every input
    ends in one chunk at its length."""
    eng = _engine(device)
    rng = np.random.default_rng(11)
    _, cmeta = _meta(kind, stride, SIZES["avg_chunk"])
    try:
        for n in (1, 3, 31, 47, 48, 49, 52, 100):
            data = rng.integers(0, 256, n, np.uint8)
            found = eng.submit(kind, data, cmeta).wait()
            if kind == "sliding" and n < 48:
                assert found.shape == (0,)
            assert _check(kind, stride, data, found, device) == [n]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kind", ["sliding", "gear"])
def test_fused_batches_over_stale_staging(device, kind):
    """One staging slot, reused: a long job alone, a fused burst of four
    long jobs, a fused burst of three shorter ones (stale bytes past each
    row and, for sliding, a bucketed pad row of stale bytes), then a
    short job alone over the first job's bytes.  No candidate comes
    from stale bytes: each job equals its own full-hash boundaries."""
    rng = np.random.default_rng(21)
    eng = _engine(device, n_slots=1, coalesce_window_s=0.2)
    _, cmeta = _meta(kind, 1, SIZES["avg_chunk"])
    plan = [[8000], [8000] * 4, [4100, 4500, 5000], [4100]]
    try:
        for sizes in plan:
            bufs = [rng.integers(0, 256, n, np.uint8) for n in sizes]
            jobs = [eng.submit(kind, b, cmeta) for b in bufs]
            for b, j in zip(bufs, jobs):
                _check(kind, 1, b, j.wait(), device)
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert st["max_fused"] >= 3 and st["launches"] < st["jobs"]
    assert st["boundary_jobs"] == sum(len(s) for s in plan)


@pytest.mark.parametrize("kind,stride", [("sliding", 4), ("sliding", 1),
                                         ("gear", 1)])
def test_sharded_candidate_job(device, kind, stride):
    """A whale candidate job split across a four-entry mesh of one
    device comes back as the unsharded candidates, in order."""
    buf = np.random.default_rng(1).integers(0, 256, (16 << 10) + 17,
                                            np.uint8)
    eng = _engine(device, 4, shard_min_bytes=8 << 10)
    _, cmeta = _meta(kind, stride, SIZES["avg_chunk"])
    try:
        found = eng.submit(kind, buf, cmeta).wait()
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert st["sharded_jobs"] == 1 and st["shards"] >= 2
    assert st["boundary_jobs"] == st["shards"]
    _check(kind, stride, buf, found, device)


def test_full_hash_and_candidate_jobs_never_fuse(device):
    """Queued back to back on one manager, full-hash jobs fuse with each
    other and candidate jobs with each other, never across: each comes
    back in its own form."""
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, 6000, np.uint8) for _ in range(4)]
    meta, cmeta = _meta("sliding", 4, SIZES["avg_chunk"])
    eng = _engine(device, coalesce_window_s=0.2)
    try:
        jobs = [eng.submit("sliding", bufs[0], meta),
                eng.submit("sliding", bufs[1], meta),
                eng.submit("sliding", bufs[2], cmeta),
                eng.submit("sliding", bufs[3], cmeta)]
        got = [j.wait() for j in jobs]
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert jobs[0].fuse_key == jobs[1].fuse_key != jobs[2].fuse_key \
        == jobs[3].fuse_key
    assert st["jobs"] == 4 and st["launches"] == 2
    for b, g in zip(bufs[:2], got[:2]):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, _cpu_sliding(b.tobytes(), 48, 4))
    for b, g in zip(bufs[2:], got[2:]):
        _check("sliding", 4, b, g, device)
    assert st["boundary_jobs"] == 2
    assert st["boundary_candidates"] == got[2].size + got[3].size


@pytest.mark.parametrize("ca", ["cdc", "cdc-gear", "fixed"])
def test_traced_write_counts_one_candidate_job(device, ca):
    """A traced write on the engine: one candidate job, as many
    candidates as the host's plain hashes give, one slide and one scan
    span; none of them under fixed blocks.  Boundaries equal a
    ``hasher='cpu'`` SAI's."""
    img = traffic.checkpoint_series(1, 40 << 10, 0.15, 4095,
                                    seed=2)[0].tobytes()
    cfg = dict(ca=ca, block_size=4096, window=48, stride=1, **SIZES)
    eng = _engine(device)
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(**cfg), crystal=eng)
    trace = Trace(1, "write")
    try:
        sai.write_async("/f", img, trace=trace).result(timeout=300)
        st = eng.snapshot_stats()
        bounds = sai._boundaries(img)
    finally:
        sai.close()
        eng.shutdown()
    cpu_sai = SAI(make_store(4, replication=2)[0],
                  SAIConfig(hasher="cpu", **cfg))
    assert bounds == cpu_sai._boundaries(img)
    names = [s.name for s in trace.spans]
    if ca == "fixed":
        assert st["boundary_jobs"] == st["boundary_candidates"] == 0
        assert "sai/chunk/slide" not in names
        return
    mask, magic = chunking.boundary_rule(SIZES["avg_chunk"])
    cpu = torch.device("cpu")
    hashes = ops.sliding_window_hash(img, 48, 1, device=cpu) \
        if ca == "cdc" else ops.gear_hash(img, device=cpu)
    hits = np.nonzero((hashes & mask) == magic)[0]
    assert st["boundary_jobs"] == 1
    assert st["boundary_candidates"] == hits.size
    assert names.count("sai/chunk/slide") == names.count(
        "sai/chunk/scan") == 1
