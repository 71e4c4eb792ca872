"""The write path's spans form on the CPU: the plain version of
``md5.md5_spans`` against ``hashlib`` and against ``md5_words`` on
``pack_blocks`` rows, the engine's spans job against its row job (fused,
unfused and sharded across a mesh), the SAI's writes against
``hasher='cpu'``, and the read path, which still submits rows.  The
CUDA entry is held to the same on the card in
``test_torch_kernels_cuda.py``.  Every comparison is exact."""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.crystal import CrystalGPU
from repro_torch.core.sai import block_digest_cpu, pack_blocks
from repro_torch.kernels import md5, ops

CPU = torch.device("cpu")
# message lengths at MD5's padding edges (a 4-byte trailer follows the
# word-padded data, so 52-56 and 60-64 bytes of data cross a block)
EDGE_LENS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 51, 52, 53, 54, 55, 56, 57, 60, 61,
             62, 63, 64, 65, 66, 67, 68, 127, 128, 129, 4095, 4096, 4097]
SMALL = dict(block_size=4096, avg_chunk=4096, min_chunk=1024,
             max_chunk=8192, window=48, stride=4)
FASTCDC = dict(ca="fastcdc", avg_chunk=8192, min_chunk=2048,
               max_chunk=65536, mask_s=0xD641C0D7, mask_l=0xD9000353)


def _words(img: np.ndarray) -> torch.Tensor:
    """An image as words with a zero tail, as the engine stages it."""
    padded = np.pad(img, (0, (-img.size) % 4))
    return torch.from_numpy(padded.view("<u4").copy())


def _digests(out: torch.Tensor) -> list:
    host = out.view(torch.int32).numpy().astype("<u4")
    return [host[i].tobytes() for i in range(host.shape[0])]


def _spans_of(lens, gap: int = 0):
    starts = np.cumsum([gap] + [n + gap for n in lens[:-1]])
    return starts.astype(np.int64), np.asarray(lens, np.int64)


@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_spans_plain_equals_hashlib_and_rows(rng, residue):
    """Every edge length at every start residue mod 4, neighbours
    sharing words: equal to hashlib's block digest and to md5_words on
    the chunks' pack_blocks rows."""
    starts, lens = _spans_of(EDGE_LENS)
    starts += residue
    img = rng.integers(0, 256, int(starts[-1] + lens[-1]) + 3,
                       dtype=np.uint8)
    got = _digests(md5.md5_spans(_words(img), torch.from_numpy(starts),
                                 torch.from_numpy(lens)))
    chunks = [img[s:s + n].tobytes() for s, n in zip(starts, lens)]
    assert got == [block_digest_cpu(c) for c in chunks]
    rows, row_lens = pack_blocks(chunks)
    want = md5.md5_words(torch.from_numpy(rows.view("<u4")),
                         torch.from_numpy(row_lens // 4))
    assert got == _digests(want)


@pytest.mark.parametrize("n_bytes", [1, 2, 3, 4, 5, 4097])
def test_spans_last_chunk_ends_off_a_word_at_the_image_end(rng, n_bytes):
    img = rng.integers(0, 256, 1000 + n_bytes, dtype=np.uint8)
    ends = np.array([7, 500, img.size], np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    got = _digests(md5.md5_spans(_words(img), torch.from_numpy(starts),
                                 torch.from_numpy(ends - starts)))
    assert got == [block_digest_cpu(img[a:b].tobytes())
                   for a, b in zip(starts, ends)]


def test_spans_refuses_spans_outside_the_image():
    words = torch.zeros(4, dtype=torch.int32)
    for starts, lens in (([0], [17]), ([-1], [2]), ([3], [-1]),
                         ([16], [1])):
        with pytest.raises(ValueError, match="spans must lie"):
            md5.md5_spans(words, torch.tensor(starts), torch.tensor(lens))
    with pytest.raises(ValueError, match="1-D"):
        md5.md5_spans(words.view(2, 2), torch.tensor([0]), torch.tensor([1]))
    assert md5.md5_spans(words, torch.tensor([16]),
                         torch.tensor([0])).shape == (1, 4)


def test_shard_span_ranges_cover_every_chunk_in_order():
    assert ops.shard_span_ranges([10, 20, 30, 40], 2) == [(0, 2), (2, 4)]
    assert ops.shard_span_ranges([1, 2, 1000], 3) == [(0, 3)]
    assert ops.shard_span_ranges([100], 4) == [(0, 1)]
    ends = np.cumsum(np.random.default_rng(1).integers(1, 9000, 500))
    ranges = ops.shard_span_ranges(ends, 4)
    assert len(ranges) == 4 and ranges[0][0] == 0 and ranges[-1][1] == 500
    assert all(a < b == c for (a, b), (c, _) in zip(ranges, ranges[1:]))


def _image_and_ends(rng, n_chunks=40, max_len=3000):
    lens = rng.integers(1, max_len, n_chunks)
    ends = np.cumsum(lens)
    img = rng.integers(0, 256, int(ends[-1]), dtype=np.uint8)
    return img, ends


@pytest.mark.parametrize("coalesce", [True, False])
def test_engine_spans_job_equals_row_job(rng, coalesce):
    """A burst of spans jobs (fused into one launch, or one launch
    each) gives the digests of the row jobs of the same chunks; the
    counters count the spans jobs and the bytes staged, images alike."""
    eng = CrystalGPU(devices=[CPU], coalesce=coalesce,
                     coalesce_window_s=0.2 if coalesce else 0.0)
    try:
        images = [_image_and_ends(rng) for _ in range(5)]
        spans = [eng.submit("direct", img, {"ends": ends})
                 for img, ends in images]
        got = [j.wait() for j in spans]
        st = eng.snapshot_stats()
        rows = []
        for img, ends in images:
            chunks = np.split(img, ends[:-1])
            r, lens = pack_blocks([c.tobytes() for c in chunks])
            rows.append(eng.submit("direct", r, {"lens": lens}).wait())
            rows[-1] = (rows[-1], r.size)
        after = eng.snapshot_stats()
    finally:
        eng.shutdown()
    for g, (want, _) in zip(got, rows):
        assert np.array_equal(g, want)
    assert st["direct_span_jobs"] == 5
    assert st["direct_staged_bytes"] == sum(img.size for img, _ in images)
    assert (st["launches"] < 5) == coalesce
    assert after["direct_span_jobs"] == 5
    assert after["direct_staged_bytes"] - st["direct_staged_bytes"] == \
        sum(n for _, n in rows)


def test_spans_and_rows_never_fuse(rng):
    img, ends = _image_and_ends(rng, 8)
    r, lens = pack_blocks([c.tobytes() for c in np.split(img, ends[:-1])])
    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.2)
    try:
        jobs = [eng.submit("direct", img, {"ends": ends}),
                eng.submit("direct", r, {"lens": lens}),
                eng.submit("direct", img, {"ends": ends})]
        got = [j.wait() for j in jobs]
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert all(np.array_equal(g, got[1]) for g in got)
    assert st["launches"] >= 2


def test_engine_refuses_ends_outside_the_image():
    eng = CrystalGPU(devices=[CPU])
    try:
        for ends in ([5, 3], [0, 11], [[1, 2]]):
            with pytest.raises(ValueError, match="ascending chunk ends"):
                eng.submit("direct", np.zeros(10, np.uint8), {"ends": ends})
    finally:
        eng.shutdown()


def test_whale_spans_job_shards_across_a_mesh_in_order(rng):
    img, ends = _image_and_ends(rng, 60, 4000)
    eng = CrystalGPU(devices=[CPU] * 4, shard_min_bytes=16 << 10)
    try:
        got = eng.submit("direct", img, {"ends": ends}).wait()
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    want = [block_digest_cpu(c.tobytes()) for c in np.split(img, ends[:-1])]
    assert [got[i].tobytes() for i in range(len(want))] == want
    assert st["sharded_jobs"] == 1 and st["shards"] >= 2
    assert sum(d["jobs"] > 0 for d in st["per_device"].values()) >= 2


def _maps(mgr, path):
    return [[(b.digest, b.length, tuple(b.nodes)) for b in fv.blocks]
            for fv in mgr.files[path]]


@pytest.mark.parametrize("ca", ["fixed", "cdc", "fastcdc"])
@pytest.mark.parametrize("how", ["write", "write_async"])
def test_sai_writes_spans_as_the_cpu_hasher(rng, ca, how):
    """Writes through the engine hash spans of their image and give the
    block maps (digests, lengths, replicas) of ``hasher='cpu'``: one
    spans job a write, which the engine shards over a two-device mesh
    with the digests kept in order."""
    cfg = dict(FASTCDC) if ca == "fastcdc" else dict(SMALL, ca=ca)
    images = [rng.integers(0, 256, 96 << 10, dtype=np.uint8).tobytes()
              for _ in range(2)]
    images.append(images[0][:40000] + images[1][:30001])
    maps = []
    eng = CrystalGPU(devices=[CPU] * 2, shard_min_bytes=16 << 10)
    try:
        for hasher in ("gpu", "cpu"):
            mgr, _ = core.make_store(4, replication=2)
            sai = core.SAI(mgr, core.SAIConfig(hasher=hasher, **cfg),
                           crystal=eng)
            before = eng.snapshot_stats()
            for img in images:
                if how == "write":
                    sai.write("/f", img)
                else:
                    sai.write_async("/f", img).result(timeout=300)
            after = eng.snapshot_stats()
            sai.close()
            maps.append(_maps(mgr, "/f"))
            spans = after["direct_span_jobs"] - before["direct_span_jobs"]
            # each write's job runs as its two shards, one a device
            assert spans == (2 * len(images) if hasher == "gpu" else 0)
    finally:
        eng.shutdown()
    assert maps[0] == maps[1]


def test_read_verify_still_submits_rows(rng):
    eng = CrystalGPU(devices=[CPU])
    mgr, _ = core.make_store(4, replication=2)
    sai = core.SAI(mgr, core.SAIConfig(ca="cdc", **SMALL), crystal=eng)
    img = rng.integers(0, 256, 64 << 10, dtype=np.uint8).tobytes()
    try:
        sai.write("/f", img)
        before = eng.snapshot_stats()
        assert sai.read("/f") == img
        assert sai.read_async("/f").result(timeout=300) == img
        after = eng.snapshot_stats()
    finally:
        sai.close()
        eng.shutdown()
    assert before["direct_span_jobs"] >= 1
    assert after["direct_span_jobs"] == before["direct_span_jobs"]
    assert after["jobs"] > before["jobs"]
    assert after["direct_staged_bytes"] > before["direct_staged_bytes"]


def test_spans_jobs_learn_their_own_launch_cost(rng):
    """Spans jobs feed the cost model under 'direct-spans', row jobs
    under 'direct': an image's bytes and padded rows' bytes are not
    priced alike."""
    img, ends = _image_and_ends(rng, 8)
    r, lens = pack_blocks([c.tobytes() for c in np.split(img, ends[:-1])])
    eng = CrystalGPU(devices=[CPU], coalesce=False)
    try:
        for _ in range(3):
            eng.submit("direct", img, {"ends": ends}).wait()
        spans_only = eng.cost.snapshot()
        eng.submit("direct", r, {"lens": lens}).wait()
        both = eng.cost.snapshot()
    finally:
        eng.shutdown()
    assert spans_only["direct-spans"]["observations"] == 3
    assert spans_only["direct"]["observations"] == 0
    assert both["direct"]["observations"] == 1
    assert both["direct-spans"]["observations"] == 3
