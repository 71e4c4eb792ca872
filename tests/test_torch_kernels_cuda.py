"""The port's CUDA kernels and engine on the card: each hashing kernel
against its plain version and ``hashlib`` or ``_cpu_gear``, bit for bit,
flash attention against its plain version (f32 within the JAX package's
2e-5, also on rows of 16384 and 32768 keys; bf16 and f16 within the bound
derived from their rounding), the f32 flash
kernel's TF32 pre-pass against its plain version bit for bit, the
boundary-candidate kernel under one rule and under two (FastCDC's strict
and loose masks) against its plain version, the direct MD5's spans entry
against ``hashlib``, its plain version and the row entry, two managers
sharing one card through their own streams, and a whale job sharded across
four managers of one card.  Every test here needs an
NVIDIA GPU and ``nvcc``; without them it skips.  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``
(this file imports neither JAX nor the JAX package)."""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
from repro_torch.core.sai import _cpu_gear
from repro_torch.kernels import (candidates, flash_attn, gear, md5, ops,
                                 sliding_md5)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("B,W", [(45, 4096), (33, 1), (64, 257)])
def test_md5_kernel_matches_plain_and_hashlib(cuda, rng, B, W):
    data = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
    lens = rng.integers(0, W + 1, B).astype(np.int32)
    lens[0] = W
    words = torch.from_numpy(data).to(cuda)
    before = md5.LAUNCHES.value
    got = md5.md5_words(words, torch.from_numpy(lens))
    assert md5.LAUNCHES.value == before + 1
    want = md5.md5_plain(words, torch.from_numpy(lens).to(cuda))
    assert _equal(got, want)
    host = got.cpu().numpy()
    for i in range(B):
        ref = hashlib.md5(data[i, :lens[i]].astype("<u4").tobytes())
        assert host[i].astype("<u4").tobytes() == ref.digest()


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_sliding_kernel_matches_plain_and_hashlib(cuda, rng, stride):
    buf = rng.integers(0, 256, (1 << 20) + 5, dtype=np.uint8)
    padded = np.pad(buf, (0, (-buf.size) % 4))
    words = torch.from_numpy(padded.view("<u4").copy()).to(cuda)[None]
    for window in (16, 32, 48):
        got = sliding_md5.sliding_md5_words(words, window // 4, stride)
        want = sliding_md5.sliding_plain(words, window // 4, stride)
        assert _equal(got, want)
    hashes = ops.sliding_window_hash(buf.tobytes(), 48, stride, device=cuda)
    n_off = (buf.size - 48) // stride + 1
    assert hashes.shape == (n_off,)
    for o in list(rng.integers(0, n_off, 50)) + [0, n_off - 1]:
        b0 = int(o) * stride
        ref = hashlib.md5(buf[b0:b0 + 48].tobytes()).digest()
        assert int(hashes[o]) == int.from_bytes(ref[:4], "little")


def _window_a(row: np.ndarray, start: int, window: int) -> int:
    """hashlib's digest word a of ``window`` bytes of a row of bytes from
    ``start``, zeros past the row's end."""
    chunk = row[start:start + window].tobytes()
    chunk += bytes(window - len(chunk))
    return int.from_bytes(hashlib.md5(chunk).digest()[:4], "little")


@pytest.mark.parametrize("w_words", range(1, 14))
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_sliding_kernel_edges(cuda, rng, stride, w_words):
    """Rows around the kernel's tile (T - 1, T, T + 1 and T + w_words
    words), rows shorter than a window and of one word, three rows of
    distinct content per launch, and a row that does not start on a
    16-byte boundary: bit for bit against the plain version, and sampled
    windows (the last ones included) against hashlib."""
    T = sliding_md5.TILE_WORDS
    R = 4 // stride
    for L in (T - 1, T, T + 1, T + w_words, max(w_words - 1, 1), 1):
        data = rng.integers(0, 2 ** 32, (3, L), dtype=np.uint32)
        words = torch.from_numpy(data).to(cuda)
        before = sliding_md5.LAUNCHES.value
        got = sliding_md5.sliding_md5_words(words, w_words, stride)
        assert sliding_md5.LAUNCHES.value == before + 1
        assert got.shape == (3, R, L)
        assert _equal(got, sliding_md5.sliding_plain(words, w_words, stride))
        host = got.cpu().numpy()
        for b in range(3):
            row = data[b].astype("<u4").view(np.uint8)
            for q in {0, L // 2, L - 1, max(L - w_words, 0)}:
                for i in range(R):
                    assert int(host[b, i, q]) == _window_a(
                        row, 4 * q + i * stride, 4 * w_words)
    # a view one word into a buffer: rows not on 16-byte boundaries
    data = torch.from_numpy(rng.integers(0, 2 ** 32, 2 * T + 9,
                                         dtype=np.uint32)).to(cuda)
    words = data[1:].view(1, 2 * T + 8)
    assert words.data_ptr() % 16
    assert _equal(sliding_md5.sliding_md5_words(words, w_words, stride),
                  sliding_md5.sliding_plain(words, w_words, stride))


def test_two_managers_on_one_card_write_and_read(cuda, rng):
    eng = CrystalGPU(devices=[cuda, cuda])
    try:
        assert all(s.stream is not None for s in eng._dev_states)
        assert eng._dev_states[0].stream != eng._dev_states[1].stream
        for ca in ("fixed", "cdc"):
            mgr, _ = make_store(4, replication=2)
            sai = SAI(mgr, SAIConfig(ca=ca, block_size=64 << 10,
                                     avg_chunk=64 << 10, min_chunk=16 << 10,
                                     max_chunk=256 << 10), crystal=eng)
            datas = [rng.integers(0, 256, 2 << 20, dtype=np.uint8).tobytes()
                     for _ in range(3)]
            futs = [sai.write_async("/f", d) for d in datas]
            for f in futs:
                f.result(timeout=120)
            for v, d in enumerate(datas):
                assert sai.read("/f", version=v) == d
            sai.close()
        assert eng.snapshot_stats()["launches"] > 0
    finally:
        eng.shutdown()


def test_forced_multi_device_sharding_cuda(cuda):
    """The JAX package's forced four-device sharding test on one card: a
    whale direct job split across four managers, each launching on its
    own stream; the shards' digests reassemble to hashlib's."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (16, 8192), np.uint8)
    ref = np.stack([np.frombuffer(
        hashlib.md5(r.tobytes()).digest(), np.uint8) for r in rows])
    eng = CrystalGPU(devices=[cuda] * 4, shard_min_bytes=32 << 10)
    try:
        assert len({s.stream for s in eng._dev_states}) == 4
        before = md5.LAUNCHES.value
        got = eng.submit("direct", rows, {}).wait()
        st = eng.snapshot_stats()
    finally:
        eng.shutdown()
    assert np.array_equal(got, ref)
    assert st["sharded_jobs"] == 1, st
    busy = [i for i, d in st["per_device"].items() if d["jobs"]]
    assert len(busy) >= 2, st["per_device"]
    assert md5.LAUNCHES.value - before == st["launches"] >= 2


@pytest.mark.parametrize("lens", [[1, 31, 32, 33, 4099], [1 << 20]])
def test_gear_kernel_matches_plain_and_cpu_gear(cuda, rng, lens):
    """Ragged rows (lengths under one window, not multiples of 4) stacked
    into one zero-padded launch: every kept position equals the plain
    version, and positions >= 31 equal the CPU baseline."""
    L = max(lens)
    rows = np.zeros((len(lens), L), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    data = torch.from_numpy(rows).to(cuda)
    before = gear.LAUNCHES.value
    got = gear.gear_bytes(data)
    assert gear.LAUNCHES.value == before + 1
    assert _equal(got, gear.gear_plain(data))
    host = got.cpu().numpy()
    for i, n in enumerate(lens):
        alone = ops.gear_hash(rows[i, :n].tobytes(), device=cuda)
        np.testing.assert_array_equal(host[i, :n], alone)
        np.testing.assert_array_equal(
            alone[31:], _cpu_gear(rows[i, :n].tobytes())[31:])
    with pytest.raises(ValueError):
        gear.gear_bytes(data, version=4)


def test_gear_shard_plan_reassembles(cuda, rng):
    buf = rng.integers(0, 256, (1 << 20) + 3, dtype=np.uint8)
    whole = ops.gear_hash(buf.tobytes(), device=cuda)
    plan = ops.stream_shard_plan(buf.size, "gear", 3)
    parts = [ops.gear_hash(buf[a:b].tobytes(), device=cuda)[d:]
             for a, b, d in plan]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_engine_gear_launches_exact_rows(cuda, rng):
    """A burst of gear jobs whose length is not a power of two: each
    result equals the plain version, and no launch hashes more than the
    burst's rows at the job's length."""
    n = (1 << 20) + 1
    bufs = [rng.integers(0, 256, n, dtype=np.uint8) for _ in range(3)]
    eng = CrystalGPU(devices=[cuda], coalesce_window_s=0.2)
    try:
        gear.LAUNCHES.reset()
        jobs = [eng.submit("gear", b, {"version": 1}) for b in bufs]
        for j, b in zip(jobs, bufs):
            np.testing.assert_array_equal(
                j.wait(), ops.gear_hash(b.tobytes(), device="cpu"))
        rows, width = gear.LAUNCHES.largest_shape
        assert width == n and rows <= len(bufs)
    finally:
        eng.shutdown()


# FastCDC's masks of the cas-gear configuration (perfbench/configs)
MASK_S, MASK_L = 0xD641C0D7, 0xD9000353


@pytest.mark.parametrize("R", [1, 2, 4])
def test_candidate_kernel_two_rules_matches_plain(cuda, R):
    """Gear hashes of random rows, a zero-filled row (where every
    position of a row of equal bytes meets a mask or none does) and rows
    cut short by n_off: the two-rule launch returns the plain version's
    codes and counts exactly, under FastCDC's masks and under masks loose
    enough that most windows meet one; the one-rule launch on the same
    hashes still returns the plain version's bare indices."""
    L = (1 << 18) + 12
    rows = np.random.default_rng(R).integers(0, 256, (4, L), dtype=np.uint8)
    rows[1] = 0
    hashes = gear.gear_bytes(torch.from_numpy(rows).to(cuda))
    Wc = L // R
    planes = hashes.view(-1)[:4 * R * Wc].view(4, R, Wc)
    n_off = [R * Wc, R * Wc, R * Wc - 1001, 7]
    for rules in ((MASK_S, 0, MASK_L, 0), (1 << 31, 0, 0x80000001, 1)):
        got, counts = candidates.boundary_candidates(planes, n_off, *rules)
        want, want_counts = candidates.candidates_plain(planes, n_off,
                                                        *rules)
        assert torch.equal(got, want)
        assert counts.tolist() == want_counts.tolist()
        k, first, second = candidates.decode(got.cpu().numpy())
        assert (first | second).all() and k.size == int(counts.sum())
    one, one_counts = candidates.boundary_candidates(planes, n_off, MASK_L,
                                                     0)
    want, want_counts = candidates.candidates_plain(planes, n_off, MASK_L, 0)
    assert torch.equal(one, want)
    assert one_counts.tolist() == want_counts.tolist()


def test_fastcdc_write_on_the_card_equals_cpu(cuda):
    """A FastCDC write through the engine on the card chunks as the
    host's gear and walk do, and counts the strict candidates."""
    img = np.random.default_rng(3).integers(0, 256, 4 << 20,
                                            dtype=np.uint8).tobytes()
    cfg = dict(ca="fastcdc", avg_chunk=8192, min_chunk=2048,
               max_chunk=65536, mask_s=MASK_S, mask_l=MASK_L)
    eng = CrystalGPU(devices=[cuda])
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(**cfg), crystal=eng)
    try:
        bounds = sai._boundaries(img)
        st = eng.snapshot_stats()
    finally:
        sai.close()
        eng.shutdown()
    cpu = SAI(make_store(4, replication=2)[0],
              SAIConfig(hasher="cpu", **cfg))
    assert bounds == cpu._boundaries(img)
    h = _cpu_gear(img)
    assert st["boundary_strict"] == np.count_nonzero((h & MASK_S) == 0)
    assert st["boundary_candidates"] == np.count_nonzero(
        ((h & MASK_S) == 0) | ((h & MASK_L) == 0))


# message lengths at MD5's padding edges and 64 KiB, the widest chunk of
# the benchmark's CDC configurations
SPAN_LENS = [1, 2, 3, 4, 5, 7, 8, 9, 51, 52, 53, 54, 55, 56, 57, 60, 61, 62,
             63, 64, 65, 66, 67, 68, 4095, 4096, 4097, 65535, 65536, 65537]


def _span_digests(out: torch.Tensor) -> list:
    host = out.view(torch.int32).cpu().numpy().astype("<u4")
    return [host[i].tobytes() for i in range(host.shape[0])]


def _image_words(img: np.ndarray, dev) -> torch.Tensor:
    padded = np.pad(img, (0, (-img.size) % 4))
    return torch.from_numpy(padded.view("<u4").copy()).to(dev)


def _hold_spans(img: np.ndarray, ends: np.ndarray, dev, rows: bool = True):
    """The spans entry over ``img`` cut at ``ends``, bit for bit against
    hashlib, its plain version (a sample of chunks) and md5_words on the
    chunks' pack_blocks rows."""
    from repro_torch.core.sai import block_digest_cpu, pack_blocks
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lens = (ends - starts).astype(np.int64)
    words = _image_words(img, dev)
    before = md5.SPAN_LAUNCHES.value
    got = md5.md5_spans(words, torch.from_numpy(starts),
                        torch.from_numpy(lens))
    torch.cuda.synchronize()
    assert md5.SPAN_LAUNCHES.value == before + 1
    digests = _span_digests(got)
    chunks = [img[a:b].tobytes() for a, b in zip(starts, ends)]
    assert digests == [block_digest_cpu(c) for c in chunks]
    pick = np.unique(np.concatenate([np.arange(min(64, lens.size)),
                                     np.argsort(lens)[-8:],
                                     [lens.size - 1]]))
    plain = md5.md5_spans_plain(words, torch.from_numpy(starts[pick]),
                                torch.from_numpy(lens[pick]))
    assert _span_digests(plain) == [digests[i] for i in pick]
    if rows:
        packed, row_lens = pack_blocks(chunks)
        dev_rows = torch.from_numpy(packed.view("<u4")).to(dev)
        want = md5.md5_words(dev_rows, torch.from_numpy(
            (row_lens // 4).astype(np.int32)))
        assert digests == _span_digests(want)


@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_md5_spans_kernel_at_every_residue(cuda, rng, residue):
    """Starts at each residue mod 4, every edge length, neighbours
    sharing a word, the last chunk ending off a word at the image's
    end."""
    ends = residue + np.cumsum(SPAN_LENS)
    img = rng.integers(0, 256, int(ends[-1]), dtype=np.uint8)
    ends = np.concatenate([[residue], ends]) if residue else ends
    _hold_spans(img, ends, cuda)
    # the image's last chunk ends 1-3 bytes into its last word
    for extra in (1, 2, 3):
        tail = rng.integers(0, 256, 4096 + extra, dtype=np.uint8)
        _hold_spans(tail, np.array([5, 2049, tail.size]), cuda)


@pytest.mark.parametrize("cell", ["cas-cdc", "cas-gear"])
def test_md5_spans_kernel_on_a_256_mib_image_cut_by_a_cell_rule(cuda,
                                                                cell):
    """One 256 MiB image of random bytes cut by the benchmark's LBFS
    (cas-cdc) or FastCDC (cas-gear) rule on the card."""
    img = np.random.default_rng(5).integers(0, 256, 256 << 20,
                                            dtype=np.uint8)
    cfg = dict(ca="cdc", window=48, stride=1, avg_chunk=8192,
               min_chunk=2048, max_chunk=65536) if cell == "cas-cdc" \
        else dict(ca="fastcdc", avg_chunk=8192, min_chunk=2048,
                  max_chunk=65536, mask_s=MASK_S, mask_l=MASK_L)
    eng = CrystalGPU(devices=[cuda])
    try:
        ends = np.asarray(SAI(make_store(4, replication=2)[0],
                              SAIConfig(**cfg), crystal=eng)
                          ._boundaries(img.tobytes()), np.int64)
    finally:
        eng.shutdown()
    assert ends[-1] == img.size and ends.size > 20000
    _hold_spans(img, ends, cuda)


def test_engine_spans_on_the_card_equal_rows_and_cpu_writes(cuda, rng):
    """Spans jobs fused on the card equal the row jobs of the same
    chunks; writes through the card's engine give the block maps of
    hasher='cpu', launching the spans entry and no row launch."""
    from repro_torch.core.sai import pack_blocks
    eng = CrystalGPU(devices=[cuda], coalesce_window_s=0.2)
    try:
        images = []
        for _ in range(4):
            ends = np.cumsum(rng.integers(1, 70000, 50))
            images.append((rng.integers(0, 256, int(ends[-1]),
                                        dtype=np.uint8), ends))
        spans = [eng.submit("direct", img, {"ends": ends})
                 for img, ends in images]
        for job, (img, ends) in zip(spans, images):
            rows, lens = pack_blocks([c.tobytes()
                                      for c in np.split(img, ends[:-1])])
            np.testing.assert_array_equal(
                job.wait(), eng.submit("direct", rows,
                                       {"lens": lens}).wait())
        cfg = dict(ca="fastcdc", avg_chunk=8192, min_chunk=2048,
                   max_chunk=65536, mask_s=MASK_S, mask_l=MASK_L)
        data = [rng.integers(0, 256, 8 << 20, dtype=np.uint8).tobytes()
                for _ in range(2)]
        maps = []
        for hasher in ("gpu", "cpu"):
            mgr, _ = make_store(4, replication=2)
            sai = SAI(mgr, SAIConfig(hasher=hasher, **cfg), crystal=eng)
            l0, s0 = md5.LAUNCHES.value, md5.SPAN_LAUNCHES.value
            for d in data:
                sai.write_async("/f", d).result(timeout=120)
            sai.close()
            if hasher == "gpu":                 # one launch a write
                assert md5.SPAN_LAUNCHES.value - s0 == len(data)
            assert md5.LAUNCHES.value == l0         # no row launch
            maps.append([[(b.digest, b.length) for b in fv.blocks]
                         for fv in mgr.files["/f"]])
        assert maps[0] == maps[1]
    finally:
        eng.shutdown()


def _plain_dropping(q, k, v, lo, hi):
    """The plain version with keys [lo, hi) left out: what a kernel that
    lost that key tile would return."""
    S, Sk, hd = q.shape[1], k.shape[1], q.shape[2]
    keep = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(S, device=q.device)[:, None]
    keep[:, lo:hi] = False
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    s = torch.where(keep[None], s, flash_attn.NEG)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())


# f32: 2e-5 as the JAX package's flash tests state it (sums taken in
# another order).  bf16 and f16: the kernel rounds P to the type before
# P.V, as the reference does, and the output to the type;
# flash_attn.flash_bf16_bound derives the per-element bound from those two
# roundings: |got - want| <= u |want| + u (P |V|) / l + 3e-5, u = 2**-8
# for bf16 and 2**-11 for f16.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("S,Sk,hd,bq,bk", [(256, 256, 64, 64, 128),
                                           (512, 512, 32, 128, 256),
                                           (128, 128, 128, 128, 128),
                                           (320, 192, 128, 64, 64),
                                           (192, 448, 64, 64, 64),
                                           (192, 320, 32, 64, 64),
                                           (320, 64, 64, 64, 64),
                                           (448, 704, 128, 64, 64)])
def test_flash_kernel_matches_plain(cuda, S, Sk, hd, bq, bk, dtype):
    """The kernel of each dtype against its plain version on the same
    inputs, ragged lengths and Sk != S both ways included; in bf16 and
    f16 the plain version with one key tile dropped must fail the
    bound."""
    g = torch.Generator(device=cuda).manual_seed(S + Sk + hd)
    q, k, v = (torch.randn((3, n, hd), generator=g, device=cuda).to(dtype)
               for n in (S, Sk, Sk))
    before = flash_attn.LAUNCHES.value
    got = flash_attn.flash_attention_fwd(q, k, v, bq=bq, bk=bk)
    assert flash_attn.LAUNCHES.value == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attn.flash_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        return
    bound = flash_attn.flash_bf16_bound(q, k, v, want)
    assert bool(torch.isfinite(got.float()).all())
    assert bool(((got.float() - want).abs() <= bound).all())
    if Sk > 64:
        lost = _plain_dropping(q, k, v, 64, 128)
        assert not bool(((lost - want).abs() <= bound).all())


@pytest.mark.parametrize("S,Sk,hd", [(256, 256, 64), (320, 192, 128),
                                     (192, 448, 64), (704, 320, 32),
                                     (64, 5, 32)])
def test_tf32_split_kernel_matches_plain(cuda, S, Sk, hd):
    """The f32 kernel's pre-pass bit for bit against its plain version:
    the TF32 hi and lo planes of q and k, and vT with its key permutation
    and zeros past Sk (ragged Sk included)."""
    g = torch.Generator(device=cuda).manual_seed(S + Sk + hd)
    q, k, v = (torch.randn((3, n, hd), generator=g, device=cuda)
               for n in (S, Sk, Sk))
    before = flash_attn.SPLIT_LAUNCHES.value
    got = flash_attn.tf32_split(q, k, v)
    assert flash_attn.SPLIT_LAUNCHES.value == before + 1
    want = flash_attn.tf32_split_plain(q, k, v)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _equal(a, b)


@pytest.mark.parametrize("S", [16384, 32768])
def test_flash_f32_long_rows_within_2e5(cuda, S):
    """The 3xTF32 kernel keeps O as one chain of tensor-core products over
    every key tile of a row, so its error grows with the row: one head of
    S = Sk keys against the plain version with TF32 off, at 2e-5."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, 128), generator=g, device=cuda)
               for _ in range(3))
    got = flash_attn.flash_attention_fwd(q, k, v)
    want = flash_attn.flash_plain(q, k, v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hd,dtype", [(48, torch.float32),
                                      (128, torch.float64),
                                      (16, torch.float16)])
def test_flash_cuda_raises_where_no_kernel(cuda, hd, dtype):
    """A CUDA tensor of a head dim or dtype the kernels lack raises; it
    never falls back to the plain version."""
    q = torch.zeros((1, 128, hd), dtype=dtype, device=cuda)
    before = flash_attn.LAUNCHES.value
    with pytest.raises(ValueError):
        flash_attn.flash_attention_fwd(q, q, q)
    assert flash_attn.LAUNCHES.value == before


def test_flash_f32_launches_the_split_and_the_kernel_once(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 256, 128), generator=g, device=cuda)
               for _ in range(3))
    split, main = flash_attn.SPLIT_LAUNCHES.value, flash_attn.LAUNCHES.value
    flash_attn.flash_attention_fwd(q, k, v, bq=128, bk=128)
    assert flash_attn.SPLIT_LAUNCHES.value == split + 1
    assert flash_attn.LAUNCHES.value == main + 1
