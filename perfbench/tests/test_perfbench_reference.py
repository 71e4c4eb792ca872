"""The plain reference against hashlib and RFC 1321's test vectors, its
chunking rule on hand-made candidates, and the frozen instruction
counts of the roofline."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from perfbench import reference, roofline  # noqa: E402

RFC1321 = {
    b"": "d41d8cd98f00b204e9800998ecf8427e",
    b"a": "0cc175b9c0f1b6a831c399e269772661",
    b"abc": "900150983cd24fb0d6963f7d28e17f72",
    b"message digest": "f96b697d7cb7938d525a2f31aaf161d0",
    b"abcdefghijklmnopqrstuvwxyz": "c3fcd3d76192e4007dfb496cca67e13b",
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789":
        "d174ab98d277d9f5a5611c2c9f419d9f",
    b"1234567890" * 8: "57edf4a22be3c955ac49da2e2107b67a",
}


def md5_plain(msg: bytes) -> str:
    """Whole-message MD5 from the reference's compression."""
    n = len(msg)
    padded = msg + b"\x80" + b"\x00" * (-(n + 9) % 64) \
        + (8 * n).to_bytes(8, "little")
    state = reference.INIT
    for o in range(0, len(padded), 64):
        words = [int.from_bytes(padded[o + 4 * j:o + 4 * j + 4], "little")
                 for j in range(16)]
        state = reference.md5_compress(state, words)
    return b"".join(int(x).to_bytes(4, "little") for x in state).hex()


@pytest.mark.parametrize("msg", list(RFC1321))
def test_compression_gives_rfc1321_vectors(msg):
    assert md5_plain(msg) == RFC1321[msg]


def hashlib_window(img: np.ndarray, start: int, window: int) -> int:
    d = hashlib.md5(img[start:start + window].tobytes()).digest()
    return int.from_bytes(d[:4], "little")


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("window", [4, 16, 48, 52])
def test_window_hashes_equal_hashlib(window, stride):
    img = np.random.default_rng(window + stride).integers(
        0, 256, 777, dtype=np.uint8)
    got = reference.window_hashes(torch.from_numpy(img), window, stride)
    n = reference.n_windows(img.size, window, stride)
    assert got.numel() == n
    assert got.tolist() == [hashlib_window(img, i * stride, window)
                            for i in range(n)]


def test_window_hashes_in_blocks(monkeypatch):
    img = np.random.default_rng(3).integers(0, 256, 5000, dtype=np.uint8)
    data = torch.from_numpy(img)
    whole = reference.window_hashes(data, 48, 1)
    mask = reference.boundary_mask(64)
    want = (torch.nonzero((whole & mask) == 0).flatten().numpy() + 48)
    monkeypatch.setattr(reference, "BLOCK", 333)
    assert reference.chunk_candidates(data, 48, 1, 64).tolist() \
        == want.tolist()


def test_short_input_has_no_windows():
    data = torch.zeros(47, dtype=torch.uint8)
    assert reference.window_hashes(data, 48, 1).numel() == 0
    assert reference.chunk_bounds(data.numpy(), {
        "ca": "cdc", "window": 48, "stride": 1, "avg_chunk": 64,
        "min_chunk": 16, "max_chunk": 256}, "cpu") == [47]


def test_cdc_boundaries_rule():
    # candidates closer than min to the last end are skipped, gaps over
    # max are cut at max, the tail too
    assert reference.cdc_boundaries([5, 12, 30, 31, 100], 130, 10, 40) \
        == [12, 30, 70, 100, 130]
    assert reference.cdc_boundaries([], 100, 10, 40) == [40, 80, 100]
    assert reference.cdc_boundaries([0, 100], 100, 10, 400) == [100]


def test_fixed_boundaries_and_block_digest():
    assert reference.fixed_boundaries(10, 4) == [4, 8, 10]
    assert reference.fixed_boundaries(8, 4) == [4, 8]
    assert reference.fixed_boundaries(0, 4) == []
    data = b"hello"
    assert reference.block_digest(data) == hashlib.md5(
        b"hello\0\0\0" + (5).to_bytes(4, "little")).digest()
    img = np.frombuffer(b"abcdefghij", np.uint8)
    assert reference.block_digests(img, [4, 10]) == [
        reference.block_digest(b"abcd"), reference.block_digest(b"efghij")]


def test_dedup_counts():
    d = [[b"a", b"b"], [b"a", b"c", b"c"], [b"b"]]
    lens = [[1, 2], [1, 3, 3], [2]]
    assert reference.dedup_counts(d, lens) == [(2, 0, 3), (1, 2, 3),
                                               (0, 1, 0)]


def test_frozen_instruction_counts():
    assert roofline.ops_per_compression() == 324
    assert roofline.sliding_ops(12) == 224
    assert [roofline.message_word(i) for i in range(64)] == \
        [reference.message_word(i) for i in range(64)]


def test_roofline_work():
    # a 1 MiB block: its message is 1 MiB + 4 B, 16385 compressions
    ops, nbytes = roofline.md5_direct_work([1 << 20])
    assert nbytes == (1 << 20) + 4 + 16
    assert ops == 324 * (((1 << 20) + 4 + 9 + 63) // 64)
    ops, nbytes = roofline.sliding_work(1000, 48, 1)
    assert ops == 224 * 953 and nbytes == 1000 + 4 * 953
    # H100 SXM: 132 SMs at 1980 MHz issue 33.45 T integer ops a second
    t = roofline.least_seconds(33.45e12, 0.0, 132, 1.98e9)
    assert t == pytest.approx(1.0, rel=1e-3)
    assert roofline.least_seconds(0.0, 3.35e12, 132, 1.98e9) == 1.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_window_hashes_on_the_card_equal_the_cpu(card):
    img = np.random.default_rng(5).integers(0, 256, 1 << 20, dtype=np.uint8)
    cpu = reference.window_hashes(torch.from_numpy(img), 48, 1)
    dev = reference.window_hashes(torch.from_numpy(img).to(card), 48, 1)
    assert torch.equal(cpu, dev.cpu())
