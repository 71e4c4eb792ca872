"""The traffic generator: the repository's checkpoint series, the same
bytes for the same seed, every version of one length."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from perfbench import traffic  # noqa: E402


def original_series(n_images, image_bytes, change_frac=0.15, seed=0):
    """benchmarks/common.py:checkpoint_series as it stands."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, image_bytes, dtype=np.uint8)
    out = [img.tobytes()]
    for i in range(1, n_images):
        buf = bytearray(img.tobytes())
        span = int(image_bytes * change_frac)
        start = int(rng.integers(0, len(buf) - span))
        buf[start:start + span] = rng.integers(
            0, 256, span, dtype=np.uint8).tobytes()
        k = int(rng.integers(1, 4096))
        ins = int(rng.integers(0, len(buf)))
        buf[ins:ins] = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        del_at = int(rng.integers(0, len(buf) - k))
        del buf[del_at:del_at + k]
        img = np.frombuffer(bytes(buf), dtype=np.uint8)
        out.append(bytes(buf))
    return out


@pytest.mark.parametrize("seed", [0, 1, 17, 2 ** 31 + 11, 6_000_000_007])
@pytest.mark.parametrize("size,frac", [(3000, 0.4), (20000, 0.15)])
def test_series_equals_the_original(seed, size, frac):
    want = original_series(5, size, frac, seed)
    got = traffic.checkpoint_series(5, size, frac, 4095, seed)
    assert [g.tobytes() for g in got] == want


def test_same_seed_same_bytes_and_lengths():
    a = traffic.checkpoint_series(4, 50000, 0.15, 4095, 99)
    b = traffic.checkpoint_series(4, 50000, 0.15, 4095, 99)
    c = traffic.checkpoint_series(4, 50000, 0.15, 4095, 100)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert {x.size for x in a + c} == {50000}


def test_op_versions():
    w = {"op": "write", "series": {"versions": 3}}
    r = {"op": "read", "series": {"versions": 8}}
    gw = traffic.op_versions(w, 5)
    assert [next(gw) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    first = [next(traffic.op_versions(r, 5)) for _ in range(1)]
    g1, g2 = traffic.op_versions(r, 5), traffic.op_versions(r, 5)
    s1 = [next(g1) for _ in range(50)]
    assert s1 == [next(g2) for _ in range(50)] and first == s1[:1]
    assert set(s1) <= set(range(8)) and len(set(s1)) > 4
