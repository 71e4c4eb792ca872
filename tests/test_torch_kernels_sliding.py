"""Sliding-window MD5 kernel of the port (``repro_torch.kernels``)
against per-window ``hashlib`` and the JAX package (``repro.kernels``:
the Pallas kernel in interpret mode, its strip builder and its oracle).
On the CPU the port runs the kernel's plain version; the CUDA kernel is
compared with it on the card in ``test_torch_kernels_cuda.py``.  Every
comparison is exact."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, sliding_md5

CPU = torch.device("cpu")


def _md5_a(buf: np.ndarray) -> int:
    return int.from_bytes(hashlib.md5(buf.tobytes()).digest()[:4], "little")


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_sliding_vs_hashlib_and_reference(rng, stride):
    L, w = 2500, 48
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    h = ops.sliding_window_hash(buf.tobytes(), window=w, stride=stride,
                                device=CPU)
    n_off = (L - w) // stride + 1
    assert h.shape == (n_off,) and h.dtype == np.uint32
    for o in list(rng.integers(0, n_off, 12)) + [0, n_off - 1]:
        bo = int(o) * stride
        assert int(h[o]) == _md5_a(buf[bo:bo + w]), (stride, o)
    np.testing.assert_array_equal(
        h, jops.sliding_window_hash(buf.tobytes(), window=w, stride=stride))


@pytest.mark.parametrize("window", [16, 32, 48])
def test_sliding_window_sizes(rng, window):
    L = 1200
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    h = ops.sliding_window_hash(buf.tobytes(), window=window, stride=4,
                                device=CPU)
    for o in [0, 7, (L - window) // 4]:
        assert int(h[o]) == _md5_a(buf[o * 4:o * 4 + window])
    np.testing.assert_array_equal(
        h, jops.sliding_window_hash(buf.tobytes(), window=window, stride=4))


def test_sliding_matches_ref(rng):
    L = 800
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    got = ops.sliding_window_hash(buf.tobytes(), window=48, stride=1,
                                  device=CPU)
    want = np.asarray(jref.sliding_md5_ref(jnp.asarray(buf), 48, 1))
    np.testing.assert_array_equal(got, want)
    port_ref = ref.sliding_md5_ref(torch.from_numpy(buf), 48, 1)
    np.testing.assert_array_equal(port_ref.numpy(), want)


def test_short_input_hashes_empty():
    for data in (b"", b"tiny", bytes(47)):
        assert ops.sliding_window_hash(data, 48, 4, device=CPU).shape == \
            (0,)
    assert ops.sliding_window_hash(bytes(48), 48, 4, device=CPU).shape == \
        (1,)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_phase_matrix_matches_reference_layout(rng, stride):
    """The [B, R, L] phase-major output of the kernel's plain version is
    the JAX wrapper's [B, R, Wc] output cut to the row width, and the
    plain version's strips are the JAX strip builder's."""
    B, L, ww = 3, 300, 12
    words = rng.integers(0, 2 ** 32, (B, L), dtype=np.uint32)
    phases = sliding_md5.phases_for(stride)
    got = sliding_md5.sliding_md5_words(torch.from_numpy(words), ww, stride)
    assert got.shape == (B, len(phases), L) and got.dtype == torch.uint32
    want = np.asarray(jops.sliding_hash_batch_device(
        jnp.asarray(words), ww, phases))
    np.testing.assert_array_equal(got.numpy(), want[:, :, :L])
    strips = sliding_md5.byte_phase_strips(torch.from_numpy(words), phases,
                                           5)
    jstrips = np.asarray(jops._byte_phase_strips_batch(
        jnp.asarray(words), phases, 5))
    np.testing.assert_array_equal(strips.numpy(), jstrips)


def test_bad_arguments_raise():
    words = torch.zeros((1, 8), dtype=torch.uint32)
    with pytest.raises(ValueError):
        sliding_md5.sliding_md5_words(words, 14, 4)
    with pytest.raises(ValueError):
        sliding_md5.sliding_md5_words(words, 12, 3)
    with pytest.raises(ValueError):
        ops.sliding_window_hash(bytes(64), window=50, stride=4, device=CPU)

