"""Direct-MD5 kernel of the port (``repro_torch.kernels.md5``) against
``hashlib`` and the JAX package (``repro.kernels``: the Pallas kernel in
interpret mode and its pure-jnp oracle).  On the CPU the port runs the
kernel's plain version; the CUDA kernel itself is compared with it on
the card in ``test_torch_kernels_cuda.py``.  Every comparison is exact:
the outputs are integer hashes."""
import hashlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, md5, ops, ref

CPU = torch.device("cpu")


@pytest.mark.parametrize("seg_bytes", [64, 128, 512, 1024, 4096, 16384])
def test_direct_hash_vs_hashlib_and_reference(rng, seg_bytes):
    N = 5
    segs = rng.integers(0, 256, (N, seg_bytes), dtype=np.uint8)
    digs = ops.direct_hash(segs, device=CPU)
    for i in range(N):
        assert digs[i].tobytes() == hashlib.md5(segs[i].tobytes()).digest()
    np.testing.assert_array_equal(digs, jops.direct_hash(segs))


def test_direct_hash_ragged_lengths(rng):
    seg, N = 2048, 9
    segs = rng.integers(0, 256, (N, seg), dtype=np.uint8)
    lens = (rng.integers(1, seg // 4 + 1, N) * 4).astype(np.int64)
    digs = ops.direct_hash(segs, lens, device=CPU)
    for i in range(N):
        want = hashlib.md5(segs[i, :lens[i]].tobytes()).digest()
        assert digs[i].tobytes() == want
    np.testing.assert_array_equal(digs, jops.direct_hash(segs, lens))


def test_plain_matches_reference_oracle_and_pallas(rng):
    """Same word input through the port's plain version, the JAX oracle
    and the Pallas kernel (which needs lens <= W - 3)."""
    from repro.kernels.md5 import md5_pallas
    N, W = 128, 64
    data = rng.integers(0, 2 ** 32, (N, W), dtype=np.uint32)
    lens = rng.integers(1, W - 2, N).astype(np.int32)
    got = md5.md5_words(torch.from_numpy(data), torch.from_numpy(lens))
    assert got.dtype == torch.uint32 and got.shape == (N, 4)
    want = np.asarray(jref.md5_words_ref(jnp.asarray(data),
                                         jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(md5_pallas(jnp.asarray(data.T),
                                   jnp.asarray(lens))).T
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_message_may_fill_its_row(rng):
    """The port needs no spare words: lens == W is hashed right."""
    N, W = 7, 33
    data = rng.integers(0, 2 ** 32, (N, W), dtype=np.uint32)
    lens = np.full((N,), W, np.int32)
    lens[1:3] = (0, 1)
    got = md5.md5_words(torch.from_numpy(data),
                        torch.from_numpy(lens)).numpy()
    for i in range(N):
        want = hashlib.md5(data[i, :lens[i]].astype("<u4").tobytes())
        assert got[i].astype("<u4").tobytes() == want.digest()


def test_lengths_past_the_row_are_refused():
    words = torch.zeros((2, 8), dtype=torch.uint32)
    with pytest.raises(ValueError):
        md5.md5_words(words, torch.tensor([8, 9], dtype=torch.int32))


def test_batch_padding_lanes(rng):
    segs = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    digs = ops.direct_hash(segs, device=CPU)
    assert digs.shape == (3, 16)
    for i in range(3):
        assert digs[i].tobytes() == hashlib.md5(segs[i].tobytes()).digest()


def test_hash_blocks_final_digest(rng):
    data = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    digs, final = ops.hash_blocks(data, 4096, device=CPU)
    assert digs.shape[0] == 13
    assert final == hashlib.md5(digs.tobytes()).digest()
    assert digs[0].tobytes() == hashlib.md5(data[:4096]).digest()
    jdigs, jfinal = jops.hash_blocks(data, 4096)
    np.testing.assert_array_equal(digs, jdigs)
    assert final == jfinal


def test_empty_and_single_word():
    segs = np.zeros((1, 4), np.uint8)
    digs = ops.direct_hash(segs, np.array([4]), device=CPU)
    assert digs[0].tobytes() == hashlib.md5(b"\x00" * 4).digest()
    digs = ops.direct_hash(segs, np.array([0]), device=CPU)
    assert digs[0].tobytes() == hashlib.md5(b"").digest()
    assert ref.md5_hex_ref(b"abcd" * 3) == \
        hashlib.md5(b"abcd" * 3).hexdigest()


def test_cpu_tensor_never_builds_the_kernel(monkeypatch, rng):
    def no_build():
        raise AssertionError("a CPU tensor must take the plain version")
    monkeypatch.setattr(_build, "library", no_build)
    before = md5.LAUNCHES.value
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (4, 16),
                                          dtype=np.uint32))
    md5.md5_words(words, torch.full((4,), 16, dtype=torch.int32))
    assert md5.LAUNCHES.value == before


def test_cuda_source_constants_match_md5():
    """The round constants written into the CUDA source are MD5's."""
    src = (Path(_build.CSRC) / "md5_core.cuh").read_text()
    table = src[src.index("kMd5K[64]"):src.index("};")]
    consts = [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", table)]
    assert tuple(consts) == ref.MD5_K

