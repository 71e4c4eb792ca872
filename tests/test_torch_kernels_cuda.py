"""The port's CUDA kernels and engine on the card: each kernel against its
plain version and ``hashlib``, bit for bit, and two managers sharing one
card through their own streams.  Every test here needs an NVIDIA GPU and
``nvcc``; without them it skips.  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``
(this file imports neither JAX nor the JAX package)."""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
from repro_torch.kernels import md5, ops, sliding_md5

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
