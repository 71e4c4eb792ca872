"""Gear rolling-hash kernel of the port (``repro_torch.kernels``) against
the JAX package (``repro.kernels``: ``ops.gear_hash`` through the Pallas
kernel in interpret mode, in each of its three versions, and the
``ref.gear_ref`` oracle) and the CPU baseline ``_cpu_gear``.  On the CPU
the port runs the kernel's plain version; the CUDA kernel is compared
with it on the card in ``test_torch_kernels_cuda.py``.  Every
comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypcompat import given, settings, strategies as st

from repro.core.sai import _cpu_gear as ref_cpu_gear
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.sai import _cpu_gear
from repro_torch.kernels import gear, ops, ref

CPU = torch.device("cpu")


@pytest.mark.parametrize("version", [1, 2, 3])
def test_gear_equals_reference_at_every_position(rng, version):
    """The port equals the JAX package's kernel at every position, the
    zero-byte history of positions < 31 included, for every reference
    kernel body."""
    buf = rng.integers(0, 256, 5000, dtype=np.uint8)
    got = ops.gear_hash(buf.tobytes(), version=version, device=CPU)
    assert got.shape == (5000,) and got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, jops.gear_hash(buf.tobytes(), version=version))


def test_gear_vs_ref_and_cpu_baseline(rng):
    """From position 31 on, the kernel equals the oracle and the CPU
    baseline (whose history contributes 0); below, only the history
    convention differs."""
    buf = rng.integers(0, 256, 3000, dtype=np.uint8)
    got = ops.gear_hash(buf.tobytes(), device=CPU)
    want = np.asarray(jref.gear_ref(jnp.asarray(buf)))
    port_ref = ref.gear_ref(torch.from_numpy(buf)).numpy()
    np.testing.assert_array_equal(port_ref, want)
    np.testing.assert_array_equal(got[31:], want[31:])
    np.testing.assert_array_equal(_cpu_gear(buf.tobytes()), want)
    np.testing.assert_array_equal(_cpu_gear(buf.tobytes()),
                                  ref_cpu_gear(buf.tobytes()))
    assert not np.array_equal(got[:31], want[:31])


def test_gear_vs_sequential_recurrence(rng):
    """The convolution form == the FastCDC h=(h<<1)+g recurrence."""
    buf = rng.integers(0, 256, 1000, dtype=np.uint8)
    seq = _cpu_gear(buf.tobytes(), vectorized=False)
    np.testing.assert_array_equal(_cpu_gear(buf.tobytes()), seq)
    np.testing.assert_array_equal(
        ops.gear_hash(buf.tobytes(), device=CPU)[31:], seq[31:])


@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, 1001, 4099])
def test_gear_lengths(rng, L):
    """Lengths under one window and not multiples of 4."""
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    got = ops.gear_hash(buf.tobytes(), device=CPU)
    assert got.shape == (L,)
    np.testing.assert_array_equal(got, jops.gear_hash(buf.tobytes()))


def test_gear_ragged_batch_in_one_call(rng):
    """Ragged rows zero-padded at the end and hashed in one call: every
    kept position equals the row hashed alone (the hash is causal)."""
    lens = [1, 31, 33, 250, 1027]
    rows = np.zeros((len(lens), max(lens)), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    out = gear.gear_bytes(torch.from_numpy(rows)).numpy()
    assert out.shape == rows.shape and out.dtype == np.uint32
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(
            out[i, :n], jops.gear_hash(rows[i, :n].tobytes()))


def test_gear_window_property(rng):
    """h at position p depends only on bytes (p-31 .. p)."""
    L = 600
    a = rng.integers(0, 256, L, dtype=np.uint8)
    b = a.copy()
    b[:L - 64] = rng.integers(0, 256, L - 64, dtype=np.uint8)
    ha = ops.gear_hash(a.tobytes(), device=CPU)
    hb = ops.gear_hash(b.tobytes(), device=CPU)
    np.testing.assert_array_equal(ha[L - 32:], hb[L - 32:])


def test_gear_shard_plan_reassembles(rng):
    """Shards that start 32 bytes early, at any byte offset, and drop 32
    outputs concatenate to the unsharded output."""
    buf = rng.integers(0, 256, 4099, dtype=np.uint8)
    whole = ops.gear_hash(buf.tobytes(), device=CPU)
    plan = ops.stream_shard_plan(buf.size, "gear", 3)
    assert len(plan) == 3 and any(a % 4 for a, _, _ in plan)
    parts = [ops.gear_hash(buf[a:b].tobytes(), device=CPU)[d:]
             for a, b, d in plan]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_gear_rejects_unknown_version_and_bad_input():
    data = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="version"):
        gear.gear_bytes(data, version=4)
    with pytest.raises(ValueError):
        gear.gear_bytes(data.view(torch.int8))
    with pytest.raises(ValueError):
        gear.gear_bytes(data[0])


@settings(max_examples=10, deadline=None)
@given(st.binary(min_size=1, max_size=2048))
def test_gear_hypothesis_matches_reference(data):
    """Every position against the reference's CPU baseline with the
    zero-byte history written out in front (numpy, so that no length
    compiles a kernel), and positions >= 31 against the port's oracle."""
    got = ops.gear_hash(data, device=CPU)
    np.testing.assert_array_equal(got, ref_cpu_gear(bytes(31) + data)[31:])
    want = ref.gear_ref(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    np.testing.assert_array_equal(got[31:], want.numpy()[31:])
