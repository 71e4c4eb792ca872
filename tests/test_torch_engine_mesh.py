"""The port's engine mesh (``repro_torch.core.crystal.CrystalGPU``) on
host devices, mirroring the JAX package's ``tests/test_engine_mesh.py``:
whale-job sharding, load-aware dispatch, adaptive fusion, manager crash
recovery, per-device stats.

A device listed n times gives n managers, each with its own lane queue
(and on a card its own stream), so ``devices=[cpu] * 4`` runs the mesh's
scheduling logic as four devices would.  Where a count of shards or
manager restarts does not depend on timing, the JAX package's
``CrystalTPU`` runs the same job stream and must give the same count.
Stream hashes are held against the JAX package's ``ops``.

The port's plain MD5 on the CPU takes about 60 ms per KiB of row width
(the reference's interpret-mode kernel is much faster), so the tests
whose assertions ride on launch latencies submit smaller rows than the
reference's: the load-aware test 32-byte rows (its 50 ms skew must not
drown in the hashing), the adaptive-caps tests rows of 64 bytes and of
1, 2 and 4 KiB in place of 4 KiB and 16, 32 and 64 KiB.  Every
assertion is the reference's."""
import hashlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.crystal import CrystalTPU
from repro.kernels import ops
from repro_torch.core.crystal import CrystalGPU

CPU = torch.device("cpu")


def _mesh(n=4, **kw):
    return CrystalGPU(devices=[CPU] * n, **kw)


def _ref_mesh(n=4, **kw):
    return CrystalTPU(devices=[jax.devices()[0]] * n, **kw)


def _md5_rows(rows):
    return np.stack([np.frombuffer(hashlib.md5(r.tobytes()).digest(),
                                   np.uint8) for r in rows])


def _shard_counts(make, submit):
    """(sharded_jobs, shards) of one engine over ``submit(engine)``."""
    eng = make()
    try:
        submit(eng)
        st = eng.snapshot_stats()
        return st["sharded_jobs"], st["shards"]
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# sharding: digests must be byte-identical to the unsharded reference
# ---------------------------------------------------------------------

def test_sharded_direct_digest_equality():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (16, 8192), np.uint8)
    eng = _mesh(4, shard_min_bytes=32 << 10)
    try:
        got = eng.submit("direct", rows, {}).wait()
        assert np.array_equal(got, _md5_rows(rows))
        st = eng.snapshot_stats()
        assert st["sharded_jobs"] == 1
        assert st["shards"] >= 2
        busy = [d for d in st["per_device"].values() if d["jobs"]]
        assert len(busy) >= 2, st["per_device"]
    finally:
        eng.shutdown()
    # the shard plan depends on sizes and the mesh only: same counts
    ref = _shard_counts(lambda: _ref_mesh(4, shard_min_bytes=32 << 10),
                        lambda e: e.submit("direct", rows, {}).wait())
    assert (st["sharded_jobs"], st["shards"]) == ref


def test_sharded_stream_digest_equality():
    rng = np.random.default_rng(1)
    sbuf = rng.integers(0, 256, (64 << 10) + 17, np.uint8)
    gbuf = rng.integers(0, 256, (160 << 10) + 5, np.uint8)
    eng = _mesh(4, shard_min_bytes=16 << 10)
    try:
        sj = eng.submit("sliding", sbuf, {"window": 48, "stride": 4})
        gj = eng.submit("gear", gbuf, {})
        assert np.array_equal(
            sj.wait(), ops.sliding_window_hash(sbuf.tobytes(), 48, 4))
        assert np.array_equal(gj.wait(),
                              ops.gear_hash(gbuf.tobytes()))
        st = eng.snapshot_stats()
        assert st["sharded_jobs"] == 2
    finally:
        eng.shutdown()

    def submit(e):
        e.submit("sliding", sbuf, {"window": 48, "stride": 4}).wait()
        e.submit("gear", gbuf, {}).wait()

    ref = _shard_counts(lambda: _ref_mesh(4, shard_min_bytes=16 << 10),
                        submit)
    assert (st["sharded_jobs"], st["shards"]) == ref


def test_small_jobs_do_not_shard():
    eng = _mesh(2, shard_min_bytes=1 << 20)
    try:
        rows = np.zeros((4, 1024), np.uint8)
        assert np.array_equal(eng.submit("direct", rows, {}).wait(),
                              _md5_rows(rows))
        assert eng.snapshot_stats()["sharded_jobs"] == 0
    finally:
        eng.shutdown()
    ref = _shard_counts(lambda: _ref_mesh(2, shard_min_bytes=1 << 20),
                        lambda e: e.submit("direct", rows, {}).wait())
    assert ref == (0, 0)


# ---------------------------------------------------------------------
# load-aware dispatch: a slow device receives less work
# ---------------------------------------------------------------------

def test_load_aware_dispatch_skews_away_from_slow_device():
    eng = _mesh(4, coalesce=False)
    eng._launch_hook = lambda idx, batch: (time.sleep(0.05)
                                           if idx == 0 else None)
    total = 30
    try:
        jobs = []
        for _ in range(total):
            jobs.append(eng.submit(
                "direct", np.ones((1, 32), np.uint8), {}))
            time.sleep(0.01)       # pace so backlog signals can develop
        for j in jobs:
            j.wait()
        per = eng.snapshot_stats()["per_device"]
        assert sum(d["jobs"] for d in per.values()) == total
        assert per[0]["jobs"] < total / 3, {
            i: d["jobs"] for i, d in per.items()}
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# adaptive fusion: caps move in the direction the measurements demand
# ---------------------------------------------------------------------

def test_adaptive_caps_grow_under_launch_overhead():
    """Tiny same-size jobs + injected fixed launch latency = overhead-
    dominated regime: the policy should open the fusion caps."""
    eng = _mesh(1, adaptive_fusion=True, max_fused_rows=4,
                max_fused_bytes=64 << 10)
    eng._launch_hook = lambda idx, batch: time.sleep(0.008)
    try:
        for _ in range(12):
            eng.submit("direct", np.ones((1, 64), np.uint8),
                       {}).wait()
        assert eng.max_fused_bytes > 64 << 10
        assert eng.max_fused_rows > 4
        pol = eng.snapshot_stats()["policy"]
        assert pol["adaptive"] == 1
        assert pol["max_fused_bytes"] == eng.max_fused_bytes
    finally:
        eng.shutdown()


def test_adaptive_caps_shrink_under_latency_target():
    """Varied job sizes + injected per-byte latency teach the cost model
    a real slope; the target launch latency then bounds the byte cap
    below the static guess."""
    eng = _mesh(1, adaptive_fusion=True, max_fused_rows=64,
                max_fused_bytes=1 << 20, target_launch_s=0.1)
    eng._launch_hook = lambda idx, batch: time.sleep(
        3e-6 * sum(j.padded_bytes for j in batch))
    try:
        for _ in range(8):
            for kb in (1, 2, 4):
                eng.submit("direct",
                           np.ones((1, kb << 10), np.uint8), {}).wait()
        assert eng.max_fused_bytes < 1 << 20, eng.max_fused_bytes
    finally:
        eng.shutdown()


def test_static_mode_caps_never_move():
    eng = _mesh(1, max_fused_rows=8, max_fused_bytes=1 << 20)
    try:
        for _ in range(6):
            eng.submit("direct", np.ones((1, 4096), np.uint8),
                       {}).wait()
        assert eng.max_fused_rows == 8
        assert eng.max_fused_bytes == 1 << 20
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# manager crash resilience
# ---------------------------------------------------------------------

def _crash_run(eng, data, ref):
    """The reference's crash drill on ``eng``: manager 0's first batch
    raises outside its launch.  Returns (failures, snapshot)."""
    fired = threading.Event()

    def fault(idx, batch):
        if idx == 0 and not fired.is_set():
            fired.set()
            raise RuntimeError("injected manager crash")

    eng._fault_hook = fault
    jobs = [eng.submit("direct", data, {}) for _ in range(12)]
    failures, successes = 0, 0
    for j in jobs:
        try:
            assert np.array_equal(j.wait(), ref)
            successes += 1
        except RuntimeError as e:
            assert "injected manager crash" in str(e)
            failures += 1
    assert fired.is_set()
    assert successes == 12 - failures
    return failures, eng.snapshot_stats()


def test_manager_crash_fails_batch_and_requeues_rest():
    eng = _mesh(2, coalesce=False)
    data = np.ones((1, 4096), np.uint8)
    ref = _md5_rows(data)
    try:
        failures, st = _crash_run(eng, data, ref)
        assert failures >= 1
        assert st["manager_restarts"] == 1
        assert sum(d["manager_restarts"]
                   for d in st["per_device"].values()) == 1
        # the restarted manager still serves its queue
        assert np.array_equal(eng.submit("direct", data, {}).wait(), ref)
        assert eng.queue_depth() == 0
    finally:
        eng.shutdown()
    # without coalescing the crashed batch is one job in both packages
    ref_eng = _ref_mesh(2, coalesce=False)
    try:
        ref_failures, ref_st = _crash_run(ref_eng, data, ref)
    finally:
        ref_eng.shutdown()
    assert (failures, st["manager_restarts"]) == \
        (ref_failures, ref_st["manager_restarts"]) == (1, 1)


# ---------------------------------------------------------------------
# octave classes: tiny and huge stream jobs must never share a launch
# ---------------------------------------------------------------------

def test_tiny_and_huge_stream_jobs_never_fuse():
    rng = np.random.default_rng(2)
    tiny = rng.integers(0, 256, 2048, np.uint8)
    huge = rng.integers(0, 256, 256 << 10, np.uint8)
    counts = []
    for make in (lambda: _mesh(1, coalesce_window_s=0.25),
                 lambda: _ref_mesh(1, coalesce_window_s=0.25)):
        eng = make()
        try:
            assert (eng.policy.octave_class(tiny.size)
                    != eng.policy.octave_class(huge.size))
            tj = eng.submit("gear", tiny, {})
            hj = eng.submit("gear", huge, {})
            assert np.array_equal(tj.wait(), ops.gear_hash(tiny.tobytes()))
            assert np.array_equal(hj.wait(), ops.gear_hash(huge.tobytes()))
            st = eng.snapshot_stats()
            assert st["jobs"] == 2
            assert st["launches"] == 2      # a fused pair would show 1
            counts.append((st["jobs"], st["launches"], st["coalesced"]))
        finally:
            eng.shutdown()
    assert counts[0] == counts[1]


def test_octave_class_is_true_power_of_two_octave():
    eng = _mesh(1)
    try:
        oc = eng.policy.octave_class
        assert oc(4096) == 13
        assert oc(8192) == 14           # adjacent octaves distinct
        assert oc(4096) != oc(8191 + 1)
        assert oc(6000) == oc(4097)     # same octave fuses
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# per-device stats + queue depth API
# ---------------------------------------------------------------------

def test_per_device_stats_and_queue_depth():
    eng = _mesh(2)
    try:
        data = np.ones((2, 4096), np.uint8)
        for _ in range(4):
            eng.submit("direct", data, {}).wait()
        st = eng.snapshot_stats()
        assert set(st["per_device"]) == {0, 1}
        for row in st["per_device"].values():
            for key in ("jobs", "launches", "bytes", "ewma_launch_s",
                        "ewma_bucket_s", "queue_depth", "queued_bytes",
                        "slowdown", "manager_restarts"):
                assert key in row, key
        assert sum(d["jobs"] for d in st["per_device"].values()) == 4
        assert "policy" in st and "cost_model" in st
        assert eng.queue_depth() == 0
        assert eng.queue_depth("fg", device=0) == 0
        assert eng.queue_depth(device=1) == 0
        with pytest.raises(IndexError):
            eng.queue_depth(device=7)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# real multi-device scheduling
# ---------------------------------------------------------------------

def test_forced_multi_device_sharding_subprocess():
    """The reference forces four XLA host devices in a subprocess.  The
    port needs no flag: four entries of the CPU device are four managers
    in this process (the same on one card, where each has its own stream:
    ``test_forced_multi_device_sharding_cuda`` in
    ``tests/test_torch_kernels_cuda.py``)."""
    devs = [CPU] * 4
    assert len(devs) == 4, devs
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (16, 8192), np.uint8)
    ref = np.stack([np.frombuffer(
        hashlib.md5(r.tobytes()).digest(), np.uint8) for r in rows])
    eng = CrystalGPU(devices=list(devs), shard_min_bytes=32 << 10)
    got = eng.submit("direct", rows, {}).wait()
    assert np.array_equal(got, ref)
    st = eng.snapshot_stats()
    eng.shutdown()
    assert st["sharded_jobs"] == 1, st
    busy = [i for i, d in st["per_device"].items() if d["jobs"]]
    assert len(busy) >= 2, st["per_device"]
