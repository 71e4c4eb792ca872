"""The port's end-to-end observability plane (``repro_torch.obs`` and
the gateway's stats over the wire) on a ``CrystalGPU`` over
``torch.device("cpu")``.  The cases and their assertions mirror the JAX
package's ``tests/test_observability.py``.

Acceptance coverage: a write through ``GatewayClient`` over a real
``SocketChannel`` yields (a) an ``OP_STATS`` reply whose JSON carries
engine per-device launch histograms with non-zero p50/p99 and WAL
fsync percentiles, and (b) a completed trace in the gateway's ring
whose span tree covers transport decode -> WDRR queue -> SAI hash ->
engine launch -> WAL commit with monotonic, nested timestamps.  The
metric primitives ride along: histogram percentile math, the
CounterGroup dict facade, race-free concurrent increments (the
unsynchronized ``stats[...] += 1`` fix), Prometheus exposition, and
the slow-request log dump.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
from repro_torch.obs import (Histogram, MetricsRegistry, Trace, Tracer,
                             dump_slow_log, flatten, prometheus_text)
from repro_torch.serve.storage_client import GatewayClient
from repro_torch.serve.storage_service import (GatewayConfig, StorageGateway,
                                               encode_request,
                                               decode_request, OP_WRITE)
from repro_torch.serve.transport import GatewayServer

CPU = torch.device("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# ----------------------------------------------------------------------
# metric primitives
# ----------------------------------------------------------------------
def test_histogram_percentiles_log_buckets():
    h = Histogram("t")
    for _ in range(1000):
        h.record(1e-3)
    # pow-2 ns buckets are good to ~±41%: the geometric bucket midpoint
    # for 1 ms must land within a factor of sqrt(2)
    for p in (50.0, 95.0, 99.0):
        assert 1e-3 / 1.5 <= h.percentile(p) <= 1e-3 * 1.5
    s = h.summary()
    assert s["count"] == 1000
    assert s["max_s"] == pytest.approx(1e-3)
    assert s["sum_s"] == pytest.approx(1.0)
    # a bimodal tail shows up in p99 but not p50
    h2 = Histogram("t2")
    for _ in range(98):
        h2.record(1e-4)
    for _ in range(2):
        h2.record(1.0)
    assert h2.percentile(50.0) < 1e-3
    assert h2.percentile(99.0) > 0.5


def test_histogram_edge_buckets():
    h = Histogram()
    h.record(0.0)                    # sub-ns -> bucket 0 -> 0.0
    assert h.percentile(50.0) == 0.0
    h.record(1e12)                   # clamped to the top bucket, no raise
    assert h.count == 2
    assert h.percentile(99.0) > 0.0
    assert h.summary()["max_s"] == pytest.approx(1e12)


def test_counter_group_is_a_dict_facade():
    reg = MetricsRegistry()
    stats = reg.group(("jobs", "launches"), prefix="eng/")
    assert stats["jobs"] == 0
    stats.inc("jobs", 3)
    stats.inc("launches")
    assert dict(stats) == {"jobs": 3, "launches": 1}
    assert {**stats} == {"jobs": 3, "launches": 1}
    assert stats == {"jobs": 3, "launches": 1}
    stats["jobs"] = 10               # absolute set (owner-lock callers)
    assert stats["jobs"] == 10
    stats.max_update("jobs", 7)      # no-op below the high-water mark
    assert stats["jobs"] == 10
    stats.max_update("jobs", 12)
    assert stats["jobs"] == 12
    # the registry sees the prefixed names
    assert reg.snapshot()["counters"]["eng/jobs"] == 12
    # unknown keys materialize on first inc (dynamic stat sites)
    stats.inc("errors")
    assert stats["errors"] == 1


def test_concurrent_increments_lose_no_updates():
    """The satellite-1 regression test: ``stats[k] += 1`` from many
    threads loses updates (read-modify-write race); ``stats.inc(k)``
    must not, even with concurrent snapshot readers."""
    reg = MetricsRegistry()
    stats = reg.group(("a", "b", "c"))
    hist = reg.histogram("lat")
    n_threads, n_iter = 8, 5000
    stop = threading.Event()

    def hammer():
        for i in range(n_iter):
            stats.inc("a")
            stats.inc("b", 2)
            stats.inc("c", i % 3)
            hist.record(1e-6)

    def reader():
        while not stop.is_set():
            dict(stats)
            hist.summary()

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers + threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    assert stats["a"] == n_threads * n_iter
    assert stats["b"] == 2 * n_threads * n_iter
    assert stats["c"] == n_threads * sum(i % 3 for i in range(n_iter))
    assert hist.count == n_threads * n_iter


def test_flatten_separator_in_key_cannot_collide():
    # a tenant literally named "a/b" must not flatten to the same metric
    # name as the genuinely nested path a -> b
    tree = {"tenants": {"a": {"b": 1}, "a/b": 2}}
    flat = flatten(tree)
    assert flat["tenants/a/b"] == 1.0
    assert flat["tenants/a%2Fb"] == 2.0
    assert len(flat) == 2
    # '%' itself round-trips unambiguously too
    flat2 = flatten({"x%2Fy": 1, "x/y": 2})
    assert flat2["x%252Fy"] == 1.0
    assert flat2["x%2Fy"] == 2.0


def test_flatten_and_prometheus_text():
    tree = {"tenants": {"acme": {"completed": 3, "qos": "batch"}},
            "engine": {"per_device": {0: {"jobs": 5, "p50_s": 0.25}}},
            "ok": True,
            "depths": [1, 2]}
    flat = flatten(tree)
    assert flat["tenants/acme/completed"] == 3.0
    assert flat["engine/per_device/0/jobs"] == 5.0
    assert flat["ok"] == 1.0
    assert flat["depths/0"] == 1.0
    assert "tenants/acme/qos" not in flat        # strings dropped
    text = prometheus_text(tree)
    assert "repro_tenants_acme_completed 3\n" in text
    assert "repro_engine_per_device_0_p50_s 0.25" in text
    assert "# TYPE repro_tenants_acme_completed counter\n" in text
    for line in text.strip().splitlines():
        if line.startswith("#"):                  # TYPE annotations
            assert line.split(" ")[1] == "TYPE"
            continue
        name, value = line.split(" ")
        float(value)                              # every line parses
        assert name.startswith("repro_")


def test_dump_slow_log(tmp_path):
    path = str(tmp_path / "slow.json")
    assert dump_slow_log([], path) is False
    assert not (tmp_path / "slow.json").exists()
    entries = [{"trace_id": 7, "name": "write", "spans": []}]
    assert dump_slow_log(entries, path) is True
    with open(path) as fh:
        assert json.load(fh)["slow_requests"][0]["trace_id"] == 7


def test_tracer_ring_is_bounded():
    tr = Tracer(capacity=4, slow_threshold_s=0.0)
    for i in range(10):
        t = tr.start(i + 1, "op")
        t.add_span("stage", t.t0, t.t0 + 1e-6)
        tr.finish(t)
    st = tr.stats()
    assert st["finished"] == 10
    assert st["in_ring"] == 4
    assert [t.trace_id for t in tr.completed()] == [7, 8, 9, 10]
    # threshold 0.0: everything lands in the slow log too (bounded)
    assert st["slow"] == 10
    assert len(tr.slow_entries()) <= 64


def test_span_names_its_cause():
    t = Trace(5, "write")
    top = t.add_span("sai/hash", 1.0, 3.0)
    child = t.add_span("sai/hash/pack", 1.0, 2.0, "sai/hash", rows=4)
    assert top.parent is None and "parent" not in top.to_dict()
    d = child.to_dict()
    assert d["parent"] == "sai/hash" and d["meta"] == {"rows": 4}
    assert [s["name"] for s in t.to_dict()["spans"]] == ["sai/hash",
                                                         "sai/hash/pack"]


def test_traced_read_yields_submit_and_assemble(rng):
    """A traced verified read: the verify's packing and submission
    (``sai/verify/submit``, on the fetch thread, between ``sai/fetch``
    and ``sai/verify``) and the join of the blocks (``sai/assemble``),
    with the verify jobs' engine spans caused by ``sai/verify``."""
    eng = CrystalGPU(devices=[CPU])
    mgr, _ = make_store(3, replication=2)
    sai = SAI(mgr, _sai_cfg(), crystal=eng)
    try:
        data = rng.integers(0, 256, 3 * 4096 + 100, dtype=np.uint8).tobytes()
        sai.write("/r", data)
        tr = Trace(1, "read")
        assert sai.read_async("/r", trace=tr).result(timeout=120) == data
        plain = Trace(2, "read")
        assert sai.read_async("/r", verify=False, trace=plain).result(
            timeout=120) == data
    finally:
        sai.close()
        eng.shutdown()
    by = {s.name: s for s in tr.spans}
    assert {"sai/fetch", "sai/verify/submit", "sai/verify",
            "sai/assemble", "engine/queue", "engine/launch", "engine/stage",
            "engine/wait", "engine/finish"} == set(by)
    assert by["sai/fetch"].t1 <= by["sai/verify/submit"].t0 \
        <= by["sai/verify/submit"].t1 <= by["sai/verify"].t0 \
        <= by["sai/verify"].t1 <= by["sai/assemble"].t0
    assert {s.parent for s in tr.spans if s.name.startswith("engine/")} \
        == {"sai/verify"}
    assert {s.name for s in plain.spans} == {"sai/fetch", "sai/assemble"}


# ----------------------------------------------------------------------
# trace-id propagation on the wire
# ----------------------------------------------------------------------
def test_trace_id_rides_the_request_frame():
    frame = encode_request(OP_WRITE, 3, 9, path="/p", data=b"d",
                           trace=0x1122334455667788)
    _op, _sess, _rid, fields = decode_request(frame)
    assert fields["trace"] == 0x1122334455667788
    # trace 0 = untraced: omitted from decoded fields so untraced
    # frames round-trip byte-identically through encode(**decode())
    frame0 = encode_request(OP_WRITE, 3, 9, path="/p", data=b"d")
    _op, _sess, _rid, fields0 = decode_request(frame0)
    assert "trace" not in fields0


# ----------------------------------------------------------------------
# acceptance: socket e2e — stats over the wire + span tree in the ring
# ----------------------------------------------------------------------
def _sai_cfg():
    return SAIConfig(ca="fixed", hasher="gpu", block_size=4096,
                     avg_chunk=4096, min_chunk=1024, max_chunk=16384)


def test_socket_write_yields_stats_and_span_tree(tmp_path, rng):
    gw = StorageGateway(None, engine=CrystalGPU(devices=[CPU]),
                        config=GatewayConfig(
                            sai=_sai_cfg(), data_dir=str(tmp_path / "store"),
                            n_nodes=3, replication=2))
    eng = gw.engine
    server = GatewayServer(gw)
    try:
        client = GatewayClient(server, "acme")       # real SocketChannel
        datas = [rng.integers(0, 256, 8 * 4096, dtype=np.uint8).tobytes()
                 for _ in range(4)]
        for i, d in enumerate(datas):
            client.write(f"/obs/{i}", d)
        assert client.read("/obs/0") == datas[0]

        # (a) the OP_STATS wire snapshot: engine per-device launch
        # histograms with non-zero p50/p99, WAL fsync percentiles
        snap = client.stats()
        assert snap["obs"]["request"]["write"]["count"] == len(datas)
        assert snap["obs"]["request"]["write"]["p50_s"] > 0.0
        per_dev = snap["engine"]["per_device"]       # JSON: string keys
        hot = [d for d in per_dev.values()
               if d["launch_hist"]["count"] > 0]
        assert hot, f"no device recorded a launch: {per_dev}"
        for d in hot:
            assert d["launch_hist"]["p50_s"] > 0.0
            assert d["launch_hist"]["p99_s"] >= d["launch_hist"]["p50_s"]
        fsync = snap["wal"]["fsync_hist"]
        assert fsync["count"] > 0 and fsync["p50_s"] > 0.0
        assert snap["blockstore"]["puts"] > 0
        assert snap["obs"]["traces"]["finished"] >= len(datas) + 1
        client.close()

        # (b) a completed write trace whose span tree covers
        # transport -> WDRR queue -> SAI hash -> engine launch -> WAL
        # commit with monotonic, nested timestamps
        writes = [t for t in gw.tracer.completed() if t.name == "write"]
        assert writes
        trace = writes[-1]
        by_name = {}
        for s in trace.spans:
            by_name.setdefault(s.name, []).append(s)
        for needed in ("transport/decode", "gateway/queue", "sai/chunk",
                       "sai/hash", "sai/store", "engine/launch",
                       "wal/commit"):
            assert needed in by_name, (needed, sorted(by_name))
        for s in trace.spans:                        # nesting
            assert trace.t0 <= s.t0 <= s.t1 <= trace.t1, s.name
        order = [min(s.t0 for s in by_name[n])       # monotonic stages
                 for n in ("transport/decode", "gateway/queue",
                           "sai/hash", "engine/launch", "wal/commit")]
        assert order == sorted(order)
        launch = by_name["engine/launch"][0]
        assert "device" in launch.meta and "lane" in launch.meta
        # the durable store's fsync wait lies in the block-map commit
        (commit,) = by_name["sai/store/commit"]
        (wal,) = by_name["wal/commit"]
        assert wal.parent == "sai/store/commit"
        assert commit.t0 <= wal.t0 <= wal.t1 <= commit.t1

        # the read trace covers the fetch/verify path
        reads = [t for t in gw.tracer.completed() if t.name == "read"]
        assert reads
        read_names = {s.name for s in reads[-1].spans}
        assert {"transport/decode", "gateway/queue",
                "sai/fetch", "sai/verify"} <= read_names
    finally:
        server.close()
        gw.close()
        eng.shutdown()
