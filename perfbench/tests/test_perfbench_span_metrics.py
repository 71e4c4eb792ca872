"""The readers of the write path's stage spans: their arithmetic on a
synthetic run (per write, a fused launch counted once, nothing read from
a program that has no such span), a small traced run on the CPU that
reports each of them in its cells, and on the card the clock the spans
share with the device trace.  The card test runs with
``PYTHONPATH=src python -m pytest -m cuda -s
perfbench/tests/test_perfbench_span_metrics.py`` and skips without one."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]
from perfbench import devtrace, harness  # noqa: E402

from _perfbench_small import WRITE_CDC, WRITE_FIXED, small_run  # noqa: E402

NEW = ["sai_queue_ms", "sai_slide_ms", "sai_scan_ms", "sai_split_ms",
       "sai_pack_ms", "sai_claim_ms", "sai_put_ms", "sai_commit_ms",
       "sai_unpin_ms", "engine_stage_ms.write", "engine_wait_ms.write",
       "engine_finish_ms.write"]
CDC_ONLY = {"sai_slide_ms", "sai_scan_ms"}


def value(name, run):
    return harness.reader(name)(run)


def synthetic_run():
    """Two traced writes that got their digests and a third that did
    not (it has a queue span only).  Write 1 packs twice; its two hash
    jobs shared one fused launch, so their engine stamps are alike."""
    run = harness.Run(op="write")
    run.spans = [
        ("sai/queue", 0.0, 0.1), ("sai/queue", 1.0, 1.3),
        ("sai/queue", 2.0, 2.2),
        ("sai/chunk/slide", 0.1, 0.4), ("sai/chunk/scan", 0.4, 0.5),
        ("sai/chunk/split", 0.5, 0.6), ("sai/chunk/split", 1.3, 1.4),
        ("sai/hash/pack", 0.6, 0.7), ("sai/hash/pack", 1.4, 1.45),
        ("sai/hash/pack", 1.45, 1.55),
        ("sai/hash", 0.6, 0.9), ("sai/hash", 1.4, 1.8),
        ("sai/store/claim", 0.9, 0.92), ("sai/store/claim", 1.8, 1.83),
        ("sai/store/put", 0.92, 0.95), ("sai/store/put", 1.83, 1.9),
        ("sai/store/commit", 0.95, 0.97), ("sai/store/commit", 1.9, 1.96),
        ("sai/store/unpin", 0.97, 0.98), ("sai/store/unpin", 1.96, 1.97),
        # the window-hash job of write 0
        ("engine/stage", 0.15, 0.2), ("engine/wait", 0.2, 0.3),
        ("engine/finish", 0.3, 0.35),
        # the hash job of write 0
        ("engine/stage", 0.7, 0.75), ("engine/wait", 0.75, 0.8),
        ("engine/finish", 0.8, 0.85),
        # write 1: two jobs, one fused launch, stamped alike
        ("engine/stage", 1.55, 1.6), ("engine/wait", 1.6, 1.7),
        ("engine/finish", 1.7, 1.75),
        ("engine/stage", 1.55, 1.6), ("engine/wait", 1.6, 1.7),
        ("engine/finish", 1.7, 1.75)]
    return run


@pytest.mark.parametrize("name,want", [
    ("sai_queue_ms", 1e3 * (0.1 + 0.3 + 0.2) / 2),
    ("sai_slide_ms", 1e3 * 0.3 / 2),
    ("sai_scan_ms", 1e3 * 0.1 / 2),
    ("sai_split_ms", 1e3 * 0.2 / 2),
    ("sai_pack_ms", 1e3 * (0.1 + 0.05 + 0.1) / 2),
    ("sai_claim_ms", 1e3 * (0.02 + 0.03) / 2),
    ("sai_put_ms", 1e3 * (0.03 + 0.07) / 2),
    ("sai_commit_ms", 1e3 * (0.02 + 0.06) / 2),
    ("sai_unpin_ms", 1e3 * (0.01 + 0.01) / 2),
    ("engine_stage_ms.write", 1e3 * (0.05 + 0.05 + 0.05) / 2),
    ("engine_wait_ms.write", 1e3 * (0.1 + 0.05 + 0.1) / 2),
    ("engine_finish_ms.write", 1e3 * (0.05 + 0.05 + 0.05) / 2)])
def test_reader_per_write(name, want):
    assert value(name, synthetic_run()) == pytest.approx(want)


def test_a_program_without_the_spans_reports_none():
    """A run of a program that has none of the new spans (nor, in a read
    cell, any ``sai/hash``) leaves each metric out and does not raise."""
    run = synthetic_run()
    run.spans = [s for s in run.spans
                 if s[0] in ("sai/chunk", "sai/hash", "sai/store",
                             "engine/queue", "engine/launch")]
    for name in NEW:
        assert value(name, run) is None, name
    run = synthetic_run()
    run.spans = [s for s in run.spans if s[0] != "sai/hash"]
    for name in NEW:
        assert value(name, run) is None, name


@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED])
def test_traced_run_reports_each_new_metric_of_its_cell(workload):
    r = small_run(workload, trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for name in NEW:
        if workload == WRITE_FIXED and name in CDC_ONLY:
            assert name not in got
        else:
            assert got[name]["value"] > 0, name
            assert got[name]["unit"] == "ms/write"
    # the existing stage metrics hold their children
    if workload == WRITE_CDC:
        assert got["sai_slide_ms"]["value"] + got["sai_scan_ms"]["value"] \
            + got["sai_split_ms"]["value"] \
            <= got["sai_chunk_ms"]["value"] * (1 + 1e-9)
    assert got["sai_pack_ms"]["value"] \
        <= got["sai_hash_ms"]["value"] * (1 + 1e-9)
    assert sum(got[n]["value"] for n in ("sai_claim_ms", "sai_put_ms",
                                         "sai_commit_ms", "sai_unpin_ms")) \
        <= got["sai_store_ms"]["value"] * (1 + 1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_work_lies_in_the_engine_spans(cuda, tmp_path):
    """The spans and the device trace share one clock: every copy and
    kernel of a traced CDC write (window hashes, then digests) lies
    within the union of its ``engine/stage`` and ``engine/wait`` spans,
    within 1 ms."""
    from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
    from repro_torch.obs import Trace

    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, 16 << 20, dtype=np.uint8).tobytes()
              for _ in range(2)]
    eng = CrystalGPU(devices=[cuda])
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(ca="cdc", window=48, stride=1,
                             avg_chunk=8192, min_chunk=2048,
                             max_chunk=65536), crystal=eng)
    try:
        sai.write_async("/w", images[0]).result(timeout=300)  # warm-up
        torch.cuda.synchronize(cuda)
        rec = devtrace.Recorder()
        rec.start()
        t0 = time.perf_counter()
        tr = Trace(1, "write")
        sai.write_async("/w", images[1], trace=tr).result(timeout=300)
        t1 = time.perf_counter()
        torch.cuda.synchronize(cuda)
        # a window wide enough that no device operation is clipped
        dev = rec.stop(str(tmp_path / "trace.json"), t0 - 60, t1 + 60)
    finally:
        sai.close()
        eng.shutdown()
    assert dev is not None
    held = sorted((s.t0, s.t1) for s in tr.spans
                  if s.name in ("engine/stage", "engine/wait"))
    union = []
    for a, b in held:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    ops = dev.ops                        # the profiler saw this write only
    for needle in ("HtoD", "DtoH", "sliding_md5", "md5_direct"):
        assert any(needle in n for n, _, _ in ops), needle

    def outside(op):
        return min(max(0.0, a - op[1], op[2] - b) for a, b in union)
    worst = max(outside(op) for op in ops)
    print(f"{len(ops)} device operations in {len(union)} engine "
          f"intervals ({len(held)} stage/wait spans); farthest outside: "
          f"{worst * 1e3:.4f} ms; device {torch.cuda.get_device_name(0)}")
    assert worst <= 1e-3, [op for op in ops if outside(op) > 1e-3]
