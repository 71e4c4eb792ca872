"""The metric arithmetic on synthetic spans, counters and a synthetic
device trace: means, rates, idle shares, rooflines and the breakdown."""
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]
from perfbench import devtrace, harness, roofline  # noqa: E402

GPU = {"sms": 132, "sm_clock_hz": 1.98e9}


def trace_events(mark_ts_us, ops):
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.MARK,
           "ts": mark_ts_us, "dur": 1.0}]
    for name, cat, ts, dur in ops:
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": mark_ts_us + 5, "dur": 1e6})
    return ev


def synthetic_run():
    # the marker at perf_counter 100.0 s sits at 5e6 us in the trace
    ops = [("void md5_direct_kernel(unsigned int const*, int)", "kernel",
            5e6 + 1e6, 2e5),
           ("void sliding_md5_kernel<12, 1>(unsigned int const*)", "kernel",
            5e6 + 2e6, 1e5),
           ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 5e6 + 2.05e6,
            1e5),
           ("md5_direct_kernel(unsigned int const*, int)", "kernel",
            5e6 + 4e6, 5e6)]             # runs past the window's end
    dev = devtrace.parse(trace_events(5e6, ops), 100.0, 100.5, 104.5)
    run = harness.Run(op="write", t0=100.5, t1=104.5, setup_s=3.0,
                      ops_done=4, bytes_done=4 * 10 ** 6)
    run.device, run.gpu = dev, GPU
    run.spans = [("sai/chunk", 100.5, 101.0), ("sai/chunk", 102.0, 102.2),
                 ("sai/hash", 101.0, 101.5), ("engine/queue", 101.0, 101.1)]
    run.counters = {"before": {"jobs": 10, "launches": 5, "coalesced": 0},
                    "after": {"jobs": 22, "launches": 9, "coalesced": 3}}
    run.work = {"md5_direct": (33.45e12 * 0.1, 0.0),
                "sliding_md5": (0.0, 3.35e12 * 0.05)}
    return run


def value(name, run):
    return harness.reader(name)(run)


def test_device_trace_on_the_host_clock():
    dev = synthetic_run().device
    assert dev.window_s == pytest.approx(4.0)
    names = sorted({n for n, _, _ in dev.ops})
    assert names == ["Memcpy HtoD", "md5_direct_kernel",
                     "sliding_md5_kernel<12, 1>"]
    # 0.2 s + the union of 0.1 s and 0.1 s overlapping by 0.05 s, and the
    # last kernel clipped to its first 0.5 s inside the window
    assert dev.busy_s == pytest.approx(0.2 + 0.15 + 0.5)
    assert dev.seconds_by_name("md5_direct_kernel") == pytest.approx(0.7)
    top = dev.top_ops()
    assert top[0][0] == "md5_direct_kernel"
    assert top[0][1] == pytest.approx(0.7)


def test_idle_by_host_span():
    run = synthetic_run()
    gaps = dict(run.device.idle_by_host(run.spans))
    # idle 100.5-101.0 (in sai/chunk), 101.2-102.0 (mid 101.6: none),
    # 102.15-104.0 (mid 103.075: none)
    assert gaps["sai/chunk"] == pytest.approx(0.5)
    assert gaps["no span"] == pytest.approx(0.8 + 1.85)
    assert sum(gaps.values()) == pytest.approx(4.0 - 0.85)


def test_end_to_end_readers():
    run = synthetic_run()
    assert value("write_MBps", run) == pytest.approx(1.0)
    assert value("read_MBps", run) is None
    assert value("setup_s", run) == 3.0
    run.op = "read"
    assert value("read_MBps", run) == pytest.approx(1.0)


def test_span_and_counter_readers():
    run = synthetic_run()
    assert value("sai_chunk_ms", run) == pytest.approx(350.0)
    assert value("sai_hash_ms", run) == pytest.approx(500.0)
    assert value("engine_queue_ms.write", run) == pytest.approx(100.0)
    assert value("sai_store_ms", run) is None
    assert value("engine_jobs_per_launch.write", run) == pytest.approx(3.0)


def test_device_readers():
    run = synthetic_run()
    assert value("device_idle_pct.write", run) == pytest.approx(
        100 * (1 - 0.85 / 4.0))
    # 0.1 s of operations bound over 0.7 s of kernel
    assert value("md5_direct_roofline.write", run) == pytest.approx(
        100 * 0.1 / 0.7, rel=1e-3)
    assert value("sliding_md5_roofline", run) == pytest.approx(50.0)
    run.device = None
    assert value("md5_direct_roofline.read", run) is None
    assert value("device_idle_pct.read", run) is None


def test_no_kernel_in_the_trace_gives_no_share():
    run = synthetic_run()
    run.device = devtrace.DeviceTrace([], 100.5, 104.5)
    assert value("md5_direct_roofline.write", run) is None
    assert value("device_idle_pct.write", run) == pytest.approx(100.0)


def test_roofline_never_counts_padding():
    # a 10-byte block is a 16-byte message: 1 compression
    ops, nbytes = roofline.md5_direct_work([10])
    assert (ops, nbytes) == (324, 16 + 16)


def test_short_names():
    assert devtrace.short_name("void k<1, 2>(int (*)[4])") == "k<1, 2>"
    assert devtrace.short_name("Memset (Device)") == "Memset"
    assert devtrace.short_name("plain") == "plain"
    assert devtrace.short_name(
        "void (anonymous namespace)::sliding_md5_kernel<12, 1>(unsigned "
        "int const*, long long)") == "sliding_md5_kernel<12, 1>"
    assert devtrace.short_name("(anonymous namespace)::md5_direct_kernel("
                               "unsigned int const*)") == "md5_direct_kernel"


def test_candidates_roofline_sums_both_passes():
    run = synthetic_run()
    # 0.1 s of bytes bound over 0.15 s of the count and scatter passes
    run.device = devtrace.DeviceTrace([
        ("candidate_count_kernel<4>", 101.0, 101.1),
        ("candidate_scatter_kernel<4>", 101.1, 101.15),
        ("sliding_md5_kernel<12, 1>", 101.2, 101.3)], 100.5, 104.5)
    run.work["candidates"] = (0.0, 3.35e12 * 0.1)
    assert value("candidates_roofline", run) == pytest.approx(
        100 * 0.1 / 0.15)
    del run.work["candidates"]          # a rule that asks for no test
    assert value("candidates_roofline", run) is None
