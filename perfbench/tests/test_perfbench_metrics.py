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
    # idle 100.5-101.0 (in sai/chunk), 101.2-102.0 (sai/hash to 101.5,
    # then none), 102.15-104.0 (sai/chunk to 102.2, then none): each gap
    # split where a span closes, not charged whole to its midpoint's
    assert gaps["sai/chunk"] == pytest.approx(0.5 + 0.05)
    assert gaps["sai/hash"] == pytest.approx(0.3)
    assert gaps["no span"] == pytest.approx(0.5 + 1.8)
    assert sum(gaps.values()) == pytest.approx(4.0 - 0.85)


def test_idle_gap_split_over_nested_and_overlapping_spans():
    dev = devtrace.DeviceTrace([("k", 0.0, 1.0), ("k", 9.0, 10.0)],
                               0.0, 10.0)
    spans = [("outer", 2.0, 6.0), ("inner", 3.0, 4.0),
             ("other", 5.0, 7.5), ("before", -1.0, 1.5)]
    gaps = dict(dev.idle_by_host(spans))
    # the one gap 1-9: before 1-1.5, none 1.5-2, outer 2-3 and 4-5,
    # outer+inner 3-4, other+outer 5-6, other 6-7.5, none 7.5-9
    assert gaps == pytest.approx({
        "before": 0.5, "no span": 0.5 + 1.5, "outer": 2.0,
        "inner+outer": 1.0, "other+outer": 1.0, "other": 1.5})
    assert dict(dev.idle_by_host([])) == pytest.approx({"no span": 8.0})


def test_device_trace_leaves_the_pauses_out():
    ops = [("k", 1.0, 2.0),             # before the pause
           ("k", 2.5, 3.5),             # runs into it: 2.5-3.0 counts
           ("m", 3.2, 3.8),             # inside it: left out
           ("k", 5.5, 6.0)]             # after it
    dev = devtrace.DeviceTrace(ops, 0.0, 8.0, paused=[(3.0, 5.0)])
    assert dev.window_s == pytest.approx(6.0)
    assert dev.busy() == [(1.0, 2.0), (2.5, 3.0), (5.5, 6.0)]
    assert dev.busy_s == pytest.approx(2.0)
    assert dev.idle() == [(0.0, 1.0), (2.0, 2.5), (5.0, 5.5), (6.0, 8.0)]
    assert sum(b - a for a, b in dev.idle()) == pytest.approx(
        dev.window_s - dev.busy_s)
    assert dev.seconds_by_name("m") == 0
    assert dev.seconds_by_name("k") == pytest.approx(2.0)
    gaps = dict(dev.idle_by_host([("sai/chunk", 0.0, 8.0)]))
    assert gaps == pytest.approx({"sai/chunk": 4.0})
    # the same through the trace's export, and the idle share's reader
    run = synthetic_run()
    events = trace_events(5e6, [("md5_direct_kernel(int)", "kernel",
                                 5e6 + 1e6, 2e5)])
    run.device = devtrace.parse(events, 100.0, 100.5, 104.5,
                                paused=[(101.1, 103.1)])
    assert run.device.window_s == pytest.approx(2.0)
    assert run.device.busy_s == pytest.approx(0.1)
    assert value("device_idle_pct.write", run) == pytest.approx(95.0)


def test_end_to_end_readers():
    run = synthetic_run()
    assert value("write_MBps", run) == pytest.approx(1.0)
    # the harness's check between laps, with the clock stopped
    run.paused = [(101.0, 101.5), (103.0, 104.0)]
    assert run.window_s == pytest.approx(2.5)
    assert value("write_MBps", run) == pytest.approx(1.6)
    run.paused = []
    assert value("read_MBps", run) is None
    assert value("setup_s", run) == 3.0
    run.op = "read"
    assert value("read_MBps", run) == pytest.approx(1.0)


def test_card_time_per_gb():
    run = synthetic_run()
    # busy 101.0-101.2, 102.0-102.15 (a kernel and a copy overlapping)
    # and 104.0-104.5 (cut at the window's end): 0.85 s over 0.004 GB
    assert value("card_ms_per_GB", run) == pytest.approx(850.0 / 0.004)
    # a pause leaves its device time out, as the window does
    run.device = devtrace.parse(
        trace_events(5e6, [("md5_direct_kernel(int)", "kernel",
                            5e6 + 1e6, 2e5),
                           ("md5_direct_kernel(int)", "kernel",
                            5e6 + 2e6, 2e5)]),
        100.0, 100.5, 104.5, paused=[(101.9, 102.5)])
    assert value("card_ms_per_GB", run) == pytest.approx(200.0 / 0.004)
    # no device operation (no card), or nothing moved: left out
    run.device = devtrace.DeviceTrace([], 100.5, 104.5)
    assert value("card_ms_per_GB", run) is None
    run.device, run.bytes_done = synthetic_run().device, 0
    assert value("card_ms_per_GB", run) is None


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
