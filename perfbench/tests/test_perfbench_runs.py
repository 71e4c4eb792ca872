"""Whole small runs of every cell on the CPU: sound runs come out
correct, and each control (a change that breaks a guarantee the
configuration states) comes out not correct."""
import gc
import json
import time

import pytest

from _perfbench_small import (HERE_CONTROLS, RESTORE, WRITE_CDC,
                              WRITE_FIXED, small_run)

from perfbench import harness


@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED, RESTORE])
def test_sound_run_is_correct(workload):
    r = small_run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]


def test_traced_run_reads_spans_and_counters():
    r = small_run(WRITE_FIXED, trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert m["engine_wait_ms.write"]["value"] > 0
    assert m["engine_jobs_per_launch.write"]["value"] >= 1
    # no card: the rooflines and the card's time find no kernel and are
    # left out
    assert "md5_direct_roofline.write" not in m
    assert "card_ms_per_GB" not in m
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("workload,control,number", [
    (WRITE_CDC, "stride-4", "boundary_mismatch"),
    (WRITE_CDC, "replication-1", "replica_faults"),
    (WRITE_FIXED, "replication-1", "replica_faults"),
    (RESTORE, "verify-off", "read_byte_mismatch")])
def test_control_is_not_correct(workload, control, number):
    with open(HERE_CONTROLS / f"{control}.json") as f:
        r = small_run(workload, control=json.load(f))
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_every_lap_is_retired_and_checked(in_flight):
    r = small_run(WRITE_FIXED, seconds=2.0,
                  control={"traffic": {"in_flight": in_flight}})
    assert r["correct"], r["checks"]
    assert r["attempted"] > 4           # more than one lap of 4 versions


def count_laps(monkeypatch, sleep_s=0.0):
    """Count the laps made and the laps checked; each check first sleeps
    ``sleep_s``, on the thread that runs it."""
    laps = {"made": 0, "checked": 0, "slept": []}
    make, retire = harness.Lap.__init__, harness.retire

    def counted_make(self, *args):
        laps["made"] += 1
        make(self, *args)

    def slow_retire(*args):
        t = time.perf_counter()
        time.sleep(sleep_s)
        laps["slept"].append((t, time.perf_counter()))
        laps["checked"] += 1
        return retire(*args)
    monkeypatch.setattr(harness.Lap, "__init__", counted_make)
    monkeypatch.setattr(harness, "retire", slow_retire)
    return laps


def test_check_between_laps_is_not_in_the_window(monkeypatch):
    from test_perfbench_chunkers import recorded_run
    laps = count_laps(monkeypatch, sleep_s=0.4)
    r, run = recorded_run(monkeypatch, WRITE_FIXED,
                          control={"traffic": {"in_flight": 2}}, trace=True)
    assert r["correct"], r["checks"]
    assert laps["made"] >= 2 and laps["checked"] == laps["made"]
    # every check but the last ran with the clock stopped, inside the
    # window; the last after it
    assert len(run.paused) == laps["made"] - 1
    for (a, b), (s0, s1) in zip(run.paused, laps["slept"]):
        assert a <= s0 and s1 <= b
        assert run.t0 < a < b < run.t1
    assert laps["slept"][-1][0] >= run.t1
    pause = r["timings"]["check_pause_s"]
    assert pause == pytest.approx(run.paused_s)
    assert pause >= 0.4 * (laps["made"] - 1)
    # the deadline counts the program's time only
    assert run.window_s >= 1.5
    assert harness.reader("write_MBps")(run) == pytest.approx(
        run.bytes_done / (run.t1 - run.t0 - pause) / 1e6)
    # no write in flight across a pause: every write's spans lie in the
    # window and outside each pause
    assert sum(n == "sai/store" for n, _, _ in run.spans) == run.ops_done
    assert all(run.t0 <= s0 <= s1 <= run.t1 for _, s0, s1 in run.spans)
    for a, b in run.paused:
        assert not any(s0 < b and s1 > a for _, s0, s1 in run.spans)


@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED])
def test_replication_control_fails_with_every_lap_checked(monkeypatch,
                                                          workload):
    laps = count_laps(monkeypatch)
    with open(HERE_CONTROLS / "replication-1.json") as f:
        r = small_run(workload, seconds=4.0, control=json.load(f))
    assert laps["made"] >= 2 and laps["checked"] == laps["made"]
    assert not r["correct"]
    assert r["checks"]["replica_faults"]["value"] > 0


def test_window_keeps_no_map_the_collector_walks(monkeypatch):
    """Each lap's block maps, kept from its pause to the check after the
    window, are plain tuples that a collection no longer walks."""
    seen = []
    writes = harness.check.writes

    def spy(done, *args):
        gc.collect()
        seen.extend(d["block_map"] for d in done)
        return writes(done, *args)
    monkeypatch.setattr(harness.check, "writes", spy)
    r = small_run(WRITE_CDC, seconds=4.0)
    assert r["correct"], r["checks"]
    assert len(seen) == r["attempted"] > 4      # more than one lap
    for ends, digests in seen:
        assert len(ends) == len(digests) > 0
        assert not gc.is_tracked(ends) and not gc.is_tracked(digests)
