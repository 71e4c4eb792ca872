"""Whole small runs of every cell on the CPU: sound runs come out
correct, and each control (a change that breaks a guarantee the
configuration states) comes out not correct."""
import json

import pytest

from _perfbench_small import (HERE_CONTROLS, RESTORE, WRITE_CDC,
                              WRITE_FIXED, small_run)


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
    assert m["sai_hash_ms"]["value"] > 0
    assert m["engine_jobs_per_launch.write"]["value"] >= 1
    # no card: the rooflines find no kernel and are left out
    assert "md5_direct_roofline.write" not in m
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
