"""``direct_staged_mb.write``: the reader's arithmetic on synthetic
counters, nothing from an engine without the counter, and a small traced
run in which each write stages its image's bytes once."""
import pytest

from _perfbench_small import SMALL, WRITE_CDC, WRITE_FIXED, small_run

from perfbench import harness


def _run(before, after, ops_done=4):
    run = harness.Run(op="write", ops_done=ops_done)
    run.counters = {"before": before, "after": after}
    return run


def test_reader_arithmetic_and_silence():
    read = harness.reader("direct_staged_mb.write")
    assert read(_run({"direct_staged_bytes": 10 ** 6},
                     {"direct_staged_bytes": 9 * 10 ** 6})) == \
        pytest.approx(2.0)
    # an engine without the counter, and a window with no write done
    assert read(_run({"jobs": 1}, {"jobs": 5})) is None
    assert read(_run({"direct_staged_bytes": 0},
                     {"direct_staged_bytes": 8}, ops_done=0)) is None
    assert read(harness.Run(op="write", ops_done=1)) is None


@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED])
def test_a_write_stages_its_image_once(workload):
    r = small_run(workload, trace=True)
    assert r["correct"], r["checks"]
    image_mb = SMALL["traffic"]["series"]["image_bytes"] / 1e6
    got = r["metrics"]["direct_staged_mb.write"]
    assert got["unit"] == "MB/write"
    assert got["value"] == pytest.approx(image_mb)
