"""Chunking rules found by name (``perfbench/chunkers/<ca>.py``): an
unknown rule fails and names the file it looked for, a rule in a new
file reaches the check and the device work with no edit to the harness,
the two rules the cells use give the device work they gave before the
rules moved into files, and a traced run keeps each span's parent and
meta and the engine's whole counters."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _perfbench_small import SMALL, WRITE_CDC, WRITE_FIXED, manifest

from perfbench import harness, reference, roofline

# a rule no file of the harness, the reference or the check names: the
# fixed-block rule, or its ends moved one byte earlier, with device work
# of its own
PROBE = '''
from perfbench import reference

SHIFT = {shift}


def bounds(image, sai, device):
    ends = reference.fixed_boundaries(image.size, sai["block_size"])
    return [e - SHIFT for e in ends[:-1]] + ends[-1:]


def work(length, sai):
    return {{"probe": (3.0, float(length))}}
'''


def recorded_run(monkeypatch, workload, scale=SMALL, control=None,
                 trace=False):
    """A small run of ``workload`` on the CPU, and the record its metric
    readers were handed."""
    runs = []
    real = harness.reader

    def spy(name):
        read = real(name)

        def wrapped(run):
            runs.append(run)
            return read(run)
        return wrapped
    monkeypatch.setattr(harness, "reader", spy)
    result = harness.run_cell(manifest(), workload, 7, 1.5, trace,
                              torch.device("cpu"), time.perf_counter(),
                              control=control, scale=scale)
    assert runs and all(r is runs[0] for r in runs)
    return result, runs[0]


def test_unknown_rule_fails_and_names_its_file():
    img = np.zeros(100, np.uint8)
    with pytest.raises(FileNotFoundError, match=r"chunkers/nope\.py"):
        reference.chunk_bounds(img, {"ca": "nope"}, "cpu")
    done = [{"version": 0, "counts": (1, 0, 100, 100)}]
    with pytest.raises(FileNotFoundError, match=r"chunkers/nope\.py"):
        harness._work(done, {0: [100]}, [img], {"ca": "nope"}, "write")


@pytest.mark.parametrize("shift,correct", [(0, True), (1, False)])
def test_a_rule_in_a_new_file_reaches_the_check_and_the_work(
        monkeypatch, tmp_path, shift, correct):
    (tmp_path / "probe.py").write_text(PROBE.format(shift=shift))
    monkeypatch.setattr(reference, "CHUNKERS", tmp_path)
    scale = harness.merged(SMALL, {"config": {"sai": {"ca": "probe"}}})
    # the program splits in fixed blocks; the reference by the probe
    result, run = recorded_run(
        monkeypatch, WRITE_FIXED, scale=scale,
        control={"config": {"sai": {"ca": "fixed"}}})
    assert result["correct"] is correct, result["checks"]
    assert (result["checks"]["boundary_mismatch"]["value"] > 0) \
        is not correct
    size = SMALL["traffic"]["series"]["image_bytes"]
    assert run.ops_done > 0
    assert run.work["probe"] == (3.0 * run.ops_done,
                                 float(size * run.ops_done))
    assert run.work["md5_direct"][0] > 0


def old_work(done, lens, series, sai, op):
    """The device work as the harness summed it before the rules moved
    into files: digests of every block, and for ``cdc`` writes the
    window hashes of every image."""
    work = {"md5_direct": [0.0, 0.0], "sliding_md5": [0.0, 0.0]}
    for d in done:
        if "error" in d:
            continue
        v = d["version"]
        ops, nbytes = roofline.md5_direct_work(lens[v])
        work["md5_direct"][0] += ops
        work["md5_direct"][1] += nbytes
        if op == "write" and sai["ca"] == "cdc":
            ops, nbytes = roofline.sliding_work(series[v].size,
                                                sai["window"], sai["stride"])
            work["sliding_md5"][0] += ops
            work["sliding_md5"][1] += nbytes
    return {k: tuple(v) for k, v in work.items() if v[0] > 0}


@pytest.mark.parametrize("op", ["write", "read"])
@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED])
def test_work_of_the_cells_rules_is_unchanged(workload, op):
    _, config, _ = harness.cell_files(harness.load_manifest(), workload)
    sai = config["sai"]
    rng = np.random.default_rng(5)
    # the work reads only each image's size
    series = [SimpleNamespace(size=int(n))
              for n in rng.integers(1 << 20, 1 << 28, 8)]
    lens = {v: np.diff([0] + sorted(rng.integers(1, img.size, 40).tolist())
                       + [img.size]).tolist()
            for v, img in enumerate(series)}
    done = [{"version": int(v)} for v in rng.integers(0, 8, 30)]
    done[3]["error"] = "TimeoutError()"
    got = harness._work(done, lens, series, sai, op)
    want = old_work(done, lens, series, sai, op)
    cands = got.pop("candidates", None)
    assert got == want
    if sai["ca"] == "cdc" and op == "write":
        windows = sum(reference.n_windows(series[d["version"]].size,
                                          sai["window"], sai["stride"])
                      for d in done if "error" not in d)
        assert cands == (0.0, 4.0 * windows)
    else:
        assert cands is None


def test_no_successful_write_asks_no_work():
    sai = {"ca": "cdc", "window": 48, "stride": 1}
    done = [{"version": 0, "error": "TimeoutError()"}]
    assert harness._work(done, {0: [10]}, [np.zeros(10, np.uint8)], sai,
                         "write") == {}


@pytest.mark.parametrize("workload", [WRITE_CDC, WRITE_FIXED])
def test_traced_run_keeps_span_meta_parents_and_counters(monkeypatch,
                                                         workload):
    result, run = recorded_run(monkeypatch, workload, trace=True)
    assert result["correct"], result["checks"]
    assert len(run.span_records) == len(run.spans)
    assert [r[:3] for r in run.span_records] == run.spans
    by = {}
    for name, t0, t1, parent, meta in run.span_records:
        by.setdefault(name, []).append((parent, meta))
    assert by["sai/hash/pack"]
    for parent, meta in by["sai/hash/pack"]:
        assert parent == "sai/hash" and meta["chunks"] > 0
    if workload == WRITE_CDC:
        assert by["sai/chunk/scan"]
        for parent, meta in by["sai/chunk/scan"]:
            assert parent == "sai/chunk" and meta["chunks"] > 0
    else:
        assert "sai/chunk/scan" not in by
    # the engine's whole counters, before and after the window
    for when in ("before", "after"):
        assert {"jobs", "launches", "coalesced", "per_device", "policy",
                "heartbeats"} <= set(run.counters[when])
    assert run.counters["after"]["jobs"] > run.counters["before"]["jobs"]


def test_program_stats_hold_every_engine_counter():
    _, config, _ = harness.cell_files(harness.load_manifest(), WRITE_CDC)
    prog = harness.Program(config, torch.device("cpu"))
    try:
        stats = prog.stats()
        assert set(stats) == set(prog.engine.snapshot_stats())
        # a copy: what the run keeps does not change with the engine
        stats["per_device"].clear()
        assert prog.engine.snapshot_stats()["per_device"]
    finally:
        prog.close()
