"""The FastCDC deployment (``cas-gear``): its plain reference
(``chunkers/fastcdc.py``) against a literal byte-by-byte loop of the
paper's Algorithm 1, its device work, the readers of its two metrics
(``gear_roofline``, ``sai_scan_candidates``), the harness's device work
for the rule, and a small traced run of the cell on the CPU."""
import ast
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _perfbench_small import SMALL, WRITE_CDC, manifest, small_run

from perfbench import devtrace, harness, reference

ROOT = Path(__file__).resolve().parents[2]
CELL = "cas-gear.ckpt-write"
FASTCDC = reference.chunker("fastcdc")
MASK = 0xFFFFFFFF
# 12 and 8 one-bits with bit 31 set, for kilobyte chunks: both masks cut
SAI = {"ca": "fastcdc", "avg_chunk": 1024, "min_chunk": 256,
       "max_chunk": 4096, "mask_s": 0xA5292492, "mask_l": 0x91111110}
GPU = {"sms": 132, "sm_clock_hz": 1.98e9}


def algorithm1(data: bytes, sai):
    """Chunk ends by FastCDC's Algorithm 1, one byte a step, with the
    configuration's departures: the fingerprint is never restarted, and
    a chunk of length i ends after the byte (i - 1) whose fingerprint
    matched."""
    gear = [FASTCDC.fmix32(b + 1) for b in range(256)]
    fp, h = 0, []
    for b in data:
        fp = ((fp << 1) + gear[b]) & MASK
        h.append(fp)
    out, last = [], 0
    while last < len(data):
        n = len(data) - last
        normal = sai["avg_chunk"]
        if n <= sai["min_chunk"]:
            last += n
            out.append(last)
            continue
        if n >= sai["max_chunk"]:
            n = sai["max_chunk"]
        elif n <= normal:
            normal = n
        i = sai["min_chunk"]
        while i < normal and h[last + i - 1] & sai["mask_s"]:
            i += 1
        if i == normal:
            while i < n and h[last + i - 1] & sai["mask_l"]:
                i += 1
        last += i
        out.append(last)
    return out


def _images():
    rng = np.random.default_rng(17)
    return {"random": rng.integers(0, 256, 50001, np.uint8),
            "zeros": np.zeros(20000, np.uint8),
            "periodic": np.resize(rng.integers(0, 256, 777, np.uint8),
                                  30000),
            "short": rng.integers(0, 256, 200, np.uint8),
            "tail": rng.integers(0, 256, 1500, np.uint8)}


@pytest.mark.parametrize("name", list(_images()))
def test_bounds_equal_algorithm1(name):
    img = _images()[name]
    assert FASTCDC.bounds(img, SAI, "cpu") == algorithm1(img.tobytes(), SAI)


def test_bounds_in_blocks_equal_one_block(monkeypatch):
    """Fingerprints computed block by block carry each block's 31 bytes
    of history over the seam."""
    img = _images()["random"]
    whole = FASTCDC.bounds(img, SAI, "cpu")
    monkeypatch.setattr(FASTCDC, "BLOCK", 4099)
    assert FASTCDC.bounds(img, SAI, "cpu") == whole


def test_both_masks_cut_and_sizes_hold():
    ends = FASTCDC.bounds(_images()["random"], SAI, "cpu")
    lens = np.diff([0] + ends)[:-1]
    assert np.any(lens < SAI["avg_chunk"]) and np.any(lens > SAI["avg_chunk"])
    assert lens.min() >= SAI["min_chunk"] and lens.max() <= SAI["max_chunk"]


def _chip_smoke_constant(name):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and [getattr(t, "id", None) for t in node.targets] == [name]:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_work_and_frozen_gear_count():
    assert FASTCDC.GEAR_OPS_PER_BYTE \
        == _chip_smoke_constant("GEAR_OPS_PER_BYTE") == 10
    L = 268435456
    assert FASTCDC.work(L, SAI) == {"gear": (10.0 * L, 5.0 * L),
                                    "candidates": (0.0, 4.0 * L)}


@pytest.mark.parametrize("op", ["write", "read"])
def test_harness_work_for_fastcdc(op):
    """``harness._work`` sums the rule's gear and candidates work over
    each successful write, and asks none for a read."""
    rng = np.random.default_rng(23)
    series = [SimpleNamespace(size=int(n))
              for n in rng.integers(1 << 20, 1 << 28, 8)]
    lens = {v: [img.size] for v, img in enumerate(series)}
    done = [{"version": int(v)} for v in rng.integers(0, 8, 20)]
    done[2]["error"] = "TimeoutError()"
    got = harness._work(done, lens, series, SAI, op)
    sizes = sum(series[d["version"]].size for d in done if "error" not in d)
    if op == "write":
        assert got["gear"] == (10.0 * sizes, 5.0 * sizes)
        assert got["candidates"] == (0.0, 4.0 * sizes)
    else:
        assert "gear" not in got and "candidates" not in got
    assert got["md5_direct"][0] > 0


def _run_with_gear_trace():
    run = harness.Run(op="write", t0=100.5, t1=104.5)
    run.gpu = GPU
    run.device = devtrace.DeviceTrace([
        ("(anonymous namespace)::gear_kernel(unsigned char const*)", 101.0,
         101.2),
        ("candidate_count_kernel<1, 2>", 101.2, 101.3),
        ("md5_direct_kernel", 101.4, 101.5)], 100.5, 104.5)
    run.work = {"gear": (0.0, 3.35e12 * 0.1), "md5_direct": (1.0, 1.0)}
    return run


def test_gear_roofline_reads_the_gear_kernel_alone():
    run = _run_with_gear_trace()
    assert harness.reader("gear_roofline")(run) == pytest.approx(50.0)
    del run.work["gear"]                # a rule that hashes no gear
    assert harness.reader("gear_roofline")(run) is None


def test_scan_candidates_reader():
    run = harness.Run(op="write")
    run.span_records = [
        ("sai/chunk/scan", 0.0, 0.1, "sai/chunk", {"chunks": 3,
                                                   "candidates": 100,
                                                   "forced": 0}),
        ("sai/chunk/scan", 1.0, 1.1, "sai/chunk", {"chunks": 3,
                                                   "candidates": 140,
                                                   "forced": 1}),
        ("sai/hash/pack", 0.2, 0.3, "sai/hash", {"rows": 3})]
    assert harness.reader("sai_scan_candidates")(run) == 120.0
    # a program whose scan spans carry no such meta, or have no scan
    for rec in run.span_records:
        rec[4].pop("candidates", None)
    assert harness.reader("sai_scan_candidates")(run) is None
    assert harness.reader("sai_scan_candidates")(harness.Run(op="write")) \
        is None


def test_traced_small_run_of_the_cell(monkeypatch):
    """Correct on the CPU, with the rule's device work recorded for the
    rooflines and the candidates walked reported; a CPU run has no card,
    so no roofline share."""
    runs = []
    real = harness.reader

    def spy(name):
        read = real(name)

        def wrapped(run):
            runs.append(run)
            return read(run)
        return wrapped
    monkeypatch.setattr(harness, "reader", spy)
    r = harness.run_cell(manifest(), CELL, 2 ** 31 + 11, 1.5, True,
                         torch.device("cpu"), time.perf_counter(),
                         scale=SMALL)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    got = r["metrics"]
    assert got["sai_scan_candidates"]["value"] > 0
    assert got["sai_scan_candidates"]["unit"] == "candidates/write"
    assert got["sai_slide_ms"]["value"] > 0 and got["sai_scan_ms"]["value"]
    assert "sliding_md5_roofline" not in got and "gear_roofline" not in got
    size = SMALL["traffic"]["series"]["image_bytes"]
    assert runs[0].work["gear"] == (10.0 * size * runs[0].ops_done,
                                    5.0 * size * runs[0].ops_done)


def test_cdc_cell_reports_its_candidates():
    r = small_run(WRITE_CDC, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["sai_scan_candidates"]["value"] > 0


@pytest.mark.parametrize("sai", [
    {"ca": "cdc-gear"},                          # the low-bits gear rule
    {"mask_s": 0xD9000353, "mask_l": 0xD641C0D7}])   # the masks swapped
def test_check_refuses_another_rule(sai):
    """The program chunking by another rule than the configuration's is
    not correct: the reference tells the rules apart."""
    r = small_run(CELL, control={"config": {"sai": sai}})
    assert not r["correct"]
    assert r["checks"]["boundary_mismatch"]["value"] > 0
