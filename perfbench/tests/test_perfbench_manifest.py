"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds and budgets, and that every file a cell or metric is found by is
there."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {c["name"]: c for c in MANIFEST["workloads"]}
# entries kept for a cell that is not in BENCHMARK.json yet: they follow
# the same rules, so a later change can move them in as they are
KEPT = json.loads((HERE / "tests" / "restore_cell.json").read_text())
KEPT_METRICS = KEPT["end_to_end"] + KEPT["per_layer"]
KEPT_CELLS = {c["name"]: c for c in KEPT["workloads"]}
# the write cells' host-clock rate and the host stages that move it, out
# of BENCHMARK.json while no host-clock rate of a write holds a bound
# (PERF.md, section 2): kept under the same rules, so a later change can
# move them back in as they are
HOST = json.loads((HERE / "tests" / "host_path.json").read_text())
HOST_METRICS = HOST["end_to_end"] + HOST["per_layer"]


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 \
        <= 43200


def test_names_units_and_lines():
    names = [m["name"] for m in METRICS] + list(CELLS) \
        + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in MANIFEST["workloads"]:
        assert NAME.match(c["traffic"]) and line_ok(c["why"])
        assert c["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16


def test_entry_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in MANIFEST["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_ok(m["layer"])


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def reported(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_enough():
    e2e = MANIFEST["end_to_end"]
    for cell in CELLS:
        got = [m["name"] for m in e2e if reported(m, cell)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(reported(m, cell) for m in MANIFEST["per_layer"]), cell


def test_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", list(CELLS)):
            assert cell in CELLS
            assert reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_one_layer_name_per_module():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_rooflines_are_named_by_kernel():
    for m in METRICS:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert re.match(r"^[a-z0-9_]+_roofline(\.[a-z]+)?$", m["name"])


def test_configs_used_and_files_under_paths():
    used = {c["config"] for c in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(c["chips"] == 4 for c in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_kept_entries_follow_the_rules():
    names = [m["name"] for m in METRICS + KEPT_METRICS] \
        + list(CELLS) + list(KEPT_CELLS)
    assert len(names) == len(set(names))
    configs = {c["name"] for c in MANIFEST["configs"]}
    for c in KEPT["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and line_ok(c["why"])
        assert c["config"] in configs and c["chips"] == 1
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"] + KEPT["end_to_end"]}
    for m in KEPT_METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(KEPT_CELLS)
    for m in KEPT["per_layer"]:
        assert line_ok(m["layer"]) and m["moves"] in e2e
        assert all(reported(e2e[m["moves"]], c) for c in m["workloads"])


def test_host_path_entries_follow_the_rules():
    names = [m["name"] for m in METRICS + KEPT_METRICS + HOST_METRICS]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in HOST["end_to_end"]}
    for m in HOST["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in HOST_METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(CELLS)
    for m in HOST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    METRICS + KEPT_METRICS + HOST_METRICS])
def test_every_metric_has_a_reader(metric):
    stems = (metric, metric.split(".")[0])
    assert any((HERE / "metrics" / f"{s}.py").exists() for s in stems)


@pytest.mark.parametrize("cell", list(CELLS) + list(KEPT_CELLS))
def test_every_traffic_mix_has_its_file(cell):
    entry = {**CELLS, **KEPT_CELLS}[cell]
    t = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    assert t["op"] in ("write", "read")


def test_files_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if p.is_file() and "out" not in p.relative_to(HERE).parts \
                and "__pycache__" not in p.parts:
            rel = str(p.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
