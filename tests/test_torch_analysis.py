"""Tests for the port's invariant lint suite (src/repro_torch/analysis),
mirroring the JAX package's tests/test_analysis.py with its rules
unchanged.

Fixture-driven: each rule has a known-bad and a known-good snippet under
tests/fixtures/analysis/ (the JAX package's fixtures, read only), with
`# ra-selftest: RAxx` markers on exactly the lines the checker must
report.  Plus the end-to-end contract: the port's src/repro_torch tree is
clean and its committed baseline (analysis-baseline-torch.txt)
byte-stable.
"""
import os
import subprocess
import sys

import pytest

from repro_torch.analysis.engine import (SourceFile, format_baseline,
                                         load_baseline, run_analysis,
                                         selftest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis")
SRC_TREE = os.path.join(ROOT, "src", "repro_torch")
BASELINE = os.path.join(ROOT, "analysis-baseline-torch.txt")


def _marks(path, rel_root):
    """Expected (display, line, rule) triples from a fixture's markers."""
    display = os.path.relpath(path, rel_root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as fh:
        src = SourceFile(path, display, fh.read())
    return {(display, line, rule) for line, rule in src.selftest_marks}


# ---------------------------------------------------------------------------
# per-rule: bad fixture reports exactly its markers, good fixture nothing

_BAD_FIXTURES = [
    ("RA01", "ra01_bad.py"),
    ("RA02", "ra02_bad.py"),
    ("RA03", os.path.join("serve", "ra03_bad.py")),
    ("RA04", "ra04_bad.py"),
    ("RA05", "ra05_bad.py"),
]

_GOOD_FIXTURES = [
    ("RA01", "ra01_good.py"),
    ("RA02", "ra02_good.py"),
    ("RA03", os.path.join("serve", "ra03_good.py")),
    ("RA04", "ra04_good.py"),
    ("RA05", "ra05_good.py"),
]


@pytest.mark.parametrize("rule,rel", _BAD_FIXTURES)
def test_bad_fixture_exact_findings(rule, rel):
    path = os.path.join(FIXTURES, rel)
    expected = _marks(path, FIXTURES)
    assert expected, f"fixture {rel} carries no ra-selftest markers"
    assert all(r == rule for _, _, r in expected)
    result = run_analysis([path], root=FIXTURES)
    actual = {(f.path, f.line, f.rule) for f in result.findings}
    assert actual == expected, (
        f"{rule}: reported {sorted(actual)} != marked {sorted(expected)}")


@pytest.mark.parametrize("rule,rel", _GOOD_FIXTURES)
def test_good_fixture_is_clean(rule, rel):
    path = os.path.join(FIXTURES, rel)
    result = run_analysis([path], root=FIXTURES)
    assert result.findings == [], [f.render() for f in result.findings]


def test_ra06_bad_fixture_exact_findings():
    tree = os.path.join(FIXTURES, "ra06_bad")
    svc = os.path.join(tree, "serve", "svc.py")
    expected = _marks(svc, tree)
    result = run_analysis([tree], root=tree)
    actual = {(f.path, f.line, f.rule) for f in result.findings}
    assert actual == expected
    # the three drift families are all present in the messages
    msgs = " | ".join(f.message for f in result.findings)
    assert "OP_NAMES is missing OP_CLOSE" in msgs
    assert "does not handle OP_CLOSE" in msgs
    assert "not documented" in msgs or "drifted" in msgs


def test_ra06_good_fixture_is_clean():
    tree = os.path.join(FIXTURES, "ra06_good")
    result = run_analysis([tree], root=tree)
    assert result.findings == [], [f.render() for f in result.findings]


def test_selftest_whole_fixture_tree():
    ok, report = selftest(FIXTURES)
    assert ok, report


# ---------------------------------------------------------------------------
# waivers and baseline machinery

def test_waiver_suppresses_and_counts(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)  # ra: disable=RA04(test waiver)\n")
    result = run_analysis([str(bad)], root=str(tmp_path))
    assert result.findings == []
    assert result.waived == 1


def test_def_level_waiver_covers_body(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self):  # ra: disable=RA04(whole function exempt)\n"
        "        with self._lock:\n"
        "            time.sleep(1)\n"
        "            time.sleep(2)\n")
    result = run_analysis([str(bad)], root=str(tmp_path))
    assert result.findings == []
    assert result.waived == 2


def test_baseline_roundtrip(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(
        "import time, threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)\n")
    result = run_analysis([str(bad)], root=str(tmp_path))
    assert len(result.findings) == 1
    baseline = load_baseline(format_baseline(result.findings))
    assert result.non_baselined(baseline) == []
    assert result.non_baselined(set()) == result.findings


def test_syntax_error_reports_ra00(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    result = run_analysis([str(bad)], root=str(tmp_path))
    assert [f.rule for f in result.findings] == ["RA00"]


# ---------------------------------------------------------------------------
# end-to-end over the real tree

def test_src_tree_is_clean():
    result = run_analysis([SRC_TREE], root=ROOT)
    assert result.findings == [], [f.render() for f in result.findings]
    # the waivers documented in docs/STATIC_ANALYSIS.md are really there
    # (the port's modules carry the JAX package's)
    assert result.waived > 0


def test_committed_baseline_is_byte_stable():
    result = run_analysis([SRC_TREE], root=ROOT)
    regenerated = format_baseline(result.findings).encode("utf-8")
    with open(BASELINE, "rb") as fh:
        committed = fh.read()
    assert committed == regenerated, (
        "analysis-baseline-torch.txt is stale — regenerate with "
        "--write-baseline analysis-baseline-torch.txt")


def test_wire_doc_matches_code():
    # RA06 runs against the real docs/WIRE_PROTOCOL.md; a clean tree
    # above already proves it, but assert the doc exists and carries all
    # eight opcodes so a doc deletion cannot slip through as "no rows"
    doc = os.path.join(ROOT, "docs", "WIRE_PROTOCOL.md")
    with open(doc, "r", encoding="utf-8") as fh:
        text = fh.read()
    for op in ("OP_OPEN", "OP_WRITE", "OP_READ", "OP_DELETE", "OP_STAT",
               "OP_CLOSE", "OP_STATS", "OP_HEALTH"):
        assert op in text, f"{op} missing from docs/WIRE_PROTOCOL.md"


# ---------------------------------------------------------------------------
# CLI contract (what make lint-invariants / CI actually run)

def _cli(*args, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True)


def test_cli_clean_tree_exits_zero():
    proc = _cli("src/repro_torch", "--baseline",
                "analysis-baseline-torch.txt")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_fixture_violations_exit_nonzero():
    proc = _cli("tests/fixtures/analysis",
                "--root", "tests/fixtures/analysis")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    # correct rule id and file:line on stdout for every rule
    for rule in ("RA01", "RA02", "RA03", "RA04", "RA05", "RA06"):
        assert rule in proc.stdout, f"{rule} missing from CLI output"
    assert "ra01_bad.py:14 RA01" in proc.stdout


def test_cli_selftest_mode():
    proc = _cli("--selftest", "tests/fixtures/analysis")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "selftest: OK" in proc.stdout


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rule in ("RA01", "RA02", "RA03", "RA04", "RA05", "RA06"):
        assert rule in proc.stdout
