"""Engine for the invariant lint suite.

Shared plumbing for the RA checkers: source loading (AST + comment map via
``tokenize``), the ``# ra:`` directive grammar, waiver filtering, baseline
files, and the fixture self-test used by CI and the unit tests.

Directive grammar (all live in ``#`` comments):

    # ra: disable=RA04(reason why this site is exempt)
        Waives the named rule(s) on this line, or — when placed on a
        ``def`` line — for the whole function.  Multiple rules separate
        with commas; the parenthesised reason is required by convention
        (reviewed like code) but not enforced grammatically.

    # ra: holds self._lock
        On a ``def`` line: RA01 treats the function body as holding the
        named lock (caller-holds-lock contract, like a ``_locked`` suffix).

    # ra: decode-boundary
        On a ``def`` line: RA03 treats the function as a sanctioned decode
        boundary (its callers receive CodecError/WALError, not struct.error).

    # guarded by self._lock
        On a ``self.attr = ...`` assignment: declares the attribute guarded;
        RA01 then requires every touch to sit under ``with self._lock:``
        (or an aliased Condition constructed from it).

    # ra-selftest: RA03
        Fixture marker (tests only): asserts the analysis reports exactly
        this rule at exactly this line.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "AnalysisResult",
    "Context",
    "Finding",
    "SourceFile",
    "all_checkers",
    "format_baseline",
    "load_baseline",
    "run_analysis",
    "selftest",
]

_RULE_RE = re.compile(r"RA\d{2}")
_DISABLE_RE = re.compile(r"ra:\s*disable=(.+)")
_HOLDS_RE = re.compile(r"ra:\s*holds\s+([A-Za-z_][\w.]*)")
_DECODE_RE = re.compile(r"ra:\s*decode-boundary")
_GUARDED_RE = re.compile(r"guarded by\s+([A-Za-z_][\w.]*)")
_SELFTEST_RE = re.compile(r"ra-selftest:\s*(RA\d{2})")


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a specific source location."""

    path: str  # display path (posix, relative to the analysis root)
    line: int
    rule: str  # "RA01" .. "RA06" ("RA00" = file failed to parse)
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass
class Context:
    """Cross-file state shared by all checkers in one run."""

    root: str  # directory findings display relative to; docs/ resolve near it


class SourceFile:
    """A parsed module: AST, comment map, and ``# ra:`` directives."""

    def __init__(self, path: str, display: str, text: str):
        self.path = path
        self.display = display
        self.text = text
        self.tree = ast.parse(text, filename=display)
        # line -> comment text (sans '#'); tokenize is the only stdlib way
        # to recover comments (ast drops them).
        self.comments: Dict[int, str] = {}
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                self.comments[tok.start[0]] = tok.string.lstrip("#").strip()
        self.disables: Dict[int, Set[str]] = {}
        self.holds: Dict[int, str] = {}
        self.decode_boundaries: Set[int] = set()
        self.guard_decls: Dict[int, str] = {}
        self.selftest_marks: Set[Tuple[int, str]] = set()
        for line, comment in self.comments.items():
            m = _DISABLE_RE.search(comment)
            if m:
                self.disables.setdefault(line, set()).update(
                    _RULE_RE.findall(m.group(1)))
            m = _HOLDS_RE.search(comment)
            if m:
                self.holds[line] = m.group(1)
            if _DECODE_RE.search(comment):
                self.decode_boundaries.add(line)
            m = _GUARDED_RE.search(comment)
            if m:
                self.guard_decls[line] = m.group(1)
            for rule in _SELFTEST_RE.findall(comment):
                self.selftest_marks.add((line, rule))
        # (def_line, end_line) spans for def-level waiver scoping
        self._func_spans: List[Tuple[int, int, int]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                end = getattr(node, "end_lineno", node.lineno) or node.lineno
                self._func_spans.append((node.lineno, end, node.lineno))

    def comment_only_line(self, line: int) -> bool:
        """True when `line` holds nothing but a comment — directives on
        such lines apply to the line below them."""
        lines = self.text.splitlines()
        return (1 <= line <= len(lines)
                and lines[line - 1].lstrip().startswith("#"))

    def is_waived(self, rule: str, line: int) -> bool:
        """True if `rule` is disabled at `line` — directly, via a
        standalone comment on the line above, or on the ``def`` line of
        any function enclosing it."""
        if rule in self.disables.get(line, ()):
            return True
        if (rule in self.disables.get(line - 1, ())
                and self.comment_only_line(line - 1)):
            return True
        for start, end, def_line in self._func_spans:
            if start <= line <= end and rule in self.disables.get(def_line, ()):
                return True
        return False

    def fn_holds(self, fn: ast.AST) -> Optional[str]:
        return self.holds.get(getattr(fn, "lineno", -1))

    def fn_is_decode_boundary(self, fn: ast.AST) -> bool:
        return getattr(fn, "lineno", -1) in self.decode_boundaries


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)  # non-waived
    waived: int = 0
    files: int = 0

    def non_baselined(self, baseline: Set[str]) -> List[Finding]:
        return [f for f in self.findings if f.render() not in baseline]


def all_checkers():
    """The registered checker modules, in rule order."""
    from . import (ra01_locks, ra02_stats, ra03_codec, ra04_blocking,
                   ra05_heartbeat, ra06_wiretable)
    return [ra01_locks, ra02_stats, ra03_codec, ra04_blocking,
            ra05_heartbeat, ra06_wiretable]


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".pytest_cache"))
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def _display_path(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:  # different drive (windows) — keep absolute
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def run_analysis(paths: Sequence[str], root: Optional[str] = None,
                 checkers=None) -> AnalysisResult:
    """Run every checker over each ``.py`` file under `paths`.

    Findings come back sorted and with waivers already filtered out;
    `result.waived` counts what the ``# ra: disable`` comments suppressed.
    """
    root = os.path.abspath(root or os.getcwd())
    checkers = checkers if checkers is not None else all_checkers()
    ctx = Context(root=root)
    result = AnalysisResult()
    for path in _iter_py_files(paths):
        display = _display_path(os.path.abspath(path), root)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
            src = SourceFile(path, display, text)
        except (SyntaxError, UnicodeDecodeError, tokenize.TokenError) as exc:
            lineno = getattr(exc, "lineno", None) or 1
            result.findings.append(Finding(
                display, int(lineno), "RA00",
                f"file failed to parse: {type(exc).__name__}"))
            result.files += 1
            continue
        result.files += 1
        for checker in checkers:
            for finding in checker.check(src, ctx):
                if src.is_waived(finding.rule, finding.line):
                    result.waived += 1
                else:
                    result.findings.append(finding)
    result.findings.sort()
    return result


# ---------------------------------------------------------------------------
# baseline files

_BASELINE_HEADER = (
    "# repro_torch invariant-lint baseline — one `path:line RAxx message` "
    "per line.\n"
    "# Regenerate: PYTHONPATH=src python -m repro_torch.analysis "
    "src/repro_torch --write-baseline analysis-baseline-torch.txt\n")


def format_baseline(findings: Sequence[Finding]) -> str:
    lines = sorted(f.render() for f in findings)
    body = "".join(line + "\n" for line in lines)
    return _BASELINE_HEADER + body


def load_baseline(text: str) -> Set[str]:
    out = set()
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


# ---------------------------------------------------------------------------
# fixture self-test

def selftest(fixture_dir: str) -> Tuple[bool, str]:
    """Run the suite over the fixture tree and compare against the
    ``# ra-selftest: RAxx`` markers embedded in the fixtures.

    Exact-match in both directions: every marker must be reported at its
    own (file, line), and nothing unmarked may be reported.  Returns
    ``(ok, human_readable_report)``.
    """
    fixture_dir = os.path.abspath(fixture_dir)
    expected: Set[Tuple[str, int, str]] = set()
    for path in _iter_py_files([fixture_dir]):
        display = _display_path(path, fixture_dir)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = SourceFile(path, display, fh.read())
        except (SyntaxError, tokenize.TokenError):
            continue
        for line, rule in src.selftest_marks:
            expected.add((display, line, rule))
    result = run_analysis([fixture_dir], root=fixture_dir)
    actual = {(f.path, f.line, f.rule) for f in result.findings}
    missing = sorted(expected - actual)
    surprise = sorted(actual - expected)
    lines = [f"selftest: {len(expected)} expected findings, "
             f"{len(actual)} reported, {result.files} fixture files"]
    for path, line, rule in missing:
        lines.append(f"  MISSING  {path}:{line} {rule} "
                     f"(marked in fixture, not reported)")
    for path, line, rule in surprise:
        lines.append(f"  SURPRISE {path}:{line} {rule} "
                     f"(reported, no fixture marker)")
    ok = not missing and not surprise and bool(expected)
    if not expected:
        lines.append("  ERROR: no `# ra-selftest:` markers found — "
                     "wrong fixture directory?")
    lines.append("selftest: " + ("OK" if ok else "FAILED"))
    return ok, "\n".join(lines)
