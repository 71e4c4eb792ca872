"""RA06 — wire-table drift.

Any module defining the opcode constants (``(OP_OPEN, ...) = range(n)``)
is cross-checked three ways:

* **OP_NAMES**: the human-name map must cover exactly the defined
  opcodes — a new verb (``OP_STATS``, ``OP_HEALTH``) that skips the map
  breaks tracing labels silently.
* **codec + dispatch coverage**: each of ``encode_request`` /
  ``decode_request`` / ``encode_response`` / ``decode_response`` (when
  present) and the dispatch function (name containing ``handle`` or
  ``dispatch``, referencing ≥ 2 opcodes) must reference every opcode —
  a verb the decoder accepts but the dispatcher ignores is a hang, not
  an error.
* **documented table**: ``docs/WIRE_PROTOCOL.md`` (located by walking up
  from the module towards the analysis root) must carry a markdown table
  row ``| OP_X | value |`` for every opcode, with matching values, and
  no rows for opcodes the code no longer defines.

All findings are reported against the module (at the constant-definition
or offending-function line) so fixtures and waivers stay in one file.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import Context, Finding, SourceFile

RULE = "RA06"
DESCRIPTION = ("opcode constants vs OP_NAMES vs codec/dispatch coverage vs "
               "the documented wire table must agree")

_CODEC_FUNCS = ("encode_request", "decode_request",
                "encode_response", "decode_response")
_DOC_NAME = os.path.join("docs", "WIRE_PROTOCOL.md")
_DOC_ROW_RE = re.compile(r"^\|\s*`?(OP_[A-Z_]+)`?\s*\|\s*(\d+)\s*\|")


def _opcode_constants(tree: ast.Module) -> Tuple[Dict[str, int], int]:
    """Parse ``(OP_A, OP_B, ...) = range(n)`` → ({name: value}, lineno)."""
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Tuple):
            continue
        names = [e.id for e in tgt.elts
                 if isinstance(e, ast.Name) and e.id.startswith("OP_")]
        if len(names) != len(tgt.elts) or not names:
            continue
        value = node.value
        if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
                and value.func.id == "range"):
            return {name: i for i, name in enumerate(names)}, node.lineno
    return {}, 0


def _names_referenced(fn: ast.AST, universe: Set[str]) -> Set[str]:
    return {n.id for n in ast.walk(fn)
            if isinstance(n, ast.Name) and n.id in universe}


def _find_doc(src_path: str, root: str) -> Optional[str]:
    """Nearest docs/WIRE_PROTOCOL.md walking up from the module to root."""
    cur = os.path.dirname(os.path.abspath(src_path))
    root = os.path.abspath(root)
    for _ in range(32):
        cand = os.path.join(cur, _DOC_NAME)
        if os.path.isfile(cand):
            return cand
        if cur == root or os.path.dirname(cur) == cur:
            break
        cur = os.path.dirname(cur)
    cand = os.path.join(root, _DOC_NAME)
    return cand if os.path.isfile(cand) else None


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    opcodes, def_line = _opcode_constants(src.tree)
    if not opcodes:
        return
    universe = set(opcodes)

    # --- OP_NAMES map coverage -------------------------------------------
    for node in src.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "OP_NAMES"
                and isinstance(node.value, ast.Dict)):
            keys = {k.id for k in node.value.keys
                    if isinstance(k, ast.Name) and k.id in universe}
            for missing in sorted(universe - keys):
                yield Finding(
                    src.display, node.lineno, RULE,
                    f"OP_NAMES is missing {missing} — tracing/QoS labels "
                    f"for that verb fall back to nothing")

    # --- codec + dispatch coverage ---------------------------------------
    fns: List[Tuple[str, ast.AST]] = []
    def collect(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append((child.name, child))
            collect(child)
    collect(src.tree)

    for fname, fn in fns:
        wanted = fname in _CODEC_FUNCS
        if not wanted and ("handle" in fname or "dispatch" in fname):
            wanted = len(_names_referenced(fn, universe)) >= 2
        if not wanted:
            continue
        referenced = _names_referenced(fn, universe)
        for missing in sorted(universe - referenced):
            yield Finding(
                src.display, fn.lineno, RULE,
                f"{fname}() does not handle {missing} — drift between the "
                f"opcode table and the {fname} switch")

    # --- documented table -------------------------------------------------
    doc_path = _find_doc(src.path, ctx.root)
    if doc_path is None:
        yield Finding(
            src.display, def_line, RULE,
            f"no {_DOC_NAME} found for the opcode table — the wire "
            f"protocol must be documented where reviewers can diff it")
        return
    doc_rows: Dict[str, int] = {}
    with open(doc_path, "r", encoding="utf-8") as fh:
        for line in fh:
            m = _DOC_ROW_RE.match(line.strip())
            if m:
                doc_rows[m.group(1)] = int(m.group(2))
    for name, value in sorted(opcodes.items()):
        if name not in doc_rows:
            yield Finding(
                src.display, def_line, RULE,
                f"{name} (= {value}) is not documented in {_DOC_NAME}")
        elif doc_rows[name] != value:
            yield Finding(
                src.display, def_line, RULE,
                f"{name} is {value} in code but {doc_rows[name]} in "
                f"{_DOC_NAME} — the documented table has drifted")
    for name in sorted(set(doc_rows) - universe):
        yield Finding(
            src.display, def_line, RULE,
            f"{_DOC_NAME} documents {name}, which the code no longer "
            f"defines — stale table row")
