"""RA03 — codec safety on wire/disk bytes.

Scope: modules under ``serve/`` plus the durable-format modules
(``wal.py``, ``castore.py``, ``blockstore.py``) — everywhere bytes arrive
from a socket or disk and are therefore hostile (truncated, bit-flipped,
or adversarial).

Two checks:

* **RA03a — unpack behind a boundary.**  Every ``struct.unpack`` /
  ``Struct.unpack_from`` must sit where ``struct.error``/``IndexError``
  cannot escape raw: an explicit bounds check (a ``len(...)`` call earlier
  in the same function — the repo's ``_take*`` idiom), an enclosing
  ``try`` whose handlers catch struct/index errors and re-raise the
  domain error (``CodecError``/``WALError``/``FrameError``/``AuthError``),
  or a ``# ra: decode-boundary`` annotation on the ``def``.

* **RA03b — length checked before allocation.**  When a value produced by
  an unpack flows into a read/allocation call (``recv``, ``_recv_exact``,
  ``fh.read``, ``bytes``/``bytearray``), some comparison against a
  ``max``-named bound (``max_frame_bytes``, ``MAX_RECORD_BYTES``, ...)
  must appear earlier in the function.  A length field is attacker data;
  allocating first is a one-frame memory bomb.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .astutil import dotted_name, iter_functions, walk_no_nested_functions
from .engine import Context, Finding, SourceFile

RULE = "RA03"
DESCRIPTION = ("struct.unpack on wire bytes needs a bounds check / "
               "decode-boundary; length fields checked vs max before "
               "allocation")

_WIRE_BASENAMES = {"wal.py", "castore.py", "blockstore.py"}
_ALLOC_CALLEES = {"recv", "recv_into", "_recv_exact", "read", "bytes",
                  "bytearray"}
_CAUGHT_OK = {"error", "Exception", "BaseException", "IndexError",
              "ValueError", "struct.error"}


def _in_scope(src: SourceFile) -> bool:
    parts = src.display.split("/")
    return "serve" in parts or parts[-1] in _WIRE_BASENAMES


def _is_unpack(call: ast.Call) -> bool:
    func = call.func
    return (isinstance(func, ast.Attribute)
            and func.attr in ("unpack", "unpack_from"))


def _handler_catches(trynode: ast.Try) -> bool:
    for handler in trynode.handlers:
        if handler.type is None:  # bare except
            return True
        types = (handler.type.elts
                 if isinstance(handler.type, ast.Tuple) else [handler.type])
        for t in types:
            name = dotted_name(t) or ""
            if name in _CAUGHT_OK or name.split(".")[-1] in _CAUGHT_OK:
                return True
    return False


def _tainted_names(fn: ast.AST) -> Set[str]:
    """Names assigned (directly or via tuple unpacking) from an unpack."""
    out: Set[str] = set()
    for node in walk_no_nested_functions(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not (isinstance(value, ast.Call) and _is_unpack(value)):
            continue
        for tgt in node.targets:
            elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for e in elts:
                if isinstance(e, ast.Name):
                    out.add(e.id)
    return out


def _is_bound_check(node: ast.Compare, tainted: Set[str]) -> bool:
    """A comparison that bounds a wire-decoded length: either against a
    ``max``-named cap, or against ``len(<buffer we already hold>)`` with a
    tainted name involved (allocation bounded by bytes in hand)."""
    has_max = False
    has_len = False
    has_taint = False
    for sub in ast.walk(node):
        name = dotted_name(sub)
        if name and "max" in name.lower():
            has_max = True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            has_len = True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            has_taint = True
    return has_max or (has_len and has_taint)


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    if not _in_scope(src):
        return
    # parent-Try map for RA03a
    try_stack: List[ast.Try] = []
    for fn, _cls in iter_functions(src.tree):
        is_boundary = src.fn_is_decode_boundary(fn)
        # line of the first len(...) call in this function, if any
        len_lines = [n.lineno for n in walk_no_nested_functions(fn)
                     if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Name) and n.func.id == "len"]
        first_len = min(len_lines) if len_lines else None
        # enclosing-try info per node, via a scoped walk
        guarded_lines: Set[int] = set()
        def mark_try(node: ast.AST, inside_ok: bool) -> None:
            for child in ast.iter_child_nodes(node):
                ok = inside_ok
                if isinstance(node, ast.Try) and child in node.body:
                    ok = inside_ok or _handler_catches(node)
                if ok and hasattr(child, "lineno"):
                    guarded_lines.add(child.lineno)
                mark_try(child, ok)
        mark_try(fn, False)

        for node in walk_no_nested_functions(fn):
            if not (isinstance(node, ast.Call) and _is_unpack(node)):
                continue
            if is_boundary:
                continue
            if first_len is not None and first_len <= node.lineno:
                continue  # the `_take` idiom: bounds-checked before unpack
            if node.lineno in guarded_lines:
                continue  # inside try whose handlers absorb struct.error
            yield Finding(
                src.display, node.lineno, RULE,
                "struct unpack of wire bytes with no bounds check, no "
                "struct.error handler, and no `# ra: decode-boundary` — "
                "a truncated frame escapes as raw struct.error")

        # RA03b: tainted length -> allocation without a max-bound compare
        tainted = _tainted_names(fn)
        if not tainted:
            continue
        compare_lines = [n.lineno for n in walk_no_nested_functions(fn)
                         if isinstance(n, ast.Compare)
                         and _is_bound_check(n, tainted)]
        first_cmp = min(compare_lines) if compare_lines else None
        for node in walk_no_nested_functions(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else node.func.id if isinstance(node.func, ast.Name)
                      else None)
            if callee not in _ALLOC_CALLEES:
                continue
            uses_taint = any(
                isinstance(sub, ast.Name) and sub.id in tainted
                for arg in node.args for sub in ast.walk(arg))
            if not uses_taint:
                continue
            if first_cmp is not None and first_cmp <= node.lineno:
                continue
            yield Finding(
                src.display, node.lineno, RULE,
                "length decoded from the wire reaches an allocation/read "
                "before any check against a max_*_bytes bound — cap it "
                "first (one hostile frame is a memory bomb)")
