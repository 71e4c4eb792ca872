"""RA05 — heartbeat coverage for long-lived threads.

Every ``threading.Thread(target=f)`` whose target (transitively, within
the module) contains a ``while`` loop must call ``beat()`` or ``park()``
somewhere in that closure, or carry ``# ra: disable=RA05(reason)`` — on
the ``Thread(...)`` line or the target's ``def``.  The watchdogs can
only notice a stalled loop that *beats*; a loop with no heartbeat is
invisible to the health plane.

Resolution is in-module only: ``target=self._loop`` binds to the method
on the enclosing class, ``target=fn`` to a module-level def, and the
call graph is chased one module deep (``self._main`` calling
``self._loop`` which beats, counts).  Unresolvable targets
(``target=httpd.serve_forever``) are skipped — we can't see their body.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astutil import dotted_name, walk_no_nested_functions
from .engine import Context, Finding, SourceFile

RULE = "RA05"
DESCRIPTION = ("Thread targets with a while loop must beat()/park() a "
               "Heartbeat (or carry an RA05 waiver)")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_Key = Tuple[Optional[str], str]  # (class name or None, function name)


def _collect_functions(tree: ast.Module) -> Dict[_Key, ast.AST]:
    out: Dict[_Key, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, _FUNC_NODES):
            out[(None, node.name)] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, _FUNC_NODES):
                    out[(node.name, sub.name)] = sub
    return out


def _callees(fn: ast.AST, cls: Optional[str],
             funcs: Dict[_Key, ast.AST]) -> Set[_Key]:
    out: Set[_Key] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self" and cls is not None
                and (cls, func.attr) in funcs):
            out.add((cls, func.attr))
        elif isinstance(func, ast.Name) and (None, func.id) in funcs:
            out.add((None, func.id))
    return out


def _closure(start: _Key, funcs: Dict[_Key, ast.AST]) -> List[_Key]:
    seen: Set[_Key] = set()
    work = [start]
    while work:
        key = work.pop()
        if key in seen or key not in funcs:
            continue
        seen.add(key)
        work.extend(_callees(funcs[key], key[0], funcs))
    return sorted(seen, key=str)


def _has_while(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.While) for n in ast.walk(fn))


def _has_beat(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("beat", "park")):
            return True
    return False


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    funcs = _collect_functions(src.tree)

    # walk every Thread(...) call, remembering the enclosing class
    def walk(node: ast.AST, cls: Optional[str]) -> Iterator[ast.Call]:
        for child in ast.iter_child_nodes(node):
            inner_cls = child.name if isinstance(child, ast.ClassDef) else cls
            if isinstance(child, ast.Call):
                name = dotted_name(child.func) or ""
                if name.split(".")[-1] == "Thread":
                    yield child, cls
            yield from walk(child, inner_cls)

    for call, cls in walk(src.tree, None):
        target = next((kw.value for kw in call.keywords
                       if kw.arg == "target"), None)
        if target is None:
            continue
        key: Optional[_Key] = None
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self" and cls is not None):
            key = (cls, target.attr)
        elif isinstance(target, ast.Name):
            key = (None, target.id)
        if key is None or key not in funcs:
            continue  # out-of-module target: nothing to inspect
        closure = _closure(key, funcs)
        bodies = [funcs[k] for k in closure]
        if not any(_has_while(b) for b in bodies):
            continue  # one-shot worker; watchdogs don't apply
        if any(_has_beat(b) for b in bodies):
            continue
        tgt_name = (f"{key[0]}.{key[1]}" if key[0] else key[1])
        finding = Finding(
            src.display, call.lineno, RULE,
            f"thread target {tgt_name}() loops forever but never beat()s "
            f"or park()s a Heartbeat — invisible to the health watchdogs")
        # honour a waiver placed on the target's def line, not just the
        # Thread(...) call site
        def_line = funcs[key].lineno
        if RULE in src.disables.get(def_line, ()):
            continue
        yield finding
