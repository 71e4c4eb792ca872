"""RA01 — lock discipline.

Attributes declared guarded (``self.attr = ...  # guarded by self._lock``)
may only be read or written inside a ``with <that lock>:`` block of the
same class.  ``threading.Condition(self._lock)`` aliases are understood:
holding the condition *is* holding the lock.

Escapes, in order of preference:

* ``with self._lock:`` around the access (the point of the rule);
* a ``_locked`` name suffix — the method's contract is "caller holds";
* ``# ra: holds self._lock`` on the ``def`` line (same contract, for
  names that can't take the suffix, e.g. condition-variable predicates);
* ``# ra: disable=RA01(reason)`` for the rare justified exception
  (pre-publication writes in ``__init__`` helpers, advisory reads).

``__init__``/``__new__`` bodies are exempt (no concurrency before the
object is published) — but callables *defined* inside them (metric-gauge
lambdas, callbacks) are not: those run later, on other threads.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Set

from .astutil import dotted_name, iter_class_functions
from .engine import Context, Finding, SourceFile

RULE = "RA01"
DESCRIPTION = ("guarded attributes (`# guarded by self._lock`) must only be "
               "touched under `with self._lock:`")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_EXEMPT_METHODS = {"__init__", "__new__"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassInfo:
    def __init__(self) -> None:
        self.guarded: Dict[str, str] = {}  # attr -> guard expr ("self._lock")
        self.aliases: Dict[str, str] = {}  # "self._cv" -> "self._lock"

    def canon(self, lock: str) -> str:
        seen = set()
        while lock in self.aliases and lock not in seen:
            seen.add(lock)
            lock = self.aliases[lock]
        return lock


def _scan_class(cls: ast.ClassDef, src: SourceFile) -> _ClassInfo:
    info = _ClassInfo()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            attr = _self_attr(tgt)
            if attr is None:
                continue
            guard = src.guard_decls.get(node.lineno)
            if not guard and src.comment_only_line(node.lineno - 1):
                guard = src.guard_decls.get(node.lineno - 1)
            if guard:
                info.guarded[attr] = guard
            # self._cv = threading.Condition(self._lock): same lock, two names
            value = node.value
            if (isinstance(value, ast.Call)
                    and (dotted_name(value.func) or "").split(".")[-1]
                    == "Condition"
                    and len(value.args) == 1):
                inner = _self_attr(value.args[0])
                if inner is not None:
                    info.aliases[f"self.{attr}"] = f"self.{inner}"
    return info


def _check_body(nodes: List[ast.AST], held: FrozenSet[str],
                info: _ClassInfo, src: SourceFile,
                out: List[Finding], in_exempt_init: bool) -> None:
    for node in nodes:
        if isinstance(node, ast.With):
            for item in node.items:
                _check_body([item.context_expr], held, info, src, out,
                            in_exempt_init)
            acquired = set()
            for item in node.items:
                name = dotted_name(item.context_expr)
                if name:
                    acquired.add(info.canon(name))
            _check_body(node.body, held | acquired, info, src, out,
                        in_exempt_init)
            continue
        if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
            # nested callable: runs later, possibly on another thread,
            # with no lock held — and the __init__ exemption ends here.
            body = node.body if isinstance(node, _FUNC_NODES) else [node.body]
            _check_body(list(body), frozenset(), info, src, out, False)
            continue
        attr = _self_attr(node)
        if attr is not None and attr in info.guarded and not in_exempt_init:
            guard = info.canon(info.guarded[attr])
            if guard not in held:
                out.append(Finding(
                    src.display, node.lineno, RULE,
                    f"self.{attr} is guarded by {info.guarded[attr]} but "
                    f"accessed outside `with {info.guarded[attr]}:`"))
        _check_body(list(ast.iter_child_nodes(node)), held, info, src, out,
                    in_exempt_init)


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _scan_class(node, src)
        if not info.guarded:
            continue
        for fn in iter_class_functions(node):
            if fn.name.endswith("_locked"):
                continue
            held: Set[str] = set()
            holds = src.fn_holds(fn)
            if holds:
                held.add(info.canon(holds))
            exempt = fn.name in _EXEMPT_METHODS
            out: List[Finding] = []
            _check_body(list(fn.body), frozenset(held), info, src, out,
                        exempt)
            yield from out
