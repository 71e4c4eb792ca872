"""RA02 — raw stats mutation.

``self.stats[k] += n`` (and friends) on a ``CounterGroup`` is a lost-update
race: read-modify-write of an atomic counter outside its lock.  Such sites
are all fixed; this rule keeps them out.  Use ``stats.inc(k, n)`` /
``stats.max_update(k, v)`` instead.  Plain assignment ``stats[k] = v`` is
allowed — ``CounterGroup.__setitem__`` routes through the atomic
``Counter.set`` — but calling ``__setitem__``/``setdefault``/``update``
explicitly to smuggle a dict-style mutation is not.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .astutil import dotted_name
from .engine import Context, Finding, SourceFile

RULE = "RA02"
DESCRIPTION = ("no `stats[k] += n` / `__setitem__` on a CounterGroup — "
               "use .inc()/.max_update()")

# attribute / variable names that hold CounterGroup instances in this repo
_STATS_NAMES = {"stats", "read_stats", "counters"}


def _stats_receiver(node: ast.AST) -> Optional[str]:
    """'self.stats' / 'stats' / 'eng.read_stats' if `node` looks like a
    CounterGroup reference, else None."""
    name = dotted_name(node)
    if name and name.split(".")[-1] in _STATS_NAMES:
        return name
    return None


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.AugAssign):
            tgt = node.target
            if isinstance(tgt, ast.Subscript):
                recv = _stats_receiver(tgt.value)
                if recv:
                    yield Finding(
                        src.display, node.lineno, RULE,
                        f"`{recv}[k] {type(node.op).__name__.lower()}=` is a "
                        f"read-modify-write race on a CounterGroup — use "
                        f"`{recv}.inc(k, n)` / `.max_update(k, v)`")
        elif isinstance(node, ast.Call):
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in ("__setitem__", "setdefault", "update")):
                recv = _stats_receiver(func.value)
                if recv:
                    yield Finding(
                        src.display, node.lineno, RULE,
                        f"`{recv}.{func.attr}(...)` bypasses the atomic "
                        f"counter API — use `{recv}.inc()` / "
                        f"`.max_update()` / plain `{recv}[k] = v`")
