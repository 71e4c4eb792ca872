"""Small AST helpers shared by the RA checkers."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

__all__ = [
    "dotted_name",
    "iter_functions",
    "iter_class_functions",
    "walk_no_nested_functions",
]

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``self._cv`` / ``threading.Thread`` as a string, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def iter_functions(tree: ast.Module) -> Iterator[
        Tuple[ast.AST, Optional[str]]]:
    """Yield (function_node, enclosing_class_name) for every def in the
    module, including methods and nested functions."""
    def walk(node: ast.AST, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, _FUNC_NODES):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


def iter_class_functions(cls: ast.ClassDef) -> Iterator[ast.AST]:
    """Direct methods of a class (no nested functions, no inner classes)."""
    for child in cls.body:
        if isinstance(child, _FUNC_NODES):
            yield child


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested def/lambda bodies —
    lexical analyses use this so code that merely *defines* a callback is
    not confused with code that runs on the current thread."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, _FUNC_NODES + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(cur))
