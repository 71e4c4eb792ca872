"""RA04 — blocking calls under a lock.

Nothing that can block indefinitely may sit lexically inside a
``with <lock>:`` body: ``queue.get()``/``put()``, socket sends/receives,
``time.sleep``, ``os.fsync``, or ``Future.result()``.  A thread that
blocks while holding a lock stalls every other thread contending for it —
the exact convoy the health watchdogs catch at runtime, caught here at lint
time.

Lock-ish context managers are recognised by name: the final component
contains ``lock``, ``cv``, ``mu``, or ``mutex`` (``self._lock``,
``self._cv``, ``self._wlock``, ``state_lock``, ...).  Queue-ish receivers
likewise (``completion_q``, ``writeq``, ``dev.queue``), so dict
``.get(key, default)`` does not trip the rule.  ``Condition.wait`` is
fine — it releases the lock.  Nested ``def``/``lambda`` bodies are
skipped: defining a callback under a lock is not running it there.

Deliberate exceptions carry ``# ra: disable=RA04(reason)`` — e.g. the
WAL's snapshot fsync, where the lock *is* the commit-point serialiser.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional

from .astutil import dotted_name
from .engine import Context, Finding, SourceFile

RULE = "RA04"
DESCRIPTION = ("no queue.get/put, socket send/recv, time.sleep, os.fsync, "
               "or Future.result() inside `with <lock>:`")

_LOCK_NAME_RE = re.compile(r"(^|_)(lock|cv|mu|mutex)$|wlock|rlock")
_QUEUE_NAME_RE = re.compile(r"(^|_)(q|queue|inq|outq|writeq)$|queue")
_SOCK_NAME_RE = re.compile(r"sock|conn\b")
_SOCK_METHODS = {"send", "sendall", "sendmsg", "recv", "recv_into",
                 "recvmsg", "accept", "connect"}
_FRAME_HELPERS = {"send_frame", "recv_frame", "_recv_exact"}
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    if not name:
        return False
    return bool(_LOCK_NAME_RE.search(name.split(".")[-1].lower()))


def _blocking_reason(call: ast.Call) -> Optional[str]:
    func = call.func
    name = dotted_name(func) or ""
    if name == "time.sleep":
        return "time.sleep holds the lock while dozing"
    if name in ("os.fsync", "os.fdatasync"):
        return f"{name} is a disk-latency stall under the lock"
    if isinstance(func, ast.Name) and func.id in _FRAME_HELPERS:
        return f"{func.id}() does socket I/O under the lock"
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    recv = dotted_name(func.value) or ""
    last = recv.split(".")[-1].lower()
    if attr == "result":
        return "Future.result() blocks until completion under the lock"
    if attr in ("get", "put") and _QUEUE_NAME_RE.search(last):
        block_false = any(
            kw.arg == "block" and isinstance(kw.value, ast.Constant)
            and kw.value.value is False for kw in call.keywords)
        if not block_false:
            return (f"{recv}.{attr}() can block on the queue while the "
                    f"lock is held (pass block=False or move it out)")
    if attr in _SOCK_METHODS and _SOCK_NAME_RE.search(recv.lower()):
        return f"{recv}.{attr}() is socket I/O under the lock"
    return None


def _walk(nodes: List[ast.AST], lock: Optional[str], src: SourceFile,
          out: List[Finding]) -> None:
    for node in nodes:
        if isinstance(node, _FUNC_NODES):
            body = ([node.body] if isinstance(node, ast.Lambda)
                    else list(node.body))
            _walk(body, None, src, out)  # callback body: runs later
            continue
        if isinstance(node, ast.With):
            held = lock
            for item in node.items:
                _walk([item.context_expr], lock, src, out)
                if _is_lockish(item.context_expr):
                    held = dotted_name(item.context_expr)
            _walk(node.body, held, src, out)
            continue
        if lock and isinstance(node, ast.Call):
            reason = _blocking_reason(node)
            if reason:
                out.append(Finding(
                    src.display, node.lineno, RULE,
                    f"blocking call inside `with {lock}:` — {reason}"))
        _walk(list(ast.iter_child_nodes(node)), lock, src, out)


def check(src: SourceFile, ctx: Context) -> Iterator[Finding]:
    out: List[Finding] = []
    _walk(list(src.tree.body), None, src, out)
    yield from out
