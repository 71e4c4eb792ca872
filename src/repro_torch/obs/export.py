"""Exposition helpers: Prometheus text format + slow-log dumps.

The gateway's ``snapshot_stats()`` is a nested JSON-safe tree (gateway
+ engine ``per_device`` + runtime + WAL + blockstore + obs).
``flatten`` walks it into ``path/to/leaf -> number`` pairs and
``prometheus_text`` renders those as one-metric-per-line text
exposition, so any scraper can consume the same snapshot the
``OP_STATS`` wire verb returns.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Mapping, Tuple

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

# leaf names that are monotonically increasing in the snapshot tree;
# everything else is exposed as a gauge (point-in-time semantics)
_COUNTER_LEAVES = frozenset({
    "count", "beats", "jobs", "launches", "bytes", "coalesced",
    "appends", "fsyncs", "snapshots", "flush_waits", "frames",
    "dispatched", "submitted", "completed", "rejected", "errors",
    "bytes_in", "bytes_out", "admission_rejections", "puts",
    "skipped_puts", "replaced", "drops", "flushes", "scanned_records",
    "scrubbed_blocks", "corrupt_found", "repairs_enqueued", "evals",
    "samples", "stats_truncated", "manager_restarts", "finished",
})


def _escape_key(key) -> str:
    """Percent-escape the path separator (and '%' itself) in one tree
    key, so a tenant named ``a/b`` can't flatten to the same metric name
    as the genuinely nested path ``a -> b``."""
    k = str(key)
    if "%" in k or "/" in k:
        k = k.replace("%", "%25").replace("/", "%2F")
    return k


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, float]:
    """Flatten a nested stats tree to {joined/key: numeric leaf}.

    ``/`` inside a single key is escaped as ``%2F`` (and ``%`` as
    ``%25``): distinct tree paths always flatten to distinct names, and
    consumers that split on ``/`` (the health rules, prometheus_text)
    recover the exact component boundaries."""
    out: Dict[str, float] = {}
    for key, value in tree.items():
        ekey = _escape_key(key)
        path = f"{prefix}/{ekey}" if prefix else ekey
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        elif isinstance(value, bool):
            out[path] = 1.0 if value else 0.0
        elif isinstance(value, (int, float)):
            out[path] = float(value)
        elif isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                if isinstance(item, Mapping):
                    out.update(flatten(item, f"{path}/{i}"))
                elif isinstance(item, (int, float)) and not isinstance(item, bool):
                    out[f"{path}/{i}"] = float(item)
        # strings and other non-numeric leaves are dropped from exposition
    return out


def metric_name(path: str, namespace: str = "repro") -> str:
    name = _NAME_BAD.sub("_", path.replace("/", "_"))
    return f"{namespace}_{name}" if namespace else name


def _render_value(value: float) -> str:
    # Prometheus exposition spells non-finite values +Inf/-Inf/NaN;
    # Python's repr() renders inf/nan (invalid), and int(value) raises
    # on them outright, so the finiteness check must come first.
    if not math.isfinite(value):
        if math.isnan(value):
            return "NaN"
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(value)


def prometheus_text(tree: Mapping, namespace: str = "repro") -> str:
    """Render a nested stats tree as Prometheus text exposition,
    including ``# TYPE`` metadata (counter for known monotonic leaf
    names, gauge otherwise)."""
    lines: List[str] = []
    for path, value in sorted(flatten(tree).items()):
        name = metric_name(path, namespace)
        leaf = path.rsplit("/", 1)[-1]
        mtype = "counter" if leaf in _COUNTER_LEAVES else "gauge"
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {_render_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def truncate_tree(tree: Mapping, max_bytes: int,
                  reserve: int = 64) -> Tuple[Dict, int]:
    """Deterministically shrink ``tree`` until its sorted-JSON encoding
    fits ``max_bytes``: drop the deepest mapping subtrees first (coarse
    per-device/per-tenant detail goes before headline counters), then
    scalar leaves bottom-up as a last resort.  Returns ``(pruned_copy,
    dropped_subtree_count)`` — the copy carries a root
    ``stats_truncated`` marker when anything was dropped.

    Used to bound ``OP_STATS`` / ``OP_HEALTH`` replies against
    ``max_frame_bytes`` instead of letting an overgrown stats tree kill
    the connection with an oversized frame.
    """
    out = json.loads(json.dumps(tree, sort_keys=True))  # deep JSON-safe copy
    budget = max(256, int(max_bytes) - reserve)
    dropped = 0

    def size() -> int:
        return len(json.dumps(out, sort_keys=True).encode("utf-8"))

    def mapping_depths(node, depth=0):
        yield depth, node
        for key in sorted(node):
            child = node[key]
            if isinstance(child, dict):
                yield from mapping_depths(child, depth + 1)

    while size() > budget:
        deepest = max(d for d, _ in mapping_depths(out))
        if deepest > 0:
            # prune every mapping at the deepest level in one pass
            def prune(node, depth=0):
                nonlocal dropped
                for key in sorted(node):
                    child = node[key]
                    if isinstance(child, dict):
                        if depth + 1 == deepest:
                            node[key] = "<truncated>"
                            dropped += 1
                        else:
                            prune(child, depth + 1)
            prune(out)
        else:
            # only root scalars left: drop keys from the sort tail
            keys = sorted(k for k in out if k != "stats_truncated")
            if not keys:
                break
            del out[keys[-1]]
            dropped += 1
        out["stats_truncated"] = dropped
    if dropped:
        out["stats_truncated"] = dropped
    return out, dropped


def dump_slow_log(entries: List[Dict], path: str) -> bool:
    """Write the slow-request span trees to ``path`` (JSON).

    Only writes when there is something to report; returns whether a
    file was written, so CI can upload the artifact conditionally.
    """
    if not entries:
        return False
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"slow_requests": entries}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return True
