"""Per-request trace spans with a bounded completed-trace ring.

A ``Trace`` is minted when a request with a nonzero trace id (packed
into the request frame header by ``GatewayClient._rpc``) is admitted,
and spans are attached as the request crosses layers: transport
decode, WDRR queue wait, SAI queue/chunk/hash/store and their stages,
engine queue/launch/stage/wait/finish (per device, per lane), WAL
group-commit fsync.  Each span names the span that caused it
(``parent``), so the tree is rebuilt without guessing from intervals
(the tree: docs/TRACING_TORCH.md).
Span producers run on different threads (scheduler, pipeline stages,
manager threads), so ``add_span`` takes the per-trace lock.

Completed traces land in ``Tracer``'s bounded ring (``capacity``
newest survive); traces slower than ``slow_threshold_s`` additionally
have their full span tree serialized into the slow-request log ring,
which benchmarks dump to ``obs-slowlog.json`` for the CI artifact.

All timestamps are ``time.perf_counter()`` — monotonic, comparable
only within a process, which is all span nesting needs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional


class Span:
    """One timed stage of a request.  ``parent`` names the span that
    caused it (None at the top of the request's tree); spans of one
    request share their ``Trace``'s ``trace_id``."""
    __slots__ = ("name", "t0", "t1", "meta", "parent")

    def __init__(self, name: str, t0: float, t1: float,
                 meta: Optional[Dict] = None,
                 parent: Optional[str] = None) -> None:
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.meta = meta or {}
        self.parent = parent

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "duration_s": self.t1 - self.t0}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.meta:
            d["meta"] = dict(self.meta)
        return d


class Trace:
    __slots__ = ("trace_id", "name", "t0", "t1", "meta", "spans", "_lock")

    def __init__(self, trace_id: int, name: str, t0: Optional[float] = None,
                 **meta) -> None:
        self.trace_id = trace_id
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1 = 0.0
        self.meta = dict(meta)
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def add_span(self, name: str, t0: float, t1: float,
                 parent: Optional[str] = None, **meta) -> Span:
        span = Span(name, t0, t1, meta or None, parent)
        with self._lock:
            self.spans.append(span)
        return span

    def finish(self, t1: Optional[float] = None) -> None:
        self.t1 = time.perf_counter() if t1 is None else t1

    @property
    def duration_s(self) -> float:
        return (self.t1 or time.perf_counter()) - self.t0

    def to_dict(self) -> Dict:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "t0": self.t0,
            "duration_s": self.duration_s,
            "meta": dict(self.meta),
            "spans": spans,
        }


class Tracer:
    """Bounded ring of completed traces + slow-request log."""

    def __init__(self, capacity: int = 256, slow_threshold_s: float = 1.0,
                 slow_capacity: int = 64) -> None:
        self.slow_threshold_s = float(slow_threshold_s)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._slow: deque = deque(maxlen=max(1, int(slow_capacity)))
        self._finished = 0
        self._slow_count = 0

    def start(self, trace_id: int, name: str, t0: Optional[float] = None,
              **meta) -> Trace:
        return Trace(trace_id, name, t0=t0, **meta)

    def finish(self, trace: Trace, t1: Optional[float] = None) -> None:
        trace.finish(t1)
        slow = trace.duration_s >= self.slow_threshold_s
        with self._lock:
            self._ring.append(trace)
            self._finished += 1
            if slow:
                self._slow.append(trace.to_dict())
                self._slow_count += 1

    def completed(self) -> List[Trace]:
        with self._lock:
            return list(self._ring)

    def slow_entries(self) -> List[Dict]:
        with self._lock:
            return list(self._slow)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "finished": self._finished,
                "in_ring": len(self._ring),
                "slow": self._slow_count,
                "slow_threshold_s": self.slow_threshold_s,
            }
