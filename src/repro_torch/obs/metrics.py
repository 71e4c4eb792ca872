"""Thread-safe metric primitives backing every layer's ``self.stats``.

Three instrument kinds:

- ``Counter`` — monotonic (or settable) integer, atomic under its own
  lock.  ``CounterGroup`` exposes a set of counters through the old
  plain-dict interface (``stats["jobs"]``, ``dict(stats)``,
  ``{**stats}``) so ``snapshot_stats()`` signatures stay
  backward-compatible while mutation becomes race-free
  (``stats.inc("jobs")``).
- ``Gauge`` — point-in-time value, either set explicitly or computed
  from a callable at read time.
- ``Histogram`` — log-bucketed latency histogram with power-of-two
  nanosecond buckets: ``record()`` is O(1) (one ``bit_length`` + one
  array bump under the histogram lock), ``percentile(p)`` walks the 64
  cumulative buckets and returns the geometric bucket midpoint.  Good
  to ~±41% per bucket, which is what you want from p99 at nanosecond-
  to-minute dynamic range without per-sample storage.

A ``MetricsRegistry`` is the get-or-create namespace each subsystem
owns; ``registry.snapshot()`` renders everything JSON-safe.
"""

from __future__ import annotations

import math
import threading
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterator, Optional, Tuple

_NBUCKETS = 64  # bucket i covers [2^(i-1), 2^i) nanoseconds; bucket 0 = sub-ns


class Counter:
    """Atomic integer counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, value: int) -> None:
        with self._lock:
            self._value = value

    def max_update(self, value: int) -> None:
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value; ``fn`` makes it computed at read time."""

    __slots__ = ("name", "_lock", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def get(self) -> float:
        if self._fn is not None:
            return self._fn()
        return self._value


class Histogram:
    """Log-bucketed latency histogram (seconds in, pow-2 ns buckets)."""

    __slots__ = ("name", "_lock", "_buckets", "_count", "_sum", "_max")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._buckets = [0] * _NBUCKETS
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        ns = int(seconds * 1e9)
        idx = ns.bit_length() if ns > 0 else 0
        if idx >= _NBUCKETS:
            idx = _NBUCKETS - 1
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum_s(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile in seconds (geometric bucket mid)."""
        with self._lock:
            n = self._count
            if n == 0:
                return 0.0
            rank = max(1, math.ceil(n * p / 100.0))
            cum = 0
            for i, c in enumerate(self._buckets):
                cum += c
                if cum >= rank:
                    if i == 0:
                        return 0.0
                    return (2.0 ** (i - 0.5)) / 1e9
            return self._max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total, peak = self._count, self._sum, self._max
        return {
            "count": count,
            "sum_s": total,
            "max_s": peak,
            "p50_s": self.percentile(50.0),
            "p95_s": self.percentile(95.0),
            "p99_s": self.percentile(99.0),
        }

    def buckets(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._buckets)


class CounterGroup(MutableMapping):
    """Plain-dict facade over a set of registry counters.

    Reads (`stats["k"]`, iteration, `dict(stats)`) behave exactly like
    the ad-hoc dicts they replace; writes go through atomic counters:
    ``inc(k, n)`` for the hot `+= 1` sites, ``stats[k] = v`` for the
    rare absolute sets (owner-lock callers), ``max_update`` for
    high-water marks.
    """

    def __init__(self, registry: "MetricsRegistry", keys=(), prefix: str = "") -> None:
        self._registry = registry
        self._prefix = prefix
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        for k in keys:
            self._counters[k] = registry.counter(prefix + k)

    def _ensure(self, key: str) -> Counter:
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.get(key)
                if c is None:
                    c = self._registry.counter(self._prefix + key)
                    self._counters[key] = c
        return c

    def inc(self, key: str, n: int = 1) -> None:
        self._ensure(key).inc(n)

    def max_update(self, key: str, value: int) -> None:
        self._ensure(key).max_update(value)

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._ensure(key).set(value)

    def __delitem__(self, key: str) -> None:
        with self._lock:
            del self._counters[key]

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._counters))

    def __len__(self) -> int:
        return len(self._counters)

    def __eq__(self, other) -> bool:
        if isinstance(other, (dict, CounterGroup)):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"CounterGroup({dict(self)!r})"


class MetricsRegistry:
    """Get-or-create namespace of counters, gauges, and histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def group(self, keys=(), prefix: str = "") -> CounterGroup:
        return CounterGroup(self, keys, prefix)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {n: g.get() for n, g in gauges.items()},
            "histograms": {n: h.summary() for n, h in hists.items()},
        }
