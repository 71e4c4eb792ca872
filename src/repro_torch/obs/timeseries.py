"""Rolling time-series over the gateway stats tree.

:class:`MetricsSampler` periodically snapshots a stats callback
(normally ``StorageGateway`` internals), flattens each tree with
:func:`repro_torch.obs.export.flatten`, and keeps ``(t, flat)`` pairs in a
bounded ring.  Diffing consecutive samples turns the stack's cumulative
counters into windowed rates — writes/s, hashed bytes/s, per-device
launches/s, WDRR queue-wait trend — without any layer having to
maintain its own rate state.

The sampler is also the data plane for
:class:`repro_torch.obs.health.HealthEngine`: heartbeat ages, device
slowdowns, lane depths, and QoS histogram buckets are all read from
the same ring.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .export import flatten

__all__ = ["MetricsSampler"]


class MetricsSampler:
    """Background sampler: bounded ring of flattened stats snapshots.

    ``snapshot_fn`` must return a JSON-safe nested stats tree.  The
    ring holds at most ``capacity`` samples; ``window_s`` bounds how
    far back ``delta``/``rate``/``series`` reach.  ``start()`` spawns
    the daemon thread; ``sample_once()`` works without it (used by the
    on-demand ``OP_HEALTH`` path when the background plane is off)."""

    def __init__(self, snapshot_fn: Callable[[], Mapping],
                 interval_s: float = 0.25, capacity: int = 240,
                 window_s: float = 5.0,
                 listeners: Optional[List[Callable]] = None):
        self.snapshot_fn = snapshot_fn
        self.interval_s = max(0.01, float(interval_s))
        self.capacity = max(2, int(capacity))
        self.window_s = max(self.interval_s, float(window_s))
        self.samples: List[Tuple[float, Dict[str, float]]] = []
        self._listeners: List[Callable] = list(listeners or [])
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors = 0

    # -- lifecycle ---------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "MetricsSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="obs-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def add_listener(self, fn: Callable) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _loop(self) -> None:  # ra: disable=RA05(the sampler is the health plane's clock; the metrics_sampler_stalled SLO rule is its watchdog)
        while not self._stop.is_set():
            self.sample_once()
            self._stop.wait(self.interval_s)

    # -- sampling ----------------------------------------------------

    def sample_once(self) -> Optional[Dict[str, float]]:
        try:
            flat = flatten(self.snapshot_fn())
        except Exception:
            self.errors += 1
            return None
        now = time.perf_counter()
        with self._lock:
            self.samples.append((now, flat))
            if len(self.samples) > self.capacity:
                del self.samples[: len(self.samples) - self.capacity]
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn()
            except Exception:
                self.errors += 1
        return flat

    # -- window reads ------------------------------------------------

    def latest_flat(self) -> Optional[Dict[str, float]]:
        with self._lock:
            return self.samples[-1][1] if self.samples else None

    def _window_locked(self) -> List[Tuple[float, Dict[str, float]]]:
        if not self.samples:
            return []
        horizon = self.samples[-1][0] - self.window_s
        i = 0
        while i < len(self.samples) - 1 and self.samples[i][0] < horizon:
            i += 1
        return self.samples[i:]

    def delta(self, key: str) -> Optional[float]:
        """latest[key] - window-start[key]; None without two samples."""
        with self._lock:
            win = self._window_locked()
        if len(win) < 2:
            return None
        t0, first = win[0]
        t1, last = win[-1]
        if key not in first or key not in last:
            return None
        return last[key] - first[key]

    def rate(self, key: str) -> Optional[float]:
        """Windowed per-second rate of a cumulative counter key."""
        with self._lock:
            win = self._window_locked()
        if len(win) < 2:
            return None
        t0, first = win[0]
        t1, last = win[-1]
        if key not in first or key not in last or t1 <= t0:
            return None
        return (last[key] - first[key]) / (t1 - t0)

    def series(self, key: str) -> List[Tuple[float, float]]:
        """In-window (t, value) points for one flattened key."""
        with self._lock:
            win = self._window_locked()
        return [(t, flat[key]) for t, flat in win if key in flat]

    def tail(self, n: int = 32,
             prefixes: Optional[List[str]] = None) -> List[Dict]:
        """Last ``n`` ring entries (optionally key-filtered) — the
        artifact shape ``obs-health.json`` carries out of CI."""
        with self._lock:
            win = self.samples[-max(1, n):]
        out = []
        for t, flat in win:
            if prefixes is None:
                kept = dict(flat)
            else:
                kept = {k: v for k, v in flat.items()
                        if any(k.startswith(p) for p in prefixes)}
            out.append({"t": t, "metrics": kept})
        return out

    # -- derived headline block --------------------------------------

    def snapshot(self) -> Dict:
        """The ``timeseries`` block for ``snapshot_stats()``."""
        with self._lock:
            n = len(self.samples)
            span = (self.samples[-1][0] - self.samples[0][0]) if n > 1 else 0.0
        out: Dict = {
            "samples": n,
            "window_s": round(min(span, self.window_s), 6),
            "interval_s": self.interval_s,
            "errors": self.errors,
        }

        def put(name: str, value: Optional[float]):
            if value is not None:
                out[name] = round(value, 6)

        put("writes_per_s", self.rate("obs/request/write/count"))
        put("reads_per_s", self.rate("obs/request/read/count"))
        put("hashed_bytes_per_s", self.rate("engine/bytes"))
        put("launches_per_s", self.rate("engine/launches"))
        flat = self.latest_flat() or {}
        per_device: Dict[str, Dict] = {}
        for key in flat:
            m = key.startswith("engine/per_device/") and key.endswith("/launches")
            if m:
                dev = key.split("/")[2]
                r = self.rate(key)
                if r is not None:
                    per_device.setdefault(dev, {})["launches_per_s"] = round(r, 6)
        if per_device:
            out["per_device"] = per_device
        # WDRR queue-wait trend: windowed mean wait vs lifetime mean
        dc = self.delta("obs/request/queue_wait/count")
        ds = self.delta("obs/request/queue_wait/sum_s")
        if dc and dc > 0 and ds is not None:
            out["queue_wait_mean_s"] = round(ds / dc, 9)
        return out
