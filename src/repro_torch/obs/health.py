"""Health plane: thread heartbeats + rule-driven verdicts.

Two halves:

* :class:`Heartbeat` / :class:`HeartbeatBoard` — instrumentation every
  long-lived thread in the stack carries (engine manager loops, the WAL
  flusher, scrub/maintenance loops, SAI pipeline stages, the gateway
  scheduler).  A thread ``beat()``s at the top of each work iteration
  and ``park()``s before blocking indefinitely (empty queue, paused
  runtime, clean exit), so "no recent beat" is distinguishable from
  "legitimately idle".

* :class:`HealthEngine` — evaluates rule-driven verdicts over the
  rolling samples a :class:`repro_torch.obs.timeseries.MetricsSampler`
  collects from the gateway stats tree:

  ========================  =======================================
  rule                      fires when
  ========================  =======================================
  ``*_stalled``             an unparked heartbeat's age exceeds
                            ``stall_after_s`` (per long-lived thread)
  ``sampler_stalled``       the sampler itself stopped producing
  ``device_straggler``      a device's EWMA slowdown exceeds
                            ``straggler_ratio`` x the mesh median
                            while the mesh is taking launches
  ``backlog_growth``        a lane queue depth grew across the
                            window past ``backlog_min_depth``
  ``slo_burn``              a QoS class's windowed latency-violation
                            rate burns its error budget faster than
                            ``burn_warn`` / ``burn_critical``
  ========================  =======================================

Verdicts are plain JSON-safe dicts so they can ride the ``OP_HEALTH``
wire verb, the ``/health`` HTTP endpoint, and ``snapshot_stats()``
unchanged.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = [
    "Heartbeat",
    "HeartbeatBoard",
    "HealthConfig",
    "HealthEngine",
    "STATUS_OK",
    "STATUS_WARN",
    "STATUS_CRITICAL",
]

STATUS_OK = "ok"
STATUS_WARN = "warn"
STATUS_CRITICAL = "critical"

_STATUS_RANK = {STATUS_OK: 0, STATUS_WARN: 1, STATUS_CRITICAL: 2}

_VERDICT_BAD = re.compile(r"[^a-zA-Z0-9_]")


class Heartbeat:
    """Liveness stamp for one long-lived thread.

    ``beat()`` marks forward progress; ``park()`` declares the thread
    intentionally dormant (blocking on an empty queue, paused, or
    exited cleanly) so the watchdog skips it instead of reading the
    growing age as a stall."""

    __slots__ = ("name", "_lock", "_last", "_parked", "_beats")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._last = time.perf_counter()
        self._parked = True  # not alive until the first beat
        self._beats = 0

    def beat(self) -> None:
        with self._lock:
            self._last = time.perf_counter()
            self._parked = False
            self._beats += 1

    def park(self) -> None:
        with self._lock:
            self._last = time.perf_counter()
            self._parked = True

    def state(self) -> Dict[str, float]:
        with self._lock:
            return {
                "age_s": max(0.0, time.perf_counter() - self._last),
                "parked": 1 if self._parked else 0,
                "beats": self._beats,
            }


class HeartbeatBoard:
    """A component's set of heartbeats, snapshot-able as a stats block."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats: Dict[str, Heartbeat] = {}

    def heartbeat(self, name: str) -> Heartbeat:
        with self._lock:
            hb = self._beats.get(name)
            if hb is None:
                hb = self._beats[name] = Heartbeat(name)
            return hb

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            beats = list(self._beats.items())
        return {name: hb.state() for name, hb in beats}


@dataclass
class HealthConfig:
    """Knobs for every verdict rule (see module docstring table)."""

    # heartbeat watchdog: an unparked heartbeat older than this is a stall
    stall_after_s: float = 2.0
    # straggler: device slowdown must exceed ratio x mesh-median slowdown
    # AND the absolute floor, while the mesh took launches this window
    straggler_ratio: float = 3.0
    straggler_min_slowdown: float = 2.0
    # backlog: lane depth must end the window above min_depth and above
    # growth_factor x its depth at the window start
    backlog_min_depth: int = 32
    backlog_growth_factor: float = 2.0
    # SLO: per-QoS p-latency objective (seconds) + allowed violation
    # fraction; burn = (violation_rate / slo_budget)
    slo_p99_s: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 0.5, "batch": 2.0, "scrub": 10.0}
    )
    slo_budget: float = 0.01
    burn_warn: float = 1.0
    burn_critical: float = 10.0
    # minimum windowed request count before the SLO rule has signal
    slo_min_count: int = 8


def _verdict_name(*parts: str) -> str:
    return _VERDICT_BAD.sub("_", "_".join(p for p in parts if p))


class HealthEngine:
    """Evaluates rule verdicts over a MetricsSampler's rolling window."""

    def __init__(self, sampler, config: Optional[HealthConfig] = None):
        self.sampler = sampler
        self.cfg = config or HealthConfig()
        self._lock = threading.Lock()
        self._last_report: Optional[Dict] = None
        self._evals = 0

    # -- rules -------------------------------------------------------

    def _rule_heartbeats(self, flat: Mapping[str, float], out: List[Dict]):
        cfg = self.cfg
        for path, age in flat.items():
            if not path.endswith("/age_s"):
                continue
            if ("/heartbeats/" not in path
                    and not path.startswith("heartbeats/")):
                continue
            base = path[: -len("/age_s")]
            if flat.get(base + "/parked", 0.0):
                continue
            if age <= cfg.stall_after_s:
                continue
            parts = base.split("/")
            idx = parts.index("heartbeats")
            prefix = parts[idx - 1] if idx > 0 else "gateway"
            name = _verdict_name(prefix, "_".join(parts[idx + 1:]), "stalled")
            out.append({
                "rule": "heartbeat",
                "name": name,
                "status": STATUS_CRITICAL,
                "value": round(age, 6),
                "detail": f"thread {base} last beat {age:.3f}s ago "
                          f"(stall_after_s={cfg.stall_after_s})",
            })

    def _rule_sampler(self, out: List[Dict]):
        s = self.sampler
        if not s.running or not s.samples:
            return
        age = time.perf_counter() - s.samples[-1][0]
        limit = max(self.cfg.stall_after_s, 4.0 * s.interval_s)
        if age > limit:
            out.append({
                "rule": "heartbeat",
                "name": "metrics_sampler_stalled",
                "status": STATUS_CRITICAL,
                "value": round(age, 6),
                "detail": f"sampler last tick {age:.3f}s ago "
                          f"(interval_s={s.interval_s})",
            })

    def _rule_straggler(self, flat: Mapping[str, float], out: List[Dict]):
        cfg = self.cfg
        devices: Dict[int, float] = {}
        for path, value in flat.items():
            m = re.fullmatch(r"engine/per_device/(\d+)/slowdown", path)
            if m:
                devices[int(m.group(1))] = value
        if len(devices) < 2:
            return
        # only judge devices that took launches this window: an idle
        # peer's default slowdown of 1.0 is not a comparison point, and
        # a stale slowdown on a drained mesh is history, not a live
        # straggler.  Needs >= 2 active peers — "slow relative to whom?"
        active = {
            i: slow for i, slow in devices.items()
            if (self.sampler.delta(f"engine/per_device/{i}/launches")
                or 0.0) >= 1.0
        }
        if len(active) < 2:
            return
        ranked = sorted(active.values())
        median = ranked[len(ranked) // 2]
        floor = max(cfg.straggler_min_slowdown, cfg.straggler_ratio * median)
        for i, slow in sorted(active.items()):
            if slow >= floor:
                out.append({
                    "rule": "straggler",
                    "name": "device_straggler",
                    "status": STATUS_CRITICAL,
                    "device": i,
                    "value": round(slow, 4),
                    "detail": f"device {i} slowdown {slow:.2f} vs mesh "
                              f"median {median:.2f} "
                              f"(ratio={cfg.straggler_ratio})",
                })

    def _rule_backlog(self, flat: Mapping[str, float], out: List[Dict]):
        cfg = self.cfg
        for path, depth in flat.items():
            if not re.fullmatch(r"(?:engine/)?queue_depths/\w+", path):
                continue
            if depth < cfg.backlog_min_depth:
                continue
            series = self.sampler.series(path)
            if len(series) < 2:
                continue
            start = series[0][1]
            if depth > max(start * cfg.backlog_growth_factor,
                           start + cfg.backlog_min_depth - 1):
                lane = path.rsplit("/", 1)[1]
                out.append({
                    "rule": "backlog",
                    "name": "backlog_growth",
                    "status": STATUS_WARN,
                    "lane": lane,
                    "value": depth,
                    "detail": f"lane {lane} depth {int(start)} -> "
                              f"{int(depth)} over sampler window",
                })

    def _rule_slo(self, flat: Mapping[str, float], out: List[Dict]):
        cfg = self.cfg
        for qos, slo_s in sorted(cfg.slo_p99_s.items()):
            prefix = f"obs/qos/{qos}/buckets/"
            bucket_keys = [k for k in flat if k.startswith(prefix)]
            if not bucket_keys:
                continue
            threshold_ns = max(1, int(slo_s * 1e9))
            # histogram bucket i holds samples whose latency-ns has
            # bit_length == i, i.e. [2^(i-1), 2^i); the first bucket
            # lying entirely at/above the SLO threshold:
            idx_start = (threshold_ns - 1).bit_length() + 1
            total = 0.0
            violations = 0.0
            for key in bucket_keys:
                delta = self.sampler.delta(key)
                if not delta or delta <= 0:
                    continue
                total += delta
                if int(key.rsplit("/", 1)[1]) >= idx_start:
                    violations += delta
            if total < cfg.slo_min_count:
                continue
            burn = (violations / total) / max(cfg.slo_budget, 1e-9)
            if burn < cfg.burn_warn:
                continue
            status = (STATUS_CRITICAL if burn >= cfg.burn_critical
                      else STATUS_WARN)
            out.append({
                "rule": "slo",
                "name": _verdict_name("slo_burn", qos),
                "status": status,
                "qos": qos,
                "value": round(burn, 4),
                "detail": f"{qos}: {int(violations)}/{int(total)} windowed "
                          f"requests over {slo_s}s SLO; burn {burn:.1f}x "
                          f"budget {cfg.slo_budget}",
            })

    # -- evaluation --------------------------------------------------

    def evaluate(self) -> Dict:
        """Run every rule against the sampler's latest window."""
        flat = self.sampler.latest_flat()
        verdicts: List[Dict] = []
        if flat is not None:
            self._rule_heartbeats(flat, verdicts)
            self._rule_sampler(verdicts)
            self._rule_straggler(flat, verdicts)
            self._rule_backlog(flat, verdicts)
            self._rule_slo(flat, verdicts)
        status = STATUS_OK
        for v in verdicts:
            if _STATUS_RANK[v["status"]] > _STATUS_RANK[status]:
                status = v["status"]
        verdicts.sort(key=lambda v: (-_STATUS_RANK[v["status"]], v["name"]))
        with self._lock:
            self._evals += 1
            report = {
                "status": status,
                "healthy": status != STATUS_CRITICAL,
                "verdicts": verdicts,
                "samples": len(self.sampler.samples),
                "evals": self._evals,
            }
            self._last_report = report
        return report

    def snapshot(self) -> Dict:
        """Most recent report (evaluating once if none exists yet)."""
        with self._lock:
            report = self._last_report
        return report if report is not None else self.evaluate()
