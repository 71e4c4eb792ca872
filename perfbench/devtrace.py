"""The device trace of a window: ``torch.profiler`` (CUPTI) records every
kernel, copy and set on the card; the export is read back into
intervals on the host's ``time.perf_counter`` clock, so they line up with
the program's spans.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "perfbench/clock"

Interval = Tuple[str, float, float]            # (name, t0, t1), seconds


class DeviceTrace:
    """Device operations of one traced window, in host seconds.  The
    window is ``[t0, t1]`` less its ``paused`` intervals (the harness's
    own work with the clock stopped): what lies in them is left out of
    the operations, the busy and the idle time alike."""

    def __init__(self, ops: List[Interval], t0: float, t1: float,
                 paused: Sequence[Tuple[float, float]] = ()):
        self.t0, self.t1 = t0, t1
        self.live: List[Tuple[float, float]] = []    # the window's parts
        last = t0
        for a, b in sorted(paused):
            if a > last:
                self.live.append((last, min(a, t1)))
            last = max(last, b)
        if t1 > last:
            self.live.append((last, t1))
        self.ops = [(n, max(a, s0), min(b, s1)) for n, a, b in ops
                    for s0, s1 in self.live if b > s0 and a < s1]

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.live)

    def busy(self) -> List[Tuple[float, float]]:
        """Union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle(self) -> List[Tuple[float, float]]:
        """The window's parts that no device operation covers, in order."""
        gaps, busy, i = [], self.busy(), 0
        for s0, s1 in self.live:
            last = s0
            while i < len(busy) and busy[i][0] < s1:
                a, b = busy[i]
                if a > last:
                    gaps.append((last, a))
                last = max(last, b)
                i += 1
            if s1 > last:
                gaps.append((last, s1))
        return gaps

    def seconds_by_name(self, needle: str) -> float:
        return sum(b - a for n, a, b in self.ops if needle in n)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_by_host(self, spans: Sequence[Interval],
                     k: int = 10) -> List[List]:
        """Idle device time summed by what the host was in: each gap is
        split where a span opens or closes, and each piece goes to the
        names of the spans open over it, or to 'no span'."""
        cuts = sorted({t for _, s0, s1 in spans for t in (s0, s1)})
        # the names open over each piece between two cuts, by a sweep
        edges: Dict[float, List] = {}
        for n, s0, s1 in spans:
            if s1 > s0:
                edges.setdefault(s0, []).append((n, 1))
                edges.setdefault(s1, []).append((n, -1))
        open_: Counter = Counter()
        labels = []
        for t in cuts:
            for n, d in edges.get(t, ()):
                open_[n] += d
            names = sorted(n for n, c in open_.items() if c > 0)
            labels.append("+".join(names) if names else "no span")
        by: Dict[str, float] = {}
        for a, b in self.idle():
            i = bisect.bisect_right(cuts, a) - 1
            while a < b:
                stop = min(cuts[i + 1], b) if i + 1 < len(cuts) else b
                label = labels[i] if i >= 0 else "no span"
                by[label] = by.get(label, 0.0) + (stop - a)
                a, i = stop, i + 1
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


class Recorder:
    """Profiles the card between ``start`` and ``stop``."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.mark_pc = 0.0

    def start(self):
        self.prof.start()
        self.mark_pc = time.perf_counter()
        with torch.profiler.record_function(MARK):
            pass

    def stop(self, path: str, t0: float, t1: float,
             paused: Sequence[Tuple[float, float]] = ()
             ) -> Optional[DeviceTrace]:
        """Stop, export the trace to ``path`` and read it back over the
        window ``[t0, t1]`` less ``paused`` (perf_counter seconds)."""
        self.prof.stop()
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) \
            if isinstance(events, dict) else events
        return parse(events, self.mark_pc, t0, t1, paused)


def parse(events, mark_pc: float, t0: float, t1: float,
          paused: Sequence[Tuple[float, float]] = ()
          ) -> Optional[DeviceTrace]:
    """Device intervals of a Chrome trace, moved onto perf_counter
    seconds by the marker span recorded at ``mark_pc``."""
    mark = [e for e in events if e.get("name") == MARK and "ts" in e]
    if not mark:
        return None
    offset = float(mark[0]["ts"]) / 1e6 - mark_pc
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = float(e["ts"]) / 1e6 - offset
            ops.append((short_name(e.get("name", "?")), a,
                        a + float(e.get("dur", 0.0)) / 1e6))
    return DeviceTrace(ops, t0, t1, paused)
