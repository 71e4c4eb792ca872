"""Deterministic fault injection for the durability stack.

Generalizes the idea behind ``repro.train.fault`` (step-indexed
``fail_at_steps`` exceptions) into a reusable harness any storage
component can instrument: code under test calls
``injector.fire("site", **ctx)`` at its fault sites, and tests arm a
site to trigger on its N-th hit — either killing the "process"
(:class:`CrashPoint`), skipping the operation (``"skip"`` — e.g. an
fsync that lies), or tearing it (``"torn"`` — the caller persists a
partial record, then dies).

Sites instrumented by the durability layer (repro_torch.core.wal /
blockstore / castore):

  ``wal.append``      one metadata WAL record about to be buffered
                      (``ctx: kind, seq``) — ``kill_after(n)`` here is
                      the "crash after n WAL records" crash point;
                      action ``"torn"`` persists a partial frame first
  ``wal.fsync``       a group-commit flush cycle about to fsync —
                      ``"skip"`` models a lying disk (records reported
                      durable, bytes lost with the process)
  ``wal.flusher``     one group-commit flusher loop iteration, fired
                      *outside* the WAL lock — a ``"stall"`` arm here
                      wedges only the flusher thread (writers keep
                      committing via ``sync()`` leader election), the
                      scenario heartbeat watchdogs must catch
  ``wal.snapshot``    a snapshot about to be written (crash =>
                      recovery falls back to the previous snapshot and
                      a longer tail)
  ``blockstore.put``  one block about to be appended to a segment
                      (``ctx: digest``) — ``"torn"`` persists a
                      partial record (the partial-segment-write case)
  ``blockstore.fsync``a segment flush about to fsync (``"skip"``)
  ``blockstore.drop`` one tombstone about to be appended (crash
                      mid-GC)

A component that receives a :class:`CrashPoint` from ``fire`` marks
itself crashed and raises it from every later call, so the rest of the
process observes the same thing it would observe of a dead peer: the
durable state on disk stops changing.  Tests then "restart" by
reopening the same directory with a fresh object graph.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class CrashPoint(BaseException):
    """Simulated process death at an instrumented fault site.

    Derives from ``BaseException`` so ``except Exception`` recovery
    paths don't accidentally swallow the "process" dying mid-write —
    exactly like a real SIGKILL wouldn't run them."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected crash at {site} (hit {hit})")
        self.site = site
        self.hit = hit


class _Arm:
    __slots__ = ("after", "action", "times", "fired")

    def __init__(self, after: int, action, times: int):
        self.after = after
        self.action = action
        self.times = times
        self.fired = 0


class FaultInjector:
    """Arm deterministic faults at named sites.

    ``arm(site, after=N)`` makes the N-th ``fire(site)`` call trigger
    (counting from the arm, 1-based).  ``action``:

      * ``"crash"`` (default) — ``fire`` raises :class:`CrashPoint`
      * ``"skip"``  — ``fire`` returns ``"skip"``; the caller must skip
        the guarded operation (fsync dropped)
      * ``"torn"``  — ``fire`` returns ``"torn"``; the caller persists
        a deliberately partial record, then raises CrashPoint itself
      * ``"stall"`` — ``fire`` blocks the *calling thread* (outside the
        injector lock) until :meth:`clear_stall` releases the site or
        ``stall_max_s`` elapses — models a wedged-but-alive thread so
        health watchdogs can be proven to fire
      * a callable — invoked with the fire context; its return value is
        handed back to the caller (may itself raise)

    ``when={...}`` restricts matching to fires whose context contains
    the given key/value pairs (e.g. only WAL records of one kind), and
    only matching fires advance the hit counter for that arm.
    ``times`` repeats the trigger for that many matching hits after the
    threshold (default 1)."""

    def __init__(self, stall_max_s: float = 60.0):
        self._lock = threading.Lock()
        self._arms: Dict[str, List[tuple]] = {}
        self._stalls: Dict[str, threading.Event] = {}
        self.stall_max_s = stall_max_s
        self.hits: Dict[str, int] = {}
        self.log: List[tuple] = []

    def arm(self, site: str, after: int = 1, action="crash",
            times: int = 1, when: Optional[Dict[str, Any]] = None):
        with self._lock:
            self._arms.setdefault(site, []).append(
                (_Arm(max(1, int(after)), action, max(1, int(times))),
                 dict(when or {}), [0]))
        return self

    def kill_after(self, site: str, n: int,
                   when: Optional[Dict[str, Any]] = None):
        """Crash on the n-th matching hit of ``site`` (the ISSUE's
        ``kill_after(n_wal_records)`` spelled per-site)."""
        return self.arm(site, after=n, action="crash", when=when)

    def stall(self, site: str, after: int = 1,
              when: Optional[Dict[str, Any]] = None):
        """Wedge every later ``fire(site)`` caller until
        :meth:`clear_stall`.  The blocked thread stays alive (unlike a
        crash), which is exactly the failure mode heartbeat watchdogs
        exist to catch."""
        with self._lock:
            self._stalls.setdefault(site, threading.Event()).clear()
        return self.arm(site, after=after, action="stall",
                        times=1 << 30, when=when)

    def clear_stall(self, site: Optional[str] = None):
        """Release stalled callers (one site, or all when ``site`` is
        None) and disarm the matching stall arms so later fires pass."""
        with self._lock:
            sites = [site] if site is not None else list(self._stalls)
            for s in sites:
                ev = self._stalls.get(s)
                if ev is not None:
                    ev.set()
                self._arms[s] = [
                    entry for entry in self._arms.get(s, [])
                    if entry[0].action != "stall"
                ]
        return self

    def _stall_wait(self, site: str) -> str:
        with self._lock:
            ev = self._stalls.setdefault(site, threading.Event())
        ev.wait(timeout=self.stall_max_s)
        return "stall"

    def fire(self, site: str, **ctx) -> Optional[Any]:
        """Called by instrumented code at a fault site.  Returns the
        armed action result (``"skip"`` / ``"torn"`` / callable return)
        or None when nothing triggers; raises CrashPoint for ``"crash"``
        arms."""
        with self._lock:
            self.hits[site] = self.hits.get(site, 0) + 1
            self.log.append((site, dict(ctx)))
            triggered: Optional[Callable[[], Any]] = None
            for arm, when, count in self._arms.get(site, ()):
                if any(ctx.get(k) != v for k, v in when.items()):
                    continue
                count[0] += 1
                if count[0] < arm.after or arm.fired >= arm.times:
                    continue
                arm.fired += 1
                hit = count[0]
                if arm.action == "crash":
                    raise CrashPoint(site, hit)
                if arm.action == "stall":
                    triggered = lambda: self._stall_wait(site)           # noqa: E731,B023
                elif callable(arm.action):
                    act = arm.action
                    triggered = lambda: act(site=site, hit=hit, **ctx)  # noqa: E731,B023
                else:
                    result = arm.action
                    triggered = lambda: result                          # noqa: E731,B023
                break
        return triggered() if triggered is not None else None

    def reset(self):
        with self._lock:
            self._arms.clear()
            self.hits.clear()
            self.log.clear()
            for ev in self._stalls.values():
                ev.set()  # release any thread still wedged in a stall
            self._stalls.clear()


def tear_tail(path: str, keep_frac: float = 0.5, min_cut: int = 1):
    """Truncate ``path`` mid-record: keep ``keep_frac`` of the final
    bytes beyond a floor cut of ``min_cut`` bytes.  A post-crash test
    helper for simulating a torn final record on any append-only file
    (WAL log or block-store segment)."""
    import os
    size = os.path.getsize(path)
    cut = max(int((1.0 - keep_frac) * size), min_cut)
    new_size = max(size - cut, 0)
    with open(path, "r+b") as fh:
        fh.truncate(new_size)
    return new_size
