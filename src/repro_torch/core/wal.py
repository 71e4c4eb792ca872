"""Write-ahead log + snapshot machinery for the metadata plane.

This module is deliberately *semantics-free*: it knows how to frame,
group-commit, snapshot, and replay opaque ``(kind, body)`` records.
What the records mean — commits, claims, retires, pins — lives in
``repro_torch.core.castore``, which keeps the dependency arrow pointing one
way (castore -> wal) and lets the framing be fuzz-tested in isolation.

Frame layout (little-endian), one per record::

    [u32 length][u32 crc32][payload]
    payload = [u64 seq][u8 kind][body]

``length`` counts payload bytes; ``crc32`` covers the payload.  Replay
stops *cleanly* at the first frame that fails any check — truncated
length prefix, zero or oversized length, truncated payload, CRC
mismatch, or a sequence number that doesn't advance — and reports how
far it got.  Hostile or torn bytes must never surface as
``struct.error``/``IndexError`` (same discipline as the gateway wire
codec).

Durability model: ``append`` buffers a frame in userspace and returns
its sequence number immediately; a flusher thread group-commits the
buffer (write + flush + fsync) every ``flush_interval_s`` so many
writers share one fsync.  ``sync(seq)`` blocks until the given record
is on disk.  Before each fsync the log runs its registered
``pre_sync_hooks`` — the metadata manager hangs block-store flushes
there, so by the time a commit record is durable the block bytes it
references are too (data-before-metadata ordering without a per-write
fsync on the data path).

On-disk layout under the log directory::

    wal-<start_seq>.log     append-only record frames
    snap-<seq>.snap         one frame (kind SNAP_KIND) holding a full
                            state snapshot as of <seq>

``snapshot(payload)`` writes the snapshot to a temp file, fsyncs,
renames it into place, rotates to a fresh log file, and only then
purges older logs/snapshots — a crash anywhere in between leaves at
least one valid (snapshot, tail) pair on disk.
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Iterator, List, Optional, Tuple

from repro_torch.obs import HeartbeatBoard, MetricsRegistry

from .faultinject import CrashPoint, FaultInjector

_HDR = struct.Struct("<II")    # length, crc32
_META = struct.Struct("<QB")   # seq, kind

SNAP_KIND = 255
MAX_RECORD_BYTES = 64 << 20

_LOG_PREFIX, _LOG_SUFFIX = "wal-", ".log"
_SNAP_PREFIX, _SNAP_SUFFIX = "snap-", ".snap"


class WALError(ValueError):
    """A record failed validation during encode/decode."""


def encode_frame(seq: int, kind: int, body: bytes) -> bytes:
    payload = _META.pack(seq, kind) + body
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
    """Yield ``(seq, kind, body, end_offset)`` for each valid frame in
    ``buf``, stopping silently at the first invalid one.  Never raises
    on hostile bytes."""
    off, n = 0, len(buf)
    prev_seq = None
    while off + _HDR.size <= n:
        length, crc = _HDR.unpack_from(buf, off)
        if length < _META.size or length > MAX_RECORD_BYTES:
            return
        end = off + _HDR.size + length
        if end > n:
            return
        payload = buf[off + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            return
        seq, kind = _META.unpack_from(payload, 0)
        if prev_seq is not None and seq <= prev_seq:
            return
        prev_seq = seq
        yield seq, kind, payload[_META.size:], end
        off = end


def _scan_file(path: str) -> Tuple[List[Tuple[int, int, bytes]], int, bool]:
    """Read every valid frame from ``path``.  Returns
    ``(records, good_end_offset, clean)`` where ``clean`` is False when
    trailing bytes past the last valid frame exist (torn tail)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    recs, good = [], 0
    for seq, kind, body, end in iter_frames(buf):
        recs.append((seq, kind, body))
        good = end
    return recs, good, good == len(buf)


def _file_seq(name: str, prefix: str, suffix: str) -> Optional[int]:
    if not (name.startswith(prefix) and name.endswith(suffix)):
        return None
    try:
        return int(name[len(prefix):len(name) - len(suffix)])
    except ValueError:
        return None


class WriteAheadLog:
    """Group-committed, snapshot-compacted record log over a directory.

    Opening an existing directory performs recovery: the newest *valid*
    snapshot payload lands in ``recovered_snapshot`` (or None), the
    valid tail records after it in ``recovered_records``, and the torn
    garbage past the last good frame — if any — is truncated away so
    appends resume from a clean boundary (``torn_tail`` records that it
    happened).  The caller replays both into its own state before doing
    new work.
    """

    def __init__(self, path: str, *, flush_interval_s: float = 0.002,
                 snapshot_every: int = 1024, fsync: bool = True,
                 fault: Optional[FaultInjector] = None):
        self.path = path
        self.flush_interval_s = float(flush_interval_s)
        self.snapshot_every = int(snapshot_every)
        self.fsync = fsync
        self.fault = fault
        self.pre_sync_hooks: List[Callable[[], None]] = []
        os.makedirs(path, exist_ok=True)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buf = bytearray()  # guarded by self._lock
        self._crashed = False
        self._closed = False
        self._pending_seq = 0  # guarded by self._lock
        self._flushed_seq = 0  # guarded by self._lock
        self._records_since_snap = 0
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.group(
            ("appends", "fsyncs", "snapshots", "flush_waits"))
        # group-commit fsync latency distribution (the durability tax a
        # blocked sync() waiter actually pays)
        self._fsync_hist = self.metrics.histogram("fsync_s")

        self.recovered_snapshot: Optional[bytes] = None
        self.recovered_seq = 0          # seq of the recovered snapshot
        self.recovered_records: List[Tuple[int, int, bytes]] = []
        self.torn_tail = False
        self._recover_dir()

        self._stop = threading.Event()
        self.heartbeats = HeartbeatBoard()
        self._flusher: Optional[threading.Thread] = None
        if self.flush_interval_s > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-flusher", daemon=True)
            self._flusher.start()
        else:
            # inline-fsync mode has no flusher thread: register the
            # heartbeat parked so watchdogs read "idle", not "stalled"
            self.heartbeats.heartbeat("flusher").park()

    # ------------------------------------------------------------ recovery

    def _recover_dir(self):  # ra: disable=RA01(runs from __init__ before the flusher thread exists)
        names = os.listdir(self.path)
        snaps = sorted((s, n) for n in names
                       if (s := _file_seq(n, _SNAP_PREFIX, _SNAP_SUFFIX))
                       is not None)
        logs = sorted((s, n) for n in names
                      if (s := _file_seq(n, _LOG_PREFIX, _LOG_SUFFIX))
                      is not None)

        snap_seq = 0
        for seq_hint, name in reversed(snaps):
            full = os.path.join(self.path, name)
            recs, _, _ = _scan_file(full)
            if len(recs) == 1 and recs[0][1] == SNAP_KIND:
                snap_seq, _, payload = recs[0]
                self.recovered_snapshot = payload
                self.recovered_seq = snap_seq
                break
            self.torn_tail = True   # corrupt/partial snapshot skipped

        last_seq = snap_seq
        active: Optional[Tuple[str, int]] = None    # (path, good_end)
        for _, name in logs:
            full = os.path.join(self.path, name)
            recs, good, clean = _scan_file(full)
            active = (full, good)
            for seq, kind, body in recs:
                if seq <= snap_seq:
                    continue
                if seq != last_seq + 1:
                    clean = False   # gap — stop replay here
                    break
                self.recovered_records.append((seq, kind, body))
                last_seq = seq
            if not clean:
                self.torn_tail = True
                break
        self._seq = last_seq
        self._pending_seq = self._flushed_seq = last_seq
        self._records_since_snap = len(self.recovered_records)

        if active is not None:
            path, good = active
            if os.path.getsize(path) != good:
                with open(path, "r+b") as fh:
                    fh.truncate(good)
            self._active_path = path
        else:
            self._active_path = os.path.join(
                self.path, f"{_LOG_PREFIX}{last_seq + 1:020d}{_LOG_SUFFIX}")
        self._fh = open(self._active_path, "ab")

    # ------------------------------------------------------------ appends

    def _check_alive(self):
        if self._crashed:
            raise CrashPoint("wal", -1)
        if self._closed:
            raise WALError("write-ahead log is closed")

    def append(self, kind: int, body: bytes) -> int:
        """Buffer one record; returns its sequence number.  Durable only
        after the covering group-commit — use ``sync``."""
        with self._lock:
            self._check_alive()
            seq = self._seq + 1
            act = None
            if self.fault is not None:
                try:
                    act = self.fault.fire("wal.append", kind=kind, seq=seq)
                except CrashPoint:
                    self._crashed = True
                    self._cv.notify_all()
                    raise
            frame = encode_frame(seq, kind, body)
            if act == "torn":
                # persist a partial frame, then die: the classic torn
                # final record recovery must truncate away
                self._write_out(self._buf + frame[:len(frame) - max(1, len(frame) // 3)],
                                do_fsync=True)
                self._buf.clear()
                self._crashed = True
                self._cv.notify_all()
                raise CrashPoint("wal.append:torn", seq)
            self._seq = seq
            self._buf += frame
            self._pending_seq = seq
            self._records_since_snap += 1
            self.stats.inc("appends")
            if self.flush_interval_s <= 0:
                self._flush_locked()
            else:
                self._cv.notify_all()
            return seq

    def sync(self, seq: Optional[int] = None):
        """Block until record ``seq`` (default: all appended so far) is
        flushed + fsynced.

        Group-commit leader election: rather than sleeping out the
        flusher's full batch window, a waiter yields one short batching
        grace (a quarter interval) for concurrent appenders to pile into
        the buffer, then performs the flush itself — every record
        buffered by then rides the same fsync.  Commit latency is
        bounded by ~interval/4 while bursts still share fsyncs."""
        with self._lock:
            target = self._pending_seq if seq is None else seq
            grace = min(max(self.flush_interval_s / 4, 1e-4), 0.05)
            while self._flushed_seq < target:
                self._check_alive()
                if self._flusher is None or not self._flusher.is_alive():
                    self._flush_locked()
                    break
                self.stats.inc("flush_waits")
                self._cv.wait(timeout=grace)
                if self._flushed_seq < target:
                    self._check_alive()
                    self._flush_locked()
            self._check_alive()

    @property
    def last_seq(self) -> int:
        return self._seq

    @property
    def records_since_snapshot(self) -> int:
        return self._records_since_snap

    def snapshot_stats(self) -> dict:
        """Counters plus the group-commit fsync latency histogram
        (count/sum/max/p50/p95/p99 in seconds)."""
        out = dict(self.stats)
        out["fsync_hist"] = self._fsync_hist.summary()
        out["heartbeats"] = self.heartbeats.snapshot()
        return out

    # ------------------------------------------------------------ flushing

    def _write_out(self, data: bytes, do_fsync: bool):
        self._fh.write(data)
        self._fh.flush()
        if do_fsync and self.fsync:
            os.fsync(self._fh.fileno())

    def _flush_locked(self):
        if not self._buf and self._flushed_seq == self._pending_seq:
            return
        for hook in self.pre_sync_hooks:
            hook()          # data-before-metadata: flush block stores
        act = None
        if self.fault is not None:
            try:
                act = self.fault.fire("wal.fsync", seq=self._pending_seq)
            except CrashPoint:
                self._crashed = True
                self._cv.notify_all()
                raise
        if act == "skip":
            # lying disk: report durable, keep bytes in userspace so a
            # simulated crash genuinely loses them
            self._buf_skipped = True
        else:
            t0 = time.perf_counter()
            self._write_out(bytes(self._buf), do_fsync=True)
            self._fsync_hist.record(time.perf_counter() - t0)
            self._buf.clear()
            self.stats.inc("fsyncs")
        self._flushed_seq = self._pending_seq
        self._cv.notify_all()

    def _flush_loop(self):
        hb = self.heartbeats.heartbeat("flusher")
        try:
            while not self._stop.is_set():
                hb.beat()
                if self.fault is not None:
                    # fired OUTSIDE the WAL lock: a "stall" arm wedges
                    # only this thread — writers keep committing via
                    # sync() leader election while the heartbeat ages
                    try:
                        self.fault.fire("wal.flusher")
                    except CrashPoint:
                        return
                with self._cv:
                    if (not self._buf
                            and self._flushed_seq == self._pending_seq
                            and not self._crashed):
                        self._cv.wait(timeout=0.1)
                    if self._stop.is_set() or self._crashed:
                        return
                    idle = (not self._buf
                            and self._flushed_seq == self._pending_seq)
                if idle:
                    # idle ticks cycle back through the beat + fault
                    # fire above, so a stall arm wedges an idle flusher
                    # too (the watchdog drill) and the heartbeat stays
                    # fresh without holding the condvar
                    continue
                # batch window: let concurrent writers pile into the buffer
                self._stop.wait(self.flush_interval_s)
                with self._lock:
                    if self._crashed:
                        return
                    try:
                        self._flush_locked()
                    except CrashPoint:
                        return
        finally:
            hb.park()   # clean exit/crash is dormancy, not a stall

    # ------------------------------------------------------------ snapshot

    def snapshot(self, payload: bytes) -> int:
        """Write a full-state snapshot as of the last appended record,
        rotate to a fresh log file, and purge older logs/snapshots.
        Returns the snapshot's sequence number."""
        with self._lock:
            self._check_alive()
            if self.fault is not None:
                try:
                    self.fault.fire("wal.snapshot", seq=self._seq)
                except CrashPoint:
                    self._crashed = True
                    self._cv.notify_all()
                    raise
            self._flush_locked()
            seq = self._seq
            frame = encode_frame(seq, SNAP_KIND, payload)
            final = os.path.join(
                self.path, f"{_SNAP_PREFIX}{seq:020d}{_SNAP_SUFFIX}")
            tmp = final + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(frame)
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())  # ra: disable=RA04(snapshot fsync IS the commit point; the lock is the serialiser)
            os.replace(tmp, final)
            # rotate: new appends land in a fresh file starting past seq
            self._fh.close()
            old_active = self._active_path
            self._active_path = os.path.join(
                self.path, f"{_LOG_PREFIX}{seq + 1:020d}{_LOG_SUFFIX}")
            self._fh = open(self._active_path, "ab")
            self._records_since_snap = 0
            self.stats.inc("snapshots")
            # purge only after the new snapshot is in place
            for name in os.listdir(self.path):
                full = os.path.join(self.path, name)
                s = _file_seq(name, _SNAP_PREFIX, _SNAP_SUFFIX)
                if s is not None and s < seq:
                    os.unlink(full)
                    continue
                s = _file_seq(name, _LOG_PREFIX, _LOG_SUFFIX)
                if s is not None and full != self._active_path and full != old_active:
                    os.unlink(full)
                elif full == old_active and full != self._active_path:
                    os.unlink(full)
            return seq

    # ------------------------------------------------------------ lifecycle

    def crash(self):
        """Mark the log dead (simulated process death): every later call
        raises CrashPoint; buffered-but-unflushed records are lost."""
        with self._lock:
            self._crashed = True
            self._cv.notify_all()

    @property
    def crashed(self) -> bool:
        return self._crashed

    def close(self):
        with self._lock:
            if self._closed or self._crashed:
                self._closed = True
                self._stop.set()
                self._cv.notify_all()
            else:
                self._flush_locked()
                self._closed = True
                self._stop.set()
                self._cv.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        try:
            self._fh.close()
        except OSError:
            pass
