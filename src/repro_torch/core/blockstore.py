"""Digest-addressed persistent block store for ``StorageNode``.

Blocks live in append-only segment files under a per-node directory::

    seg-<id>.blk        [record]*

    record = [u32 magic][u8 flags][u32 length][16s digest][data]
    flags: 0 = block (length data bytes follow), 1 = tombstone (none)

The digest *is* the checksum — the engine-verified scrub path
recomputes content hashes, so records carry no separate CRC.  Writes
are buffered in userspace and group-flushed (``flush()`` — the
metadata WAL calls it from its pre-sync hooks so block bytes hit disk
before the commit records that reference them).  A segment that
reaches ``segment_bytes`` is flushed + fsynced and a fresh one opened,
so at most the *final* segment can be torn by a crash.

Opening an existing directory scans the segments to re-derive the
resident-block index (later records win; tombstones erase).  The scan
is header-walking only — O(#records) seeks, not O(bytes) hashing —
and it truncates a torn trailing record.  Every block whose record
lives in the final (possibly-torn) segment is reported in
``suspects``: recovery hands those to the engine-verified scrub path
rather than trusting them, which is exactly the paper's point —
recovery is a hashing workload the accelerator absorbs.
"""
from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import MetricsRegistry

from .faultinject import CrashPoint, FaultInjector

_REC = struct.Struct("<IBI16s")
MAGIC = 0x314B4C42          # "BLK1"
F_BLOCK, F_TOMB = 0, 1

_SEG_PREFIX, _SEG_SUFFIX = "seg-", ".blk"


class BlockStoreError(RuntimeError):
    pass


class BlockStore:
    """Append-only segmented block store addressed by 16-byte digest."""

    def __init__(self, path: str, *, segment_bytes: int = 8 << 20,
                 fsync: bool = True, fault: Optional[FaultInjector] = None):
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.fsync_enabled = fsync
        self.fault = fault
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()
        self._crashed = False
        # digest -> (seg_id, data_offset, length)
        self._index: Dict[bytes, Tuple[int, int, int]] = {}  # guarded by self._lock
        self._handles: Dict[int, object] = {}  # guarded by self._lock
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.group(
            ("puts", "skipped_puts", "replaced", "drops", "flushes",
             "truncated_bytes", "scanned_records"))
        self.suspects: List[bytes] = []
        self._scan()

    # ------------------------------------------------------------ recovery

    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.path,
                            f"{_SEG_PREFIX}{seg_id:012d}{_SEG_SUFFIX}")

    def _scan(self):  # ra: disable=RA01(runs from __init__ pre-publication, single-threaded)
        seg_ids = []
        for name in os.listdir(self.path):
            if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
                try:
                    seg_ids.append(int(name[len(_SEG_PREFIX):
                                            len(name) - len(_SEG_SUFFIX)]))
                except ValueError:
                    continue
        seg_ids.sort()
        last_seg_digests: List[bytes] = []
        for seg_id in seg_ids:
            full = self._seg_path(seg_id)
            size = os.path.getsize(full)
            last_seg_digests = []
            with open(full, "rb") as fh:
                buf = fh.read()
            off = 0
            while off + _REC.size <= size:
                magic, flags, length, digest = _REC.unpack_from(buf, off)
                if magic != MAGIC or flags not in (F_BLOCK, F_TOMB):
                    break
                if flags == F_TOMB:
                    if length != 0:
                        break
                    self._index.pop(digest, None)
                    off += _REC.size
                    self.stats.inc("scanned_records")
                    continue
                end = off + _REC.size + length
                if length > self.segment_bytes * 4 or end > size:
                    break       # torn data tail
                self._index[digest] = (seg_id, off + _REC.size, length)
                last_seg_digests.append(digest)
                self.stats.inc("scanned_records")
                off = end
            if off != size:     # torn tail: drop the garbage
                self.stats.inc("truncated_bytes", size - off)
                with open(full, "r+b") as fh:
                    fh.truncate(off)
        if seg_ids:
            self._cur_seg = seg_ids[-1]  # guarded by self._lock
            self._cur_size = os.path.getsize(  # guarded by self._lock
                self._seg_path(self._cur_seg))
        else:
            self._cur_seg = 0
            self._cur_size = 0
        # only the final segment can have unsynced/torn records: its
        # resident blocks are suspects until the engine re-verifies them
        # (deduped — a replace rewrite appends a second record for the
        # same digest, but there is only one resident copy to verify)
        self.suspects = [d for d in dict.fromkeys(last_seg_digests)
                         if d in self._index]
        self._buf = bytearray()  # guarded by self._lock
        self._buf_base = self._cur_size  # disk offset where _buf begins; guarded by self._lock
        self._pending: Dict[bytes, bytes] = {}  # guarded by self._lock

    # ------------------------------------------------------------ helpers

    def _check_alive(self):
        if self._crashed:
            raise CrashPoint("blockstore", -1)

    def _fire(self, site: str, **ctx):
        if self.fault is None:
            return None
        try:
            return self.fault.fire(site, **ctx)
        except CrashPoint:
            self._crashed = True
            raise

    def _append_fh(self):  # ra: holds self._lock
        fh = self._handles.get(-self._cur_seg - 1)
        if fh is None:
            fh = open(self._seg_path(self._cur_seg), "ab")
            self._handles[-self._cur_seg - 1] = fh
        return fh

    def _rotate_locked(self):
        self._flush_locked(rotate_fsync=True)
        key = -self._cur_seg - 1
        fh = self._handles.pop(key, None)
        if fh is not None:
            fh.close()
        self._cur_seg += 1
        self._cur_size = 0
        self._buf_base = 0

    def _flush_locked(self, rotate_fsync: bool = False):
        if not self._buf:
            if rotate_fsync:
                fh = self._handles.get(-self._cur_seg - 1)
                if fh is not None:
                    fh.flush()
                    if self.fsync_enabled:
                        os.fsync(fh.fileno())
            return
        act = self._fire("blockstore.fsync", seg=self._cur_seg)
        if act == "skip":
            # lying disk: report success, keep bytes in userspace
            return
        fh = self._append_fh()
        fh.write(bytes(self._buf))
        fh.flush()
        if self.fsync_enabled:
            os.fsync(fh.fileno())
        self._buf_base += len(self._buf)
        self._buf.clear()
        self._pending.clear()
        self.stats.inc("flushes")

    # ------------------------------------------------------------ API

    def put(self, digest: bytes, data: bytes, replace: bool = False):
        """Append one block.  Re-putting a resident digest is a no-op
        (content-addressed dedup) unless ``replace`` — used by repair to
        overwrite a corrupt resident copy."""
        if len(digest) != 16:
            raise BlockStoreError(f"digest must be 16 bytes, got {len(digest)}")
        with self._lock:
            self._check_alive()
            if digest in self._index and not replace:
                self.stats.inc("skipped_puts")
                return
            act = self._fire("blockstore.put", digest=digest)
            rec = _REC.pack(MAGIC, F_BLOCK, len(data), digest) + bytes(data)
            if act == "torn":
                # persist a partial record directly, then die
                torn = rec[:max(_REC.size // 2, len(rec) - max(1, len(rec) // 3))]
                self._flush_locked()
                fh = self._append_fh()
                fh.write(torn)
                fh.flush()
                if self.fsync_enabled:
                    os.fsync(fh.fileno())  # ra: disable=RA04(fault-injection branch: simulated torn write must land before the crash)
                self._crashed = True
                raise CrashPoint("blockstore.put:torn", -1)
            if digest in self._index:
                self.stats.inc("replaced")
            off = self._cur_size
            self._buf += rec
            self._pending[digest] = bytes(data)
            self._index[digest] = (self._cur_seg, off + _REC.size, len(data))
            self._cur_size += len(rec)
            self.stats.inc("puts")
            if self._cur_size >= self.segment_bytes:
                self._rotate_locked()

    def get(self, digest: bytes) -> Optional[bytes]:
        with self._lock:
            self._check_alive()
            loc = self._index.get(digest)
            if loc is None:
                return None
            if digest in self._pending:
                return self._pending[digest]
            seg_id, off, length = loc
            fh = self._handles.get(seg_id)
            if fh is None:
                try:
                    fh = open(self._seg_path(seg_id), "rb")
                except FileNotFoundError:
                    return None
                self._handles[seg_id] = fh
            fh.seek(off)
            data = fh.read(length)
            if len(data) != length and seg_id == self._cur_seg:
                # record straddles the unflushed buffer
                base = self._buf_base
                if off >= base:
                    rel = off - base
                    data = bytes(self._buf[rel:rel + length])
                elif off + length > base:
                    data += bytes(self._buf[:off + length - base])
            return data if len(data) == length else None

    def has(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._index and not self._crashed

    def digests(self) -> List[bytes]:
        with self._lock:
            return list(self._index)

    def drop(self, digest: bytes):
        """Tombstone a block (logical delete; space reclaim is a
        compaction concern, not attempted here)."""
        with self._lock:
            self._check_alive()
            if digest not in self._index:
                return
            self._fire("blockstore.drop", digest=digest)
            rec = _REC.pack(MAGIC, F_TOMB, 0, digest)
            self._buf += rec
            self._cur_size += len(rec)
            self._index.pop(digest, None)
            self._pending.pop(digest, None)
            self.stats.inc("drops")

    def flush(self):
        """Write + fsync buffered records (WAL pre-sync hook target)."""
        with self._lock:
            self._check_alive()
            self._flush_locked()

    def snapshot_stats(self) -> dict:
        return dict(self.stats)

    def used_bytes(self) -> int:
        with self._lock:
            return sum(length for _, _, length in self._index.values())

    def clear(self):
        """Wipe the store (simulated disk replacement on a rebuilt node)."""
        with self._lock:
            self._check_alive()
            for fh in self._handles.values():
                try:
                    fh.close()
                except OSError:
                    pass
            self._handles.clear()
            for name in os.listdir(self.path):
                if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
                    os.unlink(os.path.join(self.path, name))
            self._index.clear()
            self._buf = bytearray()
            self._pending = {}
            self._cur_seg += 1
            self._cur_size = 0
            self._buf_base = 0
            self.suspects = []

    def crash(self):
        with self._lock:
            self._crashed = True

    @property
    def crashed(self) -> bool:
        return self._crashed

    def close(self):
        with self._lock:
            if not self._crashed:
                self._flush_locked()
            for fh in self._handles.values():
                try:
                    fh.close()
                except OSError:
                    pass
            self._handles.clear()
            self._crashed = True
