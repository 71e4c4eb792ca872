"""Content-addressable distributed storage substrate (MosaStore analog).

Object-based architecture mirroring the paper's Figure 2: a centralized
metadata manager holding per-file block-maps (block hash, length, replica
locations), N storage nodes holding blocks keyed by content hash, and
client-side striping over nodes.  Replication + node-failure handling +
re-replication give the fault-tolerance substrate the training framework's
checkpoint layer builds on.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.blockstore import BlockStore
from repro_torch.core.faultinject import FaultInjector
from repro_torch.core.integrity import merkle_root
from repro_torch.core.wal import WALError, WriteAheadLog


class NodeFailure(RuntimeError):
    pass


class StorageNode:
    """One storage node: content-hash -> block bytes.

    A digest can be *tainted* (quarantined in place): the scrubber or a
    read-path verify failure found the resident copy corrupt.  Tainted
    copies are excluded from ``has`` / ``healthy_digests`` — placement
    and scrubbing treat them as gone — but ``get`` still serves them so
    unverified last-resort reads keep working until repair lands a fresh
    copy (``put`` on the digest clears the taint).

    With a :class:`~repro_torch.core.blockstore.BlockStore` backend the node
    is *durable*: puts write through to segment files (fsynced by the
    metadata WAL's group-commit, not per put), ``blocks`` acts as an
    in-memory read cache, and ``get``/``has``/``healthy_digests`` fall
    back to the persistent index — so a node rebuilt from disk serves
    its pre-crash blocks with an empty cache."""

    def __init__(self, node_id: int, store: Optional[BlockStore] = None):
        self.node_id = node_id
        self.store = store
        self.blocks: Dict[bytes, bytes] = {}
        self.tainted: Set[bytes] = set()
        self.failed = False
        self._lock = threading.Lock()
        self.put_count = 0
        self.get_count = 0

    def put(self, digest: bytes, data: bytes):
        if self.failed:
            raise NodeFailure(f"node {self.node_id} down")
        with self._lock:
            if self.store is not None:
                # replace only when overwriting a known-corrupt resident
                # copy (repair); otherwise content addressing dedups
                self.store.put(digest, data,
                               replace=digest in self.tainted)
            self.blocks[digest] = data
            self.tainted.discard(digest)
            self.put_count += 1

    def get(self, digest: bytes) -> bytes:
        if self.failed:
            raise NodeFailure(f"node {self.node_id} down")
        with self._lock:
            self.get_count += 1
            data = self.blocks.get(digest)
            if data is None and self.store is not None:
                data = self.store.get(digest)
                if data is not None:
                    self.blocks[digest] = data     # warm the read cache
            if data is None:
                raise KeyError(digest.hex())
            return data

    def _resident(self, digest: bytes) -> bool:
        return digest in self.blocks or (self.store is not None
                                         and self.store.has(digest))

    def has(self, digest: bytes) -> bool:
        return (not self.failed and digest not in self.tainted
                and self._resident(digest))

    def taint(self, digest: bytes) -> bool:
        """Quarantine the resident copy in place (corrupt bytes kept for
        last-resort unverified reads).  Returns True if the digest was
        resident."""
        with self._lock:
            if not self._resident(digest):
                return False
            self.tainted.add(digest)
            return True

    def drop(self, digest: bytes) -> bool:
        """Reclaim a block (GC).  Returns True if bytes were freed."""
        with self._lock:
            self.tainted.discard(digest)
            freed = self.blocks.pop(digest, None) is not None
            if self.store is not None and self.store.has(digest):
                self.store.drop(digest)
                freed = True
            return freed

    def healthy_digests(self) -> List[bytes]:
        """Snapshot of resident, non-tainted digests (the scrub set)."""
        with self._lock:
            digs = set(self.blocks)
            if self.store is not None:
                digs.update(self.store.digests())
            return [d for d in digs if d not in self.tainted]

    def used_bytes(self) -> int:
        if self.store is not None:
            return self.store.used_bytes()
        return sum(len(v) for v in self.blocks.values())

    def flush(self):
        """Push buffered store writes to disk (WAL pre-sync hook)."""
        if self.store is not None and not self.store.crashed:
            self.store.flush()

    def fail(self):
        self.failed = True

    def recover_empty(self):
        self.failed = False
        self.blocks.clear()
        self.tainted.clear()
        if self.store is not None and not self.store.crashed:
            self.store.clear()


@dataclass
class BlockMeta:
    digest: bytes
    length: int
    nodes: Tuple[int, ...]            # replica locations


@dataclass
class FileVersion:
    blocks: List[BlockMeta]
    total_len: int
    timestamp: float = field(default_factory=time.time)
    # file-level Merkle root over the block digests (leaf order = block
    # order): commits the whole version, lets the scrubber spot-check a
    # single sampled block via integrity.merkle_proof without refetching
    # the file
    merkle_root: bytes = b""


# ---------------------------------------------------------------------------
# WAL record kinds + payload codecs
#
# Every recovery-relevant metadata transition appends one record to the
# write-ahead log (framing/group-commit in repro_torch.core.wal; these are the
# semantics).  Payloads are little-endian struct layouts decoded with the
# same hostile-bytes discipline as the gateway wire codec: any truncation
# or garbage raises WALError — never struct.error / IndexError — and
# replay stops at the last good record.
# ---------------------------------------------------------------------------

REC_COMMIT = 1        # path, total_len, timestamp, root, [blocks]
REC_RETIRE = 2        # path, keep_latest
REC_CLAIM = 3         # [digests] a writer won the duty to store
REC_CLAIM_DONE = 4    # digest, [nodes] (empty nodes = aborted claim)
REC_REGISTER = 5      # digest, [nodes] merged into the registry
REC_QUAR = 6          # digest, node_id quarantined
REC_UNQUAR = 7        # digest, node_id cleared
REC_PIN = 8           # [digests] pinned (+1 each)
REC_UNPIN = 9         # [digests] unpinned (-1 each)
REC_GC = 10           # [digests] reclaimed (registry+refs dropped)
REC_RELOCATE = 11     # digest, [nodes] registry locations REPLACED

RECORD_NAMES = {
    REC_COMMIT: "commit", REC_RETIRE: "retire", REC_CLAIM: "claim",
    REC_CLAIM_DONE: "claim_done", REC_REGISTER: "register",
    REC_QUAR: "quarantine", REC_UNQUAR: "unquarantine",
    REC_PIN: "pin", REC_UNPIN: "unpin", REC_GC: "gc",
    REC_RELOCATE: "relocate",
}

_SNAP_VERSION = 1

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_DIGEST_LEN = 16


class _RecReader:
    """Bounds-checked cursor over a record body (WALError on misuse)."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u(self, st: struct.Struct) -> int:
        if self.off + st.size > len(self.buf):
            raise WALError("truncated record body")
        (v,) = st.unpack_from(self.buf, self.off)
        self.off += st.size
        return v

    def raw(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.buf):
            raise WALError("truncated record body")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def digest(self) -> bytes:
        return self.raw(_DIGEST_LEN)

    def text(self) -> str:
        raw = self.raw(self.u(_U16))
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise WALError(f"invalid utf-8 in record: {e}") from None

    def nodes(self) -> Tuple[int, ...]:
        n = self.u(_U16)
        return tuple(self.u(_U32) for _ in range(n))

    def digests(self) -> List[bytes]:
        n = self.u(_U32)
        return [self.digest() for _ in range(n)]

    def done(self):
        if self.off != len(self.buf):
            raise WALError("trailing garbage in record body")


def _enc_text(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise WALError(f"path too long for WAL record: {len(raw)}")
    return _U16.pack(len(raw)) + raw


def _enc_digest(d: bytes) -> bytes:
    if len(d) != _DIGEST_LEN:
        raise WALError(f"digest must be {_DIGEST_LEN} bytes, got {len(d)}")
    return bytes(d)


def _enc_nodes(nodes: Sequence[int]) -> bytes:
    return _U16.pack(len(nodes)) + b"".join(_U32.pack(n) for n in nodes)


def _enc_digests(digests: Sequence[bytes]) -> bytes:
    return _U32.pack(len(digests)) + b"".join(_enc_digest(d)
                                              for d in digests)


def enc_commit(path: str, fv: "FileVersion") -> bytes:
    parts = [_enc_text(path), _U64.pack(fv.total_len),
             _F64.pack(fv.timestamp),
             _U16.pack(len(fv.merkle_root)), bytes(fv.merkle_root),
             _U32.pack(len(fv.blocks))]
    for b in fv.blocks:
        parts.append(_enc_digest(b.digest))
        parts.append(_U64.pack(b.length))
        parts.append(_enc_nodes(b.nodes))
    return b"".join(parts)


def dec_commit(body: bytes) -> Tuple[str, "FileVersion"]:
    r = _RecReader(body)
    path = r.text()
    total_len = r.u(_U64)
    ts = r.u(_F64)
    root = r.raw(r.u(_U16))
    blocks = [BlockMeta(digest=r.digest(), length=r.u(_U64),
                        nodes=r.nodes())
              for _ in range(r.u(_U32))]
    r.done()
    return path, FileVersion(blocks=blocks, total_len=total_len,
                             timestamp=ts, merkle_root=root)


def enc_retire(path: str, keep_latest: int) -> bytes:
    return _enc_text(path) + _U32.pack(keep_latest)


def dec_retire(body: bytes) -> Tuple[str, int]:
    r = _RecReader(body)
    path, keep = r.text(), r.u(_U32)
    r.done()
    return path, keep


def enc_digest_list(digests: Sequence[bytes]) -> bytes:
    return _enc_digests(digests)


def dec_digest_list(body: bytes) -> List[bytes]:
    r = _RecReader(body)
    out = r.digests()
    r.done()
    return out


def enc_digest_nodes(digest: bytes, nodes: Sequence[int]) -> bytes:
    return _enc_digest(digest) + _enc_nodes(nodes)


def dec_digest_nodes(body: bytes) -> Tuple[bytes, Tuple[int, ...]]:
    r = _RecReader(body)
    d, nodes = r.digest(), r.nodes()
    r.done()
    return d, nodes


def enc_digest_node(digest: bytes, node_id: int) -> bytes:
    return _enc_digest(digest) + _U32.pack(node_id)


def dec_digest_node(body: bytes) -> Tuple[bytes, int]:
    r = _RecReader(body)
    d, nid = r.digest(), r.u(_U32)
    r.done()
    return d, nid


class MetadataManager:
    """Centralized manager: file -> versioned block-maps + block registry.

    Beyond placement and block-maps, the manager carries the state the
    storage-node runtime (repro_torch.core.noderuntime) drives:

    * **reference counts** (``block_refs``): one count per committed
      block-map occurrence, incremented by ``commit_blockmap`` and
      decremented by ``retire_versions`` / ``delete_file``.  A digest
      whose count reaches zero is an orphan the GC may reclaim.
    * **pins** (``pin_blocks`` / ``unpin_blocks``): transient in-flight
      write protection — a writer pins its digests before the dedup
      claim and releases them after its block-map commit, so GC never
      reclaims a block between a dedup hit (or fresh store) and the
      commit that references it.
    * **quarantine** (``quarantine_block``): records a corrupt replica
      (digest, node), removes the node from the digest's registry
      locations so reads and placement avoid it, and notifies listeners
      (the runtime's repair pipeline) of the replica-count deficit.
    * **retire events** (``add_retire_listener``): version retirement
      reports newly-orphaned digests so the runtime GC can reclaim
      eagerly instead of rescanning the registry.
    """

    def __init__(self, nodes: Sequence[StorageNode], replication: int = 1,
                 wal: Optional[WriteAheadLog] = None):
        self.nodes = list(nodes)
        self.replication = max(1, replication)
        self.files: Dict[str, List[FileVersion]] = {}
        self.block_registry: Dict[bytes, Tuple[int, ...]] = {}
        self.block_refs: Dict[bytes, int] = {}
        self.quarantined: Dict[bytes, Set[int]] = {}
        self._pins: Dict[bytes, int] = {}
        self._claims: Dict[bytes, threading.Event] = {}
        self._retire_listeners: List[Callable] = []
        self._quarantine_listeners: List[Callable] = []
        self._rr = 0
        self._lock = threading.Lock()
        self.wal = wal
        self._replaying = False
        self.last_recovery: Optional["RecoveryReport"] = None
        if wal is not None:
            # data-before-metadata: every WAL group-commit flushes the
            # node block stores first, so a durable commit record never
            # references bytes that didn't make it to disk
            wal.pre_sync_hooks.append(self._flush_stores)

    # -- durability ----------------------------------------------------------
    def _flush_stores(self):
        for node in self.nodes:
            node.flush()

    def _log(self, kind: int, body: bytes) -> Optional[int]:
        """Append one WAL record for a transition just applied.  Must be
        called with ``self._lock`` held (record order mirrors lock
        order).  Returns the record's sequence number, or None when the
        store is in-memory or replaying."""
        wal = self.wal
        if wal is None or self._replaying or wal.crashed:
            return None
        seq = wal.append(kind, body)
        if (wal.snapshot_every > 0
                and wal.records_since_snapshot >= wal.snapshot_every):
            wal.snapshot(self._encode_snapshot_locked())
        return seq

    def wait_durable(self, seq: Optional[int] = None):
        """Block until WAL record ``seq`` (default: everything appended
        so far) — and therefore all block bytes it references — is on
        disk.  No-op for in-memory stores."""
        if self.wal is not None:
            self.wal.sync(seq)

    def snapshot(self) -> Optional[int]:
        """Force a snapshot + log compaction now.  Returns the snapshot
        sequence number (None for in-memory stores)."""
        if self.wal is None:
            return None
        with self._lock:
            return self.wal.snapshot(self._encode_snapshot_locked())

    def close(self):
        """Flush and close the durability layer (final compaction
        snapshot so the next open replays a near-empty tail)."""
        wal = self.wal
        if wal is not None and not wal.crashed:
            try:
                with self._lock:
                    wal.snapshot(self._encode_snapshot_locked())
            except Exception:
                pass
            wal.close()
        for node in self.nodes:
            if node.store is not None:
                node.store.close()

    # -- placement ---------------------------------------------------------
    def place(self, digest: bytes) -> Tuple[int, ...]:
        """Round-robin striping over live nodes with r replicas."""
        with self._lock:
            if digest in self.block_registry:
                locs = [n for n in self.block_registry[digest]
                        if not self.nodes[n].failed]
                if locs:
                    return tuple(locs)
            live = [n.node_id for n in self.nodes if not n.failed]
            if len(live) < self.replication:
                raise NodeFailure("not enough live nodes for replication")
            start = self._rr
            self._rr += 1
            return tuple(live[(start + k) % len(live)]
                         for k in range(self.replication))

    def register_block(self, digest: bytes, nodes: Tuple[int, ...]):
        with self._lock:
            prev = set(self.block_registry.get(digest, ()))
            self.block_registry[digest] = tuple(sorted(prev | set(nodes)))
            self._log(REC_REGISTER, enc_digest_nodes(digest, nodes))

    def lookup_block(self, digest: bytes) -> Tuple[int, ...]:
        with self._lock:
            return self.block_registry.get(digest, ())

    def lookup_blocks(self, digests) -> Dict[bytes, Tuple[int, ...]]:
        """Indexed digest->locations lookup for a whole write's digests
        under a single lock acquisition (the dedup fast path)."""
        with self._lock:
            reg = self.block_registry
            return {d: reg[d] for d in digests if d in reg}

    def claim_blocks(self, digests):
        """Atomic dedup decision for a whole write's digests under one
        lock: returns (locmap, claimed, waits) where ``locmap`` maps
        already-stored digests to locations, ``claimed`` is the set of
        digests this caller won the right (and duty) to store — it MUST
        call ``finish_claim`` for each, even on failure — and ``waits``
        maps digests being stored right now by a concurrent writer to
        events that fire when that store completes or aborts.  Prevents
        the check-then-act race where two store lanes both see a digest
        as absent and double-store the block."""
        locmap: Dict[bytes, Tuple[int, ...]] = {}
        claimed = set()
        waits: Dict[bytes, threading.Event] = {}
        with self._lock:
            reg = self.block_registry
            for d in digests:
                if d in locmap or d in claimed or d in waits:
                    continue
                locs = reg.get(d)
                if locs:
                    locmap[d] = locs
                elif d in self._claims:
                    waits[d] = self._claims[d]
                else:
                    self._claims[d] = threading.Event()
                    claimed.add(d)
            if claimed:
                self._log(REC_CLAIM, enc_digest_list(sorted(claimed)))
        return locmap, claimed, waits

    def finish_claim(self, digest: bytes,
                     nodes: Optional[Tuple[int, ...]] = None):
        """Complete (``nodes`` given: register the block) or abort
        (``nodes=None``) a claim from ``claim_blocks``, waking waiters
        either way."""
        with self._lock:
            if nodes:
                prev = set(self.block_registry.get(digest, ()))
                self.block_registry[digest] = tuple(sorted(prev
                                                           | set(nodes)))
            ev = self._claims.pop(digest, None)
            if ev is not None:
                self._log(REC_CLAIM_DONE,
                          enc_digest_nodes(digest, tuple(nodes or ())))
        if ev is not None:
            ev.set()

    # -- pins (in-flight write protection vs GC) -----------------------------
    def pin_blocks(self, digests):
        """Pin digests against GC for the duration of an in-flight write
        (claim -> store -> commit).  Counted: release with an identical
        ``unpin_blocks`` call."""
        with self._lock:
            pinned = sorted(set(digests))
            for d in pinned:
                self._pins[d] = self._pins.get(d, 0) + 1
            if pinned:
                self._log(REC_PIN, enc_digest_list(pinned))

    def unpin_blocks(self, digests):
        with self._lock:
            unpinned = sorted(set(digests))
            for d in unpinned:
                n = self._pins.get(d, 0) - 1
                if n > 0:
                    self._pins[d] = n
                else:
                    self._pins.pop(d, None)
            if unpinned:
                self._log(REC_UNPIN, enc_digest_list(unpinned))

    # -- block-maps ----------------------------------------------------------
    def commit_blockmap(self, path: str, blocks: List[BlockMeta],
                        total_len: int) -> Optional[int]:
        """Commit a new version.  Returns the WAL sequence number of the
        commit record (None for in-memory stores) — pass it to
        ``wait_durable`` to block until the version survives a crash."""
        root = merkle_root([b.digest for b in blocks])
        with self._lock:
            fv = FileVersion(blocks=blocks, total_len=total_len,
                             merkle_root=root)
            self.files.setdefault(path, []).append(fv)
            for b in blocks:
                self.block_refs[b.digest] = \
                    self.block_refs.get(b.digest, 0) + 1
            return self._log(REC_COMMIT, enc_commit(path, fv))

    def retire_versions(self, path: str, keep_latest: int = 1):
        """Retire old versions of ``path`` (``keep_latest=0`` deletes the
        file).  Decrements block refcounts and returns the list of
        newly-orphaned digests (refcount hit zero), which is also passed
        to retire listeners so the runtime GC can reclaim eagerly."""
        orphans: List[bytes] = []
        with self._lock:
            versions = self.files.get(path)
            if not versions:
                return orphans
            cut = max(0, len(versions) - keep_latest) if keep_latest > 0 \
                else len(versions)
            drop, keep = versions[:cut], versions[cut:]
            if keep:
                self.files[path] = keep
            else:
                self.files.pop(path, None)
            for v in drop:
                for b in v.blocks:
                    n = self.block_refs.get(b.digest, 0) - 1
                    if n > 0:
                        self.block_refs[b.digest] = n
                    else:
                        self.block_refs.pop(b.digest, None)
                        orphans.append(b.digest)
            if drop:
                self._log(REC_RETIRE, enc_retire(path, keep_latest))
            listeners = list(self._retire_listeners)
        for cb in listeners:
            try:
                cb(path, list(orphans))
            except Exception:
                pass
        return orphans

    def delete_file(self, path: str):
        return self.retire_versions(path, keep_latest=0)

    def add_retire_listener(self, cb: Callable):
        """cb(path, orphaned_digests) after versions are retired."""
        with self._lock:
            self._retire_listeners.append(cb)

    def get_blockmap(self, path: str,
                     version: int = -1) -> Optional[FileVersion]:
        with self._lock:
            versions = self.files.get(path)
            if not versions:
                return None
            return versions[version]

    def get_read_plan(self, path: str, version: int = -1):
        """Block-map plus current replica locations for every block of a
        file version under ONE lock acquisition (the read fast path —
        the fetch stage avoids per-block ``lookup_block`` lock churn).
        Returns (FileVersion | None, {digest: locations})."""
        with self._lock:
            versions = self.files.get(path)
            if not versions:
                return None, {}
            fv = versions[version]
            reg = self.block_registry
            return fv, {b.digest: reg[b.digest]
                        for b in fv.blocks if b.digest in reg}

    def num_versions(self, path: str) -> int:
        with self._lock:
            return len(self.files.get(path, ()))

    def stat_file(self, path: str,
                  version: int = -1) -> Optional[Dict[str, int]]:
        """File metadata for the gateway's STAT op under one lock:
        version count, the addressed version's byte length and block
        count.  None when the path (or version) does not exist."""
        with self._lock:
            versions = self.files.get(path)
            if not versions:
                return None
            try:
                fv = versions[version]
            except IndexError:
                return None
            return {"versions": len(versions),
                    "total_len": fv.total_len,
                    "blocks": len(fv.blocks)}

    def list_files(self) -> List[str]:
        with self._lock:
            return sorted(self.files)

    # -- quarantine ----------------------------------------------------------
    def quarantine_block(self, digest: bytes, node_id: int):
        """Record that ``node_id``'s copy of ``digest`` is corrupt: the
        node is removed from the digest's registry locations (reads and
        placement avoid it), the node-side copy is tainted in place, and
        quarantine listeners (the runtime repair pipeline) are notified
        with the surviving healthy locations.  Returns those locations."""
        with self._lock:
            locs = self.block_registry.get(digest)
            remaining: Tuple[int, ...] = ()
            if locs is not None:
                remaining = tuple(n for n in locs if n != node_id)
                self.block_registry[digest] = remaining
            self.quarantined.setdefault(digest, set()).add(node_id)
            self._log(REC_QUAR, enc_digest_node(digest, node_id))
            listeners = list(self._quarantine_listeners)
        node = self.nodes[node_id]
        if not node.failed:
            node.taint(digest)
        for cb in listeners:
            try:
                cb(digest, node_id, remaining)
            except Exception:
                pass
        return remaining

    def is_quarantined(self, digest: bytes, node_id: int) -> bool:
        with self._lock:
            return node_id in self.quarantined.get(digest, ())

    def clear_quarantine(self, digest: bytes, node_id: int):
        """A verified fresh copy landed on ``node_id`` (repair)."""
        with self._lock:
            nodes = self.quarantined.get(digest)
            if nodes is not None:
                nodes.discard(node_id)
                if not nodes:
                    self.quarantined.pop(digest, None)
                self._log(REC_UNQUAR, enc_digest_node(digest, node_id))

    def add_quarantine_listener(self, cb: Callable):
        """cb(digest, node_id, remaining_locations) on quarantine."""
        with self._lock:
            self._quarantine_listeners.append(cb)

    def remove_quarantine_listener(self, cb: Callable):
        """Unsubscribe (no-op if absent) — closed SAIs/runtimes must
        not leak into a long-lived manager's listener list."""
        with self._lock:
            try:
                self._quarantine_listeners.remove(cb)
            except ValueError:
                pass

    # -- failure handling ----------------------------------------------------
    def handle_node_failure(self, node_id: int) -> int:
        """Re-replicate blocks that lost a replica.  Returns blocks moved."""
        self.nodes[node_id].fail()
        moved = 0
        updates: Dict[bytes, Tuple[int, ...]] = {}
        for digest, locs in list(self.block_registry.items()):
            live = [n for n in locs
                    if n != node_id and not self.nodes[n].failed]
            if len(live) >= self.replication:
                updates[digest] = tuple(live)
                continue
            if not live:
                continue                    # data loss (r=1): detected on read
            data = self.nodes[live[0]].get(digest)
            candidates = [n.node_id for n in self.nodes
                          if not n.failed and n.node_id not in live]
            for target in candidates[:self.replication - len(live)]:
                self.nodes[target].put(digest, data)
                live.append(target)
                moved += 1
            updates[digest] = tuple(sorted(live))
        with self._lock:
            for digest, locs in updates.items():
                self.block_registry[digest] = locs
                self._log(REC_RELOCATE, enc_digest_nodes(digest, locs))
        return moved

    def gc_collect(self, digests=None) -> int:
        """Reclaim orphaned blocks.  ``digests`` restricts the sweep to
        known candidates (retire-event orphans); default scans every
        registered digest with refcount zero.  A digest is reclaimed
        only if it is unreferenced, unpinned, AND unclaimed — a block a
        concurrent writer has claimed (or dedup-hit and pinned) is never
        collected, even at refcount zero.  Returns node-block copies
        freed (quarantined copies included)."""
        with self._lock:
            if digests is None:
                cands = [d for d in self.block_registry
                         if self.block_refs.get(d, 0) <= 0]
            else:
                cands = list(digests)
            victims = []
            for d in cands:
                if (self.block_refs.get(d, 0) > 0 or d in self._pins
                        or d in self._claims):
                    continue
                locs = set(self.block_registry.pop(d, ()))
                locs |= self.quarantined.pop(d, set())
                self.block_refs.pop(d, None)
                victims.append((d, locs))
            if victims:
                # logged before the node-side drops: replaying the GC
                # record after a mid-drop crash re-erases the registry
                # entries, and the orphaned on-disk copies are reclaimed
                # by recovery's unregistered-resident sweep
                self._log(REC_GC, enc_digest_list([d for d, _ in victims]))
        removed = 0
        for d, locs in victims:
            for nid in locs:
                node = self.nodes[nid]
                if not node.failed and node.drop(d):
                    removed += 1
        return removed

    def resync_refcounts(self) -> int:
        """Recount block refcounts from the committed block-maps — the
        authoritative source.  Recovers from out-of-band mutation of
        ``files`` (tests / administrative surgery).  Returns the number
        of digests whose count actually changed (drift) — zero after a
        clean WAL recovery, which is the crash-matrix invariant."""
        with self._lock:
            refs: Dict[bytes, int] = {}
            for versions in self.files.values():
                for v in versions:
                    for b in v.blocks:
                        refs[b.digest] = refs.get(b.digest, 0) + 1
            drift = sum(1 for d in set(refs) | set(self.block_refs)
                        if refs.get(d, 0) != self.block_refs.get(d, 0))
            self.block_refs = refs
            return drift

    def gc_unreferenced(self) -> int:
        """Full-scan GC: resync refcounts from the committed block-maps,
        then reclaim every orphan (refcount-zero registered digest)."""
        self.resync_refcounts()
        return self.gc_collect()

    def stats(self) -> dict:
        return {
            "files": len(self.files),
            "unique_blocks": len(self.block_registry),
            "stored_bytes": sum(n.used_bytes() for n in self.nodes
                                if not n.failed),
            "live_nodes": sum(not n.failed for n in self.nodes),
            "quarantined": sum(len(v) for v in self.quarantined.values()),
            "pinned": len(self._pins),
        }

    # -- snapshot codec ------------------------------------------------------
    def _encode_snapshot_locked(self) -> bytes:
        """Full manager state as one WAL snapshot payload (refcounts are
        recomputed from the block-maps at load, not serialized)."""
        parts = [_U8.pack(_SNAP_VERSION), _U32.pack(len(self.files))]
        for path in sorted(self.files):
            versions = self.files[path]
            parts.append(_enc_text(path))
            parts.append(_U32.pack(len(versions)))
            for fv in versions:
                parts.append(_U64.pack(fv.total_len))
                parts.append(_F64.pack(fv.timestamp))
                parts.append(_U16.pack(len(fv.merkle_root)))
                parts.append(bytes(fv.merkle_root))
                parts.append(_U32.pack(len(fv.blocks)))
                for b in fv.blocks:
                    parts.append(_enc_digest(b.digest))
                    parts.append(_U64.pack(b.length))
                    parts.append(_enc_nodes(b.nodes))
        parts.append(_U32.pack(len(self.block_registry)))
        for d in sorted(self.block_registry):
            parts.append(_enc_digest(d))
            parts.append(_enc_nodes(self.block_registry[d]))
        parts.append(_U32.pack(len(self.quarantined)))
        for d in sorted(self.quarantined):
            parts.append(_enc_digest(d))
            parts.append(_enc_nodes(sorted(self.quarantined[d])))
        return b"".join(parts)

    def _load_snapshot_locked(self, payload: bytes):
        r = _RecReader(payload)
        version = r.u(_U8)
        if version != _SNAP_VERSION:
            raise WALError(f"unknown snapshot version {version}")
        files: Dict[str, List[FileVersion]] = {}
        for _ in range(r.u(_U32)):
            path = r.text()
            versions = []
            for _ in range(r.u(_U32)):
                total_len = r.u(_U64)
                ts = r.u(_F64)
                root = r.raw(r.u(_U16))
                blocks = [BlockMeta(digest=r.digest(), length=r.u(_U64),
                                    nodes=r.nodes())
                          for _ in range(r.u(_U32))]
                versions.append(FileVersion(blocks=blocks,
                                            total_len=total_len,
                                            timestamp=ts,
                                            merkle_root=root))
            files[path] = versions
        registry: Dict[bytes, Tuple[int, ...]] = {}
        for _ in range(r.u(_U32)):
            d = r.digest()
            registry[d] = r.nodes()
        quarantined: Dict[bytes, Set[int]] = {}
        for _ in range(r.u(_U32)):
            d = r.digest()
            quarantined[d] = set(r.nodes())
        r.done()
        self.files = files
        self.block_registry = dict(registry)
        self.quarantined = quarantined
        refs: Dict[bytes, int] = {}
        for versions in files.values():
            for v in versions:
                for b in v.blocks:
                    refs[b.digest] = refs.get(b.digest, 0) + 1
        self.block_refs = refs

    # -- replay --------------------------------------------------------------
    def _apply_record(self, kind: int, body: bytes,
                      open_claims: Set[bytes]):
        """Re-apply one WAL record to in-memory state (no re-logging, no
        listeners, no node side effects — those are re-derived in the
        recovery finalize pass)."""
        if kind == REC_COMMIT:
            path, fv = dec_commit(body)
            self.files.setdefault(path, []).append(fv)
            for b in fv.blocks:
                self.block_refs[b.digest] = \
                    self.block_refs.get(b.digest, 0) + 1
        elif kind == REC_RETIRE:
            path, keep = dec_retire(body)
            versions = self.files.get(path)
            if not versions:
                return
            cut = max(0, len(versions) - keep) if keep > 0 \
                else len(versions)
            drop, keep_vs = versions[:cut], versions[cut:]
            if keep_vs:
                self.files[path] = keep_vs
            else:
                self.files.pop(path, None)
            for v in drop:
                for b in v.blocks:
                    n = self.block_refs.get(b.digest, 0) - 1
                    if n > 0:
                        self.block_refs[b.digest] = n
                    else:
                        self.block_refs.pop(b.digest, None)
        elif kind == REC_CLAIM:
            open_claims.update(dec_digest_list(body))
        elif kind == REC_CLAIM_DONE:
            d, nodes = dec_digest_nodes(body)
            open_claims.discard(d)
            if nodes:
                prev = set(self.block_registry.get(d, ()))
                self.block_registry[d] = tuple(sorted(prev | set(nodes)))
        elif kind == REC_REGISTER:
            d, nodes = dec_digest_nodes(body)
            prev = set(self.block_registry.get(d, ()))
            self.block_registry[d] = tuple(sorted(prev | set(nodes)))
        elif kind == REC_RELOCATE:
            d, nodes = dec_digest_nodes(body)
            self.block_registry[d] = tuple(nodes)
        elif kind == REC_QUAR:
            d, nid = dec_digest_node(body)
            locs = self.block_registry.get(d)
            if locs is not None:
                self.block_registry[d] = tuple(n for n in locs
                                               if n != nid)
            self.quarantined.setdefault(d, set()).add(nid)
        elif kind == REC_UNQUAR:
            d, nid = dec_digest_node(body)
            nodes = self.quarantined.get(d)
            if nodes is not None:
                nodes.discard(nid)
                if not nodes:
                    self.quarantined.pop(d, None)
        elif kind == REC_PIN:
            for d in dec_digest_list(body):
                self._pins[d] = self._pins.get(d, 0) + 1
        elif kind == REC_UNPIN:
            for d in dec_digest_list(body):
                n = self._pins.get(d, 0) - 1
                if n > 0:
                    self._pins[d] = n
                else:
                    self._pins.pop(d, None)
        elif kind == REC_GC:
            for d in dec_digest_list(body):
                self.block_registry.pop(d, None)
                self.block_refs.pop(d, None)
                self.quarantined.pop(d, None)
        else:
            raise WALError(f"unknown WAL record kind {kind}")

    def recover(self) -> "RecoveryReport":
        """Rebuild state from the WAL's recovered snapshot + tail and
        reconcile it against what actually survived on the node block
        stores.  Ordering:

        1. load the newest valid snapshot, replay the record tail
           (stopping at the first undecodable record);
        2. resolve half-open claims — *adopt* a claim whose block is
           resident somewhere (register those locations so a retrying
           writer dedups instead of double-storing), *release* the rest;
        3. prune registry locations whose node no longer holds the
           block (torn segment tail); a referenced digest with zero
           surviving locations is reported ``lost``;
        4. drop resident blocks no committed/claimed state references
           (stored, never registered — the crashed writer's waste);
        5. re-taint resident quarantined copies, clear stale pins
           (crashed writers hold none), verify refcounts (drift must be
           0 — replay and commit logic agree or recovery is broken).

        Block-integrity verification of the stores' *suspect* trailing
        blocks is NOT done here — hand ``report.suspects`` to
        ``ClusterRuntime.scrub_suspects`` so the engine does the hashing
        (recovery is a scrub workload)."""
        report = RecoveryReport()
        wal = self.wal
        if wal is None:
            self.last_recovery = report
            return report
        t0 = time.perf_counter()
        open_claims: Set[bytes] = set()
        with self._lock:
            self._replaying = True
            try:
                if wal.recovered_snapshot is not None:
                    self._load_snapshot_locked(wal.recovered_snapshot)
                    report.snapshot_seq = wal.recovered_seq
                report.torn_tail = wal.torn_tail
                for seq, kind, body in wal.recovered_records:
                    try:
                        self._apply_record(kind, body, open_claims)
                    except WALError:
                        # undecodable record: stop at the last good one
                        report.bad_records += 1
                        break
                    report.replayed += 1

                resident: Dict[int, Set[bytes]] = {}
                for node in self.nodes:
                    if node.store is not None:
                        resident[node.node_id] = set(node.store.digests())
                        report.suspects[node.node_id] = \
                            list(node.store.suspects)

                # 2. half-open claims: adopt if the block survived
                for d in sorted(open_claims):
                    locs = tuple(sorted(
                        nid for nid, digs in resident.items() if d in digs))
                    if locs:
                        prev = set(self.block_registry.get(d, ()))
                        self.block_registry[d] = tuple(sorted(prev
                                                              | set(locs)))
                        report.adopted_claims.append(d)
                    else:
                        report.released_claims.append(d)

                # 3. prune registry locations that didn't survive
                if resident:
                    for d, locs in list(self.block_registry.items()):
                        keep = tuple(n for n in locs
                                     if d in resident.get(n, ()))
                        if keep != locs:
                            report.pruned_locations += \
                                len(locs) - len(keep)
                            self.block_registry[d] = keep
                            if not keep and self.block_refs.get(d, 0) > 0:
                                report.lost_blocks.append(d)

                    # 4. resident blocks nothing references: reclaim
                    registered = set(self.block_registry)
                    for node in self.nodes:
                        if node.store is None:
                            continue
                        for d in resident[node.node_id] - registered:
                            node.store.drop(d)
                            report.dropped_unregistered += 1

                # 5. re-taint quarantined residents, clear stale pins
                for d, nids in self.quarantined.items():
                    for nid in nids:
                        if d in resident.get(nid, ()):
                            self.nodes[nid].tainted.add(d)
                report.dropped_pins = len(self._pins)
                self._pins.clear()
                self._claims.clear()
            finally:
                self._replaying = False
        report.refcount_drift = self.resync_refcounts()
        report.wall_s = time.perf_counter() - t0
        self.last_recovery = report
        return report


@dataclass
class RecoveryReport:
    """What a WAL+blockstore recovery found and fixed."""
    wall_s: float = 0.0
    snapshot_seq: int = 0              # seq of the snapshot restored
    replayed: int = 0                  # tail records applied
    bad_records: int = 0               # undecodable records (replay stop)
    torn_tail: bool = False            # garbage truncated from the log
    adopted_claims: List[bytes] = field(default_factory=list)
    released_claims: List[bytes] = field(default_factory=list)
    pruned_locations: int = 0          # registry locations not resident
    lost_blocks: List[bytes] = field(default_factory=list)
    dropped_unregistered: int = 0      # resident blocks nothing references
    dropped_pins: int = 0              # stale writer pins cleared
    refcount_drift: int = 0            # must be 0 (replay == commit logic)
    suspects: Dict[int, List[bytes]] = field(default_factory=dict)


def open_durable_store(data_dir: str, n_nodes: int = 4,
                       replication: int = 1, *,
                       flush_interval_s: float = 0.002,
                       snapshot_every: int = 1024,
                       segment_bytes: int = 8 << 20,
                       fsync: bool = True,
                       fault: Optional[FaultInjector] = None,
                       ) -> Tuple[MetadataManager, List[StorageNode],
                                  RecoveryReport]:
    """Open (or create) a durable store rooted at ``data_dir``: one
    block-store directory per node plus the metadata WAL under
    ``meta/``.  Recovery runs before this returns; hand
    ``report.suspects`` to ``ClusterRuntime.scrub_suspects`` for
    engine-verified integrity of the trailing blocks."""
    nodes = [StorageNode(i, store=BlockStore(
        os.path.join(data_dir, f"node{i:03d}"),
        segment_bytes=segment_bytes, fsync=fsync, fault=fault))
        for i in range(n_nodes)]
    wal = WriteAheadLog(os.path.join(data_dir, "meta"),
                        flush_interval_s=flush_interval_s,
                        snapshot_every=snapshot_every,
                        fsync=fsync, fault=fault)
    mgr = MetadataManager(nodes, replication=replication, wal=wal)
    report = mgr.recover()
    return mgr, nodes, report


def make_store(n_nodes: int = 4, replication: int = 1,
               data_dir: Optional[str] = None,
               **durable_kw) -> Tuple[MetadataManager, List[StorageNode]]:
    """In-memory store by default; pass ``data_dir`` for a durable one
    (recovery report lands on ``manager.last_recovery``)."""
    if data_dir is not None:
        mgr, nodes, _ = open_durable_store(
            data_dir, n_nodes=n_nodes, replication=replication,
            **durable_kw)
        return mgr, nodes
    nodes = [StorageNode(i) for i in range(n_nodes)]
    return MetadataManager(nodes, replication=replication), nodes
