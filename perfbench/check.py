"""The comparison that decides ``correct``: the program's answers against
the plain reference's.  Every number compared is a count of answers
that differ, and every limit is 0 (an exact comparison).

It reads the program's answers as plain data (block maps as lists of
``(digest, length, nodes)``, write counts, read bytes) and imports
nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

LIMITS = {
    "ops_failed": 0,            # operations that raised or never came
    "boundary_mismatch": 0,     # writes whose chunk ends differ
    "digest_mismatch": 0,       # blocks whose digest differs
    "dedup_mismatch": 0,        # writes whose new/dup counts differ
    "size_mismatch": 0,         # writes whose reported size differs
    #                             from the bytes submitted
    "replica_faults": 0,        # block-map entries without
    #                             `replication` right copies
    "read_length_mismatch": 0,  # reads of the wrong length
    "read_byte_mismatch": 0,    # reads whose bytes differ
}
# bytes compared at a time (bounds the comparison's temporaries)
STEP = 1 << 22

BlockMap = List[Tuple[bytes, int, Tuple[int, ...]]]
Kept = Tuple[Tuple[int, ...], Tuple[bytes, ...]]     # ends, digests


def ends_of(block_map: BlockMap) -> List[int]:
    out, pos = [], 0
    for _, n, _ in block_map:
        pos += n
        out.append(pos)
    return out


def kept(block_map: BlockMap) -> Kept:
    """What ``writes`` needs of a block map: its chunk ends and its
    digests, as tuples of plain values, which the collector stops
    walking once it has seen them."""
    return tuple(ends_of(block_map)), tuple(d for d, _, _ in block_map)


def same_bytes(data: bytes, want: np.ndarray) -> bool:
    """``data`` holds exactly the bytes of the uint8 array ``want``."""
    if len(data) != want.size:
        return False
    got = np.frombuffer(data, np.uint8)
    return all(np.array_equal(got[i:i + STEP], want[i:i + STEP])
               for i in range(0, want.size, STEP))


def writes(done: Sequence[Dict], ref_bounds: Dict[int, List[int]],
           ref_digests: Dict[int, List[bytes]],
           ref_dedup: Dict[int, Tuple[int, int, int]],
           series: Sequence[np.ndarray]) -> Dict[str, int]:
    """``done``: one dict per timed write, with its ``version``, its
    ``counts`` (new blocks, dup blocks, new bytes, total bytes) or None
    if it failed, and its ``block_map`` as ``kept`` gives it, or None."""
    out = {"ops_failed": 0, "boundary_mismatch": 0, "digest_mismatch": 0,
           "dedup_mismatch": 0, "size_mismatch": 0}
    for w in done:
        v = w["version"]
        if w["counts"] is None:
            out["ops_failed"] += 1
            continue
        if tuple(w["counts"][:3]) != tuple(ref_dedup[v]):
            out["dedup_mismatch"] += 1
        if w["counts"][3] != series[v].size:
            out["size_mismatch"] += 1
        ends, digests = w["block_map"] or ((), ())
        if list(ends) != ref_bounds[v]:
            out["boundary_mismatch"] += 1
            out["digest_mismatch"] += len(ref_digests[v])
            continue
        out["digest_mismatch"] += sum(
            d != r for d, r in zip(digests, ref_digests[v]))
    return out


def replicas(maps: Dict[int, Optional[BlockMap]],
             series: Sequence[np.ndarray], replication: int,
             fetch: Callable[[int, bytes], Optional[bytes]]) -> int:
    """Entries of one store's block maps (``{version: map}``, None for a
    write that failed) whose block is not held, byte for byte as the
    image has it there, by ``replication`` distinct nodes: every stored
    replica that a map names.  ``fetch(node, digest)`` reads one replica
    (None if it has none).  Each (digest, node) pair is read once, and
    one stored object once."""
    faults = 0
    good_blocks: Dict[bytes, bool] = {}
    good_objects: Dict[int, bool] = {}
    for v, bm in maps.items():
        if bm is None:
            continue
        img = series[v]
        start = 0
        for digest, n, nodes in bm:
            if digest not in good_blocks:
                want = img[start:start + n]
                good = 0
                for nid in set(nodes):
                    data = fetch(nid, digest)
                    if data is None:
                        continue
                    if id(data) not in good_objects:
                        good_objects[id(data)] = same_bytes(data, want)
                    good += good_objects[id(data)]
                good_blocks[digest] = good >= replication
            faults += not good_blocks[digest]
            start += n
    return faults


def reads(done: Sequence[Dict], series: Sequence[np.ndarray]
          ) -> Dict[str, int]:
    """``done``: one dict per timed read, with its ``version``, the
    ``length`` it returned (None if it failed) and ``same``, whether its
    bytes were the version's (``same_bytes``, taken as it returned)."""
    out = {"ops_failed": 0, "read_length_mismatch": 0,
           "read_byte_mismatch": 0}
    for r in done:
        if r["length"] is None:
            out["ops_failed"] += 1
            continue
        if r["length"] != series[r["version"]].size:
            out["read_length_mismatch"] += 1
        if not r["same"]:
            out["read_byte_mismatch"] += 1
    return out


def verdict(numbers: Dict[str, int], n_done: int) -> bool:
    """Correct: every number within its limit, and something was done."""
    return n_done > 0 and all(v <= LIMITS[k] for k, v in numbers.items())
