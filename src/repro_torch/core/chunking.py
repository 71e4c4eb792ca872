"""Content-defined chunking: boundary selection + min/max enforcement.

The device kernels (sliding-window MD5, gear) produce a hash per byte
offset.  The paper's CPU post-processing stage — "the CPU is used to
check the hash values and decide on block boundaries" — is split in two:
the rule test, which picks the candidate windows, and the greedy walk
over the candidates, which enforces the min/max chunk sizes and has to
run in order.  ``select_boundaries`` does both on the host over every
hash; the offload engine can instead test the rule on the card
(``kernels/candidates.py``) and return only the candidates, which
``boundaries_from_candidates`` walks.  Both paths share the walk.

Boundary rule (LBFS): a window hash h declares a chunk end when
``h & mask == magic``.  Boundaries are byte-exact (the end of the
matching window) and min/max chunk sizes are enforced greedily.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def boundary_mask_for(avg_chunk: int) -> int:
    """mask with log2(avg_chunk) low bits set."""
    bits = max(int(np.log2(max(avg_chunk, 2))), 1)
    return (1 << bits) - 1


def boundary_rule(avg_chunk: int, magic: int = 0) -> Tuple[int, int]:
    """(mask, magic) of the rule ``h & mask == magic`` for ``avg_chunk``;
    magic keeps only its bits under the mask."""
    mask = boundary_mask_for(avg_chunk)
    return mask, magic & mask


def select_boundaries(hashes: np.ndarray, total_len: int, *,
                      window: int = 48, stride: int = 1,
                      avg_chunk: int = 4096, min_chunk: int = 0,
                      max_chunk: int = 0, magic: int = 0) -> List[int]:
    """Greedy boundary selection over every window hash.

    hashes[i] is the hash of the window starting at byte i*stride; the
    candidate chunk end for window i is ``i*stride + window``
    (byte-exact).  Returns chunk end offsets, always ending with
    total_len."""
    mask, magic = boundary_rule(avg_chunk, magic)
    cand_idx = np.nonzero((hashes & mask) == magic)[0]
    return boundaries_from_candidates(
        cand_idx, total_len, window=window, stride=stride,
        avg_chunk=avg_chunk, min_chunk=min_chunk, max_chunk=max_chunk)


def boundaries_from_candidates(cand_idx: np.ndarray, total_len: int, *,
                               window: int = 48, stride: int = 1,
                               avg_chunk: int = 4096, min_chunk: int = 0,
                               max_chunk: int = 0) -> List[int]:
    """The greedy min/max walk over candidate window indices (ascending:
    the windows whose hash meets the rule).  Returns chunk end offsets,
    always ending with total_len."""
    min_chunk = min_chunk or max(avg_chunk // 4, window)
    max_chunk = max_chunk or avg_chunk * 4

    # NOTE: boundaries are byte-exact.  Aligning them to word multiples of
    # the ABSOLUTE offset would break CDC's shift-resilience (a k-byte
    # insert with k % 4 != 0 would desynchronize every later chunk);
    # word-alignment for the hash kernels is instead handled by padding
    # each chunk's *message* (see SAI digest convention).
    cand_pos = np.asarray(cand_idx, np.int64) * stride + window
    cand_pos = cand_pos[(cand_pos > 0) & (cand_pos < total_len)]

    bounds: List[int] = []
    last = 0
    for pos in cand_pos.tolist():
        if pos - last < min_chunk:
            continue
        # force intermediate boundaries if a gap exceeded max_chunk
        while pos - last > max_chunk:
            last += max_chunk
            bounds.append(last)
        if pos - last >= min_chunk:
            bounds.append(pos)
            last = pos
    while total_len - last > max_chunk:
        last += max_chunk
        bounds.append(last)
    bounds.append(total_len)
    return bounds


def chunk_spans(bounds: List[int]) -> List[Tuple[int, int]]:
    out = []
    start = 0
    for b in bounds:
        out.append((start, b))
        start = b
    return out


def split_chunks(data: bytes, bounds: List[int]) -> List[bytes]:
    return [data[s:e] for s, e in chunk_spans(bounds)]
