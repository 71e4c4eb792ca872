"""Content-defined chunking: boundary selection + min/max enforcement.

The device kernels (sliding-window MD5, gear) produce a hash per byte
offset; this module implements the paper's CPU post-processing stage —
"the CPU is used to check the hash values and decide on block
boundaries" — exactly as in the HashGPU design, where efficient global
synchronization across GPU threads is impossible and the final scan is
host-side.

Boundary rule (LBFS): a window hash h declares a chunk end when
``h & mask == magic``.  Boundaries are aligned down to 4 bytes (word
alignment, see DESIGN.md) and min/max chunk sizes are enforced greedily.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def boundary_mask_for(avg_chunk: int) -> int:
    """mask with log2(avg_chunk) low bits set."""
    bits = max(int(np.log2(max(avg_chunk, 2))), 1)
    return (1 << bits) - 1


def select_boundaries(hashes: np.ndarray, total_len: int, *,
                      window: int = 48, stride: int = 1,
                      avg_chunk: int = 4096, min_chunk: int = 0,
                      max_chunk: int = 0, magic: int = 0) -> List[int]:
    """Greedy boundary selection.

    hashes[i] is the hash of the window starting at byte i*stride; the
    candidate chunk end for window i is ``i*stride + window`` (aligned
    down to 4).  Returns chunk end offsets, always ending with total_len.
    """
    min_chunk = min_chunk or max(avg_chunk // 4, window)
    max_chunk = max_chunk or avg_chunk * 4
    mask = boundary_mask_for(avg_chunk)
    magic = magic & mask

    # NOTE: boundaries are byte-exact.  Aligning them to word multiples of
    # the ABSOLUTE offset would break CDC's shift-resilience (a k-byte
    # insert with k % 4 != 0 would desynchronize every later chunk);
    # word-alignment for the hash kernels is instead handled by padding
    # each chunk's *message* (see SAI digest convention).
    cand_idx = np.nonzero((hashes & mask) == magic)[0]
    cand_pos = cand_idx * stride + window
    cand_pos = cand_pos[(cand_pos > 0) & (cand_pos < total_len)]

    bounds: List[int] = []
    last = 0
    for pos in cand_pos:
        pos = int(pos)
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
