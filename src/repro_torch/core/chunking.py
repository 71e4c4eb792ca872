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
matching window) and min/max chunk sizes are enforced greedily
(``boundaries_from_candidates``).

FastCDC's normalized chunking (Xia et al., USENIX ATC 2016, Algorithm 1,
at level 2) tests two masks over the gear hash: a strict one from the
minimum size up to the normal size and a loose one from there up to the
maximum.  Its candidates come flagged with the masks they meet
(``kernels/candidates.py``) and ``walk_normalized`` walks them.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.candidates import candidates_plain, decode
# the gear hash's window: FastCDC's least min_chunk (SAIConfig), so that
# no cut is tested where the window reaches before the image
from repro_torch.kernels.ref import GEAR_WINDOW  # noqa: F401


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
    found = host_candidates(hashes, *boundary_rule(avg_chunk, magic))
    return boundaries_from_candidates(
        found, total_len, window=window, stride=stride, avg_chunk=avg_chunk,
        min_chunk=min_chunk, max_chunk=max_chunk)[0]


def host_candidates(hashes: np.ndarray, *rule: int) -> np.ndarray:
    """What a candidate job with ``rule`` (mask, magic[, mask2, magic2])
    returns, from every window hash on the host: the plain version of
    the card's test and compaction over one row."""
    found, _ = candidates_plain(torch.from_numpy(hashes)[None, None],
                                [len(hashes)], *rule)
    return found.numpy()


def boundaries_from_candidates(cand_idx: np.ndarray, total_len: int, *,
                               window: int = 48, stride: int = 1,
                               avg_chunk: int = 4096, min_chunk: int = 0,
                               max_chunk: int = 0
                               ) -> Tuple[List[int], int]:
    """The greedy min/max walk over candidate window indices (ascending:
    the windows whose hash meets the rule).  Returns the chunk end
    offsets, always ending with total_len, and how many of them were
    forced at ``max_chunk`` before the end."""
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
    last = forced = 0
    for pos in cand_pos.tolist():
        if pos - last < min_chunk:
            continue
        # force intermediate boundaries if a gap exceeded max_chunk
        while pos - last > max_chunk:
            last += max_chunk
            bounds.append(last)
            forced += 1
        if pos - last >= min_chunk:
            bounds.append(pos)
            last = pos
    while total_len - last > max_chunk:
        last += max_chunk
        bounds.append(last)
        forced += 1
    bounds.append(total_len)
    return bounds, forced


def walk_normalized(codes: np.ndarray, total_len: int, *, avg_chunk: int,
                    min_chunk: int, max_chunk: int) -> Tuple[List[int], int]:
    """FastCDC's normalized walk (NC-2) over two-rule gear candidates:
    ``codes`` ascending, each ``4 * k + flags`` for a byte k whose hash
    met the strict mask (flag bit 0) or the loose one (bit 1); a cut
    after byte k lies at p = k + 1.  From a chunk's start ``last``, with
    n = total_len - last bytes left:

    - n <= min_chunk: the cut is at total_len;
    - else, with end = last + min(n, max_chunk) and normal = last +
      min(avg_chunk, n) (Algorithm 1's NormalSize <- n for a short
      tail), the cut is at the first strict p with last + min_chunk <= p
      < normal; else at the first loose p with normal <= p < end; else
      at end, a forced cut where end = last + max_chunk < total_len.

    Returns the chunk end offsets (the last one total_len) and the number
    of forced cuts.  Both position lists are searched per chunk, from
    where the previous chunk's search stopped."""
    k, strict, loose = decode(codes)
    # a sentinel past every cut ends each search
    strict = (k[strict] + 1).tolist() + [total_len + 1]
    loose = (k[loose] + 1).tolist() + [total_len + 1]
    bounds: List[int] = []
    last = forced = i = j = 0
    while total_len - last > min_chunk:
        normal = min(last + avg_chunk, total_len)
        i = bisect_left(strict, last + min_chunk, i)
        if strict[i] < normal:
            last = strict[i]
        else:
            end = min(last + max_chunk, total_len)
            j = bisect_left(loose, normal, j)
            if loose[j] < end:
                last = loose[j]
            else:
                forced += end < total_len
                last = end
        bounds.append(last)
    if last < total_len:
        bounds.append(total_len)
    return bounds, forced


def chunk_spans(bounds: List[int]) -> List[Tuple[int, int]]:
    out = []
    start = 0
    for b in bounds:
        out.append((start, b))
        start = b
    return out


def split_chunks(data: bytes, bounds: List[int]) -> List[bytes]:
    return [data[s:e] for s, e in chunk_spans(bounds)]
