"""FastCDC's normalized chunking (Xia et al., USENIX ATC 2016, sec. 3 and
Algorithm 1, at normalization level 2), as ``configs/cas-gear.json``
states it:

- the gear fingerprint ``fp = (fp << 1) + Gear[byte]`` in 32 bits, so
  the hash at byte k covers bytes k - 31 .. k; ``Gear[b]`` is MurmurHash3's
  32-bit finalizer (fmix32) of ``b + 1``.  The hash runs from the image's
  start and is never restarted (the configuration's assumption c);
- a byte whose hash has every bit of a mask zero ends a chunk after it
  (assumption d): a cut at offset p tests the hash of byte p - 1;
- from a chunk's start ``last``, with n bytes left: n <= ``min_chunk``
  ends the image in one chunk; else, with end = last + min(n,
  ``max_chunk``) and normal = last + min(``avg_chunk``, n), the cut is at
  the first p with last + ``min_chunk`` <= p < normal whose byte meets
  the strict mask ``mask_s``, else at the first p with normal <= p < end
  whose byte meets the loose mask ``mask_l``, else at end.
"""
import numpy as np
import torch

MASK = 0xFFFFFFFF
WINDOW = 32                             # bytes the 32-bit fingerprint spans
# byte positions hashed per step on the device
BLOCK = 1 << 25
# integer instructions per byte of the gear hash at the least: a frozen
# copy of chip_smoke.py's GEAR_OPS_PER_BYTE (fmix32 of b + 1: one add,
# three xor-shift pairs, two multiplies; and the shift-add of fp)
GEAR_OPS_PER_BYTE = 10


def fmix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & MASK
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


GEAR = [fmix32(b + 1) for b in range(256)]


def fingerprints(data: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """The fingerprint after bytes ``first .. first + count - 1`` of the
    uint8 tensor ``data``, each the sum of ``Gear[byte k - j] << j`` over
    the j <= min(k, 31) bytes it has seen (int64 in [0, 2**32))."""
    table = torch.tensor(GEAR, dtype=torch.int64, device=data.device)
    lo = max(first - (WINDOW - 1), 0)
    g = table[data[lo:first + count].to(torch.int64)]
    fp = torch.zeros(count, dtype=torch.int64, device=data.device)
    for j in range(WINDOW):
        # byte k - j of every k in the block, where it exists
        start = first - j - lo
        if start >= 0:
            fp += (g[start:start + count] << j) & MASK
        elif count + start > 0:
            fp[-start:] += (g[:count + start] << j) & MASK
    return fp & MASK


def mask_hits(data: torch.Tensor, masks):
    """For each mask, the cut offsets p (byte p - 1's fingerprint has
    every bit of the mask zero), ascending."""
    found = [[] for _ in masks]
    for first in range(0, data.numel(), BLOCK):
        fp = fingerprints(data, first, min(BLOCK, data.numel() - first))
        for out, m in zip(found, masks):
            out.append((torch.nonzero((fp & m) == 0).flatten()
                        + first + 1).cpu().numpy())
        del fp
    return [np.concatenate(f) if f else np.zeros(0, np.int64)
            for f in found]


def normalized_cuts(strict, loose, total: int, min_size: int,
                    normal_size: int, max_size: int):
    """Chunk end offsets, the last one ``total``, of the walk above over
    the strict and loose cut offsets."""
    out = []
    last = 0
    while last < total:
        n = total - last
        if n <= min_size:
            out.append(total)
            break
        end = last + min(n, max_size)
        normal = last + min(normal_size, n)
        i = np.searchsorted(strict, last + min_size, side="left")
        if i < len(strict) and strict[i] < normal:
            last = int(strict[i])
        else:
            i = np.searchsorted(loose, normal, side="left")
            last = int(loose[i]) if i < len(loose) and loose[i] < end \
                else end
        out.append(last)
    return out


def bounds(image, sai, device):
    """Chunk end offsets of ``image`` (uint8 array); the fingerprints are
    computed on ``device``."""
    data = torch.from_numpy(image).to(device)
    strict, loose = mask_hits(data, (sai["mask_s"], sai["mask_l"]))
    return normalized_cuts(strict, loose, image.size, sai["min_chunk"],
                           sai["avg_chunk"], sai["max_chunk"])


def work(length, sai):
    """Device work of chunking one image of ``length`` bytes, as
    (integer instructions, bytes): the gear hash at every byte (each
    byte read once and its 4-byte hash written once), and both masks'
    test over every hash (``candidates``: each 4-byte hash read once).
    The candidates' 8-byte codes that the test writes are left out, as
    for the ``cdc`` rule: about one a 2**11 bytes under an 11-bit loose
    mask, 0.1% of the hash bytes read."""
    return {"gear": (float(GEAR_OPS_PER_BYTE * length), 5.0 * length),
            "candidates": (0.0, 4.0 * length)}
