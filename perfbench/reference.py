"""The plain reference of the storage path, written from the semantics
alone: it imports nothing of the program under test.

- MD5 (RFC 1321) as plain PyTorch integer arithmetic, one 64-byte
  compression over whole tensors of messages at a time, so the sliding
  window hashes of a 256 MiB image run in blocks on the card.
- A window hash is word ``a`` of the standard MD5 digest of the
  ``window`` bytes that start at the offset (little-endian).
- Content-defined chunking by the LBFS rule: a window hash ``h`` whose
  low ``log2(avg_chunk)`` bits are all zero ends a chunk after the
  window; chunks shorter than ``min_chunk`` are skipped and gaps longer
  than ``max_chunk`` are cut at ``max_chunk``, greedily from the start.
- A block's digest is ``MD5(data zero-padded to 4 bytes || u32_le(len))``
  (``hashlib``).
- Dedup: a block is new when no earlier block of the same store had its
  digest.

Each chunking rule (the configuration's ``sai.ca``) is found by name:
``perfbench/chunkers/<ca>.py`` gives its chunk ends (``bounds``) and the
device work it asks of one image (``work``), so a new rule is a new file.

Values live in int64 tensors masked to 32 bits, so nothing relies on
how a backend wraps a 32-bit overflow.
"""
from __future__ import annotations

import hashlib
import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
K = [int(abs(math.sin(i + 1)) * 2 ** 32) & MASK for i in range(64)]
SHIFTS = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 \
    + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
# window offsets hashed per step on the device (bounds the temporaries:
# about ten int64 tensors of this length)
BLOCK = 1 << 25
# one file per chunking rule, named by the configuration's ``sai.ca``
CHUNKERS = Path(__file__).resolve().parent / "chunkers"


def message_word(i: int) -> int:
    """Index of the message word that MD5 round ``i`` reads."""
    if i < 16:
        return i
    if i < 32:
        return (5 * i + 1) % 16
    if i < 48:
        return (3 * i + 5) % 16
    return (7 * i) % 16


def md5_compress(state, words):
    """One MD5 compression: ``state`` four 32-bit values, ``words`` the
    16 message words; each value a Python int or an int64 tensor (all
    tensors broadcast together).  Returns the next state."""
    a, b, c, d = state
    for i in range(64):
        if i < 16:
            f = (b & c) | (~b & d)
        elif i < 32:
            f = (d & b) | (~d & c)
        elif i < 48:
            f = b ^ c ^ d
        else:
            f = c ^ (b | (~d & MASK))
        t = (a + f + K[i] + words[message_word(i)]) & MASK
        s = SHIFTS[i]
        a, d, c = d, c, b
        b = (b + (((t << s) | (t >> (32 - s))) & MASK)) & MASK
    return tuple((x + y) & MASK for x, y in zip(state, (a, b, c, d)))


def n_windows(length: int, window: int, stride: int) -> int:
    return max((length - window) // stride + 1, 0)


def _byte_words(data: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Little-endian 32-bit word at each of ``count`` byte offsets from
    ``start`` (int64); bytes past the end read as zero."""
    seg = data[start:start + count + 3].to(torch.int64)
    if seg.numel() < count + 3:
        seg = torch.nn.functional.pad(seg, (0, count + 3 - seg.numel()))
    return seg[:count] | (seg[1:count + 1] << 8) \
        | (seg[2:count + 2] << 16) | (seg[3:count + 3] << 24)


def window_hashes(data: torch.Tensor, window: int, stride: int,
                  first: int = 0, count: int = -1) -> torch.Tensor:
    """Window hashes ``first .. first + count`` of the uint8 tensor
    ``data`` (window i starts at byte ``i * stride``), as int64."""
    if window % 4 or not 4 <= window <= 52:
        raise ValueError(f"window {window} must be 4-52 bytes, whole words")
    total = n_windows(data.numel(), window, stride)
    if count < 0:
        count = total - first
    if count <= 0:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    w_words = window // 4
    span = stride * (count - 1) + 4 * (w_words - 1) + 1
    words = _byte_words(data, first * stride, span)
    msg = [words[4 * j:4 * j + stride * (count - 1) + 1:stride]
           for j in range(w_words)]
    # MD5 padding of a window-byte message: 0x80, zeros, bit length
    msg.append(0x80)
    msg += [0] * (13 - w_words)
    msg += [8 * window, 0]
    a = md5_compress(INIT, msg)[0]
    return a


def chunk_candidates(data: torch.Tensor, window: int, stride: int,
                     avg_chunk: int) -> np.ndarray:
    """Byte positions that end a window whose hash matches the chunking
    rule (its low ``log2(avg_chunk)`` bits all zero), in order."""
    mask = boundary_mask(avg_chunk)
    total = n_windows(data.numel(), window, stride)
    found = []
    for first in range(0, total, BLOCK):
        h = window_hashes(data, window, stride, first,
                          min(BLOCK, total - first))
        idx = torch.nonzero((h & mask) == 0).flatten()
        found.append((idx + first).cpu().numpy())
        del h
    idx = np.concatenate(found) if found else np.zeros(0, np.int64)
    return idx * stride + window


def boundary_mask(avg_chunk: int) -> int:
    return (1 << max(int(math.log2(max(avg_chunk, 2))), 1)) - 1


def cdc_boundaries(candidates: Sequence[int], total_len: int,
                   min_chunk: int, max_chunk: int) -> List[int]:
    """Chunk end offsets, the last one ``total_len``: greedy over the
    candidate positions in order."""
    out: List[int] = []
    last = 0
    for pos in candidates:
        pos = int(pos)
        if pos <= 0 or pos >= total_len or pos - last < min_chunk:
            continue
        while pos - last > max_chunk:
            last += max_chunk
            out.append(last)
        if pos - last >= min_chunk:
            out.append(pos)
            last = pos
    while total_len - last > max_chunk:
        last += max_chunk
        out.append(last)
    out.append(total_len)
    return out


def fixed_boundaries(total_len: int, block_size: int) -> List[int]:
    return [min(e, total_len) for e in range(block_size, total_len
                                               + block_size, block_size)]


def block_digest(chunk) -> bytes:
    n = len(chunk)
    pad = b"\x00" * (-n % 4)
    return hashlib.md5(bytes(chunk) + pad
                       + n.to_bytes(4, "little")).digest()


def chunker(ca: str):
    """The module of chunking rule ``ca``, ``CHUNKERS/<ca>.py``: its
    ``bounds(image, sai, device)`` gives the chunk end offsets of one
    image, its ``work(length, sai)`` the device work of chunking one
    image of that length, ``{kernel: (integer instructions, bytes)}``."""
    path = CHUNKERS / f"{ca}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference for ca={ca!r}: {path}")
    name = "perfbench_chunker_" + "".join(
        c if c.isalnum() else "_" for c in ca)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chunk_bounds(image: np.ndarray, sai: Dict, device) -> List[int]:
    """Chunk end offsets of one image under the SAI settings ``sai``, by
    the rule that ``sai["ca"]`` names."""
    return chunker(sai["ca"]).bounds(image, sai, device)


def block_digests(image: np.ndarray, bounds: List[int]) -> List[bytes]:
    """Digest of each chunk of ``image`` that ``bounds`` ends."""
    view = memoryview(image)
    starts = [0] + bounds[:-1]
    return [block_digest(view[s:e]) for s, e in zip(starts, bounds)]


def dedup_counts(series_digests: List[List[bytes]],
                 lengths: List[List[int]]):
    """(new blocks, duplicate blocks, new bytes) of each version written
    in order into one empty store."""
    seen = set()
    out = []
    for digests, lens in zip(series_digests, lengths):
        new = dup = new_bytes = 0
        for d, n in zip(digests, lens):
            if d in seen:
                dup += 1
            else:
                seen.add(d)
                new += 1
                new_bytes += n
        out.append((new, dup, new_bytes))
    return out
