"""Host-facing wrappers around the hashing kernels.

Convenience wrappers (``direct_hash``, ``hash_blocks``,
``sliding_window_hash``) take host arrays and do prep + launch + finish,
on the card unless the caller passes ``device="cpu"``.  The host-side
finish helpers (``digest_bytes``, ``sliding_finish``) and the shard
planners serve the CrystalGPU offload engine, which stages its own pinned
buffers, copies them to the card on its own stream and calls the kernel
wrappers (``md5.md5_words``, ``sliding_md5.sliding_md5_words``) itself.

A tensor on the CPU runs the kernels' plain versions; a CUDA tensor runs
the kernels.  No padding is added for a kernel's sake: the CUDA kernels
take any row count and width.  The byte-phase strips of the sliding path
are built inside the kernel (its plain version builds them with
``sliding_md5.byte_phase_strips``).
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import md5 as md5_k
from repro_torch.kernels import sliding_md5 as slide_k

DEFAULT_DEVICE = "cuda"

# --------------------------------------------------------------------------
# direct hashing
# --------------------------------------------------------------------------


def digest_bytes(dig) -> np.ndarray:
    """[N, 4] uint32 digests (tensor on any device, or array) -> [N, 16]
    uint8 host array."""
    if isinstance(dig, torch.Tensor):
        dig = dig.cpu().numpy()
    dig = np.asarray(dig)
    return dig.astype("<u4").view(np.uint8).reshape(dig.shape[0], 16)


def direct_hash(segments: np.ndarray, lens_bytes=None,
                device=None) -> np.ndarray:
    """MD5 digests of N word-aligned segments.

    segments: [N, seg_bytes/4] uint32 (or uint8 [N, seg_bytes]);
    lens_bytes: optional [N] actual byte lengths (multiples of 4).
    Returns [N, 16] uint8 digests (hashlib-identical)."""
    segments = np.asarray(segments)
    if segments.dtype == np.uint8:
        if segments.shape[1] % 4:
            raise ValueError("segment width must be a multiple of 4 bytes")
        segments = np.ascontiguousarray(segments).view("<u4")
    N, W = segments.shape
    if lens_bytes is None:
        lens_w = np.full((N,), W, np.int32)
    else:
        lens_bytes = np.asarray(lens_bytes)
        if np.any(lens_bytes % 4):
            raise ValueError("lengths must be multiples of 4 bytes")
        lens_w = (lens_bytes // 4).astype(np.int32)
    words = torch.from_numpy(np.array(segments, np.uint32))
    dig = md5_k.md5_words(words.to(device or DEFAULT_DEVICE),
                          torch.from_numpy(lens_w))
    return digest_bytes(dig)


def hash_blocks(data: bytes, block_bytes: int,
                device=None) -> Tuple[np.ndarray, bytes]:
    """Fixed-size-block direct hashing of a buffer (paper's fixed-block
    content addressability).  Returns ([n_blocks, 16] digests, final
    digest bytes = md5 over the concatenated digests, computed host-side
    exactly like the paper's CPU post-processing stage)."""
    n = (len(data) + block_bytes - 1) // block_bytes
    padded = data + b"\x00" * (n * block_bytes - len(data))
    arr = np.frombuffer(padded, np.uint8).reshape(n, block_bytes)
    lens = np.full((n,), block_bytes, np.int64)
    lens[-1] = len(data) - (n - 1) * block_bytes
    lens = ((lens + 3) // 4 * 4)                  # word-align tail
    digs = direct_hash(arr, lens, device=device)
    final = hashlib.md5(digs.tobytes()).digest()
    return digs, final


# --------------------------------------------------------------------------
# sliding-window MD5 (paper-faithful CDC)
# --------------------------------------------------------------------------
def sliding_finish(out: np.ndarray, phases: Tuple[int, ...],
                   n_off: int) -> np.ndarray:
    """Interleave phase rows: offset o = 4q + phases[r] -> out[r, q]."""
    if n_off <= 0:                 # input shorter than one window
        return np.empty((0,), np.uint32)
    R, Wc = out.shape
    inter = np.empty((Wc * R,), np.uint32)
    for i, r in enumerate(phases):
        inter[i::R] = out[i]
    return inter[:n_off]


def sliding_window_hash(data: bytes | np.ndarray, window: int = 48,
                        stride: int = 1, device=None) -> np.ndarray:
    """MD5 (digest word 'a') of every ``window``-byte window at byte
    offsets 0, stride, 2*stride, ...  window % 4 == 0, window <= 52;
    stride in {1, 2, 4}.  Returns [n_off] uint32."""
    if window % 4 or not 0 < window <= 52 or stride not in (1, 2, 4):
        raise ValueError("window must be a multiple of 4 in (0, 52] and "
                         "stride 1, 2 or 4")
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes,
                                                             bytearray)) \
        else np.asarray(data, np.uint8)
    L = len(buf)
    if L < window:                 # no complete window: empty hash array
        return np.empty((0,), np.uint32)
    n_off = (L - window) // stride + 1
    pad = (-L) % 4
    words = torch.from_numpy(np.pad(buf, (0, pad)).view("<u4").copy())
    out = slide_k.sliding_md5_words(
        words.to(device or DEFAULT_DEVICE)[None], window // 4, stride)[0]
    return sliding_finish(out.cpu().numpy(), slide_k.phases_for(stride),
                          n_off)


# ----------------------------------------------------------------------
# whale-job shard planning (host-side helpers for the engine mesh)
# ----------------------------------------------------------------------
# the gear hash at byte p is a 32-tap window over x[p-31..p] (each tap
# shifts out of the 32-bit accumulator after 32 doublings), so a shard
# that carries 32 bytes of left context reproduces the full-buffer
# output from its first owned byte onward
GEAR_HISTORY_BYTES = 32


def shard_row_ranges(n_rows: int, n_shards: int):
    """Balanced contiguous ``[start, stop)`` row ranges covering
    ``n_rows`` — the per-device sub-launch split of a whale direct-hash
    job (row digests are independent, so any row partition reassembles
    by concatenation in range order)."""
    k = max(1, min(int(n_shards), int(n_rows)))
    base, rem = divmod(int(n_rows), k)
    ranges = []
    start = 0
    for i in range(k):
        stop = start + base + (1 if i < rem else 0)
        ranges.append((start, stop))
        start = stop
    return ranges


def stream_shard_plan(n_bytes: int, kind: str, n_shards: int,
                      window: int = 48, stride: int = 4):
    """Byte-slice plan ``[(start, stop, n_drop), ...]`` splitting one
    stream buffer into sub-launches whose outputs — after dropping the
    first ``n_drop`` values of each shard — concatenate to exactly the
    unsharded kernel output.

    sliding: the offset grid ``o = f * stride`` partitions across
    shards; each shard's slice starts at its first owned offset (start
    is stride-aligned) and extends through the last owned window, so
    every window a shard owns lies fully inside its slice and nothing
    is dropped.

    gear: each shard k > 0 takes ``GEAR_HISTORY_BYTES`` of left
    context and drops that many leading outputs (they belong to the
    previous shard); the kernel's zero-history warm-up therefore only
    ever affects positions the previous shard already produced.

    Returns None when the buffer is too small to shard meaningfully.
    """
    n_bytes, k = int(n_bytes), int(n_shards)
    if kind == "sliding":
        n_off = (n_bytes - window) // stride + 1
        k = min(k, max(n_off // 2, 0))
        if k < 2:
            return None
        base, rem = divmod(n_off, k)
        plan = []
        f = 0
        for i in range(k):
            c = base + (1 if i < rem else 0)
            start = f * stride
            stop = min((f + c - 1) * stride + window, n_bytes)
            plan.append((start, stop, 0))
            f += c
        return plan
    if kind == "gear":
        h = GEAR_HISTORY_BYTES
        k = min(k, n_bytes // (4 * h))
        if k < 2:
            return None
        bounds = [n_bytes * i // k for i in range(k + 1)]
        plan = [(0, bounds[1], 0)]
        for i in range(1, k):
            plan.append((bounds[i] - h, bounds[i + 1], h))
        return plan
    return None
