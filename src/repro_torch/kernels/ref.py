"""Plain PyTorch oracles for the hashing kernels.

These are the plain versions the CUDA kernels are held against (and, in
the tests, the JAX package's oracles and ``hashlib``).  Every hashed
segment is 4-byte (word) aligned: MD5 padding of a word-aligned message
occupies whole words — ``0x00000080``, zeros, then the 64-bit
little-endian bit length.

Arithmetic is int64 under a 32-bit mask.  On the CPU, torch's uint32
``+ << >> ~`` are not implemented and int32 ``>>`` is arithmetic, so the
words are widened to int64 and every result that can leave 32 bits is
masked with ``& MASK``.  Inputs may be uint32, int32 or int64 word
tensors (the same bits); outputs are int64 in ``[0, 2**32)``.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF

# --------------------------------------------------------------------------
# MD5 constants
# --------------------------------------------------------------------------
MD5_K = tuple(int(abs(math.sin(i + 1)) * 2 ** 32) & 0xFFFFFFFF
              for i in range(64))
MD5_S = (7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 + (4, 11, 16, 23) * 4 \
    + (6, 10, 15, 21) * 4
MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def md5_g(i: int) -> int:
    if i < 16:
        return i
    if i < 32:
        return (5 * i + 1) % 16
    if i < 48:
        return (3 * i + 5) % 16
    return (7 * i) % 16


def as_words64(x: torch.Tensor) -> torch.Tensor:
    """Word tensor (uint32 / int32 / int64 bits) -> int64 in [0, 2**32)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    return ((x << s) | (x >> (32 - s))) & MASK


def md5_chunk_update(a, b, c, d, M: Sequence[torch.Tensor]):
    """One 64-round MD5 chunk update.  a..d and the 16 entries of ``M``
    are int64 tensors of one shape holding 32-bit values."""
    a0, b0, c0, d0 = a, b, c, d
    for i in range(64):
        if i < 16:
            f = (b & c) | (~b & d)
        elif i < 32:
            f = (d & b) | (~d & c)
        elif i < 48:
            f = b ^ c ^ d
        else:
            f = c ^ ((b | ~d) & MASK)
        f = (f + a + MD5_K[i] + M[md5_g(i)]) & MASK
        a = d
        d = c
        c = b
        b = (b + _rotl(f, MD5_S[i])) & MASK
    return ((a0 + a) & MASK, (b0 + b) & MASK, (c0 + c) & MASK,
            (d0 + d) & MASK)


def md5_words_ref(data: torch.Tensor, lens_w: torch.Tensor) -> torch.Tensor:
    """MD5 of N word-aligned messages.

    data: [N, W] words (little-endian words of each message, anything
    past its length ignored); lens_w: [N] message lengths in words, each
    ``<= W`` — no spare words past the message are needed, the padding
    is built here.  Returns [N, 4] int64 (a, b, c, d): the standard
    digest read as four little-endian words."""
    data = as_words64(data)
    N, W = data.shape
    lens = lens_w.to(device=data.device, dtype=torch.int64)
    if N == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=data.device)
    if int(lens.min()) < 0 or int(lens.max()) > W:
        raise ValueError(f"message lengths must lie in [0, {W}] words")
    nchunks = (lens + 18) // 16                                # [N]
    max_chunks = int(nchunks.max())
    lens_c = lens[:, None]
    blo_at = (nchunks * 16 - 2)[:, None]
    bits_lo = ((lens << 5) & MASK)[:, None]
    bits_hi = (lens >> 27)[:, None]
    cols = torch.arange(16, device=data.device)[None, :]
    state = [torch.full((N,), v, dtype=torch.int64, device=data.device)
             for v in MD5_INIT]
    for chunk in range(max_chunks):
        lo = chunk * 16
        raw = data[:, lo:lo + 16]
        if raw.shape[1] < 16:
            raw = torch.nn.functional.pad(raw, (0, 16 - raw.shape[1]))
        w = cols + lo                                          # [1, 16]
        m = torch.where(w < lens_c, raw, 0)
        m = torch.where(w == lens_c, 0x80, m)
        m = torch.where(w == blo_at, bits_lo, m)
        m = torch.where(w == blo_at + 1, bits_hi, m)
        new = md5_chunk_update(*state, [m[:, j] for j in range(16)])
        active = chunk < nchunks
        state = [torch.where(active, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=1)


def md5_window_a(M: List[torch.Tensor], w_words: int) -> torch.Tensor:
    """Digest word ``a`` of single-chunk messages of ``w_words`` words
    (``w_words <= 13``): ``M`` holds the first ``w_words`` message words;
    the padding is constant."""
    if not 0 < w_words <= 13:
        raise ValueError(f"w_words={w_words} must lie in [1, 13]")
    like = M[0]
    full = list(M[:w_words])
    for jj in range(w_words, 16):
        if jj == w_words:
            full.append(torch.full_like(like, 0x80))
        elif jj == 14:
            full.append(torch.full_like(like, w_words * 32))
        else:
            full.append(torch.zeros_like(like))
    state = [torch.full_like(like, v) for v in MD5_INIT]
    return md5_chunk_update(*state, full)[0]


# --------------------------------------------------------------------------
# helpers to go between bytes and word arrays
# --------------------------------------------------------------------------
def bytes_to_words(buf: bytes) -> np.ndarray:
    if len(buf) % 4:
        raise ValueError("word-aligned input required")
    return np.frombuffer(buf, dtype="<u4").copy()


def digest_words_to_bytes(dig) -> bytes:
    return np.asarray(dig, dtype=np.int64).astype("<u4").tobytes()


def md5_hex_ref(buf: bytes) -> str:
    """MD5 hex digest of a word-aligned byte string (matches hashlib)."""
    w = torch.from_numpy(bytes_to_words(buf).astype(np.int64))
    data = w[None, :] if len(w) else torch.zeros((1, 1), dtype=torch.int64)
    lens = torch.tensor([len(w)], dtype=torch.int64)
    return digest_words_to_bytes(md5_words_ref(data, lens)[0]).hex()


# --------------------------------------------------------------------------
# sliding-window MD5 (content-based chunking, paper-faithful primitive)
# --------------------------------------------------------------------------
def sliding_md5_ref(data_bytes: torch.Tensor, window: int,
                    stride: int = 1) -> torch.Tensor:
    """MD5 digest word 'a' of every window of ``window`` bytes.

    data_bytes: [L] uint8; window a multiple of 4 and <= 52 so the
    padded message fits one MD5 chunk.  Returns [n_off] int64 where
    n_off = (L - window)//stride + 1."""
    if window % 4 or window > 52:
        raise ValueError("window must be a multiple of 4 and <= 52")
    wins = data_bytes.to(torch.int64).unfold(0, window, stride)
    wins = wins.reshape(wins.shape[0], window // 4, 4)
    words = (wins[..., 0] | (wins[..., 1] << 8) | (wins[..., 2] << 16)
             | (wins[..., 3] << 24))                       # [n_off, w/4]
    return md5_window_a([words[:, j] for j in range(window // 4)],
                        window // 4)
