"""Sliding-window MD5 over byte phases: the CUDA kernel and its plain
version.

Replaces the TPU kernel ``sliding_md5_pallas``
(``src/repro/kernels/sliding_md5.py``, ``_sliding_kernel``) together
with the strip construction that fed it (``src/repro/kernels/ops.py``,
``_byte_phase_strips_batch``): the kernel (``csrc/sliding_md5.cu``)
builds each byte-rotated window in registers from the row itself.  It is
bound by integer operations (one 64-round compression per window).

For row b, phase index i (byte phase ``r = i * stride``) and word offset
q, output ``[b, i, q]`` is digest word ``a`` of the ``w_words``-word
window starting at byte ``4q + r``; words past the row end read as zero.
``sliding_md5_words`` takes a CPU tensor to the plain version
(:func:`sliding_plain`) and a CUDA tensor to the kernel, with no other
route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.md5 import to_uint32
from repro_torch.kernels.ref import MASK, as_words64, md5_window_a

LAUNCHES = _build.LaunchCounter("sliding_md5")

# window offsets hashed per step of the plain version (bounds its memory)
PLAIN_BLOCK = 1 << 22


def phases_for(stride: int) -> Tuple[int, ...]:
    if stride not in (1, 2, 4):
        raise ValueError(f"stride must be 1, 2 or 4, got {stride}")
    return tuple(range(0, 4, stride))


def byte_phase_strips(words: torch.Tensor, phases: Tuple[int, ...],
                      pad_words: int) -> torch.Tensor:
    """[B, L] words -> [B, R, L + pad_words] int64 strips: strip r holds
    the row's bytes shifted left by r, so word q of strip r is the word
    at byte 4q + r; trailing words are zero."""
    words = as_words64(words)
    B = words.shape[0]
    zero = torch.zeros((B, 1), dtype=torch.int64, device=words.device)
    nxt = torch.cat([words[:, 1:], zero], dim=1)
    strips = []
    for r in phases:
        s = words if r == 0 else \
            (words >> (8 * r)) | ((nxt << (32 - 8 * r)) & MASK)
        strips.append(torch.nn.functional.pad(s, (0, pad_words)))
    return torch.stack(strips, dim=1)


def sliding_plain(words: torch.Tensor, w_words: int,
                  stride: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the tensor's own device:
    [B, L] words -> [B, R, L] uint32 window hashes."""
    phases = phases_for(stride)
    B, L = words.shape
    strips = byte_phase_strips(words, phases, w_words)   # [B, R, L+ww]
    out = torch.empty((B, len(phases), L), dtype=torch.int64,
                      device=words.device)
    for q0 in range(0, L, PLAIN_BLOCK):
        n = min(PLAIN_BLOCK, L - q0)
        M = [strips[:, :, q0 + j:q0 + j + n] for j in range(w_words)]
        out[:, :, q0:q0 + n] = md5_window_a(M, w_words)
    return to_uint32(out)


def sliding_md5_words(words: torch.Tensor, w_words: int, stride: int,
                      stream: Optional[torch.cuda.Stream] = None
                      ) -> torch.Tensor:
    """Window hashes of every byte phase of B rows: ``words`` [B, L]
    uint32 or int32 -> [B, 4 // stride, L] uint32.

    ``w_words`` lies in [1, 13] (windows of 4 to 52 bytes); ``stride`` is
    1, 2 or 4.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on ``stream`` (default: the current stream),
    without synchronising."""
    if words.dim() != 2:
        raise ValueError(f"words must be [B, L], got {tuple(words.shape)}")
    if not 0 < w_words <= 13:
        raise ValueError(f"w_words={w_words} must lie in [1, 13]")
    R = len(phases_for(stride))
    if words.device.type == "cpu":
        return sliding_plain(words, w_words, stride)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.dtype not in (torch.uint32, torch.int32) \
            or not words.is_contiguous():
        raise ValueError("words must be a contiguous uint32/int32 tensor")
    B, L = words.shape
    stream = stream or torch.cuda.current_stream(words.device)
    with torch.cuda.stream(stream):
        out = torch.empty((B, R, L), dtype=torch.uint32,
                          device=words.device)
    if B == 0 or L == 0:
        return out
    lib = _build.library()
    err = lib.cdll.sliding_md5_launch(words.data_ptr(), out.data_ptr(), B,
                                      L, w_words, stride,
                                      stream.cuda_stream)
    lib.check(err, "sliding_md5")
    LAUNCHES.inc()
    return out
