"""Direct MD5 of B word-aligned messages: the CUDA kernel and its plain
version.

Replaces the TPU kernel ``md5_pallas`` (``src/repro/kernels/md5.py``,
``_md5_kernel``).  The kernel (``csrc/md5.cu``) runs one thread per
message and loops over its 64-byte chunks in registers; at the write
path's shapes it is bound by one thread's chain of dependent rounds (see
the note in the source).

``md5_words`` takes a CPU tensor to the plain version
(:func:`md5_plain`) and a CUDA tensor to the kernel; there is no other
route and no fallback.  Unlike the TPU kernel, the message may fill its
row: ``lens_w <= W`` with no spare words.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import md5_words_ref

LAUNCHES = _build.LaunchCounter("md5")

_WORD_DTYPES = (torch.uint32, torch.int32)

# The plain version issues hundreds of small torch ops per 64-byte chunk,
# each of which releases and retakes the interpreter lock.  Threads that
# run it at once (the managers of a mesh of CPU devices) convoy on that
# lock: four of them took about ten times longer than taking turns.  So
# they take turns.
_PLAIN_TURN = threading.Lock()


def to_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> uint32 tensor of the same bits."""
    x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return x.to(torch.int32).view(torch.uint32)


def md5_plain(words: torch.Tensor, lens_w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the tensors' own device:
    [B, W] words + [B] word lengths -> [B, 4] uint32 digest words."""
    with _PLAIN_TURN:
        return to_uint32(md5_words_ref(words, lens_w.to(words.device)))


def md5_words(words: torch.Tensor, lens_w: torch.Tensor,
              stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """MD5 digests of the B rows of ``words`` ([B, W] uint32 or int32,
    row-major), row b being ``lens_w[b]`` words long (``<= W``).

    Returns [B, 4] uint32 (the standard digest as four little-endian
    words).  A CPU ``words`` tensor takes the plain version; a CUDA one
    launches the kernel on ``stream`` (default: the current stream),
    without synchronising.  ``lens_w`` may lie on the host (it is checked
    there and copied on the stream) or on the words' device."""
    if words.dim() != 2:
        raise ValueError(f"words must be [B, W], got {tuple(words.shape)}")
    B, W = words.shape
    if lens_w.shape != (B,):
        raise ValueError(f"lens_w must be [{B}], got {tuple(lens_w.shape)}")
    if lens_w.device.type == "cpu" and B and (
            int(lens_w.min()) < 0 or int(lens_w.max()) > W):
        raise ValueError(f"message lengths must lie in [0, {W}] words")
    if words.device.type == "cpu":
        return md5_plain(words, lens_w)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.dtype not in _WORD_DTYPES or not words.is_contiguous():
        raise ValueError("words must be a contiguous uint32/int32 tensor")
    stream = stream or torch.cuda.current_stream(words.device)
    with torch.cuda.stream(stream):
        lens_dev = lens_w.to(words.device, torch.int32, non_blocking=True)
        lens_dev = lens_dev.contiguous()
        out = torch.empty((B, 4), dtype=torch.uint32, device=words.device)
    if B == 0:
        return out
    lib = _build.library()
    err = lib.cdll.md5_direct_launch(words.data_ptr(), lens_dev.data_ptr(),
                                     out.data_ptr(), B, W,
                                     stream.cuda_stream)
    lib.check(err, "md5_direct")
    LAUNCHES.inc()
    return out
