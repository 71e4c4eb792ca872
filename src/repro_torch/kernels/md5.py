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

``md5_spans`` is the kernel's second entry (``md5_direct_kernel_spans``),
for the write path: the block digests ``MD5(pad4(chunk) ||
u32_le(len))`` of chunks that lie end to end in one image, each read
where it lies, so no padded row is packed or copied.  Its plain version
(:func:`md5_spans_plain`) builds the padded messages in PyTorch and
hashes them with :func:`md5_plain`.  ``LAUNCHES`` counts the row
entry's launches (``md5_direct_kernel``), ``SPAN_LAUNCHES`` the spans
entry's, so each says whether its own kernel ran.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import md5_words_ref

LAUNCHES = _build.LaunchCounter("md5")
SPAN_LAUNCHES = _build.LaunchCounter("md5_spans")

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


# the plain spans version gathers a batch of chunks into rows of at most
# about this many bytes at a time
_PLAIN_SPAN_BYTES = 1 << 24


def _check_spans(image_words: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor) -> int:
    """Raise unless ``image_words`` is 1-D and ``starts``/``lens`` are
    equal 1-D host tensors of spans inside it; the number of spans."""
    if image_words.dim() != 1:
        raise ValueError(f"image_words must be 1-D, got "
                         f"{tuple(image_words.shape)}")
    if starts.dim() != 1 or lens.shape != starts.shape:
        raise ValueError(f"starts and lens must be equal 1-D tensors, got "
                         f"{tuple(starts.shape)} and {tuple(lens.shape)}")
    if starts.device.type != "cpu" or lens.device.type != "cpu":
        raise ValueError("starts and lens must lie on the host")
    n = starts.numel()
    if n and (int(starts.min()) < 0 or int(lens.min()) < 0
              or int((starts + lens).max()) > 4 * image_words.numel()):
        raise ValueError(f"spans must lie in the image's "
                         f"{4 * image_words.numel()} bytes")
    return n


def md5_spans_plain(image_words: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the spans entry, on the image's own
    device: each chunk copied into a zeroed row with its length word
    after it (the row ``pack_blocks`` builds), then hashed by
    :func:`md5_plain` (on the CPU through :func:`md5_words`, which takes
    CPU rows there).
    Chunks go in order of length, a batch of rows of about
    ``_PLAIN_SPAN_BYTES`` at a time.  Returns [n, 4] uint32."""
    n = _check_spans(image_words, starts, lens)
    dev = image_words.device
    img = image_words.contiguous().view(torch.int32).view(torch.uint8)
    if img.numel() == 0:
        img = torch.zeros((1,), dtype=torch.uint8, device=dev)
    # md5_words takes CPU rows to md5_plain; on the card the plain
    # version must not launch the kernel
    hash_rows = md5_words if dev.type == "cpu" else md5_plain
    out = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    lens_h = lens.to(torch.int64).numpy()
    order = np.argsort(lens_h, kind="stable")
    width = 4 * ((lens_h[order] + 3) // 4 + 1)     # row bytes, ascending
    i = 0
    while i < n:
        lo, hi = 1, n - i              # most rows whose widest fits
        while lo < hi:
            k = (lo + hi + 1) // 2
            if k * width[i + k - 1] <= _PLAIN_SPAN_BYTES:
                lo = k
            else:
                hi = k - 1
        sel = torch.from_numpy(order[i:i + lo]).to(dev)
        s = starts.to(dev, torch.int64)[sel]
        ln = lens.to(dev, torch.int64)[sel]
        b = torch.arange(int(width[i + lo - 1]), device=dev)
        inside = b[None, :] < ln[:, None]
        rows = torch.where(inside, img[torch.where(inside, s[:, None]
                                                   + b[None, :], 0)], 0)
        words = rows.view(torch.int32)
        lw = (ln + 3) // 4
        words[torch.arange(lo, device=dev), lw] = ln.to(torch.int32)
        out[sel] = hash_rows(words, lw + 1).view(torch.int32)
        i += lo
    return out.view(torch.uint32)


def md5_spans(image_words: torch.Tensor, starts: torch.Tensor,
              lens: torch.Tensor,
              stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """Block digests ``MD5(pad4(chunk) || u32_le(len))`` of the chunks
    ``[starts[i], starts[i] + lens[i])`` (bytes) of one image.

    ``image_words`` is the image as a 1-D uint32 or int32 tensor, its
    bytes followed by a zero tail to a word multiple; ``starts`` and
    ``lens`` are 1-D int64 host tensors of spans inside it (checked
    here, then copied on the stream).  Returns [n, 4] uint32, as
    :func:`md5_words`.  A CPU image takes the plain version; a CUDA one
    launches ``md5_direct_kernel_spans`` on ``stream`` (default: the
    current stream), without synchronising."""
    n = _check_spans(image_words, starts, lens)
    if image_words.device.type == "cpu":
        return md5_spans_plain(image_words, starts, lens)
    if image_words.device.type != "cuda":
        raise ValueError(f"unsupported device {image_words.device}")
    if image_words.dtype not in _WORD_DTYPES \
            or not image_words.is_contiguous():
        raise ValueError("image_words must be a contiguous uint32/int32 "
                         "tensor")
    dev = image_words.device
    stream = stream or torch.cuda.current_stream(dev)
    with torch.cuda.stream(stream):
        starts_dev = starts.to(dev, torch.int64, non_blocking=True)
        lens_dev = lens.to(dev, torch.int64, non_blocking=True)
        out = torch.empty((n, 4), dtype=torch.uint32, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    err = lib.cdll.md5_spans_launch(
        image_words.data_ptr(), starts_dev.contiguous().data_ptr(),
        lens_dev.contiguous().data_ptr(), out.data_ptr(), n,
        stream.cuda_stream)
    lib.check(err, "md5_spans")
    SPAN_LAUNCHES.inc()
    return out
