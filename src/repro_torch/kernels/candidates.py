"""Boundary candidates of content-defined chunking: the CUDA kernel and
its plain version.

Replaces no TPU kernel.  The JAX package brings every window hash to the
host and tests the chunking rule there (``chunking.select_boundaries``);
this kernel (``csrc/candidates.cu``) tests ``(h & mask) == magic`` where
the hashes lie and compacts the hits, so only the candidate window
indices leave the card and the host keeps the greedy min/max walk.  It
is bound by the bytes of the hashes it reads (see the note in the
source).

Input is a window-hash kernel's output as it comes: ``sliding_md5``'s
phase-major ``[B, R, Wc]`` (window index ``k = q * R + i`` at
``[b, i, q]``) or gear's per-byte ``[B, L]`` viewed as ``[B, 1, L]``.
``n_off[b]`` bounds row b: windows at ``k >= n_off[b]`` hash stale bytes
of a reused staging row or the padding of a bucketed width and are never
candidates.

With a second rule (``mask2``, ``magic2``: FastCDC's loose mask beside
its strict one) a window is a candidate when it meets either, and comes
back as the code ``4 * k + flags`` (:func:`decode`): flag bit 0 when it
meets the first rule, bit 1 the second.  Codes ascend as the indices do.

``boundary_candidates`` takes a CPU tensor to the plain version
(:func:`candidates_plain`) and a CUDA tensor to the kernel, with no other
route.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import as_words64

LAUNCHES = _build.LaunchCounter("boundary_candidates")

# word offsets q per block of the kernel (kTileQ in csrc/candidates.cu)
TILE_Q = 1024
# gridDim.y of the launch
MAX_ROWS = 65535


# flag bits of a two-rule candidate code, below its window index
FLAG_BITS = 2


def decode(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-rule candidate codes -> (window indices, meets the first rule,
    meets the second), as numpy arrays."""
    codes = np.asarray(codes, np.int64)
    return codes >> FLAG_BITS, (codes & 1) != 0, (codes & 2) != 0


def _checked(hashes: torch.Tensor, n_off: Sequence[int],
             rules: Sequence[int]) -> np.ndarray:
    if hashes.dim() != 3 or hashes.shape[1] not in (1, 2, 4):
        raise ValueError("hashes must be [B, R, Wc] with R in (1, 2, 4), "
                         f"got {tuple(hashes.shape)}")
    if not all(0 <= int(v) < 2 ** 32 for v in rules):
        raise ValueError("masks and magics must be 32-bit unsigned")
    B, R, Wc = hashes.shape
    n_off = np.clip(np.asarray(n_off, np.int64).reshape(-1), 0, R * Wc)
    if n_off.shape != (B,):
        raise ValueError(f"n_off needs {B} entries, got {n_off.shape[0]}")
    return n_off


def _rules(mask, magic, mask2, magic2) -> Tuple[int, ...]:
    """(mask, magic) or (mask, magic, mask2, magic2)."""
    return (mask, magic) if mask2 is None else (mask, magic, mask2, magic2)


def candidates_plain(hashes: torch.Tensor, n_off: Sequence[int], mask: int,
                     magic: int, mask2: Optional[int] = None,
                     magic2: int = 0) -> Tuple[torch.Tensor, np.ndarray]:
    """Plain PyTorch version of the kernel, on the tensor's own device:
    ``[B, R, Wc]`` window hashes -> (the rows' candidate window indices,
    or with a second rule their codes, concatenated, int64 and ascending
    within each row; each row's count as an int64 array)."""
    n_off = _checked(hashes, n_off, _rules(mask, magic, mask2, magic2))
    B, R, Wc = hashes.shape
    by_k = as_words64(hashes).transpose(1, 2).reshape(B, Wc * R)
    k = torch.arange(Wc * R, device=hashes.device)
    kept = k[None] < torch.from_numpy(n_off).to(hashes.device)[:, None]
    hit = ((by_k & mask) == magic) & kept
    if mask2 is None:
        rows, ks = torch.nonzero(hit, as_tuple=True)
        found = ks
    else:
        hit2 = ((by_k & mask2) == magic2) & kept
        rows, ks = torch.nonzero(hit | hit2, as_tuple=True)
        found = (ks << FLAG_BITS) + hit[rows, ks] + 2 * hit2[rows, ks]
    counts = torch.bincount(rows, minlength=B).cpu().numpy()
    return found, counts.astype(np.int64)


def boundary_candidates(hashes: torch.Tensor, n_off: Sequence[int],
                        mask: int, magic: int, mask2: Optional[int] = None,
                        magic2: int = 0,
                        stream: Optional[torch.cuda.Stream] = None
                        ) -> Tuple[torch.Tensor, np.ndarray]:
    """Window indices ``k < n_off[b]`` of each row b whose hash h has
    ``(h & mask) == magic``: ``hashes`` [B, R, Wc] uint32 -> (int64
    tensor of every row's indices in row order, ascending within a row,
    on the hashes' device; [B] int64 host array of the rows' counts).
    With ``mask2`` the windows that meet either rule, as codes
    ``4 * k + flags`` (see the module docstring).

    A CPU tensor takes the plain version.  A CUDA tensor runs the
    kernel's two passes on ``stream`` (default: the current stream) and
    synchronises it once, between them, to size the output exactly;
    ``LAUNCHES`` counts each pass that launches (the scatter pass is
    skipped when no window is a candidate)."""
    if hashes.device.type == "cpu":
        return candidates_plain(hashes, n_off, mask, magic, mask2, magic2)
    if hashes.device.type != "cuda":
        raise ValueError(f"unsupported device {hashes.device}")
    n_off = _checked(hashes, n_off, _rules(mask, magic, mask2, magic2))
    rules = (1, 0, 0) if mask2 is None else (2, mask2, magic2)
    if hashes.dtype not in (torch.uint32, torch.int32) \
            or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous uint32/int32 tensor")
    B, R, Wc = hashes.shape
    if B > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {B}")
    dev = hashes.device
    stream = stream or torch.cuda.current_stream(dev)
    q_max = -(-int(n_off.max(initial=0)) // R)
    tiles = -(-q_max // TILE_Q)
    if B == 0 or tiles == 0:
        return (torch.empty((0,), dtype=torch.int64, device=dev),
                np.zeros((B,), np.int64))
    lib = _build.library()
    with torch.cuda.stream(stream):
        n_off_d = torch.from_numpy(n_off).to(dev)
        counts = torch.empty((B, tiles), dtype=torch.int32, device=dev)
        err = lib.cdll.candidate_count_launch(
            hashes.data_ptr(), n_off_d.data_ptr(), counts.data_ptr(), B, R,
            Wc, tiles, mask, magic, *rules, stream.cuda_stream)
        lib.check(err, "candidate_count")
        # the count pass reads each row's hashes below n_off once
        read = 4 * int(n_off.sum())
        LAUNCHES.inc((B, R, Wc), read)
        ends = torch.cumsum(counts.view(-1), 0, dtype=torch.int64)
        row_ends, hit_tiles = torch.stack(
            (ends.view(B, tiles)[:, -1],
             (counts != 0).sum(1, dtype=torch.int64))).cpu().numpy()
        out = torch.empty((int(row_ends[-1]),), dtype=torch.int64,
                          device=dev)
        if out.numel():
            err = lib.cdll.candidate_scatter_launch(
                hashes.data_ptr(), n_off_d.data_ptr(), ends.data_ptr(),
                counts.data_ptr(), out.data_ptr(), B, R, Wc, tiles, mask,
                magic, *rules, stream.cuda_stream)
            lib.check(err, "candidate_scatter")
            # ... and the scatter pass again in the tiles that hold a hit
            LAUNCHES.inc((B, R, Wc),
                         min(read, 4 * R * TILE_Q * int(hit_tiles.sum())))
    return out, np.diff(row_ends, prepend=0)
