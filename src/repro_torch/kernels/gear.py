"""Windowed gear hash at every byte: the CUDA kernel and its plain
version.

Replaces the TPU kernel ``gear_pallas`` (``src/repro/kernels/gear.py``:
``_gear_kernel``, ``_gear_kernel_doubling``, ``_gear_kernel_hybrid``).
The three TPU bodies are three constructions of one function and give
identical output, so one CUDA kernel (``csrc/gear.cu``) serves every
``version`` in :data:`VERSIONS`; the version is still checked, so an
unknown one fails as the reference's lookup does.  The kernel is bound by
memory (1 byte read and 4 written per position).

For row b and byte p, output ``[b, p]`` is
``sum_{j<32} mix32(byte[b, p - j] + 1) << j`` (mod 2**32), where bytes
before the row start are zero bytes: they hash as ``mix32(1)``, as the
TPU kernel's zero history words do.  So positions < 31 differ from
``ref.gear_ref`` (whose history contributes 0) and equal the JAX
package's ``ops.gear_hash``.  The hash is causal: bytes past a position
never change it, so rows zero-padded at the end keep every kept output.

``gear_bytes`` takes a CPU tensor to the plain version
(:func:`gear_plain`) and a CUDA tensor to the kernel, with no other
route.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.md5 import to_uint32
from repro_torch.kernels.ref import GEAR_WINDOW, MASK, mix32

LAUNCHES = _build.LaunchCounter("gear")

# meta['version'] values of the reference's three kernel bodies
VERSIONS = (1, 2, 3)
# byte positions hashed per step of the plain version (bounds its memory)
PLAIN_BLOCK = 1 << 24
# gridDim.y of the launch
MAX_ROWS = 65535


def gear_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the tensor's own device:
    [B, L] uint8 -> [B, L] uint32 gear hashes (zero-byte history)."""
    B, L = data.shape
    hist = GEAR_WINDOW - 1
    g = mix32(data.to(torch.int64) + 1)
    pad = torch.full((B, hist), int(mix32(torch.ones(1))[0]),
                     dtype=torch.int64, device=data.device)
    g = torch.cat([pad, g], dim=1)                  # [B, hist + L]
    out = torch.empty((B, L), dtype=torch.int64, device=data.device)
    for p0 in range(0, L, PLAIN_BLOCK):
        n = min(PLAIN_BLOCK, L - p0)
        h = torch.zeros((B, n), dtype=torch.int64, device=data.device)
        for j in range(GEAR_WINDOW):
            lo = hist + p0 - j
            h += (g[:, lo:lo + n] << j) & MASK
        out[:, p0:p0 + n] = h & MASK
    return to_uint32(out)


def gear_bytes(data: torch.Tensor, version: int = 1,
               stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """Gear hashes of every byte of B rows: ``data`` [B, L] uint8 ->
    [B, L] uint32.

    ``version`` (1, 2 or 3) names the reference's kernel body; all three
    compute the same function here.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on ``stream`` (default:
    the current stream), without synchronising."""
    if version not in VERSIONS:
        raise ValueError(f"unknown gear version {version!r}; "
                         f"expected one of {VERSIONS}")
    if data.dim() != 2:
        raise ValueError(f"data must be [B, L], got {tuple(data.shape)}")
    if data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8, got {data.dtype}")
    if data.device.type == "cpu":
        return gear_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    B, L = data.shape
    if B > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {B}")
    stream = stream or torch.cuda.current_stream(data.device)
    with torch.cuda.stream(stream):
        out = torch.empty((B, L), dtype=torch.uint32, device=data.device)
    if B == 0 or L == 0:
        return out
    lib = _build.library()
    err = lib.cdll.gear_launch(data.data_ptr(), out.data_ptr(), B, L,
                               stream.cuda_stream)
    lib.check(err, "gear")
    LAUNCHES.inc((B, L), B * L)
    return out
