"""Causal flash-attention forward: the CUDA kernel and its plain version.

Replaces the TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attn.py``, ``_flash_kernel``), with its layout
and shape contract: q [BH, S, hd], k and v [BH, Sk, hd], S % bq == 0 and
Sk % bk == 0, output [BH, S, hd] in q's dtype.  Scores are scaled by
``hd ** -0.5`` and masked by ``k_pos <= q_pos`` on absolute positions, so
with Sk != S the mask is aligned at the start (not PyTorch's end-aligned
decode mask).  No module of the JAX package calls it besides its tests:
this function is its own entry point.

Two kernels, chosen by dtype, take hd 32, 64 or 128, accumulate in f32
with an online softmax and skip key tiles wholly above the diagonal;
``bq`` and ``bk`` are the TPU kernel's VMEM block sizes and remain here
only as the shape contract:

- bf16: ``csrc/flash_attn_wgmma.cu``, on the tensor cores (TMA loads,
  wgmma for both products, 128 queries by 128 keys).  Like the reference
  it rounds P to bf16 before P.V.
- f32: ``csrc/flash_attn.cu``, f32 FMAs on the CUDA cores (64 by 64).

``flash_attention_fwd`` takes CPU tensors to the plain version
(:func:`flash_plain`, a naive causal softmax in f32) and CUDA tensors to
the kernel of their dtype, with no other route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LaunchCounter("flash_attn")

BQ = 128
BK = 512
NEG = -1e30
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# score bytes the plain version holds at once (bounds its memory)
PLAIN_SCORE_BYTES = 1 << 30
# gridDim.y of the f32 kernel's launch
MAX_BH = 65535
# unit roundoff of bf16 (8 significant bits, round to nearest)
BF16_U = 2.0 ** -8


def flash_plain(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on the tensors' own device: naive causal
    softmax attention in f32 with the start-aligned mask.  Returns f32
    [BH, S, hd]."""
    BH, S, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    mask = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(S, device=q.device)[:, None]
    out = torch.empty((BH, S, hd), dtype=torch.float32, device=q.device)
    step = max(1, PLAIN_SCORE_BYTES // max(S * Sk * 4, 1))
    for b0 in range(0, BH, step):
        b1 = min(b0 + step, BH)
        s = torch.einsum("bqd,bkd->bqk", q[b0:b1].float(),
                         k[b0:b1].float()) * scale
        s = torch.where(mask[None], s, NEG)
        p = torch.softmax(s, dim=-1)
        out[b0:b1] = torch.einsum("bqk,bkd->bqd", p, v[b0:b1].float())
    return out


def flash_bf16_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |bf16 kernel - ``want``|, where ``want`` is
    ``flash_plain(q, k, v)`` on the same bf16 inputs.

    The kernel rounds twice where the plain version does not.  With
    u = 2**-8, bf16's unit roundoff (8 significant bits, round to
    nearest): each weight p_j is rounded to bf16 before P.V, which moves
    the output by at most u * sum_j p_j |v_j| / l, that is
    ``u * flash_plain(q, k, |v|)``; and the output is rounded to bf16, at
    most u * |want|.  3e-5 covers sums taken in another order in f32 (the
    f32 path's 2e-5, plus the tensor cores' accumulation)."""
    return BF16_U * (want.abs() + flash_plain(q, k, v.abs())) + 3e-5


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bq: int = BQ, bk: int = BK) -> torch.Tensor:
    """Causal flash attention forward.

    q: [BH, S, hd]; k, v: [BH, Sk, hd] (GQA: the caller broadcasts the
    kv heads).  f32 or bf16, hd 32, 64 or 128.  Returns [BH, S, hd] in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel of their dtype on the current stream, without
    synchronising (bf16 tensors must start on 16-byte boundaries, as TMA
    reads them)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be [BH, S, hd] and k, v [BH, Sk, hd]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, hd = q.shape
    Sk = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != hd:
        raise ValueError(f"k and v must be [{BH}, Sk, {hd}], got "
                         f"{tuple(k.shape)}")
    if Sk == 0:
        raise ValueError("k and v need at least one key")
    if S % bq or Sk % bk:
        raise ValueError(f"S={S} and Sk={Sk} must be multiples of bq={bq} "
                         f"and bk={bk}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"hd={hd} not supported; expected one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return flash_plain(q, k, v).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if BH > MAX_BH:
        raise ValueError(f"at most {MAX_BH} rows of BH per launch, got {BH}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16-byte boundaries")
    stream = torch.cuda.current_stream(q.device)
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    lib = _build.library()
    launch = lib.cdll.flash_attn_wgmma_launch if bf16 \
        else lib.cdll.flash_attn_fwd_launch
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, S, Sk, hd, hd ** -0.5, stream.cuda_stream)
    lib.check(err, "flash_attn")
    LAUNCHES.inc((BH, S, Sk, hd), q.nbytes + k.nbytes + v.nbytes)
    return out
