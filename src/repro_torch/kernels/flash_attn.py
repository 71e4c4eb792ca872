"""Causal flash-attention forward: the CUDA kernel and its plain version.

Replaces the TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attn.py``, ``_flash_kernel``), with its layout
and shape contract: q [BH, S, hd], k and v [BH, Sk, hd], S % bq == 0 and
Sk % bk == 0, output [BH, S, hd] in q's dtype.  Scores are scaled by
``hd ** -0.5`` and masked by ``k_pos <= q_pos`` on absolute positions, so
with Sk != S the mask is aligned at the start (not PyTorch's end-aligned
decode mask).  No module of the JAX package calls it besides its tests:
this function is its own entry point.

Two kernels, chosen by dtype, take hd 32, 64 or 128, run both products
on the tensor cores (TMA loads, wgmma), accumulate in f32 with an online
softmax and skip key tiles wholly above the diagonal; ``bq`` and ``bk``
are the TPU kernel's VMEM block sizes and remain here only as the shape
contract:

- bf16 and f16: ``csrc/flash_attn_wgmma.cu``, 128 queries by 128 keys,
  one instantiation per type.  Like the reference it rounds P to the
  input type before P.V.
- f32: ``csrc/flash_attn_tf32.cu``, 3xTF32: each operand x is split into
  TF32 parts hi = rna(x) and lo = rna(x - hi) and each product is
  hi.hi + hi.lo + lo.hi, 128 queries by 32 keys.  A pre-pass kernel
  (:func:`tf32_split`, plain version :func:`tf32_split_plain`) writes the
  planes q_hi, q_lo, k_hi, k_lo and V transposed to vt_hi, vt_lo
  [BH, hd, Sk padded to KEY_TILE], with the keys of every group of 8 in
  the order ``KEY_PERM``; the main kernel splits P itself.

``flash_attention_fwd`` takes CPU tensors of any head dim and any
floating dtype to the plain version (:func:`flash_plain`, a naive causal
softmax in f32, returned in q's dtype), as the reference computes them,
and CUDA tensors to the kernel of their dtype, with no other route: a
CUDA tensor of a head dim or dtype the kernels lack raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LaunchCounter("flash_attn")
SPLIT_LAUNCHES = _build.LaunchCounter("flash_tf32_split")

BQ = 128
BK = 512
NEG = -1e30
# what the CUDA kernels take
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# score bytes the plain version holds at once (bounds its memory)
PLAIN_SCORE_BYTES = 1 << 30
# unit roundoff of the 16-bit types (8 and 11 significant bits, round to
# nearest), and f16's least normal number: below it an f16 value keeps an
# absolute error of up to HALF_U[f16] * F16_MIN_NORMAL
BF16_U = 2.0 ** -8
HALF_U = {torch.bfloat16: BF16_U, torch.float16: 2.0 ** -11}
F16_MIN_NORMAL = 2.0 ** -14
# keys per tile of the f32 kernel: vT's key axis is padded to a multiple
KEY_TILE = 32
# vT slot s of each group of 8 keys holds key KEY_PERM[s]: the f32 kernel
# feeds its S accumulator (keys 2t, 2t + 1 of a thread) to P.V as the
# TF32 A fragment (k slots t, t + 4) without a shuffle
KEY_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
# TF32 keeps the top 10 of f32's 23 stored significand bits
TF32_DROP_BITS = 13


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``: integer arithmetic on the bits (a carry runs
    into the exponent), so it runs on CPU torch.  Infinities and NaNs
    pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    half = 1 << (TF32_DROP_BITS - 1)
    rounded = (bits + half) & -(1 << TF32_DROP_BITS)
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(torch.float32)


def _padded_keys(sk: int) -> int:
    return -(-sk // KEY_TILE) * KEY_TILE


def _hi_lo(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)       # x - hi is exact in f32


def tf32_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of the f32 kernel's pre-pass, on the tensors' own
    device: ``(q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo)``, hi = rna(x) and
    lo = rna(x - hi) in TF32; q and k keep their layout, v goes to vT
    [BH, hd, sk_pad] with sk_pad = Sk rounded up to KEY_TILE, zeros past
    Sk, and within every group of 8 keys slot s holding key
    ``KEY_PERM[s]``."""
    BH, Sk, hd = v.shape
    sk_pad = _padded_keys(Sk)
    vp = torch.zeros((BH, sk_pad, hd), dtype=torch.float32, device=v.device)
    vp[:, :Sk] = v
    perm = torch.tensor(KEY_PERM, device=v.device)
    vt = vp.view(BH, sk_pad // 8, 8, hd)[:, :, perm] \
        .reshape(BH, sk_pad, hd).transpose(1, 2).contiguous()
    return (*_hi_lo(q.float()), *_hi_lo(k.float()), *_hi_lo(vt))


def tf32_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The f32 kernel's pre-pass: the six planes of
    :func:`tf32_split_plain`.  CPU tensors take the plain version; CUDA
    tensors (f32, contiguous, on 16-byte boundaries; shapes as
    :func:`flash_attention_fwd` checks them) launch the kernel on the
    current stream, without synchronising."""
    if q.device.type == "cpu":
        return tf32_split_plain(q, k, v)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous f32 on 16-byte "
                         "boundaries")
    BH, S, hd = q.shape
    Sk = k.shape[1]
    sk_pad = _padded_keys(Sk)
    planes = (*(torch.empty_like(q) for _ in range(2)),
              *(torch.empty_like(k) for _ in range(2)),
              *(torch.empty((BH, hd, sk_pad), dtype=torch.float32,
                            device=q.device) for _ in range(2)))
    lib = _build.library()
    err = lib.cdll.flash_tf32_split_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(p.data_ptr() for p in planes), BH, S, Sk, sk_pad, hd,
        torch.cuda.current_stream(q.device).cuda_stream)
    lib.check(err, "flash_tf32_split")
    SPLIT_LAUNCHES.inc((BH, S, Sk, hd), q.nbytes + k.nbytes + v.nbytes)
    return planes


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


def _floored_weights(q: torch.Tensor, k: torch.Tensor, v_abs: torch.Tensor,
                     floor: float) -> torch.Tensor:
    """sum_j max(p_j, floor) |v_j| / l over each row's unmasked keys, with
    p_j = exp(s_j - max s) and l = sum_j p_j (f32, chunked as
    :func:`flash_plain`)."""
    BH, S, hd = q.shape
    Sk = k.shape[1]
    mask = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(S, device=q.device)[:, None]
    out = torch.empty((BH, S, hd), dtype=torch.float32, device=q.device)
    step = max(1, PLAIN_SCORE_BYTES // max(S * Sk * 4, 1))
    for b0 in range(0, BH, step):
        b1 = min(b0 + step, BH)
        s = torch.einsum("bqd,bkd->bqk", q[b0:b1].float(),
                         k[b0:b1].float()) * hd ** -0.5
        s = torch.where(mask[None], s, NEG)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        p = torch.where(mask[None], p.clamp_min(floor), 0.0)
        out[b0:b1] = torch.einsum("bqk,bkd->bqd", p, v_abs[b0:b1]) / l
    return out


def flash_bf16_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel - ``want``| for the 16-bit kernel of
    q's dtype (bf16 or f16), where ``want`` is ``flash_plain(q, k, v)`` on
    the same inputs.

    The kernel rounds twice where the plain version does not.  With u the
    type's unit roundoff (2**-8 for bf16, 2**-11 for f16; round to
    nearest): each weight p_j is rounded to the type before P.V, which
    moves the output by at most u * sum_j p_j |v_j| / l, that is
    ``u * flash_plain(q, k, |v|)``; and the output is rounded to the type,
    at most u * |want|.  In f16 a weight below the least normal number
    2**-14 keeps an absolute error of up to u * 2**-14, so there the sum
    takes max(p_j, 2**-14) (the kernel's p_j, taken against a running
    max, is never smaller than p_j against the row's max).  3e-5 covers
    sums taken in another order in f32 (the f32 path's 2e-5, plus the
    tensor cores' accumulation)."""
    u = HALF_U[q.dtype]
    if q.dtype == torch.float16:
        weights = _floored_weights(q, k, v.abs().float(), F16_MIN_NORMAL)
    else:
        weights = flash_plain(q, k, v.abs())
    return u * (want.abs() + weights) + 3e-5


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bq: int = BQ, bk: int = BK) -> torch.Tensor:
    """Causal flash attention forward.

    q: [BH, S, hd]; k, v: [BH, Sk, hd] (GQA: the caller broadcasts the
    kv heads), of one floating dtype.  Returns [BH, S, hd] in q's dtype.
    CPU tensors of any hd and floating dtype take the plain version.
    CUDA tensors (f32, bf16 or f16; hd 32, 64 or 128) launch the kernel
    of their dtype on the current stream, without synchronising (tensors
    must start on 16-byte boundaries, as TMA and 16-byte loads read
    them).  In f32 that is two launches, the pre-pass
    (:func:`tf32_split`) and the main kernel, counted once in
    ``LAUNCHES``."""
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
    if not q.dtype.is_floating_point or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a floating dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return flash_plain(q, k, v).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"hd={hd} not supported on the card; expected one "
                         f"of {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported on the card; "
                         f"expected one of {DTYPES}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    lib = _build.library()
    if q.dtype in HALF_U:
        launch = lib.cdll.flash_attn_wgmma_launch \
            if q.dtype == torch.bfloat16 \
            else lib.cdll.flash_attn_wgmma_f16_launch
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     BH, S, Sk, hd, hd ** -0.5, stream)
    else:
        planes = tf32_split(q, k, v)
        err = lib.cdll.flash_attn_tf32_launch(
            *(p.data_ptr() for p in planes), out.data_ptr(), BH, S, Sk,
            planes[4].shape[2], hd, hd ** -0.5, stream)
    lib.check(err, "flash_attn")
    LAUNCHES.inc((BH, S, Sk, hd), q.nbytes + k.nbytes + v.nbytes)
    return out
