"""Core transformer layers: RMSNorm, RoPE, GQA attention, MLPs.

All functions are pure functions of tensors; a parameter group ``p`` is
anything indexable by name (a dict of tensors, or a module of
``repro_torch.models.model``).  Attention is *blocked* (a loop over query
blocks with an in-block causal mask) so the S x S score tensor is never
materialised at 32k context: O(S * block) live memory rather than
O(S^2).

Numerics follow the JAX package's ``models/layers.py`` step for step:
products that JAX asks for in f32 (``preferred_element_type``) take f32
operands here on the CPU; on the card a bf16/f16 product with f32 results
runs on the tensor cores with f32 outputs (``ScoresF32``, the same exact
products summed in f32).  The softmax runs in f32, and its probabilities
are cast to the compute dtype before P.V.  No fused attention call (SDPA,
the port's flash kernel) is used, because each rounds P elsewhere.  Under
grad the scores are scaled and masked out of place (an in-place op on
them makes autograd copy them); serving scales and masks in place.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Query-block length for blocked attention.  4096-token training shapes use
# a single block; 32k prefill loops over 8 blocks of 4k.
DEFAULT_Q_BLOCK = 2048

# masked scores, as the JAX package writes them
NEG_INF = -1e30

# how many query-block checkpoints (``gqa_attention``) are running their
# forward: a selective remat policy around a superblock saves nothing
# inside one, as a ``jax.checkpoint(nothing_saveable)`` nested in an outer
# policy keeps none of its own residuals
_inner_remat = [0]


@contextlib.contextmanager
def inner_remat():
    _inner_remat[0] += 1
    try:
        yield
    finally:
        _inner_remat[0] -= 1


def in_inner_remat() -> bool:
    return _inner_remat[0] > 0


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # [hd/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2]), not halves."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [hd/2]
    angles = positions[..., None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
class ScoresF32(torch.autograd.Function):
    """``a @ b^T`` in f32 from bf16 or f16 operands, on the tensor cores:
    a: [N, M, hd], b: [N, T, hd] -> [N, M, T] f32 (``aten::bmm.dtype``, a
    CUDA kernel only, with no derivative of its own).  Each product of two
    bf16 (f16) values is exact in f32, so this is JAX's
    ``preferred_element_type=f32`` product.  Backward, as JAX's transpose
    does, multiplies the f32 grad by the other operand promoted to f32 and
    rounds the result to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = torch.bmm(grad, b.float()).to(a.dtype)
        db = torch.bmm(grad.transpose(1, 2), a.float()).to(b.dtype)
        return da, db


def _tensor_core_scores(q, k) -> bool:
    """Whether a score product with f32 results of ``q`` and ``k`` runs as
    ``ScoresF32``: both CUDA tensors of one 16-bit float dtype."""
    return (q.is_cuda and q.dtype == k.dtype
            and q.dtype in (torch.bfloat16, torch.float16))


def _attend_block(qh, kh, vh, q_pos, k_pos, swa_window, softcap,
                  score_dtype=torch.float32):
    """Softmax attention for one query block against a KV prefix.

    qh: [B, K, G, Tq, hd]; kh, vh: [B, K, Tk, hd]
    q_pos: [Tq], k_pos: [Tk] absolute positions (causal / SWA mask)
    ``score_dtype``: storage dtype of the scores; the product runs in the
    wider of it and the inputs' dtype (JAX's ``preferred_element_type``)
    and softmax computes in f32.
    returns [B, K, G, Tq, hd]
    """
    B, K, G, Tq, hd = qh.shape
    Tk = kh.shape[2]
    # the scale as the reference rounds it to the scores' dtype; a Python
    # number multiplies in one vectorised pass with the same result
    scale = torch.tensor(hd ** -0.5, dtype=score_dtype).item()
    if score_dtype == torch.float32 and _tensor_core_scores(qh, kh):
        scores = ScoresF32.apply(qh.reshape(B * K, G * Tq, hd),
                                 kh.reshape(B * K, Tk, hd)
                                 ).view(B, K, G, Tq, Tk)
    else:
        ct = torch.promote_types(qh.dtype, score_dtype)
        scores = torch.einsum("bkgth,bksh->bkgts", qh.to(ct), kh.to(ct)
                              ).to(score_dtype)
    in_place = not torch.is_grad_enabled()
    scores = scores.mul_(scale) if in_place else scores * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = k_pos[None, :] <= q_pos[:, None]                # causal  [Tq, Tk]
    if swa_window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < swa_window
    scores = scores.masked_fill_(~mask, NEG_INF) if in_place \
        else torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(qh.dtype)
    ct = torch.promote_types(probs.dtype, vh.dtype)
    return torch.einsum("bkgts,bksh->bkgth", probs.to(ct), vh.to(ct))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor, k_positions: torch.Tensor,
                  swa_window: int = 0, softcap: float = 0.0,
                  q_block: int = DEFAULT_Q_BLOCK,
                  score_dtype=torch.float32) -> torch.Tensor:
    """Blocked causal GQA attention.

    q: [B, S, H, hd]; k, v: [B, Sk, K, hd] with H = K * G.
    Inputs go head-major once, then a loop over query blocks computes
    softmax against the full (masked) KV.  With grad enabled each block
    runs under ``torch.utils.checkpoint``, as the JAX package
    rematerialises it, so backward holds one block's scores at a time.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qh = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)  # [B,K,G,S,hd]
    kh = k.permute(0, 2, 1, 3)                             # [B,K,S,hd]
    vh = v.permute(0, 2, 1, 3)
    if S <= q_block:
        out = _attend_block(qh, kh, vh, q_positions, k_positions,
                            swa_window, softcap, score_dtype)
        return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)

    assert S % q_block == 0, (S, q_block)
    remat = torch.is_grad_enabled()
    out = []
    for i in range(S // q_block):
        sl = slice(i * q_block, (i + 1) * q_block)
        args = (qh[:, :, :, sl], kh, vh, q_positions[sl], k_positions,
                swa_window, softcap, score_dtype)
        if remat:
            with inner_remat():
                ob = checkpoint(_attend_block, *args, use_reentrant=False)
        else:
            ob = _attend_block(*args)
        out.append(ob.permute(0, 3, 1, 2, 4))              # [B,qb,K,G,hd]
    return torch.cat(out, dim=1).reshape(B, S, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_positions: torch.Tensor,
                     cur_pos, softcap: float = 0.0,
                     group=None) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, H, hd]; caches: [B, C, K, hd]; slot_positions: [C] or
    [B, C] absolute position held by each cache slot (-1 or > cur_pos =>
    masked out); cur_pos: scalar or [B] (ragged continuous batching).

    With ``group`` (a process group), the caches are this rank's share of
    the slots (the flash-decoding layout) and q is whole on every rank:
    the group's max and sum of exponentials are all-reduced before the
    probabilities are rounded to q's dtype, and each rank's P.V (f32
    results) is summed over the group, then rounded as the one product
    would be.
    """
    B, _, H, hd = q.shape
    C, K = k_cache.shape[1:3]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    scale = hd ** -0.5
    tensor_cores = _tensor_core_scores(qg, k_cache)
    if tensor_cores:
        # the cache read in place as [B, C, K * hd]: one product against q
        # laid out block-diagonally ([B, K * G, K * hd], zero outside each
        # head's own block) gives every head's scores; the zeros add
        # nothing, and K times the products still leave the product bound
        # by the cache's bytes
        eye = torch.eye(K, dtype=torch.bool, device=q.device)
        qbd = torch.where(eye[:, None, :, None], qg[:, :, :, None, :], 0)
        scores = torch.bmm(qbd.reshape(B, K * G, K * hd),
                           k_cache.reshape(B, C, K * hd).transpose(1, 2),
                           out_dtype=torch.float32).view(B, K, G, C) * scale
    else:
        scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                              k_cache.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    sp = slot_positions if slot_positions.ndim == 2 \
        else slot_positions[None, :]                       # [B or 1, C]
    cp = torch.as_tensor(cur_pos, device=q.device).reshape(-1, 1)
    valid = (sp >= 0) & (sp <= cp)                         # [B or 1, C]
    scores = scores.masked_fill_(~valid[:, None, None, :], NEG_INF)
    if group is None:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        top = scores.amax(-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(scores - top)
        total = e.sum(-1, keepdim=True)
        dist.all_reduce(total, group=group)
        probs = (e / total).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v_cache.dtype)
    if tensor_cores:
        # every head's probabilities against the whole cache row, in
        # place; each head keeps its own block of the [K * G, K * hd] result
        kw = {} if group is None else {"out_dtype": torch.float32}
        pv = torch.bmm(probs.reshape(B, K * G, C),
                       v_cache.reshape(B, C, K * hd), **kw)
        out = torch.diagonal(pv.view(B, K, G, K, hd), dim1=1, dim2=3)
        out = out.permute(0, 3, 1, 2)
    elif group is None:
        out = torch.einsum("bkgs,bskh->bkgh", probs.to(ct), v_cache.to(ct))
    else:
        out = torch.einsum("bkgs,bskh->bkgh", probs.float(), v_cache.float())
    if group is not None:
        out = out.contiguous()
        dist.all_reduce(out, group=group)
        out = out.to(ct)
    return out.reshape(B, 1, H, hd)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp(x: torch.Tensor, p, mlp_type: str) -> torch.Tensor:
    dtype = x.dtype
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w1"].to(dtype)) * (x @ p["w3"].to(dtype))
    elif mlp_type == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w1"].to(dtype), approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ p["w2"].to(dtype)


def mlp_param_shapes(d: int, f: int, mlp_type: str) -> dict:
    shapes = {"w1": (d, f), "w2": (f, d)}
    if mlp_type == "swiglu":
        shapes["w3"] = (d, f)
    return shapes
