"""Core transformer layers: RMSNorm, RoPE, GQA attention, MLPs.

All functions are pure functions of tensors; a parameter group ``p`` is
anything indexable by name (a dict of tensors, or a module of
``repro_torch.models.model``).  Attention is *blocked* (a loop over query
blocks with an in-block causal mask) so the S x S score tensor is never
materialised at 32k context: O(S * block) live memory rather than
O(S^2).

Numerics follow the JAX package's ``models/layers.py`` step for step:
products that JAX asks for in f32 (``preferred_element_type``) take f32
operands here, the softmax runs in f32, and its probabilities are cast
to the compute dtype before P.V.  No fused attention call (SDPA, the
port's flash kernel) is used, because each rounds P elsewhere.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Query-block length for blocked attention.  4096-token training shapes use
# a single block; 32k prefill loops over 8 blocks of 4k.
DEFAULT_Q_BLOCK = 2048

# masked scores, as the JAX package writes them
NEG_INF = -1e30


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
    scale = torch.full((), qh.shape[-1] ** -0.5, dtype=score_dtype,
                       device=qh.device)
    ct = torch.promote_types(qh.dtype, score_dtype)
    scores = torch.einsum("bkgth,bksh->bkgts", qh.to(ct), kh.to(ct)
                          ).to(score_dtype)
    scores.mul_(scale)                                     # a fresh tensor
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = k_pos[None, :] <= q_pos[:, None]                # causal  [Tq, Tk]
    if swa_window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < swa_window
    scores = scores.masked_fill_(~mask, NEG_INF)
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
        ob = checkpoint(_attend_block, *args, use_reentrant=False) \
            if remat else _attend_block(*args)
        out.append(ob.permute(0, 3, 1, 2, 4))              # [B,qb,K,G,hd]
    return torch.cat(out, dim=1).reshape(B, S, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_positions: torch.Tensor,
                     cur_pos, softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, H, hd]; caches: [B, C, K, hd]; slot_positions: [C] or
    [B, C] absolute position held by each cache slot (-1 or > cur_pos =>
    masked out); cur_pos: scalar or [B] (ragged continuous batching).
    """
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k_cache.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    sp = slot_positions if slot_positions.ndim == 2 \
        else slot_positions[None, :]                       # [B or 1, C]
    cp = torch.as_tensor(cur_pos, device=q.device).reshape(-1, 1)
    valid = (sp >= 0) & (sp <= cp)                         # [B or 1, C]
    scores = scores.masked_fill_(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(ct), v_cache.to(ct))
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
