"""Mamba-2 (SSD, state-space duality) mixer in PyTorch.

Implements the chunked SSD algorithm [arXiv:2405.21060] as the JAX
package's ``models/ssm.py`` does: the sequence is split into chunks;
within a chunk the quadratic (attention-dual) form is used, across chunks
a linear recurrence on the [heads, state, head_dim] SSM state is carried
by a loop over chunks.  Decode is an O(1) state update.

The projection and the depthwise conv are split per component (z, x, B,
C, dt), which is mathematically identical to Mamba-2's fused ``in_proj``.

``F.softplus`` returns x itself above its threshold of 20, where
``jax.nn.softplus`` gives x + log1p(exp(-x)); the dropped term is below
exp(-20) = 2.1e-9, under half an f32 ulp of any x above 20 (9.5e-7), so
the threshold adds no error in f32, the dtype dt is taken in.  Below it
the two differ only by the rounding of their formulas (an f32 ulp or so).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig


def ssm_dims(d_model: int, cfg: SSMConfig) -> dict:
    d_in = cfg.expand * d_model
    nheads = d_in // cfg.head_dim
    gn = cfg.ngroups * cfg.state_dim
    return dict(d_in=d_in, nheads=nheads, gn=gn)


def ssm_param_shapes(d_model: int, cfg: SSMConfig) -> dict:
    dims = ssm_dims(d_model, cfg)
    d_in, nheads, gn = dims["d_in"], dims["nheads"], dims["gn"]
    cw = cfg.conv_width
    return {
        "z_proj": (d_model, d_in),
        "x_proj": (d_model, d_in),
        "B_proj": (d_model, gn),
        "C_proj": (d_model, gn),
        "dt_proj": (d_model, nheads),
        "conv_x_w": (cw, d_in), "conv_x_b": (d_in,),
        "conv_B_w": (cw, gn), "conv_B_b": (gn,),
        "conv_C_w": (cw, gn), "conv_C_b": (gn,),
        "A_log": (nheads,),
        "D": (nheads,),
        "dt_bias": (nheads,),
        "gate_norm": (d_in,),
        "out_proj": (d_in, d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: [B,S,C]; w: [cw,C]."""
    cw = w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        shift = cw - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi.float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _conv_step(tail: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token depthwise conv.  tail: [B,cw-1,C]; x_new: [B,1,C].  The
    new tail takes the promoted dtype of the two, as ``jnp.concatenate``
    does."""
    window = torch.cat([tail, x_new], dim=1)               # [B,cw,C]
    out = torch.sum(window.float() * w.float()[None], dim=1, keepdim=True)
    out = F.silu(out + b.float()).to(x_new.dtype)
    return out, window[:, 1:]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    dtype = y.dtype
    y = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                 h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: [B,S,h,p]; dt: [B,S,h] (post-softplus); A: [h] (negative);
    Bm, Cm: [B,S,g,n].  Returns (y [B,S,h,p], final_state [B,h,n,p]).
    A length that is not a multiple of ``chunk`` runs as one chunk of S
    (one S x S block per head), as in the JAX package.
    """
    B_, S, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    if S % chunk:
        chunk = S                                            # tiny shapes
    nc = S // chunk

    dA = dt * A[None, None, :]                               # [B,S,h] <= 0
    h_state = h0 if h0 is not None else torch.zeros(
        (B_, h, n, p), dtype=torch.float32, device=x.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, dAc = x[:, sl], dt[:, sl], dA[:, sl]
        Bc, Cc = Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(dAc.float(), dim=1)               # [B,l,h]
        # intra-chunk (quadratic dual form)
        CB = torch.einsum("bign,bjgn->bgij", Cc.float(), Bc.float())
        CB = torch.repeat_interleave(CB, hpg, dim=1)         # [B,h,l,l]
        li = cum.transpose(1, 2)                             # [B,h,l]
        L = torch.exp(torch.clamp(li[:, :, :, None] - li[:, :, None, :],
                                  -60.0, 0.0))
        W = torch.where(mask[None, None], CB * L, 0.0)
        W = W * dtc.float().transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhij,bjhp->bihp", W, xc.float())
        # inter-chunk contribution from the incoming state
        decay_in = torch.exp(torch.clamp(cum, -60.0, 0.0))   # [B,l,h]
        Ch = torch.repeat_interleave(Cc.float(), hpg, dim=2)  # [B,l,h,n]
        y_off = torch.einsum("blhn,bhnp->blhp", Ch, h_state) \
            * decay_in[..., None]
        # state update
        decay_last = torch.exp(torch.clamp(cum[:, -1], -60.0, 0.0))  # [B,h]
        decay_state = torch.exp(torch.clamp(cum[:, -1:, :] - cum,
                                            -60.0, 0.0))
        Bh = torch.repeat_interleave(Bc.float(), hpg, dim=2)  # [B,l,h,n]
        contrib = torch.einsum("blhn,blh,blhp->bhnp", Bh,
                               decay_state * dtc.float(), xc.float())
        h_state = decay_last[:, :, None, None] * h_state + contrib
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), h_state


def _project(x: torch.Tensor, p):
    dtype = x.dtype
    z = x @ p["z_proj"].to(dtype)
    xr = x @ p["x_proj"].to(dtype)
    Br = x @ p["B_proj"].to(dtype)
    Cr = x @ p["C_proj"].to(dtype)
    dt = x @ p["dt_proj"].to(dtype)
    return z, xr, Br, Cr, dt


def ssm_forward(x: torch.Tensor, p, d_model: int, cfg: SSMConfig,
                return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x: [B,S,d]."""
    dims = ssm_dims(d_model, cfg)
    d_in, nheads = dims["d_in"], dims["nheads"]
    z, xr, Br, Cr, dt = _project(x, p)
    x_c = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"])
    B_c = _causal_conv(Br, p["conv_B_w"], p["conv_B_b"])
    C_c = _causal_conv(Cr, p["conv_C_w"], p["conv_C_b"])
    B_, S, _ = x.shape
    x_h = x_c.reshape(B_, S, nheads, cfg.head_dim)
    Bm = B_c.reshape(B_, S, cfg.ngroups, cfg.state_dim)
    Cm = C_c.reshape(B_, S, cfg.ngroups, cfg.state_dim)
    dt_f = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, h_final = _ssd_chunked(x_h, dt_f, A, Bm, Cm, cfg.chunk_size)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * x_h
    y = y.reshape(B_, S, d_in)
    y = _gated_norm(y, z, p["gate_norm"])
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        cw = cfg.conv_width
        state = {
            "ssm": h_final,
            "conv_x": xr[:, S - (cw - 1):],
            "conv_B": Br[:, S - (cw - 1):],
            "conv_C": Cr[:, S - (cw - 1):],
        }
        return out, state
    return out


def ssm_decode_step(x: torch.Tensor, state: dict, p, d_model: int,
                    cfg: SSMConfig):
    """One-token decode.  x: [B,1,d] -> (y [B,1,d], new_state)."""
    dims = ssm_dims(d_model, cfg)
    d_in, nheads = dims["d_in"], dims["nheads"]
    z, xr, Br, Cr, dt = _project(x, p)
    x_c, conv_x = _conv_step(state["conv_x"], xr, p["conv_x_w"],
                             p["conv_x_b"])
    B_c, conv_B = _conv_step(state["conv_B"], Br, p["conv_B_w"],
                             p["conv_B_b"])
    C_c, conv_C = _conv_step(state["conv_C"], Cr, p["conv_C_w"],
                             p["conv_C_b"])
    B_ = x.shape[0]
    x_h = x_c.reshape(B_, nheads, cfg.head_dim)
    Bm = B_c.reshape(B_, cfg.ngroups, cfg.state_dim)
    Cm = C_c.reshape(B_, cfg.ngroups, cfg.state_dim)
    dt_f = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B,h]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(torch.clamp(dt_f * A[None], -60.0, 0.0))      # [B,h]
    hpg = nheads // cfg.ngroups
    Bh = torch.repeat_interleave(Bm.float(), hpg, dim=1)         # [B,h,n]
    Ch = torch.repeat_interleave(Cm.float(), hpg, dim=1)
    h_new = dA[:, :, None, None] * state["ssm"] \
        + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt_f, x_h.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
    y = y + p["D"].float()[None, :, None] * x_h.float()
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"])
    out = y @ p["out_proj"].to(x.dtype)
    new_state = {"ssm": h_new, "conv_x": conv_x, "conv_B": conv_B,
                 "conv_C": conv_C}
    return out, new_state


def ssm_state_shapes(batch: int, d_model: int, cfg: SSMConfig,
                     dtype=torch.bfloat16) -> dict:
    dims = ssm_dims(d_model, cfg)
    cw = cfg.conv_width
    return {
        "ssm": ((batch, dims["nheads"], cfg.state_dim, cfg.head_dim),
                torch.float32),
        "conv_x": ((batch, cw - 1, dims["d_in"]), dtype),
        "conv_B": ((batch, cw - 1, dims["gn"]), dtype),
        "conv_C": ((batch, cw - 1, dims["gn"]), dtype),
    }
