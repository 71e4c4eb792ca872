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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.sharding import local_shard, reduce_partial

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
    """Depthwise causal conv via shifted adds.  x: [B,S,C]; w: [cw,C].  On
    DTensors each rank convolves its own rows and channels on its local
    shards (each channel is its own filter; DTensor's layout for the
    shifted slices may shard the sequence, which the next product cannot
    take)."""
    if not isinstance(x, DTensor):
        return _conv_local(x, w, b)
    mesh = x.device_mesh
    want_x, want_w, grad_w, want_b, grad_b = [], [], [], [], []
    for i, pl in enumerate(x.placements):
        if pl == Shard(0):                          # rows
            want_x.append(pl)
            want_w.append(Replicate()), grad_w.append(Partial())
            want_b.append(Replicate()), grad_b.append(Partial())
        elif pl == Shard(2) and w.placements[i] == Shard(1):
            want_x.append(pl)                       # channels
            want_w.append(Shard(1)), grad_w.append(Shard(1))
            want_b.append(Shard(0)), grad_b.append(Shard(0))
        else:
            want_x.append(Replicate())
            want_w.append(Replicate()), grad_w.append(Replicate())
            want_b.append(Replicate()), grad_b.append(Replicate())
    out = _conv_local(local_shard(x, want_x), local_shard(w, want_w, grad_w),
                      local_shard(b, want_b, grad_b))
    return DTensor.from_local(out, mesh, want_x)


def _conv_local(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
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
    if isinstance(y, DTensor):
        # a sum over a sharded d_in is partial: all-reduce it, where DTensor
        # would reduce-scatter it over the sequence and carry that layout
        # into the products after
        var = reduce_partial(torch.sum(torch.square(y), dim=-1,
                                       keepdim=True)) / y.shape[-1]
    else:
        var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def _repeat_heads(x: torch.Tensor, hpg: int, dim: int) -> torch.Tensor:
    """``torch.repeat_interleave(x, hpg, dim)`` (each group's entry once
    per head of the group) as a view expanded and merged, which runs on
    fake tensors and DTensors (``repeat_interleave`` reads its output
    size back from the tensor)."""
    x = x.unsqueeze(dim + 1)
    shape = list(x.shape)
    shape[dim + 1] = hpg
    return x.expand(shape).flatten(dim, dim + 1)


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
        CB = _repeat_heads(CB, hpg, 1)         # [B,h,l,l]
        li = cum.transpose(1, 2)                             # [B,h,l]
        L = torch.exp(torch.clamp(li[:, :, :, None] - li[:, :, None, :],
                                  -60.0, 0.0))
        W = torch.where(mask[None, None], CB * L, 0.0)
        W = W * dtc.float().transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhij,bjhp->bihp", W, xc.float())
        # inter-chunk contribution from the incoming state
        decay_in = torch.exp(torch.clamp(cum, -60.0, 0.0))   # [B,l,h]
        Ch = _repeat_heads(Cc.float(), hpg, 2)  # [B,l,h,n]
        y_off = torch.einsum("blhn,bhnp->blhp", Ch, h_state) \
            * decay_in[..., None]
        # state update
        decay_last = torch.exp(torch.clamp(cum[:, -1], -60.0, 0.0))  # [B,h]
        decay_state = torch.exp(torch.clamp(cum[:, -1:, :] - cum,
                                            -60.0, 0.0))
        Bh = _repeat_heads(Bc.float(), hpg, 2)  # [B,l,h,n]
        contrib = torch.einsum("blhn,blh,blhp->bhnp", Bh,
                               decay_state * dtc.float(), xc.float())
        h_state = decay_last[:, :, None, None] * h_state + contrib
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), h_state


def _head_layout(x_c, h: int, g: int):
    """How each mesh dim lays out ``x_c`` [B, ., d_in] for a scan on local
    shards: "rows" (the batch sharded), "heads" (d_in sharded by whole
    heads, each rank's heads reading whole B/C groups or lying in one),
    or None (gathered).  Returns the modes and this rank's B/C groups."""
    mesh = x_c.device_mesh
    hpg = h // g
    modes, groups = [], None
    for i, pl in enumerate(x_c.placements):
        n = mesh.size(i)
        if pl == Shard(0):
            modes.append("rows")
        elif pl == Shard(2) and h % n == 0 and (
                (h // n) % hpg == 0 or hpg % (h // n) == 0):
            hl = h // n
            a = (mesh.get_local_rank(i) * hl) // hpg
            groups = slice(a, a + max(hl // hpg, 1))
            modes.append("heads")
        else:
            modes.append(None)
    return modes, groups


def _layout(modes, kind: str, head_dim: int = 0):
    """(placements, grad placements) of one input of a local-shard scan:
    kind "act" (rows sharded, heads at ``head_dim``), "param" (a per-head
    parameter: heads at 0; its grad is partial over the row axes) or "bc"
    (the B/C groups: rows sharded, whole over the head axis, where its
    grad is partial)."""
    want, grad = [], []
    for mode in modes:
        if mode == "rows":
            pl = Replicate() if kind == "param" else Shard(0)
            want.append(pl)
            grad.append(Partial() if kind == "param" else pl)
        elif mode == "heads":
            pl = {"act": Shard(head_dim), "param": Shard(0),
                  "bc": Replicate()}[kind]
            want.append(pl)
            grad.append(Partial() if kind == "bc" else pl)
        else:
            want.append(Replicate()), grad.append(Replicate())
    return want, grad


def _ssd(x_c, dt, A, B_c, C_c, D, cfg: SSMConfig):
    """The SSD scan with the D skip: x_c [B,S,d_in] and B_c, C_c
    [B,S,g*n] (post-conv) -> (y [B,S,d_in], final state [B,h,n,p]).  On
    DTensors each rank scans its own rows and heads on its local shards
    (heads are independent; the B/C groups its heads read are taken whole,
    and their grads are partial sums over the head-sharding mesh dim; the
    grads of A and D are partial sums over the row axes).  The scan's
    products merge the batch and head dims, which DTensor cannot shard
    over two mesh dims at once, and the head split is a view whose grad
    DTensor cannot always view back."""
    def run(x_c, dt, A, B_c, C_c, D, groups=None):
        B_, S, _ = x_c.shape
        x_h = x_c.reshape(B_, S, -1, cfg.head_dim)
        Bm = B_c.reshape(B_, S, -1, cfg.state_dim)
        Cm = C_c.reshape(B_, S, -1, cfg.state_dim)
        if groups is not None:
            Bm, Cm = Bm[:, :, groups], Cm[:, :, groups]
        y, state = _ssd_chunked(x_h, dt, A, Bm, Cm, cfg.chunk_size)
        y = y + D.to(y.dtype)[None, None, :, None] * x_h
        return y.reshape(B_, S, -1), state
    if not isinstance(x_c, DTensor):
        return run(x_c, dt, A, B_c, C_c, D)
    mesh = x_c.device_mesh
    modes, groups = _head_layout(x_c, dt.shape[2], cfg.ngroups)
    xl, dtl = (local_shard(t, *_layout(modes, "act", 2)) for t in (x_c, dt))
    Al, Dl = (local_shard(t, *_layout(modes, "param")) for t in (A, D))
    Bl, Cl = (local_shard(t, *_layout(modes, "bc")) for t in (B_c, C_c))
    y, state = run(xl, dtl, Al, Bl, Cl, Dl, groups)
    return (DTensor.from_local(y, mesh, _layout(modes, "act", 2)[0]),
            DTensor.from_local(state, mesh, _layout(modes, "act", 1)[0]))


def _ssm_step(x_c, dt, A, B_c, C_c, D, h, cfg: SSMConfig):
    """One token of the SSM recurrence with the D skip: x_c [B,1,d_in],
    dt [B,h] (post-softplus), B_c, C_c [B,1,g*n], the state h [B,h,n,p]
    -> (y [B,1,d_in] in x_c's dtype, new state).  On DTensors each rank
    updates its own rows and heads on its local shards, as ``_ssd`` does
    (the products merge the batch and head dims)."""
    def run(x_c, dt, A, B_c, C_c, D, h, groups=None):
        B_ = x_c.shape[0]
        x_h = x_c.reshape(B_, -1, cfg.head_dim)
        Bm = B_c.reshape(B_, -1, cfg.state_dim)
        Cm = C_c.reshape(B_, -1, cfg.state_dim)
        if groups is not None:
            Bm, Cm = Bm[:, groups], Cm[:, groups]
        hpg = x_h.shape[1] // Bm.shape[1]
        dA = torch.exp(torch.clamp(dt * A[None], -60.0, 0.0))    # [B,h]
        Bh = _repeat_heads(Bm.float(), hpg, 1)                   # [B,h,n]
        Ch = _repeat_heads(Cm.float(), hpg, 1)
        h_new = dA[:, :, None, None] * h \
            + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, x_h.float())
        y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
        y = y + D.float()[None, :, None] * x_h.float()
        return y.reshape(B_, 1, -1).to(x_c.dtype), h_new
    if not isinstance(x_c, DTensor):
        return run(x_c, dt, A, B_c, C_c, D, h)
    mesh = x_c.device_mesh
    modes, groups = _head_layout(x_c, dt.shape[1], cfg.ngroups)
    xl = local_shard(x_c, *_layout(modes, "act", 2))
    dtl, hl = (local_shard(t, *_layout(modes, "act", 1)) for t in (dt, h))
    Al, Dl = (local_shard(t, *_layout(modes, "param")) for t in (A, D))
    Bl, Cl = (local_shard(t, *_layout(modes, "bc")) for t in (B_c, C_c))
    y, h_new = run(xl, dtl, Al, Bl, Cl, Dl, hl, groups)
    return (DTensor.from_local(y, mesh, _layout(modes, "act", 2)[0]),
            DTensor.from_local(h_new, mesh, _layout(modes, "act", 1)[0]))


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
    z, xr, Br, Cr, dt = _project(x, p)
    x_c = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"])
    B_c = _causal_conv(Br, p["conv_B_w"], p["conv_B_b"])
    C_c = _causal_conv(Cr, p["conv_C_w"], p["conv_C_b"])
    S = x.shape[1]
    dt_f = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, h_final = _ssd(x_c, dt_f, A, B_c, C_c, p["D"], cfg)
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
    z, xr, Br, Cr, dt = _project(x, p)
    x_c, conv_x = _conv_step(state["conv_x"], xr, p["conv_x_w"],
                             p["conv_x_b"])
    B_c, conv_B = _conv_step(state["conv_B"], Br, p["conv_B_w"],
                             p["conv_B_b"])
    C_c, conv_C = _conv_step(state["conv_C"], Cr, p["conv_C_w"],
                             p["conv_C_b"])
    dt_f = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B,h]
    A = -torch.exp(p["A_log"].float())
    y, h_new = _ssm_step(x_c, dt_f, A, B_c, C_c, p["D"], state["ssm"], cfg)
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
