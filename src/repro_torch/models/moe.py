"""Mixture-of-Experts layer (GShard-style capacity dispatch).

Design notes (the JAX package's ``models/moe.py``, carried over):
  * Tokens are processed in *groups* (contiguous spans of the sequence).
    Dispatch/combine are one-hot einsums, so every step is a dense
    product and the expert choice matches the reference's exactly.
  * Dispatch FLOPs per token are 2 * group_size * top_k * capacity_factor
    * d_model, independent of the expert count.
  * Capacity overflow drops tokens (the residual passes through): a token
    whose position in its expert is >= C gets an all-zero capacity
    one-hot row, as ``jax.nn.one_hot`` gives for an index out of range.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import mlp
from repro_torch.models.sharding import local_shard

# tokens per dispatch group; small groups bound the one-hot dispatch cost.
GROUP_SIZE = 512


def moe_param_shapes(d: int, cfg: MoEConfig, mlp_type: str) -> dict:
    f = cfg.d_ff_expert
    n_mats = {"w1": (cfg.num_experts, d, f), "w2": (cfg.num_experts, f, d)}
    if mlp_type == "swiglu":
        n_mats["w3"] = (cfg.num_experts, d, f)
    shapes = {"router": (d, cfg.num_experts), **n_mats}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        shapes["shared_w1"] = (d, fs)
        shapes["shared_w2"] = (fs, d)
        if mlp_type == "swiglu":
            shapes["shared_w3"] = (d, fs)
    return shapes


def _capacity(group: int, cfg: MoEConfig) -> int:
    cap = int(group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    cap = max(cap, cfg.top_k)
    return min(cap, group)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros
    (``F.one_hot`` raises instead)."""
    inside = (idx >= 0) & (idx < n)
    oh = F.one_hot(torch.where(inside, idx, 0), n)
    return (oh * inside[..., None]).to(dtype)


def route(xg: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router probabilities [..., E] in f32, and the top-k gates
    (renormalised) and expert indices [..., k] of each token.  As
    ``jax.lax.top_k``: sorted, ties to the lower index (a stable sort
    keeps equal values in index order; ``torch.topk`` does not promise
    that)."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[..., :top_k]
    expert_idx = expert_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _expert_ffn(disp, comb, xg, w1, w3, w2, mlp_type: str):
    """Dispatch, the experts' FFN and combine on plain tensors."""
    xe = torch.einsum("sgec,sgd->secd", disp, xg)           # [G, E, C, d]
    if mlp_type == "swiglu":
        h = F.silu(torch.einsum("secd,edf->secf", xe, w1)) \
            * torch.einsum("secd,edf->secf", xe, w3)
    else:
        h = F.gelu(torch.einsum("secd,edf->secf", xe, w1),
                   approximate="tanh")
    ye = torch.einsum("secf,efd->secd", h, w2)              # [G, E, C, d]
    return torch.einsum("sgec,secd->sgd", comb, ye)         # [G, g, d]


def _experts(disp, comb, xg, p, dtype, mlp_type: str):
    """The experts' output [G, g, d].  On DTensors each rank runs its own
    groups' tokens through its own experts (expert-sharded weights) or its
    own share of every expert's hidden dim (FFN-sharded), on local shards,
    and the outputs are partial sums over the model axis (the dispatch's
    products merge the group and expert dims, which DTensor cannot shard
    over two mesh dims at once).  The tokens and the routing are whole on
    each rank of that axis, so their grads are partial sums there too; the
    weights' grads are partial sums over the axes that shard the rows."""
    ws = [p[n].to(dtype) if n in ("w1", "w2") or mlp_type == "swiglu"
          else None for n in ("w1", "w3", "w2")]
    if not isinstance(xg, DTensor):
        return _expert_ffn(disp, comb, xg, *ws, mlp_type)
    mesh = xg.device_mesh
    w1 = ws[0]
    want, grad, experts = [], [], None
    for i, pl in enumerate(w1.placements):
        if pl == Shard(0):                    # experts over this mesh dim
            n, r = mesh.size(i), mesh.get_local_rank(i)
            el = -(-w1.shape[0] // n)
            experts = (r * el, min((r + 1) * el, w1.shape[0]))
        if isinstance(pl, Shard):             # a model-axis dim
            want.append(Replicate()), grad.append(Partial())
        else:
            want.append(xg.placements[i] if xg.placements[i] == Shard(0)
                        else Replicate())
            grad.append(want[-1])
    dl, cl, xl = (local_shard(t, want, grad) for t in (disp, comb, xg))
    if experts is not None:
        dl, cl = (t[:, :, experts[0]:experts[1]] for t in (dl, cl))
    # each rank's weight grads come from its own rows: partial over the
    # mesh dims that shard the rows
    rows = [isinstance(g, Shard) for g in grad]
    local = [None if w is None else local_shard(w, w.placements, [
        Partial() if r else pl for r, pl in zip(rows, w.placements)])
        for w in ws]
    y = _expert_ffn(dl, cl, xl, *local, mlp_type)
    return DTensor.from_local(y, mesh, [
        Partial() if isinstance(pl, Shard) else w
        for pl, w in zip(w1.placements, want)])


def moe_mlp(x: torch.Tensor, p, cfg: MoEConfig, mlp_type: str) -> tuple:
    """x: [B, S, d] -> ([B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    dtype = x.dtype
    group = min(GROUP_SIZE, S)
    assert S % group == 0, (S, group)
    G = B * (S // group)
    xg = x.reshape(G, group, d)

    probs, gate_vals, expert_idx = route(xg, p["router"], cfg.top_k)

    E = cfg.num_experts
    C = _capacity(group, cfg)

    # position-in-expert via cumulative sum over the k one-hots in sequence
    onehot = _one_hot(expert_idx, E, torch.int32)           # [G, g, k, E]
    flat = onehot.reshape(G, group * cfg.top_k, E)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat        # [G, g*k, E]
    pos_in_expert = torch.sum(pos_in_expert * flat, dim=-1)  # [G, g*k]
    pos_in_expert = pos_in_expert.reshape(G, group, cfg.top_k)
    keep = pos_in_expert < C

    # dispatch tensor [G, g, E, C]
    cap_onehot = _one_hot(pos_in_expert, C, dtype)          # [G,g,k,C]
    kept = onehot.to(dtype) * keep[..., None].to(dtype)
    disp = torch.einsum("sgke,sgkc->sgec", kept, cap_onehot)
    comb = torch.einsum("sgk,sgke,sgkc->sgec", gate_vals.to(dtype), kept,
                        cap_onehot)

    # load-balancing auxiliary loss (Switch-style), before the experts so
    # that a checkpointed block's recompute can stop after them (the
    # combine's output is needed by no grad)
    density = torch.mean(onehot[..., 0, :].float(), dim=1)  # [G, E]
    density_prob = torch.mean(probs, dim=1)                 # [G, E]
    aux = torch.mean(torch.sum(density * density_prob, dim=-1)) * E

    y = _experts(disp, comb, xg, p, dtype, mlp_type)       # [G, g, d]
    y = y.reshape(B, S, d)

    if cfg.num_shared_experts:
        sh = {"w1": p["shared_w1"], "w2": p["shared_w2"]}
        if mlp_type == "swiglu":
            sh["w3"] = p["shared_w3"]
        y = y + mlp(x, sh, mlp_type)
    return y, aux
