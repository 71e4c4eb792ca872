"""Training step: blocked cross-entropy + grad + optimizer update.

Memory design notes (as in the JAX package):
  * Cross-entropy is computed *blocked over the sequence* with a
    rematerialised chunk body (``torch.utils.checkpoint``), so the fp32
    [B, S, V] logits tensor is never resident when the sequence splits
    into chunks.  Each chunk computes logits -> CE -> discards; backward
    recomputes the chunk logits.
  * Optional microbatching (gradient accumulation) splits the batch and
    accumulates grads in fp32 — the standard large-scale trick when the
    per-step activation footprint exceeds device memory.  On DTensors the
    accumulators are placed as their parameters and each microbatch keeps
    the batch's data-axis sharding (``_split``).

The parameters live in the model.  ``train_step`` takes the model's
parameter tree (``models.model.param_tree``) and updates it and the
optimiser state in place, as the reference's ``donate_argnums`` step
replaces them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.utils.checkpoint import checkpoint

from repro_torch.models import stacked

CE_CHUNK = 512


class VocabParallelCE(torch.autograd.Function):
    """Cross-entropy terms ``logsumexp(logits) - logits[label]`` of logits
    sharded by vocab (the last dim) over one process group, without
    gathering them: the group's max, sum of exponentials and label logit
    (non-zero on the one rank that holds the label) are all-reduces of
    ``[B, c]`` values.  Backward: softmax minus the label's one-hot, on
    this rank's columns (the output's grad is the same on every rank of
    the group, so no collective).  On plain (local) tensors: ``logits``
    this rank's f32 ``[B, c, V / n]`` columns, ``labels`` ``[B, c]``,
    ``start`` its first column's id."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, group):
        top = logits.amax(-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        total = torch.exp(logits - top[..., None]).sum(-1)
        dist.all_reduce(total, group=group)
        lse = top + torch.log(total)
        local = labels.long() - start
        hit = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(hit, local, 0)
        picked = torch.where(
            hit, torch.gather(logits, -1, local[..., None])[..., 0], 0.0)
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(logits, lse, local, hit)
        return lse - picked

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, hit = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, local[..., None], -hit[..., None].to(d.dtype))
        return d * grad[..., None], None, None, None


def _nll(logits, labels):
    """``logsumexp(logits) - logits[label]``, ``[B, c]``.  The label's
    logit is gathered (the reference's one-hot product picks the same
    value exactly).  A DTensor's logits sharded by vocab over a mesh dim
    (a vocab-sharded head) go through ``VocabParallelCE`` and stay
    sharded; the result is sharded like the logits' other dims."""
    dims = [i for i, p in enumerate(getattr(logits, "placements", ()))
            if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    if not dims:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    (m,) = dims
    mesh = logits.device_mesh
    want = [Replicate() if i == m else p
            for i, p in enumerate(logits.placements)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    cols = logits.to_local()
    out = VocabParallelCE.apply(
        cols, labels.redistribute(mesh, want).to_local(),
        mesh.get_local_rank(m) * cols.shape[-1], mesh.get_group(m))
    return DTensor.from_local(out, mesh, want)


def _ce_chunk(x, head, labels, mask, logit_scale):
    """x: [B, c, d]; head: [d, V]; labels/mask: [B, c] -> (sum_nll, count)."""
    logits = (x @ head.to(x.dtype)).float() * logit_scale
    nll = _nll(logits, labels) * mask
    return torch.sum(nll), torch.sum(mask)


def blocked_cross_entropy(x, head, labels, mask, logit_scale=1.0,
                          chunk: int = CE_CHUNK):
    """Sequence-blocked CE.  x: [B, S, d]; labels/mask: [B, S].  Sums in
    f32; each chunk is recomputed in backward."""
    B, S, d = x.shape
    if S % chunk or S <= chunk:
        return _ce_chunk(x, head, labels, mask, logit_scale)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (x[:, sl], head, labels[:, sl], mask[:, sl], logit_scale)
        s, c = checkpoint(_ce_chunk, *args, use_reentrant=False) \
            if remat else _ce_chunk(*args)
        tot, cnt = tot + s, cnt + c
    return tot, cnt


def make_loss_fn(model, aux_weight: float = 0.01):
    """``loss_fn(batch) -> (loss, {"ce", "aux"})`` over the model's own
    parameters; ``batch`` holds tensors on the model's device."""
    cfg = model.cfg
    F = cfg.frontend_embeds

    def loss_fn(batch):
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        x, aux = model.forward(tokens, embeds, return_hidden=True)
        head = model.unembed_matrix()
        if F and embeds is not None:
            # frontend positions prepended: prediction for text token j
            # comes from hidden position F - 1 + j.
            x_pred = x[:, F - 1:-1]
            labels = tokens
        else:
            x_pred = x[:, :-1]
            labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=x.device)
        tot, cnt = blocked_cross_entropy(x_pred, head, labels, mask,
                                         cfg.logit_scale)
        ce = tot / torch.clamp(cnt, min=1.0)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def _whole(t):
    """A metric as a plain tensor: a DTensor (partial sums over the data
    axes) reduced and gathered."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors, as
    tensors on ``device``; a DTensor (a batch sharded over a mesh) stays
    as it is."""
    return {k: v if isinstance(v, DTensor) else torch.as_tensor(
        np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(
            device, non_blocking=True) for k, v in batch.items()}


def grad_tree(params, flat_grads) -> Dict:
    """``flat_grads`` (one per tensor of ``params``, in its leaf order) in
    the layout of the parameter tree ``params``."""
    it = iter(flat_grads)
    grads: Dict = {}
    for path, leaf in stacked.leaves(params):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        g = [next(it) for _ in stacked.slices(leaf)]
        node[path[-1]] = g if isinstance(leaf, list) else g[0]
    return grads


def _split(x, microbatches: int) -> list:
    """``x``'s rows as ``microbatches`` equal microbatches.  A plain tensor
    splits as the reference splits (``reshape(microbatches, B / n)``).  A
    DTensor batch splits each rank's own rows, so every microbatch keeps
    the batch's data-axis sharding: microbatch ``m`` holds the ``m``-th
    part of every rank's rows, where the reference's holds ``B / n``
    consecutive rows.  The grads and the loss are sums over all rows
    either way."""
    if not isinstance(x, DTensor):
        B = x.shape[0]
        return list(x.reshape(microbatches, B // microbatches,
                              *x.shape[1:]))
    local = x.to_local()
    b = local.shape[0]
    if b % microbatches:
        raise ValueError(f"{b} rows on this rank do not split into "
                         f"{microbatches} microbatches")
    return [DTensor.from_local(part, x.device_mesh, x.placements)
            for part in local.reshape(microbatches, b // microbatches,
                                      *local.shape[1:])]


def _zeros_like_f32(p):
    """An f32 grad accumulator for parameter ``p``: a DTensor placed as
    ``p`` when ``p`` is one."""
    if isinstance(p, DTensor):
        return dtensor_zeros(p.shape, dtype=torch.float32,
                             device_mesh=p.device_mesh,
                             placements=p.placements)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(model, optimizer, microbatches: int = 1,
                    aux_weight: float = 0.01, on_phase=None):
    """Returns train_step(params, opt_state, batch, step) ->
    (params, opt_state, metrics), ``params`` the model's parameter tree;
    both trees are updated in place and returned.  ``on_phase(name)``,
    if given, is called as each part of the step is about to be queued:
    ``"forward"`` (forward and loss) and ``"backward"`` once for each
    microbatch, ``"update"`` (grad norm and optimiser), then ``"end"``."""
    loss_fn = make_loss_fn(model, aux_weight)
    mark = on_phase or (lambda name: None)

    def grads_of(flat, batch):
        with model.sharded_scope():
            mark("forward")
            loss, metrics = loss_fn(batch)
            mark("backward")
            grads = torch.autograd.grad(loss, flat)
        # DTensor grads come back partial over the data axes: placing them
        # as their parameters is the data-parallel all-reduce
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g for g, p in zip(grads, flat)]
        return _whole(loss.detach()), {k: _whole(v.detach())
                                       for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch, step):
        batch = to_device(batch, model.device)
        paths = stacked.leaves(params)
        flat = [t for _, leaf in paths for t in stacked.slices(leaf)]
        if microbatches == 1:
            loss, metrics, gflat = grads_of(flat, batch)
        else:
            mb = {k: _split(v, microbatches) for k, v in batch.items()}
            gflat = [_zeros_like_f32(p) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for m in range(microbatches):
                lm, _, g = grads_of(flat, {k: v[m] for k, v in mb.items()})
                for acc, gi in zip(gflat, g):
                    acc.add_(gi.float())
                loss = loss + lm
            gflat = [g / microbatches for g in gflat]
            loss = loss / microbatches
            metrics = {"ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=model.device)}
        mark("update")
        gnorm = _whole(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                      for g in gflat)))
        optimizer.update(grad_tree(params, gflat), opt_state, params, step)
        mark("end")
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=optimizer.lr_fn(step))
        return params, opt_state, metrics

    return train_step
