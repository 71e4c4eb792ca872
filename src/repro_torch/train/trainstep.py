"""Training step: blocked cross-entropy + grad + optimizer update.

Memory design notes (as in the JAX package):
  * Cross-entropy is computed *blocked over the sequence* with a
    rematerialised chunk body (``torch.utils.checkpoint``), so the fp32
    [B, S, V] logits tensor is never resident when the sequence splits
    into chunks.  Each chunk computes logits -> CE -> discards; backward
    recomputes the chunk logits.
  * Optional microbatching (gradient accumulation) splits the batch and
    accumulates grads in fp32 — the standard large-scale trick when the
    per-step activation footprint exceeds device memory.

The parameters live in the model.  ``train_step`` takes the model's
parameter tree (``models.model.param_tree``) and updates it and the
optimiser state in place, as the reference's ``donate_argnums`` step
replaces them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import stacked

CE_CHUNK = 512


def _ce_chunk(x, head, labels, mask, logit_scale):
    """x: [B, c, d]; head: [d, V]; labels/mask: [B, c] -> (sum_nll, count).
    The label's logit is gathered (the reference's one-hot product picks
    the same value exactly)."""
    logits = (x @ head.to(x.dtype)).float() * logit_scale
    lse = torch.logsumexp(logits, dim=-1)                     # [B, c]
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - picked) * mask
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


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors, as
    tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, non_blocking=True)
        for k, v in batch.items()}


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
        mark("forward")
        loss, metrics = loss_fn(batch)
        mark("backward")
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch, step):
        batch = to_device(batch, model.device)
        paths = stacked.leaves(params)
        flat = [t for _, leaf in paths for t in stacked.slices(leaf)]
        if microbatches == 1:
            loss, metrics, gflat = grads_of(flat, batch)
        else:
            def split(x):
                B = x.shape[0]
                return x.reshape(microbatches, B // microbatches,
                                 *x.shape[1:])
            mb = {k: split(v) for k, v in batch.items()}
            gflat = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in flat]
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
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in gflat))
        optimizer.update(grad_tree(params, gflat), opt_state, params, step)
        mark("end")
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=optimizer.lr_fn(step))
        return params, opt_state, metrics

    return train_step
