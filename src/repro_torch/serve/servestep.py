"""Serving steps: batched prefill and single-token decode.

``decode_32k`` / ``long_500k`` run the decode step (one new token against
a KV cache / SSM state of ``seq_len``); ``prefill_32k`` runs the prefill
step.  Everything here runs under the model's ``serving_mode()``
(``torch.inference_mode``; ``torch.no_grad`` under a sharding context).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def _next_token(logits):
    """The greedy token of each row, ``argmax`` over the vocab.  A
    DTensor's vocab shards are gathered first and the rows keep their
    sharding (DTensor's own argmax over a sharded dim reads the shards'
    offsets back from the device, which placeholder tensors cannot
    give)."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    mesh = logits.device_mesh
    rows = [Replicate() if isinstance(p, Shard) and p.dim == logits.ndim - 1
            else p for p in logits.placements]
    local = logits.redistribute(mesh, rows).to_local()
    return DTensor.from_local(torch.argmax(local, dim=-1), mesh, rows)


def make_prefill_step(model):
    def prefill_step(tokens, embeds=None):
        with model.serving_mode():
            cache, logits = model.prefill(tokens, embeds)
            next_tok = _next_token(logits)
        return cache, logits, next_tok
    return prefill_step


def make_decode_step(model):
    def decode_step(cache, tokens, pos):
        with model.serving_mode():
            cache, logits = model.decode_step(cache, tokens, pos)
            next_tok = _next_token(logits)
        return cache, logits, next_tok
    return decode_step


def greedy_generate(model, prompt_tokens, max_new: int,
                    capacity: Optional[int] = None,
                    on_step: Optional[Callable] = None):
    """Simple batched greedy decoding driver: the one loop the serving
    CLI, its timing and its profile run.  ``torch.argmax`` takes the
    first maximum, as ``jnp.argmax`` does.  ``on_step(i, logits)``, when
    given, is called as soon as step ``i``'s work is queued (``i = 0``
    after the prefill, ``1 .. max_new - 1`` after each decode step),
    without waiting for the device: callers mark time or start a profile
    there."""
    with model.serving_mode():
        return _greedy(model, prompt_tokens, max_new, capacity, on_step)


def _greedy(model, prompt_tokens, max_new, capacity, on_step):
    B, S = prompt_tokens.shape
    capacity = capacity or model.capacity_for(S + max_new)
    cache, logits = model.prefill(prompt_tokens, capacity=capacity)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    if on_step is not None:
        on_step(0, logits)
    for i in range(max_new - 1):
        cache, logits = model.decode_step(cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
        if on_step is not None:
            on_step(i + 1, logits)
    return torch.cat(out, dim=1)
