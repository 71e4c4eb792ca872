"""Serving steps: batched prefill and single-token decode.

``decode_32k`` / ``long_500k`` run the decode step (one new token against
a KV cache / SSM state of ``seq_len``); ``prefill_32k`` runs the prefill
step.  Everything here runs under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def make_prefill_step(model):
    @torch.inference_mode()
    def prefill_step(tokens, embeds=None):
        cache, logits = model.prefill(tokens, embeds)
        next_tok = torch.argmax(logits, dim=-1)
        return cache, logits, next_tok
    return prefill_step


def make_decode_step(model):
    @torch.inference_mode()
    def decode_step(cache, tokens, pos):
        cache, logits = model.decode_step(cache, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1)
        return cache, logits, next_tok
    return decode_step


@torch.inference_mode()
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
