"""Continuous-batching request scheduler (serving substrate).

Production serving at decode_32k scale interleaves requests: new prompts
prefill into free cache slots while resident requests decode every step.
This implements the slot-based variant matching the model's
fixed-capacity decode caches:

  * a fixed pool of B cache slots (the decode batch keeps one shape);
  * arriving requests queue; a free slot triggers a single-sequence
    prefill whose cache rows are written into the slot;
  * every engine step decodes ALL active slots in one batched call with
    a per-slot position vector (the model's ragged decode path: per-slot
    cache writes + per-slot attention masks), the cache written in place;
  * finished requests (max-tokens or EOS) free their slot.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = dataclasses.field(default_factory=time.time)
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None


class ContinuousBatcher:
    def __init__(self, model, batch_slots: int, capacity: int,
                 eos_token: int = -1):
        self.model = model
        self.B = batch_slots
        self.capacity = capacity
        self.eos = eos_token
        self.device = model.device
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}        # slot -> request
        self.finished: List[Request] = []
        self.slot_pos = np.zeros((batch_slots,), np.int64)
        with torch.inference_mode():
            self.cache = {
                key: {name: torch.zeros(shape, dtype=dt, device=self.device)
                      for name, (shape, dt) in group.items()}
                for key, group in model.cache_shapes(batch_slots,
                                                     capacity).items()}
        self._prefill_one = lambda t: model.prefill(t, capacity=capacity)
        self._decode = model.decode_step
        self.steps = 0
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int) -> Request:
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new=max_new)
        self._next_rid += 1
        self.queue.append(req)
        return req

    @torch.inference_mode()
    def _admit(self):
        for slot in range(self.B):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.from_numpy(req.prompt).to(self.device)
            cache1, logits = self._prefill_one(prompt[None, :])
            for key, group in cache1.items():
                for name, one in group.items():
                    full = self.cache[key][name]
                    full[:, slot:slot + 1] = one.to(full.dtype)
            req.out_tokens.append(int(torch.argmax(logits, -1)[0]))
            req.first_token_s = time.time()
            self.slot_pos[slot] = len(req.prompt)
            self.active[slot] = req

    def _retire(self):
        for slot, req in list(self.active.items()):
            if len(req.out_tokens) >= req.max_new or \
                    req.out_tokens[-1] == self.eos:
                req.done_s = time.time()
                self.finished.append(req)
                del self.active[slot]

    @torch.inference_mode()
    def step(self):
        """One engine step: admit -> batched ragged decode -> retire."""
        self._admit()
        self._retire()
        if not self.active:
            return
        toks = np.zeros((self.B, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out_tokens[-1]
        pos_vec = torch.from_numpy(self.slot_pos).to(self.device)   # [B]
        self.cache, logits = self._decode(
            self.cache, torch.from_numpy(toks).to(self.device), pos_vec)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for slot, req in self.active.items():
            req.out_tokens.append(int(nxt[slot]))
            self.slot_pos[slot] += 1
        self.steps += 1
        self._retire()

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            self.step()
        return self.finished

    def stats(self) -> dict:
        done = [r for r in self.finished]
        return {
            "steps": self.steps,
            "finished": len(done),
            "queued": len(self.queue),
            "active": len(self.active),
            "mean_ttft_s": float(np.mean(
                [r.first_token_s - r.submitted_s for r in done]))
            if done else 0.0,
        }
