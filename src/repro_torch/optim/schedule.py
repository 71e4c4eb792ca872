"""LR schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM).

As in the JAX package, the schedule is computed in float32: ``fn(step)``
takes a Python int or a 0-d tensor and returns a 0-d float32 tensor (on
the step's device; the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_steps: int = 0, decay_frac: float = 0.1,
                  final_lr_frac: float = 0.1):
    warmup_steps = warmup_steps or max(1, total_steps // 100)

    if kind == "cosine":
        def fn(step):
            step = _f32(step)
            warm = step / warmup_steps
            prog = torch.clamp((step - warmup_steps)
                               / max(1, total_steps - warmup_steps),
                               0.0, 1.0)
            cos = final_lr_frac + (1 - final_lr_frac) \
                * 0.5 * (1 + torch.cos(math.pi * prog))
            return base_lr * torch.where(step < warmup_steps, warm, cos)
        return fn

    if kind == "wsd":
        # MiniCPM: linear warmup, long stable plateau, short exponential-ish
        # decay over the final ``decay_frac`` of training.
        decay_start = int(total_steps * (1.0 - decay_frac))

        def fn(step):
            step = _f32(step)
            warm = step / warmup_steps
            stable = torch.ones((), device=step.device)
            prog = torch.clamp((step - decay_start)
                               / max(1, total_steps - decay_start),
                               0.0, 1.0)
            decay = torch.pow(10.0, -prog) * (1 - prog) \
                + final_lr_frac * prog
            val = torch.where(step < warmup_steps, warm,
                              torch.where(step < decay_start, stable, decay))
            return base_lr * val
        return fn

    raise ValueError(f"unknown schedule {kind!r}")
