#!/usr/bin/env python3
"""Where the LM serving path's time goes on one NVIDIA GPU.

Runs ``torch.profiler`` over one llama3-8b prefill (4 prompts of 4096
tokens) and 8 decode steps at the published widths and depth, bf16
weights from a seed, the shapes of ``chip_smoke.py`` phase 9 (a).  For
each window it prints the wall time (host clock, ending in a
synchronise), the summed device time of its kernels and their share of
the wall (the device's busy share), and the kernels with the most device
time.  Run from the root of a checkout: ``python3 tools/lm_profile.py``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S, N_DECODE, TOP = 4, 4096, 8, 12


def window(torch, model, toks, cap, n_new: int, begin: int, what: str):
    """Profile ``greedy_generate(model, toks, n_new)`` from its step
    ``begin`` (-1: before the prefill, 0: after it) to its end; the device
    is idle when the window opens."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.servestep import greedy_generate
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def on_step(i, _logits=None):
        if i == begin:
            torch.cuda.synchronize()
            prof.start()
            start.append(time.perf_counter())
    on_step(-1)
    greedy_generate(model, toks, n_new, capacity=cap, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    prof.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{what}: wall {wall * 1e3:.1f} ms, kernels {busy * 1e3:.1f} ms "
          f"on the device, busy share {busy / wall:.1%}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        t = e.self_device_time_total / 1e3
        print(f"  {t:9.2f} ms {t / 1e3 / wall:6.1%} x{e.count:<6d} "
              f"{e.key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.servestep import greedy_generate
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              param_dtype="bfloat16")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    cap = model.capacity_for(S + N_DECODE + 1)
    greedy_generate(model, toks, N_DECODE + 1, capacity=cap)   # warm-up
    window(torch, model, toks, cap, 1, -1, f"prefill B {B} x S {S}")
    window(torch, model, toks, cap, N_DECODE + 1, 0,
           f"decode, {N_DECODE} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
