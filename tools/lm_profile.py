#!/usr/bin/env python3
"""Where the LM serving path's time goes on one NVIDIA GPU.

Runs ``torch.profiler`` over one llama3-8b prefill (4 prompts of 4096
tokens) and 8 decode steps at the published widths and depth, bf16
weights from a seed, the shapes of ``chip_smoke.py`` phase 9 (a).  For
each window it prints the wall time (host clock, ending in a
synchronise), the summed device time of its kernels and their share of
the wall (the device's busy share), the kernels with the most device
time, and the host-side ops whose kernels took the most.  Last it times
``decode_attention`` alone at the decode step's shapes with the
tensor-core products and with the f32 products forced, in turns.  Run
from the root of a checkout: ``python3 tools/lm_profile.py``.
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
    print_ops(torch, prof, wall)


def print_ops(torch, prof, wall: float, top: int = TOP):
    """The host-side ops and autograd nodes (``evaluate_function: ...``)
    whose kernels took the most device time, children included: which
    op launched the kernels above (``aten::bmm`` for a score product)."""
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.device_time_total > 0 and (
               e.key.startswith("aten::")
               or e.key.startswith("autograd::engine::evaluate_function"))]
    print("  ops by device time of their kernels (children included):")
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        t = e.device_time_total / 1e3
        print(f"  {t:9.2f} ms {t / 1e3 / wall:6.1%} x{e.count:<6d} "
              f"{e.key[:100]}")


def decode_attention_ab(torch, dev, C: int, calls: int = 200):
    """``decode_attention`` alone at the decode step's shapes (B 4, 32/8
    heads of 128, a bf16 cache of C slots), with the tensor-core products
    (the cache read in place) and with the f32 products forced, in turns:
    the issuing thread's ms per call (host clock, no synchronise inside),
    the ms per call between CUDA events around the calls, and the device
    time of its kernels per call (``torch.profiler`` over 20 calls)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers
    g = torch.Generator(dev).manual_seed(2)
    q = torch.randn((4, 1, 32, 128), generator=g, device=dev).bfloat16()
    kc, vc = (torch.randn((4, C, 8, 128), generator=g, device=dev)
              .bfloat16() for _ in range(2))
    slots, cur = torch.arange(C, device=dev), torch.tensor(C - 1)
    real = layers._tensor_core_scores
    for name, use in (("tensor cores", real), ("f32 products", None),
                      ("f32 products", None), ("tensor cores", real)):
        layers._tensor_core_scores = use or (lambda a, b: False)
        try:
            with torch.inference_mode():
                for _ in range(5):
                    layers.decode_attention(q, kc, vc, slots, cur)
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t0 = time.perf_counter()
                ev[0].record()
                for _ in range(calls):
                    layers.decode_attention(q, kc, vc, slots, cur)
                ev[1].record()
                host = (time.perf_counter() - t0) / calls
                ev[1].synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        layers.decode_attention(q, kc, vc, slots, cur)
                    torch.cuda.synchronize()
        finally:
            layers._tensor_core_scores = real
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     ) / 1e3 / 20
        between = ev[0].elapsed_time(ev[1]) / calls
        print(f"decode_attention, {name}, cache {C} slots: issue "
              f"{host * 1e3:.3f} ms a call, {between:.3f} ms a call "
              f"between events, kernels {dev_ms:.3f} ms a call")


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
    decode_attention_ab(torch, dev, cap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
