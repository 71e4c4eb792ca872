#!/usr/bin/env python3
"""Where the training step's time goes on one NVIDIA GPU.

Builds minicpm-2b at its published widths and depth as ``chip_smoke.py``
phase 10 (a) trains it (f32 master weights, bf16 compute, AdamW, the WSD
schedule, remat of every superblock, batch 4 x 2048 from the data
pipeline, seed 0) and, after 2 warm-up steps, times 3 steps of
``train.trainstep.make_train_step`` part by part with CUDA events that
its ``on_phase`` hook records: the forward and loss, the backward (with
the superblocks' recompute), and the grad norm with the optimiser's
update.  Then it runs one more step under ``torch.profiler``: wall time (host clock, ending in a
synchronise), the device time of its kernels and their share of the wall
(the device's busy share), launches, the kernels with the most device
time, and the host-side ops and autograd nodes whose kernels took the
most (a ``CopySlices`` node is an in-place op recorded under grad).  Run
from the root of a checkout:
``python3 tools/train_profile.py``.  Needs one card; without one it
exits with code 2.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH, B, S, WARMUP, TIMED, TOP = "minicpm-2b", 4, 2048, 2, 3, 15
NAMES = {"forward": "forward and loss",
         "backward": "backward (with the recompute)",
         "update": "grad norm and optimizer update"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from lm_profile import print_ops
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.trainstep import make_train_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))
    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer, make_schedule(
        cfg.lr_schedule, 3e-4, WARMUP + TIMED + 1))
    state = opt.init(params)
    pipeline = make_pipeline(cfg, S, B, seed=0)
    marks = []

    def on_phase(name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    train_step = make_train_step(model, opt, on_phase=on_phase)

    def step(i: int):
        """One train step; ms of each part, by the name of its mark."""
        marks.clear()
        train_step(params, state, pipeline.batch(i), i)
        marks[-1][1].synchronize()
        parts = dict.fromkeys(NAMES, 0.0)
        for (name, a), (_, b) in zip(marks, marks[1:]):
            parts[name] += a.elapsed_time(b)
        return parts

    for i in range(WARMUP):
        step(i)
    parts = [step(WARMUP + i) for i in range(TIMED)]
    total = [sum(p.values()) for p in parts]
    print(f"{ARCH} B {B} x S {S}, {TIMED} steps after {WARMUP} warm-up "
          f"(CUDA events): step median {statistics.median(total):.1f} ms")
    for key, name in NAMES.items():
        ms = statistics.median(p[key] for p in parts)
        print(f"  {name}: {ms:.1f} ms ({ms / statistics.median(total):.1%})")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    step(WARMUP + TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profiled step: wall {wall * 1e3:.1f} ms, kernels "
          f"{busy * 1e3:.1f} ms on the device, busy share {busy / wall:.1%},"
          f" {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        t = e.self_device_time_total / 1e3
        print(f"  {t:9.2f} ms {t / 1e3 / wall:6.1%} x{e.count:<6d} "
              f"{e.key[:100]}")
    print_ops(torch, prof, wall, TOP)
    return 0


if __name__ == "__main__":
    sys.exit(main())
