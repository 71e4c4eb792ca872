"""End-to-end training driver.

Examples:
  # ~65M-param llama3-family model, 200 steps, CA-checkpointing every 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --preset 100m --steps 200 --batch 8 --seq 256

  # tiny smoke for any assigned arch, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --preset smoke --steps 20 --device cpu

The driver wires every substrate together: config -> model -> optimizer ->
deterministic data pipeline -> train step -> TrainSupervisor (fault
tolerance + stragglers) -> content-addressable checkpointing with
hashing offloaded to the card (the paper's technique).

Runs on the card (``--device cuda``, the default) unless asked for the
CPU; without a card the default raises.  Weights are random, drawn from
``--seed``.  Each step is timed with CUDA events on the card (what the
device reaches, host gaps included) and with the host clock on the CPU,
beside the CPU time of the thread that issues it; the summary leaves out
the first ``WARMUP_STEPS`` steps.  ``--ckpt-every 0`` trains without
checkpoints.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.core import CrystalGPU, SAI, SAIConfig, make_store
from repro_torch.data import make_pipeline
from repro_torch.launch.presets import preset_config  # noqa: F401
from repro_torch.launch.serve import _Clock
from repro_torch.models.model import build_model, param_tree, resolve_device
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train.checkpoint import CACheckpointer
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.trainstep import make_train_step

# steps left out of the step-time summary
WARMUP_STEPS = 2


def timed(step_fn, dev: torch.device):
    """``step_fn`` wrapped to mark each call's start and end (CUDA events
    on the card, the host clock on the CPU), the CPU seconds this thread
    spends in it, and its metrics.  Returns (wrapper, record)."""
    rec = {"clock": _Clock(dev), "cpu_s": [], "metrics": []}

    def wrapper(params, opt_state, batch, step):
        rec["clock"].mark()
        c0 = time.thread_time()
        out = step_fn(params, opt_state, batch, step)
        rec["cpu_s"].append(time.thread_time() - c0)
        rec["clock"].mark()
        rec["metrics"].append(out[2])
        return out
    return wrapper, rec


def main(argv=None):
    """Run the CLI; returns what a caller goes on with: the model, its
    parameter tree and optimiser state, the supervisor, the checkpointer
    and store (None without checkpoints), each step's seconds, the
    issuing thread's CPU seconds per step, each step's loss and
    grad_norm, and the wall time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", default="100m",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N steps (0: no checkpoints)")
    ap.add_argument("--ckpt-chunking", default="cdc-gear",
                    choices=["fixed", "cdc", "cdc-gear"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject one failure at this step (fault demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = build_model(cfg, device=dev)
    print(f"arch={cfg.name} preset={args.preset} "
          f"params={cfg.param_count()/1e6:.1f}M")

    model.init(torch.Generator(dev).manual_seed(args.seed))
    params = param_tree(model)
    lr_fn = make_schedule(cfg.lr_schedule, args.lr, args.steps)
    opt = make_optimizer(cfg.optimizer, lr_fn)
    opt_state = opt.init(params)

    pipeline = make_pipeline(cfg, args.seq, args.batch, seed=args.seed)
    step_fn, rec = timed(make_train_step(model, opt,
                                         microbatches=args.microbatches), dev)

    # content-addressable checkpoint store (the paper's technique)
    mgr = crystal = ckpt = None
    if args.ckpt_every > 0:
        mgr, _ = make_store(n_nodes=4, replication=2)
        crystal = CrystalGPU(devices=None if dev.type == "cuda" else [dev])
        sai = SAI(mgr, SAIConfig(ca=args.ckpt_chunking, avg_chunk=256 << 10,
                                 min_chunk=64 << 10, max_chunk=1 << 20,
                                 hasher="gpu"), crystal)
        ckpt = CACheckpointer(sai)

    fail = {args.fail_at: 1} if args.fail_at >= 0 else None
    sup = TrainSupervisor(step_fn, pipeline, ckpt,
                          ckpt_every=max(args.ckpt_every, 1),
                          fail_at_steps=fail)
    t0 = time.time()
    try:
        params, opt_state = sup.run(params, opt_state, 0, args.steps)
    finally:
        if crystal is not None:
            crystal.shutdown()
    wall = time.time() - t0

    losses = [r["loss"] for r in sup.log]
    print(f"steps={len(sup.log)} wall={wall:.1f}s "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f}")
    print(f"restarts={sup.restarts} stragglers={len(sup.stragglers)}")
    tok_s = args.batch * args.seq * len(sup.log) / wall
    print(f"throughput={tok_s:.0f} tok/s ({dev.type})")
    if ckpt is not None:
        for r in ckpt.history:
            print(f"  ckpt step={r['step']:4d} "
                  f"total={r['total_bytes']/1e6:.1f}MB "
                  f"new={r['new_bytes']/1e6:.1f}MB "
                  f"dedup={100*r['dedup_ratio']:.1f}% "
                  f"wall={r['wall_s']:.2f}s")
        print("store:", json.dumps(mgr.stats()))

    step_s = rec["clock"].intervals()[::2]
    cpu_s = rec["cpu_s"]
    grad_norms = [float(m["grad_norm"]) for m in rec["metrics"]]
    timed_s, timed_cpu = step_s[WARMUP_STEPS:], cpu_s[WARMUP_STEPS:]
    if timed_s:
        clock = "CUDA events" if dev.type == "cuda" else "host clock"
        print(f"train steps: median {statistics.median(timed_s)*1e3:.3f} ms, "
              f"min {min(timed_s)*1e3:.3f}, max {max(timed_s)*1e3:.3f} over "
              f"{len(timed_s)} steps after {WARMUP_STEPS} warm-up steps "
              f"({clock}); this thread's CPU "
              f"{sum(timed_cpu) / len(timed_cpu) * 1e3:.3f} ms per step, "
              f"{sum(timed_cpu) / sum(timed_s):.0%} of their time")
    assert losses[-1] < losses[0], "loss must decrease"
    return {"cfg": cfg, "model": model, "params": params,
            "opt_state": opt_state, "supervisor": sup, "checkpointer": ckpt,
            "store": mgr, "step_s": step_s, "host_cpu_s": cpu_s,
            "losses": [float(m["loss"]) for m in rec["metrics"]],
            "grad_norms": grad_norms, "wall_s": wall}


if __name__ == "__main__":
    main()
