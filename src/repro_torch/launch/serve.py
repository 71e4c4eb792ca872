"""Batched serving driver: prefill a batch of prompts, decode new tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --preset full --batch 4 --prompt-len 4096 --new-tokens 33 \
      --param-dtype bfloat16

Runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``); without a card the default raises.  Weights are
random, drawn from ``--seed``.  The timed run is one ``greedy_generate``
after a warm-up of the same shapes; the card's times come from CUDA
events on its stream, the CPU's from the host clock.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.launch.presets import preset_config
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serve.servestep import greedy_generate

# decode steps of the warm-up run, so that no first-call cost of a decode
# shape falls inside the timed run
WARMUP_STEPS = 4


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Clock:
    """Time marks: CUDA events on the current stream of a card (what the
    device reaches, host gaps included), else the host clock."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self, *_):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals(self) -> list:
        """Seconds between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def serve(model, prompts, new_tokens: int) -> dict:
    """Greedy-generate ``new_tokens`` tokens for ``prompts`` after a
    warm-up run (one prefill and ``WARMUP_STEPS`` decode steps at the same
    capacity).  The prefill ends before decode starts, as in the
    reference's timing.  Returns the tokens, the last logits, the
    prefill's seconds, each decode step's seconds and the CPU seconds this
    thread spent issuing the decode steps."""
    B, S = prompts.shape
    dev = prompts.device
    capacity = model.capacity_for(S + new_tokens)
    greedy_generate(model, prompts, min(new_tokens, WARMUP_STEPS + 1),
                    capacity=capacity)
    _sync(dev)
    clock, last, cpu = _Clock(dev), {}, []

    def on_step(i, logits):
        clock.mark()
        last["logits"] = logits
        if i == 0:
            _sync(dev)
        cpu.append(time.thread_time())
    clock.mark()
    toks = greedy_generate(model, prompts, new_tokens, capacity=capacity,
                           on_step=on_step)
    times = clock.intervals()
    return {"tokens": toks, "logits": last["logits"], "prefill_s": times[0],
            "step_s": times[1:], "host_cpu_s": cpu[-1] - cpu[0]}


def report(cfg, prompts, res: dict):
    """The reference's lines, then the decode steps' median and spread."""
    B, S = prompts.shape
    new = res["tokens"].shape[1]
    t_prefill, steps = res["prefill_s"], res["step_s"]
    t_decode = sum(steps)
    print(f"arch={cfg.name} batch={B} prompt={S} new={new}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({B*(new-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("sample continuation:", res["tokens"][0, :16].tolist())
    if steps:
        clock = "CUDA events" if prompts.device.type == "cuda" \
            else "host clock"
        print(f"decode steps: median {statistics.median(steps)*1e3:.3f} "
              f"ms, min {min(steps)*1e3:.3f}, max {max(steps)*1e3:.3f} "
              f"over {len(steps)} steps after {WARMUP_STEPS} warm-up "
              f"steps ({clock}); this thread's CPU "
              f"{res['host_cpu_s'] / len(steps) * 1e3:.3f} ms per step, "
              f"{res['host_cpu_s'] / t_decode:.0%} of their time")


def main(argv=None):
    """Run the CLI; returns the model and ``serve``'s result for a caller
    that goes on with them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", default="100m",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16", "float16"],
                    help="parameter dtype (default: the config's own)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    res = serve(model, prompts, args.new_tokens)
    report(cfg, prompts, res)
    return model, res


if __name__ == "__main__":
    main()
