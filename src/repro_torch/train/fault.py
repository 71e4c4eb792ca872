"""Fault tolerance + straggler mitigation for the training loop.

``TrainSupervisor`` wraps the step loop with:
  * periodic content-addressable checkpointing (sync or async);
  * automatic restart-from-checkpoint on step failure (node crash is
    simulated by exceptions — on a real cluster this is the coordinator
    restarting the job on respawned workers);
  * elastic batch resharding: on restart with a different data-parallel
    world size the same global batch is re-split (the deterministic
    pipeline regenerates the identical token stream for any shard count);
  * straggler monitoring: steps slower than ``straggler_factor`` x the
    trailing median are logged.

Checkpoints hold the JAX package's tree layout: ``params`` with every
block leaf stacked over superblocks (``models.stacked.stack``) and the
optimiser state as it is, so a checkpoint written by either package
restores in the other.  Restore copies the checkpoint's tensors into the
live parameters and optimiser state, each with its own dtype and device.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.models import stacked


class InjectedFailure(RuntimeError):
    """Simulated worker failure (tests inject via fail_at_steps)."""


class TrainSupervisor:
    def __init__(self, train_step: Callable, pipeline, checkpointer=None,
                 ckpt_every: int = 50, async_ckpt: bool = True,
                 max_restarts: int = 3, straggler_factor: float = 2.0,
                 fail_at_steps: Optional[Dict[int, int]] = None):
        self.train_step = train_step
        self.pipeline = pipeline
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.fail_at_steps = dict(fail_at_steps or {})
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.restarts = 0
        self.log: List[dict] = []

    def run(self, params, opt_state, start_step: int, num_steps: int):
        step = start_step
        while step < start_step + num_steps:
            try:
                t0 = time.perf_counter()
                if self.fail_at_steps.get(step, 0) > 0:
                    self.fail_at_steps[step] -= 1
                    raise InjectedFailure(f"simulated failure at {step}")
                batch = {k: np.asarray(v)
                         for k, v in self.pipeline.batch(step).items()}
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch, step)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self._track_time(step, dt)
                self.log.append({"step": step, "loss": loss, "time_s": dt})
                step += 1
                if self.ckpt is not None and step % self.ckpt_every == 0:
                    if self.async_ckpt:
                        self.ckpt.async_save(step, stacked.stack(params),
                                             opt_state)
                    else:
                        self.ckpt.save(step, stacked.stack(params),
                                       opt_state)
            except InjectedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if self.ckpt is None:
                    raise
                self.ckpt.wait()
                rstep, state, _ = self.ckpt.restore()
                params = stacked.copy_into(params, state["params"])
                opt_state = stacked.copy_into(opt_state, state["opt"])
                step = rstep
        if self.ckpt is not None:
            self.ckpt.wait()
        return params, opt_state

    def _track_time(self, step: int, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-20:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.straggler_factor * med:
                self.stragglers.append(step)


def elastic_reshard(pipeline, new_num_shards: int):
    """Rebuild the pipeline for a different dp world size; the token
    stream for a given global step is unchanged (determinism by step)."""
    import dataclasses
    return dataclasses.replace(pipeline, num_shards=new_num_shards,
                               shard=min(pipeline.shard,
                                         new_num_shards - 1))
