"""Multi-pod dry-run driver.

For every (architecture x input shape) cell this builds the step (train /
prefill / decode) against the production mesh — 16x16 single-pod and
2x16x16 multi-pod — with placeholder ranks and tensors (no device
allocation), runs it once under a capture, and records:

  * the memory of one rank (``Compiled.memory_analysis()``: local bytes of
    the arguments, the outputs, what is updated in place, and the peak
    of ``torch.distributed._tools.mem_tracker.MemTracker`` past the
    arguments) — proves it fits
  * the cost of one rank (``compat.cost_analysis``: FLOPs from
    ``FlopCounterMode``)
  * FLOPs, memory bytes and collective wire bytes from the op trace
    (``roofline.hlo_analysis``), every run of every op counted

The ranks are the ``fake`` process group at world size 256 or 512
(``launch.mesh.make_production_mesh``); parameters, optimiser state,
inputs and the serving cache are DTensors of fake tensors
(``FakeTensorMode``) holding each rank's own shard only.  So the step
runs rank 0's share of the work, with the collectives DTensor issues, and
allocates nothing.  A JAX dry run compiles; this one executes, eagerly,
on fake tensors.

Results are written to ``results/torch/dryrun/<arch>__<shape>__<mesh>.json``
(the JAX package's record keys, which ``roofline.analysis.load_records`` /
``format_table`` read), beside the trace in
``results/torch/trace/<stem>.trace.gz`` so ``roofline.reanalyze`` can
re-derive the analyzer's fields without running the step again.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell

The step runs on CUDA placeholder tensors (``--device cuda``, the
default), so it takes the card's code paths; without a card that raises,
and ``--device cpu`` takes the CPU's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import empty as dtensor_empty
from torch.utils._pytree import tree_leaves

from repro_torch import compat
from repro_torch.configs import ARCH_NAMES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import make_production_mesh, make_shard_ctx
from repro_torch.models.model import build_model, param_tree, resolve_device
from repro_torch.models.sharding import P, placements, zero1_spec
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.roofline.hlo_analysis import (Captured, OpTrace, analyze_hlo,
                                               in_sharding_propagation,
                                               sharding_propagation)
from repro_torch.serve.servestep import make_decode_step, make_prefill_step
from repro_torch.train.trainstep import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")
TRACE_DIR = os.path.join(RESULTS_DIR, "..", "trace")


def _dp(ctx):
    return ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]


def input_specs(cfg: ArchConfig, shape: ShapeSpec, ctx):
    """(specs, shardings) of every model input, as the JAX package gives
    them: ``specs`` maps each input to (shape, dtype) — the cache to the
    tree of ``LMModel.cache_shapes`` — and ``shardings`` to its partition
    spec ``P``."""
    B, S = shape.global_batch, shape.seq_len
    dp = _dp(ctx)
    batch_spec = P(dp, None) if B > 1 else P(None, None)
    if shape.kind in ("train", "prefill"):
        F = cfg.frontend_embeds
        specs = {"tokens": ((B, S - F), torch.int32)}
        shardings = {"tokens": batch_spec}
        if F:
            specs["embeds"] = ((B, F, cfg.d_model), torch.bfloat16)
            shardings["embeds"] = P(dp, None, None) if B > 1 \
                else P(None, None, None)
        return specs, shardings
    # decode: one token against a cache of S
    model = build_model(cfg, device="meta", ctx=ctx)
    return ({"tokens": ((B, 1), torch.int32),
             "cache": model.cache_shapes(B, S)},
            {"tokens": batch_spec, "cache": model.cache_pspecs(B)})


def _fake_world(size: int):
    """A ``fake`` process group of ``size`` placeholder ranks, this
    process rank 0 (one already there of that size is kept)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs the fake process group; "
                               "another one is initialised")
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())


def _make_mesh(mesh_kind: str, dp: int, tp: int, device_type: str):
    if dp and tp:
        # axis-rebalance variant: same names, another split
        shape = (2, dp, tp) if mesh_kind == "multi" else (dp, tp)
        names = ("pod", "data", "model") if mesh_kind == "multi" \
            else ("data", "model")
        _fake_world(int(torch.tensor(shape).prod()))
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    _fake_world(512 if mesh_kind == "multi" else 256)
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device_type)


def _placeholder(shape, dtype, spec, mesh):
    """A DTensor of ``shape`` placed by ``spec``, its shard uninitialised
    (under ``FakeTensorMode``: nothing allocated)."""
    return dtensor_empty(*shape, dtype=dtype, device_mesh=mesh,
                         placements=placements(spec, mesh))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``, each tensor
    counted once."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        if isinstance(t, DTensor):
            t = t._local_tensor
        total += t.numel() * t.element_size()
    return total


class _MemTracker(MemTracker):
    """``MemTracker`` that leaves out DTensor's sharding propagation, which
    under the dry run's own fake mode it would count at global shapes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if in_sharding_propagation() and not any(
                issubclass(t, DTensor) for t in types):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


@dataclasses.dataclass
class MemoryStats:
    """Per-rank bytes, named as XLA's ``memory_analysis()`` names them."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int
    # the eager port generates no code for a step
    generated_code_size_in_bytes: int = 0


class Compiled:
    """One captured run of a step: ``memory_analysis()``,
    ``cost_analysis()`` and ``as_text()`` (the op trace), as the JAX
    package's compiled object offers them."""

    def __init__(self, trace: str, flops: int, memory: MemoryStats):
        self._trace, self._flops, self._memory = trace, flops, memory

    def memory_analysis(self) -> MemoryStats:
        return self._memory

    def cost_analysis(self) -> dict:
        return Captured(self._trace, self._flops).cost_analysis()

    def as_text(self) -> str:
        return self._trace


class Lowered:
    """A step with its placeholder arguments; ``compile()`` runs it once
    under the capture and the memory tracker.  The step's arguments as
    the JAX package counts them include the parameters, which the port's
    serving steps hold in the model."""

    def __init__(self, fake_mode, step_fn, args, aliased, model, state):
        self.fake_mode, self.step_fn, self.args = fake_mode, step_fn, args
        self.aliased, self.model, self.state = aliased, model, state

    def compile(self) -> Compiled:
        arg_b = _local_bytes((param_tree(self.model), self.args))
        with self.fake_mode:
            mt = _MemTracker()
            mt.track_external(self.model, *[
                t for t in tree_leaves((self.state, self.args))
                if isinstance(t, torch.Tensor)])
            rec = OpTrace()
            with sharding_propagation(), mt, rec:
                out = self.step_fn(*self.args)
            peak = mt.get_tracker_snapshot("peak")
        peak_b = max((v.get("Total", 0) for v in peak.values()), default=0)
        mem = MemoryStats(
            argument_size_in_bytes=arg_b,
            output_size_in_bytes=_local_bytes(out),
            alias_size_in_bytes=_local_bytes(self.aliased),
            temp_size_in_bytes=max(int(peak_b) - arg_b, 0))
        return Compiled(rec.text(), rec.flops, mem)


def lower_cell(arch: str, shape_name, mesh_kind: str,
               zero1: bool = False, remat: str = "nothing_saveable",
               dp: int = 0, tp: int = 0, uneven: bool = False,
               score_dtype: str = "float32", microbatches: int = 1,
               device: str = "cuda", cfg: Optional[ArchConfig] = None):
    """Build the cell's model, optimiser state and inputs as placeholders
    on the mesh; returns (cfg, shape, mesh, Lowered).  ``shape_name`` is a
    shape's name or a ``ShapeSpec``; ``cfg`` replaces ``arch``'s config
    (a config cut to size)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else get_shape(shape_name)
    mesh = _make_mesh(mesh_kind, dp, tp, dev.type)
    ctx = make_shard_ctx(mesh)
    if uneven:
        ctx = dataclasses.replace(ctx, uneven=True)
    specs, shardings = input_specs(cfg, shape, ctx)
    fake = FakeTensorMode()
    with fake:
        model = build_model(cfg, score_dtype, dev, remat, ctx=ctx)
        inputs = {k: _placeholder(*specs[k], shardings[k], mesh)
                  for k in specs if k != "cache"}
        state = None
        if shape.kind == "train":
            lr_fn = make_schedule(cfg.lr_schedule, 3e-4, 10000)
            opt = make_optimizer(cfg.optimizer, lr_fn)
            params = param_tree(model)
            state = opt.init(params)
            if zero1:
                state = _zero1(state, opt, model, ctx)
            step_fn = make_train_step(model, opt, microbatches=microbatches)
            args = (params, state, inputs, 0)
            aliased = (params, state)
        elif shape.kind == "prefill":
            step_fn = make_prefill_step(model)
            args = (inputs["tokens"],) + ((inputs["embeds"],)
                                          if "embeds" in inputs else ())
            aliased = ()
        else:
            cache = {key: {name: _placeholder(
                shp, dt, shardings["cache"][key][name], mesh)
                for name, (shp, dt) in layer.items()}
                for key, layer in specs["cache"].items()}
            pos = torch.zeros((), dtype=torch.int32, device=dev)
            step_fn = make_decode_step(model)
            args = (cache, inputs["tokens"], pos)
            aliased = cache
    return cfg, shape, mesh, Lowered(fake, step_fn, args, aliased, model,
                                     state)


def _zero1(state, opt, model, ctx):
    """``state`` redistributed by ``zero1_spec``: each leaf's first free
    divisible dim sharded over the data axes as well."""
    dp_size = 1
    for a in ctx.dp_axes:
        dp_size *= ctx.mesh.size(ctx.mesh.mesh_dim_names.index(a))
    ospec = opt.state_spec_like(model.param_pspecs())
    specs = {tuple(k.key for k in kp): s for kp, s in
             compat.tree_flatten_with_path(
                 ospec, is_leaf=lambda x: isinstance(x, P))[0]}

    def place(kp, t):
        spec = zero1_spec(specs[tuple(k.key for k in kp)], tuple(t.shape),
                          ctx.dp_axes, dp_size)
        return t.redistribute(ctx.mesh, placements(spec, ctx.mesh))
    return compat.tree_map_with_path(place, state)


def run_cell(arch: str, shape_name, mesh_kind: str,
             zero1: bool = False, remat: str = "nothing_saveable",
             tag: str = "", dp: int = 0, tp: int = 0, uneven: bool = False,
             score_dtype: str = "float32", microbatches: int = 1,
             device: str = "cuda", cfg: Optional[ArchConfig] = None) -> dict:
    t0 = time.time()
    cfg, shape, mesh, lowered = lower_cell(
        arch, shape_name, mesh_kind, zero1=zero1, remat=remat, dp=dp, tp=tp,
        uneven=uneven, score_dtype=score_dtype, microbatches=microbatches,
        device=device, cfg=cfg)
    t_lower = time.time() - t0
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0

    mem = compiled.memory_analysis()
    mem_d = {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes")}
    cost = compat.cost_analysis(compiled)
    cost_d = {k: float(v) for k, v in cost.items()
              if isinstance(v, (int, float)) and k in
              ("flops", "bytes accessed", "transcendentals",
               "optimal_seconds")}
    trace = compiled.as_text()
    an = analyze_hlo(trace)
    coll = {"wire_bytes": an["wire_bytes"], "op_counts": an["op_counts"],
            "total_wire_bytes": an["total_wire_bytes"]}
    rec = dict(
        arch=arch, shape=shape.name, mesh=mesh_kind, zero1=zero1,
        remat=remat, kind=shape.kind, n_devices=int(mesh.size()),
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
        memory=mem_d, cost=cost_d, collectives=coll,
        flops_scaled=an["flops"], bytes_scaled=an["bytes_accessed"],
        bytes_upper=an["bytes_upper"],
        top_collectives=an["top_collectives"], top_bytes=an["top_bytes"],
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        hlo_bytes=len(trace),
    )
    # keep the trace so analyzer improvements can re-derive terms without
    # running the step again
    os.makedirs(TRACE_DIR, exist_ok=True)
    with gzip.open(os.path.join(TRACE_DIR, _stem(rec, tag) + ".trace.gz"),
                   "wt") as f:
        f.write(trace)
    return rec


def _stem(rec: dict, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}"


def save(rec: dict, tag: str = ""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, _stem(rec, tag) + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def all_cells():
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            for mesh_kind in ("single", "multi"):
                yield arch, shape.name, mesh_kind


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--remat", default="nothing_saveable")
    ap.add_argument("--tag", default="")
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--uneven-heads", action="store_true")
    ap.add_argument("--score-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the placeholder tensors' device type (cuda or "
                         "cpu); nothing is allocated on it")
    args = ap.parse_args(argv)

    cells = list(all_cells()) if args.all else \
        [(args.arch, args.shape, args.mesh)]
    failures = 0
    for arch, shape, mesh_kind in cells:
        suffix = f"__{args.tag}" if args.tag else ""
        out = os.path.join(RESULTS_DIR,
                           f"{arch}__{shape}__{mesh_kind}{suffix}.json")
        if args.skip_existing and os.path.exists(out):
            print(f"[skip] {arch} {shape} {mesh_kind}")
            continue
        try:
            rec = run_cell(arch, shape, mesh_kind, zero1=args.zero1,
                           remat=args.remat, tag=args.tag, dp=args.dp,
                           tp=args.tp, uneven=args.uneven_heads,
                           score_dtype=args.score_dtype,
                           microbatches=args.microbatches,
                           device=args.device)
            path = save(rec, args.tag)
            print(f"[ok] {arch} {shape} {mesh_kind} "
                  f"compile={rec['compile_s']}s "
                  f"flops={rec['cost'].get('flops')} -> {path}", flush=True)
        except Exception:
            failures += 1
            print(f"[FAIL] {arch} {shape} {mesh_kind}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
