"""The port's dry run (``launch/dryrun.py``) against the JAX package's, on
the CPU.

* ``input_specs`` gives the reference's input shapes, dtypes and
  partition specs, and ``cache_pspecs`` its cache specs, for every arch,
  every shape and both production meshes.  The reference runs in a
  subprocess with 512 host devices (its module sets
  ``xla_force_host_platform_device_count``); the port builds its
  contexts on a ``DeviceMesh`` that starts no process group.
* On smoke configs (dense llama3-8b, MoE mixtral-8x7b, SSM-hybrid
  jamba-1.5-large) at a 2 x 4 ('data', 'model') mesh and a train shape of
  8 x 128: ``memory.argument_size_in_bytes`` equals the reference's
  ``memory_analysis()`` less 4 bytes (the reference passes the step
  number as an int32 argument; the port's step is a Python int),
  ``alias_size_in_bytes`` (parameters and optimiser state) equals the
  reference's, and ``flops_scaled`` is within 2% of the reference's
  ``analyze_hlo`` (PERF.md lists each difference).  The reference's
  ``jax.make_mesh`` gives explicit axes on this JAX, which its sharding
  constraints refuse, so its subprocess builds the mesh with auto axes.
* The same smoke cells with ``--microbatches 2`` (one row a rank per
  microbatch) capture with the same arguments and products.
* The CLI runs one full-width cell (``llama3-8b train_4k single
  --device cpu``, 256 fake ranks) in a subprocess with its own time
  limit; the record has every key of the reference's and the port's
  ``roofline.analysis.format_table`` renders it.
* ``roofline.reanalyze`` rewrites a record's analyzer fields from its
  stored trace, equal to what the dry run wrote."""
import gzip
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from _torch_ranks import RANK_TIMEOUT_S, SRC
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.dryrun import input_specs
from repro_torch.launch.mesh import make_shard_ctx
from repro_torch.roofline.analysis import format_table, load_records

SMOKE = ("llama3-8b", "mixtral-8x7b", "jamba-1.5-large-398b")
SMOKE_SHAPE = (128, 8)          # seq_len, global batch
FLOPS_TOL = 0.02
# the reference's step number, an int32 argument of its train step
STEP_ARG_BYTES = 4
REC_KEYS = {"arch", "shape", "mesh", "zero1", "remat", "kind", "n_devices",
            "seq_len", "global_batch", "lower_s", "compile_s", "memory",
            "cost", "collectives", "flops_scaled", "bytes_scaled",
            "bytes_upper", "top_collectives", "top_bytes", "params",
            "active_params", "hlo_bytes"}

REFERENCE = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as d   # sets the host device count first
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCH_NAMES, get_config, get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch.mesh import make_shard_ctx
    from repro.roofline.hlo_analysis import analyze_hlo

    _make = jax.make_mesh
    jax.make_mesh = lambda shape, names, **kw: _make(
        shape, names,
        axis_types=(jax.sharding.AxisType.Auto,) * len(shape))

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]

    def tree(t, leaf):
        if isinstance(t, dict):
            return {k: tree(v, leaf) for k, v in t.items()}
        return leaf(t)

    specs = {}
    for kind in ("single", "multi"):
        ctx = make_shard_ctx(d.make_production_mesh(
            multi_pod=kind == "multi"))
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            for shape in cfg.shapes():
                s, sh = d.input_specs(cfg, shape, ctx)
                specs[f"{arch}/{shape.name}/{kind}"] = {
                    "specs": tree(s, lambda x: [list(x.shape),
                                                str(x.dtype)]),
                    "shardings": tree(sh, lambda x: spec(x.spec))}
    seq, batch = map(int, sys.argv[1:3])
    d.get_config = get_smoke_config
    d.get_shape = lambda name: ShapeSpec(name, seq, batch, "train")
    cells = {}
    for arch in sys.argv[3].split(","):
        _, _, _, lowered = d.lower_cell(arch, "train_small", "single",
                                        dp=2, tp=4)
        c = lowered.compile()
        m = c.memory_analysis()
        cells[arch] = {"argument": int(m.argument_size_in_bytes),
                       "alias": int(m.alias_size_in_bytes),
                       "flops": analyze_hlo(c.as_text())["flops"]}
    print(json.dumps({"specs": specs, "cells": cells}))
""")

PORT_CELLS = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as d

    seq, batch = map(int, sys.argv[1:3])
    base = sys.argv[4]
    d.RESULTS_DIR = f"{base}/dryrun"
    d.TRACE_DIR = f"{base}/trace"
    shape = ShapeSpec("train_small", seq, batch, "train")
    cells = {}
    for arch in sys.argv[3].split(","):
        rec = d.run_cell(arch, shape, "single", dp=2, tp=4, device="cpu",
                         cfg=get_smoke_config(arch))
        d.save(rec)
        mb = d.run_cell(arch, shape, "single", dp=2, tp=4, device="cpu",
                        cfg=get_smoke_config(arch), microbatches=2,
                        tag="mb2")
        cells[arch] = {"argument": rec["memory"]["argument_size_in_bytes"],
                       "alias": rec["memory"]["alias_size_in_bytes"],
                       "flops": rec["flops_scaled"],
                       "mb_argument":
                           mb["memory"]["argument_size_in_bytes"],
                       "mb_flops": mb["flops_scaled"]}
    print(json.dumps(cells))
""")


def _start(code, *args):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=dict(os.environ, PYTHONPATH=SRC,
                                     OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, timeout=RANK_TIMEOUT_S):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The reference's specs and compiled smoke cells, and the port's
    smoke cells, each in its own subprocess, the two at once."""
    base = tmp_path_factory.mktemp("dryrun")
    ref = _start(REFERENCE, *SMOKE_SHAPE, ",".join(SMOKE))
    port = _start(PORT_CELLS, *SMOKE_SHAPE, ",".join(SMOKE), base)
    port_out, ref_out = _wait(port), _wait(ref)
    return (json.loads(ref_out.strip().splitlines()[-1]),
            (base, json.loads(port_out.strip().splitlines()[-1])))


@pytest.fixture(scope="module")
def reference(cells):
    return cells[0]


@pytest.fixture(scope="module")
def port_cells(cells):
    return cells[1]


def _ctx(kind):
    shape = (2, 16, 16) if kind == "multi" else (16, 16)
    names = ("pod", "data", "model") if kind == "multi" \
        else ("data", "model")
    return make_shard_ctx(DeviceMesh(
        "cpu", torch.arange(int(np.prod(shape))).reshape(shape),
        mesh_dim_names=names, _init_backend=False, _rank=0))


def _tree(t, leaf):
    if isinstance(t, dict):
        return {k: _tree(v, leaf) for k, v in t.items()}
    return leaf(t)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_input_specs_equal_reference(reference, kind):
    ctx = _ctx(kind)
    n = 0
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            specs, shardings = input_specs(cfg, shape, ctx)
            got = {"specs": _tree(specs, lambda x: [
                       list(x[0]), str(x[1]).removeprefix("torch.")]),
                   "shardings": _tree(shardings, lambda s: [
                       list(e) if isinstance(e, tuple) else e for e in s])}
            key = f"{arch}/{shape.name}/{kind}"
            assert got == reference["specs"][key], key
            n += 1
    assert n == sum(len(get_config(a).shapes()) for a in ARCH_NAMES)


@pytest.mark.parametrize("arch", SMOKE)
def test_argument_bytes_equal_reference(reference, port_cells, arch):
    want = reference["cells"][arch]
    got = port_cells[1][arch]
    assert got["argument"] == want["argument"] - STEP_ARG_BYTES, (got, want)
    assert got["alias"] == want["alias"], (got, want)


@pytest.mark.parametrize("arch", SMOKE)
def test_flops_scaled_within_reference(reference, port_cells, arch):
    want = reference["cells"][arch]["flops"]
    got = port_cells[1][arch]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_TOL), (got, want)


@pytest.mark.parametrize("arch", SMOKE)
def test_microbatched_capture(port_cells, arch):
    """Two microbatches of 4 rows (one row a rank) capture on DTensors,
    with the arguments and the products of one batch of 8."""
    got = port_cells[1][arch]
    assert got["mb_argument"] == got["argument"], got
    assert got["mb_flops"] == pytest.approx(got["flops"], rel=1e-12), got


def test_reanalyze_round_trips_a_record(port_cells, tmp_path):
    from repro_torch.roofline import reanalyze
    base = tmp_path / "results"
    shutil.copytree(port_cells[0], base)
    path = base / "dryrun" / "llama3-8b__train_small__single.json"
    before = json.loads(path.read_text())
    spoiled = dict(before, flops_scaled=0.0, bytes_scaled=0.0,
                   top_bytes=[], collectives={})
    path.write_text(json.dumps(spoiled))
    reanalyze.main([str(base)])
    assert json.loads(path.read_text()) == before


CLI = textwrap.dedent("""
    import sys
    from repro_torch.launch import dryrun as d
    d.RESULTS_DIR = f"{sys.argv[1]}/dryrun"
    d.TRACE_DIR = f"{sys.argv[1]}/trace"
    sys.exit(d.main(["--arch", "llama3-8b", "--shape", "train_4k",
                     "--mesh", "single", "--device", "cpu"]))
""")


def test_cli_full_width_cell(tmp_path):
    out = _wait(_start(CLI, tmp_path), timeout=240)
    assert "[ok] llama3-8b train_4k single" in out
    recs = load_records(str(tmp_path / "dryrun"))
    rec = recs["llama3-8b__train_4k__single"]
    assert REC_KEYS <= set(rec), REC_KEYS - set(rec)
    assert rec["n_devices"] == 256 and rec["kind"] == "train"
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] < 80e9
    assert mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert rec["flops_scaled"] == rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    with gzip.open(tmp_path / "trace" /
                   "llama3-8b__train_4k__single.trace.gz", "rt") as f:
        assert len(f.read()) == rec["hlo_bytes"]
    table = format_table(recs)
    assert "llama3-8b" in table and "train_4k" in table
