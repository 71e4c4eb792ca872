"""The port's fault supervisor: the JAX package's supervised-restart and
elastic-reshard tests (``tests/test_checkpoint.py``) by name and
assertion, restore into live tensors with their own dtype and device,
and supervisor checkpoints that restore across the two packages both
ways: one package's run writes a durable content-addressable store, the
other's checkpointer reopens it and its restore path copies the state
into its own model and optimiser, equal tensor for tensor."""
import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.configs import get_smoke_config as ref_smoke
from repro.data import make_pipeline as ref_pipeline
from repro.models.model import build_model as ref_build
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import make_schedule as ref_make_schedule
from repro.train.checkpoint import CACheckpointer as RefCheckpointer
from repro.train.fault import TrainSupervisor as RefSupervisor
from repro.train.fault import _cast_like as ref_cast_like
from repro.train.trainstep import make_train_step as ref_make_train_step
import repro_torch.core as core
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_pipeline
from repro_torch.models.model import (build_model, param_tree,
                                      params_from_reference,
                                      params_to_reference)
from repro_torch.models import stacked
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train.checkpoint import CACheckpointer
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.trainstep import make_train_step

# the JAX package's checkpoint test chunk sizes; hashing on the host
CHUNKS = dict(avg_chunk=16 << 10, min_chunk=4 << 10, max_chunk=64 << 10)


def _ckpt(ca="cdc-gear"):
    mgr, _ = core.make_store(3, replication=2)
    sai = core.SAI(mgr, core.SAIConfig(ca=ca, hasher="cpu", **CHUNKS))
    return CACheckpointer(sai), mgr


def _port_run(cfg):
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = param_tree(model)
    opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 40))
    return model, params, opt, opt.init(params)


def test_supervisor_restart_recovers_training():
    """Inject a failure; the supervisor restores from the checkpoint and
    the run completes with decreasing loss."""
    cfg = get_smoke_config("llama3-8b")
    model, params, opt, opt_state = _port_run(cfg)
    pipeline = make_pipeline(cfg, 64, 4)
    step_fn = make_train_step(model, opt)
    ckpt, _ = _ckpt()
    sup = TrainSupervisor(step_fn, pipeline, ckpt, ckpt_every=5,
                          async_ckpt=False, fail_at_steps={12: 1})
    params, opt_state = sup.run(params, opt_state, 0, 20)
    assert sup.restarts == 1
    steps = [r["step"] for r in sup.log]
    # failure at 12 -> restore to checkpoint at 10 -> steps 10/11 re-run
    assert steps.count(10) == 2 and steps.count(11) == 2
    assert steps.count(12) == 1 and steps[-1] == 19
    losses = [r["loss"] for r in sup.log]
    assert losses[-1] < losses[0]
    # the re-run of step 10 starts from the checkpoint: the same loss
    at10 = [r["loss"] for r in sup.log if r["step"] == 10]
    assert at10[0] == at10[1]


def test_elastic_reshard_same_stream():
    from repro_torch.train.fault import elastic_reshard
    cfg = get_smoke_config("llama3-8b")
    p4 = make_pipeline(cfg, 64, 8, num_shards=1)
    b_full = p4.batch(5)["tokens"]
    p2 = elastic_reshard(p4, 2)
    b0 = p2.batch(5)["tokens"]
    assert b0.shape[0] == 4
    np.testing.assert_array_equal(b_full[:4], b0)


def test_copy_into_writes_live_tensors():
    """Restore (``stacked.copy_into``) writes into the template's own tensors, cast to their
    dtypes: f32 values into bf16 parameters, stacked values into the
    per-superblock slices, numpy's bfloat16 included."""
    cfg = get_smoke_config("llama3-8b")
    model = build_model(cfg, device="cpu")
    model.to(torch.bfloat16)
    tree = param_tree(model)
    ptrs = [t.data_ptr() for _, leaf in stacked.leaves(tree)
            for t in stacked.slices(leaf)]
    rng = np.random.default_rng(0)
    values = stacked.map_leaves(lambda leaf: torch.from_numpy(
        rng.standard_normal(stacked.ref_shape(leaf)).astype(np.float32)),
        tree)
    out = stacked.copy_into(tree, values)
    assert out is tree
    assert ptrs == [t.data_ptr() for _, leaf in stacked.leaves(tree)
                    for t in stacked.slices(leaf)]
    for path, leaf in stacked.leaves(stacked.stack(tree)):
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf, stacked.get(values, path).bfloat16())
    ref_np = params_to_reference(model)            # ml_dtypes bfloat16
    model.init(torch.Generator().manual_seed(3))
    stacked.copy_into(tree, ref_np)
    for path, leaf in stacked.leaves(stacked.stack(tree)):
        assert torch.equal(leaf, stacked.get(values, path).bfloat16())
    with pytest.raises(ValueError):
        stacked.copy_into(tree, {**values, "embed": values["embed"][:1]})


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------
STEPS, EVERY = 6, 3


def _durable(pkg, tmp_path):
    mgr, _, _ = pkg.open_durable_store(str(tmp_path), n_nodes=3,
                                       replication=2, flush_interval_s=0)
    if pkg is core:
        sai = core.SAI(mgr, core.SAIConfig(ca="cdc-gear", hasher="cpu",
                                           **CHUNKS))
        return CACheckpointer(sai), mgr
    sai = ref_core.SAI(mgr, ref_core.SAIConfig(ca="cdc-gear", hasher="cpu",
                                               **CHUNKS))
    return RefCheckpointer(sai), mgr


def _close(ckpt, mgr):
    ckpt.sai.close()
    mgr.close()


def test_reference_checkpoint_restores_in_port(tmp_path):
    arch = "llama3-8b"
    ref = ref_build(ref_smoke(arch))
    params = ref.init(jax.random.PRNGKey(0))
    opt = ref_make_optimizer("adamw", ref_make_schedule("cosine", 1e-3, 40))
    opt_state = opt.init(params)
    ckpt, mgr = _durable(ref_core, tmp_path)
    sup = RefSupervisor(jax.jit(ref_make_train_step(ref, opt)),
                        ref_pipeline(ref_smoke(arch), 64, 4), ckpt,
                        ckpt_every=EVERY, async_ckpt=False)
    params, opt_state = sup.run(params, opt_state, 0, STEPS)
    _close(ckpt, mgr)

    model, tree, popt, pstate = _port_run(get_smoke_config(arch))
    ckpt, mgr = _durable(core, tmp_path)
    step, state, _ = ckpt.restore()
    assert step == STEPS
    stacked.copy_into(tree, state["params"])
    stacked.copy_into(pstate, state["opt"])
    for got_tree, want_tree in ((stacked.stack(tree), params),
                                (pstate, opt_state)):
        for path, got in stacked.leaves(got_tree):
            want = np.asarray(stacked.get(want_tree, path))
            assert got.numpy().tobytes() == want.tobytes(), path
    _close(ckpt, mgr)


def test_port_checkpoint_restores_in_reference(tmp_path):
    arch = "llama3-8b"
    cfg = get_smoke_config(arch)
    model, tree, opt, opt_state = _port_run(cfg)
    ckpt, mgr = _durable(core, tmp_path)
    sup = TrainSupervisor(make_train_step(model, opt),
                          make_pipeline(cfg, 64, 4), ckpt,
                          ckpt_every=EVERY, async_ckpt=False)
    tree, opt_state = sup.run(tree, opt_state, 0, STEPS)
    _close(ckpt, mgr)

    ref = ref_build(ref_smoke(arch))
    template = ref.init(jax.random.PRNGKey(1))
    ropt = ref_make_optimizer("adamw", ref_make_schedule("cosine", 1e-3, 40))
    ckpt, mgr = _durable(ref_core, tmp_path)
    step, state, _ = ckpt.restore()
    assert step == STEPS
    r_params = ref_cast_like(template, state["params"])
    r_opt = ref_cast_like(ropt.init(template), state["opt"])
    for want_tree, got_tree in ((stacked.stack(tree), r_params),
                                (opt_state, r_opt)):
        for path, want in stacked.leaves(want_tree):
            got = np.asarray(stacked.get(got_tree, path))
            assert got.tobytes() == want.numpy().tobytes(), path
    # and the reference's model computes with the port's weights
    port_ref = params_from_reference(build_model(cfg, device="cpu"),
                                     jax.tree.map(np.asarray, r_params))
    for (_, a), (_, b) in zip(stacked.leaves(stacked.stack(tree)),
                              stacked.leaves(param_tree(port_ref))):
        assert torch.equal(a, torch.stack(b) if isinstance(b, list) else b)
    _close(ckpt, mgr)
