"""The port's distributed slice against the JAX package's
``tests/test_distributed.py`` contracts, on the CPU.

* A 4x2 ('data', 'model') DTensor train step of 8 ``gloo`` processes on
  llama3-8b's smoke config, from the reference's weights
  (``params_from_reference``) and batch, held against the reference's
  single-device jitted step: loss within 1e-4 and every parameter within
  3e-3 (the reference test's own bounds; the loss also against the
  single-process port step), the grad norm within 1e-4 relative and
  every grad within 1e-4 of its leaf's largest.  Then the sharded AdamW
  on the reference's grads, from the same weights: every parameter
  within one ulp plus 1e-4 of the reference update's largest, and the
  state (sharded a dim further in, past the superblock dim) within 1e-6
  of each leaf's largest.  A missing or sign-flipped update is about
  lr = 8.9e-4 per element, well outside that bound.  The step is step 3
  of the cosine schedule: at step 0 its warm-up gives lr 0.
* ``make_production_mesh`` at 256 and 512 ranks on the ``fake`` process
  group in one process: the reference's mesh shapes and dp axes.

Multi-process runs go through ``_torch_ranks.run_ranks``: a ``file://``
store in the test's own directory (no port to race for), each rank a
subprocess with its own time limit."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from _torch_ranks import RANK_TIMEOUT_S, SRC, run_ranks
from repro.configs import get_smoke_config
from repro.models.model import build_model
from repro.optim import make_optimizer, make_schedule
from repro.train.trainstep import make_loss_fn, make_train_step

STEP = 3

STEP_WORKER = textwrap.dedent("""
    import json, math, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models import stacked
    from repro_torch.models.model import (build_model, param_tree,
                                          params_from_reference)
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.trainstep import make_train_step
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, store, data, step = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4],
                                      int(sys.argv[5]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    ctx = make_shard_ctx(mesh)
    cfg = get_smoke_config("llama3-8b")

    def load(name):
        tree = {}
        for key, a in np.load(f"{data}/{name}.npz").items():
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(a)
        return tree

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def optimizer():
        return make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))

    class Recorder:
        def __init__(self, opt):
            self.opt, self.lr_fn = opt, opt.lr_fn

        def update(self, grads, state, params, step):
            self.grads = stacked.stack(grads)
            return self.opt.update(grads, state, params, step)

    def worst(got, want, scale):
        return max(float((whole(a) - stacked.get(want, k)).abs().max())
                   / scale(stacked.get(want, k))
                   for k, a in stacked.leaves(got))

    def largest(t):
        return max(float(t.abs().max()), 1e-30)

    weights = load("weights")
    tokens = torch.from_numpy(np.load(f"{data}/tokens.npy"))
    res = {}
    for name, c in (("single", None), ("sharded", ctx)):
        model = params_from_reference(
            build_model(cfg, device="cpu", ctx=c), weights)
        rec = Recorder(optimizer())
        params = param_tree(model)
        state = rec.opt.init(params)
        batch = {"tokens": tokens if c is None else distribute_tensor(
            tokens, mesh, [Shard(0), Replicate()])}
        _, _, met = make_train_step(model, rec)(params, state, batch, step)
        res[name] = {k: float(v) for k, v in met.items()}
    assert all(isinstance(t, DTensor) for t in model.parameters())
    param_err = worst(stacked.stack(params), load("stepped"), lambda w: 1.0)
    grad_err = worst(rec.grads, load("grads"), largest)
    # the sharded AdamW on the reference's grads, from the same weights
    stacked.copy_into(params, weights)
    opt = optimizer()
    state = opt.init(params)
    assert all(isinstance(t, DTensor) for _, t in stacked.leaves(state["mu"]))
    opt.update(stacked.like(params, load("grads")), state, params, step)
    updated = load("updated")
    scale = max(float((a - stacked.get(weights, k)).abs().max())
                for k, a in stacked.leaves(updated))
    update_err = 0.0
    for k, a in stacked.leaves(stacked.stack(params)):
        got, want = whole(a), stacked.get(updated, k)
        top = torch.maximum(got.abs(), want.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        excess = ((got - want).abs() - ulp).clamp(min=0)
        update_err = max(update_err, float(excess.max()) / scale)
    state_err = max(worst(state[k], load(k), largest) for k in ("mu", "nu"))
    print(json.dumps(dict(res, param_err=param_err, grad_err=grad_err,
                          update_err=update_err, state_err=state_err)))
    dist.destroy_process_group()
""")


def _save(path, tree):
    np.savez(path, **{"/".join(k.key for k in kp): np.asarray(a)
                      for kp, a in jax.tree_util.tree_flatten_with_path(
                          tree)[0]})


def test_sharded_train_step_runs_small_mesh(tmp_path):
    """A real sharded train step (4x2 mesh) runs and matches the
    single-device step numerically; the sharded update on shared grads
    equals the reference's."""
    cfg = get_smoke_config("llama3-8b")
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))
    state = opt.init(params)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 64)).astype(np.int32)
    batch, step = {"tokens": jnp.asarray(tokens)}, jnp.int32(STEP)
    stepped, _, m = jax.jit(make_train_step(ref, opt))(params, state, batch,
                                                       step)
    _, grads = jax.jit(jax.value_and_grad(make_loss_fn(ref), has_aux=True))(
        params, batch)
    updated, ustate = jax.jit(opt.update)(grads, state, params, step)
    np.save(tmp_path / "tokens.npy", tokens)
    for name, tree in (("weights", params), ("stepped", stepped),
                       ("grads", grads), ("updated", updated),
                       ("mu", ustate["mu"]), ("nu", ustate["nu"])):
        _save(tmp_path / f"{name}.npz", tree)
    want = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
    assert want["lr"] > 0
    for out in run_ranks(STEP_WORKER, 8, tmp_path, tmp_path, STEP):
        r = json.loads(out.strip().splitlines()[-1])
        got = r["sharded"]
        assert abs(got["loss"] - want["loss"]) < 1e-4, (r, want)
        assert abs(got["loss"] - r["single"]["loss"]) < 1e-4, r
        assert abs(got["grad_norm"] - want["grad_norm"]) \
            <= 1e-4 * want["grad_norm"], (r, want)
        assert r["param_err"] <= 3e-3, r
        assert r["grad_err"] <= 1e-4, r
        assert r["update_err"] <= 1e-4, r
        assert r["state_err"] <= 1e-6, r


MESH_CODE = textwrap.dedent("""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh,
                                         make_shard_ctx)

    def shape(m):
        return dict(zip(m.mesh_dim_names, m.shape))

    dist.init_process_group("fake", rank=0, world_size=256,
                            store=FakeStore())
    m1 = make_production_mesh(device_type="cpu")
    assert shape(m1) == {"data": 16, "model": 16}, shape(m1)
    ctx = make_shard_ctx(m1)
    assert ctx.dp_axes == ("data",) and ctx.model_size == 16
    assert shape(make_host_mesh("cpu")) == {"data": 256, "model": 1}
    dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=512,
                            store=FakeStore())
    m2 = make_production_mesh(multi_pod=True, device_type="cpu")
    assert shape(m2) == {"pod": 2, "data": 16, "model": 16}, shape(m2)
    ctx = make_shard_ctx(m2)
    assert ctx.dp_axes == ("pod", "data") and ctx.model_size == 16
    dist.destroy_process_group()
    print("MESH_OK")
""")


def test_production_mesh_shapes():
    """The reference's production meshes at 256 and 512 ranks, in one
    process on the ``fake`` process group; the module itself touches no
    process-group state when imported."""
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh\n"
            "assert not dist.is_initialized()\n" + MESH_CODE)
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH_OK" in out.stdout
