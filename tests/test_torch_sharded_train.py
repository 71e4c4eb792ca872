"""Microbatching and Adafactor under a sharding context against the JAX
package, on the CPU: 8 ``gloo`` processes on a 4x2 ('data', 'model')
mesh, llama3-8b's smoke config, the reference's weights
(``params_from_reference``) and batch (8 x 64), step 3 of the cosine
schedule (at step 0 its warm-up gives lr 0).

* A DTensor step with ``microbatches=2``: the accumulators are DTensors
  placed as their parameters, each microbatch keeps the batch's
  data-axis sharding (each rank splits its own rows; the reference splits
  consecutive rows, and the grads are sums over all rows either way).
  Held against the reference's jitted microbatched step by the bounds of
  ``test_torch_distributed``: loss within 1e-4, grad norm within 1e-4
  relative, every parameter within 3e-3.
* Adafactor on the reference's grads, from the same weights: its
  ``v_row`` / ``v_col`` are DTensors placed by ``state_spec_like`` on the
  stacked leaves, and the update runs on them; every parameter within
  one ulp plus 1e-4 of the reference update's largest, the state within
  1e-6 of each leaf's largest.

One launch of 8 ranks serves both tests."""
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro.configs import get_smoke_config
from repro.models.model import build_model
from repro.optim import make_optimizer, make_schedule
from repro.train.trainstep import make_loss_fn, make_train_step

STEP = 3

WORKER = textwrap.dedent("""
    import json, math, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models import stacked
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.models.sharding import placements
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.trainstep import make_train_step

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

    def largest(t):
        return max(float(t.abs().max()), 1e-30)

    def worst(got, want, scale):
        return max(float((whole(a) - stacked.get(want, k)).abs().max())
                   / scale(stacked.get(want, k))
                   for k, a in stacked.leaves(got))

    weights = load("weights")
    model = build_model(cfg, device="cpu", ctx=ctx)
    params = param_tree(model)
    stacked.copy_into(params, weights)
    tokens = torch.from_numpy(np.load(f"{data}/tokens.npy"))
    batch = {"tokens": distribute_tensor(tokens, mesh,
                                         [Shard(0), Replicate()])}
    opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))
    _, _, met = make_train_step(model, opt, microbatches=2)(
        params, opt.init(params), batch, step)
    res = {"mb": {k: float(v) for k, v in met.items()},
           "mb_param_err": worst(stacked.stack(params), load("mb_stepped"),
                                 lambda w: 1.0)}

    # Adafactor on the reference's grads, from the same weights
    stacked.copy_into(params, weights)
    opt = make_optimizer("adafactor", make_schedule("cosine", 1e-3, 10))
    state = opt.init(params)
    specs = opt.state_spec_like(model.param_pspecs())
    placed = all(isinstance(t, DTensor) and tuple(t.placements) ==
                 placements(stacked.get(specs[k], path), mesh)
                 for k in state for path, t in stacked.leaves(state[k]))
    opt.update(stacked.like(params, load("grads")), state, params, step)
    updated = load("af_updated")
    scale = max(float((a - stacked.get(weights, k)).abs().max())
                for k, a in stacked.leaves(updated))
    err = 0.0
    for k, a in stacked.leaves(stacked.stack(params)):
        got, want = whole(a), stacked.get(updated, k)
        top = torch.maximum(got.abs(), want.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        err = max(err, float(((got - want).abs() - ulp).clamp(min=0).max())
                  / scale)
    res.update(af_placed=placed, af_update_err=err,
               af_state_err=max(worst(state[k], load(f"af_{k}"), largest)
                                for k in ("v_row", "v_col")))
    print(json.dumps(res))
    dist.destroy_process_group()
""")


def _save(path, tree):
    np.savez(path, **{"/".join(k.key for k in kp): np.asarray(a)
                      for kp, a in jax.tree_util.tree_flatten_with_path(
                          tree)[0]})


@pytest.fixture(scope="module")
def sharded_train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    cfg = get_smoke_config("llama3-8b")
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 64)).astype(np.int32)
    batch, step = {"tokens": jnp.asarray(tokens)}, jnp.int32(STEP)
    adamw = make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))
    stepped, _, m = jax.jit(make_train_step(ref, adamw, microbatches=2))(
        params, adamw.init(params), batch, step)
    _, grads = jax.jit(jax.value_and_grad(make_loss_fn(ref), has_aux=True))(
        params, batch)
    af = make_optimizer("adafactor", make_schedule("cosine", 1e-3, 10))
    updated, st = jax.jit(af.update)(grads, af.init(params), params, step)
    np.save(tmp / "tokens.npy", tokens)
    for name, tree in (("weights", params), ("mb_stepped", stepped),
                       ("grads", grads), ("af_updated", updated),
                       ("af_v_row", st["v_row"]), ("af_v_col", st["v_col"])):
        _save(tmp / f"{name}.npz", tree)
    want = {k: float(m[k]) for k in ("loss", "grad_norm")}
    outs = run_ranks(WORKER, 8, tmp, tmp, STEP)
    return want, [json.loads(o.strip().splitlines()[-1]) for o in outs]


def test_microbatched_sharded_step_equals_reference(sharded_train):
    want, results = sharded_train
    for r in results:
        got = r["mb"]
        assert abs(got["loss"] - want["loss"]) < 1e-4, (r, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) \
            <= 1e-4 * want["grad_norm"], (r, want)
        assert r["mb_param_err"] <= 3e-3, r


def test_sharded_adafactor_equals_reference(sharded_train):
    _, results = sharded_train
    for r in results:
        assert r["af_placed"], r
        assert r["af_update_err"] <= 1e-4, r
        assert r["af_state_err"] <= 1e-6, r
