"""The port's optimisers and schedules: the JAX package's
``tests/test_optim.py`` by name and assertion, and parity with the JAX
package — schedules within one f32 ulp at every step, AdamW and Adafactor
updates on shared grads within 1e-6 of each leaf's largest value, on a
smoke config with several superblocks, where the rules act on the
reference's stacked leaves (a decayed ``[n_super, d]`` norm scale,
Adafactor's factored norm scales with column means across superblocks
and its RMS clip over the whole leaf)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import (build_model, param_tree,
                                      params_from_reference)
from repro_torch.models import stacked
from repro_torch.optim import (Adafactor, AdamW, make_optimizer,
                               make_schedule)

# shared-grad updates agree within this share of each leaf's largest value
UPDATE_TOL = 1e-6


def _converges(opt, steps=200):
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), dtype=torch.float32)}
    state = opt.init(params)

    def loss(p):
        return torch.mean(torch.square(p["w"] - target))

    l0 = float(loss(params))
    for i in range(steps):
        w = params["w"].detach().requires_grad_(True)
        g, = torch.autograd.grad(loss({"w": w}), [w])
        opt.update({"w": g}, state, params, i)
    return l0, float(loss(params))


def test_adamw_converges():
    l0, l1 = _converges(AdamW(lambda s: 0.05, weight_decay=0.0))
    assert l1 < 0.01 * l0


def test_adafactor_converges():
    # Adafactor's update is RMS-normalized, so a constant lr plateaus at
    # lr-scale error; use the standard relative decaying step.
    lr = lambda s: 0.5 / torch.sqrt(torch.as_tensor(s, dtype=torch.float32)
                                    + 1.0)
    l0, l1 = _converges(Adafactor(lr), steps=600)
    assert l1 < 0.05 * l0


def test_adafactor_state_is_factored():
    opt = Adafactor(lambda s: 1e-3)
    params = {"w": torch.zeros((64, 128)), "b": torch.zeros((64,))}
    st = opt.init(params)
    assert st["v_row"]["w"].shape == (64,)
    assert st["v_col"]["w"].shape == (128,)
    assert st["v_row"]["b"].shape == (64,)
    # memory: factored state is tiny vs AdamW's 2x params
    adam_bytes = 2 * 64 * 128 * 4
    fact_bytes = (64 + 128) * 4
    assert fact_bytes < adam_bytes / 50


def test_wsd_schedule_shape():
    fn = make_schedule("wsd", 1.0, 1000, warmup_steps=100)
    assert float(fn(0)) == 0.0
    assert float(fn(50)) == pytest.approx(0.5)
    assert float(fn(500)) == pytest.approx(1.0)      # stable plateau
    assert float(fn(950)) < 0.5                      # decay phase
    assert float(fn(999)) <= 0.2


def test_cosine_schedule_shape():
    fn = make_schedule("cosine", 1.0, 1000, warmup_steps=10)
    assert float(fn(10)) == pytest.approx(1.0, abs=1e-2)
    assert float(fn(999)) == pytest.approx(0.1, abs=2e-2)


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 units in the last place (same-sign values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("kind,base_lr,total,warmup,decay_frac,final", [
    ("cosine", 3e-4, 200, 0, 0.1, 0.1),
    ("cosine", 1.0, 1000, 10, 0.1, 0.1),
    ("wsd", 3e-4, 200, 0, 0.1, 0.1),
    ("wsd", 1e-2, 1000, 100, 0.2, 0.05),
])
def test_schedules_equal_reference_within_one_ulp(kind, base_lr, total,
                                                  warmup, decay_frac, final):
    """Every step 0..total+4 within one f32 ulp of the reference.  The
    one exception is f32 cos itself: XLA's and torch's may round
    cos(pi * prog) one ulp apart (they do at 16 of 300 steps of the
    second case), and 1 + cos cancels near the schedule's end, so there
    the allowance is one ulp plus that cos difference carried through
    the formula; where the two cos agree, one ulp."""
    ref = ref_optim.make_schedule(kind, base_lr, total, warmup, decay_frac,
                                  final)
    port = make_schedule(kind, base_lr, total, warmup, decay_frac, final)
    steps = np.arange(total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([float(port(int(s))) for s in steps], dtype=np.float32)
    # a 0-d tensor step gives the same values as an int
    got_t = np.array([float(port(torch.tensor(s))) for s in steps[::37]],
                     dtype=np.float32)
    np.testing.assert_array_equal(got_t, got[::37])
    assert port(3).dtype == torch.float32
    allowed = np.spacing(np.abs(want)).astype(np.float64)
    if kind == "cosine":
        w = warmup or max(1, total // 100)
        prog = torch.clamp((torch.from_numpy(steps).float() - w)
                           / max(1, total - w), 0.0, 1.0)
        arg = math.pi * prog
        c_port = torch.cos(arg).numpy()
        c_ref = np.asarray(jnp.cos(jnp.asarray(arg.numpy())))
        assert int(_ulps(c_port, c_ref).max()) <= 1
        allowed += base_lr * (1 - final) * 0.5 * np.abs(
            c_port.astype(np.float64) - c_ref) * (1 + 2.0 ** -20)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= allowed), np.max(err / allowed)


def _stacked_case():
    """llama3-8b's smoke config (4 superblocks): the reference's params,
    the port's model over the same weights and its parameter tree."""
    cfg = get_smoke_config("llama3-8b")
    ref = ref_build(ref_smoke("llama3-8b"))
    params = ref.init(jax.random.PRNGKey(0))
    tree_np = jax.tree.map(np.asarray, params)
    model = params_from_reference(build_model(cfg, device="cpu"), tree_np)
    assert model.n_super == 4
    return params, tree_np, param_tree(model)



def _regroup(tree, values):
    out = {}
    for path, leaf in stacked.leaves(tree):
        arr = torch.from_numpy(np.array(stacked.get(values, path)))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = list(arr) if isinstance(leaf, list) else arr
    return out


def _assert_close_by_leaf(port_tree, ref_tree, what):
    for path, got in stacked.leaves(port_tree):
        want = np.asarray(stacked.get(ref_tree, path))
        got = got.numpy()
        assert got.shape == want.shape, (what, path)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= UPDATE_TOL * scale, (what, path, err / scale)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_equals_reference_on_shared_grads(name):
    """Four updates fed the same numpy grads: parameters and state equal
    the reference's within 1e-6 of each leaf's largest value.  The first
    superblock's norm1 grads are zero, so AdamW moves that stacked norm
    scale by its weight decay alone, and the unstacked final norm (rank 1)
    keeps zero grads and is not decayed; Adafactor's state for a stacked
    [n_super, d] norm is factored, its column accumulator across
    superblocks."""
    params, tree_np, tree = _stacked_case()
    sched = dict(kind="cosine", base_lr=1e-2, total_steps=100,
                 warmup_steps=2)
    ro = ref_optim.make_optimizer(name, ref_optim.make_schedule(**sched))
    po = make_optimizer(name, make_schedule(**sched))
    rs, ps = ro.init(params), po.init(tree)
    upd = jax.jit(ro.update)
    rng = np.random.default_rng(3)
    for step in range(4):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01)
                         .astype(np.float32), tree_np)
        g["blocks"]["pos0"]["norm1"][0] = 0.0
        g["final_norm"][:] = 0.0
        params, rs = upd(jax.tree.map(jnp.asarray, g), rs, params,
                         jnp.asarray(step, jnp.int32))
        po.update(_regroup(tree, g), ps, tree, step)
    _assert_close_by_leaf(stacked.stack(tree), params, "params")
    for key in rs:
        _assert_close_by_leaf(ps[key], rs[key], key)
    norm0 = tree["blocks"]["pos0"]["norm1"][0].detach()
    if name == "adamw":
        assert not torch.equal(norm0, torch.ones_like(norm0))   # decayed
        assert torch.equal(tree["final_norm"].detach(),
                           torch.ones_like(norm0))             # rank 1
    else:
        d = norm0.shape[0]
        assert ps["v_row"]["blocks"]["pos0"]["norm1"].shape == (4,)
        assert ps["v_col"]["blocks"]["pos0"]["norm1"].shape == (d,)
        assert ps["v_col"]["final_norm"].shape == (1,)


def test_update_is_in_place_and_state_is_stacked_f32():
    _, _, tree = _stacked_case()
    opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))
    st = opt.init(tree)
    wq = tree["blocks"]["pos0"]["attn"]["wq"]
    assert st["mu"]["blocks"]["pos0"]["attn"]["wq"].shape == \
        (4, *wq[0].shape)
    assert all(leaf.dtype == torch.float32
               for _, leaf in stacked.leaves(st["nu"]))
    before = [t.data_ptr() for t in wq]
    grads = stacked.map_leaves(
        lambda leaf: [torch.ones_like(t) for t in leaf]
        if isinstance(leaf, list) else torch.ones_like(leaf), tree)
    out, st2 = opt.update(grads, st, tree, 1)
    assert out is tree and st2 is st
    assert [t.data_ptr() for t in wq] == before
    assert float(st["mu"]["embed"].abs().max()) > 0.0


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        make_optimizer("sgd", lambda s: 1e-3)
    with pytest.raises(ValueError):
        make_schedule("linear", 1.0, 10)
