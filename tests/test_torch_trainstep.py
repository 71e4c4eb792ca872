"""The port's train step: the JAX package's ``tests/test_trainstep.py``
(blocked CE == naive CE, its grads, microbatching == one batch, the VLM
label alignment) by name and assertion, and parity with the JAX package
on the same weights (``params_from_reference``) and batch, f32 compute:
the loss and every parameter's grad equal ``jax.value_and_grad`` of the
reference's loss within 1e-4 of the leaf's largest value, on dense, MoE,
SSM, hybrid and VLM smoke configs; the blocked CE equals the reference's;
one train step's metrics equal the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import build_model as ref_build
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import make_schedule as ref_make_schedule
from repro.train import trainstep as ref_ts
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import (build_model, param_tree,
                                      params_from_reference)
from repro_torch.models import stacked
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train.trainstep import (blocked_cross_entropy,
                                         make_loss_fn, make_train_step)

# loss and grads against the reference: share of the largest value
GRAD_TOL = 1e-4


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dtype or torch.float32)


def test_blocked_ce_matches_naive():
    rng = np.random.default_rng(0)
    B, S, d, V = 2, 1024, 16, 50
    x = _t(rng.standard_normal((B, S, d)))
    head = _t(rng.standard_normal((d, V)))
    labels = _t(rng.integers(0, V, (B, S)), torch.int32)
    mask = torch.ones((B, S))
    tot, cnt = blocked_cross_entropy(x, head, labels, mask, chunk=256)
    logits = (x @ head).float()
    naive = -torch.log_softmax(logits, -1)[
        torch.arange(B)[:, None], torch.arange(S)[None, :], labels.long()]
    np.testing.assert_allclose(float(tot / cnt), float(naive.mean()),
                               rtol=1e-5)


def test_blocked_ce_grads_match():
    rng = np.random.default_rng(1)
    B, S, d, V = 2, 512, 8, 40
    x = _t(rng.standard_normal((B, S, d)))
    head = _t(rng.standard_normal((d, V)))
    labels = _t(rng.integers(0, V, (B, S)), torch.int64)
    mask = torch.ones((B, S))

    def blocked(h):
        t, c = blocked_cross_entropy(x, h, labels, mask, chunk=128)
        return t / c

    def naive(h):
        logits = (x @ h).float()
        return -torch.log_softmax(logits, -1)[
            torch.arange(B)[:, None], torch.arange(S)[None, :],
            labels].mean()

    g1, = torch.autograd.grad(blocked(head.requires_grad_(True)), [head])
    g2, = torch.autograd.grad(naive(head), [head])
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-5)


def _smoke_model(arch, seed=0):
    return build_model(get_smoke_config(arch), device="cpu").init(
        torch.Generator().manual_seed(seed))


def test_microbatch_equivalence():
    """grad-accumulated step == single-batch step (loss + param delta)."""
    cfg = get_smoke_config("llama3-8b")
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (4, 64), generator=torch.Generator().manual_seed(0),
        dtype=torch.int32)}
    out = []
    for mb in (1, 2):
        model = _smoke_model("llama3-8b")
        opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 100))
        params = param_tree(model)
        step = make_train_step(model, opt, microbatches=mb)
        params, _, m = step(params, opt.init(params), batch, 0)
        out.append((stacked.stack(params), m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (_, a), (_, b) in zip(stacked.leaves(p1), stacked.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_vlm_loss_alignment():
    """Frontend-embed positions predict the first text token."""
    cfg = get_smoke_config("internvl2-2b")
    model = _smoke_model("internvl2-2b")
    loss_fn = make_loss_fn(model)
    B, S = 2, 32
    F = cfg.frontend_embeds
    g = torch.Generator().manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (B, S - F), generator=g),
        "embeds": torch.randn((B, F, cfg.d_model), generator=g),
    }
    loss, metrics = loss_fn(batch)
    assert torch.isfinite(loss)


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
def _pair(arch):
    """The reference's model and params, and the port's model over the
    same weights."""
    ref = ref_build(ref_smoke(arch))
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(build_model(get_smoke_config(arch),
                                             device="cpu"),
                                 jax.tree.map(np.asarray, params))
    return ref, params, port


def _batch(cfg, B=2, S=64, seed=1):
    rng = np.random.default_rng(seed)
    F = cfg.frontend_embeds
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S - F)).astype(np.int32)}
    if F:
        batch["embeds"] = rng.standard_normal(
            (B, F, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "internvl2-2b"])
def test_loss_and_grads_equal_reference(arch):
    ref, params, port = _pair(arch)
    batch = _batch(port.cfg)
    (r_loss, r_m), r_g = jax.jit(jax.value_and_grad(
        ref_ts.make_loss_fn(ref), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tree = param_tree(port)
    flat = [t for _, leaf in stacked.leaves(tree)
            for t in stacked.slices(leaf)]
    loss, m = make_loss_fn(port)({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, flat))
    for key, want in (("loss", r_loss), ("ce", r_m["ce"]),
                      ("aux", r_m["aux"])):
        got = float((loss if key == "loss" else m[key]).detach())
        assert abs(got - float(want)) <= GRAD_TOL * max(abs(float(want)),
                                                        1e-6), key
    for path, leaf in stacked.leaves(tree):
        g = [next(grads) for _ in stacked.slices(leaf)]
        got = (torch.stack(g) if isinstance(leaf, list) else g[0]).numpy()
        want = np.asarray(stacked.get(r_g, path))
        assert got.shape == want.shape, path
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, path


def test_blocked_ce_equals_reference():
    rng = np.random.default_rng(2)
    B, S, d, V = 2, 1024, 16, 50
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    head = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    for chunk in (256, 1024, 300):          # chunked, one chunk, no split

        def ref_f(xx, hh):
            t, c = ref_ts.blocked_cross_entropy(xx, hh, labels, mask, 0.5,
                                                chunk=chunk)
            return t / c
        want, (wx, wh) = jax.value_and_grad(ref_f, argnums=(0, 1))(x, head)
        xt, ht = _t(x).requires_grad_(True), _t(head).requires_grad_(True)
        t, c = blocked_cross_entropy(xt, ht, _t(labels, torch.int32),
                                     _t(mask), 0.5, chunk=chunk)
        got = t / c
        gx, gh = torch.autograd.grad(got, [xt, ht])
        assert abs(float(got.detach()) - float(want)) <= \
            1e-6 * abs(float(want))
        for a, b in ((gx, wx), (gh, wh)):
            b = np.asarray(b)
            assert float(np.abs(a.numpy() - b).max()) <= \
                GRAD_TOL * float(np.abs(b).max())


def test_train_step_metrics_equal_reference():
    """One step of the reference's train step and the port's from the
    same weights and batch: loss, ce, aux, grad_norm and lr agree (the
    updated parameters are not compared element by element: AdamW's
    first update is about lr * sign(g), which flips where g is near 0)."""
    ref, params, port = _pair("mixtral-8x7b")
    batch = _batch(port.cfg, B=4)
    sched = ("cosine", 1e-3, 100)
    ro = ref_make_optimizer("adamw", ref_make_schedule(*sched))
    po = make_optimizer("adamw", make_schedule(*sched))
    _, _, r_m = jax.jit(ref_ts.make_train_step(ref, ro))(
        params, ro.init(params), jax.tree.map(jnp.asarray, batch),
        jnp.asarray(1, jnp.int32))
    tree = param_tree(port)
    before = stacked.stack(tree)
    tree, _, m = make_train_step(port, po)(tree, po.init(tree), batch, 1)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        want = float(r_m[key])
        assert abs(float(m[key]) - want) <= GRAD_TOL * max(abs(want), 1e-6), \
            key
    moved = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        stacked.leaves(stacked.stack(tree)), stacked.leaves(before)))
    assert moved > 0.0


def test_ten_steps_follow_reference_through_wsd():
    """Ten train steps of the port and of the reference on minicpm-2b's
    smoke config from the same weights, batches (the data pipeline, seed
    0) and WSD schedule (lr 3e-4 over 10 steps, as the training CLI's
    default lr and phase 10's step count): loss and grad norm agree at
    every step within GRAD_TOL relative (step 9 is the first step of the
    schedule's decay)."""
    from repro.data import make_pipeline
    ref, params, port = _pair("minicpm-2b")
    cfg, steps = port.cfg, 10
    ro = ref_make_optimizer(cfg.optimizer,
                            ref_make_schedule(cfg.lr_schedule, 3e-4, steps))
    po = make_optimizer(cfg.optimizer,
                        make_schedule(cfg.lr_schedule, 3e-4, steps))
    r_step = jax.jit(ref_ts.make_train_step(ref, ro))
    p_step = make_train_step(port, po)
    r_state, tree = ro.init(params), param_tree(port)
    p_state = po.init(tree)
    pipeline = make_pipeline(cfg, 64, 4, seed=0)
    for i in range(steps):
        batch = pipeline.batch(i)
        params, r_state, r_m = r_step(params, r_state,
                                      jax.tree.map(jnp.asarray, batch),
                                      jnp.asarray(i, jnp.int32))
        tree, p_state, p_m = p_step(tree, p_state, batch, i)
        for key in ("loss", "grad_norm", "lr"):
            want = float(r_m[key])
            assert abs(float(p_m[key]) - want) <= \
                GRAD_TOL * max(abs(want), 1e-6), (i, key)
