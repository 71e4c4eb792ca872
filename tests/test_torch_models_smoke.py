"""The port's mirror of ``tests/test_models_smoke.py``:
per-architecture smoke configs on the CPU, one train step (finite loss
and grad norm, parameters moved), output shapes and no NaNs, decode
consistency with the full forward, and the SWA ring cache far past its
window (whose greedy tokens also equal the JAX package's with the same
weights); the remat policies.  The two config-count tests are the
configs' own (``tests/test_torch_configs.py`` holds the port's configs
equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as ref_build
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.models.model import (build_model, param_tree,
                                      params_from_reference)
from repro_torch.models import stacked
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train.trainstep import make_loss_fn, make_train_step


def _model(cfg, seed):
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_smoke(arch):
    cfg = get_smoke_config(arch)
    model = _model(cfg, 0)
    B, S = 2, 64
    F = cfg.frontend_embeds
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - F),
                                     generator=g)}
    if F:
        batch["embeds"] = torch.randn((B, F, cfg.d_model), generator=g)
    opt = make_optimizer(cfg.optimizer,
                         make_schedule(cfg.lr_schedule, 1e-3, 100))
    params = param_tree(model)
    before = stacked.stack(params)
    step = make_train_step(model, opt)
    # step 1: past LR warmup (lr(0) == 0 by schedule definition)
    params2, _, m = step(params, opt.init(params), batch, 1)
    assert torch.isfinite(m["loss"]), arch
    assert torch.isfinite(m["grad_norm"]), arch
    # params actually changed
    delta = [float((a - b).abs().max()) for (_, a), (_, b) in zip(
        stacked.leaves(stacked.stack(params2)), stacked.leaves(before))]
    assert max(delta) > 0.0


def _saved_bytes_and_grads(model, batch):
    """Bytes autograd saves for backward over one loss, and the grads."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    flat = [t for _, leaf in stacked.leaves(param_tree(model))
            for t in stacked.slices(leaf)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = make_loss_fn(model)(batch)
    return sum(saved), torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-1.5-large-398b"])
def test_remat_same_grads_fewer_saved_bytes(arch):
    """``nothing_saveable`` recomputes each superblock in backward: the
    grads equal ``everything_saveable``'s bit for bit, and the forward
    saves fewer bytes for backward (the superblocks' inputs, not their
    activations)."""
    cfg = get_smoke_config(arch)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))}
    out = {}
    for policy in ("nothing_saveable", "everything_saveable"):
        model = build_model(cfg, device="cpu", remat_policy=policy).init(
            torch.Generator().manual_seed(0))
        out[policy] = _saved_bytes_and_grads(model, batch)
    (b_remat, g_remat), (b_all, g_all) = out["nothing_saveable"], \
        out["everything_saveable"]
    assert all(torch.equal(a, b) for a, b in zip(g_remat, g_all))
    assert b_remat < b_all / 2, (b_remat, b_all)


def test_attention_blocks_recomputed_under_grad():
    """A row longer than one query block: attention saves no block's
    scores for backward under grad (each block is recomputed), and its
    grads equal those of one block over the whole row."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    B, S, H, K, hd = 1, 64, 4, 2, 8
    q, k, v = (torch.randn((B, S, n, hd), generator=g).requires_grad_(True)
               for n in (H, K, K))
    pos = torch.arange(S)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        o = L.gqa_attention(q, k, v, pos, pos, q_block=16)
    assert all(tuple(s)[-2:] != (16, S) for s in saved), saved
    want = L.gqa_attention(q, k, v, pos, pos, q_block=S)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-6)
    ga = torch.autograd.grad(o.square().sum(), [q, k, v])
    gb = torch.autograd.grad(want.square().sum(), [q, k, v])
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_unknown_remat_policy_raises():
    """A policy that takes arguments and an unknown name raise, each
    naming the policy."""
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(ValueError, match="save_only_these_names.*takes "
                                         "arguments"):
        build_model(cfg, device="cpu", remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="unknown remat policy 'no_such'"):
        build_model(cfg, device="cpu", remat_policy="no_such")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_shapes(arch):
    cfg = get_smoke_config(arch)
    model = _model(cfg, 1)
    B, S = 2, 32
    F = cfg.frontend_embeds
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S - F), generator=g)
    embeds = torch.randn((B, F, cfg.d_model), generator=g) if F else None
    with torch.no_grad():
        logits, aux = model.forward(tokens, embeds)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.all(torch.isfinite(logits))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_matches_full_forward(arch):
    """prefill(S) + decode(1) logits == forward(S+1) last-position logits.
    MoE archs use capacity_factor high enough to disable dropping (the
    known train/serve asymmetry of capacity-based MoE)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    if cfg.frontend_embeds:
        cfg = dataclasses.replace(cfg, frontend_embeds=0)
    model = _model(cfg, 0)
    B, S = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(0))
    toks2 = torch.cat([tokens, torch.zeros((B, 1), dtype=tokens.dtype)],
                      dim=1)
    cap = model.capacity_for(S + 1)
    cache, _ = model.prefill(tokens, capacity=cap)
    cache, lg_dec = model.decode_step(cache, toks2[:, -1:], S)
    with torch.no_grad():
        full_logits, _ = model.forward(toks2)
    err = float(torch.max(torch.abs(lg_dec - full_logits[:, -1])))
    assert err < 2e-3, f"{arch}: decode/full divergence {err}"


def test_swa_ring_cache_long_decode():
    """Mixtral-family SWA ring cache: decode far past the window stays
    finite and consistent with a fresh prefill; with the reference's
    weights its greedy tokens are the reference's."""
    cfg = get_smoke_config("mixtral-8x7b")
    cfg = dataclasses.replace(
        cfg, swa_window=16,
        moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_reference(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    B, S = 1, 40                                   # S > window
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                           cfg.vocab_size))
    cache, logits = model.prefill(torch.from_numpy(tokens))
    assert cache["pos0"]["k"].shape[2] == 16       # the ring, not S
    c_r, lg_r = jax.jit(lambda p, t: ref.prefill(p, t))(params,
                                                        jnp.asarray(tokens))
    dec = jax.jit(ref.decode_step)
    tok = torch.argmax(logits, -1)[:, None]
    tok_r = jnp.argmax(lg_r, -1)[:, None]
    for i in range(5):
        assert tok.tolist() == np.asarray(tok_r).tolist()
        cache, logits = model.decode_step(cache, tok, S + i)
        c_r, lg_r = dec(params, c_r, tok_r, jnp.asarray(S + i, jnp.int32))
        assert bool(torch.all(torch.isfinite(logits)))
        tok = torch.argmax(logits, -1)[:, None]
        tok_r = jnp.argmax(lg_r, -1)[:, None]
    assert tok.tolist() == np.asarray(tok_r).tolist()
