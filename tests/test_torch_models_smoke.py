"""The port's mirror of ``tests/test_models_smoke.py``'s serving tests:
per-architecture smoke configs on the CPU, output shapes and no NaNs,
decode consistency with the full forward, and the SWA ring cache far
past its window (whose greedy tokens also equal the JAX package's with
the same weights).  The training-step test waits for the port's
optimisers and train step; the two config-count tests are the configs'
own (``tests/test_torch_configs.py`` holds the port's configs equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as ref_build
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.models.model import build_model, params_from_reference


def _model(cfg, seed):
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))


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
