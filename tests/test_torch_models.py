"""The port's ``LMModel`` against the JAX package's, every architecture
in ``ARCH_NAMES`` at its smoke config, with the reference's own
``model.init`` weights carried across by ``params_from_reference``:
parameter shapes, a lossless round trip of the weights, forward logits,
prefill caches and logits, and three decode steps (internvl2 with its
frontend embeddings).  f32 tolerance 1e-4 x max|reference| (measured
about 1e-6); one bf16 llama3 case is held to a bound from bf16 rounding.
Inputs are made with numpy from a seed."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke_config
from repro.models.model import build_model as ref_build
from repro_torch.models.model import (build_model, params_from_reference,
                                      params_to_reference)

TOL = 1e-4
B, S, N_DECODE = 2, 32, 3


def rel_err(got, want):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def pair(cfg, seed=0):
    """(reference model, its params, port model with the same weights)."""
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = build_model(cfg, device="cpu")
    params_from_reference(port, jax.tree.map(np.asarray, params))
    return ref, params, port


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    F = cfg.frontend_embeds
    toks = rng.integers(0, cfg.vocab_size, (B, S - F)).astype(np.int32)
    emb = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32) \
        if F else None
    return toks, emb


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_pair(request):
    cfg = get_smoke_config(request.param)
    return (request.param, cfg, *pair(cfg))


def test_param_shapes_equal(arch_pair):
    arch, cfg, ref, params, port = arch_pair
    want = jax.tree.map(lambda s: tuple(s.shape), ref.param_shapes(),
                        is_leaf=lambda s: hasattr(s, "shape"))
    assert port.param_shapes() == want
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree.leaves(ref.param_shapes()))


def test_params_round_trip(arch_pair):
    arch, cfg, ref, params, port = arch_pair
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_forward_equal(arch_pair):
    arch, cfg, ref, params, port = arch_pair
    toks, emb = inputs(cfg)
    want, want_aux = jax.jit(ref.forward)(
        params, jnp.asarray(toks), None if emb is None else jnp.asarray(emb))
    with torch.no_grad():
        got, got_aux = port.forward(
            torch.from_numpy(toks),
            None if emb is None else torch.from_numpy(emb))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= TOL, arch
    assert abs(float(got_aux) - float(want_aux)) <= \
        TOL * max(abs(float(want_aux)), 1.0)


def test_prefill_and_decode_equal(arch_pair):
    arch, cfg, ref, params, port = arch_pair
    toks, emb = inputs(cfg)
    cap = S + N_DECODE + 1
    ref_emb = None if emb is None else jnp.asarray(emb)
    c_r, lg_r = jax.jit(lambda p, t, e: ref.prefill(p, t, e, capacity=cap))(
        params, jnp.asarray(toks), ref_emb)
    c_p, lg_p = port.prefill(torch.from_numpy(toks),
                             None if emb is None else torch.from_numpy(emb),
                             capacity=cap)
    assert rel_err(lg_p, lg_r) <= TOL, arch
    assert set(c_p) == set(c_r)
    for key in c_r:
        assert set(c_p[key]) == set(c_r[key])
        for name in c_r[key]:
            assert rel_err(c_p[key][name], c_r[key][name]) <= TOL, \
                (arch, key, name)
    dec = jax.jit(ref.decode_step)
    tok = np.argmax(np.asarray(lg_r), -1)[:, None].astype(np.int32)
    for i in range(N_DECODE):
        c_r, lg_r = dec(params, c_r, jnp.asarray(tok),
                        jnp.asarray(S + i, jnp.int32))
        c_p, lg_p = port.decode_step(c_p, torch.from_numpy(tok), S + i)
        assert rel_err(lg_p, lg_r) <= TOL, (arch, i)
        tok = np.argmax(np.asarray(lg_r), -1)[:, None].astype(np.int32)
    for key in c_r:
        for name in c_r[key]:
            assert c_p[key][name].dtype == \
                getattr(torch, str(c_r[key][name].dtype))
            assert rel_err(c_p[key][name], c_r[key][name]) <= TOL


def test_llama3_bf16_within_rounding():
    """bf16 weights and compute.  The two sides round the same values at
    the same ops, but may land one bf16 ulp (relative u = 2**-8) apart
    where they sum in another order.  The residual stream and the logits
    go through 2L + 1 rounded adds (the 2L sublayer outputs, the head);
    taken as independent, such differences add in quadrature,
    sqrt(2L + 1) u relative to the largest logit, and the bound is twice
    that: 2 sqrt(2L + 1) u max|logit| = 6u for L = 4 (the bound
    ``chip_smoke.py`` phase 9 holds the batcher to at L = 32).  Measured
    3.2-4.3u on the forward over seeds 0-3."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    ref, params, port = pair(cfg)
    assert port.embed.dtype == torch.bfloat16
    bound = 2 * math.sqrt(2 * cfg.num_layers + 1) * 2.0 ** -8
    toks, _ = inputs(cfg)
    want, _ = jax.jit(ref.forward)(params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = port.forward(torch.from_numpy(toks))
    assert rel_err(got, want) <= bound
    c_r, lg_r = jax.jit(lambda p, t: ref.prefill(p, t, capacity=S + 1))(
        params, jnp.asarray(toks))
    c_p, lg_p = port.prefill(torch.from_numpy(toks), capacity=S + 1)
    assert rel_err(lg_p, lg_r) <= bound
    tok = np.argmax(np.asarray(lg_r), -1)[:, None].astype(np.int32)
    _, lg_r = jax.jit(ref.decode_step)(params, c_r, jnp.asarray(tok),
                                       jnp.asarray(S, jnp.int32))
    _, lg_p = port.decode_step(c_p, torch.from_numpy(tok), S)
    assert rel_err(lg_p, lg_r) <= bound


def test_bf16_params_round_trip():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              param_dtype="bfloat16")
    ref = ref_build(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(3)))
    port = params_from_reference(build_model(cfg, device="cpu"), tree)
    for a, b in zip(jax.tree.leaves(params_to_reference(port)),
                    jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint16), b.view(np.uint16))


def test_params_from_reference_refuses_a_wrong_shape():
    cfg = get_smoke_config("llama3-8b")
    port = build_model(cfg, device="cpu")
    tree = params_to_reference(port.init())
    tree["blocks"]["pos0"]["attn"]["wq"] = \
        tree["blocks"]["pos0"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(port, tree)


def test_build_model_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("llama3-8b"))


def test_init_follows_the_reference_rules():
    cfg = get_smoke_config("jamba-1.5-large-398b")
    port = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    named = dict(port.named_parameters())
    ssm_pos = next(i for i, (m, _) in enumerate(port.kinds) if m == "ssm")
    pre = f"blocks.0.pos{ssm_pos}.ssm."
    assert torch.equal(named[pre + "D"], torch.ones_like(named[pre + "D"]))
    assert not named[pre + "conv_x_b"].any()
    A = torch.exp(named[pre + "A_log"])
    assert (A >= 1).all() and (A <= 16).all()
    dt = torch.nn.functional.softplus(named[pre + "dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
    assert abs(float(port.embed.detach().std()) - 0.02) < 0.002
    wq = named["blocks.0.pos4.attn.wq"]
    assert abs(float(wq.detach().std()) - cfg.d_model ** -0.5) < 0.01
