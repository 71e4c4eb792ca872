"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the same inputs, made with numpy from a seed: the expert
choice equal index for index (ties to the lower index, as
``jax.lax.top_k``), outputs and the aux loss within 1e-4 x max|reference|
in f32, with tokens dropped over capacity and with shared experts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import moe as ref
from repro_torch.models import moe

TOL = 1e-4


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _params(rng, d, cfg, mlp_type):
    shapes = moe.moe_param_shapes(d, cfg, mlp_type)
    assert shapes == ref.moe_param_shapes(d, cfg, mlp_type)
    return {n: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for n, s in shapes.items()}


def _run(x, p, cfg, mlp_type):
    want_y, want_aux = ref.moe_mlp(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, cfg,
        mlp_type)
    got_y, got_aux = moe.moe_mlp(
        torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in p.items()},
        cfg, mlp_type)
    want_y = np.asarray(want_y)
    err = float(np.abs(got_y.numpy() - want_y).max())
    assert err <= TOL * float(np.abs(want_y).max()), err
    assert abs(float(got_aux) - float(want_aux)) <= TOL * abs(float(want_aux))
    return got_y.numpy(), want_y


def _capacity_dropped(x, p, cfg):
    """Tokens whose every expert was full (the reference's routing)."""
    B, S, d = x.shape
    group = min(ref.GROUP_SIZE, S)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, group, d)
                           @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    C = ref._capacity(group, cfg)
    idx = np.asarray(idx)
    dropped = 0
    for g in range(idx.shape[0]):
        seen = np.zeros(cfg.num_experts, int)
        for t in range(group):
            kept = 0
            for e in idx[g, t]:
                kept += seen[e] < C
                seen[e] += 1
            dropped += kept == 0
    return dropped


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_moe_drops_tokens_over_capacity(rng, mlp_type):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b").moe,
                              capacity_factor=0.5)
    d = 32
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    p = _params(rng, d, cfg, mlp_type)
    n_drop = _capacity_dropped(x, p, cfg)
    assert n_drop > 0                    # the case really overflows
    got, want = _run(x, p, cfg, mlp_type)
    zero_rows = int((np.abs(got.reshape(-1, d)).max(-1) == 0).sum())
    assert zero_rows == n_drop == \
        int((np.abs(want.reshape(-1, d)).max(-1) == 0).sum())


def test_moe_shared_experts(rng):
    cfg = get_smoke_config("kimi-k2-1t-a32b").moe
    assert cfg.num_shared_experts
    d = 32
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    _run(x, _params(rng, d, cfg, "swiglu"), cfg, "swiglu")


def test_moe_groups_of_512(rng):
    """S = 1024: two dispatch groups per sequence."""
    cfg = get_smoke_config("mixtral-8x7b").moe
    d = 16
    x = rng.standard_normal((1, 1024, d)).astype(np.float32)
    _run(x, _params(rng, d, cfg, "swiglu"), cfg, "swiglu")


@pytest.mark.parametrize("uniform", [False, True],
                         ids=["random", "all-tied"])
def test_expert_choice_equal(rng, uniform):
    E, k, d = 8, 3, 16
    x = rng.standard_normal((4, 32, d)).astype(np.float32)
    router = np.zeros((d, E), np.float32) if uniform else \
        rng.standard_normal((d, E)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    want_g, want_i = jax.lax.top_k(probs, k)
    want_g = want_g / jnp.clip(jnp.sum(want_g, -1, keepdims=True), 1e-9)
    got_p, got_g, got_i = moe.route(torch.from_numpy(x),
                                    torch.from_numpy(router), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if uniform:
        assert (got_i.numpy() == np.arange(k)).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(probs),
                               rtol=1e-6, atol=1e-7)
