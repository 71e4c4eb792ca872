"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's on the same inputs and weights, made with numpy from a seed:
full-sequence output with S a multiple of the chunk and not (one chunk of
S), the returned state, and decode steps chained from the prefill state.
Tolerance 1e-4 x max|reference| in f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import ssm as ref
from repro_torch.models import ssm

TOL = 1e-4
D_MODEL = 64


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def setup(rng):
    cfg = get_smoke_config("mamba2-1.3b").ssm          # chunk 32
    shapes = ssm.ssm_param_shapes(D_MODEL, cfg)
    assert shapes == ref.ssm_param_shapes(D_MODEL, cfg)
    p = {}
    for n, s in shapes.items():
        if n == "A_log":
            p[n] = np.log(rng.uniform(1.0, 16.0, s))
        elif n == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), s))
            p[n] = dt + np.log(-np.expm1(-dt))
        else:
            p[n] = rng.standard_normal(s) / np.sqrt(s[0])
    p = {n: a.astype(np.float32) for n, a in p.items()}
    return cfg, p


def close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


def _ref_p(p):
    return {n: jnp.asarray(a) for n, a in p.items()}


def _port_p(p):
    return {n: torch.from_numpy(a) for n, a in p.items()}


@pytest.mark.parametrize("S", [64, 40, 3], ids=["two-chunks",
                                                "ragged-one-chunk",
                                                "shorter-than-conv"])
def test_ssm_forward_and_state(setup, rng, S):
    cfg, p = setup
    x = rng.standard_normal((2, S, D_MODEL)).astype(np.float32)
    want, want_st = ref.ssm_forward(jnp.asarray(x), _ref_p(p), D_MODEL, cfg,
                                    return_state=True)
    got, got_st = ssm.ssm_forward(torch.from_numpy(x), _port_p(p), D_MODEL,
                                  cfg, return_state=True)
    close(got, want)
    assert set(got_st) == set(want_st)
    for n in want_st:
        close(got_st[n], want_st[n])
    no_state = ssm.ssm_forward(torch.from_numpy(x), _port_p(p), D_MODEL, cfg)
    assert torch.equal(no_state, got)


def test_decode_steps_chained_from_prefill(setup, rng):
    cfg, p = setup
    S = 64
    x = rng.standard_normal((2, S + 4, D_MODEL)).astype(np.float32)
    _, want_st = ref.ssm_forward(jnp.asarray(x[:, :S]), _ref_p(p), D_MODEL,
                                 cfg, return_state=True)
    _, got_st = ssm.ssm_forward(torch.from_numpy(x[:, :S]), _port_p(p),
                                D_MODEL, cfg, return_state=True)
    for t in range(S, S + 4):
        want, want_st = ref.ssm_decode_step(jnp.asarray(x[:, t:t + 1]),
                                            want_st, _ref_p(p), D_MODEL, cfg)
        got, got_st = ssm.ssm_decode_step(torch.from_numpy(x[:, t:t + 1]),
                                          got_st, _port_p(p), D_MODEL, cfg)
        close(got, want)
        for n in want_st:
            close(got_st[n], want_st[n])
    # the decode chain continues the full forward at its last position
    full = ssm.ssm_forward(torch.from_numpy(x), _port_p(p), D_MODEL, cfg)
    close(got[:, 0], full[:, -1].numpy())


def test_state_shapes(setup):
    cfg, _ = setup
    got = ssm.ssm_state_shapes(3, D_MODEL, cfg)
    want = ref.ssm_state_shapes(3, D_MODEL, cfg)
    assert {n: s for n, (s, _) in got.items()} == \
        {n: s for n, (s, _) in want.items()}
    assert got["ssm"][1] == torch.float32
    assert got["conv_x"][1] == torch.bfloat16
