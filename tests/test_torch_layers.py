"""The port's transformer layers (``repro_torch.models.layers``) against
the JAX package's on the same inputs, made with numpy from a seed.

Tolerance: f32 results within 1e-4 x max|reference| (summation order is
the only difference; the measured error is about 1e-7 of it).  bf16
scores are held to the bf16 rounding they carry (see the test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref
from repro_torch.models import layers as L

TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), \
        (err, float(np.abs(want).max()))
    return err


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    close(L.rms_norm(_t(x), _t(s), 1e-5),
          ref.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


def test_apply_rope_rotates_interleaved_pairs(rng):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 100
    got = L.apply_rope(_t(x), _t(pos), 10000.0)
    close(got, ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    # pair (0, 1) of position p rotates by angle p * theta^0 = p
    c, s = np.cos(100.0), np.sin(100.0)
    x0, x1 = x[:, 0, :, 0], x[:, 0, :, 1]
    np.testing.assert_allclose(got[:, 0, :, 0].numpy(), x0 * c - x1 * s,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 0, :, 1].numpy(), x1 * c + x0 * s,
                               rtol=1e-5, atol=1e-5)


def _qkv(rng, B=2, S=32, H=4, K=2, hd=16, Sk=None):
    Sk = Sk or S
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("q_block,swa,softcap", [
    (64, 0, 0.0), (8, 0, 0.0), (8, 5, 0.0), (8, 0, 2.0), (32, 7, 1.5)],
    ids=["one-block", "blocked", "blocked-swa", "blocked-softcap",
         "one-block-swa-softcap"])
def test_gqa_attention(rng, q_block, swa, softcap):
    q, k, v = _qkv(rng)
    pos = np.arange(32, dtype=np.int32)
    want = ref.gqa_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                             swa_window=swa, softcap=softcap,
                             q_block=q_block)
    got = L.gqa_attention(*map(_t, (q, k, v, pos, pos)), swa_window=swa,
                          softcap=softcap, q_block=q_block)
    close(got, want)


def test_gqa_attention_blocked_needs_whole_blocks(rng):
    q, k, v = _qkv(rng, S=24)
    pos = _t(np.arange(24, dtype=np.int32))
    with pytest.raises(AssertionError):
        L.gqa_attention(_t(q), _t(k), _t(v), pos, pos, q_block=16)


def test_gqa_attention_bf16_scores(rng):
    """bf16 inputs and ``score_dtype`` bf16.  Each implementation rounds a
    score twice (the product, then the product by the scale, which both
    round alike), each time by at most half a bf16 ulp: |ds| <= u |s| with
    u = 2**-8.  That moves each probability by a factor within
    exp(+-2 u max|s|), so the mix over v by (exp(2 u max|s|) - 1) max|v|;
    the probabilities' and the output's roundings add u max|v|.  The two
    implementations differ by at most twice one's error."""
    q, k, v = _qkv(rng)
    pos = np.arange(32, dtype=np.int32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = ref.gqa_attention(*bf, jnp.asarray(pos), jnp.asarray(pos),
                             q_block=8, score_dtype=jnp.bfloat16)
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = L.gqa_attention(*tb, _t(pos), _t(pos), q_block=8,
                          score_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    u = 2.0 ** -8
    qf, kf, vf = (t.float().numpy() for t in tb)
    B, S, H, hd = qf.shape
    K = kf.shape[2]
    s = np.einsum("bskgd,btkd->bkgst", qf.reshape(B, S, K, H // K, hd),
                  kf) * hd ** -0.5
    vmax = float(np.abs(vf).max())
    bound = 2 * (np.expm1(2 * u * float(np.abs(s).max())) + u) * vmax
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want, np.float32)).max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_decode_attention(rng, ragged):
    B, C, H, K, hd = 3, 24, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    if ragged:
        slot_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
        slot_pos[1, 20:] = -1
        cur = np.array([5, 17, 23], np.int32)
    else:
        slot_pos = np.arange(C, dtype=np.int32)
        cur = np.int32(11)
    want = ref.decode_attention(*map(jnp.asarray, (q, kc, vc, slot_pos)),
                                jnp.asarray(cur), softcap=3.0)
    got = L.decode_attention(_t(q), _t(kc), _t(vc), _t(slot_pos),
                             torch.as_tensor(cur), softcap=3.0)
    close(got, want)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp(rng, mlp_type):
    d, f = 32, 48
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in L.mlp_param_shapes(d, f, mlp_type).items()}
    assert L.mlp_param_shapes(d, f, mlp_type) == \
        ref.mlp_param_shapes(d, f, mlp_type)
    want = ref.mlp(jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()},
                   mlp_type)
    got = L.mlp(_t(x), {n: _t(a) for n, a in p.items()}, mlp_type)
    close(got, want)
    if mlp_type == "gelu":
        # the exact erf form would fail the tolerance: jax.nn.gelu's
        # default is the tanh approximation
        h = _t(x) @ _t(p["w1"])
        exact = torch.nn.functional.gelu(h) @ _t(p["w2"])
        with pytest.raises(AssertionError):
            close(exact, want)
