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


# --------------------------------------------------------------------------
# the card's score products and autograd's graph
# --------------------------------------------------------------------------
def _graph_names(t):
    """Names of every node of ``t``'s autograd graph."""
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack += [f for f, _ in fn.next_functions]
    return names


@pytest.mark.parametrize("q_block,softcap", [(64, 0.0), (8, 2.0)],
                         ids=["one-block", "blocked-softcap"])
def test_gqa_attention_under_grad_builds_no_copy_slices(rng, q_block,
                                                        softcap):
    """Scaling and masking the scores in place under grad makes autograd
    record a ``CopySlices`` node, whose backward copies the scores' grad;
    the out-of-place forms record none."""
    q, k, v = (_t(a).requires_grad_() for a in _qkv(rng))
    pos = _t(np.arange(32, dtype=np.int32))
    out = L.gqa_attention(q, k, v, pos, pos, softcap=softcap,
                          q_block=q_block, swa_window=5)
    names = _graph_names(out)
    assert "SoftmaxBackward0" in names, names     # the walk saw the scores
    assert "CopySlices" not in names, names


def test_scores_f32_on_meta_tensors():
    """The tensor-core score product's wiring, where the CPU can run it:
    bf16 and f16 operands give f32 scores [N, M, T], and the backward gives
    grads of the operands' shapes and dtypes."""
    for dt in (torch.bfloat16, torch.float16):
        a = torch.empty(6, 10, 16, device="meta", dtype=dt,
                        requires_grad=True)
        b = torch.empty(6, 7, 16, device="meta", dtype=dt,
                        requires_grad=True)
        s = L.ScoresF32.apply(a, b)
        assert s.shape == (6, 10, 7) and s.dtype == torch.float32
        da, db = torch.autograd.grad(s, (a, b), torch.empty_like(s))
        assert da.shape == a.shape and da.dtype == dt
        assert db.shape == b.shape and db.dtype == dt


def _emulated_bmm(bmm):
    """``torch.bmm`` with ``out_dtype`` on the CPU, as the card computes
    it: the f32 product of the operands, rounded to ``out_dtype``."""
    def fn(a, b, out_dtype=None, **kw):
        if out_dtype is None:
            return bmm(a, b, **kw)
        return bmm(a.float(), b.float()).to(out_dtype)
    return fn


def test_tensor_core_paths_equal_the_f32_paths(rng, monkeypatch):
    """The card's layouts on the CPU: ``aten::bmm.dtype`` emulated (f32
    products of the bf16 operands), and the tensor-core dispatch taken for
    CPU tensors.  ``_attend_block``'s forward and grads and
    ``decode_attention`` (the block-diagonal query against the cache read
    in place) equal the f32 paths on the same bf16 inputs: the same exact
    products, summed in another order in f32, so their bf16 results
    (output and grads) agree within one bf16 rounding, 2**-8 of the
    largest value."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(rng))
    pos = _t(np.arange(32, dtype=np.int32))

    def run():
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = L.gqa_attention(*ins, pos, pos, softcap=2.0, q_block=8)
        grads = torch.autograd.grad(out.float().square().sum(), ins)
        return [out, *grads]
    want = run()
    monkeypatch.setattr(torch, "bmm", _emulated_bmm(torch.bmm))
    monkeypatch.setattr(L, "_tensor_core_scores", lambda a, b: True)
    got = run()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        close(g, w.detach().float(), 2.0 ** -8)

    B, C, H, K, hd = 3, 24, 8, 2, 16
    qd = _t(rng.standard_normal((B, 1, H, hd))).to(torch.bfloat16)
    kc, vc = (_t(rng.standard_normal((B, C, K, hd))).to(torch.bfloat16)
              for _ in range(2))
    slot_pos = torch.arange(C)
    cur = torch.tensor([5, 17, 23])
    got = L.decode_attention(qd, kc, vc, slot_pos, cur, softcap=3.0)
    monkeypatch.undo()
    want = L.decode_attention(qd, kc, vc, slot_pos, cur, softcap=3.0)
    assert got.dtype == torch.bfloat16
    close(got, want.float(), 2.0 ** -8)
