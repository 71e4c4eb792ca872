"""The f32 flash kernel's arithmetic on the CPU: the plain version of its
pre-pass (``flash_attn.tf32_split_plain``) and an emulation of its 3xTF32
products, held to the JAX package's flash kernel.

The f32 CUDA kernel splits every operand x into TF32 parts hi = rna(x)
and lo = rna(x - hi) and computes each product as hi.hi + hi.lo + lo.hi
on the tensor cores.  The pre-pass writes the split planes, with V
transposed to [BH, hd, sk_pad] and the keys of every group of 8 stored in
the order 0, 2, 4, 6, 1, 3, 5, 7.  The kernel itself runs only on the
card (``test_torch_kernels_cuda.py``); here the plain pre-pass is checked
bit by bit against an independent rounding, and the emulation (float64
products of the planes, P split the same way, keys read through vT's
slots) is held to the JAX package's ``flash_attention_fwd`` in interpret
mode within its own 2e-5, which a 1xTF32 emulation (hi parts only) must
fail."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_fwd as ref_flash
from repro_torch.kernels import flash_attn

TOL = 2e-5


def _bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32).view(np.uint32)


def _rna_numpy(x: np.ndarray) -> np.ndarray:
    """TF32 to nearest, ties away, by choosing between the two TF32
    neighbours of x in float64 (finite x only)."""
    b = _bits(x)
    down = (b & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    up = ((b & np.uint32(0xFFFFE000)) + np.uint32(0x2000)) \
        .view(np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    pick_up = np.abs(up - xd) <= np.abs(xd - down)
    return np.where(pick_up, up, down).astype(np.float32)


def test_tf32_round_is_rna(rng):
    x = (rng.standard_normal(20000)
         * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    hi = flash_attn.tf32_round(torch.from_numpy(x)).numpy()
    assert not (_bits(hi) & 0x1FFF).any(), "low 13 bits of hi are zero"
    np.testing.assert_array_equal(_bits(hi), _bits(_rna_numpy(x)))


@pytest.mark.parametrize("bits,want", [
    (0x00000000, 0x00000000),          # +0
    (0x80000000, 0x80000000),          # -0
    (0x00000001, 0x00000000),          # smallest denormal rounds to 0
    (0x80000FFF, 0x80000000),          # negative denormal below the tie
    (0x00001000, 0x00002000),          # denormal tie: away from zero
    (0x80003000, 0x80004000),          # negative denormal tie
    (0x007FF000, 0x00800000),          # largest denormals round to 2**-126
    (0x3FFFF000, 0x40000000),          # just below 2 rounds up to 2
    (0xBF7FF000, 0xBF800000),          # just above -1 rounds to -1
    (0x3F801000, 0x3F802000),          # tie in the normal range
    (0x3F800FFF, 0x3F800000),          # just below the tie
    (0x7F800000, 0x7F800000),          # +inf passes
    (0xFF800000, 0xFF800000),          # -inf passes
])
def test_tf32_round_edge_values(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)
    got = flash_attn.tf32_round(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want


def test_tf32_round_keeps_nan():
    x = torch.tensor([float("nan")], dtype=torch.float32)
    assert torch.isnan(flash_attn.tf32_round(x)).all()


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
def test_tf32_split_reconstructs(scale):
    """hi + lo rebuilds x within 2**-22 |x|.  Where lo is subnormal (|x|
    below about 2.4e-35), TF32 keeps a subnormal's bits above its low 13,
    multiples of 2**-136, so lo rounds to within 2**-137 and no split can
    do better there."""
    x = (np.random.default_rng(0).standard_normal(50000) * scale
         ).astype(np.float32)
    q = torch.from_numpy(x).view(1, -1, 8)
    q_hi, q_lo, *_ = flash_attn.tf32_split_plain(q, q, q)
    hi, lo = q_hi.numpy().ravel(), q_lo.numpy().ravel()
    assert not ((_bits(hi) | _bits(lo)) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= np.maximum(2.0 ** -22 * np.abs(x), 2.0 ** -137)).all()


@pytest.mark.parametrize("Sk,hd", [(5, 32), (37, 64), (64, 128), (100, 32)])
def test_vt_layout_and_permutation(rng, Sk, hd):
    """vT read back through the inverse of the slot permutation equals v,
    with zeros past Sk; v varies along keys, so a wrong permutation or a
    transpose the wrong way shows."""
    assert flash_attn.KEY_PERM == (0, 2, 4, 6, 1, 3, 5, 7)
    BH, S = 2, 8
    v = rng.standard_normal((BH, Sk, hd)).astype(np.float32)
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = rng.standard_normal((BH, Sk, hd)).astype(np.float32)
    planes = flash_attn.tf32_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v)))
    q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo = (p.numpy() for p in planes)
    sk_pad = -(-Sk // 32) * 32
    assert vt_hi.shape == vt_lo.shape == (BH, hd, sk_pad)
    for x, hi, lo in ((q, q_hi, q_lo), (k, k_hi, k_lo)):
        np.testing.assert_array_equal(hi, _rna_numpy(x))
        np.testing.assert_array_equal(lo, _rna_numpy(x - hi))
    v_hi = _rna_numpy(v)
    v_lo = _rna_numpy(v - v_hi)
    for slot in range(sk_pad):
        key = 8 * (slot // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[slot % 8]
        if key < Sk:
            np.testing.assert_array_equal(vt_hi[:, :, slot], v_hi[:, key])
            np.testing.assert_array_equal(vt_lo[:, :, slot], v_lo[:, key])
        else:
            assert not vt_hi[:, :, slot].any() and not vt_lo[:, :, slot].any()


def test_tf32_split_on_cpu_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 32))
                                .astype(np.float32)) for _ in range(3))
    before = flash_attn.SPLIT_LAUNCHES.value
    got = flash_attn.tf32_split(q, k, v)
    want = flash_attn.tf32_split_plain(q, k, v)
    assert flash_attn.SPLIT_LAUNCHES.value == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _hi_lo(x: torch.Tensor):
    hi = flash_attn.tf32_round(x)
    return hi, flash_attn.tf32_round(x - hi)


def emulate(q, k, v, terms: int) -> np.ndarray:
    """The f32 kernel's arithmetic in float64: S from the split planes
    (hi.hi + hi.lo + lo.hi with terms=3, hi.hi with terms=1), a causal
    softmax with the start-aligned mask, P rounded to f32 and split, and
    P.V through vT's slots.  Returns f32 [BH, S, hd]."""
    BH, S, hd = q.shape
    Sk = k.shape[1]
    q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo = (
        p.numpy().astype(np.float64) for p in flash_attn.tf32_split_plain(
            *(torch.from_numpy(x) for x in (q, k, v))))
    s = q_hi @ k_hi.transpose(0, 2, 1)
    if terms == 3:
        s += q_hi @ k_lo.transpose(0, 2, 1) + q_lo @ k_hi.transpose(0, 2, 1)
    s *= hd ** -0.5
    mask = np.arange(Sk)[None, :] <= np.arange(S)[:, None]
    s = np.where(mask[None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True)).astype(np.float32)
    l = p.sum(axis=-1, dtype=np.float64)
    sk_pad = vt_hi.shape[2]
    slots = np.zeros((BH, S, sk_pad), np.float32)
    keys = [8 * (i // 8) + flash_attn.KEY_PERM[i % 8] for i in range(sk_pad)]
    real = [i for i, key in enumerate(keys) if key < Sk]
    slots[:, :, real] = p[:, :, [keys[i] for i in real]]
    p_hi, p_lo = (x.numpy().astype(np.float64) for x in
                  _hi_lo(torch.from_numpy(slots)))
    o = p_hi @ vt_hi.transpose(0, 2, 1)
    if terms == 3:
        o += p_hi @ vt_lo.transpose(0, 2, 1) + p_lo @ vt_hi.transpose(0, 2, 1)
    return (o / l[..., None]).astype(np.float32)


@pytest.mark.parametrize("S,Sk,hd", [(128, 256, 32), (256, 128, 64),
                                     (192, 128, 128), (128, 192, 128)])
def test_3xtf32_emulation_matches_reference(rng, S, Sk, hd):
    """3xTF32 lies within the JAX package's 2e-5 of its f32 flash kernel;
    1xTF32 does not, so the check tells the two apart."""
    BH = 2
    q, k, v = (rng.standard_normal((BH, n, hd)).astype(np.float32)
               for n in (S, Sk, Sk))
    want = np.asarray(ref_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                bq=64, bk=64))
    np.testing.assert_allclose(emulate(q, k, v, 3), want, atol=TOL, rtol=TOL)
    one = emulate(q, k, v, 1)
    assert not np.allclose(one, want, atol=TOL, rtol=TOL)
