"""Causal flash-attention forward of the port
(``repro_torch.kernels.flash_attn``) against the JAX package's Pallas
kernel in interpret mode, on the same inputs made with numpy.  On the CPU
the port runs the kernel's plain version (a naive causal softmax in
f32); the CUDA kernel is compared with it on the card in
``test_torch_kernels_cuda.py``.

Tolerances are the JAX package's own (``tests/test_kernels_flash.py``):
2e-5 in f32, where the two sides sum the softmax and the products in
another order (blocked online softmax against one full-row softmax), and
3e-2 in bf16, compared in f32, where the reference also rounds P to bf16
before P.V and both round the output to bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_fwd as ref_flash
from repro_torch.kernels import flash_attn


def _inputs(rng, BH, S, Sk, hd):
    return (rng.standard_normal((BH, S, hd)).astype(np.float32),
            rng.standard_normal((BH, Sk, hd)).astype(np.float32),
            rng.standard_normal((BH, Sk, hd)).astype(np.float32))


@pytest.mark.parametrize("S,Sk,hd,bq,bk", [(256, 256, 64, 64, 128),
                                           (512, 512, 32, 128, 256),
                                           (128, 128, 128, 128, 128),
                                           (256, 128, 64, 64, 64),
                                           (128, 384, 32, 64, 128)])
def test_flash_matches_reference(rng, S, Sk, hd, bq, bk):
    """f32, including Sk != S in both directions: the mask is aligned at
    the start (k_pos <= q_pos on absolute positions)."""
    q, k, v = _inputs(rng, 3, S, Sk, hd)
    got = flash_attn.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), bq=bq, bk=bk)
    want = np.asarray(ref_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                bq=bq, bk=bk))
    assert got.dtype == torch.float32 and got.shape == (3, S, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,Sk", [(256, 256), (256, 128)])
def test_flash_bf16(rng, S, Sk):
    q, k, v = _inputs(rng, 2, S, Sk, 64)
    got = flash_attn.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        bq=128, bk=128)
    want = ref_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     bq=128, bk=128)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_flash_plain_is_the_naive_softmax(rng):
    """The plain version against a row-by-row softmax in float64."""
    q, k, v = _inputs(rng, 1, 64, 96, 32)
    got = flash_attn.flash_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    for i in range(64):
        s = (q[0, i].astype(np.float64) @ k[0, :i + 1].T.astype(np.float64)
             ) * 32 ** -0.5
        p = np.exp(s - s.max())
        want = (p / p.sum()) @ v[0, :i + 1].astype(np.float64)
        np.testing.assert_allclose(got[0, i].numpy(), want, atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("hd,dtype", [(48, torch.float32),
                                      (64, torch.float16),
                                      (16, torch.float16),
                                      (48, torch.bfloat16)])
def test_flash_takes_any_head_dim_and_float_dtype_on_cpu(rng, hd, dtype):
    """Head dims and dtypes the CUDA kernels lack (hd 48 or 16, float16 on
    the CPU) go to the plain version and match the JAX function at the
    same seed, as the reference computes them all.  Tolerances: f32 the
    JAX package's 2e-5; bf16 its 3e-2; f16 per element the reference's
    own rounding (P and the output to f16, ``flash_bf16_bound`` at
    u = 2**-11) plus the port's rounding of the output, u |want|."""
    q, k, v = _inputs(rng, 2, 128, 128, hd)
    got = flash_attn.flash_attention_fwd(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), bq=64, bk=64)
    jdtype = {torch.float32: jnp.float32, torch.float16: jnp.float16,
              torch.bfloat16: jnp.bfloat16}[dtype]
    want = ref_flash(*(jnp.asarray(x, jdtype) for x in (q, k, v)),
                     bq=64, bk=64)
    assert got.dtype == dtype and got.shape == (2, 128, hd)
    assert want.dtype == jdtype
    got, want = got.float(), torch.from_numpy(np.array(want, np.float32))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    else:
        qh, kh, vh = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        plain = flash_attn.flash_plain(qh, kh, vh)
        bound = flash_attn.flash_bf16_bound(qh, kh, vh, plain) \
            + flash_attn.HALF_U[dtype] * plain.abs()
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("shapes,dtype,kw", [
    (((2, 96, 64), (2, 128, 64)), torch.float32, {"bq": 64}),
    (((2, 128, 64), (2, 100, 64)), torch.float32, {"bk": 64}),
    (((2, 128, 64), (3, 128, 64)), torch.float32, {}),       # BH
])
def test_flash_rejects_what_the_kernel_does_not_take(shapes, dtype, kw):
    """Shapes the reference's contract refuses too."""
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_fwd(q, k, k, **{"bq": 128, "bk": 128,
                                                   **kw})
