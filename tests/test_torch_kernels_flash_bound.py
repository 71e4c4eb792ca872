"""The bf16 bound of the port's flash attention
(``repro_torch.kernels.flash_attn.flash_bf16_bound``) against the JAX
package's Pallas kernel in interpret mode.

The port's bf16 kernel rounds P to bf16 before P.V and the output to
bf16, as the reference kernel does, and is held on the card to a
per-element bound derived from those two roundings.  Here the reference
itself, on the same bf16 inputs made with numpy, must lie within that
bound of the plain version, and the plain version with one key tile left
out must not: the bound admits the reference's rounding and still catches
a lost tile.  The f16 kernel is held the same way, at f16's unit roundoff
2**-11 in place of bf16's 2**-8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_fwd as ref_flash
from repro_torch.kernels import flash_attn

SHAPES = [(256, 256, 64, 64, 128), (256, 128, 64, 64, 64),
          (128, 384, 32, 64, 128), (192, 320, 32, 64, 64),
          (256, 256, 128, 128, 128)]


def _inputs(rng, S, Sk, hd, dtype=torch.bfloat16):
    return [torch.from_numpy(rng.standard_normal((2, n, hd))
                             .astype(np.float32)).to(dtype)
            for n in (S, Sk, Sk)]


def _plain_dropping(q, k, v, lo, hi):
    """The plain version with keys [lo, hi) left out: what a kernel that
    lost that key tile would return."""
    S, Sk, hd = q.shape[1], k.shape[1], q.shape[2]
    keep = torch.arange(Sk)[None, :] <= torch.arange(S)[:, None]
    keep[:, lo:hi] = False
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    s = torch.where(keep[None], s, flash_attn.NEG)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())


@pytest.mark.parametrize("S,Sk,hd,bq,bk", SHAPES)
def test_reference_bf16_within_bound(rng, S, Sk, hd, bq, bk):
    q, k, v = _inputs(rng, S, Sk, hd)
    ref = ref_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      for x in (q, k, v)), bq=bq, bk=bk)
    got = torch.from_numpy(np.asarray(ref, np.float32))
    want = flash_attn.flash_plain(q, k, v)
    bound = flash_attn.flash_bf16_bound(q, k, v, want)
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("S,Sk,hd,bq,bk", SHAPES)
def test_dropped_key_tile_fails_bound(rng, S, Sk, hd, bq, bk):
    q, k, v = _inputs(rng, S, Sk, hd)
    want = flash_attn.flash_plain(q, k, v)
    bound = flash_attn.flash_bf16_bound(q, k, v, want)
    lost = _plain_dropping(q, k, v, 64, 128)
    assert not bool(((lost - want).abs() <= bound).all())


@pytest.mark.parametrize("S,Sk,hd,bq,bk", SHAPES)
def test_reference_f16_within_bound(rng, S, Sk, hd, bq, bk):
    q, k, v = _inputs(rng, S, Sk, hd, torch.float16)
    ref = ref_flash(*(jnp.asarray(x.float().numpy(), jnp.float16)
                      for x in (q, k, v)), bq=bq, bk=bk)
    assert ref.dtype == jnp.float16
    got = torch.from_numpy(np.asarray(ref, np.float32))
    want = flash_attn.flash_plain(q, k, v)
    bound = flash_attn.flash_bf16_bound(q, k, v, want)
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("S,Sk,hd,bq,bk", SHAPES)
def test_dropped_key_tile_fails_f16_bound(rng, S, Sk, hd, bq, bk):
    q, k, v = _inputs(rng, S, Sk, hd, torch.float16)
    want = flash_attn.flash_plain(q, k, v)
    bound = flash_attn.flash_bf16_bound(q, k, v, want)
    lost = _plain_dropping(q, k, v, 64, 128)
    assert not bool(((lost - want).abs() <= bound).all())
