"""The port's continuous-batching scheduler: the mirror of
``tests/test_scheduler.py`` (ragged-position correctness vs sequential
single-request decoding; more requests than slots), and its tokens, and
``greedy_generate``'s, equal to the JAX package's with the same weights
and prompts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as ref_build
from repro.serve.scheduler import ContinuousBatcher as RefBatcher
from repro.serve.servestep import greedy_generate as ref_greedy
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import build_model, params_from_reference
from repro_torch.serve.scheduler import ContinuousBatcher
from repro_torch.serve.servestep import (greedy_generate, make_decode_step,
                                         make_prefill_step)


def _single_reference(model, prompt, n_new, capacity):
    cache, logits = model.prefill(torch.from_numpy(prompt)[None, :],
                                  capacity=capacity)
    toks = [int(torch.argmax(logits, -1)[0])]
    for i in range(n_new - 1):
        cache, logits = model.decode_step(
            cache, torch.tensor([[toks[-1]]], dtype=torch.int32),
            len(prompt) + i)
        toks.append(int(torch.argmax(logits, -1)[0]))
    return toks


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3-8b")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    return cfg, model


@pytest.fixture()
def rng():
    """Module-local override of the session rng: argmax-continuation
    comparisons are sensitive to the exact prompt values, so these tests
    must not depend on how much of the shared stream earlier test files
    consumed."""
    return np.random.default_rng(0)


def test_ragged_matches_sequential(setup, rng):
    """3 requests with different prompt lengths, batched together, must
    produce the same continuations as independent decoding."""
    cfg, model = setup
    capacity = 64
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 19, 33)]
    n_new = 6

    want = [_single_reference(model, p, n_new, capacity) for p in prompts]

    cb = ContinuousBatcher(model, batch_slots=3, capacity=capacity)
    reqs = [cb.submit(p, n_new) for p in prompts]
    finished = cb.run_until_drained()
    assert len(finished) == 3
    got = {r.rid: r.out_tokens for r in finished}
    for i, w in enumerate(want):
        assert got[i] == w, (i, got[i], w)


def test_more_requests_than_slots(setup, rng):
    """Requests beyond the slot count queue and are served as slots free."""
    cfg, model = setup
    cb = ContinuousBatcher(model, batch_slots=2, capacity=32)
    reqs = [cb.submit(rng.integers(0, cfg.vocab_size, 5 + i
                                   ).astype(np.int32), 3 + i)
            for i in range(5)]
    finished = cb.run_until_drained()
    assert len(finished) == 5
    st = cb.stats()
    assert st["queued"] == 0 and st["active"] == 0
    assert st["mean_ttft_s"] >= 0.0
    for r in finished:
        assert len(r.out_tokens) == r.max_new


def _pair(arch):
    cfg = get_smoke_config(arch)
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(build_model(cfg, device="cpu"),
                                 jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_batcher_tokens_equal_the_reference(arch, rng):
    """Same weights, prompts and slots: the same tokens per request.  The
    batcher's cache is bf16 (``cache_shapes``) under f32 compute, and an
    SSM conv tail widens to f32 at the first decode, in both."""
    cfg, ref, params, port = _pair(arch)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 9, 20)]
    batchers = [RefBatcher(ref, params, batch_slots=2, capacity=40),
                ContinuousBatcher(port, batch_slots=2, capacity=40)]
    out = []
    for cb in batchers:
        for i, p in enumerate(prompts):
            cb.submit(p, 4 + i)
        out.append({r.rid: r.out_tokens for r in cb.run_until_drained()})
        assert cb.stats()["finished"] == 4
    assert out[1] == out[0]
    assert batchers[1].steps == batchers[0].steps
    for key, group in batchers[0].cache.items():
        for name, t in group.items():
            assert batchers[1].cache[key][name].dtype == \
                getattr(torch, str(t.dtype)), (key, name)


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-1.5-large-398b"])
def test_greedy_generate_equals_the_reference(arch, rng):
    cfg, ref, params, port = _pair(arch)
    prompts = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(ref_greedy(ref, params, jnp.asarray(prompts), 6))
    got = greedy_generate(port, torch.from_numpy(prompts), 6)
    assert got.tolist() == want.tolist()


def test_serve_steps(setup, rng):
    """The steps are the model's prefill and decode with the argmax of
    their logits (the prefill cache fits the prompt exactly, as in the
    reference, so one decode step follows it here)."""
    cfg, model = setup
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    cache, logits, nxt = make_prefill_step(model)(prompts)
    c2, lg2 = model.prefill(prompts)
    assert torch.equal(logits, lg2)
    assert torch.equal(nxt, torch.argmax(logits, -1))
    cache, logits, nxt2 = make_decode_step(model)(cache, nxt[:, None], 7)
    c2, lg2 = model.decode_step(c2, nxt[:, None], 7)
    assert torch.equal(logits, lg2)
    assert torch.equal(nxt2, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab_size)
