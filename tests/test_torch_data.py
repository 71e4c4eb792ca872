"""The port's data pipeline: the JAX package's ``tests/test_data.py``
(restart determinism, shards partitioning the global batch, a learnable
stream, VLM embeddings) by name and assertion, and batches byte-identical
to the JAX package's for the same (config, seed, step, shard)."""
import numpy as np
import pytest

from repro.data import make_pipeline as ref_pipeline
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens, make_pipeline


def test_restart_determinism():
    cfg = get_smoke_config("llama3-8b")
    p1 = make_pipeline(cfg, 64, 4, seed=3)
    p2 = make_pipeline(cfg, 64, 4, seed=3)
    for step in (0, 7, 123):
        np.testing.assert_array_equal(p1.batch(step)["tokens"],
                                      p2.batch(step)["tokens"])


def test_shards_partition_global_batch():
    cfg = get_smoke_config("llama3-8b")
    full = make_pipeline(cfg, 64, 8, num_shards=1).batch(5)["tokens"]
    parts = [make_pipeline(cfg, 64, 8, shard=s, num_shards=4).batch(5)
             ["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_stream_is_learnable_not_uniform():
    cfg = get_smoke_config("llama3-8b")
    p = make_pipeline(cfg, 256, 4)
    toks = p.batch(0)["tokens"]
    counts = np.bincount(toks.ravel(), minlength=cfg.vocab_size)
    # Zipf-ish: top-10 tokens should dominate uniform expectation
    assert counts[np.argsort(-counts)[:10]].sum() > toks.size * 0.2


def test_vlm_embeds_present():
    cfg = get_smoke_config("internvl2-2b")
    p = make_pipeline(cfg, 64, 2)
    b = p.batch(0)
    assert b["embeds"].shape == (2, cfg.frontend_embeds, cfg.d_model)
    assert b["tokens"].shape == (2, 64 - cfg.frontend_embeds)


@pytest.mark.parametrize("arch,seq,batch,seed,shard,num_shards", [
    ("llama3-8b", 64, 4, 0, 0, 1),
    ("llama3-8b", 128, 8, 3, 2, 4),
    ("minicpm-2b", 256, 2, 7, 0, 1),
    ("internvl2-2b", 64, 2, 1, 1, 2),
])
def test_batches_byte_identical_to_reference(arch, seq, batch, seed, shard,
                                             num_shards):
    cfg = get_smoke_config(arch)
    port = make_pipeline(cfg, seq, batch, seed=seed, shard=shard,
                         num_shards=num_shards)
    ref = ref_pipeline(cfg, seq, batch, seed=seed, shard=shard,
                       num_shards=num_shards)
    for step in (0, 1, 50, 1234):
        got, want = port.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (k, step)


def test_full_vocab_stream_identical():
    """minicpm-2b's published vocabulary (122753), as the chip run trains
    it: the unigram and successor tables and a row equal the reference's."""
    port = SyntheticTokens(vocab_size=122753, seq_len=512, global_batch=2)
    from repro.data.pipeline import SyntheticTokens as RefTokens
    ref = RefTokens(vocab_size=122753, seq_len=512, global_batch=2)
    assert port._succ.tobytes() == ref._succ.tobytes()
    assert port.batch(9)["tokens"].tobytes() == \
        ref.batch(9)["tokens"].tobytes()
