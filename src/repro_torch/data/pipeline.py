"""Deterministic sharded data pipeline.

Batches are a pure function of (seed, step, shard), so a restarted (or
elastically resharded) trainer resumes the exact token stream from its
checkpointed step — the data-side half of fault tolerance.  The token
stream is a Zipf-ish mixture with local n-gram structure so losses
decrease measurably during the example runs (pure uniform noise would
have a constant floor at ln V).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    frontend_embeds: int = 0
    d_model: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards
        # a fixed random unigram table + bigram successor table give the
        # stream learnable structure
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks ** 1.1)
        self._unigram /= self._unigram.sum()
        self._succ = rng.integers(0, V, size=(min(V, 4096),),
                                  dtype=np.int64)

    def _row(self, step: int, global_row: int):
        """One sequence, keyed by (seed, step, GLOBAL row id) — elastic
        resharding re-partitions identical rows across any shard count."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + global_row)
        S, V = self.seq_len, self.vocab_size
        toks = rng.choice(V, size=S, p=self._unigram)
        follow = rng.random(S - 1) < 0.5
        succ = self._succ[toks[:-1] % len(self._succ)]
        toks[1:] = np.where(follow, succ, toks[1:])
        emb = None
        if self.frontend_embeds:
            emb = rng.standard_normal(
                (self.frontend_embeds, self.d_model)).astype(np.float32)
        return toks, emb

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = range(self.shard * self.local_batch,
                     (self.shard + 1) * self.local_batch)
        toks, embs = [], []
        for r in rows:
            t, e = self._row(step, r)
            toks.append(t)
            if e is not None:
                embs.append(e)
        out = {"tokens": np.stack(toks).astype(np.int32)}
        if embs:
            out["embeds"] = np.stack(embs)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_pipeline(cfg, seq_len: int, global_batch: int, seed: int = 0,
                  shard: int = 0, num_shards: int = 1) -> SyntheticTokens:
    F = cfg.frontend_embeds
    return SyntheticTokens(
        vocab_size=cfg.vocab_size,
        seq_len=seq_len - F,
        global_batch=global_batch,
        seed=seed, shard=shard, num_shards=num_shards,
        frontend_embeds=F, d_model=cfg.d_model)
