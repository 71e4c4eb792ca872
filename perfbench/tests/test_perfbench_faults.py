"""Whole small runs on the CPU with the timed path broken underneath:
each fault a cell can have makes ``correct`` come out false.  (One card,
so no cell has an exchange between chips to leave out.)"""
import pytest
import torch

from _perfbench_small import RESTORE, WRITE_CDC, WRITE_FIXED, small_run

from repro_torch.core import castore, sai
from repro_torch.kernels import md5, sliding_md5


def _half_batch(monkeypatch):
    """The direct MD5 launch leaves the second half of its rows out."""
    real = md5.md5_words

    def half(words, lens_w, stream=None):
        out = real(words, lens_w, stream=stream).clone()
        out[(out.shape[0] + 1) // 2:] = 0
        return out
    monkeypatch.setattr(md5, "md5_words", half)


def _altered_digest(monkeypatch):
    """One bit of the first digest of every launch flips."""
    real = md5.md5_words

    def flip(words, lens_w, stream=None):
        out = real(words, lens_w, stream=stream).clone()
        out.view(torch.int32)[0, 0] ^= 1
        return out
    monkeypatch.setattr(md5, "md5_words", flip)


def _altered_window_hashes(monkeypatch):
    """Every window hash has its low bit flipped."""
    real = sliding_md5.sliding_md5_words

    def flip(words, w_words, stride, stream=None):
        out = real(words, w_words, stride, stream=stream)
        return (out.view(torch.int32) ^ 1).view(torch.uint32)
    monkeypatch.setattr(sliding_md5, "sliding_md5_words", flip)


def _unchanged_store(monkeypatch):
    """A block put leaves the node as it was."""
    monkeypatch.setattr(castore.StorageNode, "put",
                        lambda self, digest, data: None)


def _altered_read(monkeypatch):
    """A read's bytes change where the read assembles them."""
    real = sai.ReadFuture._resolve

    def flip(self, data):
        real(self, bytes([data[0] ^ 0xFF]) + data[1:])
    monkeypatch.setattr(sai.ReadFuture, "_resolve", flip)


def _stale_read(monkeypatch):
    """Every read is served from the store's first version."""
    real = castore.MetadataManager.get_read_plan
    monkeypatch.setattr(castore.MetadataManager, "get_read_plan",
                        lambda self, path, version=-1: real(self, path, 0))


def _misreported_size(monkeypatch):
    """A write reports twice the bytes it was given."""
    real = sai.WriteFuture._resolve

    def double(self, stats):
        stats.total_bytes *= 2
        real(self, stats)
    monkeypatch.setattr(sai.WriteFuture, "_resolve", double)


WRITE_FAULTS = {"unchanged-state": _unchanged_store,
                "half-batch": _half_batch,
                "altered-answer": _altered_digest}
READ_FAULTS = {"unchanged-state": _stale_read,
               "half-batch": _half_batch,
               "altered-answer": _altered_read}


@pytest.mark.parametrize("workload,fault", [
    *[(w, f) for w in (WRITE_CDC, WRITE_FIXED) for f in WRITE_FAULTS],
    (WRITE_CDC, "altered-window-hashes"),
    (WRITE_FIXED, "misreported-size"),
    *[(RESTORE, f) for f in READ_FAULTS]])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    plant = READ_FAULTS[fault] if workload == RESTORE else \
        {**WRITE_FAULTS,
         "altered-window-hashes": _altered_window_hashes,
         "misreported-size": _misreported_size}[fault]
    plant(monkeypatch)
    r = small_run(workload, seconds=1.0)
    assert not r["correct"], r["checks"]
