"""``sai/store/claim`` in ms per write: the write's digests pinned and
claimed (``pin_blocks``, ``claim_blocks``)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/store/claim")
