"""``sai/store/unpin`` in ms per write: the write's digests unpinned
(``unpin_blocks``)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/store/unpin")
