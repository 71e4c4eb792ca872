"""``sai/chunk/scan`` in ms per write: the host's boundary scan over the
window hashes (``chunking.select_boundaries``)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/chunk/scan")
