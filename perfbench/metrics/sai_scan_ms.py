"""``sai/chunk/scan`` in ms per write: the host's greedy walk over the
boundary candidates that the card returned
(``chunking.boundaries_from_candidates``)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/chunk/scan")
