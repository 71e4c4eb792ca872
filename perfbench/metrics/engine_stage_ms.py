"""``engine/stage`` in ms per write: the offload engine filling its
pinned staging and enqueueing the H2D, for every launch of the traced
writes (window hashes and digests), a fused launch counted once."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "engine/stage", distinct=True)
