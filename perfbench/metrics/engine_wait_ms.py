"""``engine/wait`` in ms per write: the offload engine enqueueing the
kernel and waiting for the output's D2H, for every launch of the traced
writes, a fused launch counted once."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "engine/wait", distinct=True)
