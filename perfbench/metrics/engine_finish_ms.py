"""``engine/finish`` in ms per write: the offload engine cutting each
job's result out of the launch's output (for window hashes, the phase
interleave into offset order) and retiring the launch, for every launch
of the traced writes, a fused launch counted once."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "engine/finish", distinct=True)
