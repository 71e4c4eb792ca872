"""``sai/store/put`` in ms per write: the replica puts of the blocks a
write claimed (placement, one put per replica, the claim finished)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/store/put")
