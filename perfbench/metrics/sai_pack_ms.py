"""``sai/hash/pack`` in ms per write: the preparation of a write's one
spans job (its chunks' ends over its image, no rows packed), not
``pack_blocks``."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/hash/pack")
