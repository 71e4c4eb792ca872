"""``sai/hash/pack`` in ms per write: every ``pack_blocks`` call of a
write's hash submission (chunks copied into zero-padded rows)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/hash/pack")
