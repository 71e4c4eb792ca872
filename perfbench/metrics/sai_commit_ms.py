"""``sai/store/commit`` in ms per write: the block map built (waiting on
blocks that other writers claimed) and committed (``commit_blockmap``,
with the durable wait where there is one)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/store/commit")
