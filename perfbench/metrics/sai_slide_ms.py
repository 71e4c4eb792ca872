"""``sai/chunk/slide`` in ms per write: the window-hash job of
content-defined chunking, from its submission to the hashes in offset
order on the host."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/chunk/slide")
