"""``sai/queue`` in ms per write: from ``write_async``'s entry (before
its copy of the image) to the chunk thread's taking the write up."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/queue")
