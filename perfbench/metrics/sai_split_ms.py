"""``sai/chunk/split`` in ms per write: the image cut into one ``bytes``
object a chunk (``chunking.split_chunks``)."""
from perfbench.metrics._per_write import span_ms_per_write


def read(run):
    return span_ms_per_write(run, "sai/chunk/split")
