"""The arithmetic of the readers of the write path's stage spans."""


def span_ms_per_write(run, name, distinct=False):
    """The ``name`` spans' time in ms, summed over the traced writes and
    divided by the writes that got their digests (``sai/hash`` spans).
    With ``distinct`` each (t0, t1) interval counts once: a fused launch
    stamps each of its jobs alike.  None where there is no such span."""
    writes = sum(n == "sai/hash" for n, _, _ in run.spans)
    spans = [(t0, t1) for n, t0, t1 in run.spans if n == name]
    if distinct:
        spans = set(spans)
    if not writes or not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / writes
