"""Mean ``sai/hash`` span in ms: the hash stage (packing, the engine's
digests) per write."""


def read(run):
    return run.mean_span_ms("sai/hash")
