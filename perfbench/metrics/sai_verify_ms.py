"""Mean ``sai/verify`` span in ms: the verify stage (the engine's digests
compared) per read."""


def read(run):
    return run.mean_span_ms("sai/verify")
