"""Mean ``sai/fetch`` span in ms: the fetch stage (every block from a node)
per read."""


def read(run):
    return run.mean_span_ms("sai/fetch")
