"""Mean ``sai/chunk`` span in ms: the chunk stage (boundaries and the
split) per write."""


def read(run):
    return run.mean_span_ms("sai/chunk")
