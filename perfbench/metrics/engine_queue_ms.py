"""Mean ``engine/queue`` span in ms: a hash job's wait in the offload
engine's queue, per job."""


def read(run):
    return run.mean_span_ms("engine/queue")
