"""MB/s of whole versions returned by verified reads, over the whole
window: first submission to the last completion, host clock."""


def read(run):
    if run.op != "read" or run.ops_done == 0:
        return None
    return run.bytes_done / (run.t1 - run.t0) / 1e6
