"""MB/s of the bytes the traffic submitted, in writes that resolved, over
the whole window: first submission to the last completion, host clock
(not the size the program reports, which the check compares)."""


def read(run):
    if run.op != "write" or run.ops_done == 0:
        return None
    return run.bytes_done / (run.t1 - run.t0) / 1e6
