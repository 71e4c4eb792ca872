"""MB/s of the bytes the traffic submitted, in writes that resolved, over
the whole window: first submission to the last completion, host clock,
less the pauses in which the harness checks a lap's stores between laps
with the clock stopped (that check is not in the window).  Not the size
the program reports, which the check compares."""


def read(run):
    if run.op != "write" or run.ops_done == 0:
        return None
    return run.bytes_done / run.window_s / 1e6
