"""MB copied into the offload engine's direct staging per write over the
window: the delta of its ``direct_staged_bytes`` counter (packed rows
and spans jobs' images alike) over the writes done.  None where the
engine has no such counter."""


def read(run):
    before, after = run.counters.get("before"), run.counters.get("after")
    if not before or not after or "direct_staged_bytes" not in after \
            or run.ops_done <= 0:
        return None
    return (after["direct_staged_bytes"]
            - before.get("direct_staged_bytes", 0)) / 1e6 / run.ops_done
