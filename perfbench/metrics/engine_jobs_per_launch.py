"""Hash jobs per kernel launch of the offload engine over the window
(its counters' deltas): how much its coalescing fused."""


def read(run):
    before, after = run.counters.get("before"), run.counters.get("after")
    if not before or not after:
        return None
    launches = after["launches"] - before["launches"]
    if launches <= 0:
        return None
    return (after["jobs"] - before["jobs"]) / launches
