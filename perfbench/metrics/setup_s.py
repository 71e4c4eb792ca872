"""Set-up time: process start to the first timed submission (imports,
the series made from the seed, the engine, warm-up), host clock."""


def read(run):
    return run.setup_s
