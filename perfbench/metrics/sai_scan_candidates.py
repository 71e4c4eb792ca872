"""Boundary candidates the host walked a write: the mean ``candidates``
meta of the ``sai/chunk/scan`` spans (the candidates the card returned,
or the host's rule test found, for the walk over them).  None where the
program's scan spans carry no such meta."""


def read(run):
    found = [meta["candidates"] for name, _, _, _, meta in run.span_records
             if name == "sai/chunk/scan" and "candidates" in meta]
    return sum(found) / len(found) if found else None
