"""Traffic: the checkpoint series and the order of operations, made from
the seed and a traffic file's parameters.

``checkpoint_series`` is the repository's checkpoint workload
(``benchmarks/common.py:checkpoint_series``, copied, not imported): each
version rewrites a contiguous ``change_frac`` of the previous one in
place and applies an insert/delete pair of 1..``indel_max`` bytes, so the
content between the two points shifts (what defeats fixed-block dedup).
The random draws are the original's, in its order, so a seed gives the
same bytes; only the copies are fewer.  Every version has the first
one's length, so every seed writes the same sizes.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def checkpoint_series(versions: int, image_bytes: int,
                      change_frac: float, indel_max: int,
                      seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, image_bytes, dtype=np.uint8)
    out = [img]
    span = int(image_bytes * change_frac)
    for _ in range(1, versions):
        start = int(rng.integers(0, image_bytes - span))
        rewrite = rng.integers(0, 256, span, dtype=np.uint8)
        k = int(rng.integers(1, indel_max + 1))
        ins = int(rng.integers(0, image_bytes))
        grown = np.empty(image_bytes + k, np.uint8)
        grown[:ins] = img[:ins]
        grown[ins:ins + k] = rng.integers(0, 256, k, dtype=np.uint8)
        grown[ins + k:] = img[ins:]
        # the rewrite came before the insert: its bytes at or past the
        # insert point sit k bytes later
        cut = min(max(ins - start, 0), span)
        grown[start:start + cut] = rewrite[:cut]
        grown[start + cut + k:start + span + k] = rewrite[cut:]
        del_at = int(rng.integers(0, image_bytes))
        img = np.concatenate([grown[:del_at], grown[del_at + k:]])
        out.append(img)
    return out


def series_of(traffic: Dict, seed: int) -> List[np.ndarray]:
    s = traffic["series"]
    return checkpoint_series(s["versions"], s["image_bytes"],
                             s["change_frac"], s["indel_max"], seed)


def op_versions(traffic: Dict, seed: int) -> Iterator[int]:
    """Version of each timed operation, in order: writes go through the
    lap in order; reads draw a version uniformly from the seed."""
    n = traffic["series"]["versions"]
    if traffic["op"] == "write":
        i = 0
        while True:
            yield i % n
            i += 1
    rng = np.random.default_rng([seed, 1])
    while True:
        yield int(rng.integers(0, n))
