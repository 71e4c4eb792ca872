"""Merkle-tree integrity over block digests.

The paper positions hashing for "data integrity checks" as a primary use
(the *different* workload evaluates exactly that configuration).  This
module adds file-level integrity on top of per-block digests: a Merkle
tree whose leaves are the block digests; the root commits the full file
and membership proofs verify single blocks without refetching the file.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple


def _h(x: bytes) -> bytes:
    return hashlib.md5(x).digest()


def merkle_root(leaves: List[bytes]) -> bytes:
    if not leaves:
        return _h(b"")
    level = [_h(b"leaf" + l) for l in leaves]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            a = level[i]
            b = level[i + 1] if i + 1 < len(level) else a
            nxt.append(_h(b"node" + a + b))
        level = nxt
    return level[0]


def merkle_proof(leaves: List[bytes], index: int) -> List[Tuple[bool, bytes]]:
    """Returns [(is_right_sibling, digest), ...] path to the root."""
    level = [_h(b"leaf" + l) for l in leaves]
    proof = []
    idx = index
    while len(level) > 1:
        sib = idx ^ 1
        if sib >= len(level):
            sib = idx
        proof.append((sib > idx, level[sib]))
        nxt = []
        for i in range(0, len(level), 2):
            a = level[i]
            b = level[i + 1] if i + 1 < len(level) else a
            nxt.append(_h(b"node" + a + b))
        level = nxt
        idx //= 2
    return proof


def merkle_proofs(leaves: List[bytes],
                  indices: List[int]) -> dict:
    """Membership proofs for several leaves from ONE tree build —
    {index: proof} with each proof identical to ``merkle_proof(leaves,
    index)``.  A ranged read covering k of n blocks pays O(n + k log n)
    instead of k full O(n) rebuilds."""
    levels = [[_h(b"leaf" + l) for l in leaves]]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        nxt = []
        for i in range(0, len(cur), 2):
            a = cur[i]
            b = cur[i + 1] if i + 1 < len(cur) else a
            nxt.append(_h(b"node" + a + b))
        levels.append(nxt)
    out = {}
    for index in indices:
        proof = []
        idx = index
        for level in levels[:-1]:
            sib = idx ^ 1
            if sib >= len(level):
                sib = idx
            proof.append((sib > idx, level[sib]))
            idx //= 2
        out[index] = proof
    return out


def merkle_verify(leaf: bytes, index: int, proof: List[Tuple[bool, bytes]],
                  root: bytes) -> bool:
    cur = _h(b"leaf" + leaf)
    for is_right, sib in proof:
        cur = _h(b"node" + cur + sib) if is_right else _h(b"node" + sib + cur)
    return cur == root
