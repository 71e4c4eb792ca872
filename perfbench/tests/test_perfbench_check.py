"""The comparison's pieces on synthetic answers: the replica check, the
byte comparison, the write and read counts, and the checker thread."""
import numpy as np
import pytest

import _perfbench_small  # noqa: F401  (puts the checkout on the path)
from perfbench import check, harness, reference

IMG = np.arange(40, dtype=np.uint8)
SERIES = [IMG, IMG[::-1].copy()]


def _store(series, ends, nodes=(0, 1)):
    """A block map of each version at ``ends`` and a node table holding
    one shared object per block on ``nodes``, as the program stores."""
    table, maps = {n: {} for n in range(4)}, {}
    for v, img in enumerate(series):
        bm, start = [], 0
        for e in ends:
            data = img[start:e].tobytes()
            d = reference.block_digest(data)
            for n in nodes:
                table[n].setdefault(d, data)
            bm.append((d, e - start, tuple(nodes)))
            start = e
        maps[v] = bm
    return maps, table


def _fetch(table):
    return lambda nid, digest: table[nid].get(digest)


def test_sound_store_has_no_replica_faults():
    maps, table = _store(SERIES, [16, 33, 40])
    assert check.replicas(maps, SERIES, 2, _fetch(table)) == 0


@pytest.mark.parametrize("fault,want", [
    ("one copy altered", 1), ("one copy missing", 1),
    ("one node for both", 3), ("every copy altered", 1)])
def test_replica_faults(fault, want):
    maps, table = _store(SERIES, [16, 33, 40])
    d = maps[0][1][0]
    if fault == "one copy altered":
        table[1][d] = b"\0" + table[1][d][1:]
    elif fault == "one copy missing":
        del table[0][d]
    elif fault == "one node for both":
        maps[1] = [(dg, n, (0, 0)) for dg, n, _ in maps[1]]
    else:
        table[0][d] = table[1][d] = b"\1" + table[0][d][1:]
    assert check.replicas(maps, SERIES, 2, _fetch(table)) == want


def test_failed_write_has_no_map_to_check():
    maps, table = _store(SERIES, [16, 40])
    maps[1] = None
    assert check.replicas(maps, SERIES, 2, _fetch(table)) == 0


def test_same_bytes_in_steps(monkeypatch):
    monkeypatch.setattr(check, "STEP", 7)
    assert check.same_bytes(IMG.tobytes(), IMG)
    bad = bytearray(IMG.tobytes())
    bad[-1] ^= 1
    assert not check.same_bytes(bytes(bad), IMG)
    assert not check.same_bytes(IMG.tobytes()[:-1], IMG)


def _writes(counts):
    bm = [(reference.block_digest(IMG[:40].tobytes()), 40, (0, 1))]
    done = [{"version": 0, "counts": counts, "block_map": check.kept(bm)}]
    return check.writes(done, {0: [40]}, {0: [bm[0][0]]}, {0: (1, 0, 40)},
                        SERIES)


@pytest.mark.parametrize("counts,number", [
    ((1, 0, 40, 40), None), ((1, 0, 40, 80), "size_mismatch"),
    ((0, 1, 0, 40), "dedup_mismatch"), (None, "ops_failed")])
def test_write_counts(counts, number):
    out = _writes(counts)
    assert {k for k, v in out.items() if v} == ({number} if number else set())


def test_every_read_is_compared():
    done = [{"version": 0, "length": 40, "same": True},
            {"version": 1, "length": 40, "same": False},
            {"version": 1, "length": 39, "same": False},
            {"version": 0, "length": None, "same": False}]
    assert check.reads(done, SERIES) == {
        "ops_failed": 1, "read_length_mismatch": 1, "read_byte_mismatch": 2}


def test_checker_counts_and_blames():
    c = harness.Checker(depth=1)
    rec = {"same": False}
    c.put(None, harness.compare_read, rec, IMG.tobytes(), IMG)
    c.put("replica_faults", lambda: {"replica_faults": 2})
    c.put("replica_faults", lambda: 1 / 0)
    c.put(None, lambda: 1 / 0)
    assert c.close() == {"replica_faults": 3}
    assert rec["same"]
