"""The port's first slice as a whole: the SAI content-addressable
write/read path of ``repro_torch`` against the JAX package's ``repro``
on the same checkpoint series, plus cross-package durable stores and the
port's standalone contract.  Every comparison is exact: boundaries,
digests, block maps, WAL records and bytes."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core as ref_core
import repro.core.castore as ref_castore
import repro_torch.core as core
import repro_torch.core.castore as castore
from benchmarks.common import checkpoint_series
from repro_torch.core.sai import block_digest_cpu

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(block_size=4096, avg_chunk=4096, min_chunk=1024,
             max_chunk=8192, window=48, stride=4)


@pytest.fixture(scope="module")
def series():
    return checkpoint_series(3, 32 << 10, change_frac=0.15, seed=0)


@pytest.fixture(scope="module")
def engines():
    ref_eng = ref_core.CrystalTPU()
    eng = core.CrystalGPU(devices=[CPU])
    yield ref_eng, eng
    ref_eng.shutdown()
    eng.shutdown()


def _write_all(sai, series):
    futs = [sai.write_async("/ckpt", img) for img in series]
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("ca", ["fixed", "cdc"])
def test_slice_matches_reference(series, engines, ca):
    """Reference SAI + CrystalTPU and port SAI + CrystalGPU(cpu) on the
    same series: equal boundaries, block maps (digest, length,
    replicas), WAL commit records, WriteStats counts and read bytes."""
    ref_eng, eng = engines
    rmgr, _ = ref_core.make_store(4, replication=2)
    pmgr, _ = core.make_store(4, replication=2)
    rsai = ref_core.SAI(rmgr, ref_core.SAIConfig(ca=ca, **SMALL),
                        crystal=ref_eng)
    psai = core.SAI(pmgr, core.SAIConfig(ca=ca, **SMALL), crystal=eng)
    try:
        for img in series:
            assert psai._boundaries(img) == rsai._boundaries(img)
        rstats, pstats = _write_all(rsai, series), _write_all(psai, series)
        for r, p in zip(rstats, pstats):
            assert (p.total_bytes, p.new_bytes, p.new_blocks,
                    p.dup_blocks) == (r.total_bytes, r.new_bytes,
                                      r.new_blocks, r.dup_blocks)
        assert pstats[1].dup_blocks > 0          # the series dedups
        for v, img in enumerate(series):
            rfv, pfv = rmgr.files["/ckpt"][v], pmgr.files["/ckpt"][v]
            assert [(b.digest, b.length, b.nodes) for b in pfv.blocks] == \
                [(b.digest, b.length, b.nodes) for b in rfv.blocks]
            assert pfv.merkle_root == rfv.merkle_root
            # same record bytes once the commit times agree
            same_time = dataclasses.replace(pfv, timestamp=rfv.timestamp)
            assert castore.enc_commit("/ckpt", same_time) == \
                ref_castore.enc_commit("/ckpt", rfv)
            assert psai.read("/ckpt", version=v) == img
            assert rsai.read("/ckpt", version=v) == img
        for digest, locs in pmgr.block_registry.items():
            assert block_digest_cpu(pmgr.nodes[locs[0]].get(digest)) == \
                digest
    finally:
        rsai.close()
        psai.close()


def test_write_async_equals_sync(series, engines):
    _, eng = engines
    results = []
    for use_async in (False, True):
        mgr, _ = core.make_store(4)
        sai = core.SAI(mgr, core.SAIConfig(ca="fixed", **SMALL),
                       crystal=eng)
        stats = _write_all(sai, series) if use_async else \
            [sai.write("/ckpt", img) for img in series]
        results.append(([(s.new_blocks, s.dup_blocks) for s in stats],
                        [[b.digest for b in fv.blocks]
                         for fv in mgr.files["/ckpt"]]))
        sai.close()
    assert results[0] == results[1]


def test_corrupt_replica_is_refetched(series, engines):
    _, eng = engines
    mgr, nodes = core.make_store(4, replication=2)
    sai = core.SAI(mgr, core.SAIConfig(ca="fixed", **SMALL), crystal=eng)
    sai.write("/f", series[0])
    digest = mgr.files["/f"][0].blocks[0].digest
    nid = mgr.block_registry[digest][0]
    blk = nodes[nid].blocks[digest]
    nodes[nid].blocks[digest] = bytes([blk[0] ^ 0xFF]) + blk[1:]
    assert sai.read("/f") == series[0]
    assert sai.read_stats["refetches"] == 1
    assert mgr.is_quarantined(digest, nid)


def test_hasher_alias_and_gear_gate(series, engines):
    _, eng = engines
    assert core.SAIConfig().hasher == "gpu"
    digests = []
    for hasher in ("gpu", "tpu"):
        mgr, _ = core.make_store(2)
        sai = core.SAI(mgr, core.SAIConfig(ca="cdc", hasher=hasher,
                                           **SMALL), crystal=eng)
        sai.write("/f", series[0])
        digests.append([b.digest for b in mgr.files["/f"][0].blocks])
    assert digests[0] == digests[1]
    mgr, _ = core.make_store(2)
    sai = core.SAI(mgr, core.SAIConfig(ca="cdc-gear", **SMALL), crystal=eng)
    with pytest.raises(NotImplementedError, match="gear"):
        sai.write("/g", series[0])
    # the CPU baseline keeps gear CDC, equal to the reference's
    cpu = core.SAI(mgr, core.SAIConfig(ca="cdc-gear", hasher="cpu",
                                       **SMALL))
    rcpu = ref_core.SAI(ref_core.make_store(2)[0],
                        ref_core.SAIConfig(ca="cdc-gear", hasher="cpu",
                                           **SMALL))
    assert cpu._boundaries(series[1]) == rcpu._boundaries(series[1])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_durable_store_recovers_across_packages(tmp_path, series, engines,
                                                writer):
    """A data_dir written by one package is recovered and read, with
    verification, by the other: WAL frames and segment records are
    byte-compatible."""
    _, eng = engines
    pkgs = {"reference": (ref_core, dict(hasher="cpu"), None),
            "port": (core, {}, eng)}
    reader = "port" if writer == "reference" else "reference"
    wpkg, wkw, weng = pkgs[writer]
    rpkg, rkw, reng = pkgs[reader]
    kw = dict(n_nodes=3, replication=2, flush_interval_s=0)
    mgr, _, _ = wpkg.open_durable_store(str(tmp_path), **kw)
    sai = wpkg.SAI(mgr, wpkg.SAIConfig(ca="cdc", **SMALL, **wkw),
                   crystal=weng)
    for img in series:
        sai.write("/ckpt", img)
    sai.close()
    mgr.close()
    mgr, _, report = rpkg.open_durable_store(str(tmp_path), **kw)
    assert report.refcount_drift == 0 and not report.lost_blocks
    sai = rpkg.SAI(mgr, rpkg.SAIConfig(ca="cdc", **SMALL, **rkw),
                   crystal=reng)
    for v, img in enumerate(series):
        assert sai.read("/ckpt", version=v, verify=True) == img
    sai.close()
    mgr.close()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert bad == []


def test_chip_smoke_needs_a_card_and_keeps_the_series_generator():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for a, b in zip(chip_smoke.checkpoint_series(3, 8192, seed=5),
                    checkpoint_series(3, 8192, seed=5)):
        assert a == b
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
