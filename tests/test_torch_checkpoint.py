"""The port's content-addressable checkpointer
(``repro_torch.train.checkpoint.CACheckpointer``) over ``ca='cdc-gear'``
on ``CrystalGPU(devices=[cpu])``: roundtrip, dedup across steps (the
paper's checkpoint workload), async save raced by an in-place update,
bf16 tensors, and the state it shares with the JAX package's
checkpointer: byte-identical manifests for the same state and durable
stores that either package's checkpointer restores."""
import collections

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from repro.train.checkpoint import CACheckpointer as RefCheckpointer
from repro_torch.train import CACheckpointer

CPU = torch.device("cpu")
# chunk sizes cut from the JAX package's checkpoint tests (16/4/64 KiB)
# so that the plain MD5 on the CPU stays quick
CHUNKS = dict(avg_chunk=4 << 10, min_chunk=1 << 10, max_chunk=8 << 10)
NT = collections.namedtuple("NT", "mu nu")


@pytest.fixture(scope="module")
def engine():
    eng = core.CrystalGPU(devices=[CPU])
    yield eng
    eng.shutdown()


def _ckpt(engine, mgr=None):
    mgr = mgr or core.make_store(3, replication=2)[0]
    sai = core.SAI(mgr, core.SAIConfig(ca="cdc-gear", **CHUNKS),
                   crystal=engine)
    return CACheckpointer(sai), mgr


def _state(rng):
    """Numpy state with every structure the leaf walk names: unsorted
    dict keys, a list, a tuple holding None, a namedtuple, an
    OrderedDict and a scalar."""
    return {"params": {"z": rng.standard_normal((40, 50)).astype(np.float32),
                       "a": [np.arange(300, dtype=np.int32),
                             (rng.standard_normal(7).astype(np.float32),
                              None)],
                       "m": NT(np.ones(3, np.float64), np.zeros(2, np.int64))},
            "opt": collections.OrderedDict([("step", np.int64(9)),
                                            ("lr", np.float32(1e-3))])}


def test_roundtrip(engine):
    ckpt, _ = _ckpt(engine)
    params = {"a": np.arange(1000, dtype=np.float32).reshape(10, 100),
              "b": {"c": torch.ones((3, 3))}}
    ckpt.save(7, params)
    step, state, extra = ckpt.restore()
    assert step == 7 and extra == {}
    assert isinstance(state["params"]["a"], torch.Tensor)
    np.testing.assert_array_equal(state["params"]["a"].numpy(), params["a"])
    assert torch.equal(state["params"]["b"]["c"], params["b"]["c"])


def test_dedup_across_steps(engine, rng):
    """Successive checkpoints dedup on their unchanged regions; an
    identical re-save stores nothing."""
    ckpt, _ = _ckpt(engine)
    big = torch.from_numpy(rng.standard_normal(300_000).astype(np.float32))
    r1 = ckpt.save(0, {"w": big})
    big2 = big.clone()
    big2[:big.numel() // 20] += 0.1
    r2 = ckpt.save(1, {"w": big2})
    assert r1["dedup_ratio"] < 0.05
    assert r2["dedup_ratio"] > 0.7, r2
    r3 = ckpt.save(2, {"w": big2})
    assert r3["new_bytes"] == 0
    _, s0, _ = ckpt.restore(version=0)
    _, s1, _ = ckpt.restore(version=1)
    assert torch.equal(s0["params"]["w"], big)
    assert torch.equal(s1["params"]["w"], big2)
    assert engine.snapshot_stats()["jobs"] > 0


def test_async_save(engine, rng):
    """``async_save`` snapshots the state before it returns: an in-place
    update right after the call does not reach the checkpoint."""
    ckpt, _ = _ckpt(engine)
    params = {"w": torch.from_numpy(
        rng.standard_normal(10_000).astype(np.float32)),
        "opt": [torch.zeros(5)]}
    before = {"w": params["w"].clone(), "opt": params["opt"][0].clone()}
    t = ckpt.async_save(3, params)
    params["w"].add_(1.0)
    params["opt"][0].add_(1.0)
    ckpt.wait()
    assert not t.is_alive()
    step, state, _ = ckpt.restore()
    assert step == 3
    assert torch.equal(state["params"]["w"], before["w"])
    assert torch.equal(state["params"]["opt"]["[0]"], before["opt"])


def test_bf16_roundtrip(engine, rng):
    ckpt, mgr = _ckpt(engine)
    w = torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32)) \
        .to(torch.bfloat16)
    ckpt.save(1, {"w": w, "empty": torch.zeros(0, dtype=torch.bfloat16)})
    _, state, _ = ckpt.restore()
    got = state["params"]["w"]
    assert got.dtype == torch.bfloat16 and got.device == CPU
    assert torch.equal(got, w)
    assert state["params"]["empty"].shape == (0,)
    manifest = ckpt.sai.read("ckpt/MANIFEST").decode()
    assert '"dtype": "bfloat16"' in manifest


def test_manifest_bytes_equal_reference(engine, rng):
    """The same numpy state gives byte-identical MANIFEST payloads: the
    leaf walk names and orders leaves as ``jax.tree_util`` does."""
    state = _state(rng)
    ckpt, _ = _ckpt(engine)
    rmgr, _ = ref_core.make_store(3, replication=2)
    rckpt = RefCheckpointer(ref_core.SAI(
        rmgr, ref_core.SAIConfig(ca="cdc-gear", hasher="cpu", **CHUNKS)))
    for step in (0, 1):
        ckpt.save(step, state["params"], state["opt"], extra={"k": step})
        rckpt.save(step, state["params"], state["opt"], extra={"k": step})
    for v in (0, 1):
        assert ckpt.sai.read("ckpt/MANIFEST", version=v) == \
            rckpt.sai.read("ckpt/MANIFEST", version=v)
    ckpt.save(2, {"z": torch.from_numpy(state["params"]["z"])})
    rckpt.save(2, {"z": state["params"]["z"]})
    assert ckpt.sai.read("ckpt/MANIFEST") == rckpt.sai.read("ckpt/MANIFEST")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_durable_checkpoint_across_packages(tmp_path, engine, rng, writer):
    """A checkpoint one package writes into a durable data_dir is
    recovered by the other package's ``open_durable_store`` and restored
    by its checkpointer with equal arrays."""
    params = {"w": rng.standard_normal((100, 30)).astype(np.float32),
              "b": {"x": np.arange(50, dtype=np.float32)}}
    kw = dict(n_nodes=3, replication=2, flush_interval_s=0)

    def open_ckpt(pkg):
        mgr, _, report = pkg.open_durable_store(str(tmp_path), **kw)
        if pkg is core:
            sai = core.SAI(mgr, core.SAIConfig(ca="cdc-gear", **CHUNKS),
                           crystal=engine)
            return CACheckpointer(sai), mgr, report
        sai = ref_core.SAI(mgr, ref_core.SAIConfig(ca="cdc-gear",
                                                   hasher="cpu", **CHUNKS))
        return RefCheckpointer(sai), mgr, report

    first, second = (ref_core, core) if writer == "reference" \
        else (core, ref_core)
    ckpt, mgr, _ = open_ckpt(first)
    ckpt.save(5, params)
    ckpt.sai.close()
    mgr.close()
    ckpt, mgr, report = open_ckpt(second)
    assert report.refcount_drift == 0 and not report.lost_blocks
    step, state, _ = ckpt.restore()
    assert step == 5
    for got, want in ((state["params"]["w"], params["w"]),
                      (state["params"]["b"]["x"], params["b"]["x"])):
        np.testing.assert_array_equal(np.asarray(got), want)
    ckpt.sai.close()
    mgr.close()
