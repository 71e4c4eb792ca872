"""The serving plane of ``repro_torch`` against the JAX package's
``repro`` on the same seeded inputs: wire frames and auth tokens byte for
byte, a client of each package against the other's TCP server, the
exporters and health verdicts, scrub and repair counts, and durable
stores reopened across the packages.  The reference runs its engine as
its own tests do (Pallas in interpret mode on the CPU); the port runs a
``CrystalGPU`` over ``torch.device("cpu")``."""
import dataclasses
import math
import shutil
import types

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.obs as ref_obs
import repro.obs.timeseries as ref_timeseries
import repro.serve.auth as ref_auth
import repro.serve.storage_client as ref_client
import repro.serve.storage_service as ref_svc
import repro.serve.transport as ref_transport
import repro_torch.core as core
import repro_torch.obs as obs
import repro_torch.obs.timeseries as timeseries
import repro_torch.serve.auth as auth
import repro_torch.serve.storage_client as client_mod
import repro_torch.serve.storage_service as svc
import repro_torch.serve.transport as transport

CPU = torch.device("cpu")
SAI_KW = dict(ca="fixed", block_size=4096, avg_chunk=4096, min_chunk=1024,
              max_chunk=16384)
SECRETS = {"acme": b"acme-secret", "globex": b"globex-secret"}


@pytest.fixture(scope="module")
def engines():
    ref_eng = ref_core.CrystalTPU()
    eng = core.CrystalGPU(devices=[CPU])
    yield ref_eng, eng
    ref_eng.shutdown()
    eng.shutdown()


# the two packages side by side: their modules, the SAI hasher that goes
# through the engine, and the engine's index in the engines fixture
PKGS = {
    "reference": types.SimpleNamespace(
        core=ref_core, svc=ref_svc, auth=ref_auth, client=ref_client,
        transport=ref_transport, hasher="tpu", eng=0),
    "port": types.SimpleNamespace(
        core=core, svc=svc, auth=auth, client=client_mod,
        transport=transport, hasher="gpu", eng=1),
}


def _gateway(pkg, eng, **kw):
    cfg = pkg.svc.GatewayConfig(
        sai=pkg.core.SAIConfig(hasher=pkg.hasher, **SAI_KW), **kw)
    mgr = None if cfg.data_dir else \
        pkg.core.make_store(4, replication=2)[0]
    return pkg.svc.StorageGateway(mgr, engine=eng, config=cfg)


# ----------------------------------------------------------------------
# wire codec
# ----------------------------------------------------------------------
def _request_fields(op, rng):
    path = f"/p/{int(rng.integers(0, 1000))}"
    if op == svc.OP_OPEN:
        return dict(tenant="acme", qos="batch",
                    weight=float(rng.uniform(0.5, 4.0)),
                    token=rng.bytes(int(rng.integers(0, 120))))
    if op == svc.OP_WRITE:
        return dict(path=path, data=rng.bytes(int(rng.integers(0, 5000))),
                    trace=int(rng.integers(1, 2 ** 62)))
    if op == svc.OP_READ:
        return dict(path=path, version=int(rng.integers(-1, 9)),
                    verify=bool(rng.integers(0, 2)),
                    trace=int(rng.integers(1, 2 ** 62)))
    if op in (svc.OP_DELETE, svc.OP_STAT):
        return dict(path=path)
    return {}


def _response_fields(op, rng):
    n = lambda: int(rng.integers(0, 2 ** 31))   # noqa: E731
    return {svc.OP_OPEN: dict(session=n()),
            svc.OP_WRITE: dict(total_bytes=n(), new_bytes=n(),
                               new_blocks=n(), dup_blocks=n()),
            svc.OP_READ: dict(data=rng.bytes(int(rng.integers(0, 5000)))),
            svc.OP_DELETE: dict(orphans=n()),
            svc.OP_STAT: dict(versions=n(), total_len=n(), blocks=n()),
            svc.OP_CLOSE: {},
            svc.OP_STATS: dict(data=b'{"frames": 3}'),
            svc.OP_HEALTH: dict(data=b'{"status": "ok"}')}[op]


def test_codec_constants_equal():
    for name in ("OP_NAMES", "QOS_LANES", "MAX_FRAME_BYTES", "ST_OK",
                 "ST_RETRY", "ST_ERROR"):
        assert getattr(svc, name) == getattr(ref_svc, name), name


@pytest.mark.parametrize("op", sorted(svc.OP_NAMES),
                         ids=lambda op: svc.OP_NAMES[op])
def test_request_and_response_frames_byte_identical(op):
    rng = np.random.default_rng(100 + op)
    for _ in range(4):
        f = _request_fields(op, rng)
        sid = int(rng.integers(0, 2 ** 32))
        rid = int(rng.integers(0, 2 ** 63))
        frame = svc.encode_request(op, sid, rid, **f)
        assert frame == ref_svc.encode_request(op, sid, rid, **f)
        assert svc.decode_request(frame) == ref_svc.decode_request(frame) \
            == (op, sid, rid, f)
        rf = _response_fields(op, rng)
        for status, fields in ((svc.ST_OK, rf),
                               (svc.ST_RETRY, dict(reason="over budget")),
                               (svc.ST_ERROR, dict(errtype="ValueError",
                                                   msg="bad"))):
            frame = svc.encode_response(status, op, rid, **fields)
            assert frame == ref_svc.encode_response(status, op, rid,
                                                    **fields)
            assert svc.decode_response(frame) == \
                ref_svc.decode_response(frame) == (status, op, rid, fields)


# ----------------------------------------------------------------------
# tenant auth
# ----------------------------------------------------------------------
@pytest.mark.parametrize("minter,verifier", [("reference", "port"),
                                             ("port", "reference")])
def test_tokens_cross_verify_and_fail_alike(minter, verifier):
    mint = PKGS[minter].auth.mint_token
    va = PKGS[verifier].auth
    nonce = bytes(range(16))
    tok = mint("acme", SECRETS["acme"], ttl_s=5.0, now=1000.0, nonce=nonce)
    assert tok == PKGS[verifier].auth.mint_token(
        "acme", SECRETS["acme"], ttl_s=5.0, now=1000.0, nonce=nonce)
    assert va.parse_token(tok)[:3] == ("acme", 1005.0, nonce)
    gate = va.TokenAuthenticator(SECRETS)
    assert gate.verify(tok, claimed="acme", now=1001.0) == "acme"
    with pytest.raises(va.AuthError):                     # replayed
        gate.verify(tok, now=1002.0)
    with pytest.raises(va.AuthError):                     # forged
        gate.verify(mint("acme", b"wrong", now=1000.0), now=1001.0)
    with pytest.raises(va.AuthError):                     # expired
        gate.verify(mint("acme", SECRETS["acme"], ttl_s=-1, now=1000.0),
                    now=1000.0)
    with pytest.raises(va.AuthError):                     # wrong tenant
        gate.verify(mint("globex", SECRETS["globex"], now=1000.0),
                    claimed="acme", now=1001.0)
    # a fresh token of the live clock verifies too
    assert gate.verify(mint("globex", SECRETS["globex"])) == "globex"


# ----------------------------------------------------------------------
# a client of one package against the other's TCP server
# ----------------------------------------------------------------------
@pytest.mark.parametrize("server,client", [("port", "reference"),
                                           ("reference", "port")])
def test_cross_package_tcp_roundtrip(engines, rng, server, client):
    spkg, cpkg = PKGS[server], PKGS[client]
    gw = _gateway(spkg, engines[spkg.eng],
                  auth=spkg.auth.TokenAuthenticator(SECRETS))
    srv = spkg.transport.GatewayServer(gw)
    try:
        addr = "%s:%d" % srv.address
        data = rng.integers(0, 256, 5 * 4096, dtype=np.uint8).tobytes()
        v2 = bytearray(data)
        v2[2 * 4096:2 * 4096 + 100] = bytes(100)
        v2 = bytes(v2)
        with pytest.raises(cpkg.auth.AuthError):
            cpkg.client.GatewayClient(addr, "acme", secret=b"wrong")
        with pytest.raises(cpkg.auth.AuthError):
            cpkg.client.GatewayClient(addr, "acme", token=cpkg.auth
                                      .mint_token("acme", SECRETS["acme"],
                                                  ttl_s=-1))
        c = cpkg.client.GatewayClient(addr, "acme", qos="batch",
                                      secret=SECRETS["acme"])
        w1 = c.write("/f", data)
        w2 = c.write("/f", v2)
        assert (w1["total_bytes"], w1["new_blocks"], w1["dup_blocks"]) \
            == (len(data), 5, 0)
        assert (w2["new_blocks"], w2["dup_blocks"], w2["new_bytes"]) \
            == (1, 4, 4096)
        assert c.read("/f", version=0) == data
        assert c.read("/f") == v2
        assert c.stat("/f") == {"versions": 2, "total_len": len(v2),
                                "blocks": 5}
        assert c.stats()["frames"] >= 6
        assert c.health()["status"] in ("ok", "warn", "critical")
        assert c.delete("/f") == 6
        with pytest.raises(FileNotFoundError):
            c.stat("/f")
        c.close()
    finally:
        # the JAX package's server waits out this timeout for its accept
        # thread, which closing the listener does not wake on Linux
        srv.close(timeout_s=2.0)
        gw.close()


# ----------------------------------------------------------------------
# exporters and health verdicts
# ----------------------------------------------------------------------
def _tree(rng):
    return {"engine": {"launches": int(rng.integers(0, 1e6)),
                       "per_device": {0: {"slowdown": 1.5, "p50": 1e-3},
                                      1: {"slowdown": float("nan")}}},
            "tenants": {"a/b c": {"bytes_in": 7, "qos": "batch",
                                  "ok": True},
                        "t=1": {"x": -math.inf, "y": math.inf}},
            "obs": {"qos": {"batch": {"buckets": [0, 3, 0, 5]}}},
            "list": [1, 2.5, "s"], "none": None,
            "f": float(rng.normal())}


def test_flatten_prometheus_and_truncation_identical(engines, rng):
    tree = _tree(np.random.default_rng(7))
    flat, ref_flat = obs.flatten(tree), ref_obs.flatten(tree)
    assert repr(sorted(flat.items())) == repr(sorted(ref_flat.items()))
    assert obs.prometheus_text(tree) == ref_obs.prometheus_text(tree)
    assert obs.prometheus_text(tree, namespace="x") == \
        ref_obs.prometheus_text(tree, namespace="x")
    assert obs.truncate_tree(tree, 300) == ref_obs.truncate_tree(tree, 300)
    # and a live stats tree of the port's gateway
    gw = _gateway(PKGS["port"], engines[1])
    try:
        c = client_mod.GatewayClient(gw, "acme")
        c.write("/f", rng.integers(0, 256, 4096, np.uint8).tobytes())
        live = gw.snapshot_stats()
        text = obs.prometheus_text(live)
        assert text == ref_obs.prometheus_text(live)
        assert "# TYPE repro_engine_launches counter" in text
        c.close()
    finally:
        gw.close()


def _health_series():
    """Stats trees whose windows trip every rule: a stale unparked
    heartbeat, a straggling device, a growing lane and an SLO burn."""
    slo = 0.5
    bad = (int(slo * 1e9) - 1).bit_length() + 1
    out = []
    for step in range(6):
        out.append({
            "wal": {"heartbeats": {"flusher": {
                "age_s": 0.1 + step, "parked": 0, "beats": 5 + step}}},
            "heartbeats": {"scheduler": {"age_s": 0.01, "parked": 1,
                                         "beats": 9}},
            "engine": {"per_device": {
                0: {"slowdown": 1.0 + 2 * step, "launches": 5 * step},
                1: {"slowdown": 1.0, "launches": 5 * step},
                2: {"slowdown": 1.1, "launches": 4 * step}}},
            "queue_depths": {"fg": 2 + 20 * step, "batch": 3},
            "obs": {"qos": {"interactive": {"buckets": {
                bad - 6: 10 * step, bad: 3 * step * (step > 2)}}}},
        })
    return out


def test_health_verdicts_equal_over_one_sample_series(monkeypatch):
    clock = {"t": 100.0}
    fake = types.SimpleNamespace(perf_counter=lambda: clock["t"])
    monkeypatch.setattr(timeseries, "time", fake)
    monkeypatch.setattr(ref_timeseries, "time", fake)
    series = _health_series()
    trees = {"port": {}, "reference": {}}
    runs = {}
    for name, mod in (("port", obs), ("reference", ref_obs)):
        s = mod.MetricsSampler(lambda n=name: trees[n], interval_s=0.25,
                               window_s=2.0)
        runs[name] = (s, mod.HealthEngine(s, mod.HealthConfig(
            stall_after_s=1.5, slo_p99_s={"interactive": 0.5})))
    reports = {"port": [], "reference": []}
    for tree in series:
        clock["t"] += 0.5
        for name, (s, eng) in runs.items():
            trees[name] = tree
            s.sample_once()
            reports[name].append((eng.evaluate(), s.snapshot()))
    assert reports["port"] == reports["reference"]
    rules = {v["rule"] for rep, _ in reports["port"]
             for v in rep["verdicts"]}
    assert rules == {"heartbeat", "straggler", "backlog", "slo"}
    assert reports["port"][-1][0]["status"] == "critical"


# ----------------------------------------------------------------------
# node runtime: scrub and repair
# ----------------------------------------------------------------------
def test_scrub_and_repair_counts_and_replica_sets_equal(engines, rng):
    data = rng.integers(0, 256, 12 * 4096, dtype=np.uint8).tobytes()
    out = {}
    for name, pkg in PKGS.items():
        mgr, nodes = pkg.core.make_store(4, replication=2)
        sai = pkg.core.SAI(mgr, pkg.core.SAIConfig(hasher="cpu", **SAI_KW))
        sai.write("/f", data)
        bad = sorted(mgr.block_registry)[:3]
        for d in bad:                        # one replica of three blocks
            nid = mgr.block_registry[d][0]
            blk = nodes[nid].blocks[d]
            nodes[nid].blocks[d] = bytes([blk[0] ^ 0xFF]) + blk[1:]
        rt = pkg.core.ClusterRuntime(mgr, engine=engines[pkg.eng])
        first = rt.scrub_once()
        placed = rt.repair_once()
        second = rt.scrub_once()
        s = rt.snapshot_stats()
        out[name] = dict(
            first=first, second=second, placed=placed,
            counters={k: s[k] for k in (
                "scrubbed_blocks", "corrupt_found", "repairs_enqueued",
                "repaired_copies", "repair_lost")},
            replicas={d: tuple(locs)
                      for d, locs in mgr.block_registry.items()},
            read=sai.read("/f", verify=True) == data)
        rt.stop()
        sai.close()
    assert out["port"] == out["reference"]
    assert out["port"]["first"] == {"scanned": 24, "corrupt": 3}
    assert out["port"]["second"] == {"scanned": 24, "corrupt": 0}
    assert out["port"]["placed"] == 3 and out["port"]["read"]


# ----------------------------------------------------------------------
# durable stores across the packages
# ----------------------------------------------------------------------
def _report(rep):
    d = dataclasses.asdict(rep)
    d.pop("wall_s")
    return d


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_durable_gateway_store_reopens_across_packages(engines, rng,
                                                       tmp_path, writer,
                                                       reader):
    wpkg, rpkg = PKGS[writer], PKGS[reader]
    kw = dict(n_nodes=3, replication=2)
    base = rng.integers(0, 256, 6 * 4096, dtype=np.uint8).tobytes()
    versions = [base, base[:5000] + rng.bytes(3000) + base[8000:],
                base[4096:] + base[:4096]]
    gw = _gateway(wpkg, engines[wpkg.eng], data_dir=str(tmp_path / "a"),
                  **kw)
    c = wpkg.client.GatewayClient(gw, "acme")
    for v in versions:
        c.write("/ckpt", v)
    c.write("/other", versions[1][:777])
    c.close()
    gw.close()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    reports, reads = {}, {}
    for pkg, d in ((wpkg, "a"), (rpkg, "b")):
        gw = _gateway(pkg, engines[pkg.eng], data_dir=str(tmp_path / d),
                      **kw)
        try:
            reports[d] = _report(gw.recovery_report)
            c = pkg.client.GatewayClient(gw, "acme")
            reads[d] = [c.read("/ckpt", version=v, verify=True)
                        for v in range(len(versions))] \
                + [c.read("/other", verify=True)]
            c.close()
        finally:
            gw.close()
    assert reports["b"] == reports["a"]
    assert reports["b"]["refcount_drift"] == 0
    assert reads["b"] == reads["a"] == versions + [versions[1][:777]]
