"""The port's TCP socket transport + tenant auth for the gateway
(``repro_torch.serve.transport``, ``repro_torch.serve.auth``) on a
``CrystalGPU`` over ``torch.device("cpu")``.  The cases and their
assertions mirror the JAX package's ``tests/test_transport.py``.

Acceptance coverage: a GatewayServer on localhost TCP serves concurrent
GatewayClient connections from separate threads with full
open -> write -> read -> stat -> close round-trips; forged/expired/
replayed open tokens are rejected with ST_ERROR; the engine shows
cross-connection coalescing (launches < jobs) for a multi-client burst
over the socket; and the connection lifecycle holds up — half-close
still drains responses, abrupt disconnects resolve in-flight futures
with ST_ERROR instead of hanging, and hostile length prefixes are
refused before any allocation.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import CrystalGPU, SAIConfig, make_store
from repro_torch.serve import storage_service as svc
from repro_torch.serve.auth import (AuthError, TokenAuthenticator,
                                    mint_token, parse_token)
from repro_torch.serve.storage_client import GatewayClient, RetryLater
from repro_torch.serve.storage_service import GatewayConfig, StorageGateway
from repro_torch.serve.transport import (FrameError, GatewayServer,
                                         SocketChannel, parse_address,
                                         recv_frame, send_frame)

CPU = torch.device("cpu")

SECRETS = {"acme": b"acme-secret", "globex": b"globex-secret",
           "t0": b"s0", "t1": b"s1", "t2": b"s2", "t3": b"s3"}


def _sai_cfg(**kw):
    kw.setdefault("hasher", "gpu")
    return SAIConfig(ca="fixed", block_size=4096, avg_chunk=4096,
                     min_chunk=1024, max_chunk=16384, **kw)


def _served(mgr, engine, auth=True, **kw):
    cfg = dict(sai=_sai_cfg())
    if auth:
        cfg["auth"] = TokenAuthenticator(SECRETS)
    cfg.update(kw)
    gw = StorageGateway(mgr, engine=engine, config=GatewayConfig(**cfg))
    return gw, GatewayServer(gw)


# ----------------------------------------------------------------------
# stream framing primitives
# ----------------------------------------------------------------------
def test_stream_framing_roundtrip_and_hostile_prefix():
    a, b = socket.socketpair()
    try:
        for payload in (b"", b"x", b"y" * 70_000):
            send_frame(a, payload, max_frame_bytes=1 << 20)
            assert recv_frame(b, max_frame_bytes=1 << 20) == payload
        # oversized send refused locally
        with pytest.raises(FrameError):
            send_frame(a, b"z" * 2048, max_frame_bytes=1024)
        # hostile length prefix refused BEFORE allocating
        a.sendall(struct.pack("!I", 1 << 31))
        with pytest.raises(FrameError):
            recv_frame(b, max_frame_bytes=1 << 20)
        # EOF mid-frame
        a.sendall(struct.pack("!I", 10) + b"abc")
        a.close()
        with pytest.raises(FrameError):
            recv_frame(b, max_frame_bytes=1 << 20)
    finally:
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass


def test_parse_address_forms():
    assert parse_address("127.0.0.1:8080") == ("127.0.0.1", 8080)
    assert parse_address("localhost:80") == ("localhost", 80)
    assert parse_address(("h", 1)) == ("h", 1)
    assert parse_address("[::1]:8080") == ("::1", 8080)
    assert parse_address("[fe80::1]:80") == ("fe80::1", 80)
    for bad in ("::1:8080",       # ambiguous unbracketed IPv6
                "nohost", ":80", "h:", "h:not-a-port", "[::1]"):
        with pytest.raises(ValueError):
            parse_address(bad)


def _ipv6_loopback_ok():
    if not socket.has_ipv6:
        return False
    try:
        s = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
        s.bind(("::1", 0))
        s.close()
        return True
    except OSError:
        return False


@pytest.mark.skipif(not _ipv6_loopback_ok(),
                    reason="no IPv6 loopback on this host")
def test_server_serves_ipv6_loopback(rng):
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw = StorageGateway(mgr, engine=eng,
                        config=GatewayConfig(sai=_sai_cfg()))
    server = GatewayServer(gw, host="::1")
    try:
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        client = GatewayClient(f"[::1]:{server.address[1]}", "six")
        client.write("/v6", blob)
        assert client.read("/v6") == blob
        client.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_recv_frame_clean_eof_is_none():
    a, b = socket.socketpair()
    send_frame(a, b"last", max_frame_bytes=1024)
    a.close()
    assert recv_frame(b, max_frame_bytes=1024) == b"last"
    assert recv_frame(b, max_frame_bytes=1024) is None
    b.close()


# ----------------------------------------------------------------------
# acceptance: concurrent clients over localhost TCP
# ----------------------------------------------------------------------
def test_socket_concurrent_clients_full_roundtrips(rng):
    """>= 2 concurrent GatewayClient connections from separate threads,
    each doing open -> write -> read -> stat -> close over TCP, and the
    multi-connection burst coalesces on the shared engine
    (launches < jobs)."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU], coalesce_window_s=0.2)
    gw, server = _served(mgr, eng)
    errors = []
    n_clients, n_files = 4, 3
    blobs = {(i, j): rng.integers(0, 256, 4 * 4096,
                                  dtype=np.uint8).tobytes()
             for i in range(n_clients) for j in range(n_files)}
    start = threading.Barrier(n_clients)

    def lifecycle(i):
        try:
            client = GatewayClient(server, f"t{i}",
                                   secret=SECRETS[f"t{i}"])
            start.wait(timeout=30)
            pending = [(j, client.submit_write(f"/t{i}/{j}",
                                               blobs[i, j]))
                       for j in range(n_files)]
            for j, p in pending:
                assert p.result(120)["new_blocks"] == 4
            for j in range(n_files):
                assert client.read(f"/t{i}/{j}") == blobs[i, j]
                st = client.stat(f"/t{i}/{j}")
                assert st["total_len"] == len(blobs[i, j])
            client.close()
        except BaseException as e:      # surface thread failures
            errors.append((i, repr(e)))

    try:
        s0 = eng.snapshot_stats()
        threads = [threading.Thread(target=lifecycle, args=(i,),
                                    daemon=True)
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        s1 = eng.snapshot_stats()
        jobs = s1["jobs"] - s0["jobs"]
        launches = s1["launches"] - s0["launches"]
        assert jobs >= n_clients * n_files
        assert launches < jobs, (launches, jobs)
        stats = gw.snapshot_stats()
        assert stats["launches"] < stats["jobs"]
        assert len(stats["tenants"]) == n_clients
        assert server.snapshot_stats()["connections"] == n_clients
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_socket_client_by_address_and_string(rng):
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    try:
        host, port = server.address
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        c1 = GatewayClient((host, port), "a")
        c2 = GatewayClient(f"{host}:{port}", "b")
        c1.write("/a", blob)
        assert c2.read("/a") == blob
        assert c2.delete("/a") == 1
        c1.close()
        c2.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


# ----------------------------------------------------------------------
# tenant auth
# ----------------------------------------------------------------------
def test_auth_token_roundtrip_and_parse():
    tok = mint_token("acme", b"k", ttl_s=10.0, now=1000.0,
                     nonce=b"n" * 16)
    tenant, expiry, nonce, _sig, _body = parse_token(tok)
    assert (tenant, expiry, nonce) == ("acme", 1010.0, b"n" * 16)
    for cut in range(len(tok)):
        with pytest.raises(AuthError):
            auth = TokenAuthenticator({"acme": b"k"})
            auth.verify(tok[:cut], now=1000.0)


def test_auth_rejects_forged_expired_replayed_and_mismatched(rng):
    gate = TokenAuthenticator(SECRETS)
    now = time.time()
    assert gate.verify(mint_token("acme", SECRETS["acme"]),
                       claimed="acme") == "acme"
    with pytest.raises(AuthError):                       # forged
        gate.verify(mint_token("acme", b"wrong-secret"))
    with pytest.raises(AuthError):                       # unknown tenant
        gate.verify(mint_token("nobody", b"k"))
    with pytest.raises(AuthError):                       # expired
        gate.verify(mint_token("acme", SECRETS["acme"], ttl_s=5.0,
                               now=now - 100.0))
    with pytest.raises(AuthError):                       # missing
        gate.verify(b"")
    with pytest.raises(AuthError):                       # wrong claimant
        gate.verify(mint_token("acme", SECRETS["acme"]),
                    claimed="globex")
    tok = mint_token("globex", SECRETS["globex"])
    assert gate.verify(tok) == "globex"
    with pytest.raises(AuthError):                       # replayed
        gate.verify(tok)


def test_gateway_rejects_bad_open_tokens_over_socket(rng):
    """Forged, expired, replayed, and missing tokens are answered with
    ST_ERROR over TCP; a valid token opens and the session works; the
    rejected opens never create tenants."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng)
    try:
        with pytest.raises(AuthError):                   # forged
            GatewayClient(server, "acme", secret=b"not-the-secret")
        with pytest.raises(AuthError):                   # expired
            GatewayClient(server, "acme", token=mint_token(
                "acme", SECRETS["acme"], ttl_s=-1.0))
        with pytest.raises(AuthError):                   # missing
            GatewayClient(server, "acme")
        with pytest.raises(AuthError):                   # stolen token
            GatewayClient(server, "globex", token=mint_token(
                "acme", SECRETS["acme"]))
        assert gw.snapshot_stats()["tenants"] == {}
        ok = GatewayClient(server, "acme", secret=SECRETS["acme"])
        tok = mint_token("globex", SECRETS["globex"])
        also = GatewayClient(server, "globex", token=tok)
        with pytest.raises(AuthError):                   # replayed
            GatewayClient(server, "globex", token=tok)
        blob = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
        ok.write("/f", blob)
        assert also.read("/f") == blob
        ok.close()
        also.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_session_ids_are_connection_scoped(rng):
    """A session opened (and authenticated) on one connection is
    worthless on every other: a raw TCP client naming the victim's
    session id gets UnknownSession for reads, writes, deletes, AND
    close — it can neither touch the victim's data, bill traffic to
    its tenant, nor kill its session."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng)                 # auth enforced
    try:
        victim = GatewayClient(server, "acme", secret=SECRETS["acme"])
        blob = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
        victim.write("/secret", blob)
        sid = victim._session
        probe = socket.create_connection(server.address, timeout=10)
        attempts = [
            (svc.OP_READ, dict(path="/secret", version=-1, verify=True)),
            (svc.OP_WRITE, dict(path="/evil", data=b"x" * 64)),
            (svc.OP_DELETE, dict(path="/secret")),
            (svc.OP_STAT, dict(path="/secret")),
            (svc.OP_CLOSE, {}),
        ]
        # the forger never authenticated, yet probes the victim's sid
        # and a spread of guesses around it
        for rid, (op, fields) in enumerate(attempts, start=1):
            send_frame(probe, svc.encode_request(op, sid, rid, **fields))
            status, _op, _rid, f = svc.decode_response(recv_frame(probe))
            assert status == svc.ST_ERROR
            assert f["errtype"] == "UnknownSession"
        for guess in (0, 1, 2, sid + 1):
            send_frame(probe, svc.encode_request(
                svc.OP_STAT, guess, 99, path="/secret"))
            status, _op, _rid, f = svc.decode_response(recv_frame(probe))
            assert status == svc.ST_ERROR
            assert f["errtype"] == "UnknownSession"
        probe.close()
        # the hijack attempts neither closed the victim's session nor
        # touched its data
        assert victim.read("/secret") == blob
        assert victim.stat("/secret")["total_len"] == len(blob)
        victim.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_disconnect_drops_connection_sessions(rng):
    """A connection's sessions are removed from the gateway table when
    the connection goes away (graceful or abrupt) — ids don't pile up
    or stay live after the socket that authenticated them is gone."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    try:
        sock = socket.create_connection(server.address, timeout=10)
        send_frame(sock, svc.encode_request(
            svc.OP_OPEN, 0, 1, tenant="gone", qos="interactive",
            weight=1.0))
        status, _op, _rid, f = svc.decode_response(recv_frame(sock))
        assert status == svc.ST_OK
        assert gw.snapshot_stats()["sessions"] == 1
        sock.close()                    # vanish without OP_CLOSE
        deadline = time.time() + 30
        while gw.snapshot_stats()["sessions"] and time.time() < deadline:
            time.sleep(0.01)
        assert gw.snapshot_stats()["sessions"] == 0
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_pipelined_client_that_never_drains_is_bounded(rng):
    """The per-connection reply queue is bounded: a client that
    pipelines far more requests than max_pipeline without reading a
    single response stalls the reader (TCP backpressure) instead of
    growing server memory; once it finally drains, every reply
    arrives."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw = StorageGateway(mgr, engine=eng,
                        config=GatewayConfig(sai=_sai_cfg()))
    server = GatewayServer(gw, max_pipeline=2)
    try:
        seed = GatewayClient(gw, "seed")
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        seed.write("/pre", blob)
        seed.close()
        sock = socket.create_connection(server.address, timeout=10)
        send_frame(sock, svc.encode_request(
            svc.OP_OPEN, 0, 1, tenant="flood", qos="interactive",
            weight=1.0))
        _status, _op, _rid, f = svc.decode_response(recv_frame(sock))
        sid = f["session"]
        n = 24                          # >> max_pipeline
        for rid in range(2, 2 + n):
            send_frame(sock, svc.encode_request(svc.OP_STAT, sid, rid,
                                                path="/pre"))
        time.sleep(0.2)                 # let replies pile up server-side
        rids = set()
        for _ in range(n):
            status, _op, rid, _f = svc.decode_response(recv_frame(sock))
            assert status == svc.ST_OK
            rids.add(rid)
        assert rids == set(range(2, 2 + n))
        sock.close()
        with pytest.raises(ValueError):
            GatewayServer(gw, max_pipeline=0)
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_server_wildcard_bind_roundtrip(rng):
    """host='' (the bind-all idiom) still constructs and serves."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw = StorageGateway(mgr, engine=eng,
                        config=GatewayConfig(sai=_sai_cfg()))
    server = GatewayServer(gw, host="")
    try:
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        client = GatewayClient(("127.0.0.1", server.address[1]), "any")
        client.write("/w", blob)
        assert client.read("/w") == blob
        client.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


class _StuckGateway:
    """handle_frame returns futures that never resolve — forces the
    connection writer's reply_timeout_s abort path."""

    def handle_frame(self, frame, owner=None):
        return svc.ReplyFuture()

    def drop_sessions(self, owner):
        return 0


def test_writer_timeout_abort_unwedges_blocked_reader():
    """When a gateway reply never resolves, the writer's timeout abort
    must drain the bounded writeq so the reader (blocked in put())
    exits and the connection tears down — not wedge the thread and
    pin max_pipeline replies forever."""
    server = GatewayServer(_StuckGateway(), max_frame_bytes=1 << 20,
                           reply_timeout_s=0.3, max_pipeline=2)
    try:
        sock = socket.create_connection(server.address, timeout=10)
        for rid in range(1, 9):         # >> max_pipeline: reader blocks
            send_frame(sock, svc.encode_request(svc.OP_STAT, 1, rid,
                                                path="/x"))
        deadline = time.time() + 30
        while server.snapshot_stats()["open_connections"] \
                and time.time() < deadline:
            time.sleep(0.01)
        assert server.snapshot_stats()["open_connections"] == 0
        sock.close()
    finally:
        server.close(timeout_s=10)


def test_close_reclaims_connection_wedged_on_nondraining_client(rng):
    """A client that pipelines big reads and stops draining leaves the
    writer stuck in sendall (reply frames >> socket buffers) and the
    reader stuck in the bounded writeq — server.close() must abort the
    socket, reclaim both threads, and drop the session anyway."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw = StorageGateway(mgr, engine=eng, config=GatewayConfig(
        sai=_sai_cfg(hasher="cpu")))
    server = GatewayServer(gw, max_pipeline=2)
    try:
        blob = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
        seed = GatewayClient(gw, "seed")
        seed.write("/big", blob)
        seed.close()
        sock = socket.create_connection(server.address, timeout=10)
        send_frame(sock, svc.encode_request(
            svc.OP_OPEN, 0, 1, tenant="wedge", qos="interactive",
            weight=1.0))
        _status, _op, _rid, f = svc.decode_response(recv_frame(sock))
        sid = f["session"]
        for rid in range(2, 8):        # 4 MiB replies, never drained
            send_frame(sock, svc.encode_request(
                svc.OP_READ, sid, rid, path="/big", version=-1,
                verify=True))
        time.sleep(1.0)                # let the writer wedge in sendall
        server.close(timeout_s=2.0)    # must abort, not hang forever
        assert server.snapshot_stats()["open_connections"] == 0
        assert gw.snapshot_stats()["sessions"] == 0
        sock.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_auth_rejects_nonfinite_expiry():
    """A hand-packed token with NaN/inf expiry must be rejected: NaN
    slips past `expiry <= now` and a NaN entry at the expiry-heap root
    would stall replay-cache pruning for every tenant (inf pins its
    entry forever)."""
    import hashlib
    import hmac as hmac_mod

    from repro_torch.serve import auth as auth_mod

    gate = TokenAuthenticator({"acme": b"k"})
    for expiry in (float("nan"), float("inf")):
        body = auth_mod._signed_body(b"acme", expiry, b"e" * 16)
        tok = body + hmac_mod.new(b"k", body,
                                  hashlib.sha256).digest()
        with pytest.raises(AuthError):
            gate.verify(tok, now=1000.0)
    assert not gate._seen and not gate._expiries    # nothing cached


def test_auth_nonce_cache_prunes_and_hides_tenant_existence():
    """The replay cache forgets expired nonces (heap-amortized prune),
    and the unknown-tenant rejection neither names the probed tenant
    nor differs from a bad-signature rejection."""
    gate = TokenAuthenticator({"acme": b"k"})
    tok = mint_token("acme", b"k", ttl_s=5.0, now=1000.0,
                     nonce=b"n" * 16)
    assert gate.verify(tok, now=1001.0) == "acme"
    with pytest.raises(AuthError):              # replay inside window
        gate.verify(tok, now=1002.0)
    # same nonce in a FRESH token long after expiry: the stale cache
    # entry was pruned, so this is accepted (and the cache stays at
    # one live entry, not one per open ever made)
    tok2 = mint_token("acme", b"k", ttl_s=5.0, now=2000.0,
                      nonce=b"n" * 16)
    assert gate.verify(tok2, now=2001.0) == "acme"
    assert len(gate._seen) == 1
    assert len(gate._expiries) == 1
    with pytest.raises(AuthError) as unknown:
        gate.verify(mint_token("nobody", b"x"), now=1000.0)
    assert "nobody" not in str(unknown.value)
    with pytest.raises(AuthError) as forged:
        gate.verify(mint_token("acme", b"wrong"), now=1000.0)
    assert str(forged.value) == str(unknown.value)


def test_inprocess_gateway_with_auth_and_without(rng):
    """Auth is transport-independent: an auth-enforcing gateway demands
    tokens from in-process channels too, and an auth=None gateway keeps
    the trusted in-process behavior."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw = StorageGateway(mgr, engine=eng, config=GatewayConfig(
        sai=_sai_cfg(), auth=TokenAuthenticator(SECRETS)))
    try:
        with pytest.raises(AuthError):
            GatewayClient(gw, "acme")
        client = GatewayClient(gw, "acme", secret=SECRETS["acme"])
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        client.write("/f", blob)
        assert client.read("/f") == blob
        client.close()
    finally:
        gw.close()
        eng.shutdown()


# ----------------------------------------------------------------------
# connection lifecycle
# ----------------------------------------------------------------------
def test_abrupt_server_disconnect_resolves_inflight_futures():
    """A server that vanishes mid-request must resolve the channel's
    in-flight ReplyFutures with ST_ERROR (ConnectionError) — waiters
    get an exception, not a hang."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    accepted = []

    def fake_server():
        sock, _ = lsock.accept()
        accepted.append(sock)
        recv_frame(sock)                   # swallow one request ...
        sock.close()                       # ... then drop the line

    th = threading.Thread(target=fake_server, daemon=True)
    th.start()
    chan = SocketChannel(lsock.getsockname()[:2])
    try:
        frame = svc.encode_request(svc.OP_STAT, 5, 77, path="/x")
        fut = chan.request(frame)
        status, op, rid, fields = svc.decode_response(fut.result(30))
        assert (status, op, rid) == (svc.ST_ERROR, svc.OP_STAT, 77)
        assert fields["errtype"] == "ConnectionError"
        # the channel is dead: later requests fail fast, not hang
        fut2 = chan.request(svc.encode_request(svc.OP_STAT, 5, 78,
                                               path="/y"))
        status2, _, _, f2 = svc.decode_response(fut2.result(30))
        assert status2 == svc.ST_ERROR
        assert f2["errtype"] == "ConnectionError"
    finally:
        th.join(timeout=10)
        chan.close()
        lsock.close()


def test_half_close_still_drains_responses(rng):
    """A raw client that sends its requests then half-closes its write
    side (EOF at the server reader) still receives every response
    before the server closes the connection."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    try:
        blob = rng.integers(0, 256, 2 * 4096, dtype=np.uint8).tobytes()
        seed = GatewayClient(gw, "seed")   # stat target exists already
        seed.write("/pre", blob)           # (stat is served inline, so
        seed.close()                       # it must not race the write)
        sock = socket.create_connection(server.address, timeout=10)
        open_frame = svc.encode_request(svc.OP_OPEN, 0, 1, tenant="hc",
                                        qos="interactive", weight=1.0)
        send_frame(sock, open_frame)
        _status, _op, _rid, f = svc.decode_response(recv_frame(sock))
        sid = f["session"]
        send_frame(sock, svc.encode_request(svc.OP_WRITE, sid, 2,
                                            path="/hc", data=blob))
        send_frame(sock, svc.encode_request(svc.OP_STAT, sid, 3,
                                            path="/pre"))
        sock.shutdown(socket.SHUT_WR)      # half-close: no more requests
        rids = set()
        while True:
            frame = recv_frame(sock)
            if frame is None:
                break
            status, _op, rid, _f = svc.decode_response(frame)
            assert status == svc.ST_OK
            rids.add(rid)
        assert rids == {2, 3}              # both replies drained
        sock.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_hostile_length_prefix_kills_connection_not_server(rng):
    """A connection announcing an over-cap frame is dropped (no
    allocation, frame_errors counted); the server keeps serving new
    connections."""
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    try:
        sock = socket.create_connection(server.address, timeout=10)
        sock.sendall(struct.pack("!I", (64 << 20) + 1))
        deadline = time.time() + 30
        while server.snapshot_stats()["frame_errors"] == 0 \
                and time.time() < deadline:
            time.sleep(0.01)
        assert server.snapshot_stats()["frame_errors"] >= 1
        try:
            assert sock.recv(1) == b""     # server closed on us
        except OSError:
            pass                           # RST is also "closed on us"
        sock.close()
        blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        client = GatewayClient(server, "fine")   # still serving
        client.write("/ok", blob)
        assert client.read("/ok") == blob
        client.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_channel_refuses_oversized_send():
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    try:
        chan = SocketChannel(server.address, max_frame_bytes=1024)
        big = svc.encode_request(svc.OP_WRITE, 1, 9, path="/big",
                                 data=b"x" * 4096)
        status, _op, rid, f = svc.decode_response(
            chan.request(big).result(30))
        assert (status, rid) == (svc.ST_ERROR, 9)
        assert f["errtype"] == "ConnectionError"
        chan.close()
    finally:
        server.close()
        gw.close()
        eng.shutdown()


def test_server_close_is_graceful_and_idempotent(rng):
    mgr, _ = make_store(4)
    eng = CrystalGPU(devices=[CPU])
    gw, server = _served(mgr, eng, auth=False)
    client = GatewayClient(server, "t")
    blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    client.write("/f", blob)
    assert client.read("/f") == blob
    server.close()
    server.close()                          # no-op
    assert server.snapshot_stats()["open_connections"] == 0
    # the gateway outlives its listener: in-process clients still work
    inproc = GatewayClient(gw, "t2")
    inproc.write("/g", blob)
    assert inproc.read("/g") == blob
    gw.close()
    eng.shutdown()
