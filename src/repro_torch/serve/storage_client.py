"""Thin framed client for the multi-tenant storage gateway.

Everything the client exchanges with the gateway is a codec frame
(bytes) pushed through a transport channel — the in-process
``GatewayChannel`` and the TCP ``SocketChannel`` implement the same
``request(frame) -> ReplyFuture`` contract, so the client works
unchanged over either (pass a ``StorageGateway``, a ``GatewayServer``,
a ready channel, or a ``host:port`` address).  Backpressure is a
first-class outcome: an over-budget tenant's request resolves to
:class:`RetryLater` (the gateway's admission control answering
``ST_RETRY``) rather than queueing without bound — callers either back
off themselves or use :meth:`GatewayClient.write_retrying`.

When the gateway enforces tenant auth, pass ``secret=`` (the tenant's
shared secret; a fresh signed token is minted for the open) or a
pre-minted ``token=``.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, Optional

from repro_torch.serve.auth import AuthError, mint_token
from repro_torch.serve.storage_service import (OP_CLOSE, OP_DELETE,
                                               OP_HEALTH, OP_OPEN, OP_READ,
                                               OP_STAT, OP_STATS, OP_WRITE,
                                               ST_ERROR, ST_OK, ST_RETRY,
                                               decode_response,
                                               encode_request)


class RetryLater(RuntimeError):
    """Admission control pushed back: the tenant is over its in-flight
    or queued-byte budget.  Back off and resubmit."""


class GatewayError(RuntimeError):
    """A gateway-side failure that does not map to a builtin."""


_ERROR_TYPES = {
    "FileNotFoundError": FileNotFoundError,
    "IOError": IOError,
    "OSError": OSError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "AuthError": AuthError,
    "PermissionError": PermissionError,
    "ConnectionError": ConnectionError,
}


def _raise_for(fields: Dict[str, Any]):
    exc = _ERROR_TYPES.get(fields["errtype"])
    if exc is not None:
        raise exc(fields["msg"])
    raise GatewayError(f"{fields['errtype']}: {fields['msg']}")


class PendingReply:
    """Handle for an in-flight gateway request; ``result()`` decodes the
    response frame and raises :class:`RetryLater` on backpressure or the
    mapped exception on gateway-side errors."""

    def __init__(self, future, op: int):
        self._future = future
        self._op = op

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = 120.0):
        status, op, _rid, fields = decode_response(
            self._future.result(timeout))
        if status == ST_RETRY:
            raise RetryLater(fields["reason"])
        if status == ST_ERROR:
            _raise_for(fields)
        assert status == ST_OK
        if op == OP_READ:
            return fields["data"]
        if op in (OP_STATS, OP_HEALTH):
            return json.loads(fields["data"].decode("utf-8"))
        return fields


class GatewayClient:
    """One client session against a storage gateway.

    ``target`` may be a :class:`~repro_torch.serve.storage_service.
    StorageGateway` or :class:`~repro_torch.serve.transport.GatewayServer`
    (anything with ``connect()``), an already-open channel (anything
    with ``request()``), or a TCP address (``"host:port"`` or
    ``(host, port)``) to dial.  The client owns its channel and closes
    it in :meth:`close`.

    ``tenant`` names the fair-share/admission bucket this session bills
    to; ``weight`` and ``qos`` ('interactive' | 'batch' | 'scrub') apply
    when this open creates the tenant (later sessions join it as-is).
    On an auth-enforcing gateway the open must carry a signed token:
    pass the tenant's shared ``secret`` (token minted here, expiring
    after ``token_ttl_s``) or a pre-minted ``token``.  ``submit_*``
    methods are asynchronous (returning :class:`PendingReply`); the
    plain verbs block on the reply.
    """

    def __init__(self, target, tenant: str, weight: float = 1.0,
                 qos: str = "interactive",
                 secret: Optional[bytes] = None,
                 token: Optional[bytes] = None,
                 token_ttl_s: float = 30.0):
        if hasattr(target, "connect"):
            self._channel = target.connect()
        elif hasattr(target, "request"):
            self._channel = target
        else:
            from repro_torch.serve.transport import SocketChannel
            self._channel = SocketChannel(target)
        self._rid = itertools.count(1)
        # per-request trace ids: random 48-bit base + counter, so ids
        # from concurrent clients don't collide and are never 0
        # (0 = untraced on the wire)
        self._trace = itertools.count(
            (int.from_bytes(os.urandom(6), "big") << 16) | 1)
        self.tenant = tenant
        if token is None and secret is not None:
            token = mint_token(tenant, secret, ttl_s=token_ttl_s)
        try:
            resp = self._rpc(OP_OPEN, session=0, tenant=tenant,
                             weight=weight, qos=qos,
                             token=token or b"").result()
        except BaseException:
            self._close_channel()
            raise
        self._session = resp["session"]

    # -- framing -------------------------------------------------------
    def _rpc(self, op: int, session: Optional[int] = None,
             **fields: Any) -> PendingReply:
        if session is None:
            session = self._session
        if op in (OP_WRITE, OP_READ) and "trace" not in fields:
            fields["trace"] = next(self._trace) & 0xFFFFFFFFFFFFFFFF
        frame = encode_request(op, session, next(self._rid), **fields)
        return PendingReply(self._channel.request(frame), op)

    # -- async submission ----------------------------------------------
    def submit_write(self, path: str, data: bytes) -> PendingReply:
        return self._rpc(OP_WRITE, path=path, data=bytes(data))

    def submit_read(self, path: str, version: int = -1,
                    verify: bool = True) -> PendingReply:
        return self._rpc(OP_READ, path=path, version=version,
                         verify=verify)

    # -- blocking verbs ------------------------------------------------
    def write(self, path: str, data: bytes,
              timeout: Optional[float] = 120.0) -> Dict[str, int]:
        """Store ``data`` at ``path``; returns the gateway's write
        summary (total/new bytes, new/dup blocks).  Raises
        :class:`RetryLater` on admission backpressure."""
        return self.submit_write(path, data).result(timeout)

    def write_retrying(self, path: str, data: bytes,
                       timeout: float = 120.0,
                       backoff_s: float = 0.002) -> Dict[str, int]:
        """``write`` that absorbs :class:`RetryLater` with a small
        backoff until ``timeout`` — the well-behaved flooder.

        ``timeout`` is a total wall-clock deadline: each attempt is
        clamped to the time *remaining* (passing the full timeout per
        attempt used to let one retry overshoot the deadline by ~2x),
        and once the deadline is exhausted the loop raises
        :class:`RetryLater` instead of starting another attempt."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RetryLater(
                    f"write_retrying deadline ({timeout}s) exhausted "
                    f"for {path}")
            try:
                return self.write(path, data, timeout=remaining)
            except RetryLater:
                if time.monotonic() + backoff_s >= deadline:
                    raise
                time.sleep(backoff_s)

    def read(self, path: str, version: int = -1, verify: bool = True,
             timeout: Optional[float] = 120.0) -> bytes:
        return self.submit_read(path, version, verify).result(timeout)

    def stat(self, path: str) -> Dict[str, int]:
        """{'versions', 'total_len', 'blocks'} for the latest version."""
        return self._rpc(OP_STAT, path=path).result()

    def stats(self) -> Dict[str, Any]:
        """Live gateway observability snapshot (the full
        ``snapshot_stats()`` tree: tenants, engine per-device
        histograms, WAL fsync percentiles, trace-ring counters) fetched
        over the wire via ``OP_STATS``.  Note JSON transit turns int
        dict keys (e.g. device indices) into strings."""
        return self._rpc(OP_STATS).result()

    def health(self) -> Dict[str, Any]:
        """The gateway's health report via ``OP_HEALTH``: overall
        ``status`` (``ok``/``warn``/``critical``) plus the rule
        verdicts — the same JSON the ``/health`` HTTP route serves."""
        return self._rpc(OP_HEALTH).result()

    def delete(self, path: str) -> int:
        """Delete every version of ``path``; returns orphaned digests."""
        return self._rpc(OP_DELETE, path=path).result()["orphans"]

    def _close_channel(self):
        close = getattr(self._channel, "close", None)
        if close is not None:
            close()

    def close(self):
        """Close the gateway session, then the transport channel (a
        no-op in-process; a graceful drain + disconnect over TCP)."""
        try:
            self._rpc(OP_CLOSE).result()
        finally:
            self._close_channel()
