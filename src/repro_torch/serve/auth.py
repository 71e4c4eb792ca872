"""Tenant auth tokens for the storage gateway.

Once frames cross a real socket the gateway cannot trust the tenant
name a client claims in ``OP_OPEN`` — any connection could bill its
traffic to another tenant's fair-share bucket (or open the admin
tenant).  This module is the shared-secret scheme that closes that
hole:

  token   — ``mint_token(tenant, secret)`` packs ``version | tenant |
            expiry | nonce`` and appends an HMAC-SHA256 signature over
            those bytes keyed by the tenant's shared secret.  The
            tenant name is *inside* the signed payload, so a token
            minted for tenant A cannot open a session as tenant B.
  expiry  — tokens carry an absolute expiry (``time.time() + ttl_s``);
            verification rejects expired tokens, so a leaked frame is
            only useful for a short window.
  nonce   — 16 random bytes, remembered (per tenant) by the verifier
            until the token expires; presenting the same token twice
            is rejected, so a captured ``OP_OPEN`` frame cannot be
            replayed to open more sessions.

:class:`TokenAuthenticator` is the gateway-side verifier: it holds the
per-tenant secret table and a nonce replay cache, and ``verify()``
returns the *authenticated* tenant name — the gateway uses that, never
the claimed field, to create the session.  All verification failures
raise :class:`AuthError` (a ``PermissionError``), which the gateway
answers with ``ST_ERROR``.
"""
from __future__ import annotations

import hashlib
import heapq
import hmac
import math
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

TOKEN_VERSION = 1
NONCE_BYTES = 16
SIG_BYTES = hashlib.sha256().digest_size       # 32

_VER = struct.Struct("!B")
_U16 = struct.Struct("!H")
_F64 = struct.Struct("!d")


class AuthError(PermissionError):
    """Token verification failed (malformed, forged, expired, replayed,
    or for an unknown/mismatched tenant)."""


def _signed_body(tenant_utf8: bytes, expiry: float, nonce: bytes) -> bytes:
    return (_VER.pack(TOKEN_VERSION) + _U16.pack(len(tenant_utf8))
            + tenant_utf8 + _F64.pack(expiry)
            + _U16.pack(len(nonce)) + nonce)


def mint_token(tenant: str, secret: bytes, ttl_s: float = 30.0,
               now: Optional[float] = None,
               nonce: Optional[bytes] = None) -> bytes:
    """Mint a signed open-token for ``tenant``.  ``now``/``nonce`` are
    injectable for tests (expired tokens, replay)."""
    tenant_utf8 = tenant.encode("utf-8")
    if len(tenant_utf8) > 0xFFFF:
        raise ValueError("tenant name too long")
    if now is None:
        now = time.time()
    if nonce is None:
        nonce = os.urandom(NONCE_BYTES)
    body = _signed_body(tenant_utf8, now + float(ttl_s), nonce)
    sig = hmac.new(bytes(secret), body, hashlib.sha256).digest()
    return body + sig


def parse_token(token: bytes) -> Tuple[str, float, bytes, bytes, bytes]:
    """-> (tenant, expiry, nonce, signature, signed_body); raises
    :class:`AuthError` on any malformed layout (never ``struct.error``
    / ``IndexError`` — tokens arrive off the wire)."""
    try:
        off = 0
        (ver,) = _VER.unpack_from(token, off)
        off += _VER.size
        if ver != TOKEN_VERSION:
            raise AuthError(f"unsupported token version {ver}")
        (tlen,) = _U16.unpack_from(token, off)
        off += _U16.size
        if off + tlen > len(token):
            raise AuthError("truncated token tenant")
        tenant = token[off:off + tlen].decode("utf-8")
        off += tlen
        (expiry,) = _F64.unpack_from(token, off)
        off += _F64.size
        (nlen,) = _U16.unpack_from(token, off)
        off += _U16.size
        if off + nlen + SIG_BYTES != len(token):
            raise AuthError("truncated token nonce/signature")
        nonce = bytes(token[off:off + nlen])
        off += nlen
        sig = bytes(token[off:])
    except AuthError:
        raise
    except (struct.error, UnicodeDecodeError, IndexError, TypeError) as e:
        raise AuthError(f"malformed token: {e}") from None
    return tenant, expiry, nonce, sig, bytes(token[:-SIG_BYTES])


class TokenAuthenticator:
    """Gateway-side verifier: per-tenant shared secrets + a nonce
    replay cache.  Thread-safe — ``OP_OPEN`` frames arrive on many
    connection reader threads at once."""

    def __init__(self, secrets: Dict[str, bytes]):
        self._secrets = {t: bytes(s) for t, s in secrets.items()}  # guarded by self._lock
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[str, bytes], float] = {}  # nonce -> expiry; guarded by self._lock
        # expiry-ordered heap over _seen keys: pruning pops only the
        # already-expired head instead of scanning the whole cache under
        # the lock on every open
        self._expiries: List[Tuple[float, Tuple[str, bytes]]] = []  # guarded by self._lock
        # unknown tenants still pay for a full HMAC against this dummy
        # secret, so a timing probe on the open path can't distinguish
        # "tenant exists" from "tenant doesn't"
        self._decoy = os.urandom(32)

    def add_tenant(self, tenant: str, secret: bytes):
        with self._lock:
            self._secrets[tenant] = bytes(secret)

    def verify(self, token: bytes, claimed: Optional[str] = None,
               now: Optional[float] = None) -> str:
        """Verify a token and return the authenticated tenant name.
        Signature is checked *first* (forged tokens never touch the
        replay cache), then expiry, then replay."""
        if not token:
            raise AuthError("missing auth token")
        if now is None:
            now = time.time()
        tenant, expiry, nonce, sig, body = parse_token(token)
        with self._lock:
            secret = self._secrets.get(tenant)
        # always do the HMAC (decoy-keyed for unknown tenants) and share
        # one error message, so neither timing nor the reply text tells
        # a prober whether a tenant name exists
        want = hmac.new(self._decoy if secret is None else secret,
                        body, hashlib.sha256).digest()
        if not hmac.compare_digest(sig, want) or secret is None:
            raise AuthError("unknown tenant or bad token signature")
        if claimed is not None and claimed != tenant:
            raise AuthError(
                f"token is for tenant {tenant!r}, not {claimed!r}")
        # the wire expiry is a raw f64: NaN slips past `expiry <= now`
        # and then stalls the expiry heap at its root forever (inf pins
        # its cache entry forever) — reject both before caching
        if not math.isfinite(expiry):
            raise AuthError("non-finite token expiry")
        if expiry <= now:
            raise AuthError("token expired")
        key = (tenant, nonce)
        with self._lock:
            while self._expiries and self._expiries[0][0] <= now:
                exp, k = heapq.heappop(self._expiries)
                # the heap may hold a stale entry for a nonce that was
                # re-recorded with a later expiry; only drop the cache
                # entry if it really is expired
                if self._seen.get(k, now + 1.0) <= now:
                    del self._seen[k]
            if key in self._seen:
                raise AuthError("token replayed (nonce already used)")
            self._seen[key] = expiry
            heapq.heappush(self._expiries, (expiry, key))
        return tenant
