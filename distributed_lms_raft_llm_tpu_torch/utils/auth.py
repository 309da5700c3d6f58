"""Forwarding auth for the tutoring port.

The port's own copy of `distributed_lms_raft_llm_tpu/utils/auth.py`: the
LMS leader stamps each forwarded query with an expiring HMAC ticket in
`QueryRequest.token`; with a shared key configured, the tutoring node
answers only queries whose ticket verifies. Same format on both sides, so
a JAX-package LMS signs what this node verifies.
"""

from __future__ import annotations

import hashlib
import hmac
import time

TICKET_TTL_S = 60


def _mac(key: str, expires_at: int, query: str) -> str:
    msg = f"{expires_at}|{query}".encode()
    return hmac.new(key.encode(), msg, hashlib.sha256).hexdigest()


def sign_query(key: str, query: str, now: float | None = None) -> str:
    """Ticket "<unix-expiry>:<hmac-sha256 of 'expiry|query'>"."""
    expires_at = int(now if now is not None else time.time()) + TICKET_TTL_S
    return f"{expires_at}:{_mac(key, expires_at, query)}"


def verify_query(key: str, query: str, ticket: str,
                 now: float | None = None) -> bool:
    expiry_s, sep, mac = (ticket or "").partition(":")
    if not sep or not expiry_s.isdigit():
        return False
    expires_at = int(expiry_s)
    if (now if now is not None else time.time()) >= expires_at:
        return False
    return hmac.compare_digest(_mac(key, expires_at, query), mac)
