"""Leader-side minting of request ids, session tokens, and KDF salts.

The port's copy of `distributed_lms_raft_llm_tpu/lms/minting.py`,
its logic as it is.

THE determinism contract for random values in a replicated state machine:
randomness is drawn exactly once, BEFORE propose, by whichever process
fronts the client (the group router, or a leader handling a direct
client) — and then rides *inside* the replicated Entry. Appliers
(`LMSState._apply_*`) only ever copy these values out of the command;
they never mint. A `uuid.uuid4()` inside an applier would hand every
replica a different token for the same committed entry, which is
divergence, not replication.

Funneling all mint sites through this module makes the contract
auditable: the `state-machine-determinism` lint rule flags any RNG
reachable from the apply path, and `mint_*` names make the sanctioned
pre-propose sites greppable. Callers that may receive a router-forced
value (`_forced_auth`) must prefer it — `forced or mint_*()` — so all
of a fan-out's legs replicate the SAME value.
"""

from __future__ import annotations

import os
import uuid

__all__ = ["mint_request_id", "mint_session_token", "mint_salt",
           "USER_METADATA_KEY", "AUTH_SALT_METADATA_KEY",
           "AUTH_TOKEN_METADATA_KEY"]

# Router wire metadata, the reference's names (its `lms/group_router.py`
# defines them; the port has no group router yet, so they live here).
# `x-lms-user` is a routing hint the client sends; the forced auth pair is
# honoured only on a router-dispatched leg (`lms/service.py::
# _forced_auth`), so a single-group node never reads it from a client.
USER_METADATA_KEY = "x-lms-user"
AUTH_SALT_METADATA_KEY = "x-lms-auth-salt"
AUTH_TOKEN_METADATA_KEY = "x-lms-auth-token"


def mint_request_id() -> str:
    """Idempotency key for one logical client mutation (not one attempt):
    minted pre-propose, carried in the command, dropped by every
    replica's `applied_requests` ledger on retry."""
    return uuid.uuid4().hex


def mint_session_token() -> str:
    """Session token minted at Login, pre-propose. The router mints one
    token for a multi-group login fan-out and forces it onto every leg
    via signed metadata, so all groups replicate the same session."""
    return uuid.uuid4().hex


def mint_salt() -> str:
    """Per-user PBKDF2 salt minted at Register, pre-propose. Rides in the
    command next to the hash it salted, so appliers never run the KDF
    with process-local randomness."""
    return os.urandom(16).hex()
