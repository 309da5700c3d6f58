"""Raft message dataclasses and the structured command codec.

The port's copy of `distributed_lms_raft_llm_tpu/raft/messages.py`,
its logic as it is.

Transport-neutral: `raft.core` speaks only these types; the gRPC layer
(`raft.service` / `raft.grpc_transport`) converts them to the frozen wire
messages (lms.proto TermCandIDPair / TermResultPair / TermLeaderIDPair
quirks included).

Commands are JSON objects `{"op": ..., "args": {...}}` encoded/decoded by
ONE codec used on both the propose and apply sides — the reference JSON-
encodes on propose but string-splits on apply, so committed commands can
never round-trip (reference: GUI_RAFT_LLM_SourceCode/lms_server.py:335-340
vs :263-268, defect D1). Fixed by construction here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Entry:
    term: int
    command: str


@dataclasses.dataclass(frozen=True)
class VoteRequest:
    term: int
    candidate_id: int
    last_log_index: int
    last_log_term: int
    # Set on the election a leadership transfer triggers (TimeoutNow):
    # voters process it even inside their leader-lease window (thesis
    # §4.2.3 carve-out — the lease exists to stop DISRUPTIVE elections;
    # a transfer election is leader-sanctioned).
    transfer: bool = False


@dataclasses.dataclass(frozen=True)
class VoteResponse:
    term: int
    granted: bool


@dataclasses.dataclass(frozen=True)
class AppendRequest:
    term: int
    leader_id: int
    prev_log_index: int
    prev_log_term: int
    entries: Tuple[Entry, ...]
    leader_commit: int


@dataclasses.dataclass(frozen=True)
class AppendResponse:
    term: int
    success: bool
    # Fast conflict backtracking (§5.3 optimization): on mismatch the
    # follower reports a hint so the leader can skip whole terms instead of
    # decrementing next_index one step per round trip.
    match_index: int = 0
    conflict_index: int = 0


@dataclasses.dataclass(frozen=True)
class InstallSnapshotRequest:
    """Leader → lagging follower: state-machine snapshot replacing the log
    prefix the leader has compacted away (Raft §7). `data` is the
    application snapshot (JSON state dict bytes for the LMS)."""

    term: int
    leader_id: int
    last_included_index: int
    last_included_term: int
    data: bytes


@dataclasses.dataclass(frozen=True)
class InstallSnapshotResponse:
    term: int
    success: bool


@dataclasses.dataclass(frozen=True)
class TimeoutNowRequest:
    """Leader → chosen successor: campaign immediately (leadership
    transfer, Raft thesis §3.10). Sent only once the target's match_index
    has reached the leader's last log index, so the §5.4.1 up-to-date vote
    check cannot reject it."""

    term: int
    leader_id: int


@dataclasses.dataclass(frozen=True)
class TimeoutNowResponse:
    term: int


def encode_command(op: str, args: Optional[Dict[str, Any]] = None) -> str:
    return json.dumps({"op": op, "args": args or {}}, sort_keys=True)


def decode_command(command: str) -> Tuple[str, Dict[str, Any]]:
    obj = json.loads(command)
    if not isinstance(obj, dict) or "op" not in obj:
        raise ValueError(f"malformed raft command: {command!r}")
    return obj["op"], obj.get("args", {})


NOOP = encode_command("noop")

# Cluster-membership change entries (Raft §4, one-server-at-a-time — each
# consecutive configuration shares a quorum with the previous one, so no
# joint consensus is needed). The entry carries the FULL new membership as
# an id -> address map; it takes effect on every node as soon as it is
# APPENDED to that node's log (not when committed), per the thesis.
MEMBERSHIP_OP = "__membership__"


def encode_membership(members: Dict[int, str]) -> str:
    return encode_command(
        MEMBERSHIP_OP, {"members": {str(k): v for k, v in members.items()}}
    )


def decode_membership(command: str) -> Dict[int, str]:
    _, args = decode_command(command)
    return {int(k): v for k, v in args["members"].items()}


_SNAP_MAGIC = b"\x00mbr\x00"


def wrap_snapshot(members: Dict[int, str], data: bytes) -> bytes:
    """Envelope the membership-at-snapshot into the InstallSnapshot payload
    (the frozen wire message has no config field; the thesis requires
    snapshots to carry the latest configuration, or a follower restored
    from one silently keeps a stale quorum view)."""
    header = json.dumps({str(k): v for k, v in members.items()}).encode()
    return _SNAP_MAGIC + len(header).to_bytes(4, "big") + header + data


def unwrap_snapshot(data: bytes):
    """-> (members | None, app_data). Non-enveloped payloads pass through."""
    if not data.startswith(_SNAP_MAGIC):
        return None, data
    off = len(_SNAP_MAGIC)
    n = int.from_bytes(data[off:off + 4], "big")
    header = data[off + 4 : off + 4 + n]
    members = {int(k): v for k, v in json.loads(header.decode()).items()}
    return members, data[off + 4 + n:]


def is_membership(command: str) -> bool:
    """Cheap-substring fast path, full decode to confirm (an application
    command whose ARGUMENTS contain the literal must not be mistaken)."""
    if '"__membership__"' not in command:
        return False
    try:
        op, _ = decode_command(command)
    except (ValueError, json.JSONDecodeError):
        return False
    return op == MEMBERSHIP_OP
