"""The replicated LMS state machine: pure apply functions over a dict.

The port's copy of `distributed_lms_raft_llm_tpu/lms/state.py`,
its logic as it is.

Schema mirrors the reference's `lms_data.json` (reference:
GUI_RAFT_LLM_SourceCode/lms_server.py:44-49 and appliers :1277-1448):

    users:            {username: {password, role}}
    assignments:      {student: [{filename, filepath, grade, text}]}
    course_materials: [{filename, filepath, instructor}]
    queries:          {student: [{query, answered, response}]}
    sessions:         {token: username}     # NEW: replicated (reference kept
                                            # sessions node-local, defect D7 —
                                            # every failover invalidated all
                                            # logins)

Apply functions are deterministic and idempotent-friendly: every node
applies the same committed command sequence and converges. No IO here —
blob/file side effects live in lms.blobs, persistence in lms.persistence.

Command set (SURVEY.md §2.4) plus Login/Logout/SetVal:
    Register, Login, Logout, PostAssignment, GradeAssignment,
    PostCourseMaterial, AskQuery, RespondToQuery, SetVal

Reshard handoff commands (lms/group_router.py, multi-group only):
    FreezeKeys, InstallKeys, DropKeys

These carry one course's per-user slice between Raft groups. `frozen`
and `moved` markers are created lazily by the appliers (NOT in
`empty_state`), so a single-group deployment's snapshot bytes are
unchanged — byte-compatibility with pre-sharding state files is the
acceptance bar. While a user is frozen on a group, that group's
mutation appliers for the user are no-ops: the write either committed
before the freeze (and rides the streamed slice) or the router converts
it into an UNAVAILABLE retry that lands on the target group after the
map flip — never a silently dropped acked write.
"""

from __future__ import annotations

import copy
import hashlib
import hmac
import json
from typing import Any, Dict, List, Optional


def empty_state() -> Dict[str, Any]:
    return {
        "users": {},
        "assignments": {},
        "course_materials": [],
        "queries": {},
        "sessions": {},
        "kv": {},
        # Idempotency ledger: request_ids already applied (insertion-ordered,
        # bounded). Replicated like everything else, so a client retry whose
        # original proposal DID commit is dropped by every replica alike.
        "applied_requests": {},
    }


# Bound on the idempotency ledger. Eviction is insertion-ordered (dict order
# survives the JSON snapshot round-trip), so every replica evicts the same
# ids at the same applied index — determinism holds.
MAX_APPLIED_REQUESTS = 4096

PBKDF2_ITERATIONS = 50_000


def hash_password(password: str, salt: str = "") -> str:
    """At-rest password hashing (the reference stores plaintext).

    With a salt (hex string): PBKDF2-HMAC-SHA256. The salt is generated by
    the leader at Register time and rides *inside* the replicated command,
    so appliers stay deterministic across replicas. Without a salt: the
    legacy single-round scheme, kept only so states persisted by earlier
    versions still authenticate.
    """
    if salt:
        return hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt), PBKDF2_ITERATIONS
        ).hex()
    return hashlib.sha256(("lms:" + password).encode()).hexdigest()


class LMSState:
    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data if data is not None else empty_state()
        for key, default in empty_state().items():
            self.data.setdefault(key, copy.deepcopy(default))

    # ------------------------------------------------------------- appliers

    def apply(self, op: str, args: Dict[str, Any]) -> None:
        handler = getattr(self, f"_apply_{op.lower()}", None)
        if handler is None:
            raise ValueError(f"unknown LMS command {op!r}")
        rid = args.get("request_id")
        if rid:
            applied = self.data.setdefault("applied_requests", {})
            if rid in applied:
                return  # client retry of an already-committed mutation
        handler(args)
        # Record only after the handler succeeded — if it raised, a client
        # retry must be re-attempted, not silently dropped.
        if rid:
            applied[rid] = True
            while len(applied) > MAX_APPLIED_REQUESTS:
                del applied[next(iter(applied))]

    def _apply_register(self, a: Dict[str, Any]) -> None:
        users = self.data["users"]
        if a["username"] not in users:
            users[a["username"]] = {
                "password": a["password_hash"],
                "salt": a.get("salt", ""),
                "role": a["role"],
            }

    def _apply_login(self, a: Dict[str, Any]) -> None:
        self.data["sessions"][a["token"]] = a["username"]

    def _apply_logout(self, a: Dict[str, Any]) -> None:
        self.data["sessions"].pop(a["token"], None)

    def frozen_for(self, username: str) -> Optional[str]:
        """The reshard id freezing `username` on this group, if any."""
        return self.data.get("frozen", {}).get(username)

    def _apply_postassignment(self, a: Dict[str, Any]) -> None:
        if self.frozen_for(a["student"]):
            return  # mid-handoff: the router retries this onto the target
        lst = self.data["assignments"].setdefault(a["student"], [])
        lst.append(
            {
                "filename": a["filename"],
                "filepath": a["filepath"],
                "grade": None,
                "text": a["text"],
            }
        )

    def _apply_gradeassignment(self, a: Dict[str, Any]) -> None:
        if self.frozen_for(a["student"]):
            return
        # Reference semantics: the grade applies to all of the student's
        # assignments (lms_server.py:1350-1353).
        for assignment in self.data["assignments"].get(a["student"], []):
            assignment["grade"] = a["grade"]

    def _apply_postcoursematerial(self, a: Dict[str, Any]) -> None:
        if self.frozen_for(a["instructor"]):
            return
        self.data["course_materials"].append(
            {
                "filename": a["filename"],
                "filepath": a["filepath"],
                "instructor": a["instructor"],
            }
        )

    def _apply_askquery(self, a: Dict[str, Any]) -> None:
        if self.frozen_for(a["username"]):
            return
        lst = self.data["queries"].setdefault(a["username"], [])
        lst.append({"query": a["query"], "answered": False, "response": None})

    def _apply_respondtoquery(self, a: Dict[str, Any]) -> None:
        if self.frozen_for(a["student"]):
            return
        # Answers the student's oldest unanswered query (reference
        # lms_server.py:1431-1448).
        for query in self.data["queries"].get(a["student"], []):
            if not query["answered"]:
                query["response"] = a["response"]
                query["answered"] = True
                return

    def _apply_setval(self, a: Dict[str, Any]) -> None:
        self.data["kv"][a["key"]] = a["value"]

    def _apply_noop(self, a: Dict[str, Any]) -> None:
        pass

    # --------------------------------------------- reshard handoff appliers

    def _apply_freezekeys(self, a: Dict[str, Any]) -> None:
        """Source-group side of a handoff: put every moving user behind a
        redirect marker. Subsequent mutations for them are applier no-ops
        (see the guards above) and the router turns their acks into
        UNAVAILABLE retries, so the slice read after this commit is the
        complete, final source-side truth for those users."""
        frozen = self.data.setdefault("frozen", {})
        for user in a["users"]:
            frozen[user] = a["reshard_id"]

    def _apply_installkeys(self, a: Dict[str, Any]) -> None:
        """Target-group side: splice the streamed slice in. Replays are
        dropped by the request_id ledger (`apply`), and the merge itself
        is replace-per-user, so a re-proposed install converges instead
        of duplicating rows. The source's idempotency ledger rides along:
        a client retry of a pre-freeze mutation that lands here after the
        map flip is recognized and dropped, not applied twice.

        Installing also lifts this group's `moved` tombstones for the
        arriving users: a course can reshard BACK to a group it left
        earlier, and a stale tombstone here would make _guard_subject
        reject every one of their writes forever."""
        payload = a["payload"]
        moved = self.data.get("moved", {})
        for user in payload.get("users", []):
            moved.pop(user, None)
        for student, rows in payload.get("assignments", {}).items():
            self.data["assignments"][student] = copy.deepcopy(rows)
        for student, rows in payload.get("queries", {}).items():
            self.data["queries"][student] = copy.deepcopy(rows)
        have = {(m["filepath"], m.get("instructor"))
                for m in self.data["course_materials"]}
        for mat in payload.get("course_materials", []):
            if (mat["filepath"], mat.get("instructor")) not in have:
                self.data["course_materials"].append(copy.deepcopy(mat))
        applied = self.data.setdefault("applied_requests", {})
        for rid in payload.get("applied_requests", {}):
            if rid not in applied:
                applied[rid] = True
        while len(applied) > MAX_APPLIED_REQUESTS:
            del applied[next(iter(applied))]

    def _apply_dropkeys(self, a: Dict[str, Any]) -> None:
        """Source-group side, after the map flip: remove the moved slice,
        clear the freeze markers, and leave a tombstone per moved user so
        a lagging reader can tell 'moved away' from 'never existed'."""
        # Dedup in COMMAND order, not via set(): a set's iteration order
        # follows per-process hash randomization (PYTHONHASHSEED), and the
        # `moved` tombstone insertion order below is replicated state — it
        # must come out identical on every replica (the state digest would
        # diverge otherwise; caught by the state-machine-determinism rule).
        users = list(dict.fromkeys(a["users"]))
        for user in users:
            self.data["assignments"].pop(user, None)
            self.data["queries"].pop(user, None)
        self.data["course_materials"] = [
            m for m in self.data["course_materials"]
            if m.get("instructor") not in users
        ]
        frozen = self.data.get("frozen", {})
        moved = self.data.setdefault("moved", {})
        for user in users:
            frozen.pop(user, None)
            moved[user] = a["reshard_id"]

    # ------------------------------------------------------------ snapshot

    def replace(self, new_data: Dict[str, Any]) -> None:
        """Swap in a full state snapshot (Raft InstallSnapshot) IN PLACE.

        Top-level and `kv` dict identities are preserved because other
        components hold live references to them (the gRPC servicers capture
        `state.data` / `state.data['kv']` at construction)."""
        kv = self.data["kv"]
        kv.clear()
        kv.update(new_data.get("kv", {}))
        for key in list(self.data):
            if key != "kv":
                del self.data[key]
        for key, value in new_data.items():
            if key != "kv":
                self.data[key] = copy.deepcopy(value)
        for key, default in empty_state().items():
            self.data.setdefault(key, copy.deepcopy(default))

    def digest(self) -> str:
        """Content hash of the replicated state, for cross-replica audit.

        Two replicas that applied the same committed prefix MUST return
        the same digest; two that diverged must not. Canonicalization is
        deliberately asymmetric:

        - TOP-LEVEL keys are hashed in sorted order. `replace()` rebuilds
          `self.data` kv-first (it preserves the dict identity), so a
          snapshot-installed replica's top-level insertion order legally
          differs from a live-applied one's — that is not divergence.
        - INSIDE each plane, `json.dumps` WITHOUT sort_keys preserves
          insertion order. That order IS replicated state (the
          `applied_requests` ledger evicts in insertion order, `moved`
          tombstone order is applier-determined), so a replica whose
          applier visited entries in a different order — the exact bug
          class the state-machine-determinism lint rule targets — shows
          up here instead of hiding behind a sorted hash.
        """
        h = hashlib.sha256()
        for key in sorted(self.data):
            h.update(key.encode())
            h.update(b"\x00")
            h.update(
                json.dumps(self.data[key], separators=(",", ":")).encode()
            )
            h.update(b"\x01")
        return h.hexdigest()[:16]

    # --------------------------------------------------------------- reads

    def user_of_token(self, token: str) -> Optional[str]:
        return self.data["sessions"].get(token)

    def role_of(self, username: str) -> Optional[str]:
        user = self.data["users"].get(username)
        return user["role"] if user else None

    def check_password(self, username: str, password: str) -> bool:
        user = self.data["users"].get(username)
        if not user:
            return False
        return hmac.compare_digest(
            user["password"], hash_password(password, user.get("salt", ""))
        )

    def assignments_of(self, student: str) -> List[Dict[str, Any]]:
        return self.data["assignments"].get(student, [])

    def unanswered_queries(self) -> List[Dict[str, str]]:
        out = []
        for student, queries in self.data["queries"].items():
            for q in queries:
                if not q["answered"]:
                    out.append({"student": student, "query": q["query"]})
        return out

    def answered_queries_of(self, student: str) -> List[Dict[str, str]]:
        return [
            {"query": q["query"], "response": q["response"]}
            for q in self.data["queries"].get(student, [])
            if q["answered"]
        ]
