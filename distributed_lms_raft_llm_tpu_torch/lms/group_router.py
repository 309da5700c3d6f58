"""Course-sharded LMS control plane: group router + live resharding.

The port's copy of `distributed_lms_raft_llm_tpu/lms/group_router.py`,
its logic as it is.

One Raft group serializes every write through a single leader — the last
single-node bottleneck on the millions-of-users north star (ROADMAP).
This module shards LMS state by course (student-hash fallback) into N
independent Raft groups, each running the unmodified `raft/core.py` +
WAL/snapshot stack, behind a thin router:

* `RoutingMap` — the course→group table. Replicated as JSON in the META
  group's kv (group 0) under `routing_map`, so every node converges on
  the same map through ordinary Raft replication. Group 0 doubles as
  the byte-compat group: its data dir layout is exactly the pre-sharding
  layout, so `groups = 1` (or absent) boots existing WAL/snapshot files
  unmodified.
* `RoutedLMSServicer` — the public LMS surface. Resolves each RPC's
  subject to a home group, executes locally when this node leads that
  group, otherwise forwards ONE hop to the leader's router (targeted via
  `x-lms-group` metadata; a hop counter prevents forwarding loops).
  Cross-group reads (course materials, unanswered queries) fan out and
  merge. Auth (Register/Login/Logout) is replicated to ALL groups — the
  router mints the salt/token once and forces it onto every leg via
  metadata, so sessions verify on whichever group a later RPC lands on.
* `ReshardCoordinator` — live resharding as a staged handoff journaled
  in the meta group: freeze the moving users on the source (writes for
  them become UNAVAILABLE retries), read-fence and slice the source
  state, install the slice on the target (the source's idempotency
  ledger rides along so in-flight client retries dedup), flip the
  routing map atomically, then drop the source copy behind tombstones.
  Every step is idempotent and journaled BEFORE the next begins, so
  `recover()` rolls any crash forward to a consistent map with zero
  acked-write loss. The `on_step` hook exists for the crash-point
  checker in tests: it fires after each persisted step.

Per-group observability is served by `GroupsAdmin.topology()` (GET
/admin/raft) rather than dynamic per-group metric names — the metrics
registry deliberately forbids runtime-formatted series.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import grpc

from ..proto import lms_pb2
from ..proto import rpc
from ..utils import metrics_registry as series
from ..utils.metrics import Metrics
from ..utils.resilience import (
    REQUEST_ID_METADATA_KEY,
    Deadline,
    request_id_from_grpc_context,
)
from ..utils.tracing import trace_metadata
from .minting import mint_salt, mint_session_token
from .state import LMSState

log = logging.getLogger("lms.group_router")

# Meta-group kv keys (group 0 is the meta group).
ROUTING_MAP_KEY = "routing_map"
RESHARD_JOURNAL_KEY = "reshard"

# Router wire metadata. `x-lms-group` marks a targeted forward (the
# receiver executes on that group and never re-fans-out); `x-lms-hops`
# bounds forwarding chains; `x-lms-user` is a ROUTING HINT only — the
# inner handlers still authenticate the token themselves, so a lying
# client can at worst mis-route to a group that rejects it.
GROUP_METADATA_KEY = "x-lms-group"
HOPS_METADATA_KEY = "x-lms-hops"
USER_METADATA_KEY = "x-lms-user"
# Forced auth material for replicated Register/Login: the entry router
# mints one salt/token and pins it onto every group's leg so all groups
# store identical credentials/sessions.
AUTH_SALT_METADATA_KEY = "x-lms-auth-salt"
AUTH_TOKEN_METADATA_KEY = "x-lms-auth-token"
# Router-to-router HMAC over the x-lms-* control pairs of a forwarded
# leg. Routers share a deployment secret; clients never see it, so a
# client cannot target its own writes at a non-home group (x-lms-group)
# or pin its own KDF salt / session token (x-lms-auth-*) — unsigned or
# bad-signature control metadata is simply ignored and the RPC routes
# as client-originated. `x-lms-user` stays an UNSIGNED hint: the client
# legitimately sends it, and it is routing-advisory only (the inner
# handlers authenticate the token themselves).
ROUTER_SIG_METADATA_KEY = "x-lms-router-sig"

MAX_FORWARD_HOPS = 2


def stable_hash(name: str) -> int:
    """Deterministic cross-process hash (builtin hash() is salted)."""
    return int(hashlib.sha1(name.encode()).hexdigest()[:12], 16)


def sign_router_metadata(secret: str, pairs: List[Tuple[str, str]]) -> str:
    """HMAC-SHA256 vouching that a set of x-lms-* control pairs was
    minted by a router, not forged by a client. Pairs are canonicalized
    sorted, so metadata reordering on the wire cannot break the check.
    A replayed signature can only repeat the identical (idempotent)
    routing decision it originally authorized."""
    canon = "\n".join(f"{k}={v}" for k, v in sorted(pairs))
    return hmac.new(secret.encode(), canon.encode(), hashlib.sha256).hexdigest()


# --------------------------------------------------------------------------
# Routing map


@dataclass
class RoutingMap:
    """The replicated course→group table.

    Resolution order for a username: explicit override → course table
    (via the deployment's course_of function) → stable hash. The map is
    versioned; every flip bumps `version` so auditors and drills can
    wait on propagation.
    """

    version: int = 1
    n_groups: int = 1
    courses: Dict[str, int] = field(default_factory=dict)
    overrides: Dict[str, int] = field(default_factory=dict)

    @staticmethod
    def initial(n_groups: int, courses: Optional[List[str]] = None) -> "RoutingMap":
        table = {c: i % n_groups for i, c in enumerate(sorted(courses or []))}
        return RoutingMap(version=1, n_groups=n_groups, courses=table)

    def group_for(
        self,
        username: str,
        course_of: Optional[Callable[[str], Optional[str]]] = None,
    ) -> int:
        gid = self.overrides.get(username)
        if gid is not None and 0 <= gid < self.n_groups:
            return gid
        if course_of is not None:
            course = course_of(username)
            if course is not None:
                gid = self.courses.get(course)
                if gid is not None and 0 <= gid < self.n_groups:
                    return gid
        return stable_hash(username) % self.n_groups

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "n_groups": self.n_groups,
                "courses": self.courses,
                "overrides": self.overrides,
            },
            sort_keys=True,
        )

    @staticmethod
    def from_json(raw: str) -> "RoutingMap":
        doc = json.loads(raw)
        return RoutingMap(
            version=int(doc.get("version", 1)),
            n_groups=int(doc.get("n_groups", 1)),
            courses={str(k): int(v) for k, v in doc.get("courses", {}).items()},
            overrides={str(k): int(v) for k, v in doc.get("overrides", {}).items()},
        )


class GroupLeaderHints:
    """Per-group leader cache (the client's leader-hint cache, keyed by group).

    Evict/distrust is per group: losing group 2's leader must not blow
    away perfectly good hints for groups 0 and 1.
    """

    def __init__(self) -> None:
        self._hints: Dict[int, int] = {}

    def get(self, gid: int) -> Optional[int]:
        return self._hints.get(gid)

    def update(self, gid: int, node_id: int) -> None:
        self._hints[gid] = node_id

    def evict(self, gid: int) -> None:
        self._hints.pop(gid, None)

    def snapshot(self) -> Dict[int, int]:
        return dict(self._hints)


# --------------------------------------------------------------------------
# Routed servicer


class RouteError(Exception):
    """Internal routing failure carrying a gRPC status; the public
    handler converts it into a context.abort."""

    def __init__(self, code: grpc.StatusCode, details: str) -> None:
        super().__init__(details)
        self.code = code
        self.details = details


class _InnerContext:
    """Context wrapper for locally-dispatched legs.

    Overrides exactly two things: `invocation_metadata` (to strip the
    raw wire's x-lms-* pairs and append only the pairs the router
    minted or signature-verified) and `abort` (to raise RouteError so a
    fan-out can observe one leg's failure without killing the real gRPC
    context). Everything else delegates to the real context.

    `lms_router_leg` marks the context as router-dispatched: the inner
    servicer's `_forced_auth` only honors x-lms-auth-* metadata behind
    this mark, so a client dialing a single-group servicer directly
    cannot pin its own salt or session token.
    """

    lms_router_leg = True

    def __init__(self, inner: Any, extra: Optional[List[Tuple[str, str]]] = None) -> None:
        self._inner = inner
        self._extra = list(extra or [])

    def invocation_metadata(self) -> List[Tuple[str, str]]:
        base = self._inner.invocation_metadata() or ()
        kept = [
            (str(k), str(v))
            for k, v in base
            if not str(k).startswith("x-lms-")
        ]
        return kept + self._extra

    async def abort(self, code: grpc.StatusCode, details: str = "") -> None:
        raise RouteError(code, details)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def _metadata_get(context: Any, key: str) -> Optional[str]:
    md = context.invocation_metadata() or ()
    for k, v in md:
        if k == key:
            return str(v)
    return None


class RoutedLMSServicer(rpc.LMSServicer):  # type: ignore[misc]
    """The sharded control plane's public LMS surface.

    Wraps one inner `LMSServicer` per hosted Raft group and routes each
    RPC: home-group writes/reads by subject, fan-out-merge for
    cross-group reads, replicated fan-out for auth. Forwards ride the
    ordinary LMS wire to the owning group's leader NODE (every node
    hosts a router), targeted with `x-lms-group` metadata.
    """

    def __init__(
        self,
        lms_nodes: Dict[int, Any],
        inner: Dict[int, Any],
        lms_addresses: Dict[int, str],
        self_id: int,
        *,
        course_of: Optional[Callable[[str], Optional[str]]] = None,
        initial_map: Optional[RoutingMap] = None,
        metrics: Optional[Metrics] = None,
        forward_timeout_s: float = 5.0,
        router_secret: str = "",
    ) -> None:
        self._nodes = lms_nodes
        self._inner = inner
        self._addresses = lms_addresses  # live reference: membership sync
        self._self_id = self_id
        self._course_of = course_of
        self._initial_map = initial_map or RoutingMap.initial(len(lms_nodes))
        self.metrics = metrics or Metrics()
        self._forward_timeout_s = forward_timeout_s
        # Shared across every router of ONE deployment ([groups] secret;
        # the sim cluster mints a random one per cluster). Signs the
        # x-lms-* control pairs of forwarded legs so peers can tell
        # router-minted metadata from client forgeries. The empty default
        # keeps ad-hoc boots working (all routers agree on the empty
        # key) but offers no forgery protection — set a real secret in
        # any deployment that untrusted clients can reach.
        self._router_secret = router_secret
        self.hints = GroupLeaderHints()
        self._map_raw: Optional[str] = None
        self._map_cache: RoutingMap = self._initial_map
        self._channels: Dict[str, Any] = {}
        self._stubs: Dict[str, Any] = {}

    # ------------------------------------------------------------- routing

    def routing_map(self) -> RoutingMap:
        """Parse (with cache) the replicated map from the meta group's
        local kv replica; fall back to the boot-time map before the
        first replicated write lands."""
        raw = self._nodes[0].state.data["kv"].get(ROUTING_MAP_KEY)
        if raw is None:
            return self._initial_map
        if raw != self._map_raw:
            try:
                self._map_cache = RoutingMap.from_json(raw)
                self._map_raw = raw
                self.metrics.set_gauge(
                    series.ROUTING_MAP_VERSION, float(self._map_cache.version)
                )
            except (ValueError, KeyError, TypeError):
                log.warning("unparseable routing map; keeping previous")
                self._map_raw = raw
        return self._map_cache

    def group_ids(self) -> List[int]:
        return sorted(self._nodes)

    def _home_group(self, username: Optional[str]) -> int:
        if username is None:
            return 0
        return self.routing_map().group_for(username, self._course_of)

    def _resolve_user(self, token: str, context: Any) -> Optional[str]:
        """Best-effort username for routing: any local group replica
        that knows the session, else the client's routing hint. Auth is
        still enforced by the inner handler — a wrong/lying hint at
        worst routes to a group that rejects the token."""
        for gid in self.group_ids():
            user = self._nodes[gid].state.user_of_token(token)
            if user is not None:
                return str(user)
        return _metadata_get(context, USER_METADATA_KEY)

    def _signed_md(self, context: Any) -> Dict[str, str]:
        """The x-lms-* control pairs of this RPC, honored only when the
        sending router's HMAC over them verifies. No signature or a bad
        one → empty dict: the RPC is treated as client-originated and
        its forged x-lms-group / x-lms-auth-* pairs are ignored."""
        pairs = [
            (str(k), str(v))
            for k, v in (context.invocation_metadata() or ())
            if str(k).startswith("x-lms-") and str(k) != ROUTER_SIG_METADATA_KEY
        ]
        if not pairs:
            return {}
        sig = _metadata_get(context, ROUTER_SIG_METADATA_KEY)
        if sig is None or not hmac.compare_digest(
            sign_router_metadata(self._router_secret, pairs), sig
        ):
            # The bare user hint is a documented client-sent pair; only
            # count actual control-metadata forgeries.
            if any(k != USER_METADATA_KEY for k, _ in pairs):
                self.metrics.inc(series.ROUTER_UNSIGNED_METADATA)
            return {}
        return dict(pairs)

    def _relayed_auth_md(
        self,
        context: Any,
        present: Optional[List[Tuple[str, str]]],
    ) -> List[Tuple[str, str]]:
        """Signature-verified forced-auth pairs from the wire, minus any
        the caller is already carrying — so a forwarded Register/Login
        leg keeps its entry-router salt/token through local dispatch and
        further hops alike."""
        signed = self._signed_md(context)
        have = {k for k, _ in (present or [])}
        return [
            (key, signed[key])
            for key in (AUTH_SALT_METADATA_KEY, AUTH_TOKEN_METADATA_KEY)
            if key in signed and key not in have
        ]

    def _hops(self, context: Any) -> int:
        raw = self._signed_md(context).get(HOPS_METADATA_KEY)
        try:
            return int(raw) if raw is not None else 0
        except ValueError:
            return 0

    def _targeted_group(self, context: Any) -> Optional[int]:
        raw = self._signed_md(context).get(GROUP_METADATA_KEY)
        if raw is None:
            return None
        try:
            gid = int(raw)
        except ValueError:
            raise RouteError(grpc.StatusCode.INVALID_ARGUMENT, "bad x-lms-group")
        if gid not in self._nodes:
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE, f"group {gid} not hosted here"
            )
        return gid

    # ----------------------------------------------------------- execution

    def _guard_subject(self, gid: int, subject: Optional[str]) -> None:
        """Refuse work for a user mid-handoff on this group. Frozen →
        the slice is being copied out; moved → our map (or the
        sender's) is stale. Both become UNAVAILABLE so the client
        retries and re-resolves against the flipped map — an acked
        write is never silently dropped by a freeze."""
        if subject is None:
            return
        state = self._nodes[gid].state
        if state.frozen_for(subject):
            self.metrics.inc(series.ROUTER_FROZEN_REJECTIONS)
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"user {subject!r} is mid-reshard on group {gid}; retry",
            )
        if subject in state.data.get("moved", {}):
            self.metrics.inc(series.ROUTER_FROZEN_REJECTIONS)
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"user {subject!r} moved off group {gid}; re-resolve and retry",
            )

    async def _execute(
        self,
        gid: int,
        name: str,
        request: Any,
        context: Any,
        *,
        extra_md: Optional[List[Tuple[str, str]]] = None,
        subject: Optional[str] = None,
        write: bool = False,
    ) -> Any:
        """Run `name` on group `gid`'s leader: locally when this node
        leads the group, else one forwarded hop to the leader's router."""
        node = self._nodes[gid]
        if node.node.is_leader:
            if write:
                self._guard_subject(gid, subject)
            handler = getattr(self._inner[gid], name)
            # A forwarded auth leg carries the entry router's forced
            # salt/token on the wire; re-vouch the verified pairs into
            # the inner context (which strips all raw x-lms-* metadata).
            inner_md = (extra_md or []) + self._relayed_auth_md(context, extra_md)
            response = await handler(request, _InnerContext(context, inner_md))
            if write and subject is not None and node.state.frozen_for(subject):
                # Freeze committed around our write. The write either
                # landed pre-freeze (it rides the slice, and the
                # client's retry dedups on the target via the carried
                # idempotency ledger) or was a frozen no-op — either
                # way, retrying is safe and acking is not provably so.
                self.metrics.inc(series.ROUTER_FROZEN_REJECTIONS)
                raise RouteError(
                    grpc.StatusCode.UNAVAILABLE,
                    f"user {subject!r} froze mid-write on group {gid}; retry",
                )
            self.hints.update(gid, self._self_id)
            return response
        if self._hops(context) >= MAX_FORWARD_HOPS:
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"forward hop limit reached for group {gid}",
            )
        leader = node.node.leader_id
        if leader is None or leader == self._self_id:
            leader = self.hints.get(gid)
        if leader is None or leader == self._self_id or leader not in self._addresses:
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE, f"group {gid} has no known leader"
            )
        response = await self._forward(
            self._addresses[leader], gid, name, request, context, extra_md
        )
        # Hints are an advisory last-wins cache: a concurrent request
        # confirming a different leader may land first, and the next
        # miss self-corrects — staleness costs one extra hop, never
        # correctness.
        self.hints.update(gid, leader)  # lint: disable=atomicity-across-await
        return response

    def _stub(self, address: str) -> Any:
        stub = self._stubs.get(address)
        if stub is None:
            channel = grpc.aio.insecure_channel(address)
            self._channels[address] = channel
            stub = rpc.LMSStub(channel)
            self._stubs[address] = stub
        return stub

    async def _forward(
        self,
        address: str,
        gid: int,
        name: str,
        request: Any,
        context: Any,
        extra_md: Optional[List[Tuple[str, str]]] = None,
    ) -> Any:
        """One targeted hop to the group leader's router over the LMS
        wire. Deadline budget, request id, trace context, and the user
        routing hint all propagate; the explicit per-RPC branches keep
        every egress visible to the deadline-flow and trace-propagation
        lint rules (a dynamic getattr dispatch would blind them)."""
        deadline = Deadline.from_grpc_context(context)
        timeout = (
            deadline.timeout(cap=self._forward_timeout_s)
            if deadline is not None
            else self._forward_timeout_s
        )
        md: List[Tuple[str, str]] = [
            (GROUP_METADATA_KEY, str(gid)),
            (HOPS_METADATA_KEY, str(self._hops(context) + 1)),
        ]
        rid = request_id_from_grpc_context(context)
        if rid:
            md.append((REQUEST_ID_METADATA_KEY, rid))
        user_hint = _metadata_get(context, USER_METADATA_KEY)
        if user_hint:
            md.append((USER_METADATA_KEY, user_hint))
        if deadline is not None:
            md.extend(deadline.to_metadata())
        if extra_md:
            md.extend(extra_md)
        # Multi-hop auth legs: keep relaying the entry router's verified
        # salt/token, then sign every x-lms-* control pair so the next
        # router can tell this leg from a client forgery.
        md.extend(self._relayed_auth_md(context, md))
        signable = [(k, v) for k, v in md if k.startswith("x-lms-")]
        md.append(
            (ROUTER_SIG_METADATA_KEY,
             sign_router_metadata(self._router_secret, signable))
        )
        stub = self._stub(address)
        self.metrics.inc(series.ROUTER_GROUP_FORWARDS)
        try:
            if name == "Register":
                return await stub.Register(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "Login":
                return await stub.Login(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "Logout":
                return await stub.Logout(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "Post":
                return await stub.Post(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "Get":
                return await stub.Get(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "GradeAssignment":
                return await stub.GradeAssignment(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "GetGrade":
                return await stub.GetGrade(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "GetLLMAnswer":
                return await stub.GetLLMAnswer(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "GetUnansweredQueries":
                return await stub.GetUnansweredQueries(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "RespondToQuery":
                return await stub.RespondToQuery(request, timeout=timeout, metadata=trace_metadata(md))
            elif name == "GetInstructorResponse":
                return await stub.GetInstructorResponse(request, timeout=timeout, metadata=trace_metadata(md))
            raise RouteError(
                grpc.StatusCode.INTERNAL, f"unroutable RPC {name!r}"
            )
        except grpc.RpcError as exc:
            self.hints.evict(gid)
            code = exc.code() if hasattr(exc, "code") else "?"
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"forward to group {gid} leader failed ({code}); retry",
            )

    async def _execute_stream(
        self,
        gid: int,
        request: Any,
        context: Any,
        *,
        extra_md: Optional[List[Tuple[str, str]]] = None,
        subject: Optional[str] = None,
    ) -> Any:
        """Streamed `StreamLLMAnswer` on group `gid`'s leader: local
        async-generator dispatch when this node leads the group, else
        one forwarded streaming hop to the leader's router.

        Freeze-guard parity with the unary GetLLMAnswer: the pre-check
        runs before the first chunk (the degraded fallback's AskQuery
        propose happens only pre-first-byte, so a frozen user is turned
        away before any write could be no-opped). There is no post-write
        re-check — once chunks have streamed, the answer was delivered
        and retrying would double-deliver; a freeze that lands mid-answer
        only affects the NEXT turn's routing."""
        node = self._nodes[gid]
        if node.node.is_leader:
            self._guard_subject(gid, subject)
            inner_md = (extra_md or []) + self._relayed_auth_md(
                context, extra_md
            )
            handler = self._inner[gid].StreamLLMAnswer
            async for chunk in handler(
                request, _InnerContext(context, inner_md)
            ):
                yield chunk
            self.hints.update(gid, self._self_id)
            return
        if self._hops(context) >= MAX_FORWARD_HOPS:
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"forward hop limit reached for group {gid}",
            )
        leader = node.node.leader_id
        if leader is None or leader == self._self_id:
            leader = self.hints.get(gid)
        if (leader is None or leader == self._self_id
                or leader not in self._addresses):
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"group {gid} has no known leader",
            )
        deadline = Deadline.from_grpc_context(context)
        timeout = (
            deadline.timeout(cap=self._forward_timeout_s)
            if deadline is not None
            else self._forward_timeout_s
        )
        md: List[Tuple[str, str]] = [
            (GROUP_METADATA_KEY, str(gid)),
            (HOPS_METADATA_KEY, str(self._hops(context) + 1)),
        ]
        rid = request_id_from_grpc_context(context)
        if rid:
            md.append((REQUEST_ID_METADATA_KEY, rid))
        user_hint = _metadata_get(context, USER_METADATA_KEY)
        if user_hint:
            md.append((USER_METADATA_KEY, user_hint))
        if deadline is not None:
            md.extend(deadline.to_metadata())
        if extra_md:
            md.extend(extra_md)
        md.extend(self._relayed_auth_md(context, md))
        signable = [(k, v) for k, v in md if k.startswith("x-lms-")]
        md.append(
            (ROUTER_SIG_METADATA_KEY,
             sign_router_metadata(self._router_secret, signable))
        )
        stub = self._stub(self._addresses[leader])
        self.metrics.inc(series.ROUTER_GROUP_FORWARDS)
        delivered = False
        try:
            async for chunk in stub.StreamLLMAnswer(
                request, timeout=timeout, metadata=trace_metadata(md)
            ):
                delivered = True
                yield chunk
        except grpc.RpcError as exc:
            self.hints.evict(gid)
            code = exc.code() if hasattr(exc, "code") else "?"
            # Mid-stream loss after chunks already went out cannot be
            # transparently retried here (the router does not know the
            # client's delivered offset) — surface UNAVAILABLE so the
            # CLIENT resumes at its own offset; pre-first-chunk the
            # failure is an ordinary retryable routing error.
            raise RouteError(
                grpc.StatusCode.UNAVAILABLE,
                f"stream forward to group {gid} leader "
                f"{'lost mid-answer' if delivered else 'failed'} "
                f"({code}); "
                + ("resume at your delivered offset"
                   if delivered else "retry"),
            )
        self.hints.update(gid, leader)

    # ------------------------------------------------------ dispatch modes

    async def _route_subject(
        self,
        name: str,
        request: Any,
        context: Any,
        subject: Optional[str],
        *,
        write: bool,
    ) -> Any:
        targeted = self._targeted_group(context)
        gid = targeted if targeted is not None else self._home_group(subject)
        extra: Optional[List[Tuple[str, str]]] = None
        if targeted is None and subject is not None:
            extra = [(USER_METADATA_KEY, subject)]
        return await self._execute(
            gid, name, request, context, extra_md=extra, subject=subject, write=write
        )

    async def _fanout_read(self, name: str, request: Any, context: Any) -> Any:
        """Cross-group read: execute on every group's leader and merge.
        Any failed leg fails the whole read — a partial merge would
        silently violate read-your-writes for rows on the failed group."""
        targeted = self._targeted_group(context)
        if targeted is not None:
            return await self._execute(targeted, name, request, context)
        self.metrics.inc(series.ROUTER_FANOUT_READS)
        responses: List[Any] = []
        for gid in self.group_ids():
            response = await self._execute(gid, name, request, context)
            if not response.success:
                return response  # auth/validation verdicts replicate
            responses.append(response)
        entries: List[Any] = []
        seen: set = set()
        for response in responses:
            for entry in response.entries:
                key = (entry.id, entry.filename, entry.instructor, entry.data)
                if key in seen:
                    continue  # reshard transition: install visible pre-drop
                seen.add(key)
                entries.append(entry)
        message = ""
        if not entries:
            for response in responses:
                if response.message:
                    message = response.message
                    break
        merged = lms_pb2.GetResponse(success=True, message=message)
        merged.entries.extend(entries)
        return merged

    async def _auth_fanout(self, name: str, request: Any, context: Any) -> Any:
        """Replicated auth: run the op on EVERY group so sessions and
        credentials verify wherever a later RPC lands. The router mints
        salt/token once and forces it onto each leg via metadata; the
        meta group's verdict is the client's answer. Any failed
        secondary leg aborts (or heals) the whole op — all three are
        idempotent to retry (first-writer-wins register, re-login,
        re-logout), so UNAVAILABLE is always a safe verdict. Silently
        ignoring a failed leg would let credentials or sessions diverge
        across groups."""
        targeted = self._targeted_group(context)
        if targeted is not None:
            return await self._execute(targeted, name, request, context)
        extra: List[Tuple[str, str]] = []
        if name == "Register":
            stored = self._nodes[0].state.data["users"].get(request.username)
            salt = stored.get("salt", "") if stored else ""
            extra.append((AUTH_SALT_METADATA_KEY, salt or mint_salt()))
        elif name == "Login":
            extra.append((AUTH_TOKEN_METADATA_KEY, mint_session_token()))
        primary = await self._execute(0, name, request, context, extra_md=extra)
        if getattr(primary, "success", True):
            for gid in self.group_ids():
                if gid == 0:
                    continue
                leg = await self._execute(
                    gid, name, request, context, extra_md=extra
                )
                if getattr(leg, "success", True):
                    continue
                if name == "Login":
                    await self._heal_login_leg(gid, request, context, extra)
                elif name == "Register":
                    # The forced-salt register is an idempotent replay on
                    # a healthy group, so a failed leg means this group
                    # holds a CONFLICTING record for the name. Surface a
                    # retryable failure instead of acking divergence.
                    raise RouteError(
                        grpc.StatusCode.UNAVAILABLE,
                        f"auth replication of Register to group {gid} "
                        "failed; retry",
                    )
                elif self._nodes[gid].state.user_of_token(request.token) is not None:
                    # Logout: the only success=False path is an unknown
                    # token, i.e. the session is already absent there —
                    # the desired end state. Abort only when this group
                    # still shows the session (a genuinely diverged leg).
                    raise RouteError(
                        grpc.StatusCode.UNAVAILABLE,
                        f"auth replication of Logout to group {gid} "
                        "failed; retry",
                    )
        return primary

    async def _heal_login_leg(
        self,
        gid: int,
        request: Any,
        context: Any,
        extra: List[Tuple[str, str]],
    ) -> None:
        """A Login leg that fails while the meta group's verdict was
        success means this group never saw the credentials: the user
        predates sharding and exists only on group 0, the byte-compat
        group. Heal lazily at login time — the one moment the plaintext
        password is in hand: replicate a Register carrying group 0's
        stored salt (so the KDF output matches byte-for-byte), then
        retry the Login leg so the session token verifies here too."""
        stored = self._nodes[0].state.data["users"].get(request.username)
        if not stored:
            return
        register = lms_pb2.RegisterRequest(
            username=request.username,
            password=request.password,
            role=stored.get("role", ""),
        )
        salt_md = [(AUTH_SALT_METADATA_KEY, stored.get("salt", ""))]
        await self._execute(gid, "Register", register, context, extra_md=salt_md)
        await self._execute(gid, "Login", request, context, extra_md=extra)

    # ------------------------------------------------------------ handlers

    async def _dispatch(self, kind: str, name: str, request: Any, context: Any) -> Any:
        try:
            if kind == "auth":
                return await self._auth_fanout(name, request, context)
            if kind == "fanout":
                return await self._fanout_read(name, request, context)
            if kind == "token":
                subject = self._resolve_user(request.token, context)
                # GetLLMAnswer counts as a write: its degraded fallback
                # proposes an AskQuery, and a frozen user's fallback
                # would be no-opped by the applier while the handler
                # acks "forwarded to an instructor" — an acked write
                # silently dropped. Guarding it like Post turns the
                # mid-reshard case into an UNAVAILABLE retry instead.
                return await self._route_subject(
                    name, request, context, subject,
                    write=(name in ("Post", "GetLLMAnswer")),
                )
            # kind == "student": explicit subject field on the request
            return await self._route_subject(
                name, request, context, request.studentId or None, write=True
            )
        except RouteError as exc:
            await context.abort(exc.code, exc.details)
            raise  # unreachable: abort always raises

    async def Register(self, request: Any, context: Any) -> Any:
        return await self._dispatch("auth", "Register", request, context)

    async def Login(self, request: Any, context: Any) -> Any:
        return await self._dispatch("auth", "Login", request, context)

    async def Logout(self, request: Any, context: Any) -> Any:
        return await self._dispatch("auth", "Logout", request, context)

    async def Post(self, request: Any, context: Any) -> Any:
        return await self._dispatch("token", "Post", request, context)

    async def Get(self, request: Any, context: Any) -> Any:
        return await self._dispatch("fanout", "Get", request, context)

    async def GradeAssignment(self, request: Any, context: Any) -> Any:
        return await self._dispatch("student", "GradeAssignment", request, context)

    async def GetGrade(self, request: Any, context: Any) -> Any:
        return await self._dispatch("token", "GetGrade", request, context)

    async def GetLLMAnswer(self, request: Any, context: Any) -> Any:
        return await self._dispatch("token", "GetLLMAnswer", request, context)

    async def StreamLLMAnswer(self, request: Any, context: Any) -> Any:
        """Streamed twin of GetLLMAnswer: same token-routing and
        write/freeze guard (the degraded fallback proposes an AskQuery),
        but the response is an async chunk generator, so it dispatches
        through `_execute_stream` instead of `_dispatch`. Session
        affinity is unaffected by group routing — the session rides the
        request to whichever tutoring node the TARGET group's pool pins
        it to, and group targeting is stable for a user between map
        flips."""
        try:
            targeted = self._targeted_group(context)
            subject = self._resolve_user(request.token, context)
            gid = (targeted if targeted is not None
                   else self._home_group(subject))
            extra: Optional[List[Tuple[str, str]]] = None
            if targeted is None and subject is not None:
                extra = [(USER_METADATA_KEY, subject)]
            async for chunk in self._execute_stream(
                gid, request, context, extra_md=extra, subject=subject
            ):
                yield chunk
        except RouteError as exc:
            await context.abort(exc.code, exc.details)

    async def GetUnansweredQueries(self, request: Any, context: Any) -> Any:
        return await self._dispatch("fanout", "GetUnansweredQueries", request, context)

    async def RespondToQuery(self, request: Any, context: Any) -> Any:
        return await self._dispatch("student", "RespondToQuery", request, context)

    async def GetInstructorResponse(self, request: Any, context: Any) -> Any:
        return await self._dispatch("token", "GetInstructorResponse", request, context)

    async def WhoIsLeader(self, request: Any, context: Any) -> Any:
        # In-process delegation to the co-located group-0 servicer — no
        # wire hop, so there is no outbound metadata to build.
        return await self._inner[0].WhoIsLeader(request, context)  # lint: disable=trace-propagation

    async def close(self) -> None:
        # Snapshot and clear BEFORE awaiting: a dispatch racing shutdown
        # can add channels while channel.close() suspends, and a clear()
        # after the awaits would silently leak those un-closed.
        channels = list(self._channels.values())
        self._channels.clear()
        self._stubs.clear()
        for channel in channels:
            await channel.close()


# --------------------------------------------------------------------------
# Resharding


class GroupAccess(Protocol):
    """What the reshard coordinator needs from a deployment: leader
    proposals per group, a linearizable fence, leader-replica state
    reads, and meta-group kv IO. Implemented by the sim cluster (live,
    cross-node) and by the crash-point test harness (direct appliers)."""

    def n_groups(self) -> int: ...

    def users(self) -> List[str]: ...

    def state(self, gid: int) -> LMSState: ...

    def current_map(self) -> RoutingMap: ...

    async def read_fence(self, gid: int) -> None: ...

    async def propose(self, gid: int, op: str, args: Dict[str, Any]) -> None: ...

    async def meta_get(self, key: str) -> Optional[str]: ...

    async def meta_set(self, key: str, value: str) -> None: ...


class ReshardCoordinator:
    """Staged group split/merge: move one course's users between groups
    with zero acked-write loss.

    Steps (each journaled in the meta group BEFORE the next begins):

        begin     → journal written; nothing moved yet
        frozen    → FreezeKeys committed on the source
        installed → source fenced, slice committed on the target
        committed → routing map flipped (version bump)
        done      → DropKeys committed on the source (tombstones remain)

    Every state-machine command carries a deterministic request_id
    derived from the reshard id, so `recover()` can blindly re-propose
    the in-flight step — the idempotency ledger drops replays. Rolling
    FORWARD (never back) is what makes crash recovery single-cased: the
    journal names the furthest step known persisted, and everything
    after it is safe to redo.
    """

    def __init__(
        self,
        access: GroupAccess,
        *,
        course_of: Optional[Callable[[str], Optional[str]]] = None,
        metrics: Optional[Metrics] = None,
        on_step: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.access = access
        self._course_of = course_of
        self.metrics = metrics or Metrics()
        self.on_step = on_step

    async def _journal(self, doc: Dict[str, Any]) -> None:
        await self.access.meta_set(RESHARD_JOURNAL_KEY, json.dumps(doc, sort_keys=True))
        self.metrics.inc(series.RESHARD_STEPS)
        if self.on_step is not None:
            self.on_step(str(doc["step"]))

    def _slice(self, state: LMSState, users: List[str]) -> Dict[str, Any]:
        data = state.data
        moving = set(users)
        return {
            "users": list(users),
            "assignments": {
                u: data["assignments"][u] for u in users if u in data["assignments"]
            },
            "queries": {u: data["queries"][u] for u in users if u in data["queries"]},
            "course_materials": [
                m for m in data["course_materials"] if m.get("instructor") in moving
            ],
            # The whole idempotency ledger rides along: a client retry of
            # a pre-freeze mutation that re-lands on the target after the
            # flip is recognized and dropped, not applied twice.
            "applied_requests": dict(data.get("applied_requests", {})),
        }

    async def reshard(self, course: str, dst: int) -> Dict[str, Any]:
        # Never clobber an unfinished journal: journaling a fresh 'begin'
        # over a crashed handoff would orphan its FreezeKeys (no DropKeys
        # ever follows) and leave those users UNAVAILABLE forever. Roll
        # the in-flight handoff forward to 'done' first — every step is
        # idempotent, so this is exactly what a restarted node would do.
        raw = await self.access.meta_get(RESHARD_JOURNAL_KEY)
        if raw is not None:
            prior = json.loads(raw)
            if prior.get("step") != "done":
                log.warning(
                    "reshard %s: rolling forward unfinished handoff %s "
                    "(step %s) before starting",
                    course, prior.get("id"), prior.get("step"),
                )
                await self._run(prior)
        m = self.access.current_map()
        src = m.courses.get(course)
        if src is None:
            raise ValueError(f"unknown course {course!r} in routing map")
        if not 0 <= dst < self.access.n_groups():
            raise ValueError(f"target group {dst} out of range")
        if src == dst:
            return {"ok": True, "id": None, "noop": True, "version": m.version}
        users = sorted(
            u
            for u in self.access.users()
            if self._course_of is not None and self._course_of(u) == course
        )
        rid = f"reshard-{course}-{src}-{dst}-v{m.version}"
        journal = {
            "id": rid,
            "step": "begin",
            "course": course,
            "src": src,
            "dst": dst,
            "users": users,
        }
        await self._journal(journal)
        return await self._run(journal)

    async def recover(self) -> Dict[str, Any]:
        """Roll an interrupted handoff forward to `done`. Safe to call
        when no handoff is in flight."""
        raw = await self.access.meta_get(RESHARD_JOURNAL_KEY)
        if raw is None:
            return {"ok": True, "id": None, "noop": True}
        journal = json.loads(raw)
        if journal["step"] == "done":
            return {"ok": True, "id": journal["id"], "step": "done", "noop": True}
        return await self._run(journal)

    async def _run(self, journal: Dict[str, Any]) -> Dict[str, Any]:
        rid = str(journal["id"])
        course = str(journal["course"])
        src = int(journal["src"])
        dst = int(journal["dst"])
        users = [str(u) for u in journal["users"]]
        if journal["step"] == "begin":
            await self.access.propose(
                src,
                "FreezeKeys",
                {"users": users, "reshard_id": rid, "request_id": rid + ":freeze"},
            )
            journal["step"] = "frozen"
            await self._journal(journal)
        if journal["step"] == "frozen":
            # Fence AFTER the freeze commit so the slice read below sees
            # every write that could ever be acked by the source.
            await self.access.read_fence(src)
            payload = self._slice(self.access.state(src), users)
            await self.access.propose(
                dst,
                "InstallKeys",
                {"payload": payload, "reshard_id": rid, "request_id": rid + ":install"},
            )
            journal["step"] = "installed"
            await self._journal(journal)
        if journal["step"] == "installed":
            m = self.access.current_map()
            if m.courses.get(course) != dst:
                flipped = RoutingMap(
                    version=m.version + 1,
                    n_groups=m.n_groups,
                    courses={**m.courses, course: dst},
                    overrides=dict(m.overrides),
                )
                await self.access.meta_set(ROUTING_MAP_KEY, flipped.to_json())
            journal["step"] = "committed"
            await self._journal(journal)
        if journal["step"] == "committed":
            await self.access.propose(
                src,
                "DropKeys",
                {"users": users, "reshard_id": rid, "request_id": rid + ":drop"},
            )
            journal["step"] = "done"
            await self._journal(journal)
            self.metrics.inc(series.RESHARD_COMPLETED)
        final = self.access.current_map()
        return {
            "ok": True,
            "id": rid,
            "step": "done",
            "course": course,
            "src": src,
            "dst": dst,
            "moved_users": len(users),
            "version": final.version,
        }


# --------------------------------------------------------------------------
# Admin plane


class GroupsAdmin:
    """Read-only topology for GET /admin/raft plus the reshard trigger
    for POST /admin/reshard. Works in single-group deployments too —
    the topology just has one row and resharding is refused."""

    def __init__(
        self,
        lms_nodes: Dict[int, Any],
        *,
        router: Optional[RoutedLMSServicer] = None,
        coordinator: Optional[ReshardCoordinator] = None,
    ) -> None:
        self._nodes = lms_nodes
        self._router = router
        self._coordinator = coordinator

    def topology(self) -> Dict[str, Any]:
        routing: Dict[str, Any] = {"version": 1, "n_groups": len(self._nodes)}
        if self._router is not None:
            m = self._router.routing_map()
            routing = {
                "version": m.version,
                "n_groups": m.n_groups,
                "courses": dict(m.courses),
                "overrides": dict(m.overrides),
            }
        groups: Dict[str, Any] = {}
        for gid, lms_node in sorted(self._nodes.items()):
            raft = lms_node.node
            groups[str(gid)] = {
                "members": {str(nid): addr for nid, addr in sorted(lms_node.addresses.items())},
                "leader": raft.leader_id,
                "is_leader": raft.is_leader,
                "term": raft.core.current_term,
                "applied": raft.core.last_applied,
                "commit": raft.core.commit_index,
                # Replica digest chain (LMSNode._fold_digest): replicas
                # of one group at equal digest_applied must agree here.
                "digest": lms_node.state_digest,
                "digest_applied": lms_node._last_applied_index,
            }
        return {"routing_map": routing, "groups": groups}

    async def reshard(self, body: Dict[str, Any]) -> Dict[str, Any]:
        if self._coordinator is None:
            raise ValueError("resharding is not enabled on this deployment")
        course = body.get("course")
        if not isinstance(course, str) or not course:
            raise ValueError("reshard body needs a 'course' string")
        dst = body.get("to_group")
        if not isinstance(dst, int):
            raise ValueError("reshard body needs an integer 'to_group'")
        return await self._coordinator.reshard(course, dst)
