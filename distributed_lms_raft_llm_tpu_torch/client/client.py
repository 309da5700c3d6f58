"""Leader-discovering LMS client library.

The port's copy of `distributed_lms_raft_llm_tpu/client/client.py`,
its logic as it is.

Reference behavior (GUI_RAFT_LLM_SourceCode/lms_gui_final.py:64-155): poll
`RaftService.WhoIsLeader` across all servers (≤5 rounds, 3 s backoff),
follow redirects to the named leader, and on transient RPC failures
re-resolve the leader and retry (≤3). Reimplemented as a clean synchronous
library the CLI/GUI layers (and tests) share, with channel reuse instead of
per-call dialing.

Retry semantics (utils/resilience.py): every logical operation runs under
ONE overall `Deadline` — created here, propagated to the server as the gRPC
timeout plus an explicit budget header, decremented across redirects and
retries. Transient failures back off with full jitter instead of the
reference's immediate-retry hammering (a synchronized retry herd is what
turns a leader blip into an outage), and the loop stops the moment the
budget is gone — the caller gets its answer or its error within the
deadline, never a hang.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import random
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, TypeVar

import grpc

from ..lms.group_router import USER_METADATA_KEY
from ..proto import lms_pb2, rpc
from ..utils.resilience import (
    REQUEST_ID_METADATA_KEY,
    Deadline,
    DeadlineExpired,
    jittered_backoff,
)
from ..utils.tracing import FLAG_DEADLINE, FLAG_ERROR, get_tracer, \
    trace_metadata

log = logging.getLogger(__name__)

T = TypeVar("T")

RETRYABLE = {
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.UNKNOWN,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.CANCELLED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
}


class NoLeader(Exception):
    pass


@dataclasses.dataclass
class StreamAnswer:
    """One streamed ask_llm's outcome, shaped for unary parity.

    `success`/`response` match `ask_llm`'s QueryResponse contract
    (`response` is the stripped full answer), so call sites can treat
    the two paths interchangeably. The streaming-only evidence rides
    along: chunk/resume counts, time-to-first-token, and the digest
    verdict (`digest_ok` is None when the stream ended on a failure or
    degraded chunk that carries no digest)."""

    success: bool
    response: str
    chunks: int = 0
    resumes: int = 0
    ttft_s: Optional[float] = None
    digest: str = ""
    digest_ok: Optional[bool] = None


class LMSClient:
    def __init__(
        self,
        servers: Sequence[str],
        *,
        discovery_rounds: int = 5,
        discovery_backoff_s: float = 1.0,
        rpc_retries: int = 3,
        rpc_timeout: float = 30.0,
        request_timeout_s: float = 60.0,
        llm_timeout_s: float = 120.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        seed: Optional[int] = None,
        group_of: Optional[Callable[[str], int]] = None,
    ):
        self.servers = list(servers)
        self.discovery_rounds = discovery_rounds
        self.discovery_backoff_s = discovery_backoff_s
        self.rpc_retries = rpc_retries
        self.rpc_timeout = rpc_timeout
        # Overall budgets: one Deadline bounds discovery + all retries of a
        # logical op. ask_llm gets its own (generation is the slow path).
        self.request_timeout_s = request_timeout_s
        self.llm_timeout_s = llm_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = random.Random(seed)
        self.token: Optional[str] = None
        self.role: Optional[str] = None
        self._channels: Dict[str, grpc.Channel] = {}
        # Leader hints keyed by Raft GROUP (sharded control plane, PR 16).
        # Lane 0 is the meta group — the only lane a single-group cluster
        # ever uses, so this stays behavior-identical there. Against a
        # sharded cluster, `group_of` (username → home group) picks the
        # lane per logical op, and a failed RPC distrusts ONLY that lane:
        # losing group 2's leader must not blow away good hints for 0/1.
        self._group_of = group_of
        self._username: Optional[str] = None
        self._leader_hints: Dict[int, str] = {}
        # Leader addresses learned over the wire (GetLeader) that the boot
        # list doesn't contain — a server added by a runtime membership
        # change. Probed during discovery so the client can follow the
        # cluster as it grows; `self.servers` stays the user's boot list
        # (WhoIsLeader's positional id->address mapping depends on it).
        self._extra_servers: List[str] = []

    # ------------------------------------------------------------ plumbing

    def _channel(self, addr: str) -> grpc.Channel:
        if addr not in self._channels:
            self._channels[addr] = grpc.insecure_channel(
                addr,
                options=[
                    ("grpc.max_send_message_length", 50 * 1024 * 1024),
                    ("grpc.max_receive_message_length", 50 * 1024 * 1024),
                ],
            )
        return self._channels[addr]

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()

    @property
    def _leader_addr(self) -> Optional[str]:
        """Back-compat view of the meta-group (lane 0) hint."""
        return self._leader_hints.get(0)

    @_leader_addr.setter
    def _leader_addr(self, addr: Optional[str]) -> None:
        if addr is None:
            self._leader_hints.pop(0, None)
        else:
            self._leader_hints[0] = addr

    def _home_group(self) -> int:
        """The logged-in user's home Raft group (lane 0 when unknown)."""
        if self._group_of is not None and self._username:
            try:
                return max(0, int(self._group_of(self._username)))
            except (TypeError, ValueError):
                return 0
        return 0

    def _set_leader(self, addr: str, group: int = 0) -> str:
        self._leader_hints[group] = addr
        if addr not in self.servers and addr not in self._extra_servers:
            # A leader the boot list doesn't know (membership-added node):
            # remember it as a discovery peer of its own, so the client
            # still finds the cluster if the boot-list nodes go away.
            self._extra_servers.append(addr)
        return addr

    def evict_leader_hint(self, addr: Optional[str] = None,
                          group: Optional[int] = None) -> None:
        """Drop cached leader hints. Called when a hinted node fails an
        RPC — it may have been removed by a membership change, restarted,
        or deposed — so the next op re-discovers from any live peer
        instead of re-dialing a corpse.

        Distrust is scoped: with `group` given, only that group's lane is
        dropped; with only `addr`, every lane currently pointing at that
        address is dropped (but other groups' healthy hints survive);
        with neither, everything goes.

        A wire-learned (off-boot-list) address is also dropped from the
        discovery peers: without this the list grows without bound under
        membership churn and every sweep keeps probing removed nodes. If
        the node is alive and leads again, the next GetLeader re-learns
        it."""
        if group is not None:
            hinted = self._leader_hints.get(group)
            if addr is None or hinted == addr:
                self._leader_hints.pop(group, None)
        elif addr is None:
            self._leader_hints.clear()
        else:
            for lane in [g for g, a in self._leader_hints.items() if a == addr]:
                self._leader_hints.pop(lane, None)
        if addr is not None and addr in self._extra_servers:
            self._extra_servers.remove(addr)

    def discover_leader(
        self, force: bool = False, deadline: Optional[Deadline] = None,
        avoid: Optional[str] = None, group: Optional[int] = None,
    ) -> str:
        """Address of the current leader (cached until an RPC fails).

        Bounded by `deadline` when given: discovery gives up the moment the
        caller's budget is gone instead of finishing its sweep schedule.

        `avoid` is an address that just failed an RPC (the evicted hint):
        it is probed last, and during the first sweep a peer's report
        naming it is treated as stale churn — other peers get the chance
        to name the REAL leader first. If a full sweep produces nothing
        else, the avoided address is accepted after all (the failure may
        have been transient), so discovery degrades gracefully instead of
        blacklisting a healthy node.

        `group` selects the hint lane (default: the logged-in user's home
        group). Discovery itself names the meta-group leader — ANY router
        node accepts and forwards every RPC — so against a sharded
        cluster each lane converges on the entry point that served it
        last, and eviction on failure is per group.
        """
        lane = self._home_group() if group is None else group
        hinted = self._leader_hints.get(lane)
        if hinted and not force:
            return hinted
        for attempt in range(self.discovery_rounds):
            # Probe healthy candidates first; the just-failed node last.
            order = [a for a in (*self.servers, *self._extra_servers)
                     if a != avoid]
            if avoid is not None:
                order.append(avoid)
            fallback: Optional[str] = None
            for addr in order:
                if deadline is not None and deadline.expired:
                    raise NoLeader(
                        f"no leader found among {self.servers} within budget"
                    )
                try:
                    probe_timeout = 2.0
                    if deadline is not None:
                        probe_timeout = max(0.1, deadline.timeout(cap=2.0))
                    stub = rpc.RaftServiceStub(self._channel(addr))
                    resp = stub.GetLeader(
                        lms_pb2.GetLeaderRequest(), timeout=probe_timeout
                    )
                    if resp.nodeId > 0 and resp.nodeAddress:
                        if resp.nodeAddress == avoid and attempt == 0:
                            fallback = resp.nodeAddress
                            continue
                        return self._set_leader(resp.nodeAddress, lane)
                    who = stub.WhoIsLeader(lms_pb2.Empty(), timeout=probe_timeout)
                    if 0 < who.leader_id <= len(self.servers):
                        cand = self.servers[who.leader_id - 1]
                        if cand == avoid and attempt == 0:
                            fallback = cand
                            continue
                        return self._set_leader(cand, lane)
                except grpc.RpcError:
                    continue
            if fallback is not None:
                # Every live peer still names the avoided address and a
                # full sweep found no alternative: trust it after all.
                return self._set_leader(fallback, lane)
            sleep_s = jittered_backoff(
                attempt, base_s=self.discovery_backoff_s,
                cap_s=self.discovery_backoff_s * 4, rng=self._rng,
            )
            if deadline is not None:
                if deadline.expired:
                    break
                sleep_s = min(sleep_s, deadline.remaining())
            time.sleep(sleep_s)
        raise NoLeader(f"no leader found among {self.servers}")

    def _call(
        self,
        fn: Callable[[rpc.LMSStub, float, Optional[Deadline]], T],
        *,
        budget_s: Optional[float] = None,
        attempt_cap_s: Optional[float] = -1.0,
        route: str = "call",
        trace_id: Optional[str] = None,
    ) -> T:
        """Run an op against the leader under one overall deadline.

        `fn(stub, timeout, deadline)` performs the RPC with the given
        per-attempt timeout (the remaining budget capped at rpc_timeout).
        Transient failures re-resolve the leader and retry with jittered
        exponential backoff until the retry count or the budget runs out.

        Mutating callers bake a `request_id` into the request (see
        `_request_id`): the SAME id is re-sent on every retry, so if the
        original proposal actually committed (e.g. the client timed out
        waiting for the quorum ACK), the replicated applier drops the
        duplicate instead of double-applying a non-idempotent command.
        """
        deadline = Deadline.after(budget_s or self.request_timeout_s)
        # -1 sentinel: default to the per-attempt rpc_timeout cap; None
        # means "let one attempt use the whole remaining budget" (ask_llm,
        # where generation legitimately outlasts control-plane RPCs).
        cap = self.rpc_timeout if attempt_cap_s == -1.0 else attempt_cap_s
        # ONE client span covers the whole logical op — discovery, every
        # retry, the backoffs between them. Server-side fragments graft
        # under it via the x-trace-context each attempt carries (_md), and
        # mutating ops reuse their idempotency id as the trace id, so
        # `/admin/trace/<request-id>` answers for the id already in logs.
        with get_tracer().trace(f"client.{route}",
                                trace_id=trace_id) as root:
            return self._attempts(fn, deadline, cap, budget_s, root)

    def _attempts(
        self,
        fn: Callable[[rpc.LMSStub, float, Optional[Deadline]], T],
        deadline: Deadline,
        cap: Optional[float],
        budget_s: Optional[float],
        root,
    ) -> T:
        last_error: Optional[Exception] = None
        avoid: Optional[str] = None
        lane = self._home_group()
        for attempt in range(self.rpc_retries + 1):
            if deadline.expired:
                break
            addr = None
            try:
                addr = self.discover_leader(force=attempt > 0,
                                            deadline=deadline, avoid=avoid,
                                            group=lane)
                stub = rpc.LMSStub(self._channel(addr))
                timeout = max(0.001, deadline.timeout(cap=cap))
                return fn(stub, timeout, deadline)
            except grpc.RpcError as e:
                last_error = e
                if e.code() not in RETRYABLE:
                    raise
                if addr is not None:
                    # Evict the hint and steer the next discovery sweep
                    # away from the failed node: mid-churn (a membership
                    # remove, a rolling restart) stale peers may keep
                    # naming it, and re-trusting them first would pin every
                    # retry on the same dead address. Distrust is scoped to
                    # this op's group lane — other groups keep their hints.
                    self.evict_leader_hint(addr, group=lane)
                    avoid = addr
                log.info("rpc failed (%s); re-resolving leader", e.code())
                if attempt >= self.rpc_retries:
                    break  # out of attempts: fail now, don't sleep first
                sleep_s = min(
                    jittered_backoff(
                        attempt, base_s=self.backoff_base_s,
                        cap_s=self.backoff_max_s, rng=self._rng,
                    ),
                    deadline.remaining(),
                )
                if sleep_s > 0:
                    time.sleep(sleep_s)
        if last_error is not None:
            root.flag(FLAG_ERROR)
            raise last_error
        root.flag(FLAG_DEADLINE)
        raise DeadlineExpired(
            f"request budget ({budget_s or self.request_timeout_s:.1f}s) "
            "exhausted before the first attempt"
        )

    @staticmethod
    def _request_id() -> str:
        """Idempotency key for one logical mutation (stable across retries)."""
        return uuid.uuid4().hex

    def _md(self, deadline: Optional[Deadline],
            request_id: Optional[str] = None):
        """Per-attempt metadata: the live deadline budget, plus (when given)
        the logical request id — the SAME id on every retry, so server-side
        mutations made on this request's behalf (the degraded instructor
        fallback) dedupe in the replicated applier."""
        md = deadline.to_metadata() if deadline is not None else []
        if request_id:
            md = md + [(REQUEST_ID_METADATA_KEY, request_id)]
        if self.token and self._username:
            # Routing HINT for the sharded control plane: lets a router
            # whose local session replicas lag still home-route the op.
            # Auth stays with the token — a wrong hint only mis-routes to
            # a group that rejects it.
            md = md + [(USER_METADATA_KEY, self._username)]
        # The trace context rides the same metadata: each attempt carries
        # the client span's position so server fragments graft under it.
        return trace_metadata(md)

    # ----------------------------------------------------------------- api

    def register(self, username: str, password: str, role: str):
        return self._call(
            lambda s, t, d: s.Register(
                lms_pb2.RegisterRequest(
                    username=username, password=password, role=role
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="register",
        )

    def login(self, username: str, password: str) -> bool:
        resp = self._call(
            lambda s, t, d: s.Login(
                lms_pb2.LoginRequest(username=username, password=password),
                timeout=t, metadata=self._md(d),
            ),
            route="login",
        )
        if resp.success:
            self.token = resp.token
            self.role = resp.role
            self._username = username
        return resp.success

    def logout(self) -> bool:
        if not self.token:
            return False
        resp = self._call(
            lambda s, t, d: s.Logout(
                lms_pb2.LogoutRequest(token=self.token), timeout=t,
                metadata=self._md(d),
            ),
            route="logout",
        )
        if resp.success:
            self.token = None
            self.role = None
        return resp.success

    def upload_assignment(self, filename: str, content: bytes) -> bool:
        rid = self._request_id()
        return self._call(
            lambda s, t, d: s.Post(
                lms_pb2.PostRequest(
                    token=self.token or "", type="assignment",
                    file=content, filename=filename, request_id=rid,
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="upload_assignment", trace_id=rid,
        ).success

    def upload_course_material(self, filename: str, content: bytes) -> bool:
        rid = self._request_id()
        return self._call(
            lambda s, t, d: s.Post(
                lms_pb2.PostRequest(
                    token=self.token or "", type="course_material",
                    file=content, filename=filename, request_id=rid,
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="upload_course_material", trace_id=rid,
        ).success

    def ask_instructor(self, query: str) -> bool:
        rid = self._request_id()
        return self._call(
            lambda s, t, d: s.Post(
                lms_pb2.PostRequest(
                    token=self.token or "", type="query", data=query,
                    request_id=rid,
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="ask_instructor", trace_id=rid,
        ).success

    def course_materials(self) -> List[lms_pb2.DataEntry]:
        resp = self._call(
            lambda s, t, d: s.Get(
                lms_pb2.GetRequest(token=self.token or "", type="course_material"),
                timeout=t, metadata=self._md(d),
            ),
            route="course_materials",
        )
        return list(resp.entries)

    def student_assignments(self) -> List[lms_pb2.DataEntry]:
        resp = self._call(
            lambda s, t, d: s.Get(
                lms_pb2.GetRequest(token=self.token or "", type="student_list"),
                timeout=t, metadata=self._md(d),
            ),
            route="student_assignments",
        )
        return list(resp.entries)

    def grade(self, student: str, grade: str):
        rid = self._request_id()
        return self._call(
            lambda s, t, d: s.GradeAssignment(
                lms_pb2.GradeRequest(
                    token=self.token or "", studentId=student, grade=grade,
                    request_id=rid,
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="grade", trace_id=rid,
        )

    def my_grade(self) -> str:
        resp = self._call(
            lambda s, t, d: s.GetGrade(
                lms_pb2.GetGradeRequest(token=self.token or ""),
                timeout=t, metadata=self._md(d),
            ),
            route="my_grade",
        )
        return resp.grade

    def unanswered_queries(self) -> List[lms_pb2.DataEntry]:
        resp = self._call(
            lambda s, t, d: s.GetUnansweredQueries(
                lms_pb2.GetRequest(token=self.token or ""),
                timeout=t, metadata=self._md(d),
            ),
            route="unanswered_queries",
        )
        return list(resp.entries)

    def respond_to_query(self, student: str, response: str) -> bool:
        rid = self._request_id()
        return self._call(
            lambda s, t, d: s.RespondToQuery(
                lms_pb2.PostRequest(
                    token=self.token or "", studentId=student, data=response,
                    request_id=rid,
                ),
                timeout=t, metadata=self._md(d),
            ),
            route="respond_to_query", trace_id=rid,
        ).success

    def instructor_responses(self) -> List[lms_pb2.DataEntry]:
        resp = self._call(
            lambda s, t, d: s.GetInstructorResponse(
                lms_pb2.GetRequest(token=self.token or ""),
                timeout=t, metadata=self._md(d),
            ),
            route="instructor_responses",
        )
        return list(resp.entries)

    def ask_llm(
        self, query: str, *, budget_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> lms_pb2.QueryResponse:
        """One student query under one overall budget (default
        `llm_timeout_s`). The LMS forwards the remaining budget to the
        tutoring node; if tutoring is down or too slow the LMS answers
        degraded (query queued for an instructor) within the budget.

        One `request_id` spans ALL retries of this logical call: a retry
        whose earlier attempt already queued the degraded instructor entry
        must not queue a second one (ROADMAP item a). It doubles as the
        TRACE id — `GET /admin/trace/<request_id>` returns this call's
        span tree — and callers may supply their own (pre-logged) id."""
        rid = request_id or self._request_id()
        return self._call(
            lambda s, t, d: s.GetLLMAnswer(
                lms_pb2.QueryRequest(token=self.token or "", query=query),
                timeout=t, metadata=self._md(d, request_id=rid),
            ),
            budget_s=budget_s or self.llm_timeout_s,
            attempt_cap_s=None,
            route="ask_llm", trace_id=rid,
        )

    def ask_llm_stream(
        self, query: str, *, session_id: str = "",
        budget_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> StreamAnswer:
        """Streamed ask_llm under the resumable-stream contract.

        The client tracks the last delivered token offset; any mid-stream
        failure (leader loss, a serving-node kill behind the LMS, a
        breaker opening) re-discovers the leader and RESUMES at that
        offset via `resume_offset` — tokens already delivered are never
        re-requested, and a resumed stream splices gap-free because the
        server regenerates deterministically and skips the delivered
        prefix. Chunks are validated client-side: pure duplicates are
        dropped, an offset gap fails the attempt (retryable — the resend
        starts at our offset), so the delivered text is monotone,
        gap-free, and duplicate-free by construction.

        `session_id` threads conversational turns: the server keys
        tutoring-node affinity on it and splices turn N's transcript as
        a shared KV prefix for turn N+1.

        The final chunk's digest is checked against sha256 of the
        stripped full answer (exactly what unary `ask_llm` returns), so
        `digest_ok=True` proves the streamed answer is bit-identical to
        the unary one end to end — across resumes included."""
        rid = request_id or self._request_id()
        deadline = Deadline.after(budget_s or self.llm_timeout_s)
        delivered = 0
        parts: List[str] = []
        resumes = 0
        chunks = 0
        ttft_s: Optional[float] = None
        with get_tracer().trace("client.ask_llm_stream",
                                trace_id=rid) as root:
            t_start = time.monotonic()
            last_error: Optional[Exception] = None
            avoid: Optional[str] = None
            lane = self._home_group()
            for attempt in range(self.rpc_retries + 1):
                if deadline.expired:
                    break
                addr = None
                if delivered > 0 and attempt > 0:
                    resumes += 1
                try:
                    addr = self.discover_leader(
                        force=attempt > 0, deadline=deadline,
                        avoid=avoid, group=lane,
                    )
                    stub = rpc.LMSStub(self._channel(addr))
                    timeout = max(0.001, deadline.timeout(cap=None))
                    final = None
                    call = stub.StreamLLMAnswer(
                        lms_pb2.StreamRequest(
                            token=self.token or "", query=query,
                            session_id=session_id,
                            resume_offset=delivered,
                        ),
                        timeout=timeout,
                        metadata=self._md(deadline, request_id=rid),
                    )
                    for chunk in call:
                        chunks += 1
                        if chunk.count > 0 and chunk.success:
                            end = chunk.offset + chunk.count
                            if end <= delivered:
                                continue  # pure duplicate: drop
                            if chunk.offset != delivered:
                                # A gap (or mid-chunk overlap) breaks
                                # the monotone contract: fail the
                                # attempt; the resume re-requests from
                                # OUR offset, never trusts the gap.
                                raise grpc.RpcError()
                            if ttft_s is None:
                                ttft_s = time.monotonic() - t_start
                            parts.append(chunk.text)
                            delivered = end
                        if chunk.final:
                            final = chunk
                            break
                    if final is None:
                        # Stream ended cleanly but without a final chunk
                        # (server died between chunks): resume.
                        raise grpc.RpcError()
                    full = "".join(parts)
                    digest_ok: Optional[bool] = None
                    if final.digest:
                        digest_ok = (
                            hashlib.sha256(full.strip().encode())
                            .hexdigest() == final.digest
                        )
                    text = (full.strip() if delivered > 0
                            else final.text)
                    return StreamAnswer(
                        success=final.success, response=text,
                        chunks=chunks, resumes=resumes,
                        ttft_s=ttft_s, digest=final.digest,
                        digest_ok=digest_ok,
                    )
                except grpc.RpcError as e:
                    last_error = e
                    code = e.code() if hasattr(e, "code") else None
                    if code is not None and code not in RETRYABLE:
                        raise
                    if addr is not None:
                        self.evict_leader_hint(addr, group=lane)
                        avoid = addr
                    log.info("stream attempt failed (%s) at offset %d; "
                             "re-resolving leader", code, delivered)
                    if attempt >= self.rpc_retries:
                        break
                    sleep_s = min(
                        jittered_backoff(
                            attempt, base_s=self.backoff_base_s,
                            cap_s=self.backoff_max_s, rng=self._rng,
                        ),
                        deadline.remaining(),
                    )
                    if sleep_s > 0:
                        time.sleep(sleep_s)
            if last_error is not None:
                root.flag(FLAG_ERROR)
                raise last_error
            root.flag(FLAG_DEADLINE)
            raise DeadlineExpired(
                f"stream budget ({budget_s or self.llm_timeout_s:.1f}s) "
                f"exhausted at offset {delivered}"
            )
