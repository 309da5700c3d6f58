"""LMS application service: the 12 `LMS` RPCs + file replication.

The port's copy of `distributed_lms_raft_llm_tpu/lms/service.py`,
its logic as it is.

Behavioral parity with the reference handlers (reference:
GUI_RAFT_LLM_SourceCode/lms_server.py:708-1521) with the surveyed defects
fixed:

- every mutation is `await propose(...)`d and ACKed only after quorum
  COMMIT (reference returned success immediately after proposing, D9);
- sessions are part of the replicated state, so logins survive failover
  (D7): Login/Logout are Raft commands carrying the token minted by the
  leader;
- `WhoIsLeader` is implemented on the LMS service as declared in the
  contract (D6) as well as on RaftService;
- uploads replicate leader→followers via `FileTransferService.SendFile`
  with replace-not-append semantics and path confinement (D5);
- the BERT gate is a long-lived engine object, not a per-request model load
  (D4), and tutoring queries go through a long-lived routing pool
  (lms/tutoring_pool.py: cache-affinity ring over N tutoring nodes,
  per-node breakers, spill, hedged sends) instead of a per-request dial.

Read RPCs are linearizable by default: each one passes a read fence
(`raft.RaftNode.read_barrier`) that proves current leadership before the
local replica is consulted, so a partitioned ex-leader refuses reads
instead of serving stale state (the reference served whatever the local
dict held, lms_server.py:1063-1133).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Dict, Optional

import grpc

from ..proto import lms_pb2, rpc
from ..raft import NotLeader, TransferInFlight, encode_command
from ..utils import pdf
from ..utils.auth import sign_query
from ..utils.faults import FaultInjector
from ..utils.metrics import Metrics
from ..utils.resilience import (
    CircuitBreaker,
    Deadline,
    request_id_from_grpc_context,
)
from ..utils.tracing import (
    FLAG_DEADLINE,
    FLAG_DEGRADED,
    get_tracer,
    trace_metadata,
    traced_grpc_handler,
)
from .minting import (
    AUTH_SALT_METADATA_KEY,
    AUTH_TOKEN_METADATA_KEY,
    mint_request_id,
    mint_salt,
    mint_session_token,
)
from .persistence import BlobStore
from .state import LMSState, hash_password
from .tutoring_pool import TutoringPool, TutoringUnavailable

log = logging.getLogger(__name__)

CHUNK_SIZE = 1024 * 1024  # reference streams 1 MB chunks (lms_server.py:1467)


def _forced_auth(context, key: str) -> Optional[str]:
    """Auth material pinned by the group router's replicated-auth fan-out
    (lms/group_router.py): the entry router mints ONE salt/token and
    forces it onto every group's Register/Login leg so credentials and
    sessions converge across groups. Absent outside multi-group routing.

    Honored ONLY on router-dispatched legs (the router strips raw
    x-lms-* wire metadata and re-vouches signature-verified pairs via
    its _InnerContext, which carries the `lms_router_leg` mark): a
    client dialing a servicer directly must not be able to pin its own
    KDF salt or mint its own session token."""
    if not getattr(context, "lms_router_leg", False):
        return None
    for k, v in context.invocation_metadata() or ():
        if k == key and v:
            return str(v)
    return None


def collect_submission_texts(state: "LMSState",
                             student: Optional[str] = None) -> list:
    """The bulk-grading corpus: every submitted assignment's extracted
    text (PDF text rides the replicated PostAssignment command), one
    entry per submission, optionally filtered to one student. The LMS
    admin plane (POST /admin/score) fans this to the tutoring fleet's
    background scoring tenant — log-likelihood per submission is the
    instructor's fluency/fit signal, computed at batch-128-class
    throughput in the chip's idle lanes instead of one forward per
    student on the interactive path."""
    texts = []
    for who, assignments in state.data["assignments"].items():
        if student is not None and who != student:
            continue
        for assignment in assignments:
            text = (assignment.get("text") or "").strip()
            if not text:
                # A scanned/empty PDF still grades as SOMETHING visible,
                # not a silently skipped row.
                text = assignment.get("filename") or ""
            if text:
                texts.append(text)
    return texts


class LMSServicer(rpc.LMSServicer):
    def __init__(
        self,
        node,                      # raft.RaftNode
        state: LMSState,
        blobs: BlobStore,
        *,
        gate=None,                 # engine.RelevanceGate (optional)
        tutoring_address: Optional[str] = None,
        tutoring_auth_key: Optional[str] = None,
        metrics: Optional[Metrics] = None,
        peer_addresses: Optional[Dict[int, str]] = None,
        self_id: Optional[int] = None,
        linearizable_reads: bool = True,
        tutoring_breaker: Optional[CircuitBreaker] = None,
        fault_injector: Optional[FaultInjector] = None,
        tutoring_timeout_s: float = 120.0,
        deadline_floor_s: float = 0.25,
        blob_fetch_timeout_s: float = 5.0,
        tutoring_pool: Optional[TutoringPool] = None,
    ):
        self.node = node
        self.state = state
        self.blobs = blobs
        self.linearizable_reads = linearizable_reads
        self.gate = gate
        self.metrics = metrics or Metrics()
        self._tutoring_auth_key = tutoring_auth_key
        # The tutoring routing tier (lms/tutoring_pool.py): per-node
        # breakers turn dead fleet members into spills (and, with every
        # node down, O(1) degraded answers) instead of stacked timeouts;
        # the injector faults each node's hop over real gRPC (admin:
        # POST /admin/faults, per-node target "tutoring:<i>"). A bare
        # `tutoring_address` still works: it becomes a one-node fleet,
        # with `tutoring_breaker` as that node's breaker.
        if tutoring_pool is None:
            tutoring_pool = TutoringPool(
                [tutoring_address] if tutoring_address else [],
                metrics=self.metrics,
                fault_injector=fault_injector,
                breakers=[tutoring_breaker] if tutoring_breaker else None,
                timeout_s=tutoring_timeout_s,
                deadline_floor_s=deadline_floor_s,
            )
        self.pool = tutoring_pool
        # Back-compat handle: the (affinity/sole) node's breaker, still
        # surfaced under the `tutoring_breaker` /healthz key.
        self.tutoring_breaker = (
            self.pool.nodes[0].breaker if self.pool.configured
            else (tutoring_breaker or CircuitBreaker())
        )
        self._tutoring_timeout_s = tutoring_timeout_s
        self._deadline_floor_s = deadline_floor_s
        self._blob_fetch_timeout_s = blob_fetch_timeout_s
        # Peer map for blob anti-entropy (fetch-on-miss); empty = disabled.
        # Kept as a LIVE reference (no copy): the caller passes the same
        # mapping runtime membership changes mutate (LMSNode.addresses), so
        # the blob fetch-on-miss path sees servers added or removed after
        # boot.
        self._peer_addresses = peer_addresses if peer_addresses is not None else {}
        self._self_id = self_id
        # Negative cache: rel_path -> monotonic deadline before which peer
        # fetches are not retried. Without it, every read referencing a
        # permanently lost blob would stall on a full peer sweep.
        self._blob_missing: Dict[str, float] = {}  # guarded-by: event-loop

    # ------------------------------------------------------------- helpers

    def _auth(self, token: str):
        """(username, role) or None."""
        username = self.state.user_of_token(token)
        if username is None:
            return None
        return username, self.state.role_of(username)

    async def _auth_fenced(self, token: str, context):
        """`_auth`, but a miss is re-checked behind the read fence.

        A token miss on a freshly-elected leader can be apply lag, not an
        invalid session: the Login entry is committed in its log but not
        yet applied (the window right after a TimeoutNow transfer — the
        new leader serves before its own-term no-op commits). Fence and
        re-check before telling the client its session is gone; on a
        non-leader the fence aborts UNAVAILABLE so the client re-resolves
        instead. The valid-token fast path pays nothing."""
        auth = self._auth(token)
        if auth is not None:
            return auth
        await self._read_fence(context)
        return self._auth(token)

    async def _propose(self, op: str, args: dict, context) -> bool:
        """Propose and await commit. Not-leader/timeout conditions abort the
        RPC with UNAVAILABLE — which the reference client already treats as
        're-resolve the leader and retry' (lms_gui_final.py:140-146) — so
        stale-leader clients recover instead of seeing terminal app-level
        failures."""
        try:
            await self.node.propose(encode_command(op, args))
            return True
        except (NotLeader, TransferInFlight, TimeoutError, RuntimeError) as e:
            log.info("propose %s failed: %s", op, e)
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"not the leader or no quorum ({e}); re-resolve and retry",
            )
            return False  # unreachable; abort raises

    async def _read_fence(self, context) -> None:
        """Linearizable reads: confirm leadership before serving local state
        (raft.RaftNode.read_barrier). A partitioned ex-leader fails the
        barrier and aborts with UNAVAILABLE — the client re-resolves the
        real leader instead of reading stale state. Runs BEFORE the session
        check so the auth lookup itself is linearizable (a session created
        through the new leader is visible, not spuriously 'invalid').
        Disabled (`linearizable_reads=False`) reads serve local state
        directly — the reference's (stale-prone) behavior."""
        if not self.linearizable_reads:
            return
        try:
            await self.node.read_barrier()
        except (NotLeader, TransferInFlight, TimeoutError, RuntimeError) as e:
            log.info("read fence failed: %s", e)
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"not the leader for reads ({e}); re-resolve and retry",
            )

    async def _degraded_answer(self, username: str, query: str, reason: str,
                               request_id: Optional[str] = None):
        """Tutoring unusable (breaker open / budget gone / RPC failed):
        fall back to the reference's human path — replicate the query onto
        the instructor queue and tell the student so. The answer degrades;
        the request never hangs or errors while the cluster is otherwise
        healthy.

        `request_id` is the CLIENT's logical-request id (x-request-id
        metadata, one per ask_llm across all its retries): keying the
        fallback on it lets the replicated applier drop the duplicate when
        a retried attempt degrades again — one instructor entry per logical
        question, not per attempt. Clients that send no id fall back to a
        fresh id per attempt (the old, duplicate-prone behavior, but only
        for clients that opted out of idempotency)."""
        self.metrics.inc("tutoring_degraded")
        log.warning("tutoring degraded (%s); queueing for instructor", reason)
        # The degraded path is exactly what the flight recorder must never
        # sample away: flag the trace (pinning it) and record the
        # instructor-queue write as its own span — the span tree of a
        # degraded ask still reaches the Raft commit, under the same
        # request id the client retries with.
        try:
            with get_tracer().span("degraded.queue", reason=reason) as dsp:
                dsp.flag(FLAG_DEGRADED)
                await self.node.propose(
                    encode_command(
                        "AskQuery",
                        {"username": username, "query": query,
                         "request_id": request_id or mint_request_id()},
                    )
                )
        except (NotLeader, TransferInFlight, TimeoutError, RuntimeError) as e:
            # Can't even commit the fallback (lost leadership mid-request):
            # tell the client to retry rather than fake success.
            log.warning("degraded fallback propose failed: %s", e)
            return lms_pb2.QueryResponse(
                success=False,
                response="The tutoring service is unavailable and your "
                "query could not be queued; please retry.",
            )
        return lms_pb2.QueryResponse(
            success=True,
            response="The LLM tutor is currently unavailable, so your "
            "question was forwarded to an instructor. Check "
            "'instructor responses' later for the answer.",
        )

    async def _blob(self, rel_path: str,
                    deadline: Optional[Deadline] = None) -> bytes:
        """Blob bytes for committed metadata; fetch-on-miss from peers.

        A node can hold committed metadata without the blob (it missed the
        leader's fire-and-forget push — e.g. it was partitioned during the
        upload, or wiped and restored from snapshot). Rather than serving
        `success=True` with empty file bytes, pull the blob from a peer
        (leader first) via the additive `FetchFile` RPC and store it, so the
        miss heals permanently.

        `deadline` is the calling RPC's propagated budget: each per-peer
        attempt spends the remaining budget (capped at
        `[resilience] blob_fetch_timeout_s`), and once it falls under
        `deadline_floor_s` the sweep stops — a client that has already
        given up must not pin this node on a doomed peer walk
        (`blob_fetch_budget_exhausted`). No deadline = the capped legacy
        behavior.
        """
        loop = asyncio.get_running_loop()
        content = await loop.run_in_executor(None, self.blobs.get, rel_path)
        if content is not None:
            return content
        now = asyncio.get_running_loop().time()
        if self._blob_missing.get(rel_path, 0.0) > now:
            return b""  # recently swept the peers; don't stall every read
        leader = self.node.leader_id
        # Snapshot: _peer_addresses is LIVE (runtime membership changes
        # mutate it mid-await); a removed peer simply stops being tried.
        peers = dict(self._peer_addresses)
        ordered = sorted(peers, key=lambda pid: (pid != leader, pid))
        for pid in ordered:
            if pid == self._self_id:
                continue
            # Re-read the live budget per attempt: earlier peers have been
            # eating it. The floor is checked against the REMAINING budget,
            # not the cap-limited timeout — a tight blob_fetch_timeout_s
            # must shorten attempts, never disable the sweep outright.
            attempt_timeout = self._blob_fetch_timeout_s
            if deadline is not None:
                if deadline.remaining() <= self._deadline_floor_s:
                    self.metrics.inc("blob_fetch_budget_exhausted")
                    log.info(
                        "blob fetch %s: deadline budget exhausted before "
                        "the peer sweep finished", rel_path,
                    )
                    return b""  # metadata-only; anti-entropy heals later
                attempt_timeout = deadline.timeout(
                    cap=self._blob_fetch_timeout_s
                )
            try:
                # Same 50 MiB cap the upload path accepts — the default
                # 4 MiB receive cap would make any larger blob unfetchable.
                async with grpc.aio.insecure_channel(
                    peers[pid],
                    options=[("grpc.max_receive_message_length",
                              50 * 1024 * 1024)],
                ) as channel:
                    stub = rpc.FileTransferServiceStub(channel)
                    resp = await stub.FetchFile(
                        lms_pb2.FetchFileRequest(path=rel_path),
                        timeout=attempt_timeout,
                        metadata=trace_metadata(),
                    )
                if resp.found:
                    await loop.run_in_executor(
                        None, self.blobs.put, rel_path, resp.content
                    )
                    self.metrics.inc("blob_fetch_on_miss")
                    # Idempotent success-path invalidation: every task
                    # that fetched the blob wants the negative-cache
                    # entry gone, and pop(..., None) of an already-
                    # popped key is a no-op — stale-read safe.
                    # lint: disable-next=atomicity-across-await
                    self._blob_missing.pop(rel_path, None)
                    return resp.content
            except grpc.RpcError as e:
                log.info("blob fetch %s from %d failed: %s", rel_path, pid,
                         e.code())
        log.warning("blob %s missing everywhere reachable", rel_path)
        # Last-wins on purpose: concurrent misses each stamp their own
        # 30 s window from their own sweep's start; any of them is a
        # valid negative-cache horizon and the latest write is freshest.
        # lint: disable-next=atomicity-across-await
        self._blob_missing[rel_path] = now + 30.0
        return b""

    # ---------------------------------------------------------------- auth

    @traced_grpc_handler("lms.Register")
    async def Register(self, request, context):
        self.metrics.inc("register")
        if not request.username or not request.password:
            return lms_pb2.RegisterResponse(
                success=False, message="Username and password are required."
            )
        if request.role not in ("student", "instructor"):
            return lms_pb2.RegisterResponse(
                success=False, message="Role must be student or instructor."
            )
        if request.username in self.state.data["users"]:
            # Same credentials re-registering is an idempotent retry (the
            # router's replicated-auth fan-out retries the whole op when
            # one group's leg fails) — fall through and succeed. Anything
            # else is a genuine conflict.
            if not (
                self.state.check_password(request.username, request.password)
                and self.state.role_of(request.username) == request.role
            ):
                return lms_pb2.RegisterResponse(
                    success=False,
                    message=f"User {request.username} already exists.",
                )
        # Salt generated here, carried in the command: every replica applies
        # the same (salt, hash) pair, so the KDF stays deterministic across
        # the cluster while each user gets a unique salt. The group router
        # forces one salt across its per-group legs.
        salt = _forced_auth(context, AUTH_SALT_METADATA_KEY) or mint_salt()
        pw_hash = hash_password(request.password, salt)
        await self._propose(
            "Register",
            {
                "username": request.username,
                "password_hash": pw_hash,
                "salt": salt,
                "role": request.role,
            },
            context,
        )
        # Re-check after commit: with concurrent registrations of the same
        # name, the applier is first-writer-wins — only tell the winner it
        # succeeded. Checked via authentication + role (not hash equality,
        # whose per-proposal salt would fail a retried proposal that lost to
        # the caller's own earlier commit; role, because a concurrent loser
        # with the same password must not be told its different role won).
        won = self.state.check_password(
            request.username, request.password
        ) and self.state.role_of(request.username) == request.role
        msg = (
            f"User {request.username} registered as {request.role}."
            if won
            else f"User {request.username} already exists."
        )
        return lms_pb2.RegisterResponse(success=won, message=msg)

    @traced_grpc_handler("lms.Login")
    async def Login(self, request, context):
        self.metrics.inc("login")
        if not self.state.check_password(request.username, request.password):
            return lms_pb2.LoginResponse(success=False)
        token = _forced_auth(context, AUTH_TOKEN_METADATA_KEY) \
            or mint_session_token()
        await self._propose(
            "Login", {"username": request.username, "token": token}, context
        )
        role = self.state.role_of(request.username) or ""
        return lms_pb2.LoginResponse(success=True, token=token, role=role)

    @traced_grpc_handler("lms.Logout")
    async def Logout(self, request, context):
        if await self._auth_fenced(request.token, context) is None:
            return lms_pb2.LogoutResponse(success=False)
        ok = await self._propose("Logout", {"token": request.token}, context)
        return lms_pb2.LogoutResponse(success=ok)

    # --------------------------------------------------------------- writes

    @traced_grpc_handler("lms.Post")
    async def Post(self, request, context):
        auth = await self._auth_fenced(request.token, context)
        if auth is None:
            return lms_pb2.PostResponse(success=False)
        username, role = auth
        self.metrics.inc("post")

        loop = asyncio.get_running_loop()
        # Stored/echoed filenames are basenamed: a hostile client must not be
        # able to plant "../" paths that peers or downloading clients write.
        filename = os.path.basename(request.filename)
        # Client idempotency key: rides in the command so the replicated
        # applier drops a retried mutation whose original already committed.
        rid = request.request_id

        if role == "instructor" and request.type == "course_material":
            rel = os.path.join("materials", filename)
            # File IO off-loop: this loop also drives Raft ticks/heartbeats.
            await loop.run_in_executor(None, self.blobs.put, rel, request.file)
            ok = await self._propose(
                "PostCourseMaterial",
                {"instructor": username, "filename": filename,
                 "filepath": rel, "request_id": rid},
                context,
            )
            return lms_pb2.PostResponse(success=ok)

        if role == "student" and request.type == "assignment":
            rel = os.path.join("assignments", username, filename)
            await loop.run_in_executor(None, self.blobs.put, rel, request.file)
            # CPU-bound (zlib + regex over up to 50 MB): keep off-loop too.
            text = await loop.run_in_executor(
                None, pdf.extract_text, request.file
            )
            ok = await self._propose(
                "PostAssignment",
                {"student": username, "filename": filename,
                 "filepath": rel, "text": text, "request_id": rid},
                context,
            )
            return lms_pb2.PostResponse(success=ok)

        if role == "student" and request.type == "query":
            ok = await self._propose(
                "AskQuery",
                {"username": username, "query": request.data,
                 "request_id": rid},
                context,
            )
            return lms_pb2.PostResponse(success=ok)

        return lms_pb2.PostResponse(success=False)

    @traced_grpc_handler("lms.GradeAssignment")
    async def GradeAssignment(self, request, context):
        auth = await self._auth_fenced(request.token, context)
        if auth is None:
            return lms_pb2.GradeResponse(
                success=False, message="Invalid session token"
            )
        _, role = auth
        if role != "instructor":
            return lms_pb2.GradeResponse(
                success=False, message="Only instructors can grade assignments"
            )
        if request.studentId not in self.state.data["assignments"]:
            return lms_pb2.GradeResponse(
                success=False, message="Student assignment not found"
            )
        ok = await self._propose(
            "GradeAssignment",
            {"student": request.studentId, "grade": request.grade,
             "request_id": request.request_id},
            context,
        )
        msg = "Grade recorded." if ok else "Grading failed (no leader?)."
        return lms_pb2.GradeResponse(success=ok, message=msg)

    @traced_grpc_handler("lms.RespondToQuery")
    async def RespondToQuery(self, request, grpc_context):
        auth = await self._auth_fenced(request.token, grpc_context)
        if auth is None:
            return lms_pb2.PostResponse(success=False)
        username, role = auth
        if role != "instructor":
            return lms_pb2.PostResponse(success=False)
        ok = await self._propose(
            "RespondToQuery",
            {"instructor": username, "student": request.studentId,
             "response": request.data, "request_id": request.request_id},
            grpc_context,
        )
        return lms_pb2.PostResponse(success=ok)

    # ---------------------------------------------------------------- reads

    @traced_grpc_handler("lms.Get")
    async def Get(self, request, context):
        await self._read_fence(context)
        auth = self._auth(request.token)
        if auth is None:
            return lms_pb2.GetResponse(success=False)
        username, role = auth
        entries = []
        # The client's remaining budget bounds every blob fetch-on-miss
        # this read triggers (see _blob); None = no budget sent.
        deadline = Deadline.from_grpc_context(context)

        if request.type == "course_material" and role == "student":
            materials = self.state.data["course_materials"]
            if not materials:
                return lms_pb2.GetResponse(
                    success=True, message="No course materials available."
                )
            for material in materials:
                content = await self._blob(material["filepath"],
                                           deadline=deadline)
                entries.append(
                    lms_pb2.DataEntry(
                        id="1",
                        filename=material["filename"],
                        file=content,
                        instructor=material.get("instructor", "Unknown"),
                    )
                )
            return lms_pb2.GetResponse(success=True, entries=entries)

        if request.type == "student_list" and role == "instructor":
            for student, assignments in self.state.data["assignments"].items():
                for assignment in assignments:
                    content = await self._blob(assignment["filepath"],
                                               deadline=deadline)
                    entries.append(
                        lms_pb2.DataEntry(
                            id=student,
                            filename=assignment["filename"],
                            file=content,
                        )
                    )
            return lms_pb2.GetResponse(success=True, entries=entries)

        return lms_pb2.GetResponse(
            success=False, message="Invalid request type or unauthorized access"
        )

    @traced_grpc_handler("lms.GetGrade")
    async def GetGrade(self, request, context):
        await self._read_fence(context)
        auth = self._auth(request.token)
        if auth is None:
            return lms_pb2.GetGradeResponse(success=False, grade="Invalid session")
        username, role = auth
        if role != "student":
            return lms_pb2.GetGradeResponse(
                success=False, grade="Only students can view grades"
            )
        assignments = self.state.assignments_of(username)
        if not assignments:
            return lms_pb2.GetGradeResponse(
                success=True, grade="No assignments found for this student."
            )
        for assignment in assignments:
            if assignment.get("grade") is not None:
                return lms_pb2.GetGradeResponse(
                    success=True, grade=f"Your grade: {assignment['grade']}"
                )
        return lms_pb2.GetGradeResponse(success=True, grade="No grade assigned yet.")

    @traced_grpc_handler("lms.GetUnansweredQueries")
    async def GetUnansweredQueries(self, request, grpc_context):
        await self._read_fence(grpc_context)
        auth = self._auth(request.token)
        if auth is None or auth[1] != "instructor":
            return lms_pb2.GetResponse(success=False)
        entries = [
            lms_pb2.DataEntry(id=item["student"], data=item["query"])
            for item in self.state.unanswered_queries()
        ]
        return lms_pb2.GetResponse(success=True, entries=entries)

    @traced_grpc_handler("lms.GetInstructorResponse")
    async def GetInstructorResponse(self, request, grpc_context):
        await self._read_fence(grpc_context)
        auth = self._auth(request.token)
        if auth is None or auth[1] != "student":
            return lms_pb2.GetResponse(success=False)
        username = auth[0]
        entries = [
            lms_pb2.DataEntry(
                id=username,
                data=(
                    f"Your Query: {item['query']}\n"
                    f"Instructor Response: {item['response']}"
                ),
            )
            for item in self.state.answered_queries_of(username)
        ]
        return lms_pb2.GetResponse(success=True, entries=entries)

    # ------------------------------------------------------------ LLM path

    @traced_grpc_handler("lms.GetLLMAnswer")
    async def GetLLMAnswer(self, request, context):
        await self._read_fence(context)
        self.metrics.inc("llm_requests")
        # One logical ask_llm = one id across all client retries (metadata;
        # the frozen QueryRequest has no field for it). Threads into the
        # degraded fallback so retries never double-queue the instructor.
        client_rid = request_id_from_grpc_context(context)
        auth = self._auth(request.token)
        if auth is None:
            return lms_pb2.QueryResponse(success=False, response="Invalid session")
        username, role = auth
        if role != "student":
            return lms_pb2.QueryResponse(
                success=False, response="Only students can query the LLM tutor"
            )
        assignments = self.state.assignments_of(username)
        if not assignments:
            return lms_pb2.QueryResponse(
                success=False,
                response="Upload an assignment before asking the LLM tutor.",
            )
        with self.metrics.time("llm_ttft"):
            if self.gate is not None:
                assignment_text = assignments[0].get("text") or ""
                loop = asyncio.get_running_loop()
                # Span opened on the loop side: run_in_executor does not
                # propagate contextvars, and the handler's wall view of
                # the gate (queue + compute) is the budget that matters.
                with get_tracer().span("gate.check") as gsp:
                    passed, sim = await loop.run_in_executor(
                        None, self.gate.check, request.query, assignment_text
                    )
                    gsp.set_attr("passed", bool(passed))
                self.metrics.inc("gate_pass" if passed else "gate_reject")
                if not passed:
                    return lms_pb2.QueryResponse(
                        success=True,
                        response=(
                            "Your query does not appear related to your "
                            f"assignment (similarity {sim:.2f}); please ask "
                            "your instructor instead."
                        ),
                    )
            if not self.pool.configured:
                return lms_pb2.QueryResponse(
                    success=False, response="Tutoring service not configured."
                )
            # Deadline propagation: the client's remaining budget (gRPC
            # deadline and/or metadata header) bounds the tutoring hop,
            # minus a floor of headroom so the degraded fallback can still
            # commit before the client gives up.
            deadline = Deadline.from_grpc_context(context)
            budget = (
                deadline.timeout(cap=self._tutoring_timeout_s)
                if deadline is not None
                else self._tutoring_timeout_s
            )
            if deadline is not None and budget <= self._deadline_floor_s:
                self.metrics.inc("tutoring_budget_exhausted")
                cur = get_tracer().current()
                if cur is not None:
                    cur.flag(FLAG_DEADLINE)
                return await self._degraded_answer(
                    username, request.query, "deadline budget exhausted",
                    request_id=client_rid,
                )
            # With a shared key configured, the forwarded query carries an
            # HMAC ticket in the token field; the tutoring node answers only
            # ticketed queries, closing the direct-dial gate bypass.
            fwd_token = (
                sign_query(self._tutoring_auth_key, request.query)
                if self._tutoring_auth_key
                else request.token
            )
            # The fleet router (lms/tutoring_pool.py) owns everything
            # between here and the wire: cache-affinity placement, spill
            # past open breakers / deep queues / short budgets, hedged
            # sends, per-node chaos (faults target "tutoring:<i>"), and
            # the per-attempt breaker accounting.
            try:
                answer, _served = await self.pool.forward(
                    request.query, fwd_token, deadline=deadline
                )
            except TutoringUnavailable as e:
                if e.kind == "breaker":
                    self.metrics.inc("tutoring_breaker_rejections")
                    return await self._degraded_answer(
                        username, request.query, "circuit open",
                        request_id=client_rid,
                    )
                if e.kind == "budget":
                    self.metrics.inc("tutoring_budget_exhausted")
                    cur = get_tracer().current()
                    if cur is not None:
                        cur.flag(FLAG_DEADLINE)
                    return await self._degraded_answer(
                        username, request.query,
                        "deadline budget exhausted",
                        request_id=client_rid,
                    )
                log.warning("tutoring fleet unavailable: %s", e)
                return await self._degraded_answer(
                    username, request.query, str(e),
                    request_id=client_rid,
                )
        return answer

    @staticmethod
    def _final_chunk(response) -> "lms_pb2.StreamChunk":
        """Adapt a unary QueryResponse (gate refusal, degraded fallback,
        config errors) into a single final StreamChunk. `count` stays 0 —
        these texts are not token streams and carry no digest; the client
        treats them exactly like the unary answer they are."""
        return lms_pb2.StreamChunk(
            success=response.success, text=response.response, final=True,
        )

    @traced_grpc_handler("lms.StreamLLMAnswer")
    async def StreamLLMAnswer(self, request, context):
        """Streamed sibling of GetLLMAnswer: same fence, auth, gate, and
        budget policy; the answer arrives as resumable chunks relayed
        from the tutoring fleet (lms/tutoring_pool.forward_stream owns
        hedging, stall detection, and resume-at-offset failover).
        Degraded fallbacks can only happen BEFORE the first delivered
        byte — mid-stream exhaustion aborts instead, and the client
        resumes with `resume_offset` = its delivered token count."""
        await self._read_fence(context)
        self.metrics.inc("llm_requests")
        client_rid = request_id_from_grpc_context(context)
        auth = self._auth(request.token)
        if auth is None:
            yield lms_pb2.StreamChunk(success=False, final=True,
                                      text="Invalid session")
            return
        username, role = auth
        if role != "student":
            yield lms_pb2.StreamChunk(
                success=False, final=True,
                text="Only students can query the LLM tutor",
            )
            return
        assignments = self.state.assignments_of(username)
        if not assignments:
            yield lms_pb2.StreamChunk(
                success=False, final=True,
                text="Upload an assignment before asking the LLM tutor.",
            )
            return
        with self.metrics.time("llm_ttft"):
            if self.gate is not None:
                assignment_text = assignments[0].get("text") or ""
                loop = asyncio.get_running_loop()
                with get_tracer().span("gate.check") as gsp:
                    passed, sim = await loop.run_in_executor(
                        None, self.gate.check, request.query,
                        assignment_text
                    )
                    gsp.set_attr("passed", bool(passed))
                self.metrics.inc("gate_pass" if passed else "gate_reject")
                if not passed:
                    yield lms_pb2.StreamChunk(
                        success=True, final=True,
                        text=(
                            "Your query does not appear related to your "
                            f"assignment (similarity {sim:.2f}); please "
                            "ask your instructor instead."
                        ),
                    )
                    return
            if not self.pool.configured:
                yield lms_pb2.StreamChunk(
                    success=False, final=True,
                    text="Tutoring service not configured.",
                )
                return
            deadline = Deadline.from_grpc_context(context)
            budget = (
                deadline.timeout(cap=self._tutoring_timeout_s)
                if deadline is not None
                else self._tutoring_timeout_s
            )
            if deadline is not None and budget <= self._deadline_floor_s:
                self.metrics.inc("tutoring_budget_exhausted")
                cur = get_tracer().current()
                if cur is not None:
                    cur.flag(FLAG_DEADLINE)
                yield self._final_chunk(await self._degraded_answer(
                    username, request.query, "deadline budget exhausted",
                    request_id=client_rid,
                ))
                return
            fwd_token = (
                sign_query(self._tutoring_auth_key, request.query)
                if self._tutoring_auth_key
                else request.token
            )
            sent_any = False
            try:
                async for chunk in self.pool.forward_stream(
                    request.query, fwd_token, deadline=deadline,
                    session_id=request.session_id,
                    resume_offset=request.resume_offset,
                ):
                    self.metrics.inc("stream_chunks")
                    yield chunk
                    sent_any = True
            except TutoringUnavailable as e:
                if sent_any:
                    # Delivered text can't be retracted into a degraded
                    # answer: abort so the client resumes at its offset
                    # (possibly against a re-elected leader).
                    log.warning("stream lost mid-answer: %s", e)
                    await context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        f"stream lost mid-answer ({e}); resume at your "
                        "delivered offset",
                    )
                if e.kind == "breaker":
                    self.metrics.inc("tutoring_breaker_rejections")
                    yield self._final_chunk(await self._degraded_answer(
                        username, request.query, "circuit open",
                        request_id=client_rid,
                    ))
                    return
                if e.kind == "budget":
                    self.metrics.inc("tutoring_budget_exhausted")
                    cur = get_tracer().current()
                    if cur is not None:
                        cur.flag(FLAG_DEADLINE)
                    yield self._final_chunk(await self._degraded_answer(
                        username, request.query,
                        "deadline budget exhausted",
                        request_id=client_rid,
                    ))
                    return
                log.warning("tutoring fleet unavailable: %s", e)
                yield self._final_chunk(await self._degraded_answer(
                    username, request.query, str(e),
                    request_id=client_rid,
                ))
                return

    @traced_grpc_handler("lms.WhoIsLeader")
    async def WhoIsLeader(self, request, context):
        # Implemented on LMS as the contract declares (reference D6 left it
        # UNIMPLEMENTED and clients had to use the RaftService one).
        leader = self.node.leader_id
        return lms_pb2.LeaderResponse(leader_id=leader if leader is not None else -1)


class FileTransferServicer(rpc.FileTransferServiceServicer):
    """Bulk data plane: receives leader-streamed uploads on followers."""

    def __init__(self, blobs: BlobStore):
        self.blobs = blobs

    @traced_grpc_handler("file.SendFile")
    async def SendFile(self, request_iterator, context):
        writer = None
        try:
            async for chunk in request_iterator:
                if writer is None:
                    writer = self.blobs.open_writer(chunk.destination_path)
                writer.write(chunk.content)
            if writer is None:
                return lms_pb2.FileTransferResponse(status="error: empty stream")
            writer.commit()
            return lms_pb2.FileTransferResponse(status="success")
        except Exception as e:
            if writer is not None:
                writer.abort()
            log.warning("SendFile failed: %s", e)
            return lms_pb2.FileTransferResponse(status=f"error: {e}")

    @traced_grpc_handler("file.FetchFile")
    async def FetchFile(self, request, context):
        """Pull path for blob anti-entropy (see LMSServicer._blob)."""
        loop = asyncio.get_running_loop()
        try:
            content = await loop.run_in_executor(
                None, self.blobs.get, request.path
            )
        except ValueError:  # path escapes the blob root: not found, not 500
            log.warning("FetchFile rejected traversal path %r", request.path)
            return lms_pb2.FetchFileResponse(found=False)
        if content is None:
            return lms_pb2.FetchFileResponse(found=False)
        return lms_pb2.FetchFileResponse(found=True, content=content)

    @traced_grpc_handler("file.ReplicateData")
    async def ReplicateData(self, request, context):
        """Direct blob push (metadata rides Raft; this is the bulk path)."""
        try:
            # Sanctioned path joins: `rel` is blob-RELATIVE and only ever
            # reaches BlobStore.put, whose _resolve escape-guard rejects
            # any traversal out of the blob root (see FetchFile above).
            sub = "materials" if request.type == "material" else os.path.join(  # lint: disable=wire-taint
                "assignments", request.username or "unknown"
            )
            rel = os.path.join(sub, os.path.basename(request.filename))  # lint: disable=wire-taint
            self.blobs.put(rel, request.file_content)
            return lms_pb2.ReplicateDataResponse(success=True)
        except Exception as e:
            log.warning("ReplicateData failed: %s", e)
            return lms_pb2.ReplicateDataResponse(success=False)


async def replicate_file_to_peers(
    addresses: Dict[int, str],
    self_id: int,
    blobs: BlobStore,
    rel_path: str,
    *,
    per_peer_timeout_s: float = 30.0,
    deadline: Optional[Deadline] = None,
    metrics: Optional[Metrics] = None,
) -> Dict[int, str]:
    """Leader-side: stream one blob to every peer in 1 MB chunks.

    Returns {peer_id: status}. Failures are logged, not fatal — a follower
    that missed a file can refetch via FetchFile anti-entropy or serve
    metadata-only (the reference aborted the apply on replication errors).

    Each peer's SendFile spends the sweep's remaining `deadline` budget
    (capped at `per_peer_timeout_s`, `[resilience] replicate_timeout_s`):
    one slow follower can no longer serialize `per_peer_timeout_s × peers`
    of leader loop time per upload. Peers the budget never reaches are
    recorded (and counted, `replicate_budget_exhausted`) rather than
    silently attempted late — the fetch-on-miss path heals them.
    """
    data = blobs.get(rel_path)
    if data is None:
        return {}
    results: Dict[int, str] = {}
    # Snapshot: the caller passes LMSNode's live map, which runtime
    # membership changes mutate between this coroutine's awaits.
    for peer, addr in list(addresses.items()):
        if peer == self_id:
            continue
        attempt_timeout = per_peer_timeout_s
        if deadline is not None:
            attempt_timeout = deadline.timeout(cap=per_peer_timeout_s)
            if attempt_timeout <= 0.0 or deadline.expired:
                results[peer] = "skipped: replication budget exhausted"
                if metrics is not None:
                    metrics.inc("replicate_budget_exhausted")
                continue
        try:
            async with grpc.aio.insecure_channel(addr) as channel:
                stub = rpc.FileTransferServiceStub(channel)

                async def chunks():
                    for off in range(0, len(data), CHUNK_SIZE):
                        yield lms_pb2.FileChunk(
                            content=data[off : off + CHUNK_SIZE],
                            destination_path=rel_path,
                        )

                resp = await stub.SendFile(chunks(), timeout=attempt_timeout,
                                           metadata=trace_metadata())
                results[peer] = resp.status
        except grpc.RpcError as e:
            results[peer] = f"error: {e.code()}"
            log.info("file replication to %d failed: %s", peer, e.code())
    return results
