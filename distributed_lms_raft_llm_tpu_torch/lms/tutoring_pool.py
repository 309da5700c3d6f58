"""Tutoring fleet router: cache-affinity placement with tail-tolerance.

The port's copy of `distributed_lms_raft_llm_tpu/lms/tutoring_pool.py`,
its logic as it is.

Before this module every student query funnelled through ONE tutoring
node: `lms_server --tutoring` took a single host:port, one breaker
guarded it, and a dead node meant fleet-wide degraded answers. The pool
fans the forward out across N nodes with three cooperating policies:

- **Cache-affinity placement** (rendezvous hashing, Karger-style minimal
  remap): the routing key is the normalized head of the prompt
  (`affinity_key`), so same-course traffic — whose prompts share the
  course-context prefix — lands on the node already holding that
  course's radix prefix blocks (PR 10's `prefix_cache_hit_rate` is the
  payoff signal). Rendezvous hashing means membership churn moves only
  the departed/arrived node's keys (~1/N), never a full reshuffle that
  cold-starts every course's cache.
- **Failure-aware spill** (Dean & Barroso, *The Tail at Scale*): the
  affinity node is skipped — and the second choice takes the send — on
  an open per-node `CircuitBreaker`, a deep serving queue (learned from
  `/healthz` polls and the `x-queue-depth` response trailer), or a
  remaining deadline budget the node's recent latency (EWMA) says it
  cannot meet. Every forward emits a `router.pick` span naming the
  chosen node and why.
- **Hedged requests**: when the chosen node has not answered within
  `hedge_after_s` (and the budget affords a second try), the same query
  is sent to the next choice; the first answer wins and the loser is
  cancelled. Hedges and hedge wins are counted (`tutoring_hedges`,
  `tutoring_hedge_wins`).

Elastic membership: a tutoring node that reports `draining: true` on its
`/healthz` (after `POST /admin/drain`) is ejected from the ring while it
finishes in-flight work; when it reports healthy again (or an operator
POSTs `/admin/tutoring {"op": "join"}`) it is re-admitted with a
warm-up weight that ramps to full over `warmup_s`, so the prefix cache
refills before the node takes its full key share. Chaos can black out a
single fleet member via the per-node fault target `tutoring:<index>`
(`utils/faults.FaultInjector` falls back `tutoring:<i>` -> `tutoring` ->
`*`, so the legacy whole-tier target still works).

The pool is event-loop confined (the LMS serving loop): `forward`, the
health poller, and the admin mutations all run there, which is why the
mutable node state needs no lock.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import grpc

from ..proto import lms_pb2, rpc
from ..utils import metrics_registry as metric
from ..utils.faults import FaultInjected, FaultInjector
from ..utils.metrics import Metrics
from ..utils.resilience import (
    CircuitBreaker,
    Deadline,
    QUEUE_DEPTH_METADATA_KEY,
    SERVED_BY_METADATA_KEY,
)
from ..utils.tracing import get_tracer, trace_metadata

log = logging.getLogger(__name__)

# Exceptions the router treats as "this node failed, try another" — the
# same set the single-node forward treated as degradable.
_NODE_ERRORS = (grpc.RpcError, FaultInjected, OSError, asyncio.TimeoutError)

# Consecutive healthy /healthz polls required before a half-open breaker
# is closed by the poller (see TutoringPool.observe_health).
HEALTH_CLOSE_STREAK = 3


class TutoringUnavailable(Exception):
    """The pool could not produce an answer. `kind` tells the caller how
    to account for it: "none" (no fleet configured), "breaker" (every
    candidate's circuit open), "ejected" (every node draining/ejected),
    "budget" (deadline floor hit mid-route), "rpc" (every attempt
    failed)."""

    def __init__(self, reason: str, kind: str = "rpc"):
        super().__init__(reason)
        self.kind = kind


class StreamProtocolError(ConnectionError):
    """A streamed chunk violated the resumable-stream contract (offset
    gap, or a partial overlap that cannot be trimmed at a token
    boundary). Subclasses ConnectionError so the router's node-failure
    handling (`_NODE_ERRORS` includes OSError) treats the sender as
    failed and resumes on the next candidate."""


def affinity_key(query: str) -> str:
    """The routing key: the normalized head of the prompt. Same-course
    asks share their course-context prefix (sim/workload.course_context
    and production PROMPT_TEMPLATE framing), so they key identically and
    land on the node already holding those radix blocks; bare queries
    key on themselves, so repeated questions still co-locate."""
    return " ".join(query.split()).lower()[:64]


def session_affinity_key(session_id: str) -> str:
    """The routing key of a multi-turn tutoring session: every turn of
    one session keys identically — and differently from any query key
    (the `sess:` namespace) — so the rendezvous ring keeps the session
    sticky to the node holding its transcript and its pinned radix KV
    blocks, regardless of how each turn's query text hashes."""
    return "sess:" + " ".join(session_id.split())[:64]


async def _http_get_raw(address: str, path: str,
                        timeout_s: float = 2.0) -> bytes:
    host, port = address.rsplit(":", 1)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port)), timeout_s
    )
    try:
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        await writer.drain()
        return await asyncio.wait_for(reader.read(-1), timeout_s)
    finally:
        writer.close()
        try:
            # Bounded: if this coroutine is being cancelled the pending
            # CancelledError can interrupt a bare wait_closed() and skip
            # the rest of the teardown; a 1 s cap acknowledges that.
            await asyncio.wait_for(writer.wait_closed(), 1.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass


async def _http_get_json(address: str, path: str,
                         timeout_s: float = 2.0) -> Dict[str, Any]:
    """Minimal async HTTP GET against a node-local healthz endpoint
    (utils/healthz.py speaks exactly this much HTTP). Lenient: the body
    is parsed regardless of status (the health poller treats any parse
    failure as one failed poll)."""
    raw = await _http_get_raw(address, path, timeout_s)
    _head, _sep, body = raw.partition(b"\r\n\r\n")
    return json.loads(body.decode())


async def _http_get_admin(address: str, path: str,
                          timeout_s: float = 2.0) -> Dict[str, Any]:
    """Status-aware GET for admin reads proxied to callers: a node-side
    404 must surface as KeyError, not as a 200 body missing its fields
    (see `_parse_admin_response`)."""
    raw = await _http_get_raw(address, path, timeout_s)
    return _parse_admin_response(raw, "GET", path)


def _parse_admin_response(raw: bytes, method: str,
                          path: str) -> Dict[str, Any]:
    """Status-aware parse of an admin-plane HTTP response: 404 raises
    KeyError (the LMS proxy maps it back to its own 404 — an unknown or
    retention-trimmed job must not poll as an eternal 200), other
    non-2xx raise RuntimeError carrying the status AND whatever detail
    the body held (raw text when it isn't JSON — a truncated error body
    must not bury the status under a JSONDecodeError)."""
    head, _sep, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0].decode("latin-1", "replace")
    parts = status_line.split()
    status = parts[1] if len(parts) >= 2 else "?"
    try:
        doc = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError):
        doc = None
    if status.startswith("2") and isinstance(doc, dict):
        return doc
    detail = (doc.get("error", doc) if isinstance(doc, dict)
              else body.decode("latin-1", "replace")[:200])
    if status == "404":
        raise KeyError(f"{method} {path} -> 404: {detail}")
    raise RuntimeError(f"{method} {path} -> {status}: {detail}")


async def _http_post_json(address: str, path: str, payload: Dict[str, Any],
                          timeout_s: float = 10.0) -> Dict[str, Any]:
    """POST sibling of `_http_get_json` (the tutoring admin plane —
    drain, bulk score jobs — rides the same node-local HTTP endpoint).
    Non-2xx responses raise (see `_parse_admin_response`)."""
    host, port = address.rsplit(":", 1)
    body = json.dumps(payload).encode()
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port)), timeout_s
    )
    try:
        writer.write(
            (
                f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n"
            ).encode() + body
        )
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), timeout_s)
    finally:
        writer.close()
        try:
            # Bounded: if this coroutine is being cancelled the pending
            # CancelledError can interrupt a bare wait_closed() and skip
            # the rest of the teardown; a 1 s cap acknowledges that.
            await asyncio.wait_for(writer.wait_closed(), 1.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
    return _parse_admin_response(raw, "POST", path)


class TutoringNode:
    """One fleet member's routing state (event-loop confined)."""

    def __init__(self, index: int, address: str,
                 health_address: Optional[str] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.index = index
        self.address = address
        self.health_address = health_address
        self.breaker = breaker or CircuitBreaker()
        self.remote_id: Optional[str] = None   # guarded-by: event-loop
        self.queued: int = 0                   # guarded-by: event-loop
        # Monotonic stamp of the last queue-depth observation (trailer
        # or health poll): spill decisions must not trust a stale
        # reading (see TutoringPool.queue_depth_of).
        self.queued_at: float = float("-inf")  # guarded-by: event-loop
        self.draining = False                  # guarded-by: event-loop
        self.ejected = False                   # guarded-by: event-loop
        self.warming_until = 0.0               # guarded-by: event-loop
        self.ewma_s: Optional[float] = None    # guarded-by: event-loop
        self.routes = 0                        # guarded-by: event-loop
        self.served = 0                        # guarded-by: event-loop
        self.health_failures = 0               # guarded-by: event-loop
        self.health_streak = 0                 # guarded-by: event-loop
        self._channel: Optional[grpc.aio.Channel] = None
        self._stub = None

    def fault_target(self) -> str:
        return f"tutoring:{self.index}"

    def stub(self):
        if self._stub is None:
            self._channel = grpc.aio.insecure_channel(self.address)
            self._stub = rpc.TutoringStub(self._channel)
        return self._stub

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._stub = None

    # --------------------------------------------------------------- state

    def routable(self) -> bool:
        return not (self.ejected or self.draining)

    def warming(self, now: float) -> bool:
        return now < self.warming_until

    def weight(self, now: float, warmup_weight: float,
               warmup_s: float) -> float:
        """Rendezvous weight: 1.0 steady-state; a rejoined node ramps
        from `warmup_weight` to 1.0 over `warmup_s` so its prefix cache
        refills before it takes its full key share."""
        if not self.warming(now):
            return 1.0
        remaining = (self.warming_until - now) / max(warmup_s, 1e-9)
        return warmup_weight + (1.0 - warmup_weight) * (1.0 - min(
            1.0, max(0.0, remaining)
        ))

    def note_latency(self, duration_s: float) -> None:
        self.ewma_s = (duration_s if self.ewma_s is None
                       else 0.8 * self.ewma_s + 0.2 * duration_s)

    def state(self, now: float) -> str:
        if self.draining:
            return "draining"
        if self.ejected:
            return "ejected"
        if self.warming(now):
            return "warming"
        return "ok"

    def snapshot(self, now: float) -> Dict[str, Any]:
        return {
            "index": self.index,
            "address": self.address,
            "health_address": self.health_address,
            "node_id": self.remote_id,
            "state": self.state(now),
            "breaker": self.breaker.snapshot(),
            "queued": self.queued,
            "ewma_s": (round(self.ewma_s, 4)
                       if self.ewma_s is not None else None),
            "routes": self.routes,
            "served": self.served,
            "health_failures": self.health_failures,
        }


class TutoringPool:
    def __init__(
        self,
        addresses: Sequence[str],
        *,
        metrics: Optional[Metrics] = None,
        health_addresses: Optional[Sequence[str]] = None,
        fault_injector: Optional[FaultInjector] = None,
        breakers: Optional[Sequence[CircuitBreaker]] = None,
        breaker_failure_threshold: int = 5,
        breaker_recovery_s: float = 10.0,
        breaker_half_open_max: int = 1,
        timeout_s: float = 120.0,
        deadline_floor_s: float = 0.25,
        hedge_after_s: float = 0.35,
        queue_spill_depth: int = 8,
        warmup_s: float = 5.0,
        warmup_weight: float = 0.25,
        health_poll_s: float = 1.0,
        stream_stall_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.metrics = metrics or Metrics()
        self.faults = fault_injector
        self.timeout_s = timeout_s
        self.deadline_floor_s = deadline_floor_s
        self.hedge_after_s = hedge_after_s
        self.queue_spill_depth = queue_spill_depth
        self.warmup_s = warmup_s
        self.warmup_weight = warmup_weight
        self.health_poll_s = health_poll_s
        # Per-chunk stall watch on streamed forwards: an open-but-silent
        # stream (node wedged, network black hole past the TCP handshake)
        # is declared failed after this much inter-chunk silence — the
        # breaker records it and the stream resumes at the delivered
        # offset on the next candidate. 0 disables the watch.
        self.stream_stall_s = stream_stall_s
        # A queue-depth reading older than this is treated as drained:
        # fleets without health polling only learn depth from response
        # trailers, and a node spilled around receives no trailers — a
        # non-expiring reading would lock its key share out forever.
        self.queue_ttl_s = max(2.0, 5.0 * health_poll_s)
        self._clock = clock
        self._breaker_kwargs = dict(
            failure_threshold=breaker_failure_threshold,
            recovery_s=breaker_recovery_s,
            half_open_max=breaker_half_open_max,
        )
        self._nodes: List[TutoringNode] = []   # guarded-by: event-loop
        self._next_index = 0                   # guarded-by: event-loop
        # node index -> last observed breaker state code (see
        # _on_breaker_change for why this is tracked, not read live).
        self._breaker_codes: Dict[int, float] = {}  # guarded-by: event-loop
        # Background score jobs routed through this pool: job id -> the
        # fleet node holding it (GET /admin/score/<id> proxies there).
        self._score_jobs: Dict[str, TutoringNode] = {}  # guarded-by: event-loop
        self._poller_task: Optional[asyncio.Task] = None
        # node index -> in-flight health-poll task (retained so the
        # cadence loop can skip hung probes and close() can cancel them).
        self._node_polls: Dict[int, asyncio.Task] = {}  # guarded-by: event-loop
        health = list(health_addresses or [])
        for i, address in enumerate(addresses):
            self._add(address, health[i] if i < len(health) else None,
                      breaker=(breakers[i] if breakers is not None
                               and i < len(breakers) else None))

    # ---------------------------------------------------------- membership

    @property
    def configured(self) -> bool:
        return bool(self._nodes)

    @property
    def nodes(self) -> List[TutoringNode]:
        return list(self._nodes)

    def _add(self, address: str, health_address: Optional[str],
             breaker: Optional[CircuitBreaker] = None) -> TutoringNode:
        node = TutoringNode(
            self._next_index, address, health_address,
            breaker=breaker or CircuitBreaker(**self._breaker_kwargs),
        )
        self._next_index += 1
        node.breaker.set_state_change_callback(
            lambda old, new, n=node: self._on_breaker_change(n, old, new)
        )
        self._nodes.append(node)
        self._update_fleet_gauge()
        return node

    def add_node(self, address: str,
                 health_address: Optional[str] = None) -> TutoringNode:
        """Admit a new fleet member (or re-admit an ejected one). New
        members join warming: the warm-up weight keeps their key share
        small until the prefix cache has had `warmup_s` to fill."""
        for node in self._nodes:
            if node.address == address:
                if health_address is not None:
                    node.health_address = health_address
                if node.ejected or node.draining:
                    self._rejoin(node)
                return node
        node = self._add(address, health_address)
        node.warming_until = self._clock() + self.warmup_s
        return node

    def remove_node(self, address: str) -> bool:
        for node in list(self._nodes):
            if node.address == address:
                self._nodes.remove(node)
                self._breaker_codes.pop(node.index, None)
                poll = self._node_polls.pop(node.index, None)
                if poll is not None and not poll.done():
                    poll.cancel()
                # The removed node's (possibly open) breaker must not
                # keep the worst-state gauge pinned.
                self.metrics.set_gauge(
                    metric.TUTORING_BREAKER_STATE,
                    max(self._breaker_codes.values(), default=0.0),
                )
                self._update_fleet_gauge()
                # Channel teardown is async; schedule it rather than
                # blocking the admin handler on a dead peer's socket.
                task = asyncio.ensure_future(node.close())
                task.add_done_callback(
                    lambda t: None if t.cancelled() else t.exception()
                )
                return True
        return False

    def eject(self, address: str) -> bool:
        """True when the node exists (idempotent: ejecting an already-
        ejected node is a successful no-op — a retried admin op must not
        read as 'unknown node')."""
        for node in self._nodes:
            if node.address == address:
                if not node.ejected:
                    self._eject(node)
                return True
        return False

    def join(self, address: str) -> bool:
        """True when the node exists (idempotent, like `eject`)."""
        for node in self._nodes:
            if node.address == address:
                if node.ejected or node.draining:
                    self._rejoin(node)
                return True
        return False

    def _eject(self, node: TutoringNode) -> None:
        node.ejected = True
        self.metrics.inc(metric.TUTORING_NODE_EJECTIONS)
        self._update_fleet_gauge()
        log.warning("tutoring node %s ejected from the ring", node.address)

    def _rejoin(self, node: TutoringNode) -> None:
        node.ejected = False
        node.draining = False
        node.warming_until = self._clock() + self.warmup_s
        self.metrics.inc(metric.TUTORING_NODE_REJOINS)
        self._update_fleet_gauge()
        log.info("tutoring node %s re-admitted (warm-up %.1fs)",
                 node.address, self.warmup_s)

    def _update_fleet_gauge(self) -> None:
        self.metrics.set_gauge(
            metric.TUTORING_FLEET_SIZE,
            float(sum(1 for n in self._nodes if n.routable())),
        )

    # ------------------------------------------------------------- routing

    def rendezvous_order(self, key: str, *,
                         routable_only: bool = True) -> List[TutoringNode]:
        """Nodes by weighted-rendezvous score, best first (draining/
        ejected nodes excluded unless `routable_only=False` — the full
        ring answers "whose key IS this", which spill accounting needs
        even while the owner is out). Scores are per-(node, key), so
        removing a node moves ONLY the keys it owned and adding one
        steals ~1/(N+1) — the minimal-remap property the prefix caches
        depend on."""
        now = self._clock()
        scored = []
        for node in self._nodes:
            if routable_only and not node.routable():
                continue
            digest = hashlib.sha1(
                f"{node.address}|{key}".encode()
            ).digest()
            u = int.from_bytes(digest[:8], "big") / 2.0 ** 64
            u = min(max(u, 1e-12), 1.0 - 1e-12)
            weight = node.weight(now, self.warmup_weight, self.warmup_s)
            scored.append((-math.log(u) / max(weight, 1e-9), node))
        scored.sort(key=lambda pair: pair[0])
        return [node for _score, node in scored]

    def queue_depth_of(self, node: TutoringNode) -> int:
        """The node's serving-queue depth for spill decisions — 0 when
        the last observation has aged past `queue_ttl_s` (a queue that
        deep drains in seconds; permanently distrusting the node on one
        stale burst reading would cost its prefix-cache affinity)."""
        if self._clock() - node.queued_at > self.queue_ttl_s:
            return 0
        return node.queued

    def plan_route(
        self, key: str, deadline: Optional[Deadline] = None
    ) -> Tuple[List[TutoringNode], str, Optional[TutoringNode]]:
        """Candidate order for one forward, the reason the head was (or
        was not) the affinity node, and the affinity node itself (the
        pre-rotation ring winner — returned so the caller never
        recomputes the ring and risks a different clock read). Pure
        w.r.t. breaker state — the allow() walk happens at send time so
        half-open probe slots are only consumed by attempts that really
        go out."""
        order = self.rendezvous_order(key)
        affinity = order[0] if order else None
        if len(order) < 2:
            return order, "affinity", affinity
        head, second = order[0], order[1]
        if (self.queue_depth_of(head) > self.queue_spill_depth
                and self.queue_depth_of(second)
                <= self.queue_spill_depth):
            return order[1:] + order[:1], "spill:queue", affinity
        if deadline is not None and head.ewma_s is not None:
            remaining = deadline.remaining()
            if (head.ewma_s >= remaining - self.deadline_floor_s
                    and (second.ewma_s is None
                         or second.ewma_s < head.ewma_s)):
                return order[1:] + order[:1], "spill:budget", affinity
        return order, "affinity", affinity

    def route_snapshot(self, query: str,
                       session_id: str = "") -> Dict[str, Any]:
        """Read-only routing answer for `GET /admin/tutoring/route?q=`:
        which node would serve this query, and the spill order behind
        it. A session id answers for the SESSION's sticky key instead
        (`&session=<sid>` — the key every turn of that session routes
        by), so the chaos drills can fault exactly the node holding a
        live session's transcript."""
        key = (session_affinity_key(session_id) if session_id
               else affinity_key(query))
        now = self._clock()
        return {
            "key": key,
            "order": [
                {"index": n.index, "address": n.address,
                 "state": n.state(now)}
                for n in self.rendezvous_order(key)
            ],
        }

    # -------------------------------------------------- background jobs

    def plan_background(self) -> List[TutoringNode]:
        """Placement order for BACKGROUND work (bulk score jobs): off the
        hot affinity nodes first. Interactive routing chases cache
        affinity; background jobs have no prefix blocks to reuse and
        must not land on the node a course's students are hammering —
        order by observed queue depth, then by how much interactive
        traffic the ring has routed there, so bulk work soaks the
        COLDEST lanes and interactive p95 never pays for it."""
        nodes = [n for n in self._nodes if n.routable()]
        return sorted(
            nodes,
            key=lambda n: (self.queue_depth_of(n), n.routes, n.index),
        )

    async def submit_score_job(
        self, texts: Sequence[str], *, purpose: str = "grading",
        job_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Fan one bulk score job to the fleet's coldest scoring-capable
        node (POST /admin/score on its admin plane). Returns
        {job_id, node, health, ...job summary}; raises
        TutoringUnavailable when no routable node accepts (no health
        addresses configured, tenant disabled everywhere, or every
        attempt failed)."""
        errors: List[str] = []
        candidates = [
            n for n in self.plan_background() if n.health_address
        ]
        if not candidates:
            raise TutoringUnavailable(
                "no scoring-capable tutoring node: background jobs need "
                "health_addresses (the admin plane they are submitted "
                "over)", kind="none",
            )
        payload: Dict[str, Any] = {
            "texts": list(texts), "purpose": purpose,
        }
        if job_id:
            payload["job_id"] = job_id
        for node in candidates:
            assert node.health_address is not None
            try:
                doc = await _http_post_json(
                    node.health_address, "/admin/score", payload
                )
            except Exception as e:  # noqa: BLE001 — try the next node
                errors.append(f"{node.address}: {e}")
                continue
            jid = str(doc.get("job_id", ""))
            if not jid:
                errors.append(f"{node.address}: no job_id in {doc}")
                continue
            self._score_jobs[jid] = node
            log.info("score job %s (%d texts, %s) routed to %s",
                     jid, len(payload["texts"]), purpose, node.address)
            return {
                "job_id": jid,
                "node": node.address,
                "health": node.health_address,
                "texts": doc.get("texts", len(payload["texts"])),
                "status": doc.get("status", "queued"),
            }
        raise TutoringUnavailable(
            f"every scoring submit failed: {errors[:3]}", kind="rpc"
        )

    async def score_job_status(self, job_id: str) -> Dict[str, Any]:
        """Proxy GET /admin/score/<job_id> from the node the job was
        routed to; KeyError for unknown ids — including a node-side 404
        (retention-trimmed job, or a restarted node that lost its
        in-memory jobs) — so the LMS plane answers 404 instead of a
        status-less 200 a poller would spin on forever."""
        node = self._score_jobs.get(job_id)
        if node is None or node.health_address is None:
            raise KeyError(job_id)
        doc = await _http_get_admin(
            node.health_address, f"/admin/score/{job_id}", timeout_s=10.0
        )
        return {"node": node.address, **doc}

    def _can_hedge(self, deadline: Optional[Deadline]) -> bool:
        if self.hedge_after_s <= 0:
            return False
        if deadline is None:
            return True
        # Budget-aware: a hedge only helps if there is room for the
        # second attempt AND the degraded-fallback floor after it.
        return deadline.remaining() > (self.hedge_after_s
                                       + 2.0 * self.deadline_floor_s)

    # ------------------------------------------------------------- forward

    async def forward(
        self, query: str, token: str,
        deadline: Optional[Deadline] = None,
    ) -> Tuple[Any, Optional[str]]:
        """Route + send one tutoring query; returns (QueryResponse,
        served-by node id). Raises TutoringUnavailable when no node
        could answer — the caller degrades to the instructor queue."""
        if not self._nodes:
            raise TutoringUnavailable("no tutoring nodes configured",
                                      kind="none")
        key = affinity_key(query)
        order, route_reason, affinity = self.plan_route(key, deadline)
        if not order:
            raise TutoringUnavailable(
                "every tutoring node is draining or ejected",
                kind="ejected",
            )
        # Spill accounting is against the FULL ring's owner: when the
        # key's true owner is ejected/draining, the routable winner is
        # already somebody else's node, and serving there must still
        # count (and read) as a spill. Only walk the full ring when a
        # node actually is out.
        if any(not n.routable() for n in self._nodes):
            full = self.rendezvous_order(key, routable_only=False)
            owner = full[0] if full else affinity
            if owner is not affinity and route_reason == "affinity":
                route_reason = "spill:ejected"
        else:
            owner = affinity
        # The breaker walk: the first candidate whose circuit admits the
        # send becomes the primary; skipped candidates are spills.
        primary = None
        primary_pos = 0
        for i, node in enumerate(order):
            if node.breaker.allow():
                primary, primary_pos = node, i
                break
        with get_tracer().span("router.pick", key=key[:48]) as sp:
            if primary is None:
                sp.set_attr("node", None)
                sp.set_attr("reason", "breaker")
                raise TutoringUnavailable("circuit open", kind="breaker")
            if primary is affinity and primary is owner:
                # A queue/budget rotation the breaker walk circled back
                # from is no spill — the span must agree with the
                # counter.
                route_reason = "affinity"
            elif primary is not affinity and route_reason == "affinity":
                route_reason = "spill:breaker"
            sp.set_attr("node", primary.address)
            sp.set_attr("node_index", primary.index)
            sp.set_attr("reason", route_reason)
            sp.set_attr("candidates", len(order))
        primary.routes += 1
        backups = order[primary_pos + 1:]
        answer, served, node = await self._race(
            primary, backups, query, token, deadline
        )
        if node is not owner:
            self.metrics.inc(metric.TUTORING_SPILLS)
        node.served += 1
        return answer, served

    async def _race(
        self, primary: TutoringNode, backups: List[TutoringNode],
        query: str, token: str, deadline: Optional[Deadline],
    ) -> Tuple[Any, Optional[str], TutoringNode]:
        loop = asyncio.get_running_loop()
        tasks: Dict[asyncio.Task, TutoringNode] = {}

        def spawn(node: TutoringNode) -> asyncio.Task:
            task = loop.create_task(
                self._attempt(node, query, token, deadline)
            )
            tasks[task] = node
            return task

        hedge_task: Optional[asyncio.Task] = None
        winner: Optional[asyncio.Task] = None
        budget_exhausted = False
        last_error: Optional[BaseException] = None
        may_hedge = bool(backups) and self._can_hedge(deadline)
        primary_started = time.monotonic()
        pending = {spawn(primary)}
        try:
            while pending:
                if may_hedge and hedge_task is None:
                    done, still = await asyncio.wait(
                        pending, timeout=self.hedge_after_s
                    )
                    pending = set(still)
                    if not done:
                        # The primary is slow, not (yet) failed: hedge
                        # to the next choice whose circuit admits it.
                        backup = next(
                            (b for b in backups if b.breaker.allow()),
                            None,
                        )
                        may_hedge = False
                        if backup is not None:
                            self.metrics.inc(metric.TUTORING_HEDGES)
                            hedge_task = spawn(backup)
                            backup.routes += 1
                            pending.add(hedge_task)
                        continue
                else:
                    done, still = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED
                    )
                    pending = set(still)
                # Prefer the primary when both land in one wake-up, so
                # the hedge-win counter means "the hedge was genuinely
                # faster".
                for task in sorted(done, key=lambda t: t is hedge_task):
                    if task.cancelled():
                        continue
                    exc = task.exception()
                    if exc is None:
                        if winner is None:
                            winner = task
                    elif isinstance(exc, TutoringUnavailable):
                        budget_exhausted = (budget_exhausted
                                            or exc.kind == "budget")
                        last_error = exc
                    elif isinstance(exc, _NODE_ERRORS):
                        last_error = exc
                        self._note_failure(tasks[task], exc)
                    else:
                        raise exc
                if winner is not None:
                    break
            if winner is not None:
                # First answer wins; the loser is cancelled by the
                # finally below (its span closes as "cancelled", its
                # RPC torn down by grpc.aio).
                # Already-done asyncio.Task: result() is immediate.
                answer, served, duration_s = winner.result()  # lint: disable=no-blocking-in-async
                node = tasks[winner]
                node.breaker.record_success()
                node.note_latency(duration_s)
                if winner is hedge_task:
                    self.metrics.inc(metric.TUTORING_HEDGE_WINS)
                    # The cancelled primary never reports its latency,
                    # so feed its EWMA the elapsed FLOOR (it was at
                    # least this slow) — but only when that raises the
                    # estimate: without this, a sustained-slow affinity
                    # node's EWMA stays frozen at its healthy value and
                    # the budget-spill branch never learns to route
                    # around it.
                    elapsed = time.monotonic() - primary_started
                    if primary.ewma_s is None or elapsed > primary.ewma_s:
                        primary.note_latency(elapsed)
                return answer, served, node
            # Primary (and any hedge) failed: spill sequentially through
            # the remaining candidates (direct awaits — handler
            # cancellation propagates straight into the attempt).
            tried = set(tasks.values())
            for node in backups:
                if node in tried or not node.breaker.allow():
                    continue
                node.routes += 1
                try:
                    answer, served, duration_s = await self._attempt(
                        node, query, token, deadline
                    )
                except TutoringUnavailable as e:
                    budget_exhausted = (budget_exhausted
                                        or e.kind == "budget")
                    last_error = e
                    continue
                except _NODE_ERRORS as e:
                    last_error = e
                    self._note_failure(node, e)
                    continue
                node.breaker.record_success()
                node.note_latency(duration_s)
                return answer, served, node
            if budget_exhausted and not isinstance(last_error,
                                                   _NODE_ERRORS):
                raise TutoringUnavailable("deadline budget exhausted",
                                          kind="budget")
            raise TutoringUnavailable(
                f"tutoring RPC failed ({self._describe(last_error)})",
                kind="rpc",
            )
        finally:
            # Whatever ends the race — first answer, total failure, or
            # the HANDLER itself being cancelled (client disconnect, RPC
            # deadline) — no spawned attempt may outlive it: an orphaned
            # RPC would occupy a tutoring slot computing an answer
            # nobody reads.
            live = [t for t in tasks if not t.done()]
            for t in live:
                t.cancel()
            if live:
                await asyncio.gather(*live, return_exceptions=True)

    # ------------------------------------------------------ streaming forward

    async def forward_stream(
        self, query: str, token: str,
        deadline: Optional[Deadline] = None,
        *, session_id: str = "", resume_offset: int = 0,
    ):
        """Route one streamed tutoring query; an async generator of
        `StreamChunk`s upholding the resumable-stream contract end to
        end:

        - offsets are monotone and gap-free from `resume_offset` through
          the final chunk, across ANY number of mid-stream failovers;
        - hedging happens only BEFORE the first chunk (a raced fork can
          be cancelled unread); after the first delivered byte a broken
          stream is *resumed at the delivered offset* on the next
          candidate — never forked, never restarted, so no token is ever
          delivered twice or dropped;
        - pure-duplicate chunks from an over-eager resume are dropped;
          an offset gap or a mid-chunk overlap is a protocol violation
          that fails the sending node (`StreamProtocolError`);
        - a session id re-keys the ring (`session_affinity_key`) so every
          turn of a session lands on the node holding its transcript and
          pinned prefix blocks.

        Raises TutoringUnavailable when no node can continue; the caller
        checks whether any byte was already delivered to choose between
        the degraded fallback and a hard abort."""
        if not self._nodes:
            raise TutoringUnavailable("no tutoring nodes configured",
                                      kind="none")
        key = (session_affinity_key(session_id) if session_id
               else affinity_key(query))
        order, route_reason, affinity = self.plan_route(key, deadline)
        if not order:
            raise TutoringUnavailable(
                "every tutoring node is draining or ejected",
                kind="ejected",
            )
        if any(not n.routable() for n in self._nodes):
            full = self.rendezvous_order(key, routable_only=False)
            owner = full[0] if full else affinity
        else:
            owner = affinity
        with get_tracer().span("router.pick", key=key[:48]) as sp:
            sp.set_attr("stream", True)
            sp.set_attr("reason", route_reason)
            sp.set_attr("candidates", len(order))
        delivered = max(0, int(resume_offset))
        tried: set = set()
        first_byte = False
        while True:
            if first_byte:
                # Continuing a stream this generator already delivered
                # bytes of: failover = resume-at-offset, by definition.
                self.metrics.inc(metric.STREAM_RESUMES)
            node, gen, chunk = await self._next_stream(
                order, tried, query, token, deadline, session_id,
                delivered,
                # Hedging forks generation, safe only while nothing has
                # been delivered ANYWHERE in the logical stream — a
                # client-driven resume (resume_offset > 0) is past that
                # point even though this RPC has sent nothing yet.
                allow_hedge=not first_byte and delivered == 0,
            )
            if node is not owner:
                self.metrics.inc(metric.TUTORING_SPILLS)
            try:
                while True:
                    if chunk.success and chunk.count > 0:
                        end = chunk.offset + chunk.count
                        if end <= delivered:
                            pass  # pure duplicate (over-eager resume): drop
                        elif chunk.offset != delivered:
                            raise StreamProtocolError(
                                f"stream chunk offset {chunk.offset} != "
                                f"delivered {delivered} from {node.address}"
                            )
                        else:
                            delivered = end
                            first_byte = True
                            yield chunk
                    else:
                        # Failure chunks and empty finals pass through
                        # unvalidated (no token payload to account).
                        yield chunk
                    if chunk.final:
                        node.served += 1
                        return
                    chunk = await gen.__anext__()
            except StopAsyncIteration as e:
                self._note_failure(node, StreamProtocolError(
                    f"stream from {node.address} ended without a final "
                    "chunk"
                ))
                last = e
            except TutoringUnavailable:
                raise
            except _NODE_ERRORS as e:
                self._note_failure(node, e)
                last = e
            finally:
                # Must-complete teardown: a cancelled forward must not
                # leave the node-side RPC open computing tokens nobody
                # reads.
                await asyncio.shield(self._close_stream(gen, None))
            log.warning("stream from %s broke at offset %d (%s); "
                        "resuming on the next candidate", node.address,
                        delivered, type(last).__name__)

    async def _next_stream(
        self, order: List[TutoringNode], tried: set, query: str,
        token: str, deadline: Optional[Deadline], session_id: str,
        offset: int, allow_hedge: bool,
    ) -> Tuple[TutoringNode, Any, Any]:
        """Open a stream on the best untried candidate whose breaker
        admits it; returns (node, chunk generator, first chunk). The
        hedge window applies only here — to the FIRST chunk: when the
        primary sits silent past `hedge_after_s`, a second stream races
        it and the loser is cancelled before anything was delivered.
        Nodes are marked `tried` when they fail or win (a cancelled
        hedge loser stays eligible as a later resume target)."""
        last_error: Optional[BaseException] = None
        budget_exhausted = False
        attempted = False

        def next_candidate() -> Optional[TutoringNode]:
            return next(
                (n for n in order if n not in tried and n.breaker.allow()),
                None,
            )

        while True:
            node = next_candidate()
            if node is None:
                break
            attempted = True
            node.routes += 1
            gen = self._attempt_stream(node, query, token, deadline,
                                       session_id, offset)
            first = asyncio.ensure_future(gen.__anext__())
            racers: Dict[asyncio.Future, Tuple[TutoringNode, Any]] = {
                first: (node, gen)
            }
            if allow_hedge and self._can_hedge(deadline):
                done, _ = await asyncio.wait({first},
                                             timeout=self.hedge_after_s)
                if not done:
                    hnode = next_candidate()
                    if hnode is not None and hnode is not node:
                        self.metrics.inc(metric.TUTORING_HEDGES)
                        hnode.routes += 1
                        hgen = self._attempt_stream(
                            hnode, query, token, deadline, session_id,
                            offset,
                        )
                        racers[asyncio.ensure_future(hgen.__anext__())] = (
                            hnode, hgen
                        )
            pending = set(racers)
            winner: Optional[asyncio.Future] = None
            while pending and winner is None:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                # Prefer the primary when both land in one wake-up, so
                # hedge wins mean "the hedge was genuinely faster".
                for task in sorted(done, key=lambda t: t is not first):
                    t_node, _t_gen = racers[task]
                    if task.cancelled():
                        continue
                    exc = task.exception()
                    if exc is None:
                        winner = task
                        break
                    tried.add(t_node)
                    if isinstance(exc, StopAsyncIteration):
                        last_error = StreamProtocolError(
                            f"stream from {t_node.address} closed before "
                            "any chunk"
                        )
                        self._note_failure(t_node, last_error)
                    elif isinstance(exc, TutoringUnavailable):
                        budget_exhausted = (budget_exhausted
                                            or exc.kind == "budget")
                        last_error = exc
                    elif isinstance(exc, _NODE_ERRORS):
                        last_error = exc
                        self._note_failure(t_node, exc)
                    else:
                        for lt, (_ln, lg) in racers.items():
                            if lt is not task:
                                await self._close_stream(lg, lt)
                        raise exc
            if winner is not None:
                wnode, wgen = racers[winner]
                tried.add(wnode)
                if winner is not first:
                    self.metrics.inc(metric.TUTORING_HEDGE_WINS)
                for task, (_n, g) in racers.items():
                    if task is not winner:
                        await self._close_stream(g, task)
                # Already-done asyncio.Task: result() is immediate.
                return wnode, wgen, winner.result()  # lint: disable=no-blocking-in-async
            for task, (_n, g) in racers.items():
                await self._close_stream(g, task)
        if budget_exhausted and not isinstance(last_error, _NODE_ERRORS):
            raise TutoringUnavailable("deadline budget exhausted",
                                      kind="budget")
        if not attempted:
            raise TutoringUnavailable("circuit open", kind="breaker")
        raise TutoringUnavailable(
            f"tutoring stream failed ({self._describe(last_error)})",
            kind="rpc",
        )

    @staticmethod
    async def _close_stream(gen: Any,
                            task: Optional[asyncio.Future]) -> None:
        """Tear down one attempt's generator (and its in-flight first-
        chunk task): a hedge loser or a broken stream must not keep its
        RPC open computing tokens nobody reads."""
        if task is not None and not task.done():
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        try:
            await gen.aclose()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass

    async def _attempt_stream(
        self, node: TutoringNode, query: str, token: str,
        deadline: Optional[Deadline], session_id: str, resume_offset: int,
    ):
        """One node's streamed attempt: an async generator of raw
        chunks. Inter-chunk silence past `stream_stall_s` raises
        asyncio.TimeoutError (a `_NODE_ERRORS` member — the caller's
        breaker bookkeeping treats the wedged-but-open stream exactly
        like a dead node). The chaos `error` fault injects a mid-stream
        loss AFTER the first chunk, exercising resume-at-offset."""
        if deadline is not None and (
            deadline.timeout(cap=self.timeout_s) <= self.deadline_floor_s
        ):
            raise TutoringUnavailable("deadline budget exhausted",
                                      kind="budget")
        plan = None
        if self.faults is not None:
            plan = await self.faults.apply_pre(node.fault_target())
        t0 = time.monotonic()
        md = deadline.to_metadata() if deadline is not None else None
        req = lms_pb2.StreamRequest(
            token=token, query=query, session_id=session_id,
            resume_offset=resume_offset,
        )
        cancelled = False
        sent = 0
        with get_tracer().span("tutoring.stream", node=node.address,
                               resume_offset=resume_offset) as sp:
            call = node.stub().StreamLLMAnswer(
                req,
                timeout=self._attempt_timeout(deadline),
                metadata=trace_metadata(md),
            )
            try:
                while True:
                    if self.stream_stall_s > 0:
                        try:
                            chunk = await asyncio.wait_for(
                                call.read(), self.stream_stall_s
                            )
                        except asyncio.TimeoutError:
                            self.metrics.inc(metric.STREAM_STALLS)
                            sp.set_status("stalled")
                            sp.set_attr("stalled_at_chunk", sent)
                            raise
                    else:
                        chunk = await call.read()
                    if chunk is grpc.aio.EOF:
                        break
                    yield chunk
                    sent += 1
                    if plan is not None and plan.error:
                        raise FaultInjected(
                            f"injected mid-stream loss <- "
                            f"{node.fault_target()}"
                        )
                served = await self._read_trailer(call, node)
                sp.set_attr("served_by", served)
                sp.set_attr("chunks", sent)
                node.note_latency(time.monotonic() - t0)
            # See _attempt: the re-raise happens after the span block so
            # it closes cleanly; `if cancelled: raise` below always
            # fires, so cancellation is never actually swallowed.
            # lint: disable-next=cancellation-safety
            except asyncio.CancelledError:
                # A hedge-race loser (or the handler going away): normal
                # operation, not an error.
                sp.set_status("cancelled")
                sp.set_attr("cancelled", True)
                cancelled = True
            finally:
                call.cancel()
        if cancelled:
            raise asyncio.CancelledError()

    @staticmethod
    def _describe(exc: Optional[BaseException]) -> str:
        if isinstance(exc, grpc.RpcError):
            try:
                return str(exc.code())
            except Exception:
                return type(exc).__name__
        return str(exc) if exc is not None else "no candidates"

    def _attempt_timeout(self, deadline: Optional[Deadline]) -> float:
        """Per-attempt gRPC timeout: the live remaining budget capped at
        the configured forward timeout, minus the degraded-fallback
        floor — re-read at call-build time because injected delays and
        earlier attempts have been eating it."""
        if deadline is None:
            return self.timeout_s
        return max(0.001,
                   deadline.timeout(cap=self.timeout_s)
                   - self.deadline_floor_s)

    async def _attempt(
        self, node: TutoringNode, query: str, token: str,
        deadline: Optional[Deadline],
    ) -> Tuple[Any, Optional[str], float]:
        if deadline is not None and (
            deadline.timeout(cap=self.timeout_s) <= self.deadline_floor_s
        ):
            raise TutoringUnavailable("deadline budget exhausted",
                                      kind="budget")
        plan = None
        if self.faults is not None:
            plan = await self.faults.apply_pre(node.fault_target())
        t0 = time.monotonic()
        md = deadline.to_metadata() if deadline is not None else None
        req = lms_pb2.QueryRequest(token=token, query=query)
        cancelled = False
        answer = served = None
        # trace_metadata called INSIDE the span: the forwarded
        # x-trace-context carries this span's id, so the tutoring node's
        # fragment grafts under it on the waterfall.
        with get_tracer().span("tutoring.forward",
                               node=node.address) as sp:
            try:
                call = node.stub().GetLLMAnswer(
                    req,
                    timeout=self._attempt_timeout(deadline),
                    metadata=trace_metadata(md),
                )
                answer = await call
                served = await self._read_trailer(call, node)
                sp.set_attr("served_by", served)
            # The re-raise happens AFTER the span block so the span
            # closes cleanly first — lexically this handler does not
            # contain a `raise`, but `if cancelled: raise` below always
            # fires, so cancellation is never actually swallowed.
            # lint: disable-next=cancellation-safety
            except asyncio.CancelledError:
                # A hedge race loser: normal operation, not an error —
                # exit the span cleanly (no FLAG_ERROR pin), then
                # re-raise so task cancellation semantics hold.
                sp.set_status("cancelled")
                sp.set_attr("cancelled", True)
                cancelled = True
        if cancelled:
            raise asyncio.CancelledError()
        if plan is not None and plan.duplicate:
            # Deliver the query twice, like FaultyTransport does for
            # Raft RPCs: the hop is a pure read/compute, so a duplicate
            # must only cost compute, never change the answer. The
            # re-send failing must not discard the first answer.
            self.metrics.inc(metric.TUTORING_DUPLICATES)
            try:
                with get_tracer().span("tutoring.forward",
                                       node=node.address,
                                       duplicate=True):
                    dup = node.stub().GetLLMAnswer(
                        req,
                        timeout=self._attempt_timeout(deadline),
                        metadata=trace_metadata(md),
                    )
                    answer = await dup
            except grpc.RpcError as e:
                log.info("duplicate delivery failed (%s); keeping the "
                         "first answer", e.code())
        if plan is not None and plan.error:
            raise FaultInjected(
                f"injected response loss <- {node.fault_target()}"
            )
        return answer, served, time.monotonic() - t0

    async def _read_trailer(self, call: Any,
                            node: TutoringNode) -> Optional[str]:
        """`x-served-by` / `x-queue-depth` from the response trailer:
        the node's self-reported identity (threaded into the forward
        span) and a passive queue-depth signal between health polls."""
        served: Optional[str] = None
        try:
            trailer = await call.trailing_metadata()
        except Exception:
            return node.remote_id
        for k, v in trailer or ():
            if k == SERVED_BY_METADATA_KEY:
                served = str(v)
                node.remote_id = served
            elif k == QUEUE_DEPTH_METADATA_KEY:
                try:
                    node.queued = int(v)
                    node.queued_at = self._clock()
                except (TypeError, ValueError):
                    pass
        return served if served is not None else node.remote_id

    def _note_failure(self, node: TutoringNode,
                      exc: BaseException) -> None:
        if isinstance(exc, grpc.RpcError):
            details = ""
            try:
                details = exc.details() or ""
            except Exception:
                pass
            if "draining" in details and node.health_address is not None:
                # Not a fault, a lifecycle signal: the node refused
                # admission because an operator is draining it. Eject it
                # from the ring instead of penalizing its breaker — the
                # health poller will observe the drain's end and rejoin
                # it. WITHOUT a health address there is no poller to see
                # recovery, and an ejected node gets no traffic to learn
                # from either — permanent silent capacity loss — so in
                # that configuration the refusal goes through the
                # breaker instead: its half-open probes keep testing the
                # node and re-close the circuit once the drain ends.
                node.draining = True
                if not node.ejected:
                    self._eject(node)
                return
        self.metrics.inc(metric.TUTORING_FAILURES)
        node.breaker.record_failure()

    def _on_breaker_change(self, node: TutoringNode, old: str,
                           new: str) -> None:
        # Runs INSIDE the transitioning breaker's lock. It must not read
        # other breakers' `.state`/`state_code()` here: those reads can
        # themselves transition (open -> half-open on the recovery
        # clock) and fire THIS callback for the other breaker, which
        # would then try to re-acquire the first breaker's non-reentrant
        # lock — a self-deadlock that freezes the serving loop. The
        # worst-state gauge is therefore computed from last-known codes.
        log.warning("tutoring breaker %s: %s -> %s", node.address, old,
                    new)
        # Transition counters come from the registry's state mapping, so
        # the series stay declared (metrics-registry lint rule).
        self.metrics.inc(metric.BREAKER_TRANSITION_COUNTERS[new])
        self._breaker_codes[node.index] = CircuitBreaker._STATE_CODES[new]
        self.metrics.set_gauge(
            metric.TUTORING_BREAKER_STATE,
            max(self._breaker_codes.values(), default=0.0),
        )

    # ------------------------------------------------------------ health

    def observe_health(self, address: str, doc: Dict[str, Any]) -> None:
        """Fold one node's `/healthz` into routing state: queue depth,
        drain-driven ejection, and drain-end rejoin (with warm-up)."""
        for node in self._nodes:
            if node.address != address and node.health_address != address:
                continue
            if "queued" in doc:
                try:
                    node.queued = int(doc["queued"])
                    node.queued_at = self._clock()
                except (TypeError, ValueError):
                    pass
            if doc.get("node_id"):
                node.remote_id = str(doc["node_id"])
            draining = bool(doc.get("draining"))
            if draining and not node.draining:
                node.health_streak = 0
                node.draining = True
                if not node.ejected:
                    self._eject(node)
            elif not draining and node.draining:
                node.health_streak = 0
                self._rejoin(node)
            elif node.breaker.state == CircuitBreaker.HALF_OPEN:
                # Active recovery probe: healthy polls while half-open
                # close the circuit without waiting for live traffic to
                # happen to route here (a non-affinity node would
                # otherwise hold an open breaker forever). SEVERAL
                # consecutive healthy polls are required: healthz only
                # proves the HTTP metrics plane, and a single poll
                # re-closing the breaker every cycle would neutralize
                # fail-fast under an asymmetric partition (gRPC dead,
                # HTTP alive). The streak slows the flap to one doomed
                # probe window per HEALTH_CLOSE_STREAK polls.
                node.health_streak += 1
                if node.health_streak >= HEALTH_CLOSE_STREAK:
                    node.health_streak = 0
                    node.breaker.record_success()
            else:
                node.health_streak = 0
            return

    async def _poll_node(self, node: TutoringNode) -> None:
        try:
            doc = await _http_get_json(node.health_address, "/healthz")
        except Exception:
            node.health_failures += 1
            node.health_streak = 0
            return
        node.health_failures = 0
        self.observe_health(node.address, doc)

    async def run_health_poller(self) -> None:
        """Dispatch every node's `/healthz` poll on a fixed cadence;
        cancelled by `close()`. Polls are fire-per-node tasks the
        cadence loop never awaits (it only skips a node whose previous
        poll is still in flight), so one hung endpoint's connect/read
        timeouts cannot slow drain/queue detection for the rest of the
        fleet. Nodes without a configured health address rely on the
        response trailer + forward errors alone."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.health_poll_s)
            for node in list(self._nodes):
                if node.health_address is None:
                    continue
                prior = self._node_polls.get(node.index)
                if prior is not None and not prior.done():
                    continue  # still probing (hung endpoint) — skip
                self._node_polls[node.index] = loop.create_task(
                    self._poll_node(node)
                )

    def start(self) -> "TutoringPool":
        """Start the health poller on the running loop (no-op when no
        node has a health address)."""
        if self._poller_task is None and any(
            n.health_address for n in self._nodes
        ):
            self._poller_task = asyncio.get_running_loop().create_task(
                self.run_health_poller()
            )
        return self

    async def close(self) -> None:
        if self._poller_task is not None:
            self._poller_task.cancel()
            try:
                await self._poller_task
            except asyncio.CancelledError:
                pass
            self._poller_task = None
        # Snapshot AND clear before the await: a poller registered by a
        # concurrent add_node while the gather runs belongs to the next
        # lifecycle, and clearing after the await would silently drop it.
        polls = [t for t in self._node_polls.values() if not t.done()]
        self._node_polls.clear()
        for t in polls:
            t.cancel()
        if polls:
            await asyncio.gather(*polls, return_exceptions=True)
        for node in self._nodes:
            # Bounded: channel teardown cancels in-flight hedges, and a
            # node mid-restart must not be able to stall its own stop
            # sequence on a peer's half-dead socket.
            try:
                await asyncio.wait_for(node.close(), timeout=2.0)
            except Exception:  # noqa: BLE001 — teardown must not raise
                log.info("tutoring channel close to %s timed out",
                         node.address)

    # ---------------------------------------------------------- snapshots

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock()
        return {
            "size": sum(1 for n in self._nodes if n.routable()),
            "nodes": [n.snapshot(now) for n in self._nodes],
        }

    def worst_breaker_snapshot(self) -> Dict[str, Any]:
        """Back-compat `/healthz` `tutoring_breaker` key: the snapshot
        of the worst-state node's breaker (a one-node fleet reports its
        only breaker, exactly as before the fleet existed)."""
        worst: Optional[CircuitBreaker] = None
        worst_code = -1.0
        for node in self._nodes:
            code = node.breaker.state_code()
            if code > worst_code:
                worst, worst_code = node.breaker, code
        if worst is None:
            return CircuitBreaker().snapshot()
        return worst.snapshot()
