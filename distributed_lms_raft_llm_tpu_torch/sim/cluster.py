"""The cluster under test: real gRPC nodes with the real admin plane.

Boots N LMS nodes (Raft + LMS + FileTransfer servicers, per-node fault
injectors, breaker, and the SAME admin/health plane `serving/lms_server`
serves — `make_admin`/`make_health` are imported, not re-implemented) plus
a tutoring node, all on one background asyncio loop, with thread-safe
control methods for the workload workers and the operations scheduler:
restart a node in place (same port, same data dir — the storage-recovery
path runs for real), spawn an extra node for a membership add, scrape
`/metrics`, and drive `POST`/`GET /admin/*` over actual HTTP.

Ports are allocated once and pinned for the cluster's lifetime so a
restarted node comes back at its advertised address (peers re-dial it,
clients re-discover it).

The default tutoring engine is `EchoEngine` — a wire-complete stand-in
that exercises the REAL BatchingQueue admission, deadline shedding, HMAC
path, and gRPC plumbing without building a model; the tier-2 soak swaps
in the port's real tiny engine (`[sim] tutoring_engine = "tiny"` or
`"tiny-paged"`), on the `device` the cluster is given (the card unless
the caller asks for the CPU).

The port's copy of `distributed_lms_raft_llm_tpu/sim/cluster.py`, its
logic as it is, with the port's engines in `_boot_tutoring_node` and one
seam more: `tutoring_engine_factory`, a keyword-only argument (not a
config key, not a flag): a callable that returns a warmed engine, which
serves on tutoring node 0 in place of the configured one (a `PagedEngine`
behind a `PagedQueue`, anything else behind a `BatchingQueue`), e.g. a
full-width deployment engine on the card. It is called on the cluster's
loop while tutoring boots, before any Raft node.
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

import grpc

from ..config import SimConfig
from ..lms.group_router import (
    ROUTING_MAP_KEY,
    GroupsAdmin,
    ReshardCoordinator,
    RoutedLMSServicer,
    RoutingMap,
)
from ..lms.node import LMSNode
from ..lms.service import FileTransferServicer, LMSServicer
from ..lms.tutoring_pool import TutoringPool
from ..proto import rpc
from ..raft import NotLeader, RaftConfig, encode_command
from ..raft.grpc_transport import RaftServicer
from ..serving.lms_server import make_admin, make_health
from ..serving.tutoring_server import (
    TutoringService,
    make_tutoring_admin,
    make_tutoring_health,
)
from ..utils.diskfaults import DiskFaultInjector
from ..utils.faults import CampaignRunner, FaultInjector
from ..utils.guards import make_serving_watchdog
from ..utils.healthz import HealthServer
from ..utils.metrics import Metrics
from ..utils.timeline import TimelineSampler
from .workload import WorkloadGenerator

log = logging.getLogger(__name__)

# Sim Raft timing: fast elections so transfers/restarts resolve in tens of
# milliseconds, aggressive snapshotting so the quarantine rejoin really
# exercises InstallSnapshot (the leader compacts the prefix away).
SIM_RAFT = RaftConfig(
    election_timeout_min=0.15, election_timeout_max=0.30,
    heartbeat_interval=0.05,
)
SIM_SNAPSHOT_EVERY = 8


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class EchoEngine:
    """Deterministic tutoring stand-in with the `answer_batch` contract.

    A tiny sleep gives the latency histograms a real (but bounded)
    distribution; it runs in the batcher's executor, never on the loop.
    Speaks the real engines' `pop_program_times` contract too, so sim
    traces carry an `engine.generate` program span and the
    `engine_prog_generate` histogram fills — the SAME reap path the
    TutoringEngine exercises, not a sim-only shortcut.
    """

    # Scoring-tenant quantum size (texts per single dispatch), mirroring
    # the real engines' `score_batch_cap` property.
    score_batch_cap = 4

    def __init__(self, delay_s: float = 0.002):
        self.delay_s = delay_s
        self._prog_times: List[Tuple[str, float, float]] = []

    def answer_batch(self, prompts: List[str]) -> List[str]:
        t0, t0_unix = time.monotonic(), time.time()
        time.sleep(self.delay_s)
        self._prog_times.append(
            ("generate", t0_unix, time.monotonic() - t0)
        )
        return [f"Echo tutor: {p.splitlines()[-2][:96]}"
                if len(p.splitlines()) >= 2 else f"Echo tutor: {p[:96]}"
                for p in prompts]

    def score(self, texts: List[str]) -> List[Dict]:
        """Deterministic stand-in for the real engines' bulk-scoring
        quantum (engine/scoring.score_texts contract: logprob/tokens/
        ppl/truncated per text) — the sim's bulk-grading night runs the
        REAL admin plane, job manager, and co-scheduler against it."""
        t0, t0_unix = time.monotonic(), time.time()
        time.sleep(self.delay_s)
        self._prog_times.append(("score", t0_unix, time.monotonic() - t0))
        out = []
        for text in texts:
            n = max(1, len(text.split()))
            out.append({"logprob": -1.5 * n, "tokens": n,
                        "ppl": 4.4817, "truncated": False})
        return out

    def pop_program_times(self) -> List[Tuple[str, float, float]]:
        out, self._prog_times = self._prog_times, []
        return out


class KeywordGate:
    """Deterministic `RelevanceGate` stand-in with the same `check`
    contract — `(passes, similarity)` from query vs. assignment text.

    Token overlap (stopwords dropped, 4-char-prefix stemming) instead of
    BERT embeddings, so the workload's off-topic asks really exercise the
    gate-reject path and the `gate_pass`/`gate_reject` counters without
    building a BERT encoder. The workload's on-topic queries score >= 0.2
    against its assignment text and the off-topic ones score 0.0, so the
    threshold splits them with margin on both sides.
    """

    threshold = 0.1

    _STOPWORDS = frozenset(
        "the a an is are was of for to and or in on at by me my what how "
        "why who when where does do did it that this after under about "
        "with please i you we your".split()
    )

    def _words(self, text: str) -> set:
        return {
            w for w in (t.strip(".,?!:;-'\"()").lower()
                        for t in text.split())
            if w and w not in self._STOPWORDS
        }

    def check(self, query: str, context: str) -> tuple:
        q, c = self._words(query), self._words(context)
        if not q:
            return False, 0.0
        hits = sum(
            1 for w in q
            if w in c or (len(w) >= 4 and any(
                len(cw) >= 4 and cw[:4] == w[:4] for cw in c
            ))
        )
        sim = hits / len(q)
        return sim >= self.threshold, sim


class SimCluster:
    def __init__(self, workdir: str, cfg: SimConfig, *, nodes: int = 3,
                 device: str = "cuda",
                 tutoring_engine_factory: Optional[Callable[[], Any]] = None):
        self.workdir = workdir
        self.cfg = cfg
        self.n_base = nodes
        # Where the "tiny"/"tiny-paged" engines run; the factory's engine
        # (tutoring node 0 only) brings its own device.
        self.device = device
        self._engine_factory = tutoring_engine_factory
        self._loop = asyncio.new_event_loop()
        self._thread: Optional[threading.Thread] = None
        self._nodes: Dict[int, Dict] = {}       # guarded-by: _lock
        self._ports: Dict[int, int] = {}        # guarded-by: _lock
        self._health_ports: Dict[int, int] = {}  # guarded-by: _lock
        self._addresses: Dict[int, str] = {}    # guarded-by: _lock
        self._extra: Optional[int] = None       # guarded-by: _lock
        self._lock = threading.Lock()
        # Tutoring fleet: index -> node record; addresses pinned for the
        # cluster's lifetime like the LMS ports.
        self._tutoring: Dict[int, Dict] = {}     # guarded-by: _lock
        self._tutoring_addrs: Dict[int, str] = {}        # guarded-by: _lock
        self._tutoring_health: Dict[int, str] = {}       # guarded-by: _lock
        # Sharded control plane ([sim] lms_groups > 1): per-(group, node)
        # Raft ports, pinned like the base ports so restarts come back at
        # the same advertised address.
        self._group_ports: Dict[Tuple[int, int], int] = {}  # guarded-by: _lock
        # The workload's static course assignment doubles as the router's
        # course_of — routing map and traffic agree on who lives where.
        self._wgen = WorkloadGenerator(cfg)
        self._initial_map = RoutingMap.initial(
            max(1, cfg.lms_groups), self._wgen.courses
        )
        # One router HMAC key per cluster ([groups] secret in a real
        # deployment): routers sign forwarded x-lms-* control metadata
        # with it, so a simulated hostile client cannot forge group
        # targeting or forced auth salts/tokens.
        self._router_secret = secrets.token_hex(16)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            for nid in range(1, self.n_base + 1):
                self._ports[nid] = _free_port()
                self._health_ports[nid] = _free_port()
                self._addresses[nid] = f"127.0.0.1:{self._ports[nid]}"
        self._thread = threading.Thread(
            target=self._loop_main, name="sim-cluster", daemon=True
        )
        self._thread.start()
        for idx in range(getattr(self.cfg, "tutoring_nodes", 1)):
            self._run(self._boot_tutoring_node(idx), timeout=120.0)
        for nid in range(1, self.n_base + 1):
            self._run(self._boot_node(nid), timeout=60.0)
        if self.wait_leader(timeout=20.0) is None:
            raise RuntimeError("sim cluster elected no leader")
        for gid in range(1, self.group_count()):
            if self.wait_group_leader(gid, timeout=20.0) is None:
                raise RuntimeError(f"raft group {gid} elected no leader")

    def stop(self) -> None:
        for nid in list(self._nodes):
            try:
                self._run(self._stop_node(nid), timeout=30.0)
            except Exception:
                log.exception("stopping sim node %d failed", nid)
        for idx in list(self._tutoring):
            try:
                self._run(self._stop_tutoring_node(idx), timeout=30.0)
            except Exception:
                log.exception("stopping sim tutoring node %d failed", idx)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _loop_main(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def _run(self, coro, timeout: float):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout
        )

    # ------------------------------------------------------------- topology

    def node_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._nodes)

    def client_servers(self) -> List[str]:
        with self._lock:
            return [self._addresses[n] for n in sorted(self._addresses)
                    if n <= self.n_base]

    def extra_node_id(self) -> Optional[int]:
        with self._lock:
            return self._extra

    def health_port(self, nid: int) -> int:
        with self._lock:
            return self._health_ports[nid]

    # ------------------------------------------------------- group topology

    def group_count(self) -> int:
        return max(1, self.cfg.lms_groups)

    def course_of(self, actor: str) -> str:
        return self._wgen.course_of(actor)

    def group_of(self, actor: str) -> int:
        """Static hint-lane assignment for clients (the INITIAL map —
        lanes only partition the leader-hint cache, so a post-reshard
        client landing on its old lane is merely a cold cache, never a
        correctness issue; the router re-routes every request against
        the live replicated map)."""
        if self.group_count() <= 1:
            return 0
        return self._initial_map.group_for(actor, self._wgen.course_of)

    def live_group_of(self, actor: str) -> int:
        """`actor`'s owning group per the LIVE replicated routing map
        (falls back to the initial map before the first flip) — what the
        ledger tags acked writes with, so the audit knows which writes
        crossed a resharding boundary."""
        if self.group_count() <= 1:
            return 0
        raw = None
        with self._lock:
            recs = list(self._nodes.values())
        for rec in recs:
            gnode = rec.get("groups", {}).get(0)
            if gnode is None:
                continue
            candidate = gnode.state.data["kv"].get(ROUTING_MAP_KEY)
            if candidate:
                raw = candidate
                if gnode.node.is_leader:
                    break
        m = RoutingMap.from_json(raw) if raw else self._initial_map
        return m.group_for(actor, self._wgen.course_of)

    def _group_addrs_locked(self, gid: int) -> Dict[int, str]:  # guarded-by: _lock
        """Pin (allocate-once) group `gid`'s Raft port for every known
        node id. Caller holds `_lock`."""
        out: Dict[int, str] = {}
        for nid in self._addresses:
            key = (gid, nid)
            if key not in self._group_ports:
                self._group_ports[key] = _free_port()
            out[nid] = f"127.0.0.1:{self._group_ports[key]}"
        return out

    def group_topology(self, nid: int) -> Dict:
        """GET /admin/raft on one node — the routing map + per-group
        members/leader/term/applied rows the dashboard renders."""
        return self.admin_get(nid, "/admin/raft")

    def group_leader(self, gid: int) -> Optional[int]:
        for nid in self.node_ids():
            with self._lock:
                rec = self._nodes.get(nid)
            if rec is None:
                continue
            gnode = rec.get("groups", {}).get(gid)
            if gnode is not None and gnode.node.is_leader:
                return nid
        return None

    def wait_group_leader(self, gid: int, timeout: float) -> Optional[int]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            nid = self.group_leader(gid)
            if nid is not None:
                return nid
            time.sleep(0.05)
        return None

    def routing_map_doc(self, nid: Optional[int] = None) -> Dict:
        target = nid if nid is not None else self.node_ids()[0]
        return dict(self.group_topology(target).get("routing_map", {}))

    def reshard(self, course: str, to_group: int) -> Dict:
        """Drive a live course split through the REAL admin plane (the
        coordinator journals every step in the meta group)."""
        nid = self.wait_leader(timeout=15.0)
        if nid is None:
            raise RuntimeError("no leader to accept /admin/reshard")
        return self.admin_post(nid, "/admin/reshard",
                               {"course": course, "to_group": to_group})

    # -------------------------------------------------------- node control

    def restart_node(self, nid: int) -> None:
        self._run(self._stop_node(nid), timeout=30.0)
        self._run(self._boot_node(nid), timeout=60.0)

    def stop_node(self, nid: int) -> None:
        self._run(self._stop_node(nid), timeout=30.0)

    def spawn_extra_node(self) -> tuple:
        """Boot one more node (fresh storage) for a membership add; it
        campaigns harmlessly until the leader commits the config entry
        (the §4.2.3 vote guard keeps it from disrupting the members)."""
        with self._lock:
            nid = max(self._ports) + 1
            self._ports[nid] = _free_port()
            self._health_ports[nid] = _free_port()
            self._addresses[nid] = f"127.0.0.1:{self._ports[nid]}"
            self._extra = nid
        self._run(self._boot_node(nid), timeout=60.0)
        return nid, self._addresses[nid]

    # ----------------------------------------------------------- HTTP plane

    def _http(self, req: urllib.request.Request, timeout: float = 10.0):
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    def admin_post(self, nid: int, path: str, body: Dict) -> Dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.health_port(nid)}{path}",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            return self._http(req, timeout=30.0)
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise RuntimeError(
                f"admin POST {path} on node {nid} -> {e.code}: {detail}"
            ) from e

    def admin_get(self, nid: int, path: str) -> Dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.health_port(nid)}{path}", method="GET"
        )
        return self._http(req)

    def healthz(self, nid: int) -> Dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.health_port(nid)}/healthz", method="GET"
        )
        return self._http(req)

    def metrics_snapshot(self, nid: int) -> Dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.health_port(nid)}/metrics", method="GET"
        )
        return self._http(req)

    def tutoring_count(self) -> int:
        with self._lock:
            return len(self._tutoring)

    def tutoring_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._tutoring)

    def tutoring_addresses(self) -> List[str]:
        with self._lock:
            return [self._tutoring_addrs[i]
                    for i in sorted(self._tutoring_addrs)
                    if i in self._tutoring]

    def tutoring_health_addresses(self) -> List[str]:
        with self._lock:
            return [self._tutoring_health[i]
                    for i in sorted(self._tutoring_health)
                    if i in self._tutoring]

    def tutoring_health_port(self, idx: int) -> int:
        with self._lock:
            return int(self._tutoring_health[idx].rsplit(":", 1)[1])

    def tutoring_admin_post(self, idx: int, path: str, body: Dict) -> Dict:
        """POST to one tutoring node's admin plane (e.g. /admin/drain)."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.tutoring_health_port(idx)}{path}",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            return self._http(req, timeout=30.0)
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise RuntimeError(
                f"tutoring admin POST {path} on node {idx} -> "
                f"{e.code}: {detail}"
            ) from e

    def tutoring_healthz(self, idx: int) -> Dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.tutoring_health_port(idx)}/healthz",
            method="GET",
        )
        return self._http(req)

    def spawn_tutoring_node(self) -> tuple:
        """Boot one more (echo) tutoring node for the autoscale drill;
        returns (idx, address, health_address). The LMS routers learn it
        via POST /admin/tutoring."""
        with self._lock:
            idx = (max(self._tutoring_addrs) + 1 if self._tutoring_addrs
                   else 0)
        self._run(self._boot_tutoring_node(idx, force_echo=True),
                  timeout=60.0)
        with self._lock:
            return idx, self._tutoring_addrs[idx], self._tutoring_health[idx]

    def stop_tutoring_node(self, idx: int) -> None:
        self._run(self._stop_tutoring_node(idx), timeout=30.0)

    def tutoring_node_metrics(self, idx: int) -> Dict:
        with self._lock:
            rec = self._tutoring.get(idx)
        return rec["metrics"].snapshot() if rec else {}

    def tutoring_metrics_snapshot(self) -> Dict:
        """The tutoring FLEET's serving Metrics, merged (counters
        summed, gauges maxed, histograms by worst p95) — the shape the
        SLO verdict and the telemetry "tutoring" source read. {} before
        boot/after teardown. Snapshot() is thread-safe."""
        with self._lock:
            recs = list(self._tutoring.values())
        snaps = [rec["metrics"].snapshot() for rec in recs]
        if not snaps:
            return {}
        if len(snaps) == 1:
            return snaps[0]
        merged: Dict = {"counters": {}, "gauges": {}, "latency": {}}
        for snap in snaps:
            for name, val in snap.get("counters", {}).items():
                merged["counters"][name] = (
                    merged["counters"].get(name, 0) + int(val)
                )
            for name, val in snap.get("gauges", {}).items():
                merged["gauges"][name] = max(
                    merged["gauges"].get(name, float("-inf")), float(val)
                )
            for name, block in snap.get("latency", {}).items():
                worst = merged["latency"].get(name)
                if worst is None or float(block.get("p95_s", 0.0)) > float(
                    worst.get("p95_s", 0.0)
                ):
                    merged["latency"][name] = dict(block)
        # Percentiles come from the worst node, but `count` must be the
        # fleet SUM: a per-node count would jump whenever the worst node
        # flips, and Timeline.append would misread the jumps as counter
        # resets — phantom observations in hist_rate/dcount (the same
        # rule utils/scrape.py applies to its cluster merge).
        for name, block in merged["latency"].items():
            block["count"] = float(sum(
                float(s.get("latency", {}).get(name, {}).get("count", 0))
                for s in snaps
            ))
        return merged

    def scrape_all(self) -> tuple:
        """({nid: /metrics}, {nid: /healthz}) for every live node."""
        metrics, health = {}, {}
        for nid in self.node_ids():
            try:
                metrics[nid] = self.metrics_snapshot(nid)
                health[nid] = self.healthz(nid)
            except (urllib.error.URLError, OSError) as e:
                raise RuntimeError(
                    f"node {nid} unreachable during final scrape: {e}"
                ) from e
        return metrics, health

    # --------------------------------------------------------------- waits

    def wait_leader(self, timeout: float,
                    exclude: Optional[int] = None) -> Optional[int]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for nid in self.node_ids():
                if nid == exclude:
                    continue
                try:
                    h = self.healthz(nid)
                except (urllib.error.URLError, OSError):
                    continue
                if h.get("role") == "leader" and not h.get(
                    "storage_recovering"
                ):
                    return nid
            time.sleep(0.05)
        return None

    def wait_healthy(self, nid: int, timeout: float) -> Dict:
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                h = self.healthz(nid)
                if h.get("ok"):
                    return h
            except (urllib.error.URLError, OSError) as e:
                last = e
            time.sleep(0.05)
        raise TimeoutError(f"node {nid} not healthy in {timeout}s ({last})")

    def wait_until(self, nid: int, pred: Callable[[Dict], bool],
                   timeout: float, what: str) -> Dict:
        deadline = time.monotonic() + timeout
        h: Dict = {}
        while time.monotonic() < deadline:
            try:
                h = self.healthz(nid)
                if pred(h):
                    return h
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"node {nid}: timed out waiting for {what} "
                           f"(last healthz: {h})")

    # ------------------------------------------------------------ coroutines

    async def _boot_tutoring_node(self, idx: int,
                                  force_echo: bool = False) -> None:
        """One tutoring fleet member: real gRPC server + the SAME
        healthz/drain admin plane the production entrypoint serves
        (make_tutoring_health/make_tutoring_admin). Node 0 runs the
        configured engine (or the factory's); extra members (and
        autoscale spawns) run the echo stand-in so a 3-node fleet builds
        no extra model."""
        from ..engine import BatchingQueue, PagedEngine, PagedQueue
        from ..engine.scoring import ScoringManager

        queue = None
        metrics = Metrics()
        scorer = None
        engine: Any = None
        warm = True
        if idx == 0 and not force_echo:
            if self._engine_factory is not None:
                # The factory hands over a warmed engine (it runs here,
                # before any Raft node boots, like the warmup below).
                engine = self._engine_factory()
            elif self.cfg.tutoring_engine in ("tiny", "tiny-paged"):
                engine, warm = self._tiny_engine(), False
        if engine is None:
            engine = EchoEngine()
        elif isinstance(engine, PagedEngine):
            if self.cfg.bulk_scoring:
                scorer = ScoringManager(engine, metrics=metrics,
                                        max_job_texts=1024,
                                        jobs_retained=8)
            queue = PagedQueue(engine, metrics=metrics, max_queue=64,
                               scorer=scorer)
        if not warm:
            # Build the kernels, run every width (and, on the card,
            # capture the graphs) now, while this loop runs nothing else:
            # tutoring boots BEFORE the Raft nodes, so the warmup can't
            # stall their tick loops (every node shares this loop+GIL).
            if queue is not None:
                engine.warmup()
            else:
                engine.warmup(batch=4)
        if self.cfg.bulk_scoring and scorer is None:
            # Every fleet member runs the background scoring tenant: the
            # bulk-grading night lands on whichever node the LMS router's
            # background route picks (the coldest one).
            scorer = ScoringManager(engine, metrics=metrics,
                                    max_job_texts=1024, jobs_retained=8)
        if queue is None:
            queue = BatchingQueue(engine, max_batch=4, max_wait_ms=5.0,
                                  metrics=metrics, max_queue=64,
                                  scorer=scorer)
        await queue.start()
        server = grpc.aio.server()
        service = TutoringService(queue, metrics, node_id=f"tut{idx}",
                                  session_ttl_s=self.cfg.session_ttl_s,
                                  session_max=64)
        rpc.add_TutoringServicer_to_server(service, server)
        with self._lock:
            want = self._tutoring_addrs.get(idx)
        if want is not None:
            port = server.add_insecure_port(want)
        else:
            port = server.add_insecure_port("127.0.0.1:0")
        await server.start()

        async def tutoring_admin_get(path: str,
                                     _scorer=scorer) -> Dict:
            # GET /admin/score[/<job-id>]: the scoring tenant's job list
            # / one job's progress+results — the same read surface the
            # production entrypoint serves.
            from ..engine.scoring import score_admin_get

            return score_admin_get(path, _scorer)

        health = HealthServer(
            metrics,
            health=make_tutoring_health(service, queue,
                                        type(engine).__name__, 64,
                                        scorer=scorer),
            admin=make_tutoring_admin(service, scorer=scorer),
            admin_get=tutoring_admin_get,
            port=(self.tutoring_health_port(idx) if want is not None
                  else 0),
        )
        hport = await health.start()
        with self._lock:
            self._tutoring[idx] = {
                "server": server, "queue": queue, "metrics": metrics,
                "service": service, "health": health,
            }
            self._tutoring_addrs[idx] = f"127.0.0.1:{port}"
            self._tutoring_health[idx] = f"127.0.0.1:{hport}"

    def _tiny_engine(self):
        """`[sim] tutoring_engine` "tiny" or "tiny-paged": the port's
        bucketed `TutoringEngine` or paged `PagedEngine` on the tiny
        preset in float32, on this cluster's device."""
        import dataclasses as _dc

        import torch

        from ..engine import (
            EngineConfig,
            PagedEngine,
            SamplingParams,
            TutoringEngine,
        )

        config = EngineConfig(
            model="tiny",
            sampling=SamplingParams(max_new_tokens=8),
            length_buckets=(32,), batch_buckets=(1, 2, 4),
            dtype=torch.float32,
            # Bulk-grading night runs against the REAL score path:
            # warmup covers the score domain so the mid-run job builds
            # nothing live.
            scoring=self.cfg.bulk_scoring,
            device=self.device,
        )
        if self.cfg.tutoring_engine == "tiny":
            return TutoringEngine(config)
        # The real serving configuration scaled down: paged continuous
        # batching with the shared-prefix radix cache, so a concentrated
        # same-course workload (`course_concentration` > 0) produces a
        # measurable prefix_cache_hit_rate in the soak's verdict. Two
        # prompt buckets + 8-token blocks: the tiny position table caps
        # prompts at 32 tokens, and a partial prefill needs a suffix
        # bucket that leaves at least one whole block of prefix in the
        # window. NOTE the 32-token cap also tail-truncates the long
        # course context, so at this scale hits come from students
        # repeating the same course question verbatim — real
        # lookup/splice/partial-prefill traffic, but not cross-question
        # context sharing.
        return PagedEngine(
            _dc.replace(config, length_buckets=(16, 32)),
            slots=4, chunk=4, prefix_cache=True,
            prefix_cache_blocks=128, prefix_block_tokens=8,
            # Fused stall-free admission, like cluster.toml: the soak
            # exercises staged chunked prefill under real diurnal churn
            # (decode_stalled_tokens stays 0).
            prefill_chunk_tokens=8,
        )

    async def _stop_tutoring_node(self, idx: int) -> None:
        with self._lock:
            rec = self._tutoring.pop(idx, None)
        if rec is None:
            return
        await rec["health"].stop()
        await rec["server"].stop(None)
        await rec["queue"].close()

    async def _boot_node(self, nid: int) -> None:
        cfg = self.cfg
        with self._lock:
            addresses = dict(self._addresses)
            port = self._ports[nid]
        faults = FaultInjector(seed=cfg.seed * 1000 + nid)
        disk_faults = DiskFaultInjector(seed=cfg.seed * 1000 + nid)
        metrics = Metrics()
        lms_node = LMSNode(
            nid, addresses, f"{self.workdir}/node{nid}",
            raft_config=SIM_RAFT, snapshot_every=SIM_SNAPSHOT_EVERY,
            fault_injector=faults, disk_fault_injector=disk_faults,
            metrics=metrics,
        )
        # Sharded control plane: group 0 IS the base node (meta group +
        # byte-compatible data group); gids >= 1 are extra Raft groups on
        # this node with their own ports/WALs. They share the node's blob
        # store and fault injector — their chaos namespace is `raft:<gid>`
        # so a campaign can sever ONE group's quorum links while the
        # others keep serving.
        groups: Dict[int, LMSNode] = {0: lms_node}
        if cfg.lms_groups > 1:
            with self._lock:
                group_addrs = {
                    gid: self._group_addrs_locked(gid)
                    for gid in range(1, cfg.lms_groups)
                }
            for gid in range(1, cfg.lms_groups):
                groups[gid] = LMSNode(
                    nid, group_addrs[gid],
                    f"{self.workdir}/node{nid}/group{gid}",
                    raft_config=SIM_RAFT,
                    snapshot_every=SIM_SNAPSHOT_EVERY,
                    fault_injector=faults,
                    disk_fault_injector=disk_faults,
                    metrics=metrics,
                    blobs=lms_node.blobs,
                    blob_addresses=lms_node.addresses,
                    fault_prefix=f"raft:{gid}",
                )
        # The tutoring routing tier, fleet-sized to [sim] tutoring_nodes:
        # sim-scale spill/hedge/warm-up knobs so the drills resolve
        # inside a seconds-long run (hedge after 100 ms, 1 s warm-up,
        # 200 ms health polls driving drain ejection/rejoin).
        pool = TutoringPool(
            self.tutoring_addresses(),
            metrics=metrics,
            health_addresses=self.tutoring_health_addresses(),
            fault_injector=faults,
            breaker_failure_threshold=3,
            breaker_recovery_s=0.5,
            timeout_s=min(30.0, cfg.llm_budget_s),
            deadline_floor_s=0.25,
            hedge_after_s=0.1,
            stream_stall_s=1.0,
            queue_spill_depth=16,
            warmup_s=1.0,
            health_poll_s=0.2,
        )
        def _servicer(gnode: LMSNode) -> LMSServicer:
            return LMSServicer(
                gnode.node, gnode.state, lms_node.blobs,
                gate=KeywordGate(),
                metrics=metrics,
                peer_addresses=lms_node.addresses,
                self_id=nid,
                fault_injector=faults,
                tutoring_timeout_s=min(30.0, cfg.llm_budget_s),
                deadline_floor_s=0.25,
                tutoring_pool=pool,
            )

        servicer = _servicer(lms_node)
        server = grpc.aio.server(
            options=[("grpc.max_receive_message_length", 50 * 1024 * 1024)]
        )
        router: Optional[RoutedLMSServicer] = None
        if cfg.lms_groups > 1:
            inner = {gid: (servicer if gid == 0 else _servicer(gnode))
                     for gid, gnode in groups.items()}
            router = RoutedLMSServicer(
                groups, inner, lms_node.addresses, nid,
                course_of=self._wgen.course_of,
                initial_map=self._initial_map,
                metrics=metrics,
                router_secret=self._router_secret,
            )
            rpc.add_LMSServicer_to_server(router, server)
        else:
            rpc.add_LMSServicer_to_server(servicer, server)
        rpc.add_RaftServiceServicer_to_server(
            # Live map: membership-added peers must be reported by
            # GetLeader (client leader-hint re-discovery depends on it).
            RaftServicer(lms_node.node, lms_node.addresses,
                         kv=lms_node.state.data["kv"]),
            server,
        )
        rpc.add_FileTransferServiceServicer_to_server(
            FileTransferServicer(lms_node.blobs), server
        )
        bound = server.add_insecure_port(f"127.0.0.1:{port}")
        if bound != port:
            raise RuntimeError(f"node {nid}: wanted port {port}, got {bound}")
        await server.start()
        # Per-group Raft wire: one small gRPC server per extra group (the
        # proto carries no group id, so each group needs its own port).
        # Servers come up before any group node starts campaigning.
        group_servers: Dict[int, grpc.aio.Server] = {}
        for gid, gnode in sorted(groups.items()):
            if gid == 0:
                continue
            gserver = grpc.aio.server()
            rpc.add_RaftServiceServicer_to_server(
                RaftServicer(gnode.node, gnode.addresses,
                             kv=gnode.state.data["kv"]),
                gserver,
            )
            with self._lock:
                gport = self._group_ports[(gid, nid)]
            gbound = gserver.add_insecure_port(f"127.0.0.1:{gport}")
            if gbound != gport:
                raise RuntimeError(
                    f"node {nid} group {gid}: wanted port {gport}, "
                    f"got {gbound}"
                )
            await gserver.start()
            group_servers[gid] = gserver
        await lms_node.start()
        for gid in sorted(group_servers):
            await groups[gid].start()
        campaigns = CampaignRunner(faults, disk_faults, metrics=metrics)
        # Same node-local telemetry timeline the production entrypoint
        # samples, served at GET /admin/timeline per node.
        sampler = TimelineSampler(metrics, interval_s=0.5,
                                  max_points=256).start()
        # The router's drain-aware health poller, like the production
        # entrypoint starts.
        pool.start()
        coordinator = None
        if cfg.lms_groups > 1:
            # Cluster-level coordinator: proposals land on each group's
            # CURRENT leader (in-process — the sim runs every node on
            # this loop), so /admin/reshard works from any node.
            coordinator = ReshardCoordinator(
                ClusterGroupAccess(self),
                course_of=self._wgen.course_of,
                metrics=metrics,
            )
        groups_admin = GroupsAdmin(groups, router=router,
                                   coordinator=coordinator)
        admin, admin_get = make_admin(lms_node, faults, disk_faults,
                                      campaigns,
                                      timeline=sampler.timeline,
                                      pool=pool, groups_admin=groups_admin)
        health = HealthServer(
            metrics,
            health=make_health(nid, lms_node, pool, faults),
            admin=admin, admin_get=admin_get,
            port=self._health_ports[nid],
        )
        await health.start()
        # Same serving-loop heartbeat the production entrypoint runs, so
        # the sim's SLO scrape sees serving_tick_lag/-_stalls per node.
        watchdog = asyncio.get_running_loop().create_task(
            make_serving_watchdog(metrics).run()
        )
        with self._lock:
            self._nodes[nid] = {
                "lms_node": lms_node, "server": server, "health": health,
                "faults": faults, "disk_faults": disk_faults,
                "campaigns": campaigns, "metrics": metrics,
                "pool": pool, "watchdog": watchdog,
                "sampler": sampler,
                "groups": groups, "group_servers": group_servers,
                "router": router,
            }

    async def _stop_node(self, nid: int) -> None:
        with self._lock:
            rec = self._nodes.pop(nid, None)
        if rec is None:
            return
        rec["campaigns"].cancel()
        rec["watchdog"].cancel()
        rec["sampler"].stop()
        await rec["pool"].close()
        await rec["health"].stop()
        if rec.get("router") is not None:
            await rec["router"].close()
        for gid in sorted(rec.get("groups", {}), reverse=True):
            if gid != 0:
                await rec["groups"][gid].stop()
        await rec["lms_node"].stop()
        await rec["server"].stop(None)
        for _gid, gserver in sorted(rec.get("group_servers", {}).items()):
            await gserver.stop(None)


class ClusterGroupAccess:
    """`GroupAccess` over the live cluster: the reshard coordinator's
    proposals chase each group's CURRENT leader replica through
    elections (every sim node shares one loop, so the leader's LMSNode
    is directly reachable in-process — the same way a production
    coordinator would follow NotLeader redirects over the wire)."""

    def __init__(self, cluster: SimCluster) -> None:
        self._cluster = cluster

    def n_groups(self) -> int:
        return self._cluster.group_count()

    def _records(self) -> List[Dict]:
        with self._cluster._lock:
            return list(self._cluster._nodes.values())

    def _leader_node(self, gid: int) -> Optional[LMSNode]:
        for rec in self._records():
            gnode = rec.get("groups", {}).get(gid)
            if (gnode is not None and gnode.node.is_leader
                    and not gnode.recovering):
                return gnode
        return None

    async def _leader(self, gid: int, timeout: float = 15.0) -> LMSNode:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gnode = self._leader_node(gid)
            if gnode is not None:
                return gnode
            await asyncio.sleep(0.05)
        raise TimeoutError(f"group {gid}: no leader within {timeout}s")

    def users(self) -> List[str]:
        # Auth is replicated to every group (router fan-out), so any
        # replica's user table is a superset view; union to be safe
        # against a lagging follower.
        names: set = set()
        for rec in self._records():
            for gnode in rec.get("groups", {}).values():
                names.update(gnode.state.data["users"].keys())
        return sorted(names)

    def state(self, gid: int):
        gnode = self._leader_node(gid)
        if gnode is None:
            raise RuntimeError(f"group {gid}: no leader replica to read")
        return gnode.state

    def current_map(self) -> RoutingMap:
        gnode = self._leader_node(0)
        if gnode is None:
            for rec in self._records():
                gnode = rec.get("groups", {}).get(0)
                if gnode is not None:
                    break
        raw = (gnode.state.data["kv"].get(ROUTING_MAP_KEY)
               if gnode is not None else None)
        if raw:
            return RoutingMap.from_json(raw)
        return self._cluster._initial_map

    async def read_fence(self, gid: int) -> None:
        gnode = await self._leader(gid)
        await gnode.node.read_barrier()

    async def propose(self, gid: int, op: str, args: Dict) -> None:
        deadline = time.monotonic() + 30.0
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            gnode = await self._leader(gid)
            try:
                await gnode.node.propose(encode_command(op, args))
                return
            except (NotLeader, TimeoutError, asyncio.TimeoutError) as e:
                # Mid-handoff leader churn (the drills induce it on
                # purpose): re-resolve and re-propose. Deterministic
                # request_ids make the replay idempotent.
                last = e
                await asyncio.sleep(0.05)
        raise TimeoutError(f"group {gid}: {op} not committed ({last})")

    async def meta_get(self, key: str) -> Optional[str]:
        gnode = await self._leader(0)
        await gnode.node.read_barrier()
        val = gnode.state.data["kv"].get(key)
        return None if val is None else str(val)

    async def meta_set(self, key: str, value: str) -> None:
        await self.propose(0, "SetVal", {"key": key, "value": value})
