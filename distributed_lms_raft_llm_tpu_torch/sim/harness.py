"""`SemesterSim`: workload + operations schedule + auditors, end to end.

One `run()` = one semester compressed into `duration_s` wall seconds:

1. boot the in-process cluster (`SimCluster`);
2. setup — register/login every actor, seed one material per course and
   one assignment per student (ask_llm requires one);
3. drive the seeded workload trace from `workers` client threads while
   the operations scheduler injects the event plan (chaos campaigns,
   TimeoutNow rolling restart, disk-fault quarantine, membership change)
   through the real admin plane;
4. settle — clear all faults, re-close every breaker by draining
   leadership to any node whose breaker is still open (the operator's
   decommission dance, automated), wait out storage recovery;
5. audit — a fresh client re-reads the world and the ledger proves zero
   acked-write loss; SLOs are evaluated from every node's `/metrics` and
   `/healthz`;
6. emit one BENCH-schema record (`python -m
   distributed_lms_raft_llm_tpu_torch.sim` prints it).

The trace and the event plan are pure functions of the seed; the record
carries their digests so a failure is replayable bit-for-bit at the
decision level.

The port's copy of `distributed_lms_raft_llm_tpu/sim/harness.py`, its
logic as it is; `device` and `tutoring_engine_factory` pass through to
`SimCluster`.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import grpc

from ..client import LMSClient
from ..client.client import NoLeader
from ..config import SimConfig
from ..utils import locks
from ..utils import metrics_registry as metric
from ..utils import pdf
from ..utils.metrics import Metrics
from ..utils.resilience import DeadlineExpired
from ..utils.scrape import ClusterScraper, SourceFn, http_source
from ..utils.timeline import snap_counter, snap_hist
from ..utils.tracing import get_tracer
from . import events as ev
from . import workload as wl
from .cluster import SimCluster
from .slo import ContinuousSloEngine
from .ledger import (
    ASSIGNMENT,
    GRADE,
    MATERIAL,
    QUERY,
    USER,
    WriteLedger,
    content_hash,
)
from .slo import evaluate_slos

log = logging.getLogger(__name__)

class SimOpFailed(Exception):
    """A simulated op the cluster refused at the application level."""


_CLIENT_ERRORS = (grpc.RpcError, NoLeader, DeadlineExpired, TimeoutError,
                  SimOpFailed)


class _TelemetryLoop:
    """The sim's in-run telemetry plane: one thread polls every node's
    `/metrics` (plus the harness's own client-side Metrics and the
    in-process tutoring queue) through the REAL scrape aggregator into a
    merged cluster timeline, and runs the continuous SLO engine's
    burn-rate evaluation on each tick. Starts at workload t0, stops
    before settle — the settle phase's deliberate degraded probes must
    not read as alerts."""

    def __init__(self, sim: "SemesterSim", t0: float):
        self.sim = sim
        self.t0 = t0
        cluster = sim.cluster

        def sources() -> Dict[str, SourceFn]:
            # Re-resolved every poll: membership events change the node
            # set mid-run; a restarting node is simply unreachable for a
            # round.
            out: Dict[str, SourceFn] = {
                f"node{nid}": http_source(
                    f"http://127.0.0.1:{cluster.health_port(nid)}/metrics"
                )
                for nid in cluster.node_ids()
            }
            # "tutoring" is the merged fleet view (counters summed
            # across members — the capacity fit and degraded-rate burn
            # read it). Per-node fleet attribution lives in the BENCH
            # record's tutoring_fleet block, NOT as extra scrape
            # sources: feeding both the merged view and per-node views
            # into one ClusterScraper would double-count every tutoring
            # counter in the cluster timeline.
            out["tutoring"] = cluster.tutoring_metrics_snapshot
            out["sim"] = sim.metrics.snapshot
            return out

        self.scraper = ClusterScraper(sources_fn=sources)
        self.engine = ContinuousSloEngine(
            sim.cfg, self.scraper.cluster, sim.metrics,
            metrics=sim.metrics,
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="sim-telemetry", daemon=True
        )

    def start(self) -> "_TelemetryLoop":
        # Baseline poll BEFORE evaluations begin: the first sight of a
        # source seeds its counter baselines (boot-era counts must not
        # read as a rate spike in the first window).
        self.scraper.poll()
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("telemetry loop did not stop")

    def _run(self) -> None:
        while not self._stop.wait(self.sim.cfg.telemetry_sample_s):
            try:
                self.scraper.poll()
                self.engine.evaluate(time.monotonic() - self.t0)
            except Exception:
                # Telemetry must never kill the run it observes.
                log.exception("telemetry poll failed")


def _password(actor: str) -> str:
    return f"pw-{actor}"


def _is_degraded(resp) -> bool:
    # Match the degraded-answer sentinel exactly: a gate rejection also
    # mentions the instructor but queues NOTHING — counting it would
    # record a ledger write the cluster never committed, and the audit
    # would report a spurious acked-write loss.
    return bool(resp.success) and "forwarded to an instructor" in resp.response


class SemesterSim:
    def __init__(self, cfg: SimConfig, workdir: str, *,
                 device: str = "cuda",
                 tutoring_engine_factory: Optional[Callable[[], Any]] = None):
        self.cfg = cfg
        self.workdir = workdir
        self.metrics = Metrics()
        self.ledger = WriteLedger(metrics=self.metrics)
        self.cluster = SimCluster(
            workdir, cfg, device=device,
            tutoring_engine_factory=tutoring_engine_factory)
        self.gen = wl.WorkloadGenerator(cfg)
        self._clients: Dict[str, LMSClient] = {}
        self._ops_bot: Optional[LMSClient] = None
        self._bot_lock = threading.Lock()
        self._bot_seq = 0

    # ------------------------------------------------------------------ run

    def run(self) -> Dict:
        t_start = time.monotonic()
        ops = self.gen.ops()
        plan = ev.plan_events(self.cfg)
        # Fresh flight recorder per run: the process-global tracer may
        # hold a previous run's traces (back-to-back sims in one test
        # process), which would pollute the per-stage p95s and could pin
        # a stale trace as this run's slowest exemplar.
        get_tracer().reset()
        # Live lock-order auditing across the whole run: every
        # OrderedLock acquisition in the in-process cluster lands in the
        # global acquisition graph; violations surface both through the
        # lock_order_violations counter and locks.violations(), and the
        # recorded graph stays readable after the run for the
        # static/dynamic cross-validation test.
        locks.reset()
        locks.set_metrics_sink(self.metrics)
        locks.enable_recording()
        try:
            # Inside the try: a partial boot (no leader within the
            # timeout, a stolen port) must still tear the cluster down,
            # or its loop thread and gRPC servers outlive the run.
            self.cluster.start()
            self._setup()
            scheduler = ev.OperationsScheduler(
                self.cluster, plan, metrics=self.metrics,
                writer=self._bot_write, asker=self._bot_ask,
                streamer=self._bot_stream, ledger=self.ledger,
            )
            t0 = time.monotonic()
            telemetry: Optional[_TelemetryLoop] = None
            if self.cfg.continuous_slos:
                telemetry = _TelemetryLoop(self, t0).start()
            threads = self._start_workers(ops, t0)
            scheduler.start(t0)
            margin = 30.0 + self.cfg.llm_budget_s
            for t in threads:
                t.join(self.cfg.duration_s + margin)
                if t.is_alive():
                    raise TimeoutError(f"sim worker {t.name} wedged")
            scheduler.join(self.cfg.duration_s + margin)
            if telemetry is not None:
                # Stop BEFORE settle: the settle phase's deliberate
                # degraded probes are post-scenario housekeeping, not
                # SLO evidence.
                telemetry.stop()
                telemetry.engine.finish(scheduler.event_windows())
            self._settle()
            self._audit()
            # After the audit (its logins are themselves replicated
            # writes): wait for every group's replicas to drain to one
            # applied index and compare their state-digest chains.
            self.ledger.note_replica_digests(
                self._collect_replica_digests()
            )
            node_metrics, node_health = self.cluster.scrape_all()
            traces = get_tracer().records()
            fleet = self._fleet_summary(node_metrics, node_health)
            scoring = self._scoring_summary()
            groups = self._groups_summary()
            report = evaluate_slos(
                self.cfg, node_metrics, node_health,
                self.metrics.snapshot(), self.ledger.report(),
                event_failures=scheduler.failures(),
                traces=traces,
                tutoring_metrics=self.cluster.tutoring_metrics_snapshot(),
                metrics=self.metrics,
                continuous=(telemetry.engine.report()
                            if telemetry is not None else None),
                fleet=fleet,
                scoring=scoring,
                groups=groups,
            )
            return self._record(ops, plan, scheduler, report, node_metrics,
                                traces, time.monotonic() - t_start,
                                telemetry=telemetry, fleet=fleet,
                                scoring=scoring, groups=groups)
        finally:
            for c in self._clients.values():
                c.close()
            if self._ops_bot is not None:
                self._ops_bot.close()
            self.cluster.stop()
            locks.disable_recording()
            locks.set_metrics_sink(None)

    # ---------------------------------------------------------------- setup

    def _new_client(self, actor: str,
                    request_timeout_s: float = 15.0) -> LMSClient:
        return LMSClient(
            self.cluster.client_servers(),
            # Sharded runs: clients key their leader-hint cache by Raft
            # group (the static lane from the initial map), so evicting
            # one group's distrusted hint leaves the others' warm.
            group_of=(self.cluster.group_of
                      if self.cfg.lms_groups > 1 else None),
            discovery_rounds=8, discovery_backoff_s=0.2,
            rpc_retries=6, rpc_timeout=5.0,
            request_timeout_s=request_timeout_s,
            llm_timeout_s=self.cfg.llm_budget_s,
            backoff_base_s=0.02, backoff_max_s=0.3,
            # Stable hash, NOT builtin hash(): PYTHONHASHSEED randomizes
            # the latter per process, which would give every replay a
            # different backoff-jitter stream and break the
            # replay-from-seed contract.
            seed=int(hashlib.sha1(
                f"{self.cfg.seed}:{actor}".encode()
            ).hexdigest(), 16) & 0xFFFF,
        )

    def _setup(self) -> None:
        """Accounts + seed content, before the clock starts. Setup runs
        fault-free, so failures here are raised, not tolerated."""
        actors: List[Tuple[str, str]] = (
            [(s, "student") for s in self.gen.students]
            + [(i, "instructor") for i in self.gen.instructors]
        )

        errors: List[str] = []

        def boot_actor(actor: str, role: str) -> None:
            # Setup runs fault-free but NOT contention-free: at soak
            # scale, dozens of concurrent account boots can push an
            # attempt past its budget — retry the whole actor rather
            # than fail the run before the scenario even starts.
            last: Optional[Exception] = None
            for _ in range(3):
                try:
                    c = self._clients.get(actor) or self._new_client(
                        actor, request_timeout_s=30.0
                    )
                    self._clients[actor] = c
                    c.register(actor, _password(actor), role)
                    if not c.login(actor, _password(actor)):
                        raise RuntimeError(
                            f"setup: login failed for {actor}"
                        )
                    # Login success proves the account committed
                    # (register alone can report 'exists' on a
                    # retried-but-committed proposal).
                    self.ledger.record(USER, (actor,), role)
                    if role == "student":
                        filename = f"{actor}_hw.pdf"
                        data = pdf.make_pdf(
                            f"{wl.ASSIGNMENT_TEXT} (initial submission "
                            f"by {actor})"
                        )
                        if not c.upload_assignment(filename, data):
                            raise RuntimeError(
                                f"setup: upload failed for {actor}"
                            )
                        self.ledger.record(ASSIGNMENT, (actor, filename),
                                           content_hash(data))
                    return
                except Exception as e:
                    last = e
                    time.sleep(0.5)
            errors.append(f"{actor}: {last}")

        def reap(t: threading.Thread) -> None:
            t.join(60.0)
            if t.is_alive():
                # An abandoned boot thread would race the workload phase
                # on its (shared, single-threaded-by-design) client —
                # fail setup loudly instead.
                errors.append(f"{t.name}: still running after 60s join")

        threads = [threading.Thread(target=boot_actor, args=a,
                                    name=f"setup-{a[0]}", daemon=True)
                   for a in actors]
        alive: List[threading.Thread] = []
        for t in threads:
            t.start()
            alive.append(t)
            if len(alive) >= self.cfg.workers:
                reap(alive.pop(0))
        for t in alive:
            reap(t)
        if errors:
            raise RuntimeError(f"setup failed: {errors}")
        # One seed material per course so downloads never start empty.
        instructor = self.gen.instructors[0]
        for course in self.gen.courses:
            filename = f"{course}_syllabus.pdf"
            data = pdf.make_pdf(f"{course} syllabus: {wl.ASSIGNMENT_TEXT}")
            if not self._clients[instructor].upload_course_material(
                filename, data
            ):
                raise RuntimeError(f"setup: material failed for {course}")
            self.ledger.record(MATERIAL, (filename,), content_hash(data))
        # The scheduler's ops bot: guaranteed-traffic writer + degraded
        #-path prober (a student, so it can ask_llm).
        bot = self._new_client("ops_bot")
        bot.register("ops_bot", _password("ops_bot"), "student")
        if not bot.login("ops_bot", _password("ops_bot")):
            raise RuntimeError("setup: ops bot login failed")
        self.ledger.record(USER, ("ops_bot",), "student")
        data = pdf.make_pdf("ops bot assignment")
        if not bot.upload_assignment("ops_bot_hw.pdf", data):
            raise RuntimeError("setup: ops bot upload failed")
        self.ledger.record(ASSIGNMENT, ("ops_bot", "ops_bot_hw.pdf"),
                           content_hash(data))
        self._ops_bot = bot

    # ----------------------------------------------------------- scheduler IO

    def _group_tag(self, actor: str):
        """The actor's owning Raft group per the LIVE routing map (None
        in single-group runs): stamped on every acked write so the
        audit can name the writes that crossed a resharding boundary."""
        if self.cfg.lms_groups <= 1:
            return None
        return self.cluster.live_group_of(actor)

    def _bot_write(self) -> bool:
        """One guaranteed acked write (the quarantine event's record
        source); ledger-tracked like any student write."""
        with self._bot_lock:
            self._bot_seq += 1
            seq = self._bot_seq
        query = f"ops bot write #{seq:04d}"
        try:
            if self._ops_bot.ask_instructor(query):
                self.ledger.record(QUERY, ("ops_bot",), query,
                                   group=self._group_tag("ops_bot"))
                return True
        except _CLIENT_ERRORS as e:
            log.info("ops bot write failed: %s", e)
        return False

    def _bot_ask(self) -> bool:
        """One ask_llm probe (the fleet drills resolve THIS query's
        affinity node and fault it, so the probe's hedge/spill is
        guaranteed to exercise the router); True if answered degraded."""
        try:
            resp = self._ops_bot.ask_llm(ev.PROBE_QUERY, budget_s=4.0)
        except _CLIENT_ERRORS as e:
            log.info("ops bot ask failed: %s", e)
            return False
        if _is_degraded(resp):
            self.metrics.inc(metric.SIM_DEGRADED_ANSWERS)
            self.ledger.record(QUERY, ("ops_bot",), ev.PROBE_QUERY,
                               group=self._group_tag("ops_bot"))
            return True
        return False

    def _bot_stream(self, session_id: str = ev.STREAM_SESSION_ID) -> bool:
        """One STREAMED ask_llm probe riding a fixed session id (the
        stream-kill drill faults this session's affinity node mid-answer,
        so the probe's resume-at-offset failover is guaranteed to
        exercise the router); True if the stream completed with its
        digest intact."""
        try:
            ans = self._ops_bot.ask_llm_stream(
                ev.PROBE_QUERY, session_id=session_id,
                budget_s=4.0,
            )
        except _CLIENT_ERRORS as e:
            log.info("ops bot stream failed: %s", e)
            return False
        if ans.resumes:
            self.metrics.inc(metric.SIM_STREAM_RESUMES, ans.resumes)
        if ans.digest_ok is False:
            self.metrics.inc(metric.SIM_STREAM_DIGEST_MISMATCH)
            return False
        if _is_degraded(ans):
            self.metrics.inc(metric.SIM_DEGRADED_ANSWERS)
            self.ledger.record(QUERY, ("ops_bot",), ev.PROBE_QUERY,
                               group=self._group_tag("ops_bot"))
            return False
        return bool(ans.success)

    # -------------------------------------------------------------- workload

    def _start_workers(self, ops: List[wl.SimOp],
                       t0: float) -> List[threading.Thread]:
        # Partition by actor so each client (one token, one channel set)
        # stays single-threaded; ops per actor run in trace order.
        buckets: List[List[wl.SimOp]] = [[] for _ in range(self.cfg.workers)]
        actor_ids = {a: i for i, a in enumerate(
            self.gen.students + self.gen.instructors
        )}
        for op in ops:
            buckets[actor_ids[op.actor] % self.cfg.workers].append(op)
        threads = []
        for w, bucket in enumerate(buckets):
            t = threading.Thread(
                target=self._worker, args=(bucket, t0),
                name=f"sim-worker-{w}", daemon=True,
            )
            t.start()
            threads.append(t)
        return threads

    def _worker(self, bucket: List[wl.SimOp], t0: float) -> None:
        # Closed-loop overload shedding: a worker that falls further
        # behind the trace than its own op budget sheds the late op
        # instead of building an unbounded backlog (which would wedge the
        # run long past its duration when the engine is the bottleneck).
        late_drop_s = self.cfg.llm_budget_s
        for op in bucket:
            delay = t0 + op.at_s - time.monotonic()
            if delay < -late_drop_s:
                self.metrics.inc(metric.SIM_OPS_DROPPED)
                continue
            if delay > 0:
                time.sleep(delay)
            started = time.monotonic()
            try:
                self._execute(op)
                self.metrics.inc(metric.SIM_OPS_OK)
            except _CLIENT_ERRORS as e:
                # Terminal client failure (budget + retries exhausted):
                # legal under faults — the op was never acked, so the
                # ledger expects nothing from it.
                log.info("sim op %s by %s failed: %s", op.kind, op.actor, e)
                self.metrics.inc(metric.SIM_OPS_FAILED)
            except Exception:
                # A harness bug must not silently kill the worker thread
                # (and every later op in its bucket) — count and carry on.
                log.exception("sim op %s by %s raised unexpectedly",
                              op.kind, op.actor)
                self.metrics.inc(metric.SIM_OPS_FAILED)
            finally:
                self.metrics.hist(metric.SIM_OP_LATENCY).observe(
                    time.monotonic() - started
                )

    def _execute(self, op: wl.SimOp) -> None:
        c = self._clients[op.actor]
        kind, payload = op.kind, op.payload
        if kind == wl.UPLOAD_MATERIAL:
            data = pdf.make_pdf(payload["text"])
            if c.upload_course_material(payload["filename"], data):
                self.ledger.record(MATERIAL, (payload["filename"],),
                                   content_hash(data),
                                   group=self._group_tag(op.actor))
        elif kind == wl.SUBMIT_ASSIGNMENT:
            data = pdf.make_pdf(payload["text"])
            if c.upload_assignment(payload["filename"], data):
                self.ledger.record(ASSIGNMENT, (op.actor,
                                                payload["filename"]),
                                   content_hash(data),
                                   group=self._group_tag(op.actor))
        elif kind == wl.GRADE:
            resp = c.grade(payload["student"], payload["grade"])
            if resp.success:
                self.ledger.record(GRADE, (payload["student"],),
                                   payload["grade"],
                                   group=self._group_tag(
                                       payload["student"]))
        elif kind == wl.ASK_INSTRUCTOR:
            if c.ask_instructor(payload["query"]):
                self.ledger.record(QUERY, (op.actor,), payload["query"],
                                   group=self._group_tag(op.actor))
        elif kind in (wl.ASK_LLM_ON_TOPIC, wl.ASK_LLM_OFF_TOPIC):
            t1 = time.monotonic()
            try:
                resp = c.ask_llm(payload["query"],
                                 budget_s=self.cfg.llm_budget_s)
            finally:
                self.metrics.hist(metric.SIM_ASK_LATENCY).observe(
                    time.monotonic() - t1
                )
            if _is_degraded(resp):
                # The degraded path IS a write: the query went onto the
                # replicated instructor queue — hold the cluster to it.
                self.metrics.inc(metric.SIM_DEGRADED_ANSWERS)
                self.ledger.record(QUERY, (op.actor,), payload["query"],
                                   group=self._group_tag(op.actor))
            elif not resp.success:
                raise SimOpFailed(f"ask_llm refused: {resp.response[:80]}")
        elif kind == wl.ASK_LLM_SESSION_CHAIN:
            self._run_session_chain(c, op)
        elif kind == wl.DOWNLOAD_MATERIAL:
            t1 = time.monotonic()
            entries = c.course_materials()
            self.ledger.check_materials_read(
                t1, {e.filename: bytes(e.file) for e in entries}, op.actor
            )
        elif kind == wl.CHECK_GRADE:
            t1 = time.monotonic()
            shown = c.my_grade()
            self.ledger.check_grade_read(t1, shown, op.actor)
        elif kind == wl.READ_RESPONSES:
            t1 = time.monotonic()
            texts = [e.data for e in c.instructor_responses()]
            self.ledger.check_responses_read(t1, texts, op.actor)
        else:  # pragma: no cover - generator and executor share the enum
            raise ValueError(f"unknown op kind {kind!r}")

    def _run_session_chain(self, c: LMSClient, op: wl.SimOp) -> None:
        """One conversational session, end to end: every turn streams
        over the SAME session id (sticky affinity, transcript splice on
        the serving node), TTFT is recorded per turn, and the final
        chunk's digest check catches any duplicated/dropped token. A
        terminally failed turn abandons the rest of the chain — later
        turns converse against the transcript the failed turn never
        produced."""
        sid = op.payload["session"]
        for turn, query in enumerate(op.payload["queries"].split("\x1f"),
                                     start=1):
            t1 = time.monotonic()
            try:
                ans = c.ask_llm_stream(query, session_id=sid,
                                       budget_s=self.cfg.llm_budget_s)
            except _CLIENT_ERRORS as e:
                log.info("session %s turn %d failed: %s", sid, turn, e)
                self.metrics.inc(metric.SIM_SESSION_TURNS_FAILED)
                return
            finally:
                self.metrics.hist(metric.SIM_ASK_LATENCY).observe(
                    time.monotonic() - t1
                )
            self.metrics.inc(metric.SIM_SESSION_TURNS)
            if ans.ttft_s is not None:
                self.metrics.hist(metric.SIM_TURN_TTFT).observe(ans.ttft_s)
            if ans.resumes:
                self.metrics.inc(metric.SIM_STREAM_RESUMES, ans.resumes)
            if ans.digest_ok is False:
                self.metrics.inc(metric.SIM_STREAM_DIGEST_MISMATCH)
            if _is_degraded(ans):
                # Same contract as the unary path: a degraded answer IS
                # a write onto the replicated instructor queue.
                self.metrics.inc(metric.SIM_DEGRADED_ANSWERS)
                self.ledger.record(QUERY, (op.actor,), query,
                                   group=self._group_tag(op.actor))
            elif not ans.success:
                raise SimOpFailed(
                    f"session turn refused: {ans.response[:80]}"
                )

    # ---------------------------------------------------------------- settle

    def _settle(self) -> None:
        """Back to blue skies: clear every fault, then re-close every
        breaker. A breaker only sees traffic while its node leads, so a
        node that led through the tutoring blackout and then lost
        leadership would hold an open breaker forever; the settle drains
        leadership to each such node and probes until it closes — the
        automated version of an operator's post-incident checklist."""
        for nid in self.cluster.node_ids():
            self.cluster.admin_post(nid, "/admin/faults", {"reset": True})
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            leader = self.cluster.wait_leader(timeout=10.0)
            if leader is None:
                continue
            open_nodes = [
                nid for nid in self.cluster.node_ids()
                if self.cluster.healthz(nid)
                .get("tutoring_breaker", {}).get("state") != "closed"
            ]
            if not open_nodes:
                return
            target = open_nodes[0]
            if target != leader:
                try:
                    self.cluster.admin_post(leader, "/admin/transfer",
                                            {"target": target})
                except RuntimeError as e:
                    log.info("settle transfer to %d failed: %s", target, e)
                    continue
            # recovery_s is 0.5 in the sim cluster: give the breaker its
            # half-open window, then probe until a success closes it.
            time.sleep(0.6)
            try:
                # "ops bot ..." overlaps the bot's assignment text, so the
                # probe passes the relevance gate and reaches tutoring —
                # a gated-out probe could never close the breaker.
                resp = self._ops_bot.ask_llm("ops bot settle probe?",
                                             budget_s=4.0)
                if _is_degraded(resp):
                    self.metrics.inc(metric.SIM_DEGRADED_ANSWERS)
                    self.ledger.record(QUERY, ("ops_bot",),
                                       "ops bot settle probe?")
            except _CLIENT_ERRORS as e:
                log.info("settle probe failed: %s", e)
        raise TimeoutError("settle: breakers never re-closed")

    # ----------------------------------------------------------------- audit

    def _audit(self) -> None:
        """Fresh reads of the final state feed the ledger's loss audit."""
        auditor = self._new_client("auditor")
        try:
            users: Dict[str, str] = {}
            for actor, role in (
                [(s, "student") for s in self.gen.students]
                + [(i, "instructor") for i in self.gen.instructors]
                + [("ops_bot", "student")]
            ):
                try:
                    if auditor.login(actor, _password(actor)):
                        users[actor] = role
                except _CLIENT_ERRORS:
                    pass
            # Materials: any student's view (reads are linearizable).
            student = self.gen.students[0]
            if not auditor.login(student, _password(student)):
                raise RuntimeError("audit: student login failed")
            materials = {e.filename: bytes(e.file)
                         for e in auditor.course_materials()}
            grades: Dict[str, str] = {}
            for s in self.gen.students:
                if auditor.login(s, _password(s)):
                    grades[s] = auditor.my_grade()
            instructor = self.gen.instructors[0]
            if not auditor.login(instructor, _password(instructor)):
                raise RuntimeError("audit: instructor login failed")
            assignments: Dict[str, List[str]] = {}
            for e in auditor.student_assignments():
                assignments.setdefault(e.id, []).append(e.filename)
            queries = [(e.id, e.data)
                       for e in auditor.unanswered_queries()]
            self.ledger.audit(users=users, materials=materials,
                              assignments=assignments, grades=grades,
                              queries=queries)
        finally:
            auditor.close()

    # ---------------------------------------------------------------- record

    def _fleet_summary(self, node_metrics: Dict, node_health: Dict):
        """Tutoring-fleet verdict inputs: router counters summed across
        the LMS nodes (whichever node led during a drill holds them)
        plus the end-state per-node routing map. None for a one-node
        fleet — the checks and record fields only exist when there is a
        fleet to judge."""
        if self.cluster.tutoring_count() <= 1:
            return None

        def total(name: str) -> int:
            return sum(snap_counter(s, name)
                       for s in node_metrics.values())

        nodes = []
        for health in node_health.values():
            fleet = health.get("tutoring_fleet") or {}
            if fleet.get("nodes"):
                nodes = fleet["nodes"]
                break
        return {
            "size": self.cluster.tutoring_count(),
            "drills": self.cfg.events,
            "spills": total(metric.TUTORING_SPILLS),
            "hedges": total(metric.TUTORING_HEDGES),
            "hedge_wins": total(metric.TUTORING_HEDGE_WINS),
            "ejections": total(metric.TUTORING_NODE_EJECTIONS),
            "rejoins": total(metric.TUTORING_NODE_REJOINS),
            # Resumable-stream evidence: router-side resume-at-offset
            # failovers and per-chunk stall trips (the stream-kill drill
            # must leave >= 1 resume behind).
            "stream_resumes": total(metric.STREAM_RESUMES),
            "stream_stalls": total(metric.STREAM_STALLS),
            "nodes": nodes,
        }

    def _collect_replica_digests(self) -> Optional[Dict]:
        """Cross-replica convergence audit at settle (replicas_converged
        SLO): each physical node reports, per Raft group, its replica's
        digest chain (GET /admin/raft -> digest / digest_applied). A
        group converged when every responding replica sits at the SAME
        applied index with the SAME digest — including across a mid-run
        group split, whose InstallSnapshot-restored members must resume
        the source chain, not fork it. Replicas drain asynchronously, so
        poll briefly before judging; unreachable nodes are skipped (a
        node the drill killed proves nothing about determinism)."""
        if self.cfg.lms_groups <= 1:
            return None
        deadline = time.monotonic() + 15.0
        doc: Dict = {"converged": False, "groups": {}}
        while True:
            per_group: Dict[str, Dict[str, Dict]] = {}
            for nid in self.cluster.node_ids():
                try:
                    topo = self.cluster.group_topology(nid)
                except (RuntimeError, OSError):
                    continue
                for gid, row in (topo.get("groups") or {}).items():
                    if "digest" not in row:
                        continue
                    per_group.setdefault(gid, {})[str(nid)] = {
                        "applied": row.get("digest_applied"),
                        "digest": row.get("digest"),
                    }
            converged = bool(per_group)
            for rows in per_group.values():
                if len(rows) < 2:
                    converged = False  # one report compares nothing
                    continue
                if len({r["applied"] for r in rows.values()}) != 1:
                    converged = False  # still draining (or wedged)
                elif len({r["digest"] for r in rows.values()}) != 1:
                    converged = False  # SAME index, DIFFERENT state
            doc = {"converged": converged, "groups": per_group}
            if converged or time.monotonic() > deadline:
                return doc
            time.sleep(0.3)

    def _groups_summary(self) -> Optional[Dict]:
        """Sharded-control-plane verdict inputs: the final routing map
        and per-group topology (GET /admin/raft), per-group leaders from
        the cluster's live records, and the ledger's reshard-boundary
        evidence. None for a single-group run — the checks and record
        fields only exist when there are groups to judge."""
        if self.cfg.lms_groups <= 1:
            return None
        nid = (self.cluster.wait_leader(timeout=10.0)
               or self.cluster.node_ids()[0])
        topo = self.cluster.group_topology(nid)
        leaders = {gid: self.cluster.group_leader(gid)
                   for gid in range(self.cfg.lms_groups)}
        ledger_report = self.ledger.report()
        return {
            "n_groups": self.cfg.lms_groups,
            "routing_map": topo.get("routing_map", {}),
            "topology": topo.get("groups", {}),
            "leaders": leaders,
            # The verdict only DEMANDS a completed handoff when the
            # event schedule actually planned the live split.
            "expected_reshard": bool(self.cfg.events),
            "reshards": ledger_report.get("reshards", []),
            "acked_by_group": ledger_report.get("acked_by_group", {}),
            "acked_across_reshard": ledger_report.get(
                "acked_across_reshard", 0
            ),
            "replica_digests": ledger_report.get("replica_digests"),
        }

    def _scoring_summary(self) -> Optional[Dict]:
        """Background scoring-tenant evidence from the tutoring fleet's
        merged counters: the bulk-grading night's completion claim
        (`bulk_scoring_completed`) and the record's idle-lane-harvest
        block. None when [sim] bulk_scoring is off."""
        if not self.cfg.bulk_scoring:
            return None
        tut = self.cluster.tutoring_metrics_snapshot()
        return {
            # The verdict only DEMANDS a completed job when the event
            # schedule actually ran the bulk-grading night.
            "expected": bool(self.cfg.events),
            "jobs_completed": snap_counter(
                tut, metric.SCORING_JOBS_COMPLETED
            ),
            "jobs_failed": snap_counter(tut, metric.SCORING_JOBS_FAILED),
            "quanta": snap_counter(tut, metric.SCORING_QUANTA),
            "scored_tokens": snap_counter(
                tut, metric.SCORING_SCORED_TOKENS
            ),
            "truncated_texts": snap_counter(
                tut, metric.SCORE_TRUNCATED_TEXTS
            ),
            "preempt_wait_ms": snap_counter(
                tut, metric.SCORE_PREEMPT_WAIT_MS
            ),
        }

    def _record(self, ops, plan, scheduler, report, node_metrics,
                traces, wall_s: float, telemetry=None,
                fleet=None, scoring=None, groups=None) -> Dict:
        snap = self.metrics.snapshot()
        counters = snap.get("counters", {})
        ask = snap_hist(snap, metric.SIM_ASK_LATENCY)
        ledger_report = self.ledger.report()

        def node_sum(name: str) -> int:
            # Undercounts across a rolling restart (the restarted node's
            # counters reset) — good enough for ">= 1 really happened".
            return sum(snap_counter(s, name)
                       for s in node_metrics.values())

        gate_pass = node_sum(metric.GATE_PASS)
        gate_reject = node_sum(metric.GATE_REJECT)

        # The flight recorder's verdict attachments: exemplar digests
        # (what was pinned and why — slow, degraded, errored) and the
        # slowest ask's FULL span tree, so a perf regression's BENCH line
        # carries its own waterfall (`scripts/trace_report.py --json`)
        # instead of sending the reader off to rerun the sim.
        exemplars = [
            {"trace_id": t["trace_id"], "route": t["route"],
             "duration_s": t["duration_s"], "flags": t["flags"]}
            for t in sorted(traces, key=lambda t: -t["duration_s"])
            if t.get("flags")
            or t["route"].startswith("client.ask_llm")
        ][:8]
        asks = [t for t in traces if t["route"] == "client.ask_llm"]
        slowest = max(asks, key=lambda t: t["duration_s"], default=None)
        return {
            # BENCH schema: one headline metric + the full story around it.
            "metric": "semester_sim_ask_p95_s",
            "value": round(float(ask.get("p95_s", 0.0)), 3),
            "unit": "s",
            "seed": self.cfg.seed,
            "students": self.cfg.students,
            "duration_s": self.cfg.duration_s,
            "tutoring_engine": self.cfg.tutoring_engine,
            "tutoring_nodes": self.cfg.tutoring_nodes,
            # Fleet router outcome (None for a one-node fleet): spill /
            # hedge / ejection counts plus the end-state routing map —
            # the acceptance evidence for the kill-one-of-N and
            # drain-and-rejoin drills.
            "tutoring_fleet": fleet,
            # Idle-lane harvest evidence (None when [sim] bulk_scoring is
            # off): the bulk-grading night's jobs/quanta/tokens plus the
            # measured interactive preemption wait behind score quanta.
            "scoring": scoring,
            # Sharded-control-plane evidence (None for one group): the
            # final routing map, per-group leaders, and which acked
            # writes crossed the live split's resharding boundary.
            "lms_groups": self.cfg.lms_groups,
            "groups": groups,
            "course_concentration": self.cfg.course_concentration,
            # Measured shared-prefix KV cache hit rate on the tutoring
            # node (None unless the engine runs the radix cache, i.e.
            # tutoring_engine = "tiny-paged").
            "prefix_cache_hit_rate": report.prefix_cache_hit_rate,
            "trace_digest": wl.trace_digest(ops),
            "event_digest": _event_digest(plan),
            "ops_planned": len(ops),
            "ops_ok": counters.get("sim_ops_ok", 0),
            "ops_failed": counters.get("sim_ops_failed", 0),
            "ops_dropped": counters.get("sim_ops_dropped", 0),
            "asks": ask.get("count", 0),
            # Conversational/streaming evidence: completed streamed
            # turns, their TTFT distribution, client-observed
            # resume-at-offset failovers, and digest mismatches (must be
            # 0 — also a verdict check).
            "sessions": {
                "turns_ok": counters.get("sim_session_turns", 0),
                "turns_failed": counters.get("sim_session_turns_failed",
                                             0),
                "turn_ttft": snap_hist(snap, metric.SIM_TURN_TTFT),
                "stream_resumes": counters.get("sim_stream_resumes", 0),
                "digest_mismatches": counters.get(
                    "sim_stream_digest_mismatch", 0
                ),
            },
            "degraded_answers": counters.get("sim_degraded_answers", 0),
            "gate_pass": gate_pass,
            "gate_reject": gate_reject,
            "acked_writes": ledger_report["acked_writes"],
            "events": scheduler.outcomes,
            "events_executed": scheduler.executed_kinds(),
            "slos": report.to_dict(),
            "trace_exemplars": exemplars,
            "slowest_trace": slowest,
            # The in-run telemetry plane's artifacts: the burn-rate
            # engine's report (also inside slos.continuous) and the full
            # scraped timeline export — the input
            # `scripts/telemetry.py --capacity` fits the capacity model
            # over, embedded so one BENCH line replays the analysis.
            "telemetry": (telemetry.engine.report()
                          if telemetry is not None else None),
            "timeline": (telemetry.scraper.export()
                         if telemetry is not None else None),
            "wall_s": round(wall_s, 1),
        }


def _event_digest(plan: List[ev.SimEvent]) -> str:
    h = hashlib.sha256()
    for e in plan:
        h.update(e.key().encode())
        h.update(b"\n")
    return h.hexdigest()[:16]
