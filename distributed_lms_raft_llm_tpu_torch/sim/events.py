"""The operations schedule: planned and unplanned events injected mid-run.

The port's copy of `distributed_lms_raft_llm_tpu/sim/events.py`,
its logic as it is but for one repair: the stream-kill drill probes a
session whose resume path stays on one engine (`_stream_session`), which
in a fleet of one engine is the JAX package's session.

`plan_events` is — like the workload trace — a pure function of the
config: the schedule (what happens, when, with which parameters) comes
from the seed, so a failed run replays. `OperationsScheduler` executes
the plan against a live `SimCluster` strictly through the surfaces real
operators use: `POST /admin/faults` (including timed campaigns),
`POST /admin/transfer` (TimeoutNow leadership handoff), the disk-fault
admin plane for the storage-recovery quarantine, and
`POST /admin/membership` for the add/remove — then verifies each event's
observable outcome from `/healthz` (`GET /admin/faults` for campaigns).

Each event records an outcome dict; any `ok=False` outcome fails the
run's verdict (the harness feeds `failures()` into `evaluate_slos` as
the `events_completed` check), so the acceptance criteria —
>=1 transfer, >=1 quarantine+rejoin, >=1 membership change — are proven,
not assumed.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ..config import SimConfig
from ..utils import metrics_registry as metric

log = logging.getLogger(__name__)

CHAOS_CAMPAIGN = "chaos_campaign"
ROLLING_RESTART = "rolling_restart"
QUARANTINE = "quarantine"
MEMBERSHIP_ADD = "membership_add"
MEMBERSHIP_REMOVE = "membership_remove"
# Tutoring-fleet drills ([sim] tutoring_nodes > 1): brownout-then-
# blackout of ONE fleet member (hedge wins, then router spill), a
# drain-and-rejoin cycle (ejection, warm-up re-admission, affinity
# restored), and an autoscale add/drain/remove under load.
TUTORING_BLACKOUT = "tutoring_blackout"
TUTORING_DRAIN = "tutoring_drain_rejoin"
TUTORING_AUTOSCALE = "tutoring_autoscale"
# Resumable-stream drill: inject a mid-stream loss (the chaos `error`
# fault fires AFTER the first delivered chunk) on the streamed probe
# session's affinity node — the router must resume the answer at the
# delivered token offset on the spill node, and the client's digest
# check proves no token was duplicated or dropped across the failover.
TUTORING_STREAM_KILL = "tutoring_stream_kill"
# Bulk grading night ([sim] bulk_scoring): an instructor-scale score job
# fans every submitted assignment to the tutoring fleet's background
# scoring tenant via the LMS admin plane, mid-run, while student traffic
# keeps flowing. The job must COMPLETE; interactive p95 must not move.
BULK_GRADING = "bulk_grading_night"
# Sharded-control-plane drills ([sim] lms_groups > 1): sever ONE Raft
# group's quorum links on its leader via the per-group fault target
# `raft:<gid>` (the other groups must keep serving and the group must
# re-elect), and a live group split — POST /admin/reshard moves a course
# between groups mid-diurnal-peak, under a network-chaos overlay, with
# the routing-map flip verified on every node.
GROUP_LEADER_LOSS = "group_leader_loss"
GROUP_SPLIT = "group_split"

# Events that are OPERATIONS, not faults: the continuous SLO engine
# classifies burn alerts against fault windows only, so a latency alert
# raised while (e.g.) the bulk-grading job runs is a FALSE ALARM and
# fails the verdict — exactly the "interactive p95 unchanged while the
# job runs" claim, enforced by the existing alarm discipline.
NON_FAULT_KINDS = frozenset({BULK_GRADING})

# The ops bot's fixed ask: the fleet drills resolve ITS affinity node
# via GET /admin/tutoring/route and then fault/drain exactly that node,
# so a probe's hedge/spill is guaranteed to exercise the router (the
# harness's asker issues this same query).
PROBE_QUERY = "ops bot probe: what is Raft?"
# The streamed probe's session id: every streamer call converses in this
# one session, so the stream-kill drill can resolve (and fault) the node
# holding its transcript via /admin/tutoring/route?session=.
STREAM_SESSION_ID = "ops-bot-stream-drill"
# Numbered variants of it the stream-kill drill may take instead (the
# port's `OperationsScheduler._stream_session`).
STREAM_SESSION_VARIANTS = 16


@dataclasses.dataclass(frozen=True)
class SimEvent:
    at_s: float      # offset from workload start
    kind: str
    params: Dict[str, float]

    def key(self) -> str:
        items = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.at_s:.6f}|{self.kind}|{items}"


def _jitter(rng: random.Random, frac: float, width: float) -> float:
    return frac + rng.uniform(-width, width)


def plan_events(cfg: SimConfig) -> List[SimEvent]:
    """The semester's operations calendar, scaled to `duration_s`.

    Layout (fractions of the run, seed-jittered): an early network-chaos
    campaign whose last phase blacks out the tutoring hop (degraded
    answers, breaker open/close), a rolling restart of the leader via
    TimeoutNow transfer, a follower quarantined into storage recovery via
    disk bit flips, then a membership add and the matching remove.
    """
    if not cfg.events:
        return []
    rng = random.Random(cfg.seed ^ 0x5EED)
    T = cfg.duration_s
    chaos_hold = max(1.0, 0.10 * T)
    # The blackout must outlast the continuous SLO engine's fast window
    # (max(1.0, 0.06*T)) with margin: the fast-window burn alert needs a
    # span where the window sits fully inside the outage, plus the
    # sustain requirement — a blackout shorter than the window can only
    # ever produce diluted ratios.
    outage_hold = max(1.5, 0.08 * T)
    events = [
        SimEvent(
            at_s=_jitter(rng, 0.12, 0.02) * T, kind=CHAOS_CAMPAIGN,
            params={
                "drop": 0.10, "delay_s": 0.002, "delay_jitter_s": 0.01,
                "duplicate": 0.05, "hold_s": round(chaos_hold, 3),
                "outage_hold_s": round(outage_hold, 3),
            },
        ),
        SimEvent(at_s=_jitter(rng, 0.38, 0.02) * T, kind=ROLLING_RESTART,
                 params={}),
        SimEvent(
            at_s=_jitter(rng, 0.55, 0.02) * T, kind=QUARANTINE,
            params={"burst_s": round(max(0.8, 0.05 * T), 3),
                    "settle_s": round(max(0.6, 0.03 * T), 3)},
        ),
        SimEvent(at_s=_jitter(rng, 0.75, 0.02) * T, kind=MEMBERSHIP_ADD,
                 params={}),
        SimEvent(at_s=_jitter(rng, 0.90, 0.02) * T, kind=MEMBERSHIP_REMOVE,
                 params={}),
    ]
    if cfg.bulk_scoring:
        # The "night" lands in the post-chaos lull before the rolling
        # restart: the job must share the chip with live student traffic
        # (that is the claim), but a restart mid-poll would reset the
        # counters the completion check reads.
        events.append(SimEvent(
            at_s=_jitter(rng, 0.26, 0.02) * T, kind=BULK_GRADING,
            params={"timeout_s": round(max(6.0, 0.4 * T), 3)},
        ))
    if cfg.lms_groups > 1:
        # Group drills straddle the diurnal PEAK (0.5T): the leader loss
        # lands just before it, the live split right on it — the handoff
        # has to freeze/stream/flip while traffic is at its densest and a
        # chaos overlay shapes the wires.
        events += [
            SimEvent(
                at_s=_jitter(rng, 0.45, 0.02) * T, kind=GROUP_LEADER_LOSS,
                params={"gid": 1,
                        "hold_s": round(max(1.2, 0.05 * T), 3)},
            ),
            SimEvent(
                at_s=_jitter(rng, 0.52, 0.02) * T, kind=GROUP_SPLIT,
                params={"course": 0,
                        "chaos_s": round(max(2.0, 0.10 * T), 3)},
            ),
        ]
    if cfg.tutoring_nodes > 1:
        # Fleet drills land AFTER the rolling restart (0.38T): the node
        # that routes (and counts hedges/spills) must not be restarted
        # out from under the drill's counter deltas.
        events += [
            SimEvent(
                at_s=_jitter(rng, 0.48, 0.02) * T, kind=TUTORING_BLACKOUT,
                params={
                    "brownout_s": round(max(2.0, 0.10 * T), 3),
                    "outage_s": round(max(1.5, 0.08 * T), 3),
                    "delay_s": 0.6,
                },
            ),
            SimEvent(
                at_s=_jitter(rng, 0.58, 0.02) * T,
                kind=TUTORING_STREAM_KILL,
                params={"error_s": round(max(1.2, 0.06 * T), 3)},
            ),
            SimEvent(at_s=_jitter(rng, 0.68, 0.02) * T,
                     kind=TUTORING_DRAIN, params={}),
            SimEvent(at_s=_jitter(rng, 0.84, 0.02) * T,
                     kind=TUTORING_AUTOSCALE,
                     params={"hold_s": round(max(0.8, 0.04 * T), 3)}),
        ]
    return events


class OperationsScheduler:
    """Executes a plan against a `SimCluster` on its own thread.

    `writer` is a callable issuing one guaranteed acked write (the
    harness's ops-bot client): the quarantine event uses it to make sure
    corrupted-on-disk records actually exist during the bit-flip burst
    even if the diurnal trough goes quiet, and clean records land after
    it (mid-file corruption, not a truncatable torn tail).
    """

    def __init__(self, cluster, plan: List[SimEvent], *, metrics=None,
                 writer=None, asker=None, streamer=None, ledger=None):
        self.cluster = cluster
        self.plan = sorted(plan, key=lambda e: e.at_s)
        self.metrics = metrics
        self.writer = writer
        self.asker = asker
        # One STREAMED probe over a fixed session id (STREAM_SESSION_ID);
        # returns True when the stream completed digest-intact. The
        # stream-kill drill drives it under an injected mid-stream loss.
        self.streamer = streamer
        self.ledger = ledger
        self.outcomes: List[Dict] = []   # guarded-by: _lock
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control

    def start(self, t0: float) -> None:
        self._thread = threading.Thread(
            target=self._run, args=(t0,), name="sim-ops", daemon=True
        )
        self._thread.start()

    def join(self, timeout: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("operations scheduler did not finish")

    def executed_kinds(self) -> Dict[str, int]:
        with self._lock:
            kinds: Dict[str, int] = {}
            for o in self.outcomes:
                if o["ok"]:
                    kinds[o["kind"]] = kinds.get(o["kind"], 0) + 1
            return kinds

    def failures(self) -> List[Dict]:
        with self._lock:
            return [o for o in self.outcomes if not o["ok"]]

    def event_windows(self) -> List[tuple]:
        """(start_s, end_s) wall intervals (offsets from workload start)
        each FAULT event actually occupied — the continuous SLO engine
        classifies burn-rate alerts against these: an alert inside a
        fault phase is the system working, one outside is a false alarm.
        Non-fault operations (NON_FAULT_KINDS — the bulk-grading night)
        are excluded on purpose: background scoring promises NOT to move
        interactive latency, so an alert during it must fail the run,
        not be excused by it."""
        with self._lock:
            return [(o["t0_s"], o["t1_s"]) for o in self.outcomes
                    if "t0_s" in o and "t1_s" in o
                    and o["kind"] not in NON_FAULT_KINDS]

    # ------------------------------------------------------------ internals

    def _run(self, t0: float) -> None:
        for event in self.plan:
            delay = t0 + event.at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            outcome = {"kind": event.kind, "at_s": round(event.at_s, 3),
                       "ok": False, "detail": "",
                       "t0_s": round(time.monotonic() - t0, 3)}
            try:
                handler = {
                    CHAOS_CAMPAIGN: self._chaos_campaign,
                    ROLLING_RESTART: self._rolling_restart,
                    QUARANTINE: self._quarantine,
                    MEMBERSHIP_ADD: self._membership_add,
                    MEMBERSHIP_REMOVE: self._membership_remove,
                    TUTORING_BLACKOUT: self._tutoring_blackout,
                    TUTORING_DRAIN: self._tutoring_drain,
                    TUTORING_AUTOSCALE: self._tutoring_autoscale,
                    TUTORING_STREAM_KILL: self._tutoring_stream_kill,
                    BULK_GRADING: self._bulk_grading,
                    GROUP_LEADER_LOSS: self._group_leader_loss,
                    GROUP_SPLIT: self._group_split,
                }[event.kind]
                outcome["detail"] = handler(event)
                outcome["ok"] = True
                if self.metrics is not None:
                    self.metrics.inc(metric.SIM_EVENTS_INJECTED)
            except Exception as e:  # recorded; the harness fails the run
                log.exception("sim event %s failed", event.kind)
                outcome["detail"] = f"{type(e).__name__}: {e}"
            outcome["t1_s"] = round(time.monotonic() - t0, 3)
            with self._lock:
                self.outcomes.append(outcome)

    def _leader(self) -> int:
        nid = self.cluster.wait_leader(timeout=15.0)
        if nid is None:
            raise RuntimeError("no leader to operate on")
        return nid

    def _post_leader(self, path: str, body: Dict, *,
                     attempts: int = 4,
                     avoid: Optional[int] = None) -> Dict:
        """POST an admin op that must land on the live leader.

        `wait_leader` and the POST are not atomic: the resolved node can
        step down in between (its /healthz hint may even still name
        itself), which is retryable operator business — re-resolve and
        re-post, like a human operator would. `avoid` drains leadership
        off that node first (decommission: never ask a node to remove
        itself)."""
        last: Optional[Exception] = None
        for attempt in range(attempts):
            leader = self._leader()
            try:
                if leader == avoid:
                    self.cluster.admin_post(leader, "/admin/transfer", {})
                    continue
                return self.cluster.admin_post(leader, path, body)
            except RuntimeError as e:
                last = e
                log.info("%s attempt %d on node %d failed: %s",
                         path, attempt, leader, e)
                time.sleep(0.5)
        raise RuntimeError(
            f"admin POST {path} kept failing across leaders: {last}"
        ) from last

    # -------------------------------------------------------------- events

    def _chaos_campaign(self, event: SimEvent) -> str:
        """Network chaos on every node's egress, with the leader's
        campaign ending in a tutoring blackout (degraded answers).

        The leader gets ONE campaign with both phases: CampaignRunner
        replaces (cancels) any running campaign on the same node, so
        posting the blackout separately would cancel the leader's chaos
        phase milliseconds in."""
        p = event.params
        leader = self._leader()
        t0 = None  # the leader's campaign clock starts at ITS post
        for nid in self.cluster.node_ids():
            phases = [{
                # "*" shapes BOTH the Raft egress and the tutoring
                # forward (FaultInjector.spec_for wildcard fallback).
                "target": "*",
                "duration_s": p["hold_s"], "drop": p["drop"],
                "delay_s": p["delay_s"],
                "delay_jitter_s": p["delay_jitter_s"],
                "duplicate": p["duplicate"],
            }]
            name = "sim-network-chaos"
            if nid == leader:
                phases.append({"target": "tutoring",
                               "duration_s": p["outage_hold_s"],
                               "drop": 1.0})
                name = "sim-chaos-then-blackout"
            self.cluster.admin_post(nid, "/admin/faults",
                                    {"campaign": {"name": name,
                                                  "phases": phases}})
            if nid == leader:
                # Anchor the probe window on the leader's POST, not on
                # some earlier instant: leader resolution and the other
                # nodes' POSTs can eat most of a second on a loaded
                # machine, and the blackout phase we probe runs on the
                # leader's clock.
                t0 = time.monotonic()
        # The campaign is introspectable while live: GET /admin/faults
        # (the plane used to be write-only).
        some = self.cluster.node_ids()[0]
        state = self.cluster.admin_get(some, "/admin/faults")
        if not state["campaign"]["active"]:
            raise RuntimeError(f"campaign not visible via GET: {state}")
        # Wait out the chaos phase, then probe while the leader's
        # blackout phase runs, guaranteeing the degraded path fires.
        end = t0 + p["hold_s"] + p["outage_hold_s"]
        time.sleep(max(0.0, t0 + p["hold_s"] + 0.1 - time.monotonic()))
        degraded = 0
        if self.asker is not None:
            while time.monotonic() < end - 0.2 and degraded < 3:
                if not self.asker():
                    time.sleep(0.1)
                    continue
                degraded += 1
        time.sleep(max(0.0, end - time.monotonic()))
        return (f"chaos {p['hold_s']}s on all nodes; tutoring blackout "
                f"{p['outage_hold_s']}s on leader {leader} "
                f"({degraded} degraded probes)")

    def _rolling_restart(self, event: SimEvent) -> str:
        """Planned maintenance: TimeoutNow handoff off the leader, then
        restart the ex-leader and wait for it to serve again. A transfer
        can abort under load (the chosen target lags or a send drops);
        that is retryable operator business, not a scenario failure."""
        resp = None
        for attempt in range(4):
            leader = self._leader()
            try:
                resp = self.cluster.admin_post(leader, "/admin/transfer",
                                               {})
                break
            except RuntimeError as e:
                log.info("transfer attempt %d failed: %s", attempt, e)
                time.sleep(0.5)
        if resp is None:
            raise RuntimeError("leadership transfer kept aborting")
        target = resp["target"]
        new_leader = self.cluster.wait_leader(timeout=15.0, exclude=leader)
        self.cluster.restart_node(leader)
        self.cluster.wait_healthy(leader, timeout=20.0)
        return (f"transferred {leader} -> {target} (observed leader "
                f"{new_leader}); restarted {leader}")

    def _quarantine(self, event: SimEvent) -> str:
        """Storage-recovery quarantine via the disk-fault admin plane:
        flip bits on a follower's disk writes, restart it — it must boot
        `storage_recovering`, rejoin via leader replication /
        InstallSnapshot, and heal.

        The restart follows the burst IMMEDIATELY: the victim's own
        snapshot compaction rewrites a clean snapshot and truncates the
        corrupt WAL prefix, so any post-clear dawdling can erase the
        evidence and boot the node clean. That compaction race is real
        (it depends on where the snapshot_every boundary lands), so a
        clean boot retries the whole burst rather than failing the run.
        """
        p = event.params
        attempts = 0
        while True:
            attempts += 1
            leader = self._leader()
            victim = next(n for n in self.cluster.node_ids()
                          if n != leader)
            self.cluster.admin_post(victim, "/admin/faults",
                                    {"target": "disk", "bit_flip": 1.0})
            # Acked writes DURING the burst: their WAL records on the
            # victim are corrupt on disk while a healthy quorum holds
            # them — the zero-loss SLO covers exactly these.
            for _ in range(5):
                if self.writer is not None:
                    self.writer()
                time.sleep(p["burst_s"] / 5)
            self.cluster.admin_post(victim, "/admin/faults",
                                    {"clear": "disk"})
            self.cluster.restart_node(victim)
            health = self.cluster.wait_healthy(victim, timeout=20.0)
            if health.get("storage_recovering"):
                break
            if attempts >= 3:
                raise RuntimeError(
                    f"node {victim} restarted clean {attempts} times — "
                    f"the disk-fault bursts never corrupted its WAL "
                    f"(healthz: {health})"
                )
            time.sleep(p["settle_s"])
        self.cluster.wait_until(
            victim, lambda h: not h.get("storage_recovering"),
            timeout=25.0, what="storage recovery to heal",
        )
        return (f"quarantined follower {victim} (attempt {attempts}); "
                "healed via rejoin")

    def _membership_add(self, event: SimEvent) -> str:
        nid, address = self.cluster.spawn_extra_node()
        resp = self._post_leader(
            "/admin/membership",
            {"op": "add", "id": nid, "address": address},
        )
        leader = self._leader()
        self.cluster.wait_until(
            leader, lambda h: str(nid) in h.get("members", {}),
            timeout=15.0, what=f"member {nid} visible on leader",
        )
        return f"added node {nid} at {address} (index {resp['index']})"

    def _membership_remove(self, event: SimEvent) -> str:
        nid = self.cluster.extra_node_id()
        if nid is None:
            raise RuntimeError("no membership-added node to remove")
        self._post_leader("/admin/membership",
                          {"op": "remove", "id": nid}, avoid=nid)
        leader = self._leader()
        self.cluster.wait_until(
            leader, lambda h: str(nid) not in h.get("members", {}),
            timeout=15.0, what=f"member {nid} gone from leader view",
        )
        self.cluster.stop_node(nid)
        return f"removed node {nid} and stopped it"

    def _bulk_grading(self, event: SimEvent) -> str:
        """Bulk grading night: fan every submitted assignment to the
        tutoring fleet's background scoring tenant via the LMS leader's
        admin plane (POST /admin/score routes off the hot affinity nodes
        — lms/tutoring_pool.plan_background), then poll the placed
        node's GET /admin/score/<id> until the job completes. Student
        traffic keeps flowing the whole time; the continuous SLO engine
        treats this window as NON-fault, so a scoring-induced latency
        alert fails the run — "interactive p95 unchanged while the job
        runs" is enforced, not assumed."""
        import json as _json
        import urllib.request

        p = event.params
        resp = self._post_leader("/admin/score", {"purpose": "grading"})
        job_id = resp["job_id"]
        health = resp["health"]
        submitted = int(resp.get("submitted_texts", 0))
        deadline = time.monotonic() + p["timeout_s"]
        doc: Dict = {}
        while time.monotonic() < deadline:
            # Poll the tutoring node directly (leadership may move while
            # the job runs; the placing node's admin plane is sticky).
            req = urllib.request.Request(
                f"http://{health}/admin/score/{job_id}", method="GET"
            )
            try:
                with urllib.request.urlopen(req, timeout=10.0) as r:
                    doc = _json.loads(r.read().decode())
            except Exception as e:  # transient poll failure: keep trying
                log.info("bulk-grading poll failed: %s", e)
                time.sleep(0.2)
                continue
            if doc.get("status") in ("done", "failed"):
                break
            time.sleep(0.1)
        if doc.get("status") != "done":
            raise RuntimeError(
                f"bulk grading job {job_id} did not complete in "
                f"{p['timeout_s']}s: {doc.get('status')!r} "
                f"({doc.get('error')})"
            )
        results = doc.get("results") or []
        if submitted and len(results) != submitted:
            raise RuntimeError(
                f"bulk grading job {job_id} returned {len(results)} "
                f"results for {submitted} submissions"
            )
        return (f"graded {len(results)} submissions in {doc.get('quanta')}"
                f" preemptible quanta on {resp.get('node')} "
                f"({doc.get('scored_tokens')} tokens scored in the idle "
                "lanes, interactive traffic untouched)")

    # ------------------------------------------------------ group drills

    def _group_is_leader(self, nid: int, gid: int) -> bool:
        doc = self.cluster.group_topology(nid)
        row = doc.get("groups", {}).get(str(gid), {})
        return bool(row.get("is_leader"))

    def _group_leader_loss(self, event: SimEvent) -> str:
        """Sever ONE Raft group's quorum links on its leader via the
        per-group fault target `raft:<gid>` (a timed campaign, the same
        plane operators use). The group must re-elect on another node
        while every OTHER group — including the meta group — keeps its
        leader untouched."""
        p = event.params
        gid = int(p["gid"])
        victim = self.cluster.wait_group_leader(gid, timeout=15.0)
        if victim is None:
            raise RuntimeError(f"group {gid} has no leader to kill")
        self.cluster.admin_post(victim, "/admin/faults", {"campaign": {
            "name": f"sim-group{gid}-leader-loss",
            "phases": [{"target": f"raft:{gid}",
                        "duration_s": p["hold_s"], "drop": 1.0}],
        }})
        t0 = time.monotonic()
        new_leader = None
        deadline = t0 + p["hold_s"] + 10.0
        while time.monotonic() < deadline:
            for nid in self.cluster.node_ids():
                if nid == victim:
                    continue
                try:
                    if self._group_is_leader(nid, gid):
                        new_leader = nid
                        break
                except Exception:
                    continue
            if new_leader is not None:
                break
            time.sleep(0.05)
        if new_leader is None:
            raise RuntimeError(
                f"group {gid} elected no replacement leader after its "
                f"leader {victim} lost its group links"
            )
        # Wait out the campaign so event_windows covers the whole fault.
        time.sleep(max(0.0, t0 + p["hold_s"] - time.monotonic()))
        return (f"severed raft:{gid} on leader {victim} for "
                f"{p['hold_s']}s; group re-elected node {new_leader}")

    def _group_split(self, event: SimEvent) -> str:
        """Live group split mid-diurnal-peak: move one course's key
        range to the neighbor group through POST /admin/reshard — the
        staged freeze/stream/flip handoff — while a network-chaos
        overlay shapes every node's egress. The routing-map flip must
        become visible on EVERY node's router."""
        p = event.params
        doc = self.cluster.routing_map_doc()
        course = f"course{int(p['course'])}"
        courses = doc.get("courses", {})
        if course not in courses:
            raise RuntimeError(
                f"course {course!r} missing from routing map {doc}"
            )
        src = int(courses[course])
        n_groups = int(doc.get("n_groups", 1))
        dst = (src + 1) % n_groups
        v0 = int(doc.get("version", 1))
        for nid in self.cluster.node_ids():
            self.cluster.admin_post(nid, "/admin/faults", {"campaign": {
                "name": "sim-split-chaos",
                "phases": [{"target": "*", "duration_s": p["chaos_s"],
                            "drop": 0.05, "delay_s": 0.002}],
            }})
        resp = self.cluster.reshard(course, dst)
        self._wait(
            lambda: all(
                int(self.cluster.routing_map_doc(nid).get("version", 0))
                > v0
                for nid in self.cluster.node_ids()
            ),
            15.0, "routing-map flip visible on every node",
        )
        if self.ledger is not None:
            self.ledger.note_reshard(course, src, dst,
                                     int(resp.get("version", v0 + 1)))
        return (f"moved {course} group {src} -> {dst} under chaos "
                f"(map v{v0} -> v{resp.get('version')}, "
                f"{resp.get('moved_users')} users)")

    # ------------------------------------------------------ fleet drills

    def _probe_route(self, nid: int, session_id: str = "") -> Dict:
        """Where the ring on LMS node `nid` would send the ops bot's
        probe query (GET /admin/tutoring/route) — or, with `session_id`,
        the probe SESSION's sticky key (the node holding its transcript
        and pinned prefix blocks)."""
        path = ("/admin/tutoring/route?session="
                + urllib.parse.quote(session_id) if session_id else
                "/admin/tutoring/route?q="
                + urllib.parse.quote(PROBE_QUERY))
        doc = self.cluster.admin_get(nid, path)
        if not doc.get("order"):
            raise RuntimeError(f"empty tutoring route on node {nid}: "
                               f"{doc}")
        return doc

    def _fleet_counter(self, name: str) -> int:
        """Summed across every live LMS node: whichever node leads (and
        therefore routes) during the drill contributes its counters."""
        total = 0
        for nid in self.cluster.node_ids():
            try:
                snap = self.cluster.metrics_snapshot(nid)
            except Exception:
                continue
            total += int(snap.get("counters", {}).get(name, 0))
        return total

    def _probe_until(self, counter: str, baseline: int, end: float,
                     settle_s: float = 0.05) -> int:
        """Drive ops-bot asks until `counter` moves past `baseline` or
        the window closes; returns the final reading."""
        value = baseline
        while time.monotonic() < end - 0.1:
            if self.asker is not None:
                self.asker()
            value = self._fleet_counter(counter)
            if value > baseline:
                break
            time.sleep(settle_s)
        return value

    def _tutoring_blackout(self, event: SimEvent) -> str:
        """Kill-one-of-N: brownout (injected delay) then full blackout
        of exactly the probe query's affinity node, via the per-node
        fault target `tutoring:<i>`. The brownout must produce a hedge
        win (the second choice answers while the affinity node sits on
        the request); the blackout must produce a router spill within
        its own window — tail-tolerance proven from /metrics, not
        assumed."""
        p = event.params
        leader = self._leader()
        route = self._probe_route(leader)
        idx = route["order"][0]["index"]
        self.cluster.admin_post(leader, "/admin/faults", {"campaign": {
            "name": "sim-fleet-brownout-blackout",
            "phases": [
                {"target": f"tutoring:{idx}",
                 "duration_s": p["brownout_s"], "delay_s": p["delay_s"]},
                {"target": f"tutoring:{idx}",
                 "duration_s": p["outage_s"], "drop": 1.0},
            ],
        }})
        t0 = time.monotonic()
        wins0 = self._fleet_counter(metric.TUTORING_HEDGE_WINS)
        wins = self._probe_until(metric.TUTORING_HEDGE_WINS, wins0,
                                 t0 + p["brownout_s"])
        time.sleep(max(0.0, t0 + p["brownout_s"] - time.monotonic()))
        # Baseline AFTER the brownout: hedge wins are served
        # off-affinity and count as spills too, so a pre-brownout
        # baseline would make the blackout-phase assertion vacuous.
        spills0 = self._fleet_counter(metric.TUTORING_SPILLS)
        spills = self._probe_until(
            metric.TUTORING_SPILLS, spills0,
            t0 + p["brownout_s"] + p["outage_s"],
        )
        time.sleep(max(0.0, t0 + p["brownout_s"] + p["outage_s"]
                       - time.monotonic()))
        if wins <= wins0:
            raise RuntimeError(
                f"no hedge win during the {p['brownout_s']}s brownout "
                f"of tutoring:{idx}"
            )
        if spills <= spills0:
            raise RuntimeError(
                f"no router spill during the {p['outage_s']}s blackout "
                f"of tutoring:{idx}"
            )
        return (f"browned out tutoring:{idx} {p['brownout_s']}s "
                f"(hedge wins +{wins - wins0}), blacked it out "
                f"{p['outage_s']}s (spills +{spills - spills0}); the "
                "router spilled within the outage window")

    def _tutoring_drain(self, event: SimEvent) -> str:
        """Elastic drain-and-rejoin, MID-SESSION: POST /admin/drain on
        the streamed probe session's affinity node (the one holding its
        transcript), watch the router eject it (health poller), prove
        the session's next streamed turn completes on the second choice
        (correctness never depends on node-local session warmth), end
        the drain, and verify the ring routes the session key BACK to
        the node once its warm-up ramp finishes — cache affinity
        restored, not just liveness."""
        leader = self._leader()
        if self.streamer is not None:
            self.streamer()  # seed the session so a transcript is live
        route = self._probe_route(leader, session_id=STREAM_SESSION_ID)
        idx = route["order"][0]["index"]
        address = route["order"][0]["address"]
        self.cluster.tutoring_admin_post(idx, "/admin/drain",
                                         {"drain": True})
        self._wait(lambda: self.cluster.tutoring_healthz(idx)
                   .get("draining") and
                   self.cluster.tutoring_healthz(idx).get("queued") == 0,
                   10.0, f"tutoring node {idx} drained")
        self._wait(lambda: self._fleet_state(leader, address)
                   in ("draining", "ejected"),
                   10.0, f"router ejected {address}")
        if self.asker is not None:
            self.asker()  # served by the second choice while drained
        mid = self._probe_route(self._leader(),
                                session_id=STREAM_SESSION_ID)
        if mid["order"] and mid["order"][0]["index"] == idx:
            raise RuntimeError(
                f"session still routed to draining node {idx}: {mid}"
            )
        if self.streamer is not None and not self.streamer():
            raise RuntimeError(
                "streamed session turn failed while its affinity node "
                f"{idx} drained (must be served off-node)"
            )
        self.cluster.tutoring_admin_post(idx, "/admin/drain",
                                         {"drain": False})
        self._wait(lambda: self._fleet_state(leader, address)
                   in ("warming", "ok"),
                   10.0, f"router re-admitted {address}")
        self._wait(lambda: self._fleet_state(leader, address) == "ok",
                   10.0, f"warm-up of {address} finished")
        back = self._probe_route(leader, session_id=STREAM_SESSION_ID)
        if back["order"][0]["index"] != idx:
            raise RuntimeError(
                f"affinity not restored after rejoin: session routes to "
                f"{back['order'][0]} instead of node {idx}"
            )
        return (f"drained tutoring:{idx} mid-session (router ejected "
                "it, the session's streamed turn completed off-node), "
                "rejoined with warm-up; session affinity restored to "
                "the same node")

    def _tutoring_stream_kill(self, event: SimEvent) -> str:
        """Kill-mid-stream: the chaos `error` fault on the session's
        affinity node makes every stream from it die right AFTER its
        first delivered chunk — too late to hedge (hedging is
        before-first-byte only), so the router must resume the answer
        at the delivered token offset on the spill node. Evidence is
        demanded from both ends: the fleet's stream_resumes counter
        moves, and the client completes a streamed answer whose
        assembled text matches the final chunk's digest (no token
        duplicated or dropped across the failover).

        The probe session is the first of `STREAM_SESSION_ID` and its
        numbered variants whose resume path stays on one engine, and the
        loss goes on its primary (`_stream_session`): a resume splices the
        spill node's regeneration onto the delivered prefix, which can
        match only where both nodes run the same engine. In a fleet of one
        engine with closed breakers that is `STREAM_SESSION_ID` and its
        affinity node, the JAX package's drill."""
        p = event.params
        if self.streamer is None:
            raise RuntimeError("stream-kill drill needs a streamer probe")
        leader = self._leader()
        session, primary = self._stream_session(leader)
        self.streamer(session)  # seed the session (affinity + transcript)
        route = self._probe_route(leader, session_id=session)
        if len(route["order"]) < 2:
            raise RuntimeError(
                f"stream-kill drill needs a spill candidate: {route}"
            )
        idx = route["order"][0]["index"] if primary is None else primary
        resumes0 = self._fleet_counter(metric.STREAM_RESUMES)
        self.cluster.admin_post(leader, "/admin/faults", {"campaign": {
            "name": "sim-stream-kill",
            "phases": [{"target": f"tutoring:{idx}",
                        "duration_s": p["error_s"], "error": 1.0}],
        }})
        t0 = time.monotonic()
        end = t0 + p["error_s"]
        intact = 0
        resumes = resumes0
        while time.monotonic() < end - 0.1:
            if self.streamer(session):
                intact += 1
            resumes = self._fleet_counter(metric.STREAM_RESUMES)
            if resumes > resumes0 and intact >= 1:
                break
            time.sleep(0.05)
        time.sleep(max(0.0, end - time.monotonic()))
        if resumes <= resumes0:
            raise RuntimeError(
                f"no resume-at-offset failover during the "
                f"{p['error_s']}s mid-stream loss on tutoring:{idx}"
            )
        if intact < 1:
            raise RuntimeError(
                "no digest-intact streamed answer completed during the "
                f"mid-stream loss on tutoring:{idx}"
            )
        return (f"injected mid-stream loss on tutoring:{idx} for "
                f"{p['error_s']}s; +{resumes - resumes0} resume-at-"
                f"offset failovers, {intact} streamed answer(s) "
                "completed digest-intact")

    def _tutoring_autoscale(self, event: SimEvent) -> str:
        """Autoscaling drill: add a fleet member under load (every LMS
        router admits it, warm-up weighted), hold, then drain + remove
        it — the add/remove remaps only the new node's ~1/N key share
        (rendezvous), so the survivors' prefix caches stay warm."""
        p = event.params
        idx, address, health = self.cluster.spawn_tutoring_node()
        for nid in self.cluster.node_ids():
            self.cluster.admin_post(nid, "/admin/tutoring",
                                    {"op": "add", "address": address,
                                     "health": health})
        leader = self._leader()
        self._wait(lambda: self._fleet_state(leader, address)
                   in ("warming", "ok"),
                   10.0, f"router admitted {address}")
        time.sleep(p["hold_s"])  # serve under load as a fleet of N+1
        self.cluster.tutoring_admin_post(idx, "/admin/drain",
                                         {"drain": True})
        self._wait(lambda: self.cluster.tutoring_healthz(idx)
                   .get("queued") == 0,
                   10.0, f"autoscaled node {idx} drained")
        for nid in self.cluster.node_ids():
            self.cluster.admin_post(nid, "/admin/tutoring",
                                    {"op": "remove", "address": address})
        self.cluster.stop_tutoring_node(idx)
        return (f"scaled the fleet up with {address} under load, then "
                "drained and removed it")

    def _stream_session(self, nid: int) -> Tuple[str, Optional[int]]:
        """The stream-kill drill's probe session on LMS node `nid`'s ring
        and its primary: `STREAM_SESSION_ID`, or the first of its
        numbered variants whose primary and resume target (the first two
        nodes of its route whose breaker admits a send) serve the same
        engine, as each tutoring node's /healthz names it. A fleet of one
        engine takes `STREAM_SESSION_ID`; so does a fleet where no
        variant qualifies, with no primary named (None)."""
        health = self.cluster.healthz(nid)
        admitting = {
            node["address"]
            for node in health.get("tutoring_fleet", {}).get("nodes", ())
            if node.get("breaker", {}).get("state") != "open"}
        engines: Dict[int, Optional[str]] = {}
        for i in range(STREAM_SESSION_VARIANTS):
            session = (STREAM_SESSION_ID if i == 0
                       else f"{STREAM_SESSION_ID}-{i}")
            order = self._probe_route(nid, session_id=session)["order"]
            pair = [node["index"] for node in order
                    if node["address"] in admitting][:2]
            if len(pair) < 2:
                continue
            for idx in pair:
                if idx not in engines:
                    engines[idx] = self.cluster.tutoring_healthz(idx).get(
                        "engine")
            if engines[pair[0]] == engines[pair[1]]:
                return session, pair[0]
        return STREAM_SESSION_ID, None

    def _fleet_state(self, nid: int, address: str) -> Optional[str]:
        health = self.cluster.healthz(nid)
        for node in health.get("tutoring_fleet", {}).get("nodes", ()):
            if node["address"] == address:
                return node["state"]
        return None

    def _wait(self, pred, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if pred():
                    return
            except Exception:
                pass
            time.sleep(0.05)
        raise RuntimeError(f"timed out waiting for {what}")
