"""SLO evaluation: continuous burn-rate windows in-run, verdict at end.

The port's copy of `distributed_lms_raft_llm_tpu/sim/slo.py`,
its logic as it is.

Two layers, one set of bounds (`SimConfig.slo_*`):

**Continuous (`ContinuousSloEngine`)** — the semester sim no longer
waits for the post-mortem: while the workload runs, a telemetry loop
polls every node's `/metrics` into a merged cluster timeline
(utils/scrape.py) and evaluates each SLO over TWO sliding windows — a
short *fast* window that pages quickly and a long *slow* window that
demands sustained evidence — the SRE-workbook multi-window burn-rate
pattern scaled to sim time. Burn = (budget consumption rate) / (budget
accrual rate): a degraded-answer rate of 2x its bound burns at 2.0. An
alert needs `sustain` consecutive over-threshold evaluations to raise
(one noisy sample never pages) and the same streak below to clear;
raises and clears are recorded as timeline events, counted in
`sim_burn_alerts`, and carried — classified against the operations
schedule's fault phases — into the verdict and the BENCH record. On the
healthy baseline the engine must stay silent (`no_false_alarms`); during
an injected fault it must fire (the tier-1 sim pins both).

**End-of-run (`evaluate_slos`)** — unchanged in spirit: after faults
clear and the cluster settles, the checks run against what the CLUSTER
exports (every node's `/metrics`/`/healthz` over HTTP) plus the
harness's client-side series, so the same checks an operator's alerting
would run are what gate the run. Metric names route through
`utils/metrics_registry` constants and the shared snapshot readers
(utils/timeline.snap_*) — the metrics-registry lint rule checks these
READ sites too, so an SLO bound on a never-declared series fails lint
instead of silently reading 0.

The verdict also carries **per-stage p95 breakdowns** computed from the
flight recorder's retained traces (utils/tracing.py): the aggregate
`answer_p95` bound says *whether* the cluster met its budget, the stage
breakdown says *where* the budget went. Stage quantiles use the shared
nearest-rank helper (utils/metrics.percentile_of_sorted), the same
formula every histogram and timeline percentile in the repo uses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import SimConfig
from ..utils import metrics_registry as metric
from ..utils.metrics import Metrics, percentile_of_sorted
from ..utils.timeline import (
    Timeline,
    degraded_rate_burn,
    snap_counter,
    snap_gauge,
    snap_hist,
)


@dataclasses.dataclass(frozen=True)
class SloCheck:
    name: str
    ok: bool
    observed: str
    bound: str


@dataclasses.dataclass
class SloReport:
    checks: List[SloCheck]
    # Span name -> {count, p50_s, p95_s, max_s}: where the answer budget
    # actually went, computed from retained traces (stage_breakdown).
    stage_p95s: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    # Measured shared-prefix KV cache hit rate on the tutoring node
    # (prefix_cache_hit_rate gauge); None when the serving engine runs
    # without the cache (echo stand-in, bucketed engine). Informational
    # — carried in the verdict and the BENCH record, not a pass/fail
    # bound.
    prefix_cache_hit_rate: Any = None
    # The continuous engine's report (windows, evaluations, alerts with
    # fault classification); None when the run evaluated SLOs only at
    # the end ([sim] continuous_slos = false).
    continuous: Optional[Dict[str, Any]] = None
    # Tutoring-fleet summary (router spill/hedge counters + per-node
    # end-state map); None for a one-node fleet.
    fleet: Optional[Dict[str, Any]] = None
    # Background scoring-tenant summary (jobs/quanta/tokens from the
    # tutoring fleet's counters); None when the tenant is disabled.
    scoring: Optional[Dict[str, Any]] = None
    # Sharded-control-plane summary (routing map, per-group leaders,
    # reshard evidence); None for a single-group deployment.
    groups: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def failures(self) -> List[SloCheck]:
        return [c for c in self.checks if not c.ok]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "checks": {c.name: {"ok": c.ok, "observed": c.observed,
                                "bound": c.bound}
                       for c in self.checks},
            "stage_p95s": self.stage_p95s,
            "prefix_cache_hit_rate": self.prefix_cache_hit_rate,
            "continuous": self.continuous,
            "fleet": self.fleet,
            "scoring": self.scoring,
            "groups": self.groups,
        }


def _walk_spans(span: Dict[str, Any], out: Dict[str, List[float]]) -> None:
    out.setdefault(span["name"], []).append(float(span.get("duration_s",
                                                           0.0)))
    for child in span.get("children", ()):
        _walk_spans(child, out)


def stage_breakdown(
    traces: Sequence[Dict[str, Any]],
) -> Dict[str, Dict[str, float]]:
    """Per-stage latency stats from assembled trace dicts
    (`Tracer.records()` / `GET /admin/trace/<id>` shape): span name ->
    {count, p50_s, p95_s, max_s}. Spans aggregate by NAME — `queue.wait`
    collects every request's queue wait regardless of which node recorded
    it — so the result reads as attributable per-stage budgets next to
    the aggregate `answer_p95` SLO bound."""
    by_name: Dict[str, List[float]] = {}
    for trace in traces:
        for root in trace.get("spans", ()):
            _walk_spans(root, by_name)
    out: Dict[str, Dict[str, float]] = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        out[name] = {
            "count": len(durs),
            "p50_s": round(percentile_of_sorted(durs, 50), 6),
            "p95_s": round(percentile_of_sorted(durs, 95), 6),
            "max_s": round(durs[-1], 6),
        }
    return out


# ===================================================== continuous engine


FAST = "fast"
SLOW = "slow"

# The continuously evaluated SLOs (each over both windows).
CONTINUOUS_SLOS = ("answer_p95", "degraded_rate", "tick_stalls")


@dataclasses.dataclass
class BurnAlert:
    """One raised burn-rate alert and its lifecycle."""

    slo: str
    window: str                       # FAST | SLOW
    window_s: float
    raised_at_s: float                # offset from workload start
    peak_burn: float
    cleared_at_s: Optional[float] = None
    # Set by finish(): whether the raise falls inside (a margin around)
    # an injected-fault phase. An alert outside every fault phase is a
    # false alarm and fails the verdict's `no_false_alarms` check.
    during_fault: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "slo": self.slo,
            "window": self.window,
            "window_s": round(self.window_s, 3),
            "raised_at_s": round(self.raised_at_s, 3),
            "cleared_at_s": (round(self.cleared_at_s, 3)
                             if self.cleared_at_s is not None else None),
            "peak_burn": round(self.peak_burn, 3),
            "during_fault": self.during_fault,
        }


class ContinuousSloEngine:
    """Fast/slow multi-window burn-rate evaluation over a live run.

    `cluster` is the scrape aggregator's merged timeline (node-side
    counters: degraded rate, tick stalls); `sim_metrics` is the
    harness's own client-side Metrics (the answer-latency SLO uses its
    TRUE sliding-window percentile — a cumulative reservoir would hold
    an early spike against the whole run). Windows default to fractions
    of the run so the same config scales from the 16 s tier-1 sim to an
    hours-long soak; production windows come from [telemetry].
    """

    def __init__(
        self,
        cfg: SimConfig,
        cluster: Timeline,
        sim_metrics: Metrics,
        *,
        fast_window_s: Optional[float] = None,
        slow_window_s: Optional[float] = None,
        fast_burn: float = 1.2,
        slow_burn: float = 1.0,
        sustain: int = 2,
        metrics: Optional[Metrics] = None,
    ):
        self.cfg = cfg
        self.cluster = cluster
        self.sim_metrics = sim_metrics
        self.metrics = metrics
        self.windows: Dict[str, float] = {
            FAST: (fast_window_s if fast_window_s is not None
                   else max(1.0, 0.06 * cfg.duration_s)),
            SLOW: (slow_window_s if slow_window_s is not None
                   else max(4.0, 0.30 * cfg.duration_s)),
        }
        self.burn_thresholds: Dict[str, float] = {
            FAST: fast_burn, SLOW: slow_burn,
        }
        self.sustain = max(1, sustain)
        self.alerts: List[BurnAlert] = []
        self.evaluations = 0
        self.windows_evaluated: Dict[str, int] = {
            slo: 0 for slo in CONTINUOUS_SLOS
        }
        self._over: Dict[Tuple[str, str], int] = {}
        self._under: Dict[Tuple[str, str], int] = {}
        self._active: Dict[Tuple[str, str], BurnAlert] = {}

    # -------------------------------------------------------- burn math

    def _burn(self, slo: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Budget consumption rate over the window as a multiple of the
        budget's accrual rate; None = the window holds no evidence (no
        samples / no traffic to judge), which never moves a streak."""
        cfg = self.cfg
        if slo == "answer_p95":
            p95 = self.sim_metrics.hist(
                metric.SIM_ASK_LATENCY
            ).window_percentile(window_s, 95)
            if p95 is None:
                return None
            return p95 / cfg.slo_answer_p95_s
        if slo == "degraded_rate":
            return degraded_rate_burn(self.cluster, window_s,
                                      cfg.slo_degraded_rate_max, now)
        if slo == "tick_stalls":
            rate = self.cluster.counter_rate(metric.RAFT_TICK_STALLS,
                                             window_s, now)
            if rate is None:
                return None
            budget_rate = cfg.slo_tick_stalls_max / cfg.duration_s
            return rate / budget_rate if budget_rate > 0 else 0.0
        raise ValueError(f"unknown continuous SLO {slo!r}")

    # ------------------------------------------------------- evaluation

    def evaluate(self, at_s: float, now: Optional[float] = None) -> None:
        """One evaluation round at offset `at_s` from workload start;
        `now` overrides the timeline queries' wall clock (tests feed
        synthetic timelines on a synthetic clock)."""
        self.evaluations += 1
        for slo in CONTINUOUS_SLOS:
            for wname, window_s in self.windows.items():
                burn = self._burn(slo, window_s, now)
                if burn is None:
                    continue
                self.windows_evaluated[slo] += 1
                self._update(slo, wname, window_s, burn, at_s)

    def _update(self, slo: str, wname: str, window_s: float,
                burn: float, at_s: float) -> None:
        key = (slo, wname)
        threshold = self.burn_thresholds[wname]
        active = self._active.get(key)
        if burn >= threshold:
            self._under[key] = 0
            self._over[key] = self._over.get(key, 0) + 1
            if active is not None:
                active.peak_burn = max(active.peak_burn, burn)
            elif self._over[key] >= self.sustain:
                alert = BurnAlert(slo=slo, window=wname,
                                  window_s=window_s,
                                  raised_at_s=at_s, peak_burn=burn)
                self._active[key] = alert
                self.alerts.append(alert)
                self.cluster.record_event(
                    "slo_alert_raised",
                    f"{slo} burn {burn:.2f} over {window_s:.1f}s "
                    f"({wname} window, threshold {threshold})",
                    at_s=round(at_s, 3), slo=slo, window=wname,
                )
                if self.metrics is not None:
                    self.metrics.inc(metric.SIM_BURN_ALERTS)
        else:
            self._over[key] = 0
            if active is not None:
                self._under[key] = self._under.get(key, 0) + 1
                if self._under[key] >= self.sustain:
                    active.cleared_at_s = at_s
                    del self._active[key]
                    self._under[key] = 0
                    self.cluster.record_event(
                        "slo_alert_cleared",
                        f"{slo} burn {burn:.2f} back under {threshold} "
                        f"({wname} window)",
                        at_s=round(at_s, 3), slo=slo, window=wname,
                    )

    # ----------------------------------------------------------- verdict

    def finish(self, fault_windows: Sequence[Tuple[float, float]],
               margin_before_s: float = 1.0,
               margin_after_s: Optional[float] = None) -> None:
        """Classify every alert against the injected-fault phases: an
        alert raised inside [start - margin_before, end + margin_after]
        of some fault phase is EXPECTED; anything else is a false alarm.
        The after-margin defaults to the slow window plus slack — a burn
        window legitimately keeps paging until the fault has slid out of
        it."""
        after = (margin_after_s if margin_after_s is not None
                 else self.windows[SLOW] + 2.0)
        for alert in self.alerts:
            alert.during_fault = any(
                t0 - margin_before_s <= alert.raised_at_s <= t1 + after
                for t0, t1 in fault_windows
            )

    def false_alarms(self) -> List[BurnAlert]:
        return [a for a in self.alerts if not a.during_fault]

    def report(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "windows_s": {k: round(v, 3) for k, v in self.windows.items()},
            "burn_thresholds": dict(self.burn_thresholds),
            "sustain": self.sustain,
            "evaluations": self.evaluations,
            "windows_evaluated": dict(self.windows_evaluated),
            "alerts": [a.to_dict() for a in self.alerts],
        }


# ===================================================== end-of-run checks


def evaluate_slos(
    cfg: SimConfig,
    node_metrics: Dict[int, Dict[str, Any]],
    node_health: Dict[int, Dict[str, Any]],
    sim_metrics: Dict[str, Any],
    ledger_report: Dict[str, Any],
    *,
    event_failures: Sequence[Dict[str, Any]] = (),
    traces: Sequence[Dict[str, Any]] = (),
    tutoring_metrics: Optional[Dict[str, Any]] = None,
    metrics: Optional[Metrics] = None,
    continuous: Optional[Dict[str, Any]] = None,
    fleet: Optional[Dict[str, Any]] = None,
    scoring: Optional[Dict[str, Any]] = None,
    groups: Optional[Dict[str, Any]] = None,
) -> SloReport:
    """`node_metrics`/`node_health`: node id -> scraped JSON snapshots of
    every node alive at the end of the run; `sim_metrics`: the harness's
    own Metrics snapshot; `ledger_report`: `WriteLedger.report()`;
    `event_failures`: the scheduler's `ok=False` outcomes; `traces`: the
    flight recorder's retained trace trees (per-stage breakdowns);
    `tutoring_metrics`: the tutoring node's serving-queue snapshot (the
    verdict carries its measured prefix_cache_hit_rate); `continuous`:
    the ContinuousSloEngine's report — when present, the in-run alert
    discipline becomes part of the verdict (windows really evaluated,
    zero false alarms)."""
    checks: List[SloCheck] = []

    def check(name: str, ok: bool, observed: str, bound: str) -> None:
        checks.append(SloCheck(name=name, ok=ok, observed=observed,
                               bound=bound))
        if not ok and metrics is not None:
            metrics.inc(metric.SIM_SLO_VIOLATIONS)

    losses = ledger_report["losses"]
    check("zero_acked_write_loss", not losses,
          f"{len(losses)} lost of {ledger_report['acked_writes']} acked"
          + (f": {losses[:3]}" if losses else ""), "0 lost")
    ryw = ledger_report["ryw_violations"]
    check("read_your_writes", not ryw,
          f"{len(ryw)} violations" + (f": {ryw[:3]}" if ryw else ""), "0")

    ask = snap_hist(sim_metrics, metric.SIM_ASK_LATENCY)
    client_p95 = ask.get("p95_s")
    check(
        "answer_p95_client", client_p95 is None
        or client_p95 <= cfg.slo_answer_p95_s,
        f"{client_p95 if client_p95 is not None else 'n/a'} s "
        f"({ask.get('count', 0)} asks)",
        f"<= {cfg.slo_answer_p95_s} s",
    )
    worst = 0.0
    for snap in node_metrics.values():
        hist = snap_hist(snap, metric.LLM_TTFT)
        worst = max(worst, float(hist.get("p95_s", 0.0)))
    check("answer_p95_nodes", worst <= cfg.slo_answer_p95_s,
          f"worst node llm_ttft p95 {worst:.3f} s",
          f"<= {cfg.slo_answer_p95_s} s")

    degraded = sum(snap_counter(s, metric.TUTORING_DEGRADED)
                   for s in node_metrics.values())
    requests = sum(snap_counter(s, metric.LLM_REQUESTS)
                   for s in node_metrics.values())
    rate = degraded / requests if requests else 0.0
    check("degraded_rate", rate <= cfg.slo_degraded_rate_max,
          f"{degraded}/{requests} = {rate:.3f}",
          f"<= {cfg.slo_degraded_rate_max}")

    open_breakers = {
        nid: h.get("tutoring_breaker", {}).get("state")
        for nid, h in node_health.items()
        if h.get("tutoring_breaker", {}).get("state") != "closed"
    }
    check("breakers_closed", not open_breakers,
          f"open: {open_breakers}" if open_breakers else "all closed",
          "closed on every node")

    stuck = sorted(
        set(
            [nid for nid, h in node_health.items()
             if h.get("storage_recovering")]
            + [nid for nid, s in node_metrics.items()
               if snap_gauge(s, metric.STORAGE_RECOVERING) > 0]
        )
    )
    check("no_stuck_storage_recovery", not stuck,
          f"recovering: {stuck}" if stuck else "none recovering", "none")

    stalls = sum(snap_counter(s, metric.RAFT_TICK_STALLS)
                 for s in node_metrics.values())
    check("tick_stalls", stalls <= cfg.slo_tick_stalls_max,
          f"{stalls} stalls summed", f"<= {cfg.slo_tick_stalls_max}")

    failed = [f"{o['kind']}: {o['detail']}" for o in event_failures]
    check("events_completed", not failed,
          f"{len(failed)} failed" + (f": {failed[:3]}" if failed else ""),
          "every planned event ok")

    # Resumable-stream / conversational-session verdicts. The digest
    # check is unconditional: the client verifies every completed stream
    # against the final chunk's answer digest, so ANY duplicated or
    # dropped token — including across a mid-stream failover — lands in
    # this counter (0 streams trivially passes).
    mismatches = snap_counter(sim_metrics, metric.SIM_STREAM_DIGEST_MISMATCH)
    streamed_turns = snap_counter(sim_metrics, metric.SIM_SESSION_TURNS)
    check("stream_digest_parity", mismatches == 0,
          f"{mismatches} digest mismatches over {streamed_turns} "
          "streamed turns",
          "0 — streams monotone, gap-free, duplicate-free")
    if round(cfg.session_fraction * cfg.students) >= 1:
        turns_failed = snap_counter(sim_metrics,
                                    metric.SIM_SESSION_TURNS_FAILED)
        check("session_turns_completed", streamed_turns >= 1,
              f"{streamed_turns} ok / {turns_failed} failed",
              ">= 1 streamed session turn completed")
        tt = snap_hist(sim_metrics, metric.SIM_TURN_TTFT)
        ttft_p95 = tt.get("p95_s")
        check(
            "turn_ttft_p95",
            ttft_p95 is None or ttft_p95 <= cfg.slo_turn_ttft_p95_s,
            f"{ttft_p95 if ttft_p95 is not None else 'n/a'} s "
            f"({tt.get('count', 0)} turns)",
            f"<= {cfg.slo_turn_ttft_p95_s} s",
        )
        if cfg.tutoring_engine == "tiny-paged" and streamed_turns >= 2:
            # Follow-up turns must actually splice the session prefix:
            # turn N+1 starts from turn N's published transcript blocks,
            # so the radix cache records hit tokens (> 0) for the chain.
            hit_tokens = snap_counter(tutoring_metrics or {},
                                      metric.PREFIX_CACHE_HIT_TOKENS)
            check("session_prefix_hits", hit_tokens > 0,
                  f"{hit_tokens} prefix-cache hit tokens",
                  "> 0 hit tokens across follow-up turns")

    if continuous is not None:
        evaluated = continuous.get("windows_evaluated", {})
        missing = [slo for slo in CONTINUOUS_SLOS
                   if not evaluated.get(slo)]
        check(
            "burn_windows_evaluated", not missing,
            f"evaluations per SLO: {evaluated}"
            + (f"; never evaluated: {missing}" if missing else ""),
            ">= 1 burn-rate window evaluated per SLO",
        )
        false_alarms = [a for a in continuous.get("alerts", [])
                        if not a.get("during_fault")]
        check(
            "no_false_alarms", not false_alarms,
            (f"{len(false_alarms)} alert(s) outside every fault phase: "
             f"{false_alarms[:3]}") if false_alarms
            else f"{len(continuous.get('alerts', []))} alert(s), all "
                 "inside fault phases",
            "every alert inside an injected-fault phase",
        )

    if fleet is not None:
        # Fleet verdicts (only when there IS a fleet, [sim]
        # tutoring_nodes > 1): the drills must leave measured evidence
        # — >=1 router spill and >=1 hedge win — and no node may end the
        # run stuck out of the ring (ejected/draining after settle means
        # a drain that never rejoined).
        if fleet.get("drills"):
            check("fleet_spill_observed", fleet.get("spills", 0) >= 1,
                  f"{fleet.get('spills', 0)} spills", ">= 1 router spill")
            check("fleet_hedge_win_observed",
                  fleet.get("hedge_wins", 0) >= 1,
                  f"{fleet.get('hedge_wins', 0)} hedge wins "
                  f"({fleet.get('hedges', 0)} hedged)",
                  ">= 1 hedged answer won")
            check("stream_resume_observed",
                  fleet.get("stream_resumes", 0) >= 1,
                  f"{fleet.get('stream_resumes', 0)} resumes "
                  f"({fleet.get('stream_stalls', 0)} stall trips)",
                  ">= 1 mid-stream failover resumed at its offset")
        stuck_nodes = [n["address"] for n in fleet.get("nodes", ())
                       if n.get("state") in ("draining", "ejected")]
        check("fleet_nodes_routable", not stuck_nodes,
              f"out of ring: {stuck_nodes}" if stuck_nodes
              else f"all {fleet.get('size', 0)} nodes routable",
              "no node left ejected/draining")

    if scoring is not None and scoring.get("expected"):
        # The bulk-grading night's completion claim: the background
        # tenant finished its job(s) in the idle lanes (the "p95
        # unchanged" half is enforced by no_false_alarms above — the
        # grading window is NOT a fault window, so a scoring-induced
        # burn alert fails the run).
        done = int(scoring.get("jobs_completed", 0))
        failed = int(scoring.get("jobs_failed", 0))
        check(
            "bulk_scoring_completed", done >= 1 and failed == 0,
            f"{done} completed / {failed} failed "
            f"({scoring.get('quanta', 0)} quanta, "
            f"{scoring.get('scored_tokens', 0)} tokens scored)",
            ">= 1 bulk job completed, 0 failed",
        )

    if groups is not None:
        # Sharded-control-plane verdicts ([sim] lms_groups > 1): every
        # Raft group must end the run with a leader (the per-group
        # leader-loss drill healed), and when a live split was planned
        # the routing map must have flipped — the staged handoff ran to
        # `done`, not just "was attempted". Zero acked-write loss ACROSS
        # the flip is already pinned by zero_acked_write_loss above: the
        # ledger tags every write with its owning group and the audit
        # re-reads the moved keys through the post-flip map.
        leaderless = sorted(
            gid for gid, nid in groups.get("leaders", {}).items()
            if nid is None
        )
        check(
            "groups_routable", not leaderless,
            f"leaderless groups: {leaderless}" if leaderless
            else (f"all {groups.get('n_groups', 0)} groups have leaders: "
                  f"{groups.get('leaders', {})}"),
            "a leader per Raft group",
        )
        digests = groups.get("replica_digests") or {}
        if digests:
            # The runtime face of the state-machine-determinism lint
            # rule: at settle, every replica of every group sat at the
            # same applied index with the same LMSState.digest chain
            # value — including group members restored mid-run via
            # InstallSnapshot during the split drill. A divergent digest
            # means some applier observed clock/RNG/iteration-order
            # nondeterminism the static rule could not see.
            diverged = sorted(
                gid for gid, rows in digests.get("groups", {}).items()
                if len({r.get("digest") for r in rows.values()}) > 1
            )
            check(
                "replicas_converged", bool(digests.get("converged")),
                (f"diverged/undrained groups: {diverged}" if diverged
                 else "digest audit did not converge") if not
                digests.get("converged") else
                ", ".join(
                    f"group {gid}: {len(rows)} replicas @ "
                    f"{next(iter(rows.values())).get('applied')} = "
                    f"{next(iter(rows.values())).get('digest')}"
                    for gid, rows in sorted(
                        digests.get("groups", {}).items()
                    )
                ),
                "identical per-group state digests at settle",
            )
        if groups.get("expected_reshard"):
            reshards = groups.get("reshards", [])
            version = int(
                groups.get("routing_map", {}).get("version", 1)
            )
            check(
                "reshard_completed", bool(reshards) and version > 1,
                f"{len(reshards)} reshard(s), map version {version}"
                + (f", {groups.get('acked_across_reshard', 0)} acked "
                   "writes crossed the boundary" if reshards else ""),
                ">= 1 completed handoff, routing map flipped",
            )

    hit_rate = snap_gauge(tutoring_metrics or {},
                          metric.PREFIX_CACHE_HIT_RATE, default=-1.0)
    return SloReport(
        checks=checks, stage_p95s=stage_breakdown(traces),
        prefix_cache_hit_rate=hit_rate if hit_rate >= 0 else None,
        continuous=continuous,
        fleet=fleet,
        scoring=scoring,
        groups=groups,
    )
