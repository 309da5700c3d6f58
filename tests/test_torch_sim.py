"""The port's semester simulator (`sim/`, `utils/scrape.py`,
`utils/locks.py`, the `[sim]` section) against the JAX package's.

- Parity, exact: for seeds 0 and 7, a sharded fleet config and
  configs/cluster.toml's `[sim]`, the port's op trace (`trace_digest`,
  op keys) and event schedule (`plan_events` keys) equal the JAX
  package's; `[sim]` read from both deployment files gives equal
  `SimConfig`s field for field; `ClusterScraper` fed one scripted
  snapshot sequence (restarts, an unreachable round, worst-node flips)
  exports the same document; `evaluate_slos` on the same inputs gives
  the same report, passing and failing; `ContinuousSloEngine` over one
  scripted cluster timeline raises, clears and reports the same alerts;
  one scripted acquisition sequence (nesting, a cycle closed on a second
  thread, a re-entry) leaves the same lock graph and violations in both
  `utils/locks.py`.
- A short CPU sim with `tutoring_engine = "tiny-paged"` on
  `device="cpu"`, no events: the port's `PagedEngine` (not echo) answered
  and the verdict is ok; the CLI runs an echo semester and exits 0.

Carried (`torch_carry.py`, as `test_port_<file>_<case>`, with
`analysis.*` the JAX package's): `tests/test_semester_sim.py` but its
sharded cases (`tests/test_torch_sim_groups.py` carries those, so
`--dist loadfile` runs the two sims on two workers), the slow soak kept
`slow`; `tests/test_timeline.py`'s quantile, timeline, sampler, scraper,
burn-engine, config and Prometheus-endpoint cases. Not carried from
`tests/test_timeline.py`: `test_render_prometheus_round_trip` (it reads
`metrics_registry.spec()`, which the port's registry, a `SPECS` table,
does not have; `tests/test_torch_tutoring_server.py` holds the port's
exposition equal to the JAX package's); the sampler's wall-clock cost
bound, `test_timeline_sampler_overhead_bound` (the port's sampler, the
same logic, read 0.25 ms a sample alone and once 91.7 ms under six
workers beside four semesters on eight cores; the JAX package's case
keeps the bound); and the capacity-model and trace-report cases
(`test_fit_capacity_*`, `test_capacity_cli_over_bench_record`,
`test_trace_report_stage_diff`), which test `scripts/` alone and reach
no module of either package's sim; the carried
`test_timeline_export_feeds_capacity_model` feeds the port's export to
that script. The port's two repairs over the JAX package's are tested
here too: the stream-kill drill probes a session whose resume path stays
on one engine, and the lock auditor bumps its sink outside its state
lock.
"""

import dataclasses
import json
import threading
from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_carry import carry, carried_cases

from distributed_lms_raft_llm_tpu import config as jax_config
from distributed_lms_raft_llm_tpu import sim as jax_sim
from distributed_lms_raft_llm_tpu.sim import slo as jax_slo
from distributed_lms_raft_llm_tpu.utils import locks as jax_locks
from distributed_lms_raft_llm_tpu.utils import scrape as jax_scrape
from distributed_lms_raft_llm_tpu.utils import timeline as jax_timeline
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch import config
from distributed_lms_raft_llm_tpu_torch import sim
from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
from distributed_lms_raft_llm_tpu_torch.sim import cluster as sim_cluster
from distributed_lms_raft_llm_tpu_torch.sim import slo
from distributed_lms_raft_llm_tpu_torch.utils import locks, scrape, timeline
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

# The port's sim and everything it reads; `analysis.*` stays the JAX
# package's (the lock-graph case's static half).
_PORT = ("config", "sim", "utils")
_SEMESTER = carry("test_semester_sim", modules=_PORT)
_SHARDED = {name for name in vars(_SEMESTER)
            if name.startswith("test_sharded_")} | {"groups_run"}
globals().update(carried_cases(_SEMESTER, "port_semester_sim",
                               skip=_SHARDED))
globals().update(carried_cases(
    carry("test_timeline", modules=_PORT), "port_timeline",
    skip=("test_render_prometheus_round_trip",
          "test_timeline_sampler_overhead_bound",
          "test_fit_capacity_finds_the_slo_knee",
          "test_fit_capacity_unsaturated_is_a_lower_bound",
          "test_capacity_cli_over_bench_record",
          "test_trace_report_stage_diff")))

REPO = Path(__file__).resolve().parent.parent
CLUSTER_TOML = str(REPO / "configs" / "cluster.toml")


# ------------------------------------------------------ pure functions

CONFIGS = {
    "seed0": dict(seed=0),
    "seed7": dict(seed=7),
    "seed7_fleet_groups": dict(seed=7, tutoring_nodes=3, lms_groups=2,
                               course_concentration=0.6),
    "cluster_toml": None,
}


def _both(kwargs):
    if kwargs is None:
        return (config.load_config(CLUSTER_TOML).sim,
                jax_config.load_config(CLUSTER_TOML).sim)
    return config.SimConfig(**kwargs), jax_config.SimConfig(**kwargs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trace_and_schedule_equal_the_jax_packages(name):
    port_cfg, jax_cfg = _both(CONFIGS[name])
    ops = sim.WorkloadGenerator(port_cfg).ops()
    ref = jax_sim.WorkloadGenerator(jax_cfg).ops()
    assert [o.key() for o in ops] == [o.key() for o in ref]
    assert sim.trace_digest(ops) == jax_sim.trace_digest(ref)
    events = [e.key() for e in sim.plan_events(port_cfg)]
    assert events == [e.key() for e in jax_sim.plan_events(jax_cfg)]
    assert ops and events


def test_sim_section_equals_the_jax_packages_field_for_field():
    for path in (CLUSTER_TOML, str(REPO / "configs" / "dev.toml")):
        port_cfg = config.load_config(path).sim
        jax_cfg = jax_config.load_config(path).sim
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert ([f.name for f in dataclasses.fields(config.SimConfig)]
            == [f.name for f in dataclasses.fields(jax_config.SimConfig)])
    assert dataclasses.asdict(config.SimConfig()) == dataclasses.asdict(
        jax_config.SimConfig())
    for engine in ("echo", "tiny", "tiny-paged"):
        assert config.SimConfig(tutoring_engine=engine)
    for bad in ("gpt2", "paged", ""):
        for cls in (config.SimConfig, jax_config.SimConfig):
            with pytest.raises(ValueError, match="tutoring_engine"):
                cls(tutoring_engine=bad)


# ------------------------------------------------------ cluster scraper


def _scrape_script():
    """Per poll, each source's snapshot (None = unreachable): counters
    rising with a restart, gauges, histograms whose worst node flips."""
    polls = []
    for i in range(8):
        a = {"counters": {"llm_requests": 100 + 7 * i,
                          "tutoring_degraded": i // 3},
             "gauges": {"serving_queue_depth": float(i % 3)},
             "latency": {"llm_ttft": {"count": 10 + 2 * i,
                                      "p95_s": 0.1 * (i % 4),
                                      "p50_s": 0.05}}}
        b_count = 5 + 3 * i if i < 4 else 3 * (i - 4)  # b restarted at 4
        b = {"counters": {"llm_requests": b_count, "gate_reject": i},
             "gauges": {"serving_queue_depth": 1.5,
                        "storage_recovering": 1.0 if i == 4 else 0.0},
             "latency": {"llm_ttft": {"count": b_count,
                                      "p95_s": 0.35 - 0.04 * i}}}
        c = None if i in (2, 5) else {
            "counters": {"llm_requests": 50 + i},
            "latency": {"sim_ask_latency": {"count": i, "p95_s": 0.2}}}
        polls.append({"a": a, "b": b, "c": c})
    return polls


def test_cluster_scraper_export_equals_the_jax_packages():
    exports = []
    for mod in (scrape, jax_scrape):
        polls = _scrape_script()
        state = {"i": 0}
        scraper = mod.ClusterScraper(sources={
            name: (lambda name=name: polls[state["i"]][name])
            for name in ("a", "b", "c")})
        for i in range(len(polls)):
            state["i"] = i
            scraper.poll(now=5000.0 + 0.5 * i)
        scraper.cluster.record_event("slo_alert_raised", "burst",
                                     t=5001.0, window="fast")
        exports.append(scraper.export())
    assert exports[0] == exports[1]
    assert exports[0]["node_count"] == 3
    assert len(exports[0]["cluster"]["points"]) == 8


def test_sources_fn_and_http_source_match_the_jax_packages():
    """Sources re-resolved each poll (membership changes mid-run) and an
    unreachable URL read as None, not an exception, in both."""
    exports = []
    for mod in (scrape, jax_scrape):
        sources = {"x": lambda: {"counters": {"llm_requests": 3}}}
        scraper = mod.ClusterScraper(sources_fn=lambda: dict(sources))
        scraper.poll(now=1.0)
        sources["y"] = mod.http_source("http://127.0.0.1:9/metrics",
                                       timeout_s=0.2)
        scraper.poll(now=2.0)
        exports.append((scraper.export(), dict(scraper.unreachable)))
    assert exports[0] == exports[1]
    assert exports[0][1] == {"y": 1}


# ------------------------------------------------------ SLO verdicts


def _traces():
    return [{"trace_id": "t1", "route": "client.ask_llm", "flags": [],
             "duration_s": 1.2, "spans": [
                 {"name": "client.ask_llm", "duration_s": 1.2, "children": [
                     {"name": "raft.commit", "duration_s": 0.01,
                      "children": []},
                     {"name": "tutoring.forward", "duration_s": 1.1,
                      "children": [{"name": "queue.wait",
                                    "duration_s": 0.2, "children": []}]}]}]},
            {"trace_id": "t2", "route": "client.ask_llm", "flags": ["slow"],
             "duration_s": 0.4, "spans": [
                 {"name": "client.ask_llm", "duration_s": 0.4,
                  "children": [{"name": "raft.commit", "duration_s": 0.03,
                                "children": []}]}]}]


def _slo_inputs(failing: bool):
    nodes = {1: {"counters": {"llm_requests": 40, "tutoring_degraded":
                              30 if failing else 3,
                              "raft_tick_stalls": 60 if failing else 2},
                 "latency": {"llm_ttft": {"count": 40, "p95_s":
                                          9.0 if failing else 1.5}},
                 "gauges": {"storage_recovering": 0.0}},
             2: {"counters": {"llm_requests": 5},
                 "gauges": {"storage_recovering": 1.0 if failing else 0.0}}}
    health = {1: {"tutoring_breaker": {"state": "closed"}},
              2: {"tutoring_breaker": {"state": "open" if failing
                                       else "closed"},
                  "storage_recovering": failing}}
    sim_metrics = {"counters": {"sim_session_turns": 4,
                                "sim_session_turns_failed": 1,
                                "sim_stream_digest_mismatch":
                                    1 if failing else 0},
                   "latency": {"sim_ask_latency": {"count": 30, "p95_s":
                                                   7.5 if failing else 2.0},
                               "sim_turn_ttft": {"count": 4, "p95_s": 0.8}}}
    ledger = {"acked_writes": 50,
              "losses": [{"kind": "grade", "key": ["s1"]}] if failing else [],
              "ryw_violations": ["s2 read stale"] if failing else []}
    continuous = {"enabled": True,
                  "windows_evaluated": {"answer_p95": 3, "degraded_rate": 4,
                                        "tick_stalls": 0 if failing else 4},
                  "alerts": [{"slo": "degraded_rate", "window": "fast",
                              "during_fault": not failing}]}
    fleet = {"size": 3, "drills": True, "spills": 0 if failing else 2,
             "hedges": 3, "hedge_wins": 1, "stream_resumes": 1,
             "stream_stalls": 0,
             "nodes": [{"address": "127.0.0.1:1", "state": "ok"},
                       {"address": "127.0.0.1:2",
                        "state": "ejected" if failing else "warming"}]}
    scoring = {"expected": True, "jobs_completed": 0 if failing else 1,
               "jobs_failed": 0, "quanta": 5, "scored_tokens": 900}
    groups = {"n_groups": 2, "leaders": {0: 1, 1: None if failing else 2},
              "expected_reshard": True,
              "reshards": [] if failing else [{"src": 0, "dst": 1}],
              "routing_map": {"version": 1 if failing else 2},
              "acked_across_reshard": 4,
              "replica_digests": {"converged": not failing, "groups": {
                  "0": {"1": {"applied": 9, "digest": "ab"},
                        "2": {"applied": 9, "digest":
                              "cd" if failing else "ab"}}}}}
    return dict(node_metrics=nodes, node_health=health,
                sim_metrics=sim_metrics, ledger_report=ledger,
                event_failures=([{"kind": "quarantine", "detail": "stuck"}]
                                if failing else []),
                traces=_traces(),
                tutoring_metrics={"counters": {"prefix_cache_hit_tokens": 7},
                                  "gauges": {"prefix_cache_hit_rate": 0.25}},
                continuous=continuous, fleet=fleet, scoring=scoring,
                groups=groups)


@pytest.mark.parametrize("failing", [False, True])
@pytest.mark.parametrize("engine", ["echo", "tiny-paged"])
def test_evaluate_slos_equals_the_jax_packages(failing, engine):
    reports, counts = [], []
    for cfg_mod, slo_mod, metrics_cls in (
            (config, slo, Metrics), (jax_config, jax_slo, JaxMetrics)):
        cfg = cfg_mod.SimConfig(tutoring_engine=engine, students=8)
        inputs = _slo_inputs(failing)
        metrics = metrics_cls()
        report = slo_mod.evaluate_slos(
            cfg, inputs.pop("node_metrics"), inputs.pop("node_health"),
            inputs.pop("sim_metrics"), inputs.pop("ledger_report"),
            metrics=metrics, **inputs)
        reports.append(report.to_dict())
        counts.append(metrics.snapshot()["counters"])
    assert reports[0] == reports[1]
    assert counts[0] == counts[1]
    assert reports[0]["ok"] is (not failing)
    assert slo.stage_breakdown(_traces()) == jax_slo.stage_breakdown(
        _traces())


def test_continuous_engine_equals_the_jax_packages():
    """One scripted cluster timeline (healthy, a degraded blackout, tick
    stalls, recovery) through both engines, evaluated at the same
    instants: the same alerts, windows and report."""
    reports = []
    for cfg_mod, slo_mod, tl_mod, metrics_cls in (
            (config, slo, timeline, Metrics),
            (jax_config, jax_slo, jax_timeline, JaxMetrics)):
        cfg = cfg_mod.SimConfig(duration_s=16.0)
        cluster = tl_mod.Timeline()
        sim_metrics, harness_metrics = metrics_cls(), metrics_cls()
        eng = slo_mod.ContinuousSloEngine(
            cfg, cluster, sim_metrics, metrics=harness_metrics,
            fast_window_s=1.0, slow_window_s=4.0)
        req = deg = stalls = 0
        for i in range(40):
            req += 3
            deg += 3 if 10 <= i < 18 else 0
            stalls += 2 if 22 <= i < 26 else 0
            t = 7000.0 + 0.25 * i
            cluster.append({"counters": {
                "llm_requests": req, "tutoring_degraded": deg,
                "gate_reject": i // 5, "raft_tick_stalls": stalls}}, t=t)
            eng.evaluate(at_s=0.25 * i, now=t)
        eng.finish([(2.5, 4.5)])
        reports.append((eng.report(), eng.false_alarms() and [
            a.to_dict() for a in eng.false_alarms()],
            harness_metrics.snapshot()["counters"],
            [e["kind"] for e in cluster.events()]))
    assert reports[0] == reports[1]
    assert reports[0][0]["alerts"], "the blackout raised no alert"


# ------------------------------------------------------ lock graph


class _Sink:
    """A duck-typed metrics sink without a lock of its own (the auditor
    calls it while holding its state lock)."""

    def __init__(self):
        self.counters = {}

    def inc(self, name, amount=1):
        self.counters[name] = self.counters.get(name, 0) + amount


def _lock_script(mod):
    """Nesting A -> B -> C, a second thread closing C -> A (a cycle), a
    non-blocking re-entry of B; the graph, violations and sink counts."""
    mod.reset()
    sink = _Sink()
    mod.set_metrics_sink(sink)
    a, b, c = (mod.make_lock(f"{n}._lock") for n in ("Alpha", "Beta",
                                                    "Gamma"))
    try:
        with mod.recording():
            with a:
                with b:
                    with c:
                        pass

            def closer():
                with c:
                    with a:
                        pass

            t = threading.Thread(target=closer)
            t.start()
            t.join()
            with b:
                reentered = b.acquire(blocking=False)
        edges = mod.acquisition_edges()
        violations = mod.violations()
        try:
            mod.assert_acyclic()
            acyclic = True
        except AssertionError:
            acyclic = False
        return (sorted(edges), violations, reentered, acyclic,
                sink.counters, repr(a))
    finally:
        mod.set_metrics_sink(None)
        mod.reset()


def test_lock_graph_and_violations_equal_the_jax_packages():
    port, ref = _lock_script(locks), _lock_script(jax_locks)
    assert port == ref
    edges, violations, reentered, acyclic, counts, _ = port
    assert ("Gamma._lock", "Alpha._lock") in edges and not acyclic
    assert not reentered
    assert any(v.startswith("cycle closed by") for v in violations)
    assert any(v.startswith("re-entry:") for v in violations)
    assert counts["lock_order_violations"] == len(violations)


def test_port_locks_carry_the_jax_declaration_names():
    """The port's breaker and metrics locks are named as the JAX package
    declares them, so the carried lock-graph case lines the runtime
    graph up with the static one."""
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import (
        LatencyHistogram,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.resilience import (
        CircuitBreaker,
    )

    assert CircuitBreaker()._lock.name == "CircuitBreaker._lock"
    assert Metrics()._lock.name == "Metrics._lock"
    assert LatencyHistogram()._lock.name == "LatencyHistogram._lock"


# ------------------------------------------------------ CPU sims


def test_tiny_paged_cpu_sim_answers_through_the_ports_paged_engine(
        tmp_path, monkeypatch):
    built = []
    real = sim_cluster.SimCluster._tiny_engine

    def capture(self):
        engine = real(self)
        built.append(engine)
        return engine

    monkeypatch.setattr(sim_cluster.SimCluster, "_tiny_engine", capture)
    cfg = config.SimConfig(
        seed=3, students=6, instructors=1, courses=2, duration_s=6.0,
        base_rate=4.0, workers=3, events=False, tutoring_nodes=1,
        tutoring_engine="tiny-paged", course_concentration=0.6,
        bulk_scoring=False, slo_answer_p95_s=8.0)
    record = sim.SemesterSim(cfg, str(tmp_path), device="cpu").run()
    assert record["slos"]["ok"], {k: v for k, v in
                                  record["slos"]["checks"].items()
                                  if not v["ok"]}
    assert len(built) == 1 and isinstance(built[0], PagedEngine)
    engine = built[0]
    assert engine.device.type == "cpu" and engine.config.model == "tiny"
    assert engine.total_generated_tokens > 0
    assert record["asks"] >= 1 and record["degraded_answers"] == 0
    # only a paged engine with the radix cache reports a hit rate
    assert record["prefix_cache_hit_rate"] is not None


def test_cli_runs_an_echo_semester(capsys):
    from distributed_lms_raft_llm_tpu_torch.sim import __main__ as cli

    rc = cli.main(["--device", "cpu", "--seed", "2", "--students", "3",
                   "--duration", "3", "--base-rate", "3",
                   "--tutoring-nodes", "1", "--no-events"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["metric"] == "semester_sim_ask_p95_s"
    assert record["seed"] == 2 and record["students"] == 3
    assert record["tutoring_engine"] == "echo" and record["events"] == []
    args = cli.build_parser().parse_args(["--config", CLUSTER_TOML,
                                          "--engine", "tiny"])
    cfg = cli.sim_config(args)
    assert cfg == dataclasses.replace(
        config.load_config(CLUSTER_TOML).sim, tutoring_engine="tiny")


def test_engine_factory_serves_on_tutoring_node_0(tmp_path):
    """The one engine seam: a factory's warmed engine serves on node 0 in
    place of the configured echo stand-in, and the cluster does not warm
    it again (a one-node fleet, so every ask reaches it)."""
    import torch

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    built, submitted = [], []

    def factory():
        engine = PagedEngine(
            EngineConfig(model="tiny", device="cpu", dtype=torch.float32,
                         sampling=SamplingParams(max_new_tokens=8),
                         length_buckets=(16, 32), batch_buckets=(1, 2, 4)),
            slots=4, chunk=4, prefix_cache=True, prefix_cache_blocks=64,
            prefix_block_tokens=8, prefill_chunk_tokens=8)
        engine.warmup()
        real_submit = engine.submit
        engine.warmup = None  # a second warmup would fail here

        def submit(prompt):
            submitted.append(prompt)
            return real_submit(prompt)

        engine.submit = submit
        built.append(engine)
        return engine

    cfg = config.SimConfig(
        seed=5, students=6, instructors=1, courses=2, duration_s=5.0,
        base_rate=4.0, workers=3, events=False, tutoring_nodes=1,
        course_concentration=0.6, bulk_scoring=False,
        slo_answer_p95_s=8.0)
    assert cfg.tutoring_engine == "echo"
    record = sim.SemesterSim(cfg, str(tmp_path),
                             tutoring_engine_factory=factory).run()
    assert record["slos"]["ok"], {k: v for k, v in
                                  record["slos"]["checks"].items()
                                  if not v["ok"]}
    assert len(built) == 1 and submitted
    assert built[0].total_generated_tokens > 0


def test_a_violation_with_a_metrics_sink_does_not_wedge_the_thread():
    """The port's auditor bumps its sink with the state lock released: a
    `Metrics` sink (whose own lock is a named one) counts a recorded
    re-entry. The JAX package's auditor calls the sink under its state
    lock, so the same script wedges its thread (not run here)."""
    sink = Metrics()
    lock = locks.make_lock("Delta._lock")
    done = []

    def script():
        with locks.recording():
            with lock:
                done.append(lock.acquire(blocking=False))

    locks.reset()
    locks.set_metrics_sink(sink)
    try:
        t = threading.Thread(target=script, daemon=True)
        t.start()
        t.join(10.0)
        assert not t.is_alive(), "recording a violation wedged the thread"
        assert done == [False]
        assert [v.split(":")[0] for v in locks.violations()] == ["re-entry"]
        assert sink.snapshot()["counters"]["lock_order_violations"] == 1
    finally:
        locks.set_metrics_sink(None)
        locks.reset()


class _DrillCluster:
    """Just enough of `SimCluster` for the stream-kill drill: a leader,
    each probe session's route over three tutoring nodes (`routes`:
    session id -> node order, else 0, 1, 2), each node's engine as its
    /healthz names it, admin POSTs recorded, and a fleet
    `stream_resumes` counter that moves once the fault is installed."""

    def __init__(self, engines, routes, open_=()):
        self.engines, self.routes, self.posts = engines, routes, []
        self.open = set(open_)

    def healthz(self, nid):
        return {"tutoring_fleet": {"nodes": [
            {"address": f"a{i}", "breaker": {
                "state": "open" if i in self.open else "closed"}}
            for i in range(len(self.engines))]}}

    def wait_leader(self, timeout):
        return 1

    def node_ids(self):
        return [1]

    def admin_get(self, nid, path):
        session = path.split("session=", 1)[1]
        order = self.routes.get(session, list(range(len(self.engines))))
        return {"order": [{"index": i, "address": f"a{i}", "state": "ok"}
                          for i in order]}

    def tutoring_healthz(self, idx):
        return {"ok": True, "engine": self.engines[idx]}

    def admin_post(self, nid, path, body):
        self.posts.append(body)
        return {"ok": True}

    def metrics_snapshot(self, nid):
        return {"counters": {"stream_resumes": len(self.posts)}}


SID = "ops-bot-stream-drill"


ECHO, PAGED = "EchoEngine", "PagedEngine"


@pytest.mark.parametrize("engines,routes,open_,session,target", [
    # one engine everywhere: the JAX package's session and target
    ([ECHO] * 3, {SID: [1, 0, 2]}, (), SID, 1),
    # the real engine leads the session's route: the first variant whose
    # affinity node and spill candidate are both echo
    ([PAGED, ECHO, ECHO],
     {SID: [0, 1, 2], SID + "-1": [1, 0, 2], SID + "-2": [2, 1, 0]}, (),
     SID + "-2", 2),
    # the real engine is the spill candidate
    ([PAGED, ECHO, ECHO], {SID: [2, 0, 1], SID + "-1": [1, 2, 0]}, (),
     SID + "-1", 1),
    # an open breaker moves the resume target one node down the route
    ([PAGED, ECHO, ECHO, ECHO],
     {SID: [1, 2, 0, 3], SID + "-1": [1, 3, 2, 0]}, (2,), SID + "-1", 1),
    # ... and the primary, when it is the affinity node's
    ([PAGED, ECHO, ECHO, ECHO], {SID: [2, 1, 3, 0]}, (2,), SID, 1),
])
def test_stream_kill_drill_keeps_the_resume_on_one_engine(
        engines, routes, open_, session, target):
    """The port's repair of the stream-kill drill: its probe session is
    the first of the JAX package's session id and its numbered variants
    whose affinity node and first spill candidate serve the same engine,
    since a resume splices the spill node's regeneration onto the
    delivered prefix; the loss goes on that session's affinity node."""
    probes = []
    cluster = _DrillCluster(engines, routes, open_)
    scheduler = sim.events.OperationsScheduler(
        cluster, [], streamer=lambda s=SID: probes.append(s) or True)
    event = sim.SimEvent(at_s=0.0, kind=sim.events.TUTORING_STREAM_KILL,
                         params={"error_s": 0.3})
    detail = scheduler._tutoring_stream_kill(event)
    assert set(probes) == {session}
    [post] = cluster.posts
    assert [ph["target"] for ph in post["campaign"]["phases"]] == [
        f"tutoring:{target}"]
    assert f"tutoring:{target}" in detail
