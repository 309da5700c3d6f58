"""Semester simulator: one continuously-verified production scenario.

The robustness PRs built every primitive the deployment story needs —
chaos over real gRPC, disk-fault injection, crash-consistent storage with
rejoin-by-InstallSnapshot, breakers + degraded fallback, TimeoutNow
leadership transfer, runtime membership changes — but only as separate
tests. This package composes them into ONE Jepsen-style scenario:

- `workload`  — seeded deterministic trace of simulated students across
  courses following a diurnal load curve (the full op mix, including on-
  and off-topic `ask_llm`);
- `events`    — a seeded operations schedule injected mid-run (rolling
  restart via TimeoutNow transfer, a storage-recovery quarantine via the
  disk-fault admin plane, a membership add/remove, chaos campaigns via
  `POST /admin/faults`);
- `ledger`    — a client-side acked-write ledger proving zero acked-write
  loss and read-your-writes across the whole run;
- `slo`       — continuous fast/slow burn-rate SLO evaluation DURING the
  run (alerts classified against the fault schedule) plus the end-of-run
  assertions from `/metrics` + `/healthz`;
- `cluster`   — the in-process cluster under test (real gRPC, real admin
  plane, restartable nodes);
- `harness`   — `SemesterSim`, wiring it all together and emitting one
  BENCH-schema record (`python -m distributed_lms_raft_llm_tpu_torch.sim`,
  `__main__.py`).

Everything that decides WHAT happens (op trace, event schedule) is a pure
function of the seed, so a failed run replays from its seed; only the
interleaving with real sockets is nondeterministic.

The port's copy of `distributed_lms_raft_llm_tpu/sim/`: the same trace,
schedule, auditors and verdict over the port's LMS, router and tutoring
nodes; the "tiny"/"tiny-paged" tutoring engines are the port's, on the
card unless the caller passes `device="cpu"`.
"""

from ..config import SimConfig
from .cluster import SimCluster
from .events import SimEvent, plan_events
from .harness import SemesterSim
from .ledger import WriteLedger
from .slo import ContinuousSloEngine, SloReport, evaluate_slos
from .workload import SimOp, WorkloadGenerator, trace_digest

__all__ = [
    "SimConfig",
    "SimCluster",
    "SimEvent",
    "plan_events",
    "SemesterSim",
    "WriteLedger",
    "ContinuousSloEngine",
    "SloReport",
    "evaluate_slos",
    "SimOp",
    "WorkloadGenerator",
    "trace_digest",
]
