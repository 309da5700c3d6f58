"""Semester simulator CLI: one production scenario, one JSON verdict.

Boots the port's in-process LMS cluster (3 Raft nodes + the tutoring
fleet), drives a seeded semester of student traffic along a diurnal curve
while the operations schedule injects a chaos campaign, a TimeoutNow
rolling restart, a disk-fault storage-recovery quarantine, and a
membership add/remove — then audits the acked-write ledger and asserts
the SLOs from every node's /metrics and /healthz.

Prints ONE BENCH-schema JSON line (metric: semester_sim_ask_p95_s) with
the full story: per-event outcomes, SLO verdicts, ledger counts, and the
trace/event digests that make a failed seed replayable:

    python -m distributed_lms_raft_llm_tpu_torch.sim --device cpu
    python -m distributed_lms_raft_llm_tpu_torch.sim --seed 7 \\
        --duration 60 --students 48 --device cpu
    python -m distributed_lms_raft_llm_tpu_torch.sim \\
        --config configs/cluster.toml --engine tiny

The flags are `scripts/semester_sim.py`'s, plus `--device`: where the
"tiny" engine runs (`cuda`, the default, raises without a card; the echo
stand-in runs on no device). Exit status 0 only if every event executed
and every SLO held.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_lms_raft_llm_tpu_torch.sim",
        description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="TOML deployment file; its [sim] section seeds "
                         "the defaults, flags below override")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--students", type=int, default=None)
    ap.add_argument("--duration", type=float, default=None,
                    help="workload wall-clock seconds")
    ap.add_argument("--base-rate", type=float, default=None,
                    help="mean op arrival rate (ops/s)")
    ap.add_argument("--engine", choices=["echo", "tiny"], default=None,
                    help="tutoring engine: wire-complete echo stand-in "
                         "or the port's real tiny engine")
    ap.add_argument("--tutoring-nodes", type=int, default=None,
                    help="tutoring fleet size behind the routing tier "
                         "(> 1 adds the fleet drills: kill-one-of-N "
                         "blackout, drain-and-rejoin, autoscale)")
    ap.add_argument("--no-events", action="store_true",
                    help="pure-workload run (no operations schedule)")
    ap.add_argument("--keep-workdir", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the tiny tutoring engines (default "
                         "cuda; raises without a card)")
    return ap


def sim_config(args: argparse.Namespace):
    """The run's `SimConfig`: the file's [sim] (or the defaults) with the
    flags given on the command line applied."""
    from ..config import SimConfig, load_config

    cfg = load_config(args.config).sim if args.config else SimConfig()
    overrides = {}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.students is not None:
        overrides["students"] = args.students
    if args.duration is not None:
        overrides["duration_s"] = args.duration
    if args.base_rate is not None:
        overrides["base_rate"] = args.base_rate
    if args.engine is not None:
        overrides["tutoring_engine"] = args.engine
    if args.tutoring_nodes is not None:
        overrides["tutoring_nodes"] = args.tutoring_nodes
    if args.no_events:
        overrides["events"] = False
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from . import SemesterSim

    cfg = sim_config(args)
    workdir = tempfile.mkdtemp(prefix="semester_sim_")
    try:
        record = SemesterSim(cfg, workdir, device=args.device).run()
        print(json.dumps(record))
        ok = record["slos"]["ok"] and not [
            e for e in record["events"] if not e["ok"]
        ]
        return 0 if ok else 1
    finally:
        if args.keep_workdir:
            sys.stderr.write(f"workdir kept at {workdir}\n")
        else:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
