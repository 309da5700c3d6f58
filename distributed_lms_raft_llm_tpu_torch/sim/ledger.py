"""Client-side acked-write ledger: the Jepsen-style history auditor.

The port's copy of `distributed_lms_raft_llm_tpu/sim/ledger.py`,
its logic as it is.

Every write the cluster ACKed (quorum-committed, success on the wire) is
recorded with its ack timestamp and a content fingerprint. Two kinds of
checks consume the history:

- **in-run read-your-writes**: whenever a simulated client performs a
  read, every write acked BEFORE the read began must be visible in the
  response (reads are linearizable by default — a leadership fence runs
  before local state is served — so this is the per-run proof, not an
  assumption). Writes acked concurrently with the read are exempt.
- **end-of-run audit**: after the cluster settles and all faults clear, a
  fresh client re-reads everything; any acked write that cannot be found
  is an acked-write LOSS — the zero-loss SLO the whole fault arsenal is
  supposed to guarantee.

Blob content degrades legally to metadata-only while a replica's copy is
missing (fetch-on-miss budget exhausted), so in-run material reads check
presence always but bytes only when bytes came back; the final audit — no
faults, generous budget — requires the exact bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import metrics_registry as metric

USER = "user"
MATERIAL = "material"
ASSIGNMENT = "assignment"
GRADE = "grade"
QUERY = "query"


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class AckedWrite:
    kind: str
    key: Tuple[str, ...]      # e.g. ("student003", "hw.pdf")
    value: str                # content hash / grade / query text
    acked_at: float           # time.monotonic() when the ack arrived
    group: Optional[int] = None   # owning Raft group at ack time (sharded)


@dataclasses.dataclass(frozen=True)
class ReshardMark:
    """A routing-map flip the workload observed mid-run: every write
    acked before `at` whose `group` == `src` crossed the resharding
    boundary, and the end-of-run audit proving it present on the NEW
    owner is the zero-acked-write-loss evidence for the handoff."""
    course: str
    src: int
    dst: int
    version: int
    at: float


class WriteLedger:
    def __init__(self, metrics=None):
        self.metrics = metrics
        self._writes: List[AckedWrite] = []       # guarded-by: _lock
        self._violations: List[str] = []          # guarded-by: _lock
        self._losses: List[str] = []              # guarded-by: _lock
        self._reshards: List[ReshardMark] = []    # guarded-by: _lock
        self._replica_digests: Optional[Dict] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------------- recording

    def record(self, kind: str, key: Tuple[str, ...], value: str = "",
               group: Optional[int] = None) -> None:
        """Call ONLY after the cluster acked the write. `group` tags the
        write with the Raft group that owned its subject at ack time (per
        the routing map the workload routed against), so the audit can
        show which acked writes crossed a later resharding boundary."""
        w = AckedWrite(kind=kind, key=key, value=value,
                       acked_at=time.monotonic(), group=group)
        with self._lock:
            self._writes.append(w)

    def note_reshard(self, course: str, src: int, dst: int,
                     version: int) -> None:
        """Mark a completed routing-map flip (group split/merge)."""
        with self._lock:
            self._reshards.append(ReshardMark(
                course=course, src=src, dst=dst, version=version,
                at=time.monotonic(),
            ))

    def note_replica_digests(self, doc: Optional[Dict]) -> None:
        """Record the settle-time cross-replica digest audit (harness
        `_collect_replica_digests`): per group, every live replica's
        (applied index, state digest). Divergence here is the runtime
        face of state-machine nondeterminism — the replicas_converged
        SLO fails the run on it."""
        with self._lock:
            self._replica_digests = doc

    def acked_before(self, t0: float, kind: str) -> List[AckedWrite]:
        with self._lock:
            return [w for w in self._writes
                    if w.kind == kind and w.acked_at < t0]

    @property
    def acked_count(self) -> int:
        with self._lock:
            return len(self._writes)

    # ------------------------------------------------- in-run read-your-writes

    def _violation(self, msg: str) -> None:
        with self._lock:
            self._violations.append(msg)
        if self.metrics is not None:
            self.metrics.inc(metric.SIM_RYW_VIOLATIONS)

    def check_materials_read(
        self, t0: float, seen: Dict[str, bytes], reader: str
    ) -> None:
        """`seen`: filename -> returned bytes (may be empty: legal
        metadata-only degradation while a blob heals)."""
        for w in self.acked_before(t0, MATERIAL):
            filename = w.key[0]
            if filename not in seen:
                self._violation(
                    f"{reader}: material {filename!r} acked "
                    f"{t0 - w.acked_at:.2f}s before the read but missing"
                )
            elif seen[filename] and content_hash(seen[filename]) != w.value:
                self._violation(
                    f"{reader}: material {filename!r} bytes differ from "
                    "the acked upload"
                )

    def check_grade_read(self, t0: float, response: str, student: str) -> None:
        acked = self.acked_before(t0, GRADE)
        mine = [w for w in acked if w.key[0] == student]
        if mine and "no grade" in response.lower():
            self._violation(
                f"{student}: grade acked before the read but the read "
                f"says {response!r}"
            )

    def check_responses_read(self, t0: float, texts: List[str],
                             student: str) -> None:
        """Answered-or-queued visibility is audited at the END (a query
        may legitimately sit unanswered mid-run); in-run we only require
        that responses the student saw once never disappear — covered by
        the final audit against the full history, so this records
        nothing today and exists as the read hook for future checks."""

    # -------------------------------------------------------- end-of-run audit

    def _loss(self, msg: str) -> None:
        with self._lock:
            self._losses.append(msg)
        if self.metrics is not None:
            self.metrics.inc(metric.SIM_ACKED_WRITE_LOSSES)

    def audit(self, *, users: Dict[str, str], materials: Dict[str, bytes],
              assignments: Dict[str, List[str]],
              grades: Dict[str, str], queries: List[Tuple[str, str]]) -> None:
        """Compare the final cluster state (read through a fresh client
        with no faults active) against every acked write.

        `users`: username -> role for accounts that could log in;
        `materials`: filename -> bytes; `assignments`: student ->
        filenames; `grades`: student -> displayed grade; `queries`:
        (student, query) pairs present on the instructor queue or already
        answered."""
        with self._lock:
            writes = list(self._writes)
        acked_grades: Dict[str, List[str]] = {}
        for w in writes:
            if w.kind == USER and w.key[0] not in users:
                self._loss(f"user {w.key[0]!r} acked but cannot log in")
            elif w.kind == MATERIAL:
                data = materials.get(w.key[0])
                if data is None:
                    self._loss(f"material {w.key[0]!r} acked but absent")
                elif content_hash(data) != w.value:
                    self._loss(f"material {w.key[0]!r} bytes differ from "
                               "the acked upload")
            elif w.kind == ASSIGNMENT:
                student, filename = w.key
                if filename not in assignments.get(student, []):
                    self._loss(f"assignment {filename!r} of {student} "
                               "acked but absent")
            elif w.kind == GRADE:
                acked_grades.setdefault(w.key[0], []).append(w.value)
            elif w.kind == QUERY:
                if (w.key[0], w.value) not in queries:
                    self._loss(f"query {w.value!r} by {w.key[0]} acked "
                               "but on no queue")
        for student, values in acked_grades.items():
            # Grades overwrite each other and concurrent acks leave the
            # winner ambiguous client-side, so the surviving grade must be
            # SOME acked grade — "No grade assigned" after an ack is loss.
            shown = grades.get(student, "")
            if not any(v in shown for v in values):
                self._loss(f"grades {values} of {student} acked but the "
                           f"cluster shows {shown!r}")

    # ---------------------------------------------------------------- report

    def report(self) -> Dict:
        with self._lock:
            by_group: Dict[str, int] = {}
            for w in self._writes:
                if w.group is not None:
                    label = f"group{w.group}"
                    by_group[label] = by_group.get(label, 0) + 1
            crossed = sum(
                1 for w in self._writes for r in self._reshards
                if w.group == r.src and w.acked_at < r.at
            )
            out = {
                "acked_writes": len(self._writes),
                "ryw_violations": list(self._violations),
                "losses": list(self._losses),
            }
            if by_group or self._reshards:
                out["acked_by_group"] = by_group
                out["reshards"] = [
                    {"course": r.course, "src": r.src, "dst": r.dst,
                     "version": r.version}
                    for r in self._reshards
                ]
                # Writes whose owning group changed under them: the
                # population the final audit certifies as lossless
                # across the handoff.
                out["acked_across_reshard"] = crossed
            if self._replica_digests is not None:
                out["replica_digests"] = self._replica_digests
            return out
