"""Seeded deterministic workload generator: a semester of LMS traffic.

The port's copy of `distributed_lms_raft_llm_tpu/sim/workload.py`,
its logic as it is.

Simulated students and instructors, grouped into courses, issue the full
op mix — material upload/download, assignment submit, grading, instructor
Q&A, and on-/off-topic `ask_llm` (exercising the relevance gate and the
degraded fallback) — along a diurnal load curve compressed into the run's
wall-clock duration.

Determinism is the contract: the trace is a pure function of `SimConfig`
(seed included), pinned by `trace_digest` and the seeded-determinism test,
so a failed sim run replays from its seed. Arrivals come from a thinned
nonhomogeneous Poisson process (exponential gaps at the peak rate, each
arrival kept with probability rate(t)/peak) — the standard construction
that keeps the RNG stream independent of float drift in the rate curve.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import random
from typing import Dict, List, Tuple

from ..config import SimConfig

# Op kinds, student-issued unless noted.
ASK_LLM_SESSION_CHAIN = "ask_llm_session_chain"
DOWNLOAD_MATERIAL = "download_material"
SUBMIT_ASSIGNMENT = "submit_assignment"
ASK_LLM_ON_TOPIC = "ask_llm_on_topic"
ASK_LLM_OFF_TOPIC = "ask_llm_off_topic"
ASK_INSTRUCTOR = "ask_instructor"
CHECK_GRADE = "check_grade"
READ_RESPONSES = "read_responses"
UPLOAD_MATERIAL = "upload_material"    # instructor
GRADE = "grade"                        # instructor

# (kind, weight): the steady-state mix. ask_llm dominates (it is the
# product's hot path and the SLO target); a sprinkle of off-topic asks
# exercises the gate; reads interleave so read-your-writes is audited
# continuously, not only at the end.
OP_MIX: Tuple[Tuple[str, float], ...] = (
    (ASK_LLM_ON_TOPIC, 0.30),
    (ASK_LLM_OFF_TOPIC, 0.06),
    (DOWNLOAD_MATERIAL, 0.14),
    (SUBMIT_ASSIGNMENT, 0.10),
    (ASK_INSTRUCTOR, 0.08),
    (CHECK_GRADE, 0.10),
    (READ_RESPONSES, 0.07),
    (UPLOAD_MATERIAL, 0.08),
    (GRADE, 0.07),
)

ON_TOPIC_QUERIES = (
    "How does Raft elect a leader after a partition heals?",
    "Why does log matching guarantee state machine safety?",
    "When is an entry committed under a changing membership?",
    "How does a leadership transfer avoid a full election timeout?",
    "What makes InstallSnapshot safe for a lagging follower?",
)
OFF_TOPIC_QUERIES = (
    "What is the best pizza topping?",
    "Who won the world cup in 1998?",
    "Write me a poem about the sea.",
)
# Follow-up turns of a streamed tutoring session: each rides the SAME
# session id, so the server splices the prior turns' transcript as the
# shared prompt prefix (session-pinned radix blocks).
FOLLOWUP_QUERIES = (
    "Can you elaborate on that point?",
    "What happens in the failure case?",
    "How does that interact with snapshots?",
    "Give a concrete example of that.",
)
ASSIGNMENT_TEXT = (
    "Homework: explain the Raft consensus algorithm - leader election, "
    "log replication, commitment, safety under partitions, leadership "
    "transfer, and cluster membership changes."
)


@dataclasses.dataclass(frozen=True)
class SimOp:
    """One scheduled client operation."""

    at_s: float          # offset from workload start (wall seconds)
    actor: str           # username
    role: str            # "student" | "instructor"
    kind: str
    course: str
    payload: Dict[str, str]

    def key(self) -> str:
        """Canonical line for digests/diffs (payloads are str->str)."""
        items = ",".join(f"{k}={v}" for k, v in sorted(self.payload.items()))
        return (f"{self.at_s:.6f}|{self.actor}|{self.role}|{self.kind}|"
                f"{self.course}|{items}")


def trace_digest(ops: List[SimOp]) -> str:
    """Stable digest of a trace — the replay fingerprint the BENCH record
    carries and the seeded-determinism test pins."""
    h = hashlib.sha256()
    for op in ops:
        h.update(op.key().encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


class WorkloadGenerator:
    """Pure function of the config: `ops()` returns the full trace."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.courses = [f"course{c}" for c in range(cfg.courses)]
        self.students = [f"student{i:03d}" for i in range(cfg.students)]
        self.instructors = [f"instructor{i}" for i in range(cfg.instructors)]

    def course_of(self, actor: str) -> str:
        """Static assignment: actors hash onto courses. With
        `course_concentration` > 0 the hash is skewed geometrically
        toward the first courses (1.0 = everyone on course0) — the
        same-course traffic regime the tutoring engine's shared-prefix
        KV cache targets. Still a pure function of the actor name, so
        the trace stays seed-deterministic."""
        h = int(hashlib.sha1(actor.encode()).hexdigest(), 16)
        c = self.cfg.course_concentration
        if c <= 0:
            return self.courses[h % len(self.courses)]
        weights = [(1.0 - c) ** i for i in range(len(self.courses))]
        u = (h % 10**9) / 10**9 * sum(weights)
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if u < acc:
                return self.courses[i]
        return self.courses[-1]

    def course_context(self, course: str) -> str:
        """The deterministic course/assignment context on-topic asks are
        prefixed with under `course_concentration` > 0: every student in
        a course asks against the SAME context text, so their prompts
        share the token prefix the radix cache prefills once. Caveat at
        sim scale: the tiny tutoring model's position table is narrower
        than this context, and the engine keeps a prompt's TAIL — so in
        the tiny-paged soak the measured hits come from students
        repeating the same course question verbatim (still the radix
        partial-prefill path); genuine cross-question context sharing is
        exercised with token-level control by bench.py's shared-prefix
        scenario and tests/test_prefix_cache.py."""
        return (f"{course} assignment context: {ASSIGNMENT_TEXT} "
                f"Course question: ")

    def rate(self, t_s: float) -> float:
        """Diurnal ops/s at offset `t_s`: `days` sine cycles compressed
        into `duration_s`, trough at the start (campus asleep), peak at
        midday; never fully zero so the auditors always have traffic."""
        cfg = self.cfg
        phase = 2.0 * math.pi * (t_s / cfg.duration_s) * cfg.days
        diurnal = 1.0 + cfg.diurnal_amplitude * math.sin(phase - math.pi / 2)
        return cfg.base_rate * max(0.05, diurnal)

    def peak_rate(self) -> float:
        return self.cfg.base_rate * (1.0 + abs(self.cfg.diurnal_amplitude))

    def ops(self) -> List[SimOp]:
        cfg = self.cfg
        rng = random.Random(cfg.seed)
        kinds = [k for k, _ in OP_MIX]
        weights = [w for _, w in OP_MIX]
        ops: List[SimOp] = []
        counters = {"material": 0, "submit": 0}
        peak = self.peak_rate()
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= cfg.duration_s:
                break
            if rng.random() > self.rate(t) / peak:
                continue  # thinned: below the diurnal envelope right now
            kind = rng.choices(kinds, weights=weights, k=1)[0]
            ops.append(self._op(kind, t, rng, counters))
        ops.extend(self._session_chains())
        ops.sort(key=lambda op: (op.at_s, op.actor, op.kind))
        return ops

    def _session_chains(self) -> List[SimOp]:
        """Conversational follow-up chains: `session_fraction` of the
        students each run ONE multi-turn streamed session (one op — the
        executor drives the turns sequentially, since turn N+1 needs
        turn N's transcript on the server). A separate seeded RNG stream
        keeps the Poisson trace untouched by the chain knobs."""
        cfg = self.cfg
        n = min(len(self.students),
                round(cfg.session_fraction * len(self.students)))
        if n <= 0 or cfg.session_turns < 1:
            return []
        srng = random.Random(cfg.seed ^ 0x5E5510)
        chains: List[SimOp] = []
        for i in range(n):
            actor = self.students[i * len(self.students) // n]
            course = self.course_of(actor)
            first = srng.choice(ON_TOPIC_QUERIES)
            if cfg.course_concentration > 0:
                first = self.course_context(course) + first
            queries = [first] + [
                srng.choice(FOLLOWUP_QUERIES)
                for _ in range(cfg.session_turns - 1)
            ]
            # Chains start in the first 60% of the run so every turn —
            # each bounded by llm_budget_s — can finish inside it.
            at = srng.uniform(0.05, 0.60) * cfg.duration_s
            chains.append(SimOp(
                at_s=at, actor=actor, role="student",
                kind=ASK_LLM_SESSION_CHAIN, course=course,
                payload={"session": f"{actor}-chain{i}",
                         "queries": "\x1f".join(queries)},
            ))
        return chains

    # ------------------------------------------------------------ builders

    def _op(self, kind: str, t: float, rng: random.Random,
            counters: Dict[str, int]) -> SimOp:
        if kind in (UPLOAD_MATERIAL, GRADE):
            actor = rng.choice(self.instructors)
            role = "instructor"
        else:
            actor = rng.choice(self.students)
            role = "student"
        course = self.course_of(actor)
        payload: Dict[str, str] = {}
        if kind == UPLOAD_MATERIAL:
            counters["material"] += 1
            n = counters["material"]
            payload = {"filename": f"{course}_notes_{n:04d}.pdf",
                       "text": f"{course} lecture notes #{n}: "
                               f"{ASSIGNMENT_TEXT}"}
        elif kind == SUBMIT_ASSIGNMENT:
            counters["submit"] += 1
            payload = {"filename": f"{actor}_hw.pdf",
                       "text": f"{ASSIGNMENT_TEXT} (revision "
                               f"{counters['submit']:04d} by {actor})"}
        elif kind == ASK_LLM_ON_TOPIC:
            q = rng.choice(ON_TOPIC_QUERIES)
            if self.cfg.course_concentration > 0:
                # Shared course context: the prompt prefix is identical
                # for every on-topic ask in this course (off-topic asks
                # stay bare so the relevance gate keeps discriminating).
                q = self.course_context(course) + q
            payload = {"query": q}
        elif kind == ASK_LLM_OFF_TOPIC:
            payload = {"query": rng.choice(OFF_TOPIC_QUERIES)}
        elif kind == ASK_INSTRUCTOR:
            payload = {"query": f"{course}: please clarify point "
                                f"{rng.randrange(1, 9)} of the homework."}
        elif kind == GRADE:
            payload = {"student": rng.choice(self.students),
                       "grade": rng.choice(("A", "B", "C"))}
        # DOWNLOAD_MATERIAL / CHECK_GRADE / READ_RESPONSES carry no payload.
        return SimOp(at_s=t, actor=actor, role=role, kind=kind,
                     course=course, payload=payload)
