"""The deployment file (TOML) as the port's nodes read it.

A trimmed port of `distributed_lms_raft_llm_tpu/config.py`. One TOML file
describes the whole deployment (configs/cluster.toml, configs/dev.toml);
the port's LMS nodes and tutoring node start from it:

    python -m distributed_lms_raft_llm_tpu_torch.serving.lms_server \\
        --config configs/cluster.toml --id 1
    python -m distributed_lms_raft_llm_tpu_torch.serving.tutoring_server \\
        --config configs/cluster.toml

`load_config` is as strict as the JAX package's over the WHOLE file: an
unknown section or an unknown key in any section is refused, so the same
files load and the same typos fail on both packages. Every section is
parsed into a dataclass with the JAX package's defaults and value checks
(`[cluster]` with `[cluster.nodes]`, `[tutoring]`, `[tutoring_fleet]`,
`[sampling]`, `[scoring]`, `[sessions]`, `[gate]`, `[resilience]`,
`[groups]`, `[storage]`, `[sim]`, `[tracing]`, `[telemetry]`).
`apply_file_defaults` is the JAX package's two-phase
merge: the file fills each flag the command line left out, and a flag
given on the command line wins. `sampling_params` and `engine_config` build
the tutoring node's engine settings from [sampling] and [tutoring] (plus
[scoring]'s switch), returning the port's types; the engine modules are
imported only when they are called.
"""

from __future__ import annotations

import argparse
import dataclasses
import tomllib
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ClusterConfig:
    """[cluster]: the Raft topology (`[cluster.nodes]`, id -> host:port)
    and its timing."""

    nodes: Dict[int, str] = dataclasses.field(default_factory=dict)
    data_dir: str = "lms_data"  # per-node state under <data_dir>/node<id>
    election_timeout: float = 0.5
    heartbeat_interval: float = 0.1
    snapshot_every: int = 64
    metrics_period: float = 60.0
    linearizable_reads: bool = True

    @property
    def addresses(self) -> Dict[int, str]:
        return dict(self.nodes)


@dataclasses.dataclass
class SamplingConfig:
    """[sampling]: the reference's generation settings."""

    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.2
    max_new_tokens: int = 128
    # The port computes the exact top-k for it (engine/sampling.py).
    approx_top_k: bool = False


@dataclasses.dataclass
class TutoringConfig:
    """[tutoring]: the tutoring node (the JAX package's keys)."""

    address: str = "127.0.0.1:50054"
    model: str = "gpt2"
    checkpoint: Optional[str] = None
    vocab: Optional[str] = None
    merges: Optional[str] = None
    tokenizer_json: Optional[str] = None
    tp: int = 1
    ep: int = 1
    quant: Optional[str] = None
    kv_quant: bool = False
    spec_tokens: int = 0
    paged: bool = False
    max_batch: int = 8
    max_wait_ms: float = 10.0
    slots: Optional[int] = None
    chunk: int = 16
    megastep: int = 1
    megastep_max: int = 0
    inflight: int = 2
    prefix_cache: bool = False
    prefix_cache_blocks: int = 512
    prefill_chunk_tokens: int = 0
    draft_source: str = "prompt_lookup"
    auth_key_file: Optional[str] = None

    @property
    def port(self) -> int:
        return int(self.address.rsplit(":", 1)[1])


@dataclasses.dataclass
class TutoringFleetConfig:
    """[tutoring_fleet]: the LMS's cache-affinity routing across N
    tutoring nodes (`lms/tutoring_pool.py`). Empty `addresses` = a one-node
    fleet at [tutoring].address."""

    addresses: List[str] = dataclasses.field(default_factory=list)
    # Optional per-node /healthz endpoints, same order as `addresses`.
    health_addresses: List[str] = dataclasses.field(default_factory=list)
    hedge_after_s: float = 0.35     # hedge to the second choice; 0 = off
    queue_spill_depth: int = 8      # spill past this serving-queue depth
    warmup_s: float = 5.0           # rejoin warm-up ramp length
    warmup_weight: float = 0.25     # initial key-share weight when warming
    health_poll_s: float = 1.0      # router health-poll cadence
    stream_stall_s: float = 2.0     # max silence between streamed chunks;
    #                                 0 = no stall watch

    def __post_init__(self) -> None:
        if self.health_addresses and len(self.health_addresses) != len(
            self.addresses
        ):
            raise ValueError(
                "[tutoring_fleet] health_addresses must be empty or "
                "match addresses one-to-one"
            )
        if self.hedge_after_s < 0 or self.health_poll_s <= 0:
            raise ValueError(
                "[tutoring_fleet] needs hedge_after_s >= 0 and "
                "health_poll_s > 0"
            )
        if not 0.0 < self.warmup_weight <= 1.0 or self.warmup_s < 0:
            raise ValueError(
                "[tutoring_fleet] needs 0 < warmup_weight <= 1 and "
                "warmup_s >= 0"
            )
        if self.queue_spill_depth < 1:
            raise ValueError(
                "[tutoring_fleet] queue_spill_depth must be >= 1"
            )
        if self.stream_stall_s < 0:
            raise ValueError(
                "[tutoring_fleet] stream_stall_s must be >= 0"
            )


@dataclasses.dataclass
class SessionsConfig:
    """[sessions]: multi-turn tutoring sessions on the streaming path."""

    ttl_s: float = 600.0
    max_sessions: int = 256

    def __post_init__(self) -> None:
        if self.ttl_s <= 0:
            raise ValueError("[sessions] ttl_s must be > 0")
        if self.max_sessions < 0:
            raise ValueError("[sessions] max_sessions must be >= 0")


@dataclasses.dataclass
class ScoringConfig:
    """[scoring]: the background bulk-scoring tenant (engine/scoring.py)."""

    enabled: bool = False
    max_job_texts: int = 4096   # admission cap per bulk job (texts)
    jobs_retained: int = 32     # finished jobs kept for GET /admin/score

    def __post_init__(self) -> None:
        if self.max_job_texts < 1 or self.jobs_retained < 1:
            raise ValueError(
                "[scoring] needs max_job_texts >= 1 and jobs_retained >= 1")


@dataclasses.dataclass
class GateConfig:
    """[gate]: the BERT relevance gate on the LMS leader (the section; the
    gate itself is `engine.gate.GateConfig` / `RelevanceGate`)."""

    model: Optional[str] = None  # "bert-base-uncased" | "tiny"; None = off
    checkpoint: Optional[str] = None
    vocab: Optional[str] = None
    threshold: float = 0.6
    quant: Optional[str] = None  # weight-only int8 for the gate encoder


@dataclasses.dataclass
class ResilienceConfig:
    """[resilience]: overload and failure behaviour. A tutoring node reads
    `queue_depth` (its admission bound); the rest is the client's and the
    LMS's."""

    request_timeout_s: float = 60.0
    llm_timeout_s: float = 120.0
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    tutoring_timeout_s: float = 120.0
    deadline_floor_s: float = 0.25
    breaker_failure_threshold: int = 5
    breaker_recovery_s: float = 10.0
    breaker_half_open_max: int = 1
    blob_fetch_timeout_s: float = 5.0
    replicate_timeout_s: float = 30.0
    replicate_budget_s: float = 60.0
    queue_depth: int = 64
    fault_seed: int = 0


@dataclasses.dataclass
class StorageConfig:
    """[storage]: durability and recovery of the WAL, the LMS state
    snapshot and the blob store (`raft/storage.py`, `lms/persistence.py`)."""

    checksums: bool = True    # v2 CRC-framed records; False = legacy v1
    fsync: str = "always"     # "always" | "never" (dev/bench only)
    recovery: str = "rejoin"  # corrupt WAL/snapshot: "rejoin" | "fail"

    def __post_init__(self) -> None:
        if self.fsync not in ("always", "never"):
            raise ValueError(
                f"[storage] fsync must be 'always' or 'never', "
                f"got {self.fsync!r}"
            )
        if self.recovery not in ("rejoin", "fail"):
            raise ValueError(
                f"[storage] recovery must be 'rejoin' or 'fail', "
                f"got {self.recovery!r}"
            )


@dataclasses.dataclass
class GroupsConfig:
    """[groups]: the sharded control plane: N independent Raft groups
    hosting partitioned LMS state behind the course-keyed router
    (lms/group_router.py). `count = 1` (or the section absent) keeps the
    single-group world byte-compatible: no router, no extra Raft ports,
    existing WAL/snapshot files load unchanged. With `count > 1` every
    server hosts one member of EVERY group (group 0 doubles as the meta
    group holding the replicated routing map) and each extra group's
    Raft plane listens at the node's base port + `port_stride * gid`.
    """

    count: int = 1          # Raft groups (1 = the single-group world)
    port_stride: int = 1000  # group gid's Raft port = base + stride * gid
    secret: str = ""        # shared router HMAC key: signs the x-lms-*
    #                         control metadata of forwarded legs so a
    #                         client cannot forge group targeting or
    #                         forced auth salts/tokens. Every node of a
    #                         deployment must use the same value; empty
    #                         (default) disables forgery protection but
    #                         keeps routers interoperable.

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError("[groups] count must be >= 1")
        if self.port_stride < 1:
            raise ValueError("[groups] port_stride must be >= 1")


@dataclasses.dataclass
class TracingConfig:
    """[tracing]: the flight-recorder request tracer (utils/tracing.py)."""

    enabled: bool = True
    ring_size: int = 256
    exemplars_per_route: int = 4
    flagged_max: int = 64
    max_spans_per_trace: int = 512

    def __post_init__(self) -> None:
        if self.ring_size < 1 or self.max_spans_per_trace < 1:
            raise ValueError(
                "[tracing] ring_size and max_spans_per_trace must be >= 1")
        if self.exemplars_per_route < 0 or self.flagged_max < 0:
            raise ValueError(
                "[tracing] exemplars_per_route and flagged_max must be >= 0")


@dataclasses.dataclass
class TelemetryConfig:
    """[telemetry]: the timeline plane (utils/timeline.py). A tutoring
    node reads the sampler's switch, interval and ring; the burn windows
    are the JAX package's cluster tools'. `chip_ceiling_tokens_per_s` is
    the operator's saturation figure for the card: it anchors
    `scoring_utilization` (no default is a card's: the JAX package's is a
    TPU figure, and the port's node sets the gauge only from a file)."""

    enabled: bool = True
    sample_interval_s: float = 1.0
    ring_points: int = 600
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 1.2
    slow_burn: float = 1.0
    chip_ceiling_tokens_per_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.sample_interval_s <= 0 or self.ring_points < 2:
            raise ValueError(
                "[telemetry] needs sample_interval_s > 0 and "
                "ring_points >= 2")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "[telemetry] needs 0 < fast_window_s <= slow_window_s")
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise ValueError("[telemetry] burn thresholds must be > 0")
        if (self.chip_ceiling_tokens_per_s is not None
                and self.chip_ceiling_tokens_per_s <= 0):
            raise ValueError(
                "[telemetry] chip_ceiling_tokens_per_s must be > 0")


@dataclasses.dataclass
class SimConfig:
    """[sim]: the semester simulator (sim/): one continuously-verified
    production scenario composing the whole fault arsenal under SLOs.
    Workload shape (students, diurnal curve), operations schedule, and the
    SLO bounds the end-of-run checker asserts from `/metrics`/`/healthz`
    all live here so a failed run replays from one seed + one section.
    """

    seed: int = 0                 # workload trace + event schedule RNG
    students: int = 24
    instructors: int = 2
    courses: int = 3
    duration_s: float = 30.0      # wall-clock length of the workload phase
    base_rate: float = 8.0        # mean op arrival rate (ops/s)
    diurnal_amplitude: float = 0.6  # 0 = flat load, 1 = full day/night swing
    days: float = 1.0             # diurnal cycles compressed into the run
    workers: int = 8              # client worker threads driving the trace
    llm_budget_s: float = 10.0    # per-ask_llm overall client budget
    course_concentration: float = 0.0  # 0 = actors hash uniformly onto
    #                                courses and ask_llm prompts stay bare;
    #                                > 0 skews actors toward the first
    #                                courses AND prefixes on-topic asks
    #                                with their course's deterministic
    #                                assignment context (the shared-prefix
    #                                cache's target workload); 1 = all
    #                                traffic on course0
    tutoring_nodes: int = 1       # tutoring fleet size: N in-process
    #                               tutoring nodes behind the LMS
    #                               routing tier (cache-affinity ring,
    #                               spill, hedging); > 1 adds the fleet
    #                               drills to the operations schedule
    #                               (kill-one-of-N blackout,
    #                               drain-and-rejoin, autoscale)
    tutoring_engine: str = "echo"  # "echo" (wire-complete stand-in),
    #                                "tiny" (the real bucketed engine,
    #                                tier-2 soak), or "tiny-paged" (the
    #                                real paged engine + shared-prefix
    #                                radix cache)
    events: bool = True           # run the operations schedule (transfer,
    #                               quarantine, membership, chaos campaign)
    slo_answer_p95_s: float = 6.0    # ask_llm p95 bound (client + /metrics)
    slo_degraded_rate_max: float = 0.5  # degraded answers / llm requests
    slo_tick_stalls_max: int = 50    # bound on summed raft_tick_stalls
    continuous_slos: bool = True  # evaluate the SLOs in fast/slow burn-rate
    #                               windows DURING the run (sim/slo.py
    #                               ContinuousSloEngine over a live cluster
    #                               scrape), not only at run end; alerts
    #                               land in the verdict and the BENCH record
    bulk_scoring: bool = True     # run the "bulk grading night" event: an
    #                               instructor-scale score job fanned to the
    #                               tutoring fleet mid-run via the LMS
    #                               admin plane; the background tenant must
    #                               complete it WITHOUT moving interactive
    #                               p95 (a scoring-induced burn alert is a
    #                               false alarm — it fails the verdict)
    telemetry_sample_s: float = 0.25  # scrape/evaluate cadence of the
    #                               in-run telemetry loop (cluster /metrics
    #                               poll + burn-rate evaluation)
    session_fraction: float = 0.25  # fraction of students that run a
    #                               follow-up-question CHAIN (streamed,
    #                               session-sticky, prefix-spliced turns)
    #                               instead of independent one-shot asks;
    #                               0 disables the conversational workload
    session_turns: int = 3        # turns per follow-up chain (turn 1 cold,
    #                               turns 2..N splice the session prefix)
    session_ttl_s: float = 30.0   # sim-scale session pin TTL handed to the
    #                               tutoring nodes' session stores
    slo_turn_ttft_p95_s: float = 4.0  # per-turn time-to-first-token p95
    #                               bound over streamed session turns —
    #                               the latency SLO conversational turns
    #                               are judged by (TTFT, not full-answer)
    lms_groups: int = 1           # Raft groups hosting the sharded LMS
    #                               state (lms/group_router.py); > 1 boots
    #                               the router + per-group Raft planes and
    #                               adds the group drills (per-group
    #                               leader loss, live split mid-peak) to
    #                               the operations schedule

    def __post_init__(self) -> None:
        if self.telemetry_sample_s <= 0:
            raise ValueError("[sim] telemetry_sample_s must be > 0")
        if self.lms_groups < 1:
            raise ValueError("[sim] lms_groups must be >= 1")
        if self.tutoring_engine not in ("echo", "tiny", "tiny-paged"):
            raise ValueError(
                f"[sim] tutoring_engine must be 'echo', 'tiny', or "
                f"'tiny-paged', got {self.tutoring_engine!r}"
            )
        if self.students < 1 or self.workers < 1 or self.duration_s <= 0:
            raise ValueError("[sim] needs students/workers >= 1 and "
                             "duration_s > 0")
        if self.courses < 1 or self.instructors < 1:
            raise ValueError("[sim] needs courses/instructors >= 1")
        if self.base_rate <= 0:
            raise ValueError("[sim] base_rate must be > 0")
        if self.tutoring_nodes < 1:
            raise ValueError("[sim] tutoring_nodes must be >= 1")
        if not 0.0 <= self.course_concentration <= 1.0:
            raise ValueError("[sim] course_concentration must be in [0, 1]")
        if not 0.0 <= self.session_fraction <= 1.0:
            raise ValueError("[sim] session_fraction must be in [0, 1]")
        if self.session_turns < 1:
            raise ValueError("[sim] session_turns must be >= 1")
        if self.session_ttl_s <= 0 or self.slo_turn_ttft_p95_s <= 0:
            raise ValueError("[sim] session_ttl_s and slo_turn_ttft_p95_s "
                             "must be > 0")


@dataclasses.dataclass
class AppConfig:
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    tutoring: TutoringConfig = dataclasses.field(
        default_factory=TutoringConfig)
    tutoring_fleet: TutoringFleetConfig = dataclasses.field(
        default_factory=TutoringFleetConfig)
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    scoring: ScoringConfig = dataclasses.field(default_factory=ScoringConfig)
    sessions: SessionsConfig = dataclasses.field(
        default_factory=SessionsConfig)
    gate: GateConfig = dataclasses.field(default_factory=GateConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    groups: GroupsConfig = dataclasses.field(default_factory=GroupsConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)

    @property
    def client_servers(self) -> List[str]:
        return [self.cluster.nodes[k] for k in sorted(self.cluster.nodes)]


# Section name -> its AppConfig field's dataclass.
SECTIONS = {f.name: f.default_factory for f in dataclasses.fields(AppConfig)}


def _check_keys(table: Dict[str, Any], known, path: str) -> None:
    unknown = set(table) - set(known)
    if unknown:
        raise ValueError(f"unknown key(s) {sorted(unknown)} in [{path}] "
                         f"(known: {sorted(known)})")


def load_config(path: str) -> AppConfig:
    """Parse a TOML deployment file (strict sections and keys)."""
    with open(path, "rb") as fh:
        raw = tomllib.load(fh)
    unknown = set(raw) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown section(s) {sorted(unknown)} in {path}")
    built = {}
    for name, cls in SECTIONS.items():
        table = dict(raw.get(name, {}))
        if name == "cluster" and "nodes" in table:
            # TOML keys are strings; node ids are ints.
            table["nodes"] = {int(k): str(v)
                              for k, v in table["nodes"].items()}
        _check_keys(table, {f.name for f in dataclasses.fields(cls)}, name)
        built[name] = cls(**table)
    return AppConfig(**built)


_UNSET = object()


def apply_file_defaults(args: argparse.Namespace,
                        parser: argparse.ArgumentParser,
                        overrides: Dict[str, Any], *,
                        argv: Optional[List[str]]) -> None:
    """Two-phase CLI/TOML merge: the file fills each value the command line
    left unset; explicitly passed flags win.

    Explicitness is found by re-parsing `argv` (the list the caller parsed;
    None = sys.argv) onto a namespace whose dests hold a sentinel: argparse
    assigns defaults only to attributes the namespace lacks, so a dest
    still holding the sentinel was not given on the command line (a flag
    given with its default value still wins). Every override must name a
    flag's dest: positionals cannot be probed this way.
    """
    flag_dests = {a.dest for a in parser._actions if a.option_strings}
    bad = set(overrides) - flag_dests
    if bad:
        raise ValueError(
            f"overrides name non-flag or unknown parser dest(s): "
            f"{sorted(bad)} (positionals can't be probed for explicitness)")
    probe = argparse.Namespace(**{a.dest: _UNSET for a in parser._actions})
    parser.parse_known_args(argv, namespace=probe)
    for name, value in overrides.items():
        if getattr(probe, name, _UNSET) is _UNSET:
            setattr(args, name, value)


def client_kwargs(cfg: AppConfig) -> Dict[str, Any]:
    """LMSClient constructor kwargs from [resilience]."""
    r = cfg.resilience
    return dict(
        request_timeout_s=r.request_timeout_s,
        llm_timeout_s=r.llm_timeout_s,
        backoff_base_s=r.backoff_base_s,
        backoff_max_s=r.backoff_max_s,
    )


def sampling_params(cfg: AppConfig):
    """The engines' `SamplingParams` from [sampling]."""
    from .engine.sampling import SamplingParams

    s = cfg.sampling
    return SamplingParams(
        temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
        repetition_penalty=s.repetition_penalty,
        max_new_tokens=s.max_new_tokens,
        approx_top_k=s.approx_top_k,
    )


def engine_config(cfg: AppConfig):
    """`EngineConfig` for the tutoring node described by [tutoring] and
    [sampling] (the engine's device and dtypes keep their defaults)."""
    from .engine.engine import EngineConfig

    t = cfg.tutoring
    return EngineConfig(
        model=t.model, checkpoint=t.checkpoint, vocab_path=t.vocab,
        merges_path=t.merges, tokenizer_json=t.tokenizer_json,
        sampling=sampling_params(cfg), tp=t.tp, ep=t.ep, quant=t.quant,
        kv_quant=t.kv_quant, spec_tokens=t.spec_tokens,
        draft_source=t.draft_source,
        scoring=cfg.scoring.enabled,
    )


def raft_config(cfg: AppConfig):
    """`raft.RaftConfig` from [cluster]: the election timeout is drawn
    from [election_timeout / 2, election_timeout]."""
    from .raft import RaftConfig

    c = cfg.cluster
    return RaftConfig(
        election_timeout_min=c.election_timeout / 2,
        election_timeout_max=c.election_timeout,
        heartbeat_interval=c.heartbeat_interval,
    )
