"""The metric series the port's LMS and tutoring nodes emit, with kind and help.

The port's own copy of the entries of `distributed_lms_raft_llm_tpu/utils/
metrics_registry.py` that this node emits, under the same names, so one
dashboard (and `/metrics.prom` scraper) reads a JAX node and a port node
alike. `/metrics.prom` (`utils/healthz.py`) takes HELP and TYPE from here;
a name not declared here still exports, typed by its snapshot section.
"""

from __future__ import annotations

from typing import Dict, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# name -> (kind, help), the JAX registry's text verbatim.
SPECS: Dict[str, Tuple[str, str]] = {
    "llm_requests": (COUNTER, (
        "GetLLMAnswer RPCs received (LMS leader and tutoring node each "
        "count their own)"
    )),
    "llm_unauthorized": (COUNTER, (
        "direct-dial queries refused for lacking the LMS leader's HMAC "
        "ticket"
    )),
    "llm_failures": (COUNTER, (
        "generation failures surfaced to the client"
    )),
    "tutoring_drain_rejections": (COUNTER, (
        "requests refused because this tutoring node was draining (the "
        "router spills them to another fleet member)"
    )),
    "stream_chunks": (COUNTER, (
        "StreamLLMAnswer chunks sent (LMS leader and tutoring node each "
        "count their own side of the stream)"
    )),
    "shed_expired": (COUNTER, (
        "requests dropped because their deadline budget expired before "
        "prefill dispatched"
    )),
    "shed_overload": (COUNTER, (
        "requests refused at admission because the bounded queue was "
        "full (RESOURCE_EXHAUSTED on the wire)"
    )),
    "engine_batches": (COUNTER, (
        "device batches dispatched by the group batcher"
    )),
    "megastep_dead_lane_tokens": (COUNTER, (
        "pad token positions decoded by slots that finished inside a "
        "megastep before its boundary let the host reap them (spec-mode "
        "lanes count spec_tokens+1 positions each; megastep overhead, "
        "zero in chunk-loop mode)"
    )),
    "prefill_stall_ms": (COUNTER, (
        "host wall milliseconds the paged decode train spent blocked on "
        "sequential admission (prefill dispatches + the first-token "
        "sync while live slots waited); 0 by construction under fused "
        "staged admission (prefill_chunk_tokens > 0)"
    )),
    "decode_stalled_tokens": (COUNTER, (
        "proxy decode tokens the live slots gave up to blocking "
        "sequential admission (live slots x chunk per admission prefill "
        "that paused the train); 0 by construction under fused staged "
        "admission — the fused-prefill before/after number"
    )),
    "prefix_cache_hit_tokens": (COUNTER, (
        "prompt tokens whose KV was spliced from the shared-prefix "
        "radix cache instead of being re-prefilled (the device time the "
        "cache saves)"
    )),
    "prefix_cache_evictions": (COUNTER, (
        "shared-prefix KV blocks evicted under the block budget (LRU "
        "unpinned leaves; blocks a live slot references are never "
        "freed)"
    )),
    "tutoring_draining": (GAUGE, (
        "1 while this tutoring node is draining (POST /admin/drain): "
        "new requests are refused while in-flight work finishes and the "
        "fleet router ejects the node from its ring"
    )),
    "session_active": (GAUGE, (
        "live multi-turn tutoring sessions this node holds transcripts "
        "for ([sessions] ttl_s expiry, max_sessions cap)"
    )),
    "session_pinned_blocks": (GAUGE, (
        "shared-prefix KV blocks held resident by live session pins "
        "(soft pins: TTL-expired first under eviction pressure, then "
        "soonest-expiry live pins — hard refcount pins are never "
        "evicted)"
    )),
    "serving_queue_depth": (GAUGE, (
        "requests admitted but not yet in a device batch (the bound "
        "`max_queue` is enforced against), sampled at each scheduling "
        "round — queue growth at flat tokens/s is the saturation signal "
        "the capacity model and autoscaler watch"
    )),
    "megastep_k": (GAUGE, (
        "live megastep controller value: device chunks fused per host "
        "dispatch (1 = plain chunk loop; grows toward megastep_max when "
        "idle, capped at the next guaranteed slot-free horizon while "
        "admissions wait)"
    )),
    "host_dispatches_per_token": (GAUGE, (
        "host program dispatches paid per emitted token on the paged "
        "engine (cumulative ratio; the megastep exists to shrink it)"
    )),
    "prefix_cache_blocks_used": (GAUGE, (
        "shared-prefix KV blocks currently resident in the radix tree "
        "(may transiently exceed the budget while every leaf is pinned)"
    )),
    "prefix_cache_hit_rate": (GAUGE, (
        "cumulative fraction of admitted prompt tokens served from the "
        "shared-prefix cache (hit tokens / prompt tokens since queue "
        "start)"
    )),
    "answer_latency": (HISTOGRAM, (
        "full GetLLMAnswer latency on the tutoring node"
    )),
    "ttft": (HISTOGRAM, (
        "engine-measured time between a request's prefill and its first "
        "decoded token"
    )),
    "engine_prog_prefill": (HISTOGRAM, (
        "paged-engine _prefill program dispatch wall time (one "
        "fresh-slot prompt pass)"
    )),
    "engine_prog_partial_prefill": (HISTOGRAM, (
        "paged-engine _partial_prefill program dispatch wall time (a "
        "shared-prefix cache hit's suffix-only prompt pass)"
    )),
    "engine_prog_install": (HISTOGRAM, (
        "paged-engine _install program dispatch wall time (splicing a "
        "prefilled slot into the live state)"
    )),
    "engine_prog_step": (HISTOGRAM, (
        "paged-engine _step/_spec_step program dispatch wall time (one "
        "chunk of decode scan iterations)"
    )),
    "engine_prog_megastep": (HISTOGRAM, (
        "paged-engine _megastep program dispatch wall time (K chunks of "
        "decode fused into one device-resident dispatch)"
    )),
    "engine_prog_grow": (HISTOGRAM, (
        "paged-engine _grow program dispatch wall time (cache width "
        "transition)"
    )),
    "engine_prog_stage": (HISTOGRAM, (
        "paged-engine _stage program dispatch wall time (fused "
        "admission: arming a slot's staged prompt; the prefill itself "
        "runs inside the megastep scan)"
    )),
    "engine_prog_generate": (HISTOGRAM, (
        "bucketed-engine generate dispatch wall time (one grouped "
        "device batch, prefill through last token)"
    )),
    # The background bulk-scoring tenant (engine/scoring.py and the
    # co-scheduler in engine/batcher.py).
    "scoring_tokens_per_s": (GAUGE, (
        "recent background-scoring throughput: tokens scored per second "
        "over the last few seconds of quanta — the scoring tenant's half "
        "of the tenant-split utilization view (serving_tokens_per_s is "
        "the interactive half)"
    )),
    # The JAX help names a TPU ceiling; the port has no default ceiling
    # and sets this gauge only where the operator gives one.
    "scoring_utilization": (GAUGE, (
        "scoring_tokens_per_s as a fraction of the operator's chip "
        "saturation ceiling ([telemetry] chip_ceiling_tokens_per_s); not "
        "set on a node started without one"
    )),
    "scoring_quanta": (COUNTER, (
        "single-dispatch scoring quanta executed (one batch-bucket "
        "forward each — the preemption granularity interactive arrivals "
        "wait behind at most one of)"
    )),
    "scoring_scored_tokens": (COUNTER, (
        "corpus tokens the background tenant has scored (bulk grading / "
        "relevance / calibration texts; the cumulative companion of the "
        "scoring_tokens_per_s gauge)"
    )),
    "scoring_jobs_completed": (COUNTER, (
        "bulk score jobs run to completion by the background tenant"
    )),
    "scoring_jobs_failed": (COUNTER, (
        "bulk score jobs that failed (the job fails; the serving loop and "
        "other jobs keep going)"
    )),
    "score_truncated_texts": (COUNTER, (
        "scored texts longer than the length-bucket limit whose PREFIX "
        "was scored (each carries a per-item truncated flag so relevance "
        "evals can't silently read a prefix score as a full-document "
        "score)"
    )),
    "score_preempt_wait_ms": (COUNTER, (
        "milliseconds interactive requests waited behind an in-flight "
        "scoring quantum before admission resumed (bounded by one "
        "quantum per arrival — the scoring tenant's preemption-latency "
        "account)"
    )),
    "engine_prog_score": (HISTOGRAM, (
        "score program dispatch wall time (one background-scoring "
        "quantum: a full-sequence batch-bucket forward — the preemption "
        "granularity)"
    )),
    # The serving loop's heartbeat (utils/guards.py).
    "serving_tick_lag": (HISTOGRAM, (
        "how late the serving event loop's heartbeat ran versus its "
        "schedule (a stall here means a handler blocked the loop)"
    )),
    "serving_tick_stalls": (COUNTER, (
        "serving-loop heartbeats later than the stall threshold (each "
        "also logged)"
    )),
    # The LMS plane: the service, the tutoring fleet router, the
    # storage layer, the chaos plane and the Raft runner.
    "register": (COUNTER, (
        'Register RPCs received'
    )),
    "login": (COUNTER, (
        'Login RPCs received'
    )),
    "post": (COUNTER, (
        'Post RPCs received (materials, assignments, queries)'
    )),
    "gate_pass": (COUNTER, (
        'queries the BERT relevance gate accepted'
    )),
    "gate_reject": (COUNTER, (
        'queries the BERT relevance gate refused'
    )),
    "llm_ttft": (HISTOGRAM, (
        'LMS-side student-query latency: gate check + tutoring forward '
        '(the BASELINE north-star is its p50)'
    )),
    "tutoring_degraded": (COUNTER, (
        'queries answered by the degraded instructor-queue fallback'
    )),
    "tutoring_failures": (COUNTER, (
        'tutoring forwards that failed (RPC error)'
    )),
    "tutoring_duplicates": (COUNTER, (
        'tutoring forwards deliberately delivered twice by the '
        '`duplicate` chaos fault'
    )),
    "tutoring_budget_exhausted": (COUNTER, (
        "queries degraded because the client's remaining deadline budget "
        'was under the floor'
    )),
    "tutoring_breaker_rejections": (COUNTER, (
        'queries degraded because the tutoring circuit breaker was open'
    )),
    "tutoring_breaker_state": (GAUGE, (
        'tutoring circuit breaker state (0 closed / 1 open / 2 half-open)'
    )),
    "tutoring_breaker_closed": (COUNTER, (
        'breaker transitions into CLOSED'
    )),
    "tutoring_breaker_open": (COUNTER, (
        'breaker transitions into OPEN'
    )),
    "tutoring_breaker_half_open": (COUNTER, (
        'breaker transitions into HALF_OPEN'
    )),
    "blob_fetch_on_miss": (COUNTER, (
        'blobs healed from a peer after committed metadata referenced a '
        'locally missing file'
    )),
    "blob_fetch_budget_exhausted": (COUNTER, (
        "blob fetch-on-miss sweeps skipped because the request's "
        'remaining deadline budget was under the floor (metadata-only '
        'response instead of a doomed peer sweep)'
    )),
    "replicate_budget_exhausted": (COUNTER, (
        'file-replication peers skipped because the per-upload '
        'replication budget ran out mid-sweep (anti-entropy heals them '
        'later)'
    )),
    "tutoring_spills": (COUNTER, (
        'tutoring forwards served by a non-affinity fleet node (the '
        "router spilled past the ring's first choice: open breaker, deep "
        'queue, insufficient budget, or the affinity node failed/was '
        'ejected)'
    )),
    "tutoring_hedges": (COUNTER, (
        'hedged duplicate sends issued after the affinity node sat on a '
        'forward past hedge_after_s (tail-tolerance; the loser is '
        'cancelled)'
    )),
    "tutoring_hedge_wins": (COUNTER, (
        'tutoring answers won by the hedged (second-choice) send — the '
        'tail latency the hedge actually shaved'
    )),
    "tutoring_node_ejections": (COUNTER, (
        'fleet members the router ejected from the ring (drain observed '
        'via /healthz or a draining refusal on the wire)'
    )),
    "tutoring_node_rejoins": (COUNTER, (
        'ejected fleet members re-admitted to the ring (drain ended or an '
        'operator joined them back); each rejoin starts a warm-up ramp so '
        "the node's prefix cache refills before it takes its full key "
        'share'
    )),
    "tutoring_fleet_size": (GAUGE, (
        'routable tutoring fleet members (configured minus '
        'ejected/draining)'
    )),
    "stream_resumes": (COUNTER, (
        "streamed answers resumed at the client's delivered token offset "
        'on another fleet node after the serving stream broke mid-answer '
        '(node death, open breaker, drain, or a per-chunk stall) — the '
        "resumable-stream contract's failover path; never a restart"
    )),
    "stream_stalls": (COUNTER, (
        'streamed forwards declared wedged because no chunk arrived '
        'within stream_stall_s (the stream was open but silent); each '
        "counts against the node's breaker and triggers a resume-at-offset"
    )),
    "wal_torn_tail_truncations": (COUNTER, (
        'Raft WAL replays that dropped a torn final record (crash '
        'mid-append; the record was never acked durable)'
    )),
    "wal_corrupt_records": (COUNTER, (
        'Raft WAL records that failed CRC/framing checks mid-file (bit '
        'rot / merged short write) — the node refuses to trust the log '
        'and recovers per [storage].recovery'
    )),
    "snapshot_integrity_failures": (COUNTER, (
        'LMS state snapshots that failed their integrity header check at '
        'load'
    )),
    "storage_recovering": (GAUGE, (
        '1 while this node has discarded corrupt local storage and is '
        'rejoining via leader replication / InstallSnapshot; 0 once '
        'healed'
    )),
    "stale_tmp_files_removed": (COUNTER, (
        'orphaned atomic-write temp files (.raftwal.* / .lmssnap.* / '
        '.blob*) swept at boot, leaked by a crash between mkstemp and '
        'rename'
    )),
    "fault_campaign_phases": (COUNTER, (
        'fault-campaign phases the admin plane applied (each phase '
        'installs one injector spec for its duration, then clears it)'
    )),
    "raft_tick_lag": (HISTOGRAM, (
        'how late each Raft tick ran versus its schedule (stalls here are '
        'the precursor of spurious elections)'
    )),
    "raft_tick_stalls": (COUNTER, (
        'Raft ticks later than 10 heartbeat intervals (each also logged)'
    )),
    "raft_state_digest": (GAUGE, (
        "low 32 bits of the replica's state-digest chain at its applied "
        'index (LMSState.digest folded per apply; replicas of one group '
        'at the same applied index must report the same value — '
        'divergence here is state-machine nondeterminism)'
    )),
    # LMS group router (lms/group_router.py), the course-sharded control
    # plane. Aggregate series only: per-group detail is served by GET
    # /admin/raft instead of runtime-formatted metric names.
    "router_group_forwards": (COUNTER, (
        "LMS RPCs the router forwarded to another node because that node "
        "leads the subject's Raft group"
    )),
    "router_fanout_reads": (COUNTER, (
        "cross-group reads (course materials, unanswered queries) fanned "
        "out to every group's leader and merged"
    )),
    "router_frozen_rejections": (COUNTER, (
        "writes/reads refused with UNAVAILABLE because the subject was "
        "frozen or tombstoned mid-reshard (the client retries against the "
        "flipped routing map; never a silent drop)"
    )),
    "router_unsigned_metadata_rejections": (COUNTER, (
        "RPCs whose x-lms-* control metadata (group targeting, forced auth "
        "salt/token) carried no valid router HMAC and was ignored — a "
        "client forgery or a router-secret mismatch across the deployment"
    )),
    "reshard_steps": (COUNTER, (
        "journaled reshard handoff steps persisted to the meta group "
        "(begin/frozen/installed/committed/done)"
    )),
    "reshard_completed": (COUNTER, (
        "reshard handoffs that reached 'done': slice installed on the "
        "target, map flipped, source copy dropped behind tombstones"
    )),
    "routing_map_version": (GAUGE, (
        "version of the replicated course->group routing map this router "
        "last parsed from the meta group"
    )),
    # The semester simulator's client-side series (sim/), and the
    # lock-order auditor's counter (utils/locks.py).
    "sim_ops_ok": (COUNTER, (
        "simulated student/instructor ops that succeeded"
    )),
    "sim_ops_failed": (COUNTER, (
        "simulated ops that failed terminally (retries and budget "
        "exhausted)"
    )),
    "sim_ops_dropped": (COUNTER, (
        "simulated ops shed unexecuted because their worker fell further "
        "behind the trace than the lag bound (closed-loop overload, not a "
        "cluster failure)"
    )),
    "sim_op_latency": (HISTOGRAM, (
        "client-observed latency of every simulated op"
    )),
    "sim_ask_latency": (HISTOGRAM, (
        "client-observed ask_llm latency (its p95 is the semester-sim "
        "answer SLO)"
    )),
    "sim_degraded_answers": (COUNTER, (
        "ask_llm calls answered by the degraded instructor-queue fallback, "
        "as seen by the simulated clients"
    )),
    "sim_events_injected": (COUNTER, (
        "operations-schedule events the semester sim executed (transfers, "
        "quarantines, membership changes, chaos campaigns)"
    )),
    "sim_ryw_violations": (COUNTER, (
        "read-your-writes violations the in-run ledger auditor observed (a "
        "write acked before the read started was not visible)"
    )),
    "sim_acked_write_losses": (COUNTER, (
        "acked writes the end-of-run ledger audit could not find in the "
        "cluster (the zero-acked-write-loss SLO; must stay 0)"
    )),
    "sim_slo_violations": (COUNTER, (
        "semester-sim SLO checks that failed"
    )),
    "sim_burn_alerts": (COUNTER, (
        "burn-rate alerts the continuous SLO engine raised during the run "
        "(fast- and slow-window; each is also recorded as a timeline event "
        "and classified against the injected-fault phases in the verdict)"
    )),
    "sim_session_turns": (COUNTER, (
        "streamed follow-up-chain turns the simulated students completed "
        "(each is one StreamLLMAnswer call carrying a session id)"
    )),
    "sim_session_turns_failed": (COUNTER, (
        "streamed session turns that failed terminally; the rest of that "
        "chain is abandoned (later turns need the transcript)"
    )),
    "sim_stream_resumes": (COUNTER, (
        "client-observed resume-at-offset failovers: streamed asks that "
        "lost their stream after the first delivered byte and continued "
        "from the delivered token offset on a retry"
    )),
    "sim_stream_digest_mismatch": (COUNTER, (
        "streamed answers whose assembled text failed the final chunk's "
        "digest check — a duplicated or dropped token somewhere in the "
        "stream; the verdict requires 0"
    )),
    "sim_turn_ttft": (HISTOGRAM, (
        "client-observed time to first streamed token per session turn (its "
        "p95 is the per-turn conversational SLO)"
    )),
    "lock_order_violations": (COUNTER, (
        "lock acquisitions that re-entered a held non-reentrant lock or "
        "closed a cycle in the live acquisition-order graph (recorded by "
        "utils/locks.py OrderedLock when debug recording is on; each also "
        "lands in locks.violations() with the offending edge)"
    )),
}

# The names the scoring tenant and the serving watchdog emit.
SCORING_TOKENS_PER_S = "scoring_tokens_per_s"
SCORING_UTILIZATION = "scoring_utilization"
SCORING_QUANTA = "scoring_quanta"
SCORING_SCORED_TOKENS = "scoring_scored_tokens"
SCORING_JOBS_COMPLETED = "scoring_jobs_completed"
SCORING_JOBS_FAILED = "scoring_jobs_failed"
SCORE_TRUNCATED_TEXTS = "score_truncated_texts"
SCORE_PREEMPT_WAIT_MS = "score_preempt_wait_ms"
ENGINE_PROG_SCORE = "engine_prog_score"
SERVING_TICK_LAG = "serving_tick_lag"
SERVING_TICK_STALLS = "serving_tick_stalls"


# The LMS plane's names.
REGISTER = "register"
LOGIN = "login"
POST = "post"
LLM_REQUESTS = "llm_requests"
GATE_PASS = "gate_pass"
GATE_REJECT = "gate_reject"
LLM_TTFT = "llm_ttft"
TUTORING_DEGRADED = "tutoring_degraded"
TUTORING_FAILURES = "tutoring_failures"
TUTORING_DUPLICATES = "tutoring_duplicates"
TUTORING_BUDGET_EXHAUSTED = "tutoring_budget_exhausted"
TUTORING_BREAKER_REJECTIONS = "tutoring_breaker_rejections"
TUTORING_BREAKER_STATE = "tutoring_breaker_state"
TUTORING_BREAKER_CLOSED = "tutoring_breaker_closed"
TUTORING_BREAKER_OPEN = "tutoring_breaker_open"
TUTORING_BREAKER_HALF_OPEN = "tutoring_breaker_half_open"
BLOB_FETCH_ON_MISS = "blob_fetch_on_miss"
BLOB_FETCH_BUDGET_EXHAUSTED = "blob_fetch_budget_exhausted"
REPLICATE_BUDGET_EXHAUSTED = "replicate_budget_exhausted"
TUTORING_SPILLS = "tutoring_spills"
TUTORING_HEDGES = "tutoring_hedges"
TUTORING_HEDGE_WINS = "tutoring_hedge_wins"
TUTORING_NODE_EJECTIONS = "tutoring_node_ejections"
TUTORING_NODE_REJOINS = "tutoring_node_rejoins"
TUTORING_FLEET_SIZE = "tutoring_fleet_size"
STREAM_RESUMES = "stream_resumes"
STREAM_STALLS = "stream_stalls"
WAL_TORN_TAIL_TRUNCATIONS = "wal_torn_tail_truncations"
WAL_CORRUPT_RECORDS = "wal_corrupt_records"
SNAPSHOT_INTEGRITY_FAILURES = "snapshot_integrity_failures"
STORAGE_RECOVERING = "storage_recovering"
STALE_TMP_FILES_REMOVED = "stale_tmp_files_removed"
FAULT_CAMPAIGN_PHASES = "fault_campaign_phases"
RAFT_TICK_LAG = "raft_tick_lag"
RAFT_TICK_STALLS = "raft_tick_stalls"
RAFT_STATE_DIGEST = "raft_state_digest"

# The group router's names.
ROUTER_GROUP_FORWARDS = "router_group_forwards"
ROUTER_FANOUT_READS = "router_fanout_reads"
ROUTER_FROZEN_REJECTIONS = "router_frozen_rejections"
ROUTER_UNSIGNED_METADATA = "router_unsigned_metadata_rejections"
RESHARD_STEPS = "reshard_steps"
RESHARD_COMPLETED = "reshard_completed"
ROUTING_MAP_VERSION = "routing_map_version"

# The semester simulator's names (sim/) and the lock-order auditor's.
SIM_OPS_OK = "sim_ops_ok"
SIM_OPS_FAILED = "sim_ops_failed"
SIM_OPS_DROPPED = "sim_ops_dropped"
SIM_OP_LATENCY = "sim_op_latency"
SIM_ASK_LATENCY = "sim_ask_latency"
SIM_DEGRADED_ANSWERS = "sim_degraded_answers"
SIM_EVENTS_INJECTED = "sim_events_injected"
SIM_RYW_VIOLATIONS = "sim_ryw_violations"
SIM_ACKED_WRITE_LOSSES = "sim_acked_write_losses"
SIM_SLO_VIOLATIONS = "sim_slo_violations"
SIM_BURN_ALERTS = "sim_burn_alerts"
SIM_SESSION_TURNS = "sim_session_turns"
SIM_SESSION_TURNS_FAILED = "sim_session_turns_failed"
SIM_STREAM_RESUMES = "sim_stream_resumes"
SIM_STREAM_DIGEST_MISMATCH = "sim_stream_digest_mismatch"
SIM_TURN_TTFT = "sim_turn_ttft"
LOCK_ORDER_VIOLATIONS = "lock_order_violations"
PREFIX_CACHE_HIT_TOKENS = "prefix_cache_hit_tokens"
PREFIX_CACHE_HIT_RATE = "prefix_cache_hit_rate"

# Breaker state -> transition counter (the LMS breaker observer).
BREAKER_TRANSITION_COUNTERS = {
    "closed": TUTORING_BREAKER_CLOSED,
    "open": TUTORING_BREAKER_OPEN,
    "half_open": TUTORING_BREAKER_HALF_OPEN,
}


def is_declared(name: str) -> bool:
    return name in SPECS
