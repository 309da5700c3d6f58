"""The metric series the port's tutoring node emits, with kind and help.

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


def is_declared(name: str) -> bool:
    return name in SPECS
