"""Background bulk-scoring tenant: log-likelihood scoring in idle lanes.

Port of `distributed_lms_raft_llm_tpu/engine/scoring.py`. It turns
`engine.score()` (log-likelihood grading, course-material relevance,
gate-threshold calibration corpora) into a schedulable second tenant of a
tutoring node:

- `score_program` is the full-sequence forward both engines bind at
  construction (`TutoringEngine._score` / `PagedEngine._score`); with
  `EngineConfig.scoring` on, warmup runs it once at every (batch bucket,
  length bucket) shape (`derive_score_shapes`), after the paged engine's
  CUDA graphs are captured, so the first bulk job builds no kernel and
  grows no allocator segment on the serving path;
- `ScoringManager` chunks submitted jobs into single-dispatch **quanta**
  (one batch-bucket forward each, the preemption granularity), with
  resumable progress, per-job stats and idempotent job ids. The serving
  queues (engine/batcher.py) run a quantum ONLY while no interactive
  request waits and the engine holds no work, and yield at quantum
  boundaries: an interactive arrival waits behind at most one quantum
  (`score_preempt_wait_ms`);
- `score_admin_get` backs ``GET /admin/score[/<job-id>]`` on the node's
  admin plane; ``POST /admin/score`` submits through `ScoringManager.
  submit` (serving/tutoring_server.py), and the JAX package's LMS fans a
  course's submissions here through its fleet router's background route.

This file is a dispatch module (`no-host-sync-in-dispatch` applies): the
quantum loop's only device readback (a `.cpu()` of the per-row sums and
counts, stacked into one tensor) and the batch's upload sit inside
`intended_transfer()`, as in the reference.

What differs from the JAX package:

- the forward runs eagerly (about 600 kernel launches for GPT-2 small;
  no CUDA graph per score shape) and on the calling thread's current
  stream. The queues call it from their executor threads, whose current
  stream is the default stream, the one the engine's graph replays and
  their copies run on, so a quantum is ordered behind the engine's last
  work (and the co-scheduler starts one only once that work was read);
- `ScoringManager` has no default chip ceiling: `scoring_utilization` is
  set only where the operator gives one (`[telemetry]
  chip_ceiling_tokens_per_s`), since the JAX default is a TPU figure;
- at sequence parallelism (`EngineConfig.sp > 1`, the bucketed engine;
  the paged engine refuses it, as the JAX one does) the forward runs
  round the ring (`parallel/ring.py`) and each rank holds the logits of
  its own T/sp positions: it sums the log probabilities and counts of the
  pairs those positions start (every rank holds the whole ids, so a
  shard's last position reads its target from the next shard's first
  id), and the sums are added over sp before the perplexity is formed.
  The shapes follow the JAX package's sp rules (the limit floored to a
  multiple of sp, the bucket rounded up to one). At dp > 1 the batch is
  split over dp, as the JAX ring's `shard_map` splits it: it is rounded
  up to a multiple of dp with all-pad filler rows (scored, then dropped),
  each dp line of sp ranks scores its own rows, and the rows' sums are
  gathered over dp. At sp = 1 every dp line scores the whole batch, as
  JAX's jit replicates it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import ParallelAxis, axis_of
from ..utils import metrics_registry as metric
from ..utils.guards import intended_transfer
from .generate import pick_bucket

log = logging.getLogger(__name__)


def score_program(params: Any, ids: torch.Tensor, mask: torch.Tensor, *,
                  cfg: Any, model: Any, dp: Optional[ParallelAxis] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row total next-token log probability and valid-pair count.

    The full-sequence forward (no KV cache, causal attention through the
    plain `attend`), a float32 `log_softmax` of the logits, the log
    probability of each next token, and the valid-pair mask
    `mask[:, 1:] & mask[:, :-1]`. Right-padded rows: pads sit after the
    causal horizon of every real token and are masked out of the sum.

    With ``cfg.sequence_parallel`` (sp > 1) the forward is the ring one:
    this rank's positions [r T/sp, (r+1) T/sp), each paired with the next
    id (the last position of the sequence with none), summed here and
    then over the sp ranks.

    With `dp` above size 1 (sp > 1 at dp > 1) this rank's dp line scores
    its `1/dp` of the rows (the batch a multiple of dp) and the rows'
    sums and counts are gathered over dp, in row order.
    """
    if dp is not None and dp.size > 1:
        rows = ids.shape[0] // dp.size
        mine = slice(dp.rank * rows, (dp.rank + 1) * rows)
        total, count = score_program(params, ids[mine], mask[mine],
                                     cfg=cfg, model=model)
        both = dp.all_gather(torch.stack((total, count.to(total.dtype))),
                             dim=1)
        return both[0], both[1].long()
    logits, _ = model.forward(params, cfg, ids)
    sp = axis_of(cfg, "sequence_parallel", "sp")
    if sp.size == 1:
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        picked = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        valid = mask[:, 1:] & mask[:, :-1]
        total = torch.where(valid, picked, torch.zeros_like(picked)).sum(1)
        return total, valid.sum(dim=1)
    t, t_local = ids.shape[1], logits.shape[1]
    pos = sp.rank * t_local + torch.arange(t_local, device=ids.device)
    nxt = torch.clamp(pos + 1, max=t - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, ids[:, nxt, None])[..., 0]
    valid = mask[:, nxt] & mask[:, pos] & (pos + 1 < t)
    total = torch.where(valid, picked, torch.zeros_like(picked)).sum(1)
    # Counts are at most a length bucket: exact in float32.
    both = sp.all_reduce(torch.stack((total, valid.sum(dim=1).float())))
    return both[0], both[1].long()


def derive_score_shapes(length_buckets: Sequence[int],
                        batch_buckets: Sequence[int],
                        max_position_embeddings: int, sp: int = 1,
                        dp: int = 1) -> List[Tuple[int, int]]:
    """Every (batch, length) shape `score_texts` can run, derived the way
    `encode_score_batch` buckets live texts: the domain warmup covers when
    scoring is on. At sp > 1 the JAX package's rules: the limit floored to
    a multiple of sp, each bucket rounded up to one within it, each batch
    bucket rounded up to a multiple of dp."""
    limit = _score_limit(length_buckets, max_position_embeddings, sp)
    buckets = {_sp_bucket(min(b, limit), limit, sp) for b in length_buckets}
    batches = {_dp_batch(nb, sp, dp) for nb in batch_buckets}
    return sorted((nb, t) for nb in batches for t in buckets)


def _score_limit(length_buckets: Sequence[int], max_position_embeddings: int,
                 sp: int) -> int:
    """The most tokens a text is scored over: the largest length bucket
    capped at the position table and, at sp > 1, floored to a multiple of
    sp, so a bucket rounded up to one (`_sp_bucket`) stays in the table."""
    limit = min(max(length_buckets), max_position_embeddings)
    return (limit // sp) * sp


def _sp_bucket(bucket: int, limit: int, sp: int) -> int:
    """`bucket` rounded up to a multiple of sp, within `limit` (itself a
    multiple of sp): the ring takes sp equal shards."""
    return min(-(-bucket // sp) * sp, limit)


def _dp_batch(nbatch: int, sp: int, dp: int) -> int:
    """The batch bucket rounded up to a multiple of dp where sp > 1 (the
    ring splits the rows over dp); as it is at sp = 1."""
    return -(-nbatch // dp) * dp if sp > 1 else nbatch


def encode_score_batch(engine: Any, texts: Sequence[str]
                       ) -> Tuple[np.ndarray, np.ndarray, List[bool]]:
    """Tokenize and right-pad one score group (at most the largest batch
    bucket) into a warmed (batch, length) shape; returns (ids, mask,
    truncated), where `truncated[i]` says text i exceeded the length
    limit and only its PREFIX is scored. The limit is the largest length
    bucket capped at the position table, so no position leaves it; at
    sp > 1 floored to a multiple of sp, the bucket rounded up to one, and
    the batch rounded up to a multiple of dp with all-pad rows."""
    cfg = engine.config
    sp = cfg.sp
    limit = _score_limit(cfg.length_buckets,
                         engine.cfg.max_position_embeddings, sp)
    token_lists: List[List[int]] = []
    truncated: List[bool] = []
    for text in texts:
        toks = engine.tokenizer.encode(text)
        truncated.append(len(toks) > limit)
        toks = toks[:limit]
        token_lists.append(toks if toks else [engine.tokenizer.pad_id])
    longest = max(len(t) for t in token_lists)
    bucket = _sp_bucket(min(pick_bucket(longest, cfg.length_buckets),
                            limit), limit, sp)
    if bucket % sp or bucket > engine.cfg.max_position_embeddings:
        # Held by _score_limit and _sp_bucket; checked rather than left to
        # a clamp (JAX clamps the position gather silently).
        raise ValueError(
            f"score bucket {bucket} is not {sp} equal shards inside the "
            f"position table {engine.cfg.max_position_embeddings}")
    nbatch = _dp_batch(pick_bucket(len(texts), cfg.batch_buckets), sp,
                       engine.dp)
    ids = np.full((nbatch, bucket), engine.tokenizer.pad_id, np.int64)
    mask = np.zeros((nbatch, bucket), bool)
    for i, toks in enumerate(token_lists):
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = True
    return ids, mask, truncated


@torch.inference_mode()
def score_texts(engine: Any, texts: Sequence[str]) -> List[Dict[str, Any]]:
    """Log-likelihood scoring through the engine's `_score` program: per
    text, the total next-token log probability, the token count, the
    perplexity and the `truncated` flag. Groups above the largest batch
    bucket run as several device batches; a group at or under it is ONE
    forward and one readback, the scoring tenant's preemption quantum.

    Inference mode is entered here, per call: it is thread-local, and the
    queues call this from their executor threads.

    MoE caveat: with capacity dropping active (capacity_factor <
    num_experts) a token's routing, hence its logprob, depends on its
    forward-pass companions, pads and filler rows included
    (models/moe.py). For reproducible MoE evals raise capacity_factor to
    >= num_experts.
    """
    if not texts:
        return []
    cap = max(engine.config.batch_buckets)
    if len(texts) > cap:
        out: List[Dict[str, Any]] = []
        for start in range(0, len(texts), cap):
            out.extend(score_texts(engine, texts[start:start + cap]))
        return out
    ids, mask, truncated = encode_score_batch(engine, texts)
    t0, t0_unix = time.monotonic(), time.time()
    with intended_transfer():  # the batch's upload (a copy that syncs)
        ids_dev = torch.from_numpy(ids).to(engine.device)
        mask_dev = torch.from_numpy(mask).to(engine.device)
    engine.programs["_score"].record(ids.shape)
    total, count = engine._score(engine.params, ids_dev, mask_dev)
    # The quantum's one readback: sums and counts in one copy (counts are
    # at most a length bucket, exact in float32).
    with intended_transfer():
        host = torch.stack((total, count.to(total.dtype))).cpu().numpy()
    engine._prog_times.append(("score", t0_unix, time.monotonic() - t0))
    if len(engine._prog_times) > engine._PROG_TIMES_MAX:
        del engine._prog_times[: -engine._PROG_TIMES_MAX]
    out = []
    for i in range(len(texts)):
        n = int(host[1, i])
        lp = float(host[0, i])
        out.append({
            "logprob": lp,
            "tokens": n,
            "ppl": float(np.exp(-lp / max(n, 1))),
            "truncated": bool(truncated[i]),
        })
    return out


def warm_score(engine: Any) -> int:
    """Run the score program once at each of `engine.score_shapes` (empty
    unless scoring is on), so the first bulk job pays no first launch,
    kernel build or allocator growth; returns the shapes run."""
    with torch.inference_mode():
        for nb, bucket in engine.score_shapes:
            ids = torch.full((nb, bucket), engine.tokenizer.pad_id,
                             dtype=torch.long, device=engine.device)
            mask = torch.ones((nb, bucket), dtype=torch.bool,
                              device=engine.device)
            engine.programs["_score"].record((nb, bucket))
            total, count = engine._score(engine.params, ids, mask)
            with intended_transfer():
                torch.stack((total, count.to(total.dtype))).cpu()
    return len(engine.score_shapes)


# ====================================================== the job manager


@dataclasses.dataclass
class ScoreJob:
    """One bulk-scoring job, chunked into single-dispatch quanta."""

    job_id: str
    purpose: str                       # "grading" | "relevance" | ...
    texts: List[str]
    status: str = "queued"             # queued | running | done | failed
    cursor: int = 0                    # texts scored so far (resumable)
    quanta: int = 0
    scored_tokens: int = 0
    truncated_texts: int = 0
    error: Optional[str] = None
    results: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    submitted_unix: float = dataclasses.field(default_factory=time.time)
    finished_unix: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.status in ("done", "failed")

    def summary(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "purpose": self.purpose,
            "status": self.status,
            "texts": len(self.texts),
            "scored": self.cursor,
            "quanta": self.quanta,
            "scored_tokens": self.scored_tokens,
            "truncated_texts": self.truncated_texts,
            "error": self.error,
            "submitted_unix": round(self.submitted_unix, 3),
            "finished_unix": (round(self.finished_unix, 3)
                              if self.finished_unix is not None else None),
        }

    def detail(self) -> Dict[str, Any]:
        doc = self.summary()
        # Results ship only once the job is done: a half-scored corpus
        # would read as a complete (silently short) eval.
        doc["results"] = list(self.results) if self.status == "done" else None
        return doc


class ScoringManager:
    """Chunk bulk score jobs into preemptible single-dispatch quanta.

    Serving-loop contract: `submit`/`job`/`jobs`/`stats` run on the
    serving event loop (the admin plane); `run_quantum` runs in the
    queue's executor thread while the loop keeps admitting interactive
    work, hence the lock. The co-scheduler (engine/batcher.py) calls
    `run_quantum` only while no interactive request waits and the engine
    is idle, and re-checks interactive arrivals at every quantum boundary.

    `chip_ceiling_tokens_per_s` is the operator's saturation figure for
    the card; without one `scoring_utilization` is not set.
    """

    def __init__(self, engine: Any, metrics: Optional[Any] = None, *,
                 max_job_texts: int = 4096, jobs_retained: int = 32,
                 chip_ceiling_tokens_per_s: Optional[float] = None):
        self.engine = engine
        self.metrics = metrics
        self.max_job_texts = max(1, max_job_texts)
        self.jobs_retained = max(1, jobs_retained)
        self.chip_ceiling_tokens_per_s = (
            None if chip_ceiling_tokens_per_s is None
            else max(1.0, chip_ceiling_tokens_per_s))
        # One quantum = one device batch = the largest batch bucket.
        self.quantum_texts = int(
            getattr(engine, "score_batch_cap", 0)
            or max(engine.config.batch_buckets)
        )
        self._jobs: "OrderedDict[str, ScoreJob]" = OrderedDict()  # guarded-by: _lock
        self._queue: Deque[str] = deque()                         # guarded-by: _lock
        self._lock = threading.Lock()
        # Loop-side wake handle: the queue's idle wait blocks on this, so
        # a job submitted to an idle server starts scoring at once
        # (created lazily on the serving loop).
        self._wake: Optional[asyncio.Event] = None
        # Recent (monotonic, scored tokens) quanta feeding the
        # scoring_tokens_per_s / scoring_utilization gauges.
        self._tok_window: Deque[Tuple[float, int]] = deque()  # guarded-by: _lock
        self._tok_window_s = 5.0
        # Aggregate stats (the healthz surface).
        self.total_quanta = 0            # guarded-by: _lock
        self.total_scored_tokens = 0     # guarded-by: _lock
        self.jobs_completed = 0          # guarded-by: _lock
        self.jobs_failed = 0             # guarded-by: _lock
        self.max_quantum_wall_s = 0.0    # guarded-by: _lock
        # Quanta run while interactive work waited: the admission policy
        # says this stays 0.
        self.quanta_with_pending = 0     # guarded-by: _lock

    # ------------------------------------------------------------ submit

    def submit(self, texts: Sequence[str], *, purpose: str = "adhoc",
               job_id: Optional[str] = None) -> Dict[str, Any]:
        """Queue one bulk job; returns its summary. Idempotent on
        `job_id`: a retried admin POST returns the existing job instead
        of scoring the corpus twice."""
        clean = [str(t) for t in texts if str(t).strip()]
        if not clean:
            raise ValueError("score job needs at least one non-empty text")
        if len(clean) > self.max_job_texts:
            raise ValueError(
                f"score job of {len(clean)} texts exceeds the admission "
                f"cap {self.max_job_texts} ([scoring] max_job_texts)"
            )
        jid = job_id or uuid.uuid4().hex[:12]
        with self._lock:
            existing = self._jobs.get(jid)
            if existing is not None:
                return existing.summary()
            job = ScoreJob(job_id=jid, purpose=str(purpose), texts=clean)
            self._jobs[jid] = job
            self._queue.append(jid)
            self._trim_locked()
        if self._wake is not None:
            self._wake.set()
        log.info("score job %s queued: %d texts (%s)", jid, len(clean),
                 purpose)
        return job.summary()

    def _trim_locked(self) -> None:  # guarded-by: _lock
        finished = [j for j in self._jobs.values() if j.finished]
        while len(finished) > self.jobs_retained:
            victim = finished.pop(0)
            self._jobs.pop(victim.job_id, None)

    # ----------------------------------------------------------- queries

    @property
    def has_work(self) -> bool:
        with self._lock:
            return any(
                not j.finished and j.cursor < len(j.texts)
                for j in self._jobs.values()
            )

    def done(self) -> bool:
        with self._lock:
            return all(j.finished for j in self._jobs.values())

    def current_job_id(self) -> Optional[str]:
        with self._lock:
            for jid in self._queue:
                job = self._jobs.get(jid)
                if job is not None and not job.finished:
                    return jid
        return None

    def job(self, job_id: str) -> Dict[str, Any]:
        """Full status (and results when done); KeyError when unknown."""
        with self._lock:
            return self._jobs[job_id].detail()

    def jobs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [j.summary() for j in self._jobs.values()]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "quantum_texts": self.quantum_texts,
                "jobs": len(self._jobs),
                "jobs_completed": self.jobs_completed,
                "jobs_failed": self.jobs_failed,
                "quanta": self.total_quanta,
                "scored_tokens": self.total_scored_tokens,
                "backlog_texts": sum(
                    len(j.texts) - j.cursor
                    for j in self._jobs.values() if not j.finished
                ),
                "max_quantum_wall_ms": round(
                    self.max_quantum_wall_s * 1000.0, 2
                ),
                "quanta_with_pending": self.quanta_with_pending,
            }

    # -------------------------------------------------------------- wake

    def wake_event(self) -> asyncio.Event:
        """The serving queue's idle wait blocks on this beside the
        interactive queue, so a submit to an idle server starts scoring
        without polling. Loop-confined (created on first use there)."""
        if self._wake is None:
            self._wake = asyncio.Event()
        if self.has_work:
            self._wake.set()
        return self._wake

    def clear_wake(self) -> None:
        if self._wake is not None:
            self._wake.clear()

    # ----------------------------------------------------------- quantum

    def run_quantum(self, interactive_pending: int = 0) -> bool:
        """Score ONE chunk (at most quantum_texts, one device batch) of the
        oldest live job; returns True when work was done. Runs in the
        serving queue's executor thread and never raises: a scoring
        failure fails the JOB, not the serving loop."""
        with self._lock:
            job = self._next_job_locked()
            if job is None:
                return False
            job.status = "running"
            chunk = list(job.texts[job.cursor:job.cursor
                                   + self.quantum_texts])
        t0 = time.monotonic()
        try:
            results = self.engine.score(chunk)
        except Exception as e:  # the job fails; serving keeps going
            log.exception("score job %s failed at text %d", job.job_id,
                          job.cursor)
            with self._lock:
                job.status = "failed"
                job.error = f"{type(e).__name__}: {e}"
                job.finished_unix = time.time()
                self.jobs_failed += 1
            self._emit_metrics(0, 0, job_failed=True)
            return True
        wall_s = time.monotonic() - t0
        tokens = sum(int(r["tokens"]) for r in results)
        truncated = sum(1 for r in results if r.get("truncated"))
        with self._lock:
            job.results.extend(results)
            job.cursor += len(chunk)
            job.quanta += 1
            job.scored_tokens += tokens
            job.truncated_texts += truncated
            job_done = job.cursor >= len(job.texts)
            if job_done:
                job.status = "done"
                job.finished_unix = time.time()
                self.jobs_completed += 1
            self.total_quanta += 1
            self.total_scored_tokens += tokens
            self.max_quantum_wall_s = max(self.max_quantum_wall_s, wall_s)
            if interactive_pending > 0:
                self.quanta_with_pending += 1
        self._emit_metrics(tokens, truncated, job_done=job_done)
        return True

    def _next_job_locked(self) -> Optional[ScoreJob]:  # guarded-by: _lock
        while self._queue:
            job = self._jobs.get(self._queue[0])
            if job is None or job.finished:
                self._queue.popleft()
                continue
            return job
        return None

    def _emit_metrics(self, tokens: int, truncated: int, *,
                      job_done: bool = False,
                      job_failed: bool = False) -> None:
        if self.metrics is None:
            return
        self.metrics.inc(metric.SCORING_QUANTA)
        if tokens:
            self.metrics.inc(metric.SCORING_SCORED_TOKENS, tokens)
        if truncated:
            self.metrics.inc(metric.SCORE_TRUNCATED_TEXTS, truncated)
        if job_done:
            self.metrics.inc(metric.SCORING_JOBS_COMPLETED)
        if job_failed:
            self.metrics.inc(metric.SCORING_JOBS_FAILED)
        now = time.monotonic()
        with self._lock:
            self._tok_window.append((now, tokens))
            cutoff = now - self._tok_window_s
            while self._tok_window and self._tok_window[0][0] < cutoff:
                self._tok_window.popleft()
            span = now - self._tok_window[0][0]
            window_tokens = sum(n for _, n in self._tok_window)
        if span > 0.2:
            tps = window_tokens / span
            self.metrics.set_gauge(metric.SCORING_TOKENS_PER_S, tps)
            if self.chip_ceiling_tokens_per_s is not None:
                self.metrics.set_gauge(
                    metric.SCORING_UTILIZATION,
                    tps / self.chip_ceiling_tokens_per_s)


def score_admin_get(path: str,
                    scorer: Optional[ScoringManager]) -> Dict[str, Any]:
    """GET /admin/score: the job list and the tenant's stats; GET
    /admin/score/<id>: one job's status, with per-text results once done.
    Raises KeyError for unknown paths and jobs (the admin plane answers
    404) and when the scoring tenant is off on this node."""
    if scorer is None:
        raise KeyError(path)
    if path == "/admin/score":
        return {"ok": True, "jobs": scorer.jobs(), "stats": scorer.stats()}
    prefix = "/admin/score/"
    if path.startswith(prefix) and len(path) > len(prefix):
        return {"ok": True, **scorer.job(path[len(prefix):])}
    raise KeyError(path)
