"""The port's bulk-scoring tenant on the CPU, against the JAX package's.

Counterparts of tests/test_scoring.py:

- per-text scores of both port engines (bucketed and paged, dense and
  int8 weights) against the JAX engines' `score` on the same weights (the
  JAX tree carried across with `params_from_jax`): `tokens` and
  `truncated` equal, `logprob` within SCORE_RTOL / SCORE_ATOL (float32;
  the two packages sum the same products in different orders);
- pad invariance: a text's logprob batched equals its logprob alone,
  across batch and length buckets;
- the truncation flag and the `score_truncated_texts` counter;
- `score_shapes` equal to the JAX `derive_score_shapes` (and the JAX
  engines'), and warmup running each shape once, only with scoring on;
- the job manager's chunking, resume, failure, admission cap and admin
  surface, with the JAX `ScoringManager` driven through the same script
  on the same stand-in engine and giving the same documents;
- the co-scheduler through both queues: an interactive request arriving
  mid-quantum waits at most one quantum (`score_preempt_wait_ms`), no
  quantum runs while interactive work waits (`quanta_with_pending` 0),
  and a job submitted to an idle server starts without traffic;
- the node's admin plane: POST/GET /admin/score and the healthz block.
"""

import asyncio
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import ScoringManager as JaxManager
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.engine import scoring as jax_scoring
from distributed_lms_raft_llm_tpu_torch.engine import (
    BatchingQueue,
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.engine import scoring
from distributed_lms_raft_llm_tpu_torch.engine.scoring import (
    ScoringManager,
    score_admin_get,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

# float32 scores, port against JAX on the same weights: relative to the
# text's |logprob| (tens to hundreds of nats here) plus an absolute floor.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-4
# Pad invariance within one package (the JAX test's tolerance).
PAD_RTOL, PAD_ATOL = 1e-4, 1e-4

LENGTHS, BATCHES = (16, 32), (1, 2, 4)
TEXTS = [
    "a",                                  # one token: no pair to score
    "raft logs",                          # the 16 bucket
    "leaders replicate the log",          # the 32 bucket
    "quorum",
    "a term " * 12,                       # past 32 tokens: truncated
]


def _jax_engine(kind, quant):
    kw = dict(model="tiny", length_buckets=LENGTHS, batch_buckets=BATCHES,
              dtype=jnp.float32, param_dtype=jnp.float32, quant=quant,
              kv_quant=bool(quant), scoring=True)
    if kind == "bucketed":
        return JaxEngine(JaxConfig(sampling=JaxSampling(max_new_tokens=4),
                                   **kw))
    return JaxPaged(JaxConfig(sampling=JaxSampling.greedy(max_new_tokens=4),
                              **kw), slots=2, chunk=2)


def _port_engine(kind, quant=None, scoring_on=True, **kw):
    kw.setdefault("length_buckets", LENGTHS)
    kw.setdefault("batch_buckets", BATCHES)
    config = EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=4),
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        quant=quant, kv_quant=bool(quant), scoring=scoring_on, **kw)
    if kind == "bucketed":
        return TutoringEngine(config)
    return PagedEngine(config, slots=2, chunk=2)


@pytest.fixture(scope="module", params=[("bucketed", None),
                                        ("bucketed", "int8"),
                                        ("paged", None), ("paged", "int8")],
                ids=lambda p: f"{p[0]}-{p[1] or 'dense'}")
def pair(request):
    """(JAX engine, the port's engine on its weights)."""
    kind, quant = request.param
    jeng = _jax_engine(kind, quant)
    eng = _port_engine(kind, quant)
    eng.params = params_from_jax(jax.device_get(jeng.params), device="cpu")
    return jeng, eng


def test_scores_match_the_jax_engines(pair):
    jeng, eng = pair
    want, got = jeng.score(TEXTS), eng.score(TEXTS)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["truncated"] for g in got] == [w["truncated"] for w in want]
    assert [w["truncated"] for w in want] == [False] * 4 + [True]
    np.testing.assert_allclose([g["logprob"] for g in got],
                               [w["logprob"] for w in want],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose([g["ppl"] for g in got],
                               [w["ppl"] for w in want], rtol=1e-4)


def test_score_shapes_match_the_jax_derivation(pair):
    jeng, eng = pair
    want = jax_scoring.derive_score_shapes(LENGTHS, BATCHES,
                                           eng.cfg.max_position_embeddings)
    assert eng.score_shapes == [tuple(s) for s in want] == [
        tuple(s) for s in jeng.score_shapes]
    assert eng.score_batch_cap == jeng.score_batch_cap == max(BATCHES)


@pytest.mark.parametrize("kind", ["bucketed", "paged"])
def test_batched_equals_singleton_across_buckets(kind):
    """Pad invariance: a text's logprob does not depend on the (batch,
    length) bucket its companions forced it into."""
    eng = _port_engine(kind)
    texts = TEXTS[1:4] + ["logs"]
    batched = eng.score(texts)  # mixed lengths: the 32 bucket, batch 4
    for text, got in zip(texts, batched):
        [alone] = eng.score([text])  # its own smallest buckets
        assert alone["tokens"] == got["tokens"]
        np.testing.assert_allclose(got["logprob"], alone["logprob"],
                                   rtol=PAD_RTOL, atol=PAD_ATOL)


def test_truncated_flag_marks_prefix_scores():
    eng = _port_engine("bucketed", length_buckets=(8,), batch_buckets=(1, 2))
    long_text = " ".join(["raft"] * 30)
    res = eng.score(["raft", long_text])
    assert [r["truncated"] for r in res] == [False, True]
    # The truncated score really is the prefix's score.
    prefix = eng.tokenizer.decode(eng.tokenizer.encode(long_text)[:8])
    [alone] = eng.score([prefix])
    assert alone["tokens"] == res[1]["tokens"] == 7
    np.testing.assert_allclose(res[1]["logprob"], alone["logprob"],
                               rtol=PAD_RTOL, atol=PAD_ATOL)
    metrics = Metrics()
    mgr = ScoringManager(eng, metrics=metrics)
    mgr.submit(["raft", long_text, long_text])
    while mgr.run_quantum():
        pass
    assert metrics.snapshot()["counters"]["score_truncated_texts"] == 2


def test_groups_past_the_batch_cap_run_as_several_batches():
    eng = _port_engine("bucketed", batch_buckets=(1, 2))
    shapes = []
    program = eng._score
    eng._score = lambda p, ids, mask: (shapes.append(tuple(ids.shape)),
                                       program(p, ids, mask))[1]
    res = eng.score(TEXTS)
    assert len(res) == len(TEXTS)
    assert shapes == [(2, 16), (2, 32), (1, 32)]
    assert [n for n, _, _ in eng.pop_program_times()] == ["score"] * 3


@pytest.mark.parametrize("kind", ["bucketed", "paged"])
@pytest.mark.parametrize("on", [True, False])
def test_warmup_runs_each_score_shape_once(kind, on):
    eng = _port_engine(kind, scoring_on=on)
    seen = []
    program = eng._score
    eng._score = lambda p, ids, mask: (seen.append(tuple(ids.shape)),
                                       program(p, ids, mask))[1]
    if kind == "bucketed":
        eng.warmup(batch=2, bucket=16)
    else:
        eng.warmup()
    assert sorted(seen) == eng.score_shapes
    assert len(seen) == (len(LENGTHS) * len(BATCHES) if on else 0)


# ------------------------------------------------------ the job manager


class SlowScoreEngine:
    """Deterministic stand-in for the scoring contract, with a controllable
    quantum wall, for the manager and co-scheduler tests (the JAX test's)."""

    score_batch_cap = 2

    def __init__(self, quantum_s: float = 0.0, fail_at: int = -1):
        self.quantum_s = quantum_s
        self.fail_at = fail_at
        self.calls = 0

    def answer_batch(self, prompts):
        return [f"ans:{p}" for p in prompts]

    def score(self, texts):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected score failure")
        if self.quantum_s:
            time.sleep(self.quantum_s)
        return [
            {"logprob": -2.0 * max(1, len(t.split())),
             "tokens": max(1, len(t.split())), "ppl": 7.389,
             "truncated": t.startswith("LONG")}
            for t in texts
        ]


def _without_clock(doc):
    return {k: v for k, v in doc.items()
            if k not in ("submitted_unix", "finished_unix",
                         "max_quantum_wall_ms")}


def _chunk_script(manager_cls):
    """Submit, resubmit (idempotent), drain quantum by quantum; returns
    every document the manager produced and its counters."""
    metrics = Metrics()
    mgr = manager_cls(SlowScoreEngine(), metrics=metrics)
    docs = [mgr.submit(["a b", "c", "d e f", "g", "LONG x"],
                       purpose="grading", job_id="j1"),
            mgr.submit(["ignored"], job_id="j1")]
    quanta = 0
    while mgr.has_work:
        assert mgr.run_quantum()
        quanta += 1
        docs.append(mgr.job("j1"))
    assert not mgr.run_quantum()  # drained
    docs.append(mgr.stats())
    return ([_without_clock(d) for d in docs], quanta,
            metrics.snapshot()["counters"])


def test_jobs_chunk_resume_and_complete_as_in_jax():
    docs, quanta, counters = _chunk_script(ScoringManager)
    assert _chunk_script(JaxManager)[:2] == (docs, quanta)
    assert quanta == 3  # ceil(5 / cap 2)
    detail = docs[-2]
    assert detail["status"] == "done" and len(detail["results"]) == 5
    assert detail["truncated_texts"] == 1
    assert docs[1]["texts"] == 5  # the retried POST: the same job
    assert counters["scoring_quanta"] == 3
    assert counters["scoring_jobs_completed"] == 1
    assert counters["score_truncated_texts"] == 1
    assert counters["scoring_scored_tokens"] == detail["scored_tokens"] > 0


@pytest.mark.parametrize("manager_cls", [ScoringManager, JaxManager],
                         ids=["port", "jax"])
def test_job_failure_fails_the_job_not_the_tenant(manager_cls):
    metrics = Metrics()
    mgr = manager_cls(SlowScoreEngine(fail_at=1), metrics=metrics)
    mgr.submit(["a", "b"], job_id="bad")
    mgr.submit(["c"], job_id="good")
    assert mgr.run_quantum()  # fails the first job internally
    bad = mgr.job("bad")
    assert bad["status"] == "failed" and bad["results"] is None
    assert bad["error"] == "RuntimeError: injected score failure"
    while mgr.has_work:
        mgr.run_quantum()
    assert mgr.job("good")["status"] == "done"
    counters = metrics.snapshot()["counters"]
    assert counters["scoring_jobs_failed"] == 1
    assert counters["scoring_jobs_completed"] == 1


@pytest.mark.parametrize("manager_cls", [ScoringManager, JaxManager],
                         ids=["port", "jax"])
def test_admission_caps_and_retention(manager_cls):
    mgr = manager_cls(SlowScoreEngine(), max_job_texts=3, jobs_retained=1)
    with pytest.raises(ValueError, match="admission cap"):
        mgr.submit(["x"] * 4)
    with pytest.raises(ValueError, match="non-empty"):
        mgr.submit(["", "  "])
    for jid in ("one", "two", "three"):
        mgr.submit(["a"], job_id=jid)  # trims the finished beyond one
        mgr.run_quantum()
    assert [j["job_id"] for j in mgr.jobs()] == ["two", "three"]


def test_admin_get_surface_as_in_jax():
    docs = []
    for manager_cls, admin_get in ((ScoringManager, score_admin_get),
                                   (JaxManager, jax_scoring.score_admin_get)):
        mgr = manager_cls(SlowScoreEngine())
        mgr.submit(["a"], job_id="jj")
        listing = admin_get("/admin/score", mgr)
        got = admin_get("/admin/score/jj", mgr)
        assert listing["ok"] and listing["stats"]["backlog_texts"] == 1
        assert got["status"] == "queued" and got["results"] is None
        for path, scorer in (("/admin/score/nope", mgr),
                             ("/admin/scorex", mgr),
                             ("/admin/score", None)):
            with pytest.raises(KeyError):
                admin_get(path, scorer)
        docs.append((_without_clock(listing["jobs"][0]), listing["stats"],
                     _without_clock(got)))
    assert docs[0] == docs[1]


def test_utilization_is_set_only_against_a_ceiling():
    """The port has no default chip ceiling (the JAX default is a TPU
    figure): without one only scoring_tokens_per_s is set."""
    gauges = []
    for ceiling in (None, 1000.0):
        metrics = Metrics()
        mgr = ScoringManager(SlowScoreEngine(quantum_s=0.15),
                             metrics=metrics,
                             chip_ceiling_tokens_per_s=ceiling)
        mgr.submit(["a b"] * 6)
        while mgr.run_quantum():
            pass
        gauges.append(metrics.snapshot().get("gauges", {}))
    assert "scoring_utilization" not in gauges[0]
    assert gauges[0]["scoring_tokens_per_s"] > 0
    assert gauges[1]["scoring_utilization"] == pytest.approx(
        gauges[1]["scoring_tokens_per_s"] / 1000.0)


# ------------------------------------------------- queue co-scheduling


class SlowPaged(PagedEngine):
    """The real tiny paged engine whose score quantum takes at least
    `quantum_s` of wall time."""

    quantum_s = 0.4

    def score(self, texts):
        t0 = time.monotonic()
        out = super().score(texts)
        time.sleep(max(0.0, self.quantum_s - (time.monotonic() - t0)))
        return out


def _queue(kind, metrics, scorer, engine):
    if kind == "batching":
        return BatchingQueue(engine, max_batch=2, max_wait_ms=1.0,
                             metrics=metrics, scorer=scorer)
    return PagedQueue(engine, metrics=metrics, scorer=scorer)


@pytest.mark.parametrize("kind", ["batching", "paged"])
def test_preemption_wait_bounded_by_one_quantum(kind):
    """An interactive request arriving mid-quantum is admitted after at
    most ONE quantum, and the wait is recorded in score_preempt_wait_ms."""
    if kind == "batching":
        engine = SlowScoreEngine(quantum_s=0.4)
    else:
        engine = SlowPaged(EngineConfig(
            model="tiny", sampling=SamplingParams.greedy(max_new_tokens=4),
            length_buckets=(16,), batch_buckets=(1, 2), scoring=True,
            dtype=torch.float32, param_dtype=torch.float32, device="cpu"),
            slots=2, chunk=2)
        engine.warmup()

    async def run():
        metrics = Metrics()
        scorer = ScoringManager(engine, metrics=metrics)
        q = _queue(kind, metrics, scorer, engine)
        await q.start()
        scorer.submit(["t one", "t two", "t three", "t four"])
        await asyncio.sleep(0.1)  # the first quantum is in flight
        t0 = time.monotonic()
        answer = await q.submit("hello")
        wait_s = time.monotonic() - t0
        while not scorer.done():
            await asyncio.sleep(0.01)
        await q.close()
        return answer, wait_s, metrics.snapshot(), scorer, q

    answer, wait_s, snap, scorer, q = asyncio.run(run())
    assert isinstance(answer, str)
    # Arrived ~0.1 s into a 0.4 s quantum: served after that quantum, never
    # after the whole job (4 texts, 2 quanta).
    assert wait_s < 0.4 + 0.35, f"waited {wait_s:.3f}s"
    assert snap["counters"]["score_preempt_wait_ms"] >= 1
    assert 0 < q.max_preempt_wait_s <= q.max_quantum_window_s
    assert q.max_quantum_window_s <= scorer.max_quantum_wall_s + 0.05
    stats = scorer.stats()
    assert stats["quanta_with_pending"] == 0
    assert stats["jobs_completed"] == 1 and stats["quanta"] == 2
    assert snap["latency"].get("engine_prog_score", {}).get("count", 0) == (
        0 if kind == "batching" else 2)  # the stand-in reports no times


def test_paged_queue_harvests_idle_lanes_real_engine():
    """Through the real paged engine: interactive answers resolve, the bulk
    job completes in the idle gaps, and no quantum runs while anything
    interactive is pending."""
    eng = _port_engine("paged", batch_buckets=(1, 2))
    eng.warmup()
    plain = _port_engine("paged", batch_buckets=(1, 2))
    corpus = [f"course text number {i} about raft logs" for i in range(5)]

    async def run():
        metrics = Metrics()
        scorer = ScoringManager(eng, metrics=metrics)
        q = PagedQueue(eng, metrics=metrics, scorer=scorer)
        await q.start()
        scorer.submit(corpus, purpose="relevance", job_id="rel")
        answers = await asyncio.gather(q.submit("what is a term?"),
                                       q.submit("who votes?"))
        while not scorer.done():
            await asyncio.sleep(0.01)
        await q.close()
        return answers, scorer, metrics.snapshot()

    answers, scorer, snap = asyncio.run(run())
    assert all(isinstance(a, str) for a in answers)
    stats = scorer.stats()
    assert stats["jobs_completed"] == 1
    assert stats["quanta"] == 3  # ceil(5 / batch cap 2)
    assert stats["quanta_with_pending"] == 0
    assert snap["counters"]["scoring_scored_tokens"] > 0
    # The same scores the engine gives directly, interleaved or not.
    plain.params = eng.params
    want = plain.score(corpus)
    got = scorer.job("rel")["results"]
    np.testing.assert_allclose([g["logprob"] for g in got],
                               [w["logprob"] for w in want],
                               rtol=PAD_RTOL, atol=PAD_ATOL)


@pytest.mark.parametrize("kind", ["batching", "paged"])
def test_scorer_wake_starts_idle_server(kind):
    """A job submitted to an IDLE queue starts scoring without any
    interactive traffic to kick the runner."""
    engine = (SlowScoreEngine() if kind == "batching"
              else _port_engine("paged", batch_buckets=(1, 2)))

    async def run():
        scorer = ScoringManager(engine)
        q = _queue(kind, Metrics(), scorer, engine)
        await q.start()
        await asyncio.sleep(0.05)  # the runner parked on the idle wait
        scorer.submit(["a", "b", "c"])
        for _ in range(500):
            if scorer.done():
                break
            await asyncio.sleep(0.01)
        await q.close()
        return scorer.stats()

    stats = asyncio.run(run())
    assert stats["jobs_completed"] == 1 and stats["quanta"] == 2


# ------------------------------------------------------- the admin plane


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload or b"null")


@pytest.mark.parametrize("scoring_on", [True, False])
def test_admin_plane_serves_the_score_jobs(scoring_on):
    engine = _port_engine("bucketed", batch_buckets=(1, 2))

    async def run():
        server = await tutoring_server.serve_async(
            0, engine, host="127.0.0.1", metrics_port=0,
            scoring=scoring_on, node_id="port-1")
        port = server._health.port
        try:
            posted = await _http(port, "POST", "/admin/score",
                                 {"texts": ["raft logs", "a term"],
                                  "purpose": "grading", "job_id": "g1"})
            if not scoring_on:
                return posted, None, None
            for _ in range(500):
                code, doc = await _http(port, "GET", "/admin/score/g1")
                if doc.get("status") == "done":
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.25)  # a watchdog heartbeat or two
            health = await _http(port, "GET", "/healthz")
            metrics = await _http(port, "GET", "/metrics")
            return posted, (code, doc), (health, metrics)
        finally:
            await server.stop(0)
            await server._queue.close()

    posted, job, extra = asyncio.run(run())
    if not scoring_on:
        assert posted[0] == 404  # as on a JAX node without the tenant
        return
    assert posted[0] == 200 and posted[1]["job_id"] == "g1"
    assert posted[1]["node_id"] == "port-1"
    code, doc = job
    assert code == 200 and doc["status"] == "done"
    want = engine.score(["raft logs", "a term"])
    assert [r["tokens"] for r in doc["results"]] == [w["tokens"]
                                                    for w in want]
    np.testing.assert_allclose([r["logprob"] for r in doc["results"]],
                               [w["logprob"] for w in want],
                               rtol=PAD_RTOL, atol=PAD_ATOL)
    (hcode, health), (_, snap) = extra
    assert hcode == 200 and health["scoring"]["jobs_completed"] == 1
    assert snap["counters"]["scoring_quanta"] == 1
    assert snap["latency"]["engine_prog_score"]["count"] == 1
    assert "serving_tick_lag" in snap["latency"]
