"""Tutoring server: `Tutoring.GetLLMAnswer` and `StreamLLMAnswer` on the
PyTorch engine.

Port of `distributed_lms_raft_llm_tpu/serving/tutoring_server.py`. It
speaks the frozen `lms.proto`, so the JAX package's LMS and its
`TutoringPool` forward to it unchanged, beside JAX tutoring nodes.
Concurrent RPCs coalesce in `BatchingQueue` into device batches of the
bucketed `TutoringEngine`, or, with ``--paged``, join the running batch of
the continuous-batching `PagedEngine` through `PagedQueue`.

`StreamLLMAnswer` keeps the resumable-stream contract (token offsets,
`resume_offset`, the sha256 digest of the stripped answer on the final
chunk) and tutoring sessions (`session_id`: turn N+1 extends turn N's
transcript, whose KV the paged engine's prefix cache keeps pinned).
With ``--metrics-port`` the node serves `/healthz`, `/metrics`,
`/metrics.prom`, ``POST /admin/drain``, ``GET /admin/trace[/<id>]`` and
``GET /admin/timeline`` (the telemetry ring, `utils/timeline.py`; off with
``--no-telemetry``); every RPC continues the caller's `x-trace-context`.
A heartbeat watchdog on the serving loop reports `serving_tick_lag` and
`serving_tick_stalls`.

With ``--scoring`` the node runs the background bulk-scoring tenant
(`engine/scoring.py`): warmup covers the score program's shapes, ``POST
/admin/score {"texts": [...], "purpose": ..., "job_id": ...}`` queues a
job, ``GET /admin/score[/<id>]`` reads it back, and quanta run only while
no interactive request waits. The JAX package's LMS sends its bulk-grading
jobs here (`TutoringPool.submit_score_job`).

Run (on the card; ``--device cpu`` for a CPU run), from the deployment
file (explicit flags win over it):

    python -m distributed_lms_raft_llm_tpu_torch.serving.tutoring_server \\
        --config configs/cluster.toml [--metrics-port 9104]

or with flags alone: ``[--port 50054] [--model gpt2] [--checkpoint
model.safetensors ...]``. The production tutoring node (configs/
cluster.toml ``[tutoring]``, ``[scoring]``): ``--paged --quant int8
--kv-quant --slots 16 --chunk 16 --inflight 3 --megastep 4 --megastep-max 8
--prefix-cache --prefix-cache-blocks 512 --prefill-chunk-tokens 32
--scoring``, and with speculative decoding (commented out there)
``--spec-tokens 8 --draft-source prompt_lookup``. On the card the paged
engine's warmup captures its CUDA graphs before the server listens, so
``--no-warmup`` is refused with ``--paged`` there.

``--strict-dispatch`` makes every unmarked host sync raise once the
engine is warm (`utils/guards.py`); ``--approx-topk`` (``[sampling]
approx_top_k``) is accepted and samples the exact top-k
(`engine/sampling.py`). Every ``metrics_period_s`` (60 s) the node logs one
``metrics {json}`` line, as the JAX node does.

``--tp N`` (``[tutoring] tp``) shards the model over N ranks, one process
each (`parallel/`): started alone, the node is rank 0 and spawns N - 1
follower processes of itself, which rendezvous with it on the loopback
(``--tp-backend``: nccl, one GPU a rank, the default; gloo where the ranks
share a card or run on the CPU). Under torchrun each process takes its rank
from the environment. Every rank builds the same engine; rank 0 alone
serves gRPC and the health plane, and the other ranks replay its engine
calls (`PagedEngine.follow`). ``--ep M`` (``[tutoring] ep``, an MoE
model) shards its experts over M ranks the same way: the node runs
N x M ranks, spawned and joined as above. ``/healthz`` adds ``tp`` and
``ep`` when above 1, and ``/metrics`` the ``serving_tp`` and
``serving_kv_bytes_per_chip`` gauges. Under torchrun the node's ranks are
the whole ``WORLD_SIZE``, which must be a multiple of N x M: dp takes the
rest, as the JAX node's dp takes the spare devices, so ``WORLD_SIZE`` 2
at ``--tp 1`` serves at dp 2, rank 1 following rank 0 and serving no port
of its own; ``/healthz`` adds ``dp`` when above 1. A node started alone
starts N x M ranks (a process started alone has no spare devices to take).
A call that fails on any rank fails them all (`parallel/spmd.py`): a
follower exits non-zero, and rank 0 ends (exit code 1) once a follower it
started has exited (`watch_followers`); under torchrun the launcher ends
the other ranks.

Not ported: the JAX node's ``--jax-platform`` (an unknown flag here;
``--device`` stands in its place).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import hashlib
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import grpc
import torch

from ..engine import (
    BatchingQueue,
    EngineConfig,
    PagedEngine,
    PagedQueue,
    TutoringEngine,
)
from ..config import apply_file_defaults, engine_config, load_config
from ..engine.engine import DRAFT_SOURCES
from ..engine.scoring import ScoringManager, score_admin_get
from ..models import registry
from ..parallel import mesh as mesh_lib
from ..proto import lms_pb2, rpc
from ..utils import auth
from ..utils.guards import enable_strict_dispatch, make_serving_watchdog
from ..utils.healthz import HealthServer
from ..utils.metrics import Metrics
from ..utils.resilience import (
    QUEUE_DEPTH_METADATA_KEY,
    SERVED_BY_METADATA_KEY,
    Deadline,
    DeadlineExpired,
    Overloaded,
)
from ..utils.timeline import TimelineSampler, timeline_admin_get
from ..utils.tracing import (
    configure_from,
    get_tracer,
    trace_admin_get,
    traced_grpc_handler,
)
from .prompts import FOLLOWUP_TEMPLATE, PROMPT_TEMPLATE

log = logging.getLogger("tutoring_server")

__all__ = ["FOLLOWUP_TEMPLATE", "PROMPT_TEMPLATE", "TutoringService",
           "build_parser", "engine_from_args", "make_tutoring_admin",
           "make_tutoring_health", "read_auth_key", "resolve_args",
           "serve_args", "serve_async", "main"]

DRAINING = "draining: this tutoring node is not admitting new work"


class TutoringService(rpc.TutoringServicer):
    def __init__(self, queue, metrics: Metrics,
                 auth_key: Optional[str] = None,
                 node_id: Optional[str] = None,
                 session_ttl_s: float = 600.0,
                 session_max: int = 256):
        self.queue = queue
        self.metrics = metrics
        self.auth_key = auth_key
        # Fleet identity: rides every answer's trailing metadata.
        self.node_id = node_id
        self.draining = False
        # Tutoring sessions: session_id -> (transcript, expiry). The
        # transcript is the byte-exact prompt + answer of every turn served
        # HERE, so turn N+1's prompt extends it verbatim and the prefix
        # cache splices turn N's KV. Node-local: a session that lands on
        # another node restarts its transcript there and loses only cache
        # warmth, never correctness.
        self.session_ttl_s = float(session_ttl_s)
        self.session_max = int(session_max)
        self._sessions: Dict[str, Tuple[str, float]] = {}  # event loop only

    def set_draining(self, draining: bool) -> None:
        """POST /admin/drain: stop admitting new queries while in-flight
        work finishes. The fleet router reads `draining` on /healthz (or
        the UNAVAILABLE refusal) and takes the node out of its ring."""
        self.draining = bool(draining)
        self.metrics.set_gauge("tutoring_draining",
                               1.0 if self.draining else 0.0)
        log.info("tutoring node %s %s", self.node_id or "(unnamed)",
                 "draining: admission stopped" if self.draining
                 else "drain ended: admitting again")

    def _session_transcript(self, session_id: str) -> str:
        """Live transcript of `session_id` ('' = new or expired)."""
        entry = self._sessions.get(session_id)
        if entry is None:
            return ""
        text, expiry = entry
        if time.monotonic() >= expiry:
            self._drop_session(session_id)
            return ""
        return text

    def _session_update(self, session_id: str, transcript: str) -> None:
        """Record the turn's prompt + answer, refresh the TTL, and hold the
        cap (the soonest-expiring sessions go first, their prefix pins
        released back to plain LRU)."""
        self._sessions[session_id] = (transcript,
                                      time.monotonic() + self.session_ttl_s)
        while self.session_max and len(self._sessions) > self.session_max:
            oldest = min(self._sessions, key=lambda s: self._sessions[s][1])
            self._drop_session(oldest)
        self.metrics.set_gauge("session_active", float(len(self._sessions)))

    def _drop_session(self, session_id: str) -> None:
        self._sessions.pop(session_id, None)
        release = getattr(getattr(self.queue, "engine", None),
                          "release_session", None)
        if release is not None:
            release(session_id)
        self.metrics.set_gauge("session_active", float(len(self._sessions)))

    def _trailer(self, context) -> None:
        """Who served the answer, and the live queue depth (a passive load
        signal for the router). Buffered until the RPC completes; direct
        servicer-level callers pass context=None."""
        if context is not None:
            trailer = [(QUEUE_DEPTH_METADATA_KEY, str(self.queue.waiting))]
            if self.node_id:
                trailer.append((SERVED_BY_METADATA_KEY, self.node_id))
            context.set_trailing_metadata(tuple(trailer))

    @traced_grpc_handler("tutoring.GetLLMAnswer")
    async def GetLLMAnswer(self, request, context):
        self.metrics.inc("llm_requests")
        self._trailer(context)
        if self.draining:
            self.metrics.inc("tutoring_drain_rejections")
            if context is not None:
                await context.abort(grpc.StatusCode.UNAVAILABLE, DRAINING)
            return lms_pb2.QueryResponse(success=False, response=DRAINING)
        if self.auth_key and not auth.verify_query(
            self.auth_key, request.query, request.token
        ):
            # Only the LMS leader holds the key: direct dials cannot bypass
            # the session check and the relevance gate.
            self.metrics.inc("llm_unauthorized")
            return lms_pb2.QueryResponse(
                success=False, response="Unauthorized: query the LMS, not "
                "the tutoring node."
            )
        if not request.query.strip():
            return lms_pb2.QueryResponse(success=False, response="Empty query.")
        # The caller's remaining budget rides in on the gRPC deadline and/or
        # the budget header; a request that expires while queued is shed
        # before its prefill.
        deadline = Deadline.from_grpc_context(context)
        if deadline is not None and deadline.expired:
            self.metrics.inc("shed_expired")
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "deadline already expired on arrival")
        prompt = PROMPT_TEMPLATE.format(query=request.query)
        try:
            with self.metrics.time("answer_latency"):
                # The handler's span rides into the queue explicitly: the
                # queue runs on other tasks (the engine in an executor
                # thread), where this handler's contextvars are not set.
                answer = await self.queue.submit(
                    prompt, deadline=deadline, span=get_tracer().current())
        except Overloaded as e:
            if context is None:
                raise
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeadlineExpired as e:
            if context is None:
                raise
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except Exception:
            log.exception("generation failed")
            self.metrics.inc("llm_failures")
            return lms_pb2.QueryResponse(
                success=False, response="The tutoring model is unavailable."
            )
        return lms_pb2.QueryResponse(success=True, response=answer.strip())

    @traced_grpc_handler("tutoring.StreamLLMAnswer")
    async def StreamLLMAnswer(self, request, context):
        """Server-streaming tutoring answer (the resumable-stream contract).

        Chunk offsets count tokens and are monotone and gap-free;
        `request.resume_offset = K` regenerates deterministically and
        delivers only tokens >= K (the failover path: the pool resumes a
        broken stream at the client's delivered offset). The final chunk
        carries the sha256 hexdigest of the whole stripped answer, which is
        what the unary GetLLMAnswer returns, so a resumed client checks its
        spliced transcript against it.

        `request.session_id` makes the turn conversational: the prompt
        extends this node's transcript of the session (turn N's prompt +
        answer), and the finished turn is published and pinned so the
        prefix cache serves turn N+1's shared prefix from cached KV.
        """
        self.metrics.inc("llm_requests")
        self._trailer(context)
        if self.draining:
            self.metrics.inc("tutoring_drain_rejections")
            if context is not None:
                await context.abort(grpc.StatusCode.UNAVAILABLE, DRAINING)
            yield lms_pb2.StreamChunk(success=False, final=True,
                                      text=DRAINING)
            return
        if self.auth_key and not auth.verify_query(
            self.auth_key, request.query, request.token
        ):
            self.metrics.inc("llm_unauthorized")
            yield lms_pb2.StreamChunk(
                success=False, final=True,
                text="Unauthorized: query the LMS, not the tutoring node.")
            return
        if not request.query.strip():
            yield lms_pb2.StreamChunk(success=False, final=True,
                                      text="Empty query.")
            return
        deadline = Deadline.from_grpc_context(context)
        if deadline is not None and deadline.expired:
            self.metrics.inc("shed_expired")
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "deadline already expired on arrival")
        # A session turn extends the running transcript verbatim (a
        # byte-stable prefix); a fresh stream frames the query exactly as
        # the unary path does, so the two answers are identical.
        session_id = request.session_id
        transcript = (self._session_transcript(session_id) if session_id
                      else "")
        if transcript:
            prompt = transcript + FOLLOWUP_TEMPLATE.format(query=request.query)
        else:
            prompt = PROMPT_TEMPLATE.format(query=request.query)
        session = (session_id, self.session_ttl_s) if session_id else None
        sent_any = False
        try:
            with self.metrics.time("answer_latency"):
                async for delta in self.queue.submit_stream(
                        prompt, deadline=deadline,
                        span=get_tracer().current(),
                        resume_offset=request.resume_offset,
                        session=session):
                    self.metrics.inc("stream_chunks")
                    if delta.final:
                        full = delta.full_text
                        if session_id:
                            self._session_update(session_id, prompt + full)
                        yield lms_pb2.StreamChunk(
                            success=True, text=delta.text,
                            offset=delta.offset, count=delta.count,
                            final=True,
                            digest=hashlib.sha256(
                                full.strip().encode()).hexdigest())
                    else:
                        yield lms_pb2.StreamChunk(
                            success=True, text=delta.text,
                            offset=delta.offset, count=delta.count)
                    sent_any = True
        except Overloaded as e:
            if context is None:
                raise
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeadlineExpired as e:
            if context is None:
                raise
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("streamed generation failed")
            self.metrics.inc("llm_failures")
            if not sent_any:
                # Nothing delivered yet: fail softly, like the unary path.
                yield lms_pb2.StreamChunk(
                    success=False, final=True,
                    text="The tutoring model is unavailable.")
            elif context is not None:
                # Delivered text cannot be retracted: a hard error, so the
                # pool resumes at the client's offset.
                await context.abort(grpc.StatusCode.INTERNAL,
                                    "stream broken mid-answer")


def make_tutoring_admin(service: TutoringService, scorer=None):
    """POST handler of the node's admin plane.

    POST /admin/drain {"drain": true|false} stops or resumes admission;
    in-flight work finishes, and the fleet router takes the node out of
    its ring while it drains.

    POST /admin/score {"texts": [...], "purpose": "grading"|...,
    "job_id"?} queues one bulk job on the scoring tenant (idempotent on
    job_id); progress and results are read back at GET
    /admin/score[/<job-id>]. 404 without the tenant, as on a JAX node."""

    async def admin(path: str, body: dict) -> dict:
        if path == "/admin/drain":
            service.set_draining(bool(body.get("drain", True)))
            return {"ok": True, "draining": service.draining,
                    "node_id": service.node_id}
        if path == "/admin/score":
            if scorer is None:
                raise KeyError(path)  # scoring tenant off: 404
            texts = body.get("texts")
            if not isinstance(texts, list):
                raise ValueError("score job needs 'texts': [str, ...]")
            job = scorer.submit(
                texts, purpose=str(body.get("purpose", "adhoc")),
                job_id=(str(body["job_id"]) if body.get("job_id")
                        else None))
            return {"ok": True, "node_id": service.node_id, **job}
        raise KeyError(path)

    return admin


def make_tutoring_health(service: TutoringService, queue, engine_name: str,
                         max_queue: int, spec_tokens: int = 0,
                         draft_source: str = "prompt_lookup", scorer=None,
                         tp: int = 1, ep: int = 1, dp: int = 1):
    """/healthz provider: admission pressure and the fleet lifecycle (the
    router's health poller reads `draining`, `queued` and `node_id`); a
    speculating node adds its `spec_tokens` and `draft_source`, a scoring
    node its tenant's stats (`scoring`), as a JAX node adds its scoring
    block only when it scores, and a sharded node its `tp`, `ep` and `dp`
    ways (the JAX node reports tp as the `serving_tp` gauge alone), so a
    node without any of them answers with the JAX node's fields alone."""

    def health() -> dict:
        doc = {
            "ok": True,
            "engine": engine_name,
            "node_id": service.node_id,
            "queue_depth_limit": max_queue,
            "queued": queue.waiting,
            "draining": service.draining,
            "sessions": len(service._sessions),
        }
        if spec_tokens > 0:
            doc.update(spec_tokens=spec_tokens, draft_source=draft_source)
        if scorer is not None:
            doc["scoring"] = scorer.stats()
        if tp > 1:
            doc["tp"] = tp
        if ep > 1:
            doc["ep"] = ep
        if dp > 1:
            doc["dp"] = dp
        return doc

    return health


async def _report_metrics(metrics: Metrics, period_s: float) -> None:
    """One `metrics {json}` log line a period (the JAX node's)."""
    while True:
        await asyncio.sleep(period_s)
        log.info("metrics %s", json.dumps(metrics.snapshot()))


async def serve_async(port: int, engine, *,
                      max_batch: int = 8, max_wait_ms: float = 10.0,
                      max_queue: int = 0, metrics: Optional[Metrics] = None,
                      metrics_period_s: float = 60.0,
                      auth_key: Optional[str] = None,
                      node_id: Optional[str] = None,
                      metrics_port: Optional[int] = None,
                      session_ttl_s: float = 600.0, session_max: int = 256,
                      telemetry: bool = True,
                      telemetry_interval_s: float = 1.0,
                      telemetry_ring: int = 600,
                      scoring: bool = False,
                      scoring_max_job_texts: int = 4096,
                      scoring_jobs_retained: int = 32,
                      scoring_chip_ceiling: Optional[float] = None,
                      host: str = "[::]") -> grpc.aio.Server:
    """Start (and return) the aio server; the caller awaits termination.

    A `PagedEngine` is served through `PagedQueue` (continuous batching:
    requests join the running batch between dispatches), a
    `TutoringEngine` through `BatchingQueue`. `scoring` attaches the
    background bulk-scoring tenant (`server._scorer`, an
    `engine/scoring.ScoringManager`) to the queue; `scoring_chip_ceiling`
    is the operator's saturation figure behind `scoring_utilization`
    (None: the gauge is not set). `telemetry` starts the timeline sampler
    (`server._telemetry_sampler`). A heartbeat watchdog runs on the loop
    (`server._watchdog`), and a task logs the metrics snapshot every
    `metrics_period_s` (`server._metrics_task`). The bound port is
    `server._port`. With
    `metrics_port` (0 = any free port) the health plane listens on
    127.0.0.1 (`server._health.port`): /healthz, /metrics, /metrics.prom,
    POST /admin/drain, POST /admin/score, GET /admin/trace[/<id>],
    /admin/score[/<id>] and /admin/timeline. Shut down with ``await
    server.stop(grace)`` (which stops the health plane, the sampler and
    the watchdog too) then ``await server._queue.close()``.
    """
    metrics = metrics or Metrics()
    scorer = None
    if scoring:
        scorer = ScoringManager(
            engine, metrics=metrics, max_job_texts=scoring_max_job_texts,
            jobs_retained=scoring_jobs_retained,
            chip_ceiling_tokens_per_s=scoring_chip_ceiling)
    if isinstance(engine, PagedEngine):
        queue = PagedQueue(engine, metrics=metrics, max_queue=max_queue,
                           scorer=scorer)
    else:
        queue = BatchingQueue(engine, max_batch=max_batch,
                              max_wait_ms=max_wait_ms, metrics=metrics,
                              max_queue=max_queue, scorer=scorer)
    await queue.start()
    server = grpc.aio.server(
        options=[
            ("grpc.max_send_message_length", 50 * 1024 * 1024),
            ("grpc.max_receive_message_length", 50 * 1024 * 1024),
        ]
    )
    service = TutoringService(queue, metrics, auth_key=auth_key,
                              node_id=node_id, session_ttl_s=session_ttl_s,
                              session_max=session_max)
    rpc.add_TutoringServicer_to_server(service, server)
    server._port = server.add_insecure_port(f"{host}:{port}")
    await server.start()
    server._queue = queue
    server._service = service
    server._scorer = scorer
    server._health = None
    # A handler or a queue step that blocks the loop shows up as
    # serving_tick_lag / serving_tick_stalls.
    server._watchdog = make_serving_watchdog(metrics)
    watchdog_task = asyncio.get_running_loop().create_task(
        server._watchdog.run())
    server._metrics_task = asyncio.get_running_loop().create_task(
        _report_metrics(metrics, metrics_period_s))
    # The node's telemetry ring, served at GET /admin/timeline (the JAX
    # package's scripts/telemetry.py merges it with the other nodes').
    sampler = None
    if telemetry:
        sampler = TimelineSampler(metrics, interval_s=telemetry_interval_s,
                                  max_points=telemetry_ring).start()
    server._telemetry_sampler = sampler
    if metrics_port is not None:

        async def admin_get(path: str) -> dict:
            # GET /admin/trace[/<id>]: this node's trace fragments (the
            # engine spans live here; the JAX package's trace_report merges
            # them with the LMS nodes' into one waterfall).
            if path == "/admin/score" or path.startswith("/admin/score/"):
                return score_admin_get(path, scorer)
            if path == "/admin/timeline":
                return timeline_admin_get(
                    path, None if sampler is None else sampler.timeline)
            return trace_admin_get(path)

        health = HealthServer(
            metrics,
            health=make_tutoring_health(
                service, queue, type(engine).__name__, max_queue,
                spec_tokens=engine.config.spec_tokens,
                draft_source=engine.config.draft_source, scorer=scorer,
                tp=engine.config.tp, ep=engine.config.ep,
                dp=getattr(engine, "dp", 1)),
            admin=make_tutoring_admin(service, scorer=scorer),
            admin_get=admin_get, port=metrics_port)
        log.info("health/metrics endpoint on http://127.0.0.1:%d",
                 await health.start())
        server._health = health
    # `stop` is an attribute of the server, so it must not hold the server
    # (nor its bound `stop`): that cycle would keep the server, its queue
    # and the engine alive after the caller drops them, until a full
    # garbage collection frees every such engine at once.
    grpc_stop = type(server).stop
    server_ref = weakref.ref(server)

    async def stop(grace):
        srv = server_ref()
        watchdog_task.cancel()
        srv._metrics_task.cancel()
        await asyncio.gather(watchdog_task, srv._metrics_task,
                             return_exceptions=True)
        if sampler is not None:
            sampler.stop()
        if srv._health is not None:
            await srv._health.stop()
        return await grpc_stop(srv, grace)

    server.stop = stop
    log.info("tutoring server listening on %d", server._port)
    return server


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None,
                        help="TOML deployment file (config.py: [tutoring], "
                        "[sampling], [scoring], [sessions], [resilience], "
                        "[tracing], [telemetry]); explicit flags override "
                        "it")
    parser.add_argument("--port", type=int, default=50054)
    parser.add_argument("--model", default="gpt2",
                        choices=sorted(registry.PRESETS),
                        help="preset: gpt2 (GPT-2 small), tiny, llama3-8b "
                        "(Meta-Llama-3-8B's shape) or llama-tiny")
    parser.add_argument("--checkpoint", default=None,
                        help="HF-layout .safetensors weights (default: "
                        "seeded random weights)")
    parser.add_argument("--vocab", default=None, help="GPT-2 vocab.json")
    parser.add_argument("--merges", default=None, help="GPT-2 merges.txt")
    parser.add_argument("--tokenizer-json", default=None,
                        help="HF tokenizer.json (a Llama checkpoint needs "
                        "it; it wins over --vocab/--merges)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ways: one process a rank; "
                        "started alone the node spawns the other ranks")
    parser.add_argument("--tp-backend", default="nccl",
                        choices=["nccl", "gloo"],
                        help="collective backend of the tp ranks: nccl "
                        "(one GPU a rank) or gloo (ranks sharing a card, "
                        "or the CPU); CUDA graphs need nccl")
    parser.add_argument("--tp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-init", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel ways (an MoE model): one "
                        "process a rank, tp x ep ranks in all, started as "
                        "--tp's")
    parser.add_argument("--approx-topk", action="store_true",
                        help="the JAX node's approximate top-k: accepted, "
                        "and the port samples the exact top-k")
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=10.0)
    parser.add_argument(
        "--queue-depth", type=int, default=64,
        help="bounded admission: waiting requests beyond this are refused "
        "with RESOURCE_EXHAUSTED (0 = unbounded)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--node-id", default=None,
                        help="fleet identity in every answer's x-served-by "
                        "trailer and in /healthz (default: tut-<port>)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="HTTP /healthz + /metrics endpoint (0 = "
                        "ephemeral); omit to disable. Also serves POST "
                        "/admin/drain (stop admission, finish in-flight "
                        "work) and GET /admin/trace[/<id>]")
    parser.add_argument("--session-ttl", type=float, default=600.0,
                        help="tutoring-session transcript and prefix-pin "
                        "lifetime in seconds")
    parser.add_argument("--session-max", type=int, default=256,
                        help="tutoring sessions held on this node (the "
                        "soonest-expiring go first beyond it)")
    parser.add_argument("--auth-key-file", default=None,
                        help="file holding the LMS<->tutoring shared "
                        "secret; when set, only queries signed by the LMS "
                        "leader are answered")
    parser.add_argument(
        "--strict-dispatch", action="store_true",
        help="assertion mode for dispatch hygiene (utils/guards.py): once "
        "the engine is warm, any host sync of a CUDA tensor outside a "
        "`with intended_transfer():` block raises instead of silently "
        "stalling the hot path (a no-op without a card)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="serve without warmup (refused with --paged "
                        "on the card: the paged engine captures its CUDA "
                        "graphs in warmup)")
    parser.add_argument("--quant", default=None, choices=["int8"],
                        help="weight-only int8 (per-channel scales)")
    parser.add_argument("--kv-quant", action="store_true",
                        help="int8 KV cache with per-slot scales")
    parser.add_argument("--paged", action="store_true",
                        help="continuous batching (PagedEngine + PagedQueue)")
    parser.add_argument("--slots", type=int, default=None,
                        help="paged engine decode slots (default: "
                        "--max-batch)")
    parser.add_argument("--chunk", type=int, default=16,
                        help="paged engine tokens per dispatched step")
    parser.add_argument("--inflight", type=int, default=2,
                        help="paged engine dispatches in flight (2 = "
                        "dispatch N+1 before reading N)")
    parser.add_argument("--megastep", type=int, default=1,
                        help="paged engine megastep: the controller's "
                        "starting K, chunks run per host decision (CUDA "
                        "graph replays on the card; 1 = the chunk loop)")
    parser.add_argument("--megastep-max", type=int, default=0,
                        help="megastep controller ceiling: K grows toward "
                        "it while nothing waits, and is capped at the next "
                        "guaranteed slot-free horizon under load (0 = "
                        "follow --megastep)")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="paged engine radix shared-prefix KV cache: "
                        "prompts sharing a course context prefill it once")
    parser.add_argument("--prefix-cache-blocks", type=int, default=512,
                        help="shared-prefix cache block budget (16 tokens a "
                        "block; LRU eviction, blocks live slots use are "
                        "never freed)")
    parser.add_argument("--prefill-chunk-tokens", type=int, default=0,
                        help="paged engine fused stall-free admission: "
                        "prompts are staged and prefilled this many tokens "
                        "per megastep iteration, so admission never pauses "
                        "decode (0 = sequential admission)")
    parser.add_argument("--spec-tokens", type=int, default=0,
                        help="speculative decoding: verify this many draft "
                        "tokens a step in one forward (exact: the output "
                        "distribution is unchanged); both engines, "
                        "acceptance in /metrics as spec_tokens_per_window "
                        "and spec_accepted_tokens; 0 = off")
    parser.add_argument("--draft-source", default="prompt_lookup",
                        choices=DRAFT_SOURCES,
                        help="speculative draft source (with --spec-tokens):"
                        " prompt_lookup = most recent n-gram continuation; "
                        "ngram = per-slot modal-continuation table (paged "
                        "only)")
    parser.add_argument("--scoring", action="store_true",
                        help="background bulk-scoring tenant "
                        "(engine/scoring.py): warmup covers the score "
                        "program's shapes and preemptible score quanta run "
                        "in idle lanes (POST/GET /admin/score on the "
                        "metrics plane; quanta run only while no "
                        "interactive request waits)")
    parser.add_argument("--scoring-max-job-texts", type=int, default=4096,
                        help="admission cap per bulk score job (texts)")
    parser.add_argument("--scoring-jobs-retained", type=int, default=32,
                        help="finished score jobs kept for GET /admin/score")
    parser.add_argument("--no-telemetry", action="store_true",
                        help="no telemetry timeline (sampler thread and GET "
                        "/admin/timeline)")
    parser.add_argument("--telemetry-interval", type=float, default=1.0,
                        help="telemetry timeline sample interval, seconds")
    parser.add_argument("--telemetry-ring", type=int, default=600,
                        help="telemetry timeline ring length (samples)")
    return parser


def resolve_args(argv=None) -> argparse.Namespace:
    """Parse the flags and, with --config, fill every flag the command
    line left out from the deployment file, as the JAX node does
    (`config.apply_file_defaults`: explicit flags win). Also sets what the
    node reads from the file beside its flags: `app_config` (the loaded
    file, or None: `engine_from_args` builds from `config.engine_config`),
    `sampling_overrides`
    ([sampling] beyond max_new_tokens), `scoring_chip_ceiling` ([telemetry]
    chip_ceiling_tokens_per_s; None without a file), `telemetry` and
    `tracing` (the [tracing] section, or None)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    args.telemetry = not args.no_telemetry
    args.app_config = None
    args.sampling_overrides = {}
    args.scoring_chip_ceiling = None
    args.tracing = None
    if args.config:
        cfg = load_config(args.config)
        args.app_config = cfg
        t, s = cfg.tutoring, cfg.sampling
        apply_file_defaults(args, parser, {
            "port": t.port, "model": t.model, "checkpoint": t.checkpoint,
            "vocab": t.vocab, "merges": t.merges,
            "tokenizer_json": t.tokenizer_json, "tp": t.tp, "ep": t.ep,
            "quant": t.quant, "max_new_tokens": s.max_new_tokens,
            "max_batch": t.max_batch, "max_wait_ms": t.max_wait_ms,
            "queue_depth": cfg.resilience.queue_depth,
            "slots": t.slots, "chunk": t.chunk,
            "megastep": t.megastep, "megastep_max": t.megastep_max,
            "inflight": t.inflight, "prefix_cache": t.prefix_cache,
            "prefix_cache_blocks": t.prefix_cache_blocks,
            "prefill_chunk_tokens": t.prefill_chunk_tokens,
            "draft_source": t.draft_source,
            "auth_key_file": t.auth_key_file,
            # store_true flags merge the same way: presence in argv marks
            # them explicit, so the file fills only absent ones.
            "kv_quant": t.kv_quant, "paged": t.paged,
            "approx_topk": s.approx_top_k, "spec_tokens": t.spec_tokens,
            "scoring": cfg.scoring.enabled,
            "scoring_max_job_texts": cfg.scoring.max_job_texts,
            "scoring_jobs_retained": cfg.scoring.jobs_retained,
            "telemetry_interval": cfg.telemetry.sample_interval_s,
            "telemetry_ring": cfg.telemetry.ring_points,
            "session_ttl": cfg.sessions.ttl_s,
            "session_max": cfg.sessions.max_sessions,
        }, argv=argv)
        args.scoring_chip_ceiling = cfg.telemetry.chip_ceiling_tokens_per_s
        if not args.no_telemetry:
            args.telemetry = cfg.telemetry.enabled
        args.sampling_overrides = dict(
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            repetition_penalty=s.repetition_penalty)
        args.tracing = cfg.tracing
    return args


def engine_from_args(args: argparse.Namespace):
    """The engine the parsed (and resolved, `resolve_args`) flags ask for,
    not yet warmed."""
    # bf16 weights and activations on the card; float32 on the CPU.
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    # From the deployment file through `config.engine_config` (flags win:
    # `resolve_args` already merged them), else the defaults.
    app = getattr(args, "app_config", None)
    base = engine_config(app) if app is not None else EngineConfig()
    config = dataclasses.replace(
        base,
        model=args.model, checkpoint=args.checkpoint,
        vocab_path=args.vocab, merges_path=args.merges,
        tokenizer_json=args.tokenizer_json,
        sampling=dataclasses.replace(
            base.sampling, max_new_tokens=args.max_new_tokens,
            approx_top_k=args.approx_topk,
            **getattr(args, "sampling_overrides", {})),
        seed=args.seed, device=args.device, dtype=dtype, param_dtype=dtype,
        tp=args.tp, ep=args.ep, quant=args.quant, kv_quant=args.kv_quant,
        spec_tokens=args.spec_tokens, draft_source=args.draft_source,
        scoring=args.scoring,
    )
    if args.paged:
        if args.no_warmup and torch.device(args.device).type == "cuda":
            raise ValueError(
                "--no-warmup with --paged on the card: the paged engine "
                "captures its CUDA graphs in warmup, never while serving")
        return PagedEngine(
            config, slots=args.slots or args.max_batch, chunk=args.chunk,
            inflight=args.inflight, megastep=args.megastep,
            megastep_max=args.megastep_max, prefix_cache=args.prefix_cache,
            prefix_cache_blocks=args.prefix_cache_blocks,
            prefill_chunk_tokens=args.prefill_chunk_tokens)
    for flag, on in (("--megastep", args.megastep > 1),
                     ("--prefix-cache", args.prefix_cache),
                     ("--prefill-chunk-tokens",
                      args.prefill_chunk_tokens > 0)):
        if on:
            log.warning("%s applies to the paged engine only; ignored "
                        "without --paged", flag)
    return TutoringEngine(config)


def read_auth_key(args: argparse.Namespace) -> Optional[str]:
    """The LMS<->tutoring secret from `--auth-key-file` (None without
    one), read before the event loop starts, as the JAX node's `main`
    reads it."""
    if not args.auth_key_file:
        return None
    with open(args.auth_key_file) as fh:
        return fh.read().strip()


async def serve_args(args: argparse.Namespace, engine,
                     host: str = "[::]",
                     auth_key: Optional[str] = None) -> grpc.aio.Server:
    """`serve_async` with what the resolved flags (`resolve_args`) ask for:
    what `main` serves, for a caller that builds and warms the engine
    itself. `auth_key` is `read_auth_key(args)`, read off the loop."""
    if args.auth_key_file and auth_key is None:
        raise ValueError("--auth-key-file is set: pass "
                         "auth_key=read_auth_key(args) to serve_args")
    return await serve_async(
        args.port, engine, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.queue_depth,
        auth_key=auth_key, node_id=args.node_id or f"tut-{args.port}",
        metrics_port=args.metrics_port,
        session_ttl_s=args.session_ttl, session_max=args.session_max,
        telemetry=args.telemetry,
        telemetry_interval_s=args.telemetry_interval,
        telemetry_ring=args.telemetry_ring, scoring=args.scoring,
        scoring_max_job_texts=args.scoring_max_job_texts,
        scoring_jobs_retained=args.scoring_jobs_retained,
        scoring_chip_ceiling=args.scoring_chip_ceiling, host=host)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def join_tp_group(args: argparse.Namespace,
                  argv: List[str]) -> Tuple[int, List[subprocess.Popen]]:
    """Join the process group of the node's ranks (`node_world`, more
    than one); returns (this process' rank, the follower processes it
    started). Under torchrun (WORLD_SIZE set) the rank comes from the
    environment; a follower this node started gets `--tp-rank` and the
    rendezvous; a node started alone is rank 0 and starts ranks 1..tp x
    ep - 1 as copies of itself (`argv` plus those two flags),
    rendezvousing on the loopback. With nccl each rank takes the GPU of
    its (local) rank."""
    world = node_world(args)
    if world <= 1:
        return 0, []
    followers: List[subprocess.Popen] = []
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if args.tp_backend == "nccl":
            torch.cuda.set_device(local)
        mesh_lib.initialize_multihost(args.tp_backend)
        return rank, followers
    if args.tp_rank is None:
        init = f"tcp://127.0.0.1:{_free_port()}"
        rank = 0
        for r in range(1, world):
            followers.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name, *argv,
                 "--tp-rank", str(r), "--tp-init", init]))
    else:
        rank, init = args.tp_rank, args.tp_init
    if args.tp_backend == "nccl":
        torch.cuda.set_device(rank)
    mesh_lib.init_process_group(args.tp_backend, init, world, rank)
    return rank, followers


def node_world(args: argparse.Namespace) -> int:
    """The ranks a node's engine runs over: under torchrun WORLD_SIZE, a
    multiple of tp x ep (dp takes the rest, as the JAX engines' dp takes
    the spare devices); else tp x ep, the ranks a node started alone
    starts."""
    model = args.tp * args.ep
    if "WORLD_SIZE" not in os.environ:
        return model
    world = int(os.environ["WORLD_SIZE"])
    if world % model:
        raise ValueError(
            f"WORLD_SIZE={world} under torchrun is not a multiple of --tp "
            f"{args.tp} x --ep {args.ep}: a node's ranks are dp x tp x ep")
    return world


def watch_followers(followers: List[subprocess.Popen],
                    period_s: float = 1.0) -> threading.Event:
    """Rank 0: end this process (exit code 1) once a follower process it
    started exits while the node runs. The ranks cannot be brought back
    into step, and rank 0 would wait for the lost rank in its next
    collective; a follower that fails exits non-zero (its `follow`
    raises). The returned event ends the watch: a clean shutdown sets it
    before it releases the followers."""
    done = threading.Event()
    if not followers:
        return done

    def watch() -> None:
        while not done.wait(period_s):
            gone = [p for p in followers if p.poll() is not None]
            if gone and not done.is_set():
                log.critical("tp follower (pid %d) exited with code %s; "
                             "ending rank 0", gone[0].pid, gone[0].returncode)
                for p in followers:
                    if p.poll() is None:
                        p.kill()
                os._exit(1)

    threading.Thread(target=watch, name="tp-followers", daemon=True).start()
    return done


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = resolve_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.tracing is not None:
        # The process tracer from [tracing], before any request opens a
        # span.
        configure_from(args.tracing)
    rank, followers = join_tp_group(args, argv)
    watch = watch_followers(followers)
    engine = None
    try:
        engine = engine_from_args(args)
        if rank > 0:
            # A follower: the same engine, driven by rank 0's calls
            # (warmup included) until rank 0 stops.
            log.info("tp rank %d of %d following rank 0", rank,
                     node_world(args))
            engine.follow()
            return
        _serve_main(args, engine)
    finally:
        watch.set()
        if engine is not None and rank == 0:
            engine.stop_followers()
        for proc in followers:
            try:
                # Released followers exit at once; without an engine here
                # they wait for a rank 0 that is gone.
                proc.wait(timeout=30 if engine is not None else 0.1)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _serve_main(args: argparse.Namespace, engine) -> None:
    """Warm `engine` and serve it until the server terminates (rank 0)."""
    if isinstance(engine, PagedEngine):
        warm = engine.warmup
    else:
        warm = functools.partial(engine.warmup, batch=args.max_batch)
    if not args.no_warmup:
        log.info("warmup took %.1fs", warm())
    if args.strict_dispatch:
        # After the build and warmup (the JAX node turns its guard on
        # before them): the weights' upload and the graph captures are
        # copies torch counts as syncs, while JAX's guard sees only
        # device-to-host reads. Serving is what the mode holds.
        enable_strict_dispatch()
    auth_key = read_auth_key(args)

    async def run():
        server = await serve_args(args, engine, auth_key=auth_key)
        try:
            await server.wait_for_termination()
        finally:
            # Bounded best effort, as the LMS node's teardown: close()
            # fails the waiting requests and joins the engine loop, and a
            # wedged engine must not hang the process's exit.
            await asyncio.wait_for(server._queue.close(), timeout=30.0)

    asyncio.run(run())


if __name__ == "__main__":
    main()
