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
`/metrics.prom`, ``POST /admin/drain`` and ``GET /admin/trace[/<id>]``;
every RPC continues the caller's `x-trace-context`.

Run (on the card; ``--device cpu`` for a CPU run):

    python -m distributed_lms_raft_llm_tpu_torch.serving.tutoring_server \\
        [--port 50054] [--model gpt2] [--checkpoint model.safetensors ...]

The production tutoring node (configs/cluster.toml ``[tutoring]``):
``--paged --quant int8 --kv-quant --slots 16 --chunk 16 --inflight 3
--megastep 4 --megastep-max 8 --prefix-cache --prefix-cache-blocks 512
--prefill-chunk-tokens 32``, and with speculative decoding (commented out
there) ``--spec-tokens 8 --draft-source prompt_lookup``. On the card the
paged engine's warmup captures its CUDA graphs before the server listens,
so ``--no-warmup`` is refused with ``--paged`` there.

Not ported yet, and so refused as unknown flags: the scoring tenant
(``--scoring``; ``/admin/score`` answers 404, as on a JAX node without a
scorer), the telemetry timeline, tp/ep.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import hashlib
import logging
import time
from typing import Dict, Optional, Tuple

import grpc
import torch

from ..engine import (
    BatchingQueue,
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
    TutoringEngine,
)
from ..engine.engine import DRAFT_SOURCES
from ..proto import lms_pb2, rpc
from ..utils import auth
from ..utils.healthz import HealthServer
from ..utils.metrics import Metrics
from ..utils.resilience import (
    QUEUE_DEPTH_METADATA_KEY,
    SERVED_BY_METADATA_KEY,
    Deadline,
    DeadlineExpired,
    Overloaded,
)
from ..utils.tracing import get_tracer, trace_admin_get, traced_grpc_handler
from .prompts import FOLLOWUP_TEMPLATE, PROMPT_TEMPLATE

log = logging.getLogger("tutoring_server")

__all__ = ["FOLLOWUP_TEMPLATE", "PROMPT_TEMPLATE", "TutoringService",
           "build_parser", "engine_from_args", "make_tutoring_admin",
           "make_tutoring_health", "serve_async", "main"]

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


def make_tutoring_admin(service: TutoringService):
    """POST handler of the node's admin plane.

    POST /admin/drain {"drain": true|false} stops or resumes admission;
    in-flight work finishes, and the fleet router takes the node out of
    its ring while it drains. Every other path answers 404, /admin/score
    included (the scoring tenant is not ported; a JAX node without a
    scorer answers the same)."""

    async def admin(path: str, body: dict) -> dict:
        if path == "/admin/drain":
            service.set_draining(bool(body.get("drain", True)))
            return {"ok": True, "draining": service.draining,
                    "node_id": service.node_id}
        raise KeyError(path)

    return admin


def make_tutoring_health(service: TutoringService, queue, engine_name: str,
                         max_queue: int, spec_tokens: int = 0,
                         draft_source: str = "prompt_lookup"):
    """/healthz provider: admission pressure and the fleet lifecycle (the
    router's health poller reads `draining`, `queued` and `node_id`); a
    speculating node adds its `spec_tokens` and `draft_source`, as a JAX
    node adds its scoring block only when it scores, so a node without
    speculation answers with the JAX node's fields alone."""

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
        return doc

    return health


async def serve_async(port: int, engine, *,
                      max_batch: int = 8, max_wait_ms: float = 10.0,
                      max_queue: int = 0, metrics: Optional[Metrics] = None,
                      auth_key: Optional[str] = None,
                      node_id: Optional[str] = None,
                      metrics_port: Optional[int] = None,
                      session_ttl_s: float = 600.0, session_max: int = 256,
                      host: str = "[::]") -> grpc.aio.Server:
    """Start (and return) the aio server; the caller awaits termination.

    A `PagedEngine` is served through `PagedQueue` (continuous batching:
    requests join the running batch between dispatches), a
    `TutoringEngine` through `BatchingQueue`. The bound port is
    `server._port`. With `metrics_port` (0 = any free port) the health
    plane listens on 127.0.0.1 (`server._health.port`): /healthz,
    /metrics, /metrics.prom, POST /admin/drain, GET /admin/trace[/<id>].
    Shut down with ``await server.stop(grace)`` (which stops the health
    plane too) then ``await server._queue.close()``.
    """
    metrics = metrics or Metrics()
    if isinstance(engine, PagedEngine):
        queue = PagedQueue(engine, metrics=metrics, max_queue=max_queue)
    else:
        queue = BatchingQueue(engine, max_batch=max_batch,
                              max_wait_ms=max_wait_ms, metrics=metrics,
                              max_queue=max_queue)
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
    server._health = None
    if metrics_port is not None:

        async def admin_get(path: str) -> dict:
            # GET /admin/trace[/<id>]: this node's trace fragments (the
            # engine spans live here; the JAX package's trace_report merges
            # them with the LMS nodes' into one waterfall).
            return trace_admin_get(path)

        health = HealthServer(
            metrics,
            health=make_tutoring_health(
                service, queue, type(engine).__name__, max_queue,
                spec_tokens=engine.config.spec_tokens,
                draft_source=engine.config.draft_source),
            admin=make_tutoring_admin(service), admin_get=admin_get,
            port=metrics_port)
        log.info("health/metrics endpoint on http://127.0.0.1:%d",
                 await health.start())
        server._health = health
        grpc_stop = server.stop

        async def stop(grace):
            await health.stop()
            return await grpc_stop(grace)

        server.stop = stop
    log.info("tutoring server listening on %d", server._port)
    return server


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=50054)
    parser.add_argument("--model", default="gpt2",
                        help="preset: gpt2 (GPT-2 small) or tiny")
    parser.add_argument("--checkpoint", default=None,
                        help="HF-layout .safetensors weights (default: "
                        "seeded random weights)")
    parser.add_argument("--vocab", default=None, help="GPT-2 vocab.json")
    parser.add_argument("--merges", default=None, help="GPT-2 merges.txt")
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
    return parser


def engine_from_args(args: argparse.Namespace):
    """The engine the parsed flags ask for, not yet warmed."""
    # bf16 weights and activations on the card; float32 on the CPU.
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    config = EngineConfig(
        model=args.model, checkpoint=args.checkpoint,
        vocab_path=args.vocab, merges_path=args.merges,
        sampling=SamplingParams.reference_defaults(
            max_new_tokens=args.max_new_tokens),
        seed=args.seed, device=args.device, dtype=dtype, param_dtype=dtype,
        quant=args.quant, kv_quant=args.kv_quant,
        spec_tokens=args.spec_tokens, draft_source=args.draft_source,
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    engine = engine_from_args(args)
    if isinstance(engine, PagedEngine):
        warm = engine.warmup
    else:
        warm = functools.partial(engine.warmup, batch=args.max_batch)
    if not args.no_warmup:
        log.info("warmup took %.1fs", warm())
    auth_key = None
    if args.auth_key_file:
        with open(args.auth_key_file) as fh:
            auth_key = fh.read().strip()

    async def run():
        server = await serve_async(
            args.port, engine, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_queue=args.queue_depth,
            auth_key=auth_key, node_id=args.node_id or f"tut-{args.port}",
            metrics_port=args.metrics_port,
            session_ttl_s=args.session_ttl, session_max=args.session_max,
        )
        try:
            await server.wait_for_termination()
        finally:
            await server._queue.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
