"""Tutoring server: `Tutoring.GetLLMAnswer` on the PyTorch engine.

Port of the unary path of `distributed_lms_raft_llm_tpu/serving/
tutoring_server.py`. It speaks the frozen `lms.proto`, so the JAX
package's LMS forwards to it unchanged. Concurrent RPCs coalesce in
`BatchingQueue` into device batches of the bucketed `TutoringEngine`, or,
with ``--paged``, join the running batch of the continuous-batching
`PagedEngine` through `PagedQueue`.

Run (on the card; ``--device cpu`` for a CPU run):

    python -m distributed_lms_raft_llm_tpu_torch.serving.tutoring_server \\
        [--port 50054] [--model gpt2] [--checkpoint model.safetensors ...]

The production tutoring node (configs/cluster.toml ``[tutoring]``, less
speculative decoding): ``--paged --quant int8 --kv-quant --slots 16
--chunk 16 --inflight 3 --megastep 4 --megastep-max 8 --prefix-cache
--prefix-cache-blocks 512 --prefill-chunk-tokens 32``. On the card the
paged engine's warmup captures its CUDA graphs before the server listens,
so ``--no-warmup`` is refused with ``--paged`` there.

`StreamLLMAnswer`, sessions, drain, health and telemetry come with a later
slice; until then `StreamLLMAnswer` answers UNIMPLEMENTED.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import logging
from typing import Optional

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
from ..proto import lms_pb2, rpc
from ..utils import auth
from ..utils.metrics import Metrics
from ..utils.resilience import (
    QUEUE_DEPTH_METADATA_KEY,
    SERVED_BY_METADATA_KEY,
    Deadline,
    DeadlineExpired,
    Overloaded,
)
from .prompts import PROMPT_TEMPLATE

log = logging.getLogger("tutoring_server")

__all__ = ["PROMPT_TEMPLATE", "TutoringService", "build_parser",
           "engine_from_args", "serve_async", "main"]


class TutoringService(rpc.TutoringServicer):
    def __init__(self, queue, metrics: Metrics,
                 auth_key: Optional[str] = None,
                 node_id: Optional[str] = None):
        self.queue = queue
        self.metrics = metrics
        self.auth_key = auth_key
        # Fleet identity: rides every answer's trailing metadata.
        self.node_id = node_id

    async def GetLLMAnswer(self, request, context):
        self.metrics.inc("llm_requests")
        # Trailing metadata is buffered until the RPC completes. Direct
        # servicer-level callers pass context=None.
        if context is not None:
            trailer = [(QUEUE_DEPTH_METADATA_KEY, str(self.queue.waiting))]
            if self.node_id:
                trailer.append((SERVED_BY_METADATA_KEY, self.node_id))
            context.set_trailing_metadata(tuple(trailer))
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
                answer = await self.queue.submit(prompt, deadline=deadline)
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


async def serve_async(port: int, engine, *,
                      max_batch: int = 8, max_wait_ms: float = 10.0,
                      max_queue: int = 0, metrics: Optional[Metrics] = None,
                      auth_key: Optional[str] = None,
                      node_id: Optional[str] = None,
                      host: str = "[::]") -> grpc.aio.Server:
    """Start (and return) the aio server; the caller awaits termination.

    A `PagedEngine` is served through `PagedQueue` (continuous batching:
    requests join the running batch between dispatches), a
    `TutoringEngine` through `BatchingQueue`. The bound port is
    `server._port`. Shut down with ``await server.stop(grace)`` then
    ``await server._queue.close()``.
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
                              node_id=node_id)
    rpc.add_TutoringServicer_to_server(service, server)
    server._port = server.add_insecure_port(f"{host}:{port}")
    await server.start()
    server._queue = queue
    server._service = service
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
                        "trailer (default: tut-<port>)")
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
        )
        try:
            await server.wait_for_termination()
        finally:
            await server._queue.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
