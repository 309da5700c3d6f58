"""A dropped engine is freed by reference counting alone.

A node serves its engine through `serving.tutoring_server.serve_args`
(the queue, the scoring tenant, the health plane). Once the caller stops
the server and drops it and the engine, nothing may keep the engine
alive until a full garbage collection: on the card that collection frees
every such engine, its KV planes and captured graphs at once, in the
middle of a later engine's serving loop (a multi-second stall). Here the
collector is off while the engine is dropped, so only a reference cycle
could keep it; `chip_smoke.py` phase 15 (d) checks a graphed engine on
the card the same way.
"""

import asyncio
import gc
import weakref

import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server


def _engine(paged):
    config = EngineConfig(
        model="tiny", device="cpu", dtype=torch.float32,
        param_dtype=torch.float32, batch_buckets=(1, 2),
        length_buckets=(4, 16), scoring=True,
        sampling=SamplingParams.greedy(max_new_tokens=4))
    if paged:
        return PagedEngine(config, slots=2, chunk=2, prefix_cache=True,
                           megastep=2, megastep_max=4,
                           prefill_chunk_tokens=4)
    return TutoringEngine(config)


def _serve_once(engine):
    """A node on `engine` (scoring, health plane), one question answered
    and a scoring job submitted, then stopped as its callers stop it."""
    args = tutoring_server.resolve_args([
        "--device", "cpu", "--model", "tiny", "--port", "0",
        "--metrics-port", "0", "--scoring", "--max-new-tokens", "4"])

    async def run():
        server = await tutoring_server.serve_args(args, engine,
                                                  host="127.0.0.1")
        try:
            reply = await server._service.GetLLMAnswer(
                lms_pb2.QueryRequest(query="what is raft?"), None)
            server._scorer.submit(["a text to score"], purpose="grading")
            return reply.success
        finally:
            await server.stop(0)
            await server._queue.close()

    return asyncio.run(run())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "bucketed"])
def test_a_dropped_served_engine_is_freed_without_a_collection(paged):
    engine = _engine(paged)
    engine.warmup()
    gc.collect()
    gc.disable()
    try:
        assert _serve_once(engine)
        ref = weakref.ref(engine)
        del engine
        alive = ref()
        holders = ([type(r).__name__ for r in gc.get_referrers(alive)]
                   if alive is not None else [])
        del alive
        assert ref() is None, f"the engine is held by {holders}"
    finally:
        gc.enable()
