"""Speculative decoding in the port's paged engine on the CPU, against JAX.

A tiny `PagedEngine` of each package holds the same weights (the JAX
engine's tree carried across with `params_from_jax`); under greedy
decoding in float32 the port's verify-window engine must answer byte for
byte as the JAX spec engine and as the port without speculation, with
equal acceptance (`pop_spec_stats`) and dispatch statistics: spec_tokens
1 and 3, both drafters, dense and int8 weights with an int8 KV cache, the
megastep, fused admission and the prefix cache, more prompts than slots so
requests are admitted while other slots are mid-window
(tests/test_paged_spec.py). The port attends through the kernel's plain
window version (`fused_attention=True`). Then the cases of
tests/test_paged_spec.py on the port: the first window token distributed
as the plain step's sampled token, admission mid-window, the dead-slot
filler, the queue's metrics, the position budget; and a speculative
stream over gRPC that assembles to the unary answer.
"""

import asyncio
import dataclasses
import functools
import json

import grpc
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine import paged as paged_lib
from distributed_lms_raft_llm_tpu_torch.engine.sampling import (
    seen_mask_from_ids,
)
from distributed_lms_raft_llm_tpu_torch.models import registry
from distributed_lms_raft_llm_tpu_torch.models.common import KVCache
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.ops import attention
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

MAX_NEW = 8
# More prompts than slots (3), over three prompt buckets (4, 8, 16); the
# last extends the first (a prefix-cache hit once the first is in).
PROMPTS = ["what is raft?", "hello world", "explain paging", "k", "k v",
           "a longer question about logs", "paxos?", "what is raft? paxos?"]
QUANT = {"dense": {}, "int8": dict(quant="int8", kv_quant=True)}
DEPLOY = (("megastep", 2), ("megastep_max", 4), ("prefix_cache", True),
          ("prefix_block_tokens", 4), ("prefill_chunk_tokens", 4),
          ("inflight", 3))


def make_config(**kw):
    kw.setdefault("sampling", SamplingParams.greedy(max_new_tokens=MAX_NEW))
    kw.setdefault("length_buckets", (16,))
    kw.setdefault("spec_tokens", 3)
    return EngineConfig(model="tiny", batch_buckets=(1, 2, 4),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", fused_attention=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(k, source, quant_mode, options):
    """The JAX spec engine's greedy answers to PROMPTS, its acceptance and
    dispatch statistics, and its parameter tree."""
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        length_buckets=(4, 8, 16), spec_tokens=k, draft_source=source,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        **QUANT[quant_mode]), slots=3, chunk=2, **dict(options))
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    return ([out[r] for r in rids], jeng.pop_spec_stats(),
            jeng.pop_dispatch_stats(), jeng.pop_prefix_stats(),
            jax.device_get(jeng.params))


def _port_run(k, source, quant_mode, options, tree):
    eng = PagedEngine(make_config(
        length_buckets=(4, 8, 16), spec_tokens=k, draft_source=source,
        **QUANT[quant_mode]), slots=3, chunk=2, **dict(options))
    eng.params = params_from_jax(tree, device="cpu")
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.drain()
    return eng, [out[r] for r in rids]


@pytest.mark.parametrize("k,source,quant_mode,options", [
    (1, "prompt_lookup", "dense", ()),
    (3, "prompt_lookup", "dense", ()),
    (3, "ngram", "dense", ()),
    (3, "prompt_lookup", "int8", ()),
    (3, "prompt_lookup", "dense", (("megastep", 4), ("megastep_max", 4))),
    (3, "prompt_lookup", "int8", DEPLOY),
    (1, "ngram", "int8", DEPLOY),
], ids=["k1", "k3", "k3-ngram", "k3-int8", "k3-megastep4",
        "k3-int8-deployment", "k1-ngram-int8-deployment"])
def test_greedy_answers_equal_jax_and_the_plain_engine(k, source, quant_mode,
                                                       options):
    want, jspec, jstats, jprefix, tree = _jax_run(k, source, quant_mode,
                                                  options)
    eng, got = _port_run(k, source, quant_mode, options, tree)
    assert got == want
    assert eng.pop_spec_stats() == jspec
    stats = eng.pop_dispatch_stats()
    assert stats[:3] == jstats[:3] and stats[4] == jstats[4]
    plain, plain_got = _port_run(0, "prompt_lookup", quant_mode, options,
                                 tree)
    assert plain_got == want and plain.pop_spec_stats() is None
    assert eng.decode_steps < plain.decode_steps  # fewer model calls
    if dict(options).get("prefix_cache"):
        # (hit tokens, prompt tokens, evictions, blocks in the tree)
        prefix = eng.pop_prefix_stats()
        assert prefix == jprefix and prefix[3] > 0


def test_with_repetition_penalty_equals_the_plain_engine():
    """The hypothetical seen stack through the transcript plumbing: a token
    accepted mid-window penalizes the rest of the window."""
    sp = SamplingParams(temperature=0.0, top_k=50, top_p=1.0,
                        repetition_penalty=1.2, max_new_tokens=12)
    answers = []
    for k in (0, 3):
        eng = PagedEngine(make_config(sampling=sp, spec_tokens=k), slots=4)
        rids = [eng.submit(p) for p in PROMPTS[:4]]
        out = eng.drain()
        answers.append([out[r] for r in rids])
    assert answers[0] == answers[1]


def test_pipelined_outputs_match_serialized():
    """inflight 2 (dispatch N+1 before reading N) with ragged per-slot
    window advances gives the answers of inflight 1."""
    out = []
    for inflight in (1, 2):
        eng = PagedEngine(make_config(), slots=2, inflight=inflight, chunk=2)
        rids = [eng.submit(p) for p in PROMPTS[:4]]
        res = eng.drain()
        out.append([res[r] for r in rids])
    assert out[0] == out[1]


def test_mid_verify_window_admission_completes_without_waiting():
    """A request submitted while another slot is between verify windows
    joins at the next chunk boundary and finishes within its own budget."""
    paged = PagedEngine(make_config(), slots=2, chunk=2)
    paged.submit("a long question about distributed consensus and logs")
    for _ in range(2):
        paged.step()
    b = paged.submit("b")
    finished = {}
    steps_after_b = 0
    while paged.has_work and steps_after_b < 3 * MAX_NEW:
        steps_after_b += 1
        for rid, _ in paged.step():
            finished.setdefault(rid, steps_after_b)
        if steps_after_b == 1:
            in_slots = {r.rid for r in paged._slot_req if r is not None}
            assert b in in_slots or b in finished
    assert b in finished
    assert finished[b] <= MAX_NEW // 2 + 3


def _slot_state(cfg, family, params, s_slots, t0, width, pending, row):
    ids = torch.from_numpy(np.tile(row, (s_slots, 1)))
    kv = family.init_cache(cfg, s_slots, width, device="cpu")
    family.forward(params, cfg, ids, cache=kv)
    seen = seen_mask_from_ids(ids, torch.ones((s_slots, t0), dtype=torch.bool),
                              cfg.vocab_size)
    seen[:, pending] = True
    transcript = torch.zeros((s_slots, width), dtype=torch.long)
    transcript[:, :t0] = ids
    transcript[:, t0] = pending
    return paged_lib.SlotState(
        cache=KVCache(k=kv.k, v=kv.v,
                      lengths=torch.full((s_slots,), t0, dtype=torch.int32)),
        tok=torch.full((s_slots,), pending, dtype=torch.long),
        active=torch.ones((s_slots,), dtype=torch.bool), seen=seen,
        transcript=transcript,
        staged=torch.zeros((s_slots,), dtype=torch.bool),
        stage_cursor=torch.zeros((s_slots,), dtype=torch.int32),
        stage_len=torch.ones((s_slots,), dtype=torch.int32),
        stage_seq=torch.zeros((s_slots,), dtype=torch.int32),
        stage_noise=torch.zeros((s_slots, 0)))


def test_first_window_token_matches_plain_step_distribution():
    """Over S identical slots, the first token a verify window emits is
    distributed as the plain step's sampled token for the same prefix
    (through transcript -> drafts -> ragged forward -> verify)."""
    family, cfg = registry.resolve("tiny", torch.float32, torch.float32)
    cfg = dataclasses.replace(cfg, fused_decode_attention=True)
    params = family.init_params(cfg, 0, "cpu")
    sampling = SamplingParams(temperature=0.7, top_k=16, top_p=0.9,
                              repetition_penalty=1.2, max_new_tokens=8)
    s_slots, t0, width, k = 1500, 6, 16, 3
    rng = np.random.default_rng(0)
    row = rng.integers(1, cfg.vocab_size, t0)
    row[3:5] = row[0:2]  # a repeated bigram so the drafter finds anchors
    pending = int(row[1])
    statics = dict(cfg=cfg, sampling=sampling, eos_id=-1, pad_id=-1,
                   model=family, chunk=1)
    state = _slot_state(cfg, family, params, s_slots, t0, width, pending, row)
    toks, _ = paged_lib._step_program(params, state,
                                      torch.Generator().manual_seed(7),
                                      **statics)
    ref = toks[0].numpy()
    state = _slot_state(cfg, family, params, s_slots, t0, width, pending, row)
    emitted, counts, _ = paged_lib._spec_step_program(
        params, state, torch.Generator().manual_seed(8), spec_tokens=k,
        **statics)
    assert (counts[0] >= 1).all()
    got = emitted[0, :, 0].numpy()
    support = sorted(set(ref.tolist()) | set(got.tolist()))
    f_ref = np.array([(ref == s).mean() for s in support])
    f_got = np.array([(got == s).mean() for s in support])
    np.testing.assert_allclose(f_got, f_ref, atol=0.065)


def test_parked_and_overrun_slots_stay_inside_the_window():
    """A slot parked at width-1 (staged) and one past its budget: the window
    base is clamped to width-1-k, every write stays inside the width, and
    the transcript takes no token past it."""
    family, cfg = registry.resolve("tiny", torch.float32, torch.float32)
    cfg = dataclasses.replace(cfg, fused_decode_attention=True)
    params = family.init_params(cfg, 0, "cpu")
    t0, width, k = 6, 16, 3
    row = np.arange(1, t0 + 1)
    state = _slot_state(cfg, family, params, 2, t0, width, 9, row)
    state.cache.lengths.copy_(torch.tensor([width - 1, width - 2],
                                           dtype=torch.int32))
    state.active[0] = False
    before = state.transcript.clone()
    emitted, counts, active = paged_lib._spec_step_program(
        params, state, None, spec_tokens=k, cfg=cfg,
        sampling=SamplingParams.greedy(), eos_id=-1, pad_id=-1,
        model=family, chunk=2)
    assert counts[:, 0].tolist() == [0, 0]  # the parked slot emits nothing
    assert int(state.cache.lengths[0]) == width - 1
    assert int(state.cache.lengths.max()) <= width
    assert torch.equal(state.transcript[0], before[0])
    assert counts[0, 1] >= 1 and int(active[1]) == 1


def test_stochastic_session_plausible_and_observable():
    sp = SamplingParams.reference_defaults(max_new_tokens=MAX_NEW)
    for source in ("prompt_lookup", "ngram"):
        eng = PagedEngine(make_config(sampling=sp, draft_source=source),
                          slots=2, chunk=2)
        rids = [eng.submit(f"the the the question {i}") for i in range(5)]
        out = eng.drain()
        assert all(isinstance(out[r], str) for r in rids)
        windows, emitted = eng.pop_spec_stats()
        assert 0 < windows <= emitted <= windows * (eng.spec + 1)
        assert eng.pop_spec_stats() == (0, 0)  # drained


def test_dead_slot_emits_no_filler_when_pad_differs_from_eos():
    """A slot inactive from admission (its first token is eos) runs
    zero-count windows: the answer is empty even where pad != eos."""
    paged = PagedEngine(make_config(), slots=2)
    paged.tokenizer.pad_id = 0
    assert paged.tokenizer.eos_id != 0
    real_prefill = paged._prefill

    def eos_first(params, ids, true_len, generator, cache):
        _, seen = real_prefill(params, ids, true_len, generator, cache)
        return torch.tensor(paged.tokenizer.eos_id), seen

    paged._prefill = eos_first
    rid = paged.submit("anything at all")
    assert paged.drain()[rid] == paged.tokenizer.decode([])


def test_paged_queue_reports_spec_metrics():
    metrics = Metrics()
    engine = PagedEngine(make_config(), slots=2, chunk=2)

    async def run():
        q = PagedQueue(engine, metrics=metrics)
        await q.start()
        try:
            return await asyncio.gather(
                *[q.submit(f"query number {i}") for i in range(4)])
        finally:
            await q.close()

    assert len(asyncio.run(run())) == 4
    snap = metrics.snapshot()
    tpw = snap["gauges"]["spec_tokens_per_window"]
    assert 1.0 <= tpw <= engine.spec + 1
    assert snap["counters"]["spec_accepted_tokens"] >= 0
    assert metrics.hist("ttft").snapshot()["count"] == 4


def test_spec_overhang_respects_the_position_table():
    """tiny's table is 64: with max_new 50 and k 4 the prompt bucket gives
    up the window's k-1 overhang; a budget leaving no prompt room, and a
    staged slot that would park inside its prompt, are refused."""
    eng = PagedEngine(make_config(
        sampling=SamplingParams.greedy(max_new_tokens=50), spec_tokens=4),
        slots=2)
    assert eng.bucket == 64 - 50 - 3
    assert eng.widths[-1] == eng.bucket + 50 + 3 <= 64
    rid = eng.submit("a prompt much longer than eleven byte-tokens")
    assert isinstance(eng.drain()[rid], str)
    with pytest.raises(ValueError, match="no room"):
        PagedEngine(make_config(
            sampling=SamplingParams.greedy(max_new_tokens=62),
            spec_tokens=4), slots=2)
    with pytest.raises(ValueError, match="max_new_tokens >= 2"):
        PagedEngine(make_config(
            sampling=SamplingParams.greedy(max_new_tokens=1)), slots=2,
            prefill_chunk_tokens=4)
    with pytest.raises(ValueError, match="draft_source"):
        PagedEngine(make_config(draft_source="model"), slots=2)


def test_spec_window_wider_than_the_kernel_is_refused():
    """spec_tokens 16 with fused attention is a 17-row verify window, one
    more than the attention kernel takes: construction raises rather than
    let a window run the plain version; 15 builds."""
    with pytest.raises(ValueError, match="exceeds the attention kernel"):
        PagedEngine(make_config(spec_tokens=attention.MAX_WINDOW), slots=2)
    eng = PagedEngine(make_config(
        spec_tokens=attention.MAX_WINDOW - 1,
        sampling=SamplingParams.greedy(max_new_tokens=8)), slots=2)
    assert eng.spec + 1 == attention.MAX_WINDOW
    assert eng.cfg.fused_decode_attention


def test_megastep_counts_dead_lanes_in_window_positions():
    """A slot dead inside a megastep strands spec+1 positions a lane."""
    eng = PagedEngine(make_config(), slots=2, chunk=2, megastep=4,
                      megastep_max=4)
    d = paged_lib._Dispatch(
        toks=torch.zeros((4, 2, 2, 4), dtype=torch.int32),
        active=torch.tensor([[1, 1], [0, 1], [0, 1], [0, 1]],
                            dtype=torch.int8),
        started=torch.tensor([True, True]), flipped=None, firsts=None,
        counts=torch.zeros((4, 2, 2), dtype=torch.int32), event=None,
        slots=[None, None])
    eng._reap(d)
    assert eng.pop_dispatch_stats()[2] == 2 * 4 * 2  # chunk x (k+1) x lanes


def test_spec_stream_over_grpc_assembles_to_the_unary_answer():
    """The server with --spec-tokens: a StreamLLMAnswer assembles to the
    GetLLMAnswer answer and the engine's direct one (windows deliver
    several tokens a step); /healthz names the speculation config and
    /metrics carries its gauge."""
    args = tutoring_server.build_parser().parse_args(
        ["--device", "cpu", "--model", "tiny", "--paged", "--slots", "2",
         "--chunk", "2", "--max-new-tokens", "16", "--spec-tokens", "3",
         "--draft-source", "ngram", "--prefix-cache",
         "--prefill-chunk-tokens", "4"])
    built = tutoring_server.engine_from_args(args)
    assert built.spec == 3 and built._draft_fn.__name__ == \
        "build_drafts_ngram"
    assert built.fused and built.prefix_cache is not None
    # Served greedy, so the three answers can be held equal.
    engine = PagedEngine(make_config(
        sampling=SamplingParams.greedy(max_new_tokens=16),
        draft_source="ngram"), slots=2, chunk=2, prefix_cache=True,
        prefill_chunk_tokens=4)
    query = "what is a raft term?"
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    rid = engine.submit(PROMPT_TEMPLATE.format(query=query))
    direct = engine.drain()[rid].strip()

    async def run():
        server = await tutoring_server.serve_async(
            0, engine, host="127.0.0.1", metrics_port=0)
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server._port}") as channel:
                stub = rpc.TutoringStub(channel)
                chunks = [ch async for ch in stub.StreamLLMAnswer(
                    lms_pb2.StreamRequest(query=query), timeout=60)]
                unary = await stub.GetLLMAnswer(
                    lms_pb2.QueryRequest(query=query), timeout=60)
            health = await _http_json(server._health.port, "/healthz")
            metrics = await _http_json(server._health.port, "/metrics")
            return chunks, unary, health, metrics
        finally:
            await server.stop(None)
            await server._queue.close()

    chunks, unary, health, metrics = asyncio.run(run())
    assert all(c.success for c in chunks) and chunks[-1].final
    offsets = [c.offset for c in chunks]
    assert offsets == sorted(offsets)
    assert "".join(c.text for c in chunks).strip() == unary.response == \
        direct
    assert health["spec_tokens"] == 3 and health["draft_source"] == "ngram"
    assert "spec_tokens_per_window" in json.dumps(metrics)


async def _http_json(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    return json.loads(raw.partition(b"\r\n\r\n")[2])
