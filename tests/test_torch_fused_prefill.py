"""The port's fused staged admission on the CPU, against the JAX package.

Admission is staged: the prompt goes to the slot's transcript row and a
staged plane, and each megastep iteration prefills one chunk of
`prefill_chunk_tokens` positions for the oldest staged slot before its
decode chunk, flipping the slot live when the prompt is done. A tiny
`PagedEngine` of each package holds the same weights (`params_from_jax`);
greedy answers must be byte-equal at chunk budgets 8 and 32 (a prompt in
several chunks with a pad tail, and a whole prompt in one), dense and with
int8 weights and an int8 KV cache, with equal dispatch statistics. Then the
JAX pins: fused equals sequential, decode never stalls, K stays >= 2 while
requests wait, and the queue reports the stall series.
"""

import asyncio
import functools

import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine.prefix_cache import (
    plan_staged as jax_plan_staged,
)
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine.prefix_cache import plan_staged
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

# A budget of 32 new tokens lets a 32-token chunk budget stand unclamped
# (the engines clamp it to max_new + 1); prompts fill buckets 16 and 32.
MAX_NEW = 32
PROMPTS = ["what is raft?", "hello world", "explain paging in an OS",
           "k", "a longer question about replicated logs", "paxos?",
           "why do leaders need a majority of votes?"]
QUANT = {"dense": {}, "int8": dict(quant="int8", kv_quant=True)}


def port_config(max_new=MAX_NEW, **kw):
    return EngineConfig(model="tiny", batch_buckets=(1, 2, 4),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", length_buckets=(16, 32),
                        sampling=SamplingParams.greedy(max_new_tokens=max_new),
                        **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(quant_mode, options):
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        length_buckets=(16, 32),
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        **QUANT[quant_mode]), slots=3, chunk=2, **dict(options))
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    return ([out[r] for r in rids], jeng.pop_dispatch_stats(),
            jax.device_get(jeng.params))


def _port_run(quant_mode, options, tree):
    eng = PagedEngine(port_config(fused_attention=True, **QUANT[quant_mode]),
                      slots=3, chunk=2, **dict(options))
    eng.params = params_from_jax(tree, device="cpu")
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.drain()
    return eng, [out[r] for r in rids], eng.pop_dispatch_stats()


@pytest.mark.parametrize("quant_mode", sorted(QUANT))
@pytest.mark.parametrize("prefill_chunk", [8, 32])
def test_greedy_byte_equal_to_jax_fused(quant_mode, prefill_chunk):
    options = (("megastep", 2), ("megastep_max", 4),
               ("prefill_chunk_tokens", prefill_chunk))
    want, jstats, tree = _jax_run(quant_mode, options)
    eng, got, stats = _port_run(quant_mode, options, tree)
    assert eng.prefill_chunk == prefill_chunk
    assert got == want
    dispatches, tokens, dead, stall_ms, stalled = stats
    assert (dispatches, tokens, dead, stalled) == (
        jstats[0], jstats[1], jstats[2], jstats[4])
    assert stall_ms == jstats[3] == 0 and stalled == 0
    # Every prompt prefilled inside the megasteps, none sequentially.
    assert eng.prefill_calls == 0 and eng.admission_chunks >= len(PROMPTS)


def test_fused_at_rung_one_equals_sequential():
    """K = 1 still dispatches through the megastep (the admission chunk
    runs), and answers as the sequential engine does."""
    seq = PagedEngine(port_config(), slots=3, chunk=2)
    fused = PagedEngine(port_config(), slots=3, chunk=2,
                        prefill_chunk_tokens=5)
    fused.params = seq.params
    rs = [seq.submit(p) for p in PROMPTS]
    out_s = seq.drain()
    rf = [fused.submit(p) for p in PROMPTS]
    out_f = fused.drain()
    assert [out_f[r] for r in rf] == [out_s[r] for r in rs]
    assert any(name == "megastep" for name, _, _ in fused.pop_program_times())


def test_pipelined_matches_serialized():
    cfg = port_config(max_new=8)
    answers = []
    for inflight in (1, 3):
        eng = PagedEngine(cfg, slots=2, chunk=2, inflight=inflight,
                          megastep=4, megastep_max=4, prefill_chunk_tokens=4)
        rids = [eng.submit(p) for p in PROMPTS]
        out = eng.drain()
        answers.append([out[r] for r in rids])
    assert answers[0] == answers[1]


def _churn(engine):
    """A request arrives while another decodes (the JAX pin's `_churn`)."""
    engine.submit("a long question about distributed consensus and logs")
    for _ in range(2):
        engine.step()
    engine.submit("b second question")
    engine.submit("c third question")
    engine.drain()
    return engine.pop_dispatch_stats()


def test_sequential_admission_stalls_fused_does_not():
    cfg = port_config(max_new=8)
    *_, stall_ms, stalled = _churn(
        PagedEngine(cfg, slots=2, chunk=2, megastep=2, megastep_max=2))
    assert stalled > 0 and stall_ms > 0
    *_, stall_ms, stalled = _churn(
        PagedEngine(cfg, slots=2, chunk=2, megastep=2, megastep_max=2,
                    prefill_chunk_tokens=4))
    assert stalled == 0 and stall_ms == 0
    # Saturation: K stays >= 2 the whole time a backlog waits.
    fused = PagedEngine(cfg, slots=2, chunk=2, megastep=4, megastep_max=4,
                        prefill_chunk_tokens=4)
    ks = []
    for i in range(8):
        fused.submit(f"question number {i}")
    while fused.has_work:
        fused.step()
        if fused._pending:
            ks.append(fused.megastep_k)
    assert ks and min(ks) >= 2


def test_staged_slots_are_served_in_staging_order():
    """The host's plan serves staged prompts by staging sequence, not by
    slot index, one chunk an iteration, as the device's argmin does."""
    eng = PagedEngine(port_config(max_new=8), slots=3, chunk=2,
                      megastep=4, megastep_max=4, prefill_chunk_tokens=4)
    for p in ("first prompt here", "second", "third one"):
        eng.submit(p)
    eng._stage_admissions()
    first, _, last = eng._slot_req
    first.stage_seq, last.stage_seq = 9, 0  # slot 2 staged before slot 0
    need = [r.chunks_left for r in eng._slot_req]
    assert eng._plan_admissions(need[2] + 1) == [True] * (need[2] + 1)
    assert [r.chunks_left for r in eng._slot_req] == [need[0], need[1] - 1,
                                                       0]
    total = need[0] + need[1] - 1
    assert eng._plan_admissions(total + 2) == [True] * total + [False] * 2


def test_admission_chunk_masks_the_pad_tail():
    """A final chunk that runs past the prompt writes its pad tail inside
    the width, as the JAX package's ragged scatter does (under an MoE
    model the pad rows attend it and share expert capacity with the real
    rows), and nothing past the chunk (int8 K/V and scales included); no
    other slot's pages change."""
    eng = PagedEngine(port_config(max_new=8, quant="int8", kv_quant=True),
                      slots=2, chunk=2, prefill_chunk_tokens=9)
    width = eng.state.cache.max_len
    kv = eng._kv
    for x in (kv.k, kv.v):
        x.fill_(7)
    for x in (kv.ks, kv.vs):
        x.fill_(0.5)
    eng.submit("abcdefghijkl")  # 12 tokens: a 9-chunk, then one of 3 + 6
    eng._stage_admissions()
    before = [x.clone() for x in (kv.k, kv.v, kv.ks, kv.vs)]
    eng._admission(eng.params, eng.state)
    eng._admission(eng.params, eng.state)
    assert bool(eng.state.active[0]) or int(eng.state.tok[0]) == \
        eng.tokenizer.eos_id
    assert int(eng.state.cache.lengths[0]) == 12
    for old, new in zip(before, (kv.k, kv.v, kv.ks, kv.vs)):
        assert torch.equal(new[:, 1], old[:, 1])           # other slot
        assert torch.equal(new[:, 0, :, 18:], old[:, 0, :, 18:])  # past it
        assert not torch.equal(new[:, 0, :, :12], old[:, 0, :, :12])
        assert not torch.equal(new[:, 0, :, 12:18], old[:, 0, :, 12:18])
    assert eng.state.cache.max_len == width
    # Nothing staged: a spurious chunk changes nothing.
    snap = [x.clone() for x in (kv.k, eng.state.cache.lengths,
                                eng.state.active, eng.state.tok)]
    flipped, _ = eng._admission(eng.params, eng.state)
    assert not bool(flipped.any())
    for old, new in zip(snap, (kv.k, eng.state.cache.lengths,
                               eng.state.active, eng.state.tok)):
        assert torch.equal(old, new)


def test_plan_staged_block_alignment_equals_jax():
    cases = [(16, 20, 4, 16), (16, 16, 4, 12), (15, 20, 4, 12),
             (3, 20, 4, 0), (0, 20, 4, 0)]
    for hit, tl, blk, want in cases:
        assert plan_staged(hit, tl, blk) == jax_plan_staged(hit, tl, blk) \
            == want


class _StallingStubEngine:
    """Paged-protocol stub whose dispatch statistics report a known
    admission stall (the JAX pin's stub, with the 5-tuple)."""

    backlog = 0

    def __init__(self):
        self._work = []
        self._rid = 0

    def submit(self, prompt):
        self._rid += 1
        self._work.append((self._rid, prompt))
        return self._rid

    @property
    def has_work(self):
        return bool(self._work)

    def step(self):
        done, self._work = self._work[:1], self._work[1:]
        return [(rid, f"answer to {p}") for rid, p in done]

    def pop_ttfts(self):
        return {}

    def pop_program_times(self):
        return []

    def pop_dispatch_stats(self):
        return (3, 10, 2, 12.5, 4)


def test_paged_queue_reports_stall_metrics():
    """`prefill_stall_ms`, `decode_stalled_tokens` and
    `megastep_dead_lane_tokens` from a stub that reports them; neither
    stall series from a fused engine's real run."""

    async def run(q, n):
        await q.start()
        try:
            return await asyncio.gather(
                *[q.submit(f"query number {i}") for i in range(n)])
        finally:
            await q.close()

    metrics = Metrics()
    asyncio.run(run(PagedQueue(_StallingStubEngine(), metrics=metrics), 2))
    counters = metrics.snapshot()["counters"]
    assert counters["decode_stalled_tokens"] > 0
    assert counters["prefill_stall_ms"] > 0
    assert counters["megastep_dead_lane_tokens"] > 0

    fused_metrics = Metrics()
    fused = PagedEngine(port_config(max_new=8), slots=2, chunk=2,
                        prefill_chunk_tokens=4)
    assert len(asyncio.run(run(PagedQueue(fused, metrics=fused_metrics),
                               6))) == 6
    snap = fused_metrics.snapshot()
    assert snap["counters"].get("decode_stalled_tokens", 0) == 0
    assert snap["counters"].get("prefill_stall_ms", 0) == 0
    assert snap["latency"]["ttft"]["count"] == 6
    assert snap["latency"]["engine_prog_stage"]["count"] == 6


def test_sampled_flip_draws_what_the_sequential_prefill_draws():
    """The flip samples its first token with uniforms drawn at staging, in
    the sequential admission's order: one request whose prompt fits one
    admission chunk gives the same sampled tokens, from the same seed,
    fused or sequential."""
    cfg = port_config(seed=5)
    cfg.sampling = SamplingParams(max_new_tokens=MAX_NEW)
    seq = PagedEngine(cfg, slots=2, chunk=2)
    fused = PagedEngine(cfg, slots=2, chunk=2, prefill_chunk_tokens=32)
    prompt = "why do leaders need votes?"
    answers = []
    for eng in (seq, fused):
        eng.submit(prompt)
        req = eng._pending[-1]
        eng.drain()
        answers.append(list(req.tokens))
    assert answers[0] == answers[1] and len(answers[0]) > 1
