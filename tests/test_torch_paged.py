"""The PyTorch port's continuous-batching engine on the CPU, against JAX.

A tiny `PagedEngine` of each package holds the same weights (the JAX
engine's parameter tree, quantized or not, carried across with
`params_from_jax`); under greedy decoding in float32 their answers must be
byte-equal, with more prompts than slots and mixed prompt buckets, both
with dense weights and a float cache and with int8 weights and an int8 KV
cache. The port decodes through the kernel's plain version with per-row
lengths (`fused_attention=True`), the JAX engine through its XLA einsums.
Then the cases of tests/test_paged.py and tests/test_quant.py run on the
port alone (against its bucketed engine where the JAX tests compare
against theirs), and `PagedQueue` and the server are driven in process.
"""

import asyncio
import time

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
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.engine import paged as paged_lib
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics
from distributed_lms_raft_llm_tpu_torch.utils.resilience import (
    Deadline,
    DeadlineExpired,
    Overloaded,
)

MAX_NEW = 8
PROMPTS = ["what is raft?", "hello world", "explain paging", "k"]
# More prompts than slots, over three prompt buckets (4, 8, 16).
MIXED = PROMPTS + ["k v", "a longer question about logs", "paxos?"]


def make_config(**kw):
    kw.setdefault("sampling", SamplingParams.greedy(max_new_tokens=MAX_NEW))
    kw.setdefault("length_buckets", (16,))
    return EngineConfig(model="tiny", batch_buckets=(1, 2, 4),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", **kw)


QUANT = {"dense": {}, "int8": dict(quant="int8", kv_quant=True)}


@pytest.fixture(scope="module", params=sorted(QUANT))
def jax_pair(request):
    """(JAX PagedEngine, its answers to MIXED, the port's engine options):
    module-scoped, one per weight/cache mode."""
    opts = dict(length_buckets=(4, 8, 16), **QUANT[request.param])
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW), **opts),
        slots=3)
    rids = [jeng.submit(p) for p in MIXED]
    out = jeng.drain()
    return jeng, [out[r] for r in rids], opts


def _port_like(jeng, opts, **kw):
    eng = PagedEngine(make_config(**opts), **kw)
    eng.params = params_from_jax(jax.device_get(jeng.params), device="cpu")
    return eng


def _drain(eng, prompts):
    rids = [eng.submit(p) for p in prompts]
    out = eng.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("fused", [True, False])
def test_greedy_byte_equal_to_jax_paged_engine(jax_pair, fused):
    jeng, want, opts = jax_pair
    eng = _port_like(jeng, dict(opts, fused_attention=fused), slots=3)
    assert eng.cfg.quant_kv == bool(opts.get("kv_quant"))
    assert eng.widths == jeng.widths and eng.buckets == jeng.buckets
    assert _drain(eng, MIXED) == want
    assert eng.decode_steps > 0 and eng.prefill_calls == len(MIXED)


def test_greedy_byte_equal_to_jax_at_other_slot_counts(jax_pair):
    """The schedule changes with the slot count; the answers do not."""
    jeng, want, opts = jax_pair
    for slots in (1, 7):
        eng = _port_like(jeng, dict(opts, fused_attention=True), slots=slots,
                         chunk=3)
        assert _drain(eng, MIXED) == want


def test_decode_steps_take_the_append_route(jax_pair, monkeypatch):
    """Every decode model call runs each layer's attention through
    `decode_attention_append` (the kernel's plain version on the CPU), and
    no torch row write: the answers stay JAX's."""
    from distributed_lms_raft_llm_tpu_torch.models import gpt2
    from distributed_lms_raft_llm_tpu_torch.ops import attention

    jeng, want, opts = jax_pair
    calls = {"append": 0, "decode": 0, "writes": []}
    append, decode = (attention.decode_attention_append,
                      attention.decode_attention)
    write_rows = gpt2._write_rows

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def writes(buf, layer, rows, slots, val, keep):
        calls["writes"].append(slots.shape[1])
        return write_rows(buf, layer, rows, slots, val, keep)

    monkeypatch.setattr(attention, "decode_attention_append",
                        counted("append", append))
    monkeypatch.setattr(attention, "decode_attention",
                        counted("decode", decode))
    monkeypatch.setattr(gpt2, "_write_rows", writes)
    eng = _port_like(jeng, dict(opts, fused_attention=True), slots=3)
    assert _drain(eng, MIXED) == want
    assert calls["append"] == eng.cfg.num_layers * eng.decode_steps > 0
    assert calls["decode"] == 0
    assert 1 not in calls["writes"]  # no one-slot write: the kernel's


def test_int8_engine_holds_the_quantized_tree_and_cache(jax_pair):
    jeng, _, opts = jax_pair
    eng = _port_like(jeng, opts, slots=2)
    quantized = "quant" in opts
    assert isinstance(eng.params["wte"], dict) == quantized
    assert (eng.state.cache.k.dtype == torch.int8) == quantized
    assert (eng.state.cache.ks is not None) == quantized


# ------------------------------------------ the port's engine on its own


@pytest.mark.parametrize("opts", [{}, dict(quant="int8", kv_quant=True)])
def test_greedy_parity_with_bucketed_engine(opts):
    """Same weights, greedy: the paged engine emits what the bucketed
    engine emits, despite right vs left padding and ragged slots."""
    cfg = make_config(fused_attention=True, **opts)
    expected = TutoringEngine(cfg).answer_batch(list(PROMPTS))
    assert _drain(PagedEngine(cfg, slots=4), PROMPTS) == expected


def test_mid_decode_admission_completes_without_waiting():
    paged = PagedEngine(make_config(), slots=2, chunk=1)
    paged.submit("a long question about distributed consensus and logs")
    for _ in range(3):
        paged.step()  # A is now mid-decode
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
    # B finished within its own budget (+1 for the pipeline): it did not
    # wait for A's remaining decode.
    assert finished[b] <= MAX_NEW + 2
    stats = paged.pop_dispatch_stats()
    assert stats[4] > 0  # B's prefill stalled A's decode train


def test_pipelined_outputs_match_serialized():
    cfg = make_config()
    ser = _drain(PagedEngine(cfg, slots=2, inflight=1), PROMPTS)
    assert _drain(PagedEngine(cfg, slots=2, inflight=2), PROMPTS) == ser
    assert _drain(PagedEngine(cfg, slots=2, inflight=3, chunk=3),
                  PROMPTS) == ser


def test_greedy_parity_with_prompt_buckets_and_churn():
    """Per-prompt prefill buckets plus slot reuse (5 requests, 2 slots)."""
    cfg = make_config(length_buckets=(4, 8, 16))
    prompts = list(PROMPTS) + ["k v"]
    expected = TutoringEngine(cfg).answer_batch(prompts)
    paged = PagedEngine(cfg, slots=2)
    widths = set()
    real_prefill = paged._prefill

    def spy(params, ids, *args):
        widths.add(ids.shape[1])
        return real_prefill(params, ids, *args)

    paged._prefill = spy
    assert _drain(paged, prompts) == expected
    assert len(widths) >= 2 and min(widths) < 16, widths


def test_cache_width_grows_and_shrinks_with_prompt_mix():
    cfg = make_config(length_buckets=(4, 16))
    long_prompt = "a long question about raft elections and replicated logs"
    prompts = ["k v", long_prompt, "hi"]
    expected = TutoringEngine(cfg).answer_batch(prompts)
    paged = PagedEngine(cfg, slots=2)
    assert paged.widths == [12, 24]
    narrow, wide = paged.widths
    r0 = paged.submit(prompts[0])
    paged.step()
    assert paged.state.cache.max_len == narrow
    r1 = paged.submit(prompts[1])
    out = {}
    while paged.has_work and len(out) < 2:
        out.update(paged.step())
    assert paged.state.cache.max_len == wide
    assert any(name == "grow" for name, _, _ in paged.pop_program_times())
    r2 = paged.submit(prompts[2])
    while paged.has_work:
        out.update(paged.step())
    assert paged.state.cache.max_len == narrow
    assert [out[r] for r in (r0, r1, r2)] == expected
    # every width is a window of the one allocation
    assert paged.state.cache.k.data_ptr() == paged._kv.k.data_ptr()


def test_slot_reuse_evict_then_readmit():
    cfg = make_config()
    sequential = PagedEngine(cfg, slots=1)
    r1 = sequential.submit(PROMPTS[0])
    out1 = sequential.drain()
    r2 = sequential.submit(PROMPTS[1])
    out2 = sequential.drain()
    fresh = PagedEngine(cfg, slots=1)
    f1 = fresh.submit(PROMPTS[0])
    f2 = fresh.submit(PROMPTS[1])
    both = fresh.drain()
    assert both[f1] == out1[r1] and both[f2] == out2[r2]


def test_overflow_budget_clamped_or_rejected():
    """tiny's position table is 64: a budget of 50 clamps the prompt
    bucket to 14; a budget that leaves no prompt room is refused."""
    eng = PagedEngine(make_config(
        sampling=SamplingParams.greedy(max_new_tokens=50)), slots=2)
    assert eng.bucket == 14 and eng.bucket + 50 <= 64 and eng.tmax == 64
    rid = eng.submit("a prompt much longer than fourteen byte-tokens")
    assert isinstance(eng.drain()[rid], str)
    with pytest.raises(ValueError, match="no room"):
        PagedEngine(make_config(
            sampling=SamplingParams.greedy(max_new_tokens=64)), slots=2)


def test_dead_slot_pad_filler_not_appended_when_pad_differs_from_eos():
    """With pad != eos, a slot inactive from admission (its first token is
    eos) answers empty: chunk pad filler is not content."""
    paged = PagedEngine(make_config(), slots=2)
    paged.tokenizer.pad_id = 0
    assert paged.tokenizer.eos_id != 0
    paged._step = paged_lib.functools.partial(
        paged_lib._step_program, eos_id=paged.tokenizer.eos_id, pad_id=0,
        chunk=paged.chunk, cfg=paged.cfg, sampling=paged.config.sampling,
        model=paged.family)
    real_prefill = paged._prefill

    def eos_first(*args):
        _first, seen = real_prefill(*args)
        return torch.tensor(paged.tokenizer.eos_id), seen

    paged._prefill = eos_first
    rid = paged.submit("anything at all")
    assert paged.drain()[rid] == paged.tokenizer.decode([])


def test_step_program_keeps_offsets_inside_the_window():
    """A full slot writes at its clamped offset and stays at the width: no
    index leaves the cache, and its token budget ends it on the host."""
    eng = PagedEngine(make_config(), slots=2, chunk=4)
    eng.state = eng._init_state(eng.widths[0])
    width = eng.state.cache.max_len
    eng.state.cache.lengths[:] = torch.tensor([width - 1, width],
                                              dtype=torch.int32)
    eng.state.active[:] = True
    toks, active = eng._step(eng.params, eng.state, eng.generator)
    assert toks.shape == (4, 2) and toks.dtype == torch.int32
    assert active.dtype == torch.int8
    assert eng.state.cache.lengths.tolist() == [width, width]


def test_sampled_generation_is_seeded():
    cfg = make_config(sampling=SamplingParams(max_new_tokens=MAX_NEW), seed=3)
    assert _drain(PagedEngine(cfg, slots=2), PROMPTS) == _drain(
        PagedEngine(cfg, slots=2), PROMPTS)


def test_warmup_runs_every_width_and_leaves_a_clean_engine():
    eng = PagedEngine(make_config(length_buckets=(4, 8, 16)), slots=2)
    assert eng.warmup() > 0
    assert not eng.has_work and eng.pop_ttfts() == {}
    assert eng.pop_dispatch_stats()[:2] == (0, 0)
    assert eng.kv_bytes_total == sum(
        x.numel() * x.element_size() for x in (eng.state.cache.k,
                                               eng.state.cache.v))


def test_cancel_pending_and_backlog():
    eng = PagedEngine(make_config(), slots=1)
    a, b = eng.submit("a"), eng.submit("b")
    assert eng.backlog == 2
    assert eng.cancel_pending(b) and not eng.cancel_pending(b)
    assert set(eng.drain()) == {a}


@pytest.mark.parametrize("option,match", [
    # Speculative decoding, the scoring tenant, tp and ep are ported
    # (tests/test_torch_tp.py, tests/test_torch_ep.py): sp is refused with
    # the JAX paged engine's message (it has no full-sequence forward to
    # shard), and ep on this dense model with its message, beside tp too.
    (dict(config=dict(spec_tokens=2, sp=2)), "sp applies to"),
    (dict(config=dict(tp=2, ep=2)), "requires an MoE family"),
    (dict(config=dict(scoring=True, sp=2)), "sp applies to"),
    (dict(config=dict(ep=2)), "requires an MoE family"),
])
def test_unported_options_raise(option, match):
    option = dict(option)
    cfg = make_config(**option.pop("config", {}))
    with pytest.raises(ValueError, match=match):
        PagedEngine(cfg, **option)


def test_unknown_quant_mode_refused():
    with pytest.raises(ValueError, match="quant mode"):
        PagedEngine(make_config(quant="int4"))


# ---------------------------------------------------------- PagedQueue


def test_paged_queue_serves_concurrent_requests():
    metrics = Metrics()
    engine = PagedEngine(make_config(), slots=2)

    async def run():
        q = PagedQueue(engine, metrics=metrics)
        await q.start()
        try:
            return await asyncio.gather(
                *[q.submit(f"query number {i}") for i in range(5)])
        finally:
            await q.close()

    answers = asyncio.run(run())
    assert len(answers) == 5 and all(isinstance(a, str) for a in answers)
    snap = metrics.snapshot()
    assert snap["latency"]["ttft"]["count"] == 5
    assert snap["latency"]["engine_prog_step"]["count"] > 0
    assert 0 < snap["gauges"]["host_dispatches_per_token"] < 1
    want = _drain(PagedEngine(make_config(), slots=2),
                  [f"query number {i}" for i in range(5)])
    assert answers == want


def test_paged_queue_recovers_after_step_failure():
    """A failed step fails its requests and resets the engine, so later
    requests still serve."""
    engine = PagedEngine(make_config(), slots=2)
    orig_step = engine.step
    armed = {"on": True}
    resets = []
    orig_reset = engine.reset

    def flaky_step():
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected device failure")
        return orig_step()

    def counting_reset():
        resets.append(1)
        orig_reset()

    engine.step = flaky_step
    engine.reset = counting_reset

    async def run():
        q = PagedQueue(engine)
        await q.start()
        try:
            with pytest.raises(RuntimeError, match="injected"):
                await q.submit("first")
            return await q.submit("second")
        finally:
            await q.close()

    assert isinstance(asyncio.run(run()), str) and resets == [1]


def test_paged_queue_sheds_overload_and_expired_requests():
    engine = PagedEngine(make_config(), slots=1)
    metrics = Metrics()

    async def run():
        q = PagedQueue(engine, metrics=metrics, max_queue=1)
        with pytest.raises(DeadlineExpired):
            await q.submit("x", deadline=Deadline.after(0.0))
        # Not started: the first request waits in the queue, the second
        # finds the bound reached.
        first = asyncio.ensure_future(q.submit("a"))
        await asyncio.sleep(0)
        with pytest.raises(Overloaded):
            await q.submit("b")
        await q.start()
        answer = await first
        # Backlogged past its deadline behind a slow step: cancelled
        # before its prefill.
        q.max_queue = 0
        step = engine.step

        def slow_step():
            time.sleep(0.1)
            return step()

        engine.step = slow_step
        engine.submit("occupies the only slot")
        late = asyncio.ensure_future(q.submit(
            "late", deadline=Deadline.after(0.05)))
        with pytest.raises(DeadlineExpired, match="backlogged"):
            await late
        await q.close()
        return answer

    assert isinstance(asyncio.run(run()), str)
    assert metrics.snapshot()["counters"]["shed_overload"] == 1
    assert metrics.snapshot()["counters"]["shed_expired"] >= 1


def test_deadline_raise_if_expired_matches_jax():
    """`raise_if_expired` passes while budget is left and then raises
    with the JAX package's message (tests/test_resilience.py's check)."""
    from distributed_lms_raft_llm_tpu.utils import resilience as jax_res

    now = [0.0]
    messages = []
    for deadline, expired in ((jax_res.Deadline, jax_res.DeadlineExpired),
                              (Deadline, DeadlineExpired)):
        now[0] = 0.0
        d = deadline.after(5.0, clock=lambda: now[0])
        d.raise_if_expired()
        now[0] = 6.0
        with pytest.raises(expired) as err:
            d.raise_if_expired("prefill")
        messages.append(str(err.value))
    assert messages == ["prefill: deadline expired"] * 2


def test_server_serves_a_paged_engine_through_paged_queue():
    engine = PagedEngine(make_config(), slots=2)
    query = "what is a linked list?"

    async def run():
        server = await tutoring_server.serve_async(0, engine,
                                                   host="127.0.0.1")
        try:
            assert isinstance(server._queue, PagedQueue)
            service = server._service
            return await service.GetLLMAnswer(
                tutoring_server.lms_pb2.QueryRequest(query=query), None)
        finally:
            await server.stop(0)
            await server._queue.close()

    resp = asyncio.run(run())
    want = _drain(PagedEngine(make_config(), slots=2),
                  [tutoring_server.PROMPT_TEMPLATE.format(query=query)])[0]
    assert resp.success and resp.response == want.strip()


@pytest.mark.parametrize("flag", [["--megastep", "4"], ["--prefix-cache"],
                                  ["--prefill-chunk-tokens", "32"]])
def test_server_refuses_unported_flags(flag):
    """The three flags the server once refused now build a paged engine
    with their option, served through `PagedQueue`."""
    args = tutoring_server.build_parser().parse_args(
        ["--device", "cpu", "--model", "tiny", "--paged", "--slots", "2",
         "--max-new-tokens", "8", *flag])
    engine = tutoring_server.engine_from_args(args)
    assert isinstance(engine, PagedEngine)
    assert (engine.megastep_max, engine.prefix_cache is not None,
            engine.prefill_chunk) == {
        "--megastep": (4, False, 0), "--prefix-cache": (1, True, 0),
        "--prefill-chunk-tokens": (1, False, 9)}[flag[0]]

    async def run():
        server = await tutoring_server.serve_async(0, engine,
                                                   host="127.0.0.1")
        try:
            assert isinstance(server._queue, PagedQueue)
            return await server._service.GetLLMAnswer(
                tutoring_server.lms_pb2.QueryRequest(query="what is raft?"),
                None)
        finally:
            await server.stop(0)
            await server._queue.close()

    assert asyncio.run(run()).success


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_server_refuses_paged_without_warmup_on_the_card(device):
    """On the card the paged engine serves through CUDA graphs captured in
    warmup: skipping warmup there is refused before anything is built,
    not answered with an eager engine."""
    args = tutoring_server.build_parser().parse_args(
        ["--device", device, "--model", "tiny", "--paged", "--no-warmup"])
    with pytest.raises(ValueError, match="captures its CUDA graphs"):
        tutoring_server.engine_from_args(args)


def test_server_builds_paged_without_warmup_on_the_cpu():
    args = tutoring_server.build_parser().parse_args(
        ["--device", "cpu", "--model", "tiny", "--paged", "--no-warmup",
         "--slots", "2", "--max-new-tokens", "8"])
    engine = tutoring_server.engine_from_args(args)
    assert isinstance(engine, PagedEngine) and not engine.cuda_graphs
