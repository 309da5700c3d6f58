"""The port's megastep decode on the CPU, against the JAX package.

The controller's pure functions are held against the JAX package's over a
grid; the dead-lane account against the JAX `_megastep_program` on the same
weights and the same prefilled state; and a tiny `PagedEngine` of each
package, holding the same weights (`params_from_jax`), must answer greedily
byte for byte alike at K = 1, 2 and 4, dense and with int8 weights and an
int8 KV cache, with equal dispatch statistics (dispatches, emitted tokens,
dead lanes, stalled tokens). On the CPU a megastep is a plain loop of its
chunks; the card replays CUDA graphs of the same chunks
(tests/test_torch_kernels_cuda.py).
"""

import asyncio
import functools
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import paged as jax_paged
from distributed_lms_raft_llm_tpu.engine import program_inventory
from distributed_lms_raft_llm_tpu.models import registry as jax_registry
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine import megastep
from distributed_lms_raft_llm_tpu_torch.engine import paged as paged_lib
from distributed_lms_raft_llm_tpu_torch.models import registry
from distributed_lms_raft_llm_tpu_torch.models.common import KVCache
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

MAX_NEW = 8
# More prompts than slots (3), over three prompt buckets (4, 8, 16).
PROMPTS = ["what is raft?", "hello world", "explain paging", "k", "k v",
           "a longer question about logs", "paxos?"]
QUANT = {"dense": {}, "int8": dict(quant="int8", kv_quant=True)}


# ------------------------------------------------- controller and ladder


@pytest.mark.parametrize("megastep_max", range(0, 13))
def test_ladder_and_ceiling_equal_jax(megastep_max):
    assert megastep.megastep_ladder(megastep_max) == \
        program_inventory.megastep_ladder(megastep_max)
    for start in range(0, 10):
        assert megastep.effective_megastep_max(start, megastep_max) == \
            program_inventory.effective_megastep_max(start, megastep_max)


@pytest.mark.parametrize("fused", [False, True])
def test_controller_equals_jax_over_a_grid(fused):
    for top in (1, 2, 6, 8):
        ladder = megastep.megastep_ladder(top)
        for current, pending, slack in itertools.product(
                range(0, 10), (0, 1, 3, 16), (None, 0, 1, 2, 3, 5, 8, 64)):
            args = (current, ladder, pending, slack)
            assert megastep.next_megastep_k(*args, fused=fused) == \
                jax_paged.next_megastep_k(*args, fused=fused), args


def test_controller_pins():
    """The JAX pins (tests/test_megastep.py): shrink to the admission
    horizon under a backlog, hold amortization under saturation, the fused
    floor at the second rung, grow when idle."""
    ladder = [1, 2, 4, 8]
    nk = megastep.next_megastep_k
    assert nk(8, ladder, pending=1, slack_chunks=1) == 1
    assert nk(8, ladder, pending=1, slack_chunks=None) == 1
    assert nk(8, ladder, pending=1, slack_chunks=5) == 4
    assert nk(1, ladder, pending=16, slack_chunks=64) == 8
    assert nk(8, ladder, pending=1, slack_chunks=1, fused=True) == 2
    assert nk(8, ladder, pending=3, slack_chunks=0, fused=True) == 2
    assert nk(1, ladder, pending=0) == 2 and nk(8, ladder, pending=0) == 8
    assert nk(1, [1], pending=5, slack_chunks=0, fused=True) == 1


# ------------------------------------------------------ dead-lane account


def test_dead_lane_account_equals_jax_megastep_program():
    """Both packages' megastep programs on the same weights and the same
    prefilled 2-slot state, with an eos that slot 0 samples inside the
    first chunk: the same token planes, active snapshots and dead-lane
    count, chunk x (K - 1) for the slot that died in chunk 0."""
    jfamily, jcfg = jax_registry.resolve("tiny", jnp.float32)
    jparams = jfamily.init_params(jax.random.key(0), jcfg)
    sampling = JaxSampling.greedy(max_new_tokens=32)
    s_slots, t0, width, chunk, k_chunks = 2, 4, 40, 2, 3
    rng = np.random.default_rng(0)
    ids = rng.integers(1, jcfg.vocab_size, (s_slots, t0)).astype(np.int32)
    cache = jfamily.init_cache(jcfg, s_slots, width, dtype=jcfg.dtype)
    _, cache = jfamily.forward(jparams, jcfg, jnp.asarray(ids), cache=cache)
    cache = cache._replace(length=jnp.full((s_slots,), t0, jnp.int32))
    key_shape = jax.random.key_data(jax.random.key(0)).shape
    jstate = jax_paged.SlotState(
        cache=cache, tok=jnp.asarray(ids[:, -1]),
        active=jnp.ones((s_slots,), bool),
        seen=jnp.zeros((s_slots, jcfg.vocab_size), bool),
        transcript=jnp.zeros((s_slots, width), jnp.int32).at[:, :t0].set(ids),
        staged=jnp.zeros((s_slots,), bool),
        stage_cursor=jnp.zeros((s_slots,), jnp.int32),
        stage_len=jnp.ones((s_slots,), jnp.int32),
        stage_seq=jnp.zeros((s_slots,), jnp.int32),
        stage_rng=jnp.zeros((s_slots,) + key_shape, jnp.uint32))
    statics = dict(cfg=jcfg, sampling=sampling, pad_id=0, model=jfamily,
                   chunk=chunk)
    _, disc, _ = jax_paged._step_program(
        jparams, jstate, jax.random.key(1), eos_id=-1,
        **dict(statics, chunk=chunk * k_chunks))
    disc = np.asarray(disc)
    eos = int(disc[1, 0])
    assert int(np.argmax(disc[:, 0] == eos)) < chunk
    assert eos not in disc[:, 1]
    rngs = jnp.stack([jax.random.key(i) for i in range(k_chunks)])
    _, jtoks, jactive, jdead = jax_paged._megastep_program(
        jparams, jstate, rngs, eos_id=eos, spec_tokens=0, **statics)

    family, cfg = registry.resolve("tiny", torch.float32, torch.float32)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    kv = family.init_cache(cfg, s_slots, width, device="cpu")
    tids = torch.from_numpy(ids).long()
    family.forward(params, cfg, tids, cache=kv)
    lengths = torch.full((s_slots,), t0, dtype=torch.int32)
    state = paged_lib.SlotState(
        cache=KVCache(k=kv.k, v=kv.v, lengths=lengths), tok=tids[:, -1],
        active=torch.ones((s_slots,), dtype=torch.bool),
        seen=torch.zeros((s_slots, cfg.vocab_size), dtype=torch.bool),
        transcript=torch.zeros((s_slots, width), dtype=torch.long),
        staged=torch.zeros((s_slots,), dtype=torch.bool),
        stage_cursor=torch.zeros((s_slots,), dtype=torch.int32),
        stage_len=torch.ones((s_slots,), dtype=torch.int32),
        stage_seq=torch.zeros((s_slots,), dtype=torch.int32),
        stage_noise=torch.zeros((s_slots, 0)))
    step = functools.partial(
        paged_lib._step_program, params, state, None, cfg=cfg,
        sampling=SamplingParams.greedy(max_new_tokens=32), eos_id=eos,
        pad_id=0, model=family, chunk=chunk)
    toks, active, started, flipped, _, counts = paged_lib._megastep_program(
        step, None, state.active, [False] * k_chunks, pad_id=0)
    assert flipped is None and bool(started.all())
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    dead = megastep.dead_lane_tokens(started, active, flipped, chunk)
    assert int(dead) == int(jdead) == chunk * (k_chunks - 1)


def test_dead_lane_account_with_a_flip():
    """A slot flipped live by a fused admission and dead in the same
    megastep strands lanes too; a staged slot's pre-flip iterations and a
    slot dead at entry do not count."""
    started = torch.tensor([True, False, False])
    active = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 0], [0, 0, 0]],
                          dtype=torch.int8)
    flipped = torch.zeros((4, 3), dtype=torch.bool)
    flipped[1, 1] = True
    # slot 0 dead after chunks 1 and 2; slot 1 live from chunk 1, dead
    # after chunk 2; slot 2 never live. The last chunk never counts.
    assert int(megastep.dead_lane_tokens(started, active, flipped, 4)) == \
        4 * (2 + 1)
    assert int(megastep.dead_lane_tokens(started, active[:1], None, 4)) == 0


# ---------------------------------------------- engines against JAX


@functools.lru_cache(maxsize=None)
def _jax_run(quant_mode, options):
    """The JAX engine's greedy answers to PROMPTS, its dispatch statistics,
    and its parameter tree, for one (quant mode, engine options) pair."""
    kw = dict(options)
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        length_buckets=(4, 8, 16),
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        **QUANT[quant_mode]), slots=3, chunk=2, **kw)
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    return ([out[r] for r in rids], jeng.pop_dispatch_stats(),
            jax.device_get(jeng.params), jeng.megastep_ks)


def _port_run(quant_mode, options, tree):
    eng = PagedEngine(EngineConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=torch.float32,
        param_dtype=torch.float32, device="cpu", length_buckets=(4, 8, 16),
        fused_attention=True,
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW),
        **QUANT[quant_mode]), slots=3, chunk=2, **dict(options))
    eng.params = params_from_jax(tree, device="cpu")
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.drain()
    return eng, [out[r] for r in rids], eng.pop_dispatch_stats()


def assert_same_stats(got, want):
    """(dispatches, tokens, dead, stall_ms, stalled): equal but for the
    stall's wall time, which must be zero on both sides or on neither."""
    assert got[:3] == want[:3] and got[4] == want[4]
    assert (got[3] > 0) == (want[3] > 0)


@pytest.mark.parametrize("quant_mode", sorted(QUANT))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_byte_equal_to_jax_at_megastep_k(quant_mode, k):
    options = (("megastep", k), ("megastep_max", k))
    want, jstats, tree, ladder = _jax_run(quant_mode, options)
    eng, got, stats = _port_run(quant_mode, options, tree)
    assert eng.megastep_ks == ladder
    assert got == want
    assert_same_stats(stats, jstats)
    if k > 1:  # fewer host decisions than chunks
        assert eng.host_decisions < eng.decode_steps // eng.chunk


@pytest.mark.parametrize("quant_mode", sorted(QUANT))
def test_controller_walk_and_stats_equal_jax(quant_mode):
    """K grows and shrinks along a ladder (start 2, ceiling 4) as the
    backlog drains: the same answers and dispatch statistics as JAX."""
    options = (("megastep", 2), ("megastep_max", 4), ("inflight", 3))
    want, jstats, tree, _ = _jax_run(quant_mode, options)
    _, got, stats = _port_run(quant_mode, options, tree)
    assert got == want
    assert_same_stats(stats, jstats)


def test_engine_controller_tracks_admission_horizon():
    """The JAX pin through the port's engine: a backlog keeps K wide while
    no slot can free, steps to 1 once the dispatched debt covers the
    guaranteed finish, and widens again when the freed lanes refill."""
    cfg = EngineConfig(model="tiny", batch_buckets=(1, 2, 4),
                       dtype=torch.float32, param_dtype=torch.float32,
                       device="cpu", length_buckets=(16,),
                       sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW))
    eng = PagedEngine(cfg, slots=2, chunk=2, megastep=4, megastep_max=4)
    for i in range(6):
        eng.submit(f"question number {i}")
    eng.step()
    assert eng.megastep_k == 4
    eng.step()
    assert eng.megastep_k == 1
    eng.step()
    assert eng.megastep_k == 4
    eng.drain()


def test_megastep_cuts_host_decisions_per_token():
    """At K=4 the host decides once per 4 chunks: step dispatches per
    emitted token fall 4x against the chunk loop (inflight 1, one request
    that uses its whole budget)."""
    cfg = EngineConfig(model="tiny", batch_buckets=(1,), dtype=torch.float32,
                       param_dtype=torch.float32, device="cpu",
                       length_buckets=(8,),
                       sampling=SamplingParams.greedy(max_new_tokens=17))

    def run(k):
        eng = PagedEngine(cfg, slots=1, chunk=1, inflight=1, megastep=k,
                          megastep_max=k)
        eng.submit("a question about raft elections and paging")
        eng.drain()
        _, tokens, _, _, _ = eng.pop_dispatch_stats()
        steps = sum(1 for name, _, _ in eng.pop_program_times()
                    if name in ("step", "megastep"))
        return tokens, steps

    t1, s1 = run(1)
    t4, s4 = run(4)
    assert t1 == t4 == 17 and s1 / s4 >= 4.0


def test_paged_queue_reports_megastep_metrics():
    """The queue's gauges and counters under the JAX names."""
    metrics = Metrics()
    cfg = EngineConfig(model="tiny", batch_buckets=(1, 2), dtype=torch.float32,
                       param_dtype=torch.float32, device="cpu",
                       length_buckets=(16,),
                       sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW))
    engine = PagedEngine(cfg, slots=2, chunk=2, megastep=2, megastep_max=4)

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
    assert snap["gauges"]["megastep_k"] in {float(k)
                                            for k in engine.megastep_ks}
    assert 0.0 < snap["gauges"]["host_dispatches_per_token"] < 2.0
    assert snap["latency"]["engine_prog_megastep"]["count"] > 0
    assert snap["latency"]["ttft"]["count"] == 4


def test_state_planes_keep_their_addresses():
    """Every plane a graph reads is a persistent buffer: growth, an idle
    rebuild at another width and reset() keep its storage (windows of one
    allocation, zeroed in place), so graphs captured at warmup read the
    live state."""
    cfg = EngineConfig(model="tiny", batch_buckets=(1, 2), dtype=torch.float32,
                       param_dtype=torch.float32, device="cpu",
                       length_buckets=(4, 16), kv_quant=True,
                       sampling=SamplingParams(max_new_tokens=MAX_NEW))
    eng = PagedEngine(cfg, slots=2, chunk=2, prefill_chunk_tokens=4)

    def storage():
        s = eng.state
        return [x.untyped_storage().data_ptr() for x in (
            s.cache.k, s.cache.v, s.cache.ks, s.cache.vs, s.cache.lengths,
            s.tok, s.active, s.seen, s.transcript, s.staged,
            s.stage_cursor, s.stage_len, s.stage_seq, s.stage_noise)]

    before = storage()
    assert eng.state.stage_noise.shape == (2, 50)  # top-k uniforms
    eng.submit("k")
    eng.step()
    eng.submit("a longer question about raft")
    eng.drain()  # grows the width
    assert storage() == before
    eng.submit("k")
    eng.step()  # idle rebuild back to the narrow width
    eng.reset()
    assert storage() == before
    assert not bool(eng.state.staged.any())
    assert int(eng.state.cache.lengths.abs().sum()) == 0
