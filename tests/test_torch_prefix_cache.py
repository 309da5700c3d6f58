"""The port's radix prefix cache on the CPU, against the JAX package.

The tree (`engine/prefix_cache.py`, the port's own copy) must give the same
hits, splits, evictions and pins as the JAX package's on the same sequence
of operations; the JAX pins of its structure run on the port's. Then a tiny
`PagedEngine` of each package holds the same weights (`params_from_jax`):
greedy answers must be byte-equal with a prefix hit and with a miss, and
with the megastep, fused admission and the prefix cache all on, dense and
with int8 weights and an int8 KV cache, with equal hit statistics. A hit
must also answer as the cache-off engine does, under eviction pressure
too, and the queue reports the JAX package's prefix metrics.
"""

import asyncio
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import PagedQueue as JaxQueue
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import prefix_cache as jax_pc
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine.prefix_cache import (
    PrefixCache,
    plan_partial,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

MAX_NEW = 8
BLOCK = 4
# A shared course context over several 4-token blocks (byte tokenizer on
# the tiny model: a token a character), with distinct suffixes.
CTX = "the raft leader election protocol works by "
HITS = [CTX + "choosing a leader", CTX + "replicating a log",
        CTX + "electing nodes", CTX + "choosing a leader"]
MISSES = ["what is paging?", "explain a heap", "k", "why sort?"]
QUANT = {"dense": {}, "int8": dict(quant="int8", kv_quant=True)}


def ints(n, start=0):
    return list(range(start, start + n))


# ------------------------------------------------------------ the tree


def test_tree_lookup_insert_and_partial_hit():
    pc = PrefixCache(block_tokens=4, max_blocks=64)
    toks = ints(17)
    assert pc.insert(toks[:16], lambda i: f"blk{i}") == 4
    assert pc.lookup(toks[:16]).tokens == 12  # usable-capped at len - 1
    m = pc.lookup(toks + ints(8, 100))
    assert m.tokens == 16 and m.blocks() == ["blk0", "blk1", "blk2", "blk3"]
    m = pc.lookup(ints(8) + ints(12, 500))
    assert m.tokens == 8 and m.blocks() == ["blk0", "blk1"]
    assert pc.lookup(ints(12, 900)).tokens == 0


def test_tree_insert_splits_and_dedups():
    pc = PrefixCache(block_tokens=2, max_blocks=64)
    pc.insert(ints(8), lambda i: ("a", i))
    made = []
    added = pc.insert(ints(4) + ints(6, 50),
                      lambda i: made.append(i) or ("b", i))
    assert added == 3 and made == [2, 3, 4] and pc.blocks_used == 7
    assert pc.lookup(ints(8) + [99]).tokens == 8
    assert pc.lookup(ints(4) + ints(6, 50) + [99]).tokens == 10
    assert pc.insert(ints(8), lambda i: ("c", i)) == 0


def test_tree_lru_eviction_and_refcount_pin():
    pc = PrefixCache(block_tokens=2, max_blocks=4)
    pc.insert(ints(4), lambda i: ("a", i))
    pc.insert(ints(4, 100), lambda i: ("b", i))
    pin = pc.lookup(ints(4) + [9])
    pc.acquire(pin)
    pc.insert(ints(4, 200), lambda i: ("c", i))
    assert pc.evict_to_budget() == 2 and pc.blocks_used == 4
    assert pc.lookup(ints(4) + [9]).tokens == 4
    assert pc.lookup(ints(4, 100) + [9]).tokens == 0
    pc.acquire(pc.lookup(ints(4, 200) + [9]))
    pc.insert(ints(4, 300), lambda i: ("d", i))
    pc.acquire(pc.lookup(ints(4, 300) + [9]))
    assert pc.evict_to_budget() == 0 and pc.blocks_used == 6
    pc.release(pin)
    assert pc.evict_to_budget() == 2 and pc.blocks_used == 4
    assert pc.evicted_blocks == 4


def test_tree_split_keeps_pin_on_deep_node():
    pc = PrefixCache(block_tokens=2, max_blocks=2)
    pc.insert(ints(8), lambda i: ("a", i))
    pc.acquire(pc.lookup(ints(8) + [9]))
    pc.insert(ints(4) + ints(4, 50), lambda i: ("b", i))
    pc.evict_to_budget()
    assert pc.lookup(ints(8) + [9]).tokens == 8


def test_plan_partial_equals_jax():
    buckets = (8, 16, 32)
    assert plan_partial(8, 20, 32, buckets, 4) == (8, 16)
    assert plan_partial(28, 32, 32, buckets, 4) == (24, 8)
    assert plan_partial(3, 10, 16, buckets, 4) == (0, 0)
    for hit in range(0, 33):
        for tl in range(1, 33):
            for bucket in (8, 16, 32):
                got = plan_partial(hit, tl, bucket, buckets, 4)
                assert got == jax_pc.plan_partial(hit, tl, bucket, buckets,
                                                  4)


@pytest.mark.parametrize("seed", range(4))
def test_tree_matches_jax_tree_on_the_same_operations(seed):
    """Random lookups, pins, releases, inserts and evictions (and a
    session pin) over a small alphabet, so prefixes share and split: both
    trees answer every operation alike, and hold the same blocks."""
    rng = np.random.default_rng(seed)
    trees = (PrefixCache(block_tokens=2, max_blocks=12),
             jax_pc.PrefixCache(block_tokens=2, max_blocks=12))
    pins = ([], [])
    for step in range(300):
        toks = rng.integers(0, 3, size=int(rng.integers(1, 14))).tolist()
        op = rng.choice(["lookup", "insert", "acquire", "release", "evict",
                         "session"])
        outs = []
        for tree, held in zip(trees, pins):
            if op == "lookup":
                m = tree.lookup(toks)
                outs.append((m.tokens, m.used, m.blocks()))
            elif op == "insert":
                outs.append(tree.insert(toks, lambda i: (tuple(toks), i)))
            elif op == "acquire":
                m = tree.lookup(toks)
                tree.acquire(m)
                held.append(m)
                outs.append(m.tokens)
            elif op == "release" and held:
                tree.release(held.pop(0))
                outs.append(None)
            elif op == "session":
                outs.append(tree.pin_session(f"s{step % 3}", toks, 5.0,
                                             now=float(step)))
            else:
                outs.append(tree.evict_to_budget(now=float(step)))
            outs[-1] = (outs[-1], tree.blocks_used, tree.evicted_blocks,
                        tree.node_count, tree.session_count,
                        tree.session_pinned_blocks())
        assert outs[0] == outs[1], (step, op, toks)


# ---------------------------------------------- engines against JAX


def port_config(**kw):
    return EngineConfig(model="tiny", batch_buckets=(1, 2, 4),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", length_buckets=(16, 32),
                        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW),
                        **kw)


PREFIX = (("prefix_cache", True), ("prefix_cache_blocks", 64),
          ("prefix_block_tokens", BLOCK))
ALL_THREE = PREFIX + (("megastep", 4), ("megastep_max", 8),
                      ("prefill_chunk_tokens", 3))


@functools.lru_cache(maxsize=None)
def _jax_run(quant_mode, options, prompts):
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        length_buckets=(16, 32),
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        **QUANT[quant_mode]), slots=2, chunk=2, **dict(options))
    rids = [jeng.submit(p) for p in prompts]
    out = jeng.drain()
    return ([out[r] for r in rids], jeng.pop_dispatch_stats(),
            jeng.pop_prefix_stats(), jeng.pop_prefix_hits(),
            jax.device_get(jeng.params))


def _port_engine(quant_mode, options, tree=None):
    eng = PagedEngine(port_config(fused_attention=True, **QUANT[quant_mode]),
                      slots=2, chunk=2, **dict(options))
    if tree is not None:
        eng.params = params_from_jax(tree, device="cpu")
    return eng


def _drain(eng, prompts):
    rids = [eng.submit(p) for p in prompts]
    out = eng.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("quant_mode", sorted(QUANT))
@pytest.mark.parametrize("case,options,prompts", [
    ("hit", PREFIX, tuple(HITS)),
    ("miss", PREFIX, tuple(MISSES)),
    ("all_three", ALL_THREE, tuple(HITS + MISSES)),
])
def test_greedy_byte_equal_to_jax_with_prefix_cache(quant_mode, case,
                                                    options, prompts):
    want, jstats, jprefix, jhits, tree = _jax_run(quant_mode, options,
                                                  prompts)
    eng = _port_engine(quant_mode, options, tree)
    assert _drain(eng, list(prompts)) == want
    stats = eng.pop_dispatch_stats()
    assert stats[:3] == jstats[:3] and stats[4] == jstats[4]
    assert eng.pop_prefix_stats() == jprefix
    hits = eng.pop_prefix_hits()
    assert sorted(hits.values()) == sorted(jhits.values())
    if case == "miss":
        assert jprefix[0] == 0
    else:
        assert jprefix[0] > 0


@pytest.mark.parametrize("options", [PREFIX, ALL_THREE],
                         ids=["sequential", "all_three"])
def test_hits_answer_as_the_cache_off_engine(options):
    """Two passes (the second fully warm) against the cache-off engine on
    the same weights, under a block budget small enough to evict."""
    base = _port_engine("dense", ())
    want = _drain(base, HITS + MISSES)
    eng = _port_engine("dense", options + (("prefix_cache_blocks", 20),))
    eng.params = base.params
    for _ in range(2):
        assert _drain(eng, HITS + MISSES) == want
    hit, total, evicted, _ = eng.pop_prefix_stats()
    assert 0 < hit < total and evicted > 0
    assert not eng._prefix_pins  # every pin released at completion


def test_reset_releases_pins_but_keeps_tree():
    eng = _port_engine("dense", PREFIX)
    eng.submit(HITS[0])
    eng.step()
    blocks = eng.prefix_cache.blocks_used
    assert blocks > 0
    eng.reset()
    assert not eng._prefix_pins
    assert all(n.refs == 0 for n in eng.prefix_cache._iter_nodes())
    assert eng.prefix_cache.blocks_used == blocks
    assert _drain(eng, [HITS[0]])[0]
    assert eng.pop_prefix_stats()[0] > 0


def test_paged_queue_reports_prefix_metrics():
    metrics = Metrics()
    engine = _port_engine("dense", ALL_THREE)

    async def run():
        q = PagedQueue(engine, metrics=metrics)
        await q.start()
        try:
            return await asyncio.gather(*[q.submit(p)
                                          for p in HITS + HITS])
        finally:
            await q.close()

    assert len(asyncio.run(run())) == 2 * len(HITS)
    snap = metrics.snapshot()
    assert snap["counters"]["prefix_cache_hit_tokens"] > 0
    assert 0.0 < snap["gauges"]["prefix_cache_hit_rate"] < 1.0
    assert snap["gauges"]["prefix_cache_blocks_used"] > 0
    assert snap["counters"].get("decode_stalled_tokens", 0) == 0
    assert "megastep_k" in snap["gauges"]


def test_queue_metric_names_are_the_jax_ones():
    """Both packages' queues over engines with all three options, on the
    same requests: every counter and gauge the port's queue reports, the
    JAX queue reports under the same name."""

    async def run(q):
        await q.start()
        try:
            return await asyncio.gather(*[q.submit(p)
                                          for p in HITS + HITS])
        finally:
            await q.close()

    jax_metrics = JaxMetrics()
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2, 4), dtype=jnp.float32,
        length_buckets=(16, 32),
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW)),
        slots=2, chunk=2, **dict(ALL_THREE))
    asyncio.run(run(JaxQueue(jeng, metrics=jax_metrics)))
    metrics = Metrics()
    asyncio.run(run(PagedQueue(_port_engine("dense", ALL_THREE),
                               metrics=metrics)))
    want, got = jax_metrics.snapshot(), metrics.snapshot()
    for kind in ("counters", "gauges"):
        assert set(got[kind]) <= set(want[kind]), kind
    for name in ("megastep_k", "host_dispatches_per_token",
                 "prefix_cache_hit_rate", "prefix_cache_blocks_used"):
        assert name in got["gauges"] and name in want["gauges"]
    assert "prefix_cache_hit_tokens" in got["counters"]
    for name in ("ttft", "engine_prog_megastep", "engine_prog_stage"):
        assert name in got["latency"] and name in want["latency"]
