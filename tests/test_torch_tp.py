"""Tensor parallelism in the port, two gloo ranks on the CPU, held against
the JAX package at tp 2 (its 8-virtual-device mesh) and against the port
at tp 1, on the same JAX-initialised weights.

The two rank processes (`tests/torch_tp_ranks.py`) start once for the
module and rendezvous through a `file://` path under the module's tmp dir;
every case runs on both ranks at once. Held here:

- the GPT-2, Llama and MoE forwards in float32, dense and int8, full-sequence,
  prefill and one decode step: logits within atol 2e-5 / rtol 1e-5 of the
  JAX package's at tp 2 and of the port's at tp 1, and equal on both ranks;
- greedy answers byte-equal to the JAX engines at tp 2: `TutoringEngine`,
  and `PagedEngine` in the six configurations of
  tests/test_paged_sharded.py (plain, spec, megastep, fused admission,
  prefix hit, int8 KV); both ranks return the same answers and took the
  same host decisions (admissions, megastep K and admission plans);
- each rank's KV bytes are half of tp 1's and `serving_tp` reads 2 through
  `PagedQueue`; CUDA graphs over gloo raise at construction;
- a session release and a stream unwatch made from another thread while
  rank 0 steps reach every rank at the same point; a fault on one rank
  fails every rank instead of leaving one waiting in a collective;
- the tutoring node started with ``--tp 2`` serves from two processes,
  and ends once its follower is gone.

dp, in the same two ranks and a pool of four, against the JAX package on
as many virtual devices (its ``"dp": -1`` takes the spare ones):

- `make_hybrid_mesh` over four ranks in two hosts (`LOCAL_WORLD_SIZE=2`):
  each axis' all-reduce sums exactly the ranks JAX's hybrid mesh puts on
  that axis;
- greedy answers byte-equal to JAX's: the bucketed engine at dp 2, tp 2 x
  dp 2 and gpt2-moe at ep 2 x dp 2 (capacity 1.25 of 4 experts, so an
  answer depends on its companions); the paged engine at dp 2 and tp 2 x
  dp 2 in two configurations, every rank the same answers and decisions;
- scoring at sp 2 x dp 2 of three texts (the batch rounded to dp with a
  filler row) within tests/test_torch_ring.py's tolerance of JAX's, and
  its shapes JAX's; the gate at dp 2 within 1e-5 of JAX's;
- the node under torchrun's variables (``WORLD_SIZE`` 2, ``--tp 1``)
  serving at dp 2, and a ``WORLD_SIZE`` that is not a multiple refused.
"""

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_tp_ranks import Ranks, jax_hybrid_ranks

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import llama as jax_llama
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.parallel import partition as jax_partition
from distributed_lms_raft_llm_tpu_torch.engine import EngineConfig
from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams
from distributed_lms_raft_llm_tpu_torch.models import registry
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
# The forwards' tolerance against JAX at tp 2 and the port at tp 1: the
# row-parallel sums add two partial products where tp 1 adds one.
ATOL, RTOL = 2e-5, 1e-5
MAX_NEW = 8
PROMPTS = ["what is raft?", "hello world", "explain paging", "k"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(TP, tmp_path_factory.mktemp("tp_rendezvous"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("dp_rendezvous"))
    yield r
    r.close()


# --------------------------------------------------------------- forward

# The MoE trunk shards like GPT-2; at ep = 1 its experts stay whole on
# every rank.
JAX_MODELS = {
    "tiny": (jax_gpt2, jax_gpt2.GPT2Config.tiny, "gpt2"),
    "llama-tiny": (jax_llama, jax_llama.LlamaConfig.tiny, "llama"),
    "moe-tiny": (jax_moe, jax_moe.GPT2MoEConfig.tiny, "gpt2_moe"),
}


def _jax_forwards(model, params, ids, tp):
    """JAX logits (full sequence, prefill, one decode step) at `tp` on the
    virtual mesh, params sharded by the JAX rules."""
    module, factory, family = JAX_MODELS[model]
    cfg = factory(dtype=jnp.float32, param_dtype=jnp.float32)
    m = jax_mesh.make_mesh({"tp": tp, "dp": -1}, devices=jax.devices()[:8])
    sharded = jax_partition.shard_tree(params, m,
                                       jax_partition.RULES_FOR[family])
    fwd = jax.jit(module.forward, static_argnums=(1,))
    ids = jnp.asarray(ids)
    b, t = ids.shape
    with m:
        full, _ = fwd(sharded, cfg, ids)
        cache = module.init_cache(cfg, b, t)
        pre, cache = fwd(sharded, cfg, ids[:, :-1], cache)
        step, _ = fwd(sharded, cfg, ids[:, -1:], cache)
    return {k: np.asarray(v) for k, v in
            (("full", full), ("prefill", pre), ("step", step))}


def _port_forwards(model, tree, ids):
    """The port's logits at tp 1 on the same tree."""
    family, cfg = registry.resolve(model, torch.float32)
    ids = torch.as_tensor(ids)
    b, t = ids.shape
    with torch.no_grad():
        full, _ = family.forward(tree, cfg, ids)
        cache = family.init_cache(cfg, b, t, dtype=torch.float32,
                                  device="cpu")
        pre, cache = family.forward(tree, cfg, ids[:, :-1], cache=cache)
        step, _ = family.forward(tree, cfg, ids[:, -1:], cache=cache)
    return {"full": full.numpy(), "prefill": pre.numpy(),
            "step": step.numpy()}


@pytest.mark.parametrize("quant", ["dense", "int8"])
@pytest.mark.parametrize("model", sorted(JAX_MODELS))
def test_forward_at_tp2_matches_jax_tp2_and_port_tp1(ranks, model, quant):
    module, factory, family = JAX_MODELS[model]
    cfg = factory(dtype=jnp.float32, param_dtype=jnp.float32)
    params = module.init_params(jax.random.key(3), cfg)
    if quant == "int8":
        params = jax_quant.quantize_params(params, family)
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 9))
    tree = params_from_jax(jax.device_get(params), device="cpu")
    got = ranks.run("forward", model=model, tree=tree, ids=ids)
    jax_tp2 = _jax_forwards(model, params, ids, TP)
    port_tp1 = _port_forwards(model, tree, ids)
    heads = getattr(cfg, "num_kv_heads", cfg.num_heads)
    for rank in range(TP):
        assert got[rank]["cache_heads"] == heads // TP
        for key in ("full", "prefill", "step"):
            np.testing.assert_array_equal(got[rank][key], got[0][key])
            np.testing.assert_allclose(got[rank][key], jax_tp2[key],
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(got[rank][key], port_tp1[key],
                                       atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------- engines

# tests/test_paged_sharded.py's serving configurations.
CONFIGS = [
    ("plain", {}, {}),
    ("spec", {"spec_tokens": 2}, {}),
    ("megastep", {}, {"megastep": 2, "megastep_max": 4}),
    ("fused_admission", {},
     {"megastep": 2, "megastep_max": 4, "prefill_chunk_tokens": 4}),
    ("prefix_hit", {},
     {"prefix_cache": True, "prefix_cache_blocks": 64,
      "prefix_block_tokens": 4}),
    ("kv_quant", {"kv_quant": True}, {}),
]
# The prefix case repeats a course context (an exact repeat guarantees a
# deep block hit, as in tests/test_paged_sharded.py).
CTX = "the raft leader election protocol works by "
PREFIX_PROMPTS = [CTX + "choosing a leader", CTX + "choosing a leader",
                  CTX + "counting votes", "k"]


def _jax_paged(cfg_kw, eng_kw, prompts):
    kw = dict(cfg_kw)
    if "prefix_cache" in eng_kw:
        kw["length_buckets"] = (16, 32)
    eng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2), dtype=jnp.float32, tp=TP,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        length_buckets=kw.pop("length_buckets", (4, 16)), **kw),
        slots=2, chunk=2, **eng_kw)
    rids = [eng.submit(p) for p in prompts]
    out = eng.drain()
    return eng, [out[r] for r in rids]


@pytest.mark.parametrize("name,cfg_kw,eng_kw", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_paged_greedy_byte_equal_to_jax_tp2(ranks, name, cfg_kw, eng_kw):
    prompts = PREFIX_PROMPTS if "prefix_cache" in eng_kw else PROMPTS
    jeng, want = _jax_paged(cfg_kw, eng_kw, prompts)
    config_kw = dict(cfg_kw, max_new=MAX_NEW)
    if "prefix_cache" in eng_kw:
        config_kw["length_buckets"] = (16, 32)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = ranks.run("paged", model="tiny", tree=tree, prompts=prompts,
                    config_kw=config_kw,
                    engine_kw=dict(slots=2, chunk=2, **eng_kw))
    leader, follower = got
    rids = sorted(leader["answers"])
    assert [leader["answers"][r] for r in rids] == want
    assert {r: follower["answers"][r] for r in rids} == leader["answers"]
    assert follower["decisions"] == leader["decisions"]
    kinds = {d[0] for d in leader["decisions"]}
    assert "dispatch" in kinds and kinds & {"admit", "stage"}
    if name == "prefix_hit":
        assert jeng.pop_prefix_stats()[0] > 0


def test_bucketed_greedy_byte_equal_to_jax_tp2(ranks):
    sampling = JaxSampling.greedy(max_new_tokens=MAX_NEW)
    jeng = JaxEngine(JaxConfig(model="tiny", dtype=jnp.float32, tp=TP,
                               sampling=sampling, length_buckets=(16,),
                               batch_buckets=(1, 2, 4)))
    want = jeng.answer_batch(PROMPTS)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = ranks.run("bucketed", model="tiny", tree=tree, prompts=PROMPTS,
                    config_kw=dict(max_new=MAX_NEW, length_buckets=(16,),
                                   batch_buckets=(1, 2, 4)))
    assert got[0] == want
    assert got[1] == want  # the follower's own replay of the batch


def test_kv_bytes_halve_and_serving_tp_reads_2(ranks):
    """Each rank's KV planes hold half the heads, so half of tp 1's bytes;
    the queue's gauges say so."""
    port = PagedEngine(EngineConfig(
        model="tiny", device="cpu", dtype=torch.float32,
        param_dtype=torch.float32, batch_buckets=(1, 2),
        length_buckets=(4, 16),
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW)), slots=2,
        chunk=2)
    tree = port.params
    rids = [port.submit(p) for p in PROMPTS]
    out = port.drain()
    want = [out[r] for r in rids]
    got = ranks.run("queue", model="tiny", tree=tree, prompts=PROMPTS,
                    engine_kw=dict(slots=2, chunk=2))
    leader = got[0]
    assert leader["answers"] == want
    assert sorted(got[1]) == sorted(want)
    assert leader["serving_tp"] == 2.0
    paged = ranks.run("paged", model="tiny", tree=tree, prompts=PROMPTS[:1],
                      engine_kw=dict(slots=2, chunk=2))
    for rank in paged:
        assert rank["tp"] == TP and rank["cache_heads"] == 2
        assert rank["kv_bytes_total"] == TP * rank["kv_bytes_per_chip"]
        assert rank["kv_bytes_per_chip"] == port.kv_bytes_per_chip // TP
    assert leader["serving_kv_bytes_per_chip"] == \
        port.kv_bytes_per_chip // TP


def test_session_release_and_unwatch_during_a_step_stay_in_step(ranks):
    """A session closed and a stream unwatched from another thread while
    rank 0's step runs are deferred to the next broadcast, so every rank
    applies them at the same point: the ranks' answers, decisions, pinned
    sessions, watched rids and kept final tokens stay equal."""
    port = PagedEngine(EngineConfig(
        model="tiny", device="cpu", dtype=torch.float32,
        param_dtype=torch.float32, batch_buckets=(1, 2),
        length_buckets=(16, 32),
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW)), slots=2,
        chunk=2)
    engine_kw = dict(slots=2, chunk=2, prefix_cache=True,
                     prefix_cache_blocks=64, prefix_block_tokens=4)
    got = ranks.run("release_during_step", model="tiny", tree=port.params,
                    prompts=PREFIX_PROMPTS,
                    config_kw=dict(max_new=MAX_NEW, length_buckets=(16, 32)),
                    engine_kw=engine_kw)
    leader, follower = got
    assert leader["fired"] == [(True, None)]
    assert sorted(leader["answers"]) == list(range(len(PREFIX_PROMPTS)))
    for key in ("answers", "decisions", "pins", "pin_stats", "watched",
                "finals"):
        assert follower[key] == leader[key], key
    assert leader["pins"] == ["s2"]
    assert leader["watched"] == [] and leader["finals"] == [3]
    assert leader["pin_stats"][0] == 1


def test_a_fault_on_one_rank_fails_every_rank(tmp_path):
    """A replayed call that raises on the follower alone fails the group:
    the follower aborts the process group, rank 0's step raises instead of
    waiting in its collective, and every later call raises at once."""
    port = PagedEngine(EngineConfig(
        model="tiny", device="cpu", dtype=torch.float32,
        param_dtype=torch.float32, batch_buckets=(1, 2),
        length_buckets=(4, 16),
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW)), slots=2,
        chunk=2)
    own = Ranks(TP, tmp_path)
    try:
        leader, follower = own.run("follower_fails", model="tiny",
                                   tree=port.params, prompts=PROMPTS,
                                   timeout=60.0)
    finally:
        own.close()
    assert "a fault on this rank alone" in follower["error"]
    assert "tp rank 1: step() raised RuntimeError" in follower["error"]
    assert "tp rank 0: step() raised" in leader["error"]
    assert "the tp group failed" in leader["later"]
    assert leader["seconds"] < 30 and follower["seconds"] < 30


def test_cuda_graphs_over_gloo_raise_at_construction(ranks):
    for message in ranks.run("refusals"):
        assert message is not None
        assert "cuda_graphs over the gloo backend" in message


# -------------------------------------------------------------- the node


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_node(tmp_path):
    """A paged tutoring node at `--tp 2` over gloo on the CPU, once its
    /healthz answers: (process, gRPC port, metrics port, health)."""
    port, mport = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributed_lms_raft_llm_tpu_torch.serving.tutoring_server",
         "--device", "cpu", "--model", "tiny", "--max-new-tokens", "8",
         "--paged", "--slots", "2", "--chunk", "2", "--tp", "2",
         "--tp-backend", "gloo", "--port", str(port), "--metrics-port",
         str(mport), "--no-telemetry"],
        env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / "node.log", "wb"))
    return proc, port, mport, _health(proc, mport)


def _health(proc, mport):
    """The node's /healthz once it answers (None if `proc` exits first or
    90 s pass)."""
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/healthz", timeout=2) as r:
                return json.loads(r.read())
        except OSError:
            if proc.poll() is not None:
                return None
            time.sleep(0.5)
    return None


def _ask(port):
    """One GetLLMAnswer to the node on `port`."""
    async def ask():
        import grpc

        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = rpc.TutoringStub(ch)
            return await stub.GetLLMAnswer(
                lms_pb2.QueryRequest(query="what is raft?"), timeout=60)

    return asyncio.run(ask())


def test_tutoring_node_serves_at_tp2(tmp_path):
    """`--tp 2` starts the node as rank 0, which spawns rank 1 and serves
    alone; /healthz and /metrics report the two ways."""
    proc, port, mport, health = _start_node(tmp_path)
    try:
        assert health is not None and health["tp"] == 2
        assert _ask(port).success
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=5) as r:
            gauges = json.loads(r.read())["gauges"]
        assert gauges["serving_tp"] == 2.0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    # Rank 0 released its follower before it exited.
    assert "tp rank 1 of 2 following rank 0" in (
        tmp_path / "node.log").read_text()


def test_tutoring_node_ends_when_its_follower_dies(tmp_path):
    """Rank 0 cannot go on without a rank: once the follower it started
    is gone, the node exits with code 1 instead of waiting for it in its
    next collective."""
    proc, _, _, health = _start_node(tmp_path)
    try:
        assert health is not None and health["tp"] == 2
        children = open(f"/proc/{proc.pid}/task/{proc.pid}/children").read()
        (follower,) = [int(pid) for pid in children.split()]
        os.kill(follower, signal.SIGKILL)
        assert proc.wait(timeout=30) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "tp follower (pid %d) exited" % follower in (
        tmp_path / "node.log").read_text()



# -------------------------------------------------------------------- dp


def _pool(ranks, ranks4, world):
    return ranks if world == TP else ranks4


def test_hybrid_mesh_axes_all_reduce_over_jax_lines(ranks4):
    """Two hosts of two ranks: each axis' subgroup sums 2 ** rank over
    exactly the ranks of the line JAX's hybrid mesh puts this rank on."""
    layouts = [({"dp": 2}, {"tp": 2}), ({"sp": 2}, {"dp": 2})]
    got = ranks4.run("hybrid_axes", layouts=layouts, local_world_size=2)
    for i, (ici, dcn) in enumerate(layouts):
        ids = jax_hybrid_ranks(ici, dcn, 2, 4)
        for rank, out in enumerate(got):
            rec = out[i]
            assert rec["layout"] == tuple(ids.ravel())
            where = tuple(np.argwhere(ids == rank)[0])
            assert tuple(rec["coords"].values()) == where
            for axis, name in enumerate(rec["coords"]):
                line = list(where)
                line[axis] = slice(None)
                want = tuple(int(r) for r in ids[tuple(line)])
                assert rec["ranks"][name] == want
                if len(want) > 1:
                    assert rec["sums"].pop(name) == sum(2.0 ** r
                                                        for r in want)
            assert rec["sums"] == {}
    # The first layout is not row-major: tp pairs ranks 0 and 2.
    assert got[0][0]["ranks"]["tp"] == (0, 2)


DP_BUCKETED = [("tiny", 2, {}), ("tiny", 4, {"tp": 2}),
               ("moe-tiny", 4, {"ep": 2})]


@pytest.mark.parametrize("model,world,axes", DP_BUCKETED,
                         ids=["dp2", "tp2_dp2", "moe_ep2_dp2"])
def test_bucketed_greedy_byte_equal_to_jax_at_dp(ranks, ranks4, model, world,
                                                 axes):
    jeng = JaxEngine(JaxConfig(
        model=model, dtype=jnp.float32, param_dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        length_buckets=(16,), batch_buckets=(1, 2, 4), **axes),
        devices=jax.devices()[:world])
    assert jeng.mesh.shape["dp"] == 2
    want = jeng.answer_batch(PROMPTS)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = _pool(ranks, ranks4, world).run(
        "bucketed", model=model, tree=tree, prompts=PROMPTS,
        config_kw=dict(axes, tp=axes.get("tp", 1), max_new=MAX_NEW,
                       length_buckets=(16,), batch_buckets=(1, 2, 4)))
    assert got == [want] * world  # every rank replays the whole batch


@pytest.mark.parametrize("world,tp", [(2, 1), (4, 2)], ids=["dp2", "tp2_dp2"])
@pytest.mark.parametrize("name,cfg_kw,eng_kw", [CONFIGS[0], CONFIGS[2]],
                         ids=[CONFIGS[0][0], CONFIGS[2][0]])
def test_paged_greedy_byte_equal_to_jax_at_dp(ranks, ranks4, world, tp, name,
                                              cfg_kw, eng_kw):
    jeng = JaxPaged(JaxConfig(
        model="tiny", batch_buckets=(1, 2), dtype=jnp.float32, tp=tp,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        length_buckets=(4, 16), **cfg_kw), devices=jax.devices()[:world],
        slots=2, chunk=2, **eng_kw)
    assert jeng.mesh.shape["dp"] == 2
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = _pool(ranks, ranks4, world).run(
        "paged", model="tiny", tree=tree, prompts=PROMPTS,
        config_kw=dict(cfg_kw, tp=tp, max_new=MAX_NEW),
        engine_kw=dict(slots=2, chunk=2, **eng_kw))
    leader = got[0]
    assert [leader["answers"][r] for r in sorted(leader["answers"])] == \
        [out[r] for r in rids]
    for rank in got:
        assert (rank["dp"], rank["tp"]) == (2, tp)
        assert rank["answers"] == leader["answers"]
        assert rank["decisions"] == leader["decisions"]


def test_scoring_at_sp2_dp2_matches_jax(ranks4):
    """Three texts in batch bucket 3: the rows round up to 4 for dp 2, the
    filler row scored and dropped; each dp line scores two rows round its
    sp ring."""
    from test_torch_ring import SCORE_ATOL, SCORE_RTOL, TEXTS

    from distributed_lms_raft_llm_tpu.engine import scoring as jax_scoring
    from distributed_lms_raft_llm_tpu_torch.engine import program_inventory

    texts = TEXTS + ["a third text on terms"]
    buckets = dict(length_buckets=(16, 32), batch_buckets=(1, 3))
    jeng = JaxEngine(JaxConfig(
        model="tiny", sampling=JaxSampling(max_new_tokens=4), sp=2,
        dtype=jnp.float32, param_dtype=jnp.float32, scoring=True, **buckets),
        devices=jax.devices()[:4])
    assert jeng.mesh.shape["dp"] == 2
    want = jeng.score(texts)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = ranks4.run("score", model="tiny", tree=tree, texts=texts,
                     config_kw=dict(sp=2, tp=1, max_new=4, scoring=True,
                                    **buckets))
    shapes = jax_scoring.derive_score_shapes(
        (16, 32), (1, 3), jeng.cfg.max_position_embeddings, sp=2, dp=2)
    assert (2, 16) in shapes and (4, 32) in shapes  # batches round to dp
    assert program_inventory.static_score_domain(
        (16, 32), (1, 3), jeng.cfg.max_position_embeddings, sp=2,
        dp=2)["pairs"] == shapes
    for rank in got:
        assert rank["dp"] == 2 and rank["shapes"] == shapes
        assert [(s["tokens"], s["truncated"]) for s in rank["scores"]] == [
            (w["tokens"], w["truncated"]) for w in want]
        np.testing.assert_allclose(
            [s["logprob"] for s in rank["scores"]],
            [w["logprob"] for w in want], rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_gate_at_dp2_matches_jax_gate(ranks):
    from test_torch_gate import BUCKETS
    from test_torch_gate_tp import F32_TOL, PAIRS

    from distributed_lms_raft_llm_tpu.engine.gate import (
        GateConfig as JaxGateConfig,
        RelevanceGate as JaxGate,
    )

    jgate = JaxGate(JaxGateConfig(model="tiny", dtype=jnp.float32,
                                  length_buckets=BUCKETS),
                    devices=jax.devices()[:2])
    assert jgate.mesh.shape["dp"] == 2
    want = [jgate.check(q, c) for q, c in PAIRS]
    tree = params_from_jax(jax.device_get(jgate.params), device="cpu")
    leader, follower = ranks.run("gate", tree=tree, pairs=PAIRS,
                                 gate_kw=dict(length_buckets=BUCKETS, tp=1))
    assert [ok for ok, _ in leader["checks"]] == [ok for ok, _ in want]
    np.testing.assert_allclose([s for _, s in leader["checks"]],
                               [s for _, s in want], atol=F32_TOL, rtol=0)
    assert leader["word_rows"] == follower["word_rows"] == 384
    assert leader["forwards"] == follower["forwards"] > 0


def test_node_world_under_torchrun(monkeypatch):
    args = argparse.Namespace(tp=2, ep=1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tutoring_server.node_world(args) == 2
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tutoring_server.node_world(args) == 4  # dp 2
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="not a multiple of --tp 2"):
        tutoring_server.node_world(args)


def test_tutoring_node_serves_at_dp2_under_torchrun(tmp_path):
    """Two processes with torchrun's variables (WORLD_SIZE 2) at --tp 1:
    one node at dp 2, rank 0 serving, rank 1 following without a port."""
    port, mport, master = _free_port(), _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "distributed_lms_raft_llm_tpu_torch.serving.tutoring_server",
             "--device", "cpu", "--model", "tiny", "--max-new-tokens", "8",
             "--paged", "--slots", "2", "--chunk", "2", "--tp", "1",
             "--tp-backend", "gloo", "--port", str(port), "--metrics-port",
             str(mport), "--no-telemetry"],
            env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL,
            stderr=open(tmp_path / f"rank{rank}.log", "wb")))
    try:
        health = _health(procs[0], mport)
        assert health is not None and health["dp"] == 2
        assert "tp" not in health
        assert _ask(port).success
    finally:
        procs[0].send_signal(signal.SIGINT)
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
    assert codes[1] == 0  # released by rank 0
    assert "tp rank 1 of 2 following rank 0" in (
        tmp_path / "rank1.log").read_text()
