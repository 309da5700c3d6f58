"""Expert parallelism in the port: gloo ranks on the CPU, held against the
JAX package at the same ep (its 8-virtual-device mesh) and against the
port at ep 1, on the same JAX-initialised weights.

Two rank pools start once for the module (`tests/torch_tp_ranks.py`): two
ranks (ep 2) and four (ep 4, and tp 2 x ep 2); every case runs on all the
ranks of its pool at once. Held here:

- the MoE forward (full sequence, prefill, one decode step) at ep 2, ep 4
  and ep 2 x tp 2 (dense; int8 at ep 2 x tp 2): logits within atol/rtol
  2e-5 of the JAX package's at the same mesh (tests/test_moe.py's
  tolerance: the row-parallel sums differ in order) and equal on every
  rank;
- ep 2 against ep 1 bit-equal in float32: a token's combine has at most
  two non-zero terms, and adding the other rank's zeros is exact;
- greedy answers byte-equal to the JAX engines: the paged engine at
  tp 2 x ep 2 (tests/test_paged_sharded.py's MoE case) and the bucketed
  engine at ep 2, every rank taking the same decisions, each holding
  E / ep experts;
- the tutoring node started with ``--ep 2`` serves from two processes;
- the refusals: ep on a family without experts (the JAX engines'
  messages), and an ep that does not divide the experts.
"""

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
from torch_tp_ranks import Ranks

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.parallel import partition as jax_partition
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.models import registry
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.parallel import partition
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The forwards' tolerance against JAX (tests/test_moe.py's).
ATOL = RTOL = 2e-5
MAX_NEW = 8
PROMPTS = ["what is raft?", "hello world", "explain paging", "k"]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by world size, started on first use."""
    made = {}

    def get(world):
        if world not in made:
            made[world] = Ranks(world, tmp_path_factory.mktemp(
                f"ep_rendezvous_{world}"))
        return made[world]

    yield get
    for ranks in made.values():
        ranks.close()


@pytest.fixture(scope="module")
def moe_tree():
    """The JAX MoE init (tests/test_moe.py's key), JAX and port trees."""
    cfg = jax_moe.GPT2MoEConfig.tiny(dtype=jnp.float32,
                                     param_dtype=jnp.float32)
    params = jax_moe.init_params(jax.random.key(0), cfg)
    return cfg, params


def _jax_forwards(cfg, params, ids, sizes):
    """JAX logits (full sequence, prefill, one decode step) on the virtual
    mesh of `sizes`, params sharded by MOE_RULES."""
    m = jax_mesh.make_mesh(dict(sizes, dp=-1), devices=jax.devices()[:8])
    sharded = jax_partition.shard_tree(params, m,
                                       jax_partition.RULES_FOR["gpt2_moe"])
    fwd = jax.jit(jax_moe.forward, static_argnums=(1,))
    ids = jnp.asarray(ids)
    b, t = ids.shape
    with m:
        full, _ = fwd(sharded, cfg, ids)
        cache = jax_moe.init_cache(cfg, b, t)
        pre, cache = fwd(sharded, cfg, ids[:, :-1], cache)
        step, _ = fwd(sharded, cfg, ids[:, -1:], cache)
    return {k: np.asarray(v) for k, v in
            (("full", full), ("prefill", pre), ("step", step))}


def _port_ep1(tree, ids, dtype=torch.float32):
    """The port's logits at ep 1 (one process) on the same tree."""
    family, cfg = registry.resolve("moe-tiny", dtype)
    ids = torch.as_tensor(ids)
    b, t = ids.shape
    with torch.no_grad():
        full, _ = family.forward(tree, cfg, ids)
        cache = family.init_cache(cfg, b, t, dtype=dtype, device="cpu")
        pre, cache = family.forward(tree, cfg, ids[:, :-1], cache=cache)
        step, _ = family.forward(tree, cfg, ids[:, -1:], cache=cache)
    return {"full": full.float().numpy(), "prefill": pre.float().numpy(),
            "step": step.float().numpy()}


# (pool, ep, the JAX mesh): tp takes the ranks ep leaves.
LAYOUTS = {"ep2": (2, 2, {"ep": 2}), "ep4": (4, 4, {"ep": 4}),
           "ep2_tp2": (4, 2, {"ep": 2, "tp": 2})}


# Every layout dense; the int8 expert pairs on the composed one.
@pytest.mark.parametrize("layout,quant", [
    ("ep2", "dense"), ("ep4", "dense"), ("ep2_tp2", "dense"),
    ("ep2_tp2", "int8")])
def test_moe_forward_at_ep_matches_jax(pools, moe_tree, layout, quant):
    world, ep, sizes = LAYOUTS[layout]
    cfg, params = moe_tree
    if quant == "int8":
        params = jax_quant.quantize_params(params, "gpt2_moe")
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
    tree = params_from_jax(jax.device_get(params), device="cpu")
    got = pools(world).run("moe_forward", tree=tree, ids=ids, ep=ep)
    want = _jax_forwards(cfg, params, ids, sizes)
    for rank, out in enumerate(got):
        assert out["experts"] == cfg.num_experts // ep
        assert out["coords"]["ep"] == (rank // (world // ep)) % ep
        for key in ("full", "prefill", "step"):
            np.testing.assert_array_equal(out[key], got[0][key])
            np.testing.assert_allclose(out[key], want[key], atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.parametrize("quant", ["dense", "int8"])
def test_ep2_is_bit_equal_to_ep1_in_float32(pools, moe_tree, quant):
    """Each expert's product is the same at ep 1 and ep 2, and the combine
    adds only zeros to a token's sum: equal bits, not a tolerance."""
    cfg, params = moe_tree
    if quant == "int8":
        params = jax_quant.quantize_params(params, "gpt2_moe")
    ids = np.random.RandomState(6).randint(0, cfg.vocab_size, (3, 10))
    tree = params_from_jax(jax.device_get(params), device="cpu")
    got = pools(2).run("moe_forward", tree=tree, ids=ids, ep=2)
    want = _port_ep1(tree, ids)
    for out in got:
        for key in ("full", "prefill", "step"):
            np.testing.assert_array_equal(out[key], want[key])


def test_paged_greedy_byte_equal_to_jax_at_tp2_ep2(pools):
    jeng = JaxPaged(JaxConfig(
        model="moe-tiny", tp=2, ep=2, batch_buckets=(1, 2),
        dtype=jnp.float32, length_buckets=(4, 16),
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW)),
        slots=2, chunk=2)
    assert jeng.tp == 2 and jeng.ep == 2
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    want = [out[r] for r in rids]
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = pools(4).run("paged", model="moe-tiny", tree=tree, prompts=PROMPTS,
                       config_kw=dict(ep=2, max_new=MAX_NEW),
                       engine_kw=dict(slots=2, chunk=2))
    leader = got[0]
    rids = sorted(leader["answers"])
    assert [leader["answers"][r] for r in rids] == want
    for rank in got:
        assert {r: rank["answers"][r] for r in rids} == leader["answers"]
        assert rank["decisions"] == leader["decisions"]
        assert (rank["tp"], rank["ep"], rank["experts"]) == (2, 2, 2)
        assert rank["cache_heads"] == 2


def test_bucketed_greedy_byte_equal_to_jax_at_ep2(pools):
    jeng = JaxEngine(JaxConfig(
        model="moe-tiny", ep=2, dtype=jnp.float32, param_dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
        length_buckets=(16,), batch_buckets=(1, 2, 4)))
    want = jeng.answer_batch(PROMPTS)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    got = pools(2).run("bucketed", model="moe-tiny", tree=tree,
                       prompts=PROMPTS,
                       config_kw=dict(ep=2, max_new=MAX_NEW,
                                      length_buckets=(16,),
                                      batch_buckets=(1, 2, 4)))
    assert got[0] == want
    assert got[1] == want  # the follower's own replay of the batch


def _port_config(**kw):
    return EngineConfig(device="cpu", dtype=torch.float32,
                        param_dtype=torch.float32, **kw)


@pytest.mark.parametrize("cls,jax_cls", [(TutoringEngine, JaxEngine),
                                         (PagedEngine, JaxPaged)])
def test_ep_on_a_family_without_experts_is_refused_as_jax_does(cls,
                                                               jax_cls):
    with pytest.raises(ValueError) as jax_err:
        jax_cls(JaxConfig(model="tiny", ep=2))
    with pytest.raises(ValueError) as err:
        cls(_port_config(model="tiny", ep=2))
    assert str(err.value) == str(jax_err.value)
    assert "requires an MoE family" in str(err.value)


@pytest.mark.parametrize("cls", [TutoringEngine, PagedEngine])
def test_ep_that_does_not_divide_the_experts_is_refused(cls, moe_tree):
    """moe-tiny's 4 experts over ep 3: the engines refuse it before any
    process group, and the slicing refuses it where the JAX package's
    `device_put` does."""
    with pytest.raises(ValueError, match="does not divide the 4 experts"):
        cls(_port_config(model="moe-tiny", ep=3))
    cfg, params = moe_tree
    m = jax_mesh.make_mesh({"ep": 3, "dp": -1}, devices=jax.devices()[:6])
    with pytest.raises(ValueError):
        jax_partition.shard_tree(params, m,
                                 jax_partition.RULES_FOR["gpt2_moe"])
    tree = params_from_jax(jax.device_get(params), device="cpu")
    with pytest.raises(ValueError, match="does not split over ep=3"):
        partition.shard_params(tree, partition.MOE_RULES, 0, 1, 0, 3)


# -------------------------------------------------------------- the node


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tutoring_node_serves_at_ep2(tmp_path):
    """`--ep 2` on an MoE model starts the node as rank 0, which spawns
    rank 1 and serves alone; /healthz reports the two ways."""
    port, mport = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributed_lms_raft_llm_tpu_torch.serving.tutoring_server",
         "--device", "cpu", "--model", "moe-tiny", "--max-new-tokens", "8",
         "--paged", "--slots", "2", "--chunk", "2", "--ep", "2",
         "--no-warmup",
         "--tp-backend", "gloo", "--port", str(port), "--metrics-port",
         str(mport), "--no-telemetry"],
        env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / "node.log", "wb"))
    try:
        deadline = time.monotonic() + 90
        health = None
        while time.monotonic() < deadline and health is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/healthz", timeout=2) as r:
                    health = json.loads(r.read())
            except OSError:
                if proc.poll() is not None:
                    break
                time.sleep(0.5)
        assert health is not None and health["ep"] == 2
        assert "tp" not in health

        async def ask():
            import grpc

            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = rpc.TutoringStub(ch)
                return await stub.GetLLMAnswer(
                    lms_pb2.QueryRequest(query="what is raft?"), timeout=60)

        assert asyncio.run(ask()).success
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert "tp rank 1 of 2 following rank 0" in (
        tmp_path / "node.log").read_text()
