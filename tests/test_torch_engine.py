"""The PyTorch port's serving path on the CPU, against the JAX package.

A tiny `TutoringEngine` of each package holds the same weights (the JAX
init carried across with `params_from_jax`); under greedy decoding their
`generate_ids` tokens and lengths must be byte-equal. The JAX engine runs
with `fused_attention=True` on one CPU device, its Pallas decode kernel in
interpret mode; the port runs the same flag through the kernel's plain
version. Then the port's `BatchingQueue` and `TutoringService` are driven
in process.
"""

import asyncio
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxEngineConfig
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu_torch.device import resolve_device
from distributed_lms_raft_llm_tpu_torch.engine import (
    BatchingQueue,
    EngineConfig,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2
from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
from distributed_lms_raft_llm_tpu_torch.utils import auth

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["hello world", "what is raft?", "explain a binary search tree"]


def _port_engine(**kw):
    cfg = dict(model="tiny", sampling=SamplingParams.greedy(max_new_tokens=8),
               length_buckets=(16, 32), batch_buckets=(1, 2, 4),
               dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    cfg.update(kw)
    return TutoringEngine(EngineConfig(**cfg))


@pytest.fixture(scope="module")
def engines():
    """(jax engine, port engine) with the same weights."""
    mp = pytest.MonkeyPatch()
    orig = jax_attention.pl.pallas_call
    mp.setattr(jax_attention.pl, "pallas_call",
               functools.partial(orig, interpret=True))
    try:
        jeng = JaxEngine(
            JaxEngineConfig(
                model="tiny", sampling=JaxSampling.greedy(max_new_tokens=8),
                length_buckets=(16, 32), batch_buckets=(1, 2, 4),
                fused_attention=True, dtype=jnp.float32,
                param_dtype=jnp.float32,
            ),
            devices=jax.devices()[:1],
        )
        peng = _port_engine(fused_attention=True)
        peng.params = params_from_jax(jax.device_get(jeng.params),
                                      device="cpu")
        yield jeng, peng
    finally:
        mp.undo()


@pytest.mark.parametrize("prompts", [PROMPTS, PROMPTS[:1], ["x" * 40] * 2])
def test_greedy_generate_ids_byte_equal_to_jax(engines, prompts):
    jeng, peng = engines
    assert jeng.cfg.fused_decode_attention and peng.cfg.fused_decode_attention
    ids, mask, bucket = peng.encode_prompts(prompts)
    jids, jmask, jbucket = jeng.encode_prompts(prompts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    want = jeng.generate_ids(jids, jmask)
    got = peng.generate_ids(ids, mask)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert jeng.answer_batch(prompts) == peng.answer_batch(prompts)


def test_fused_and_plain_attention_agree(engines):
    _, peng = engines
    plain = _port_engine(fused_attention=False)
    plain.params = peng.params
    assert not plain.cfg.fused_decode_attention
    ids, mask, _ = peng.encode_prompts(PROMPTS)
    a, b = peng.generate_ids(ids, mask), plain.generate_ids(ids, mask)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_engine_counts_decode_steps_and_measures_ttft():
    eng = _port_engine()
    ids, mask, _ = eng.encode_prompts(PROMPTS)
    before = eng.decode_steps
    result = eng.generate_ids(ids, mask)
    steps = eng.decode_steps - before
    # Without EOS every row runs the whole budget: max_new - 1 steps.
    assert 0 < steps <= 7 and result.lengths.max() == steps + 1
    assert eng.last_ttft_s is not None and eng.last_ttft_s > 0
    assert result.tokens.dtype == np.int32 and result.tokens.shape == (4, 8)


def test_sampled_generation_is_seeded():
    kw = dict(sampling=SamplingParams(max_new_tokens=8), seed=3)
    a, b = _port_engine(**kw), _port_engine(**kw)
    assert a.answer_batch(PROMPTS) == b.answer_batch(PROMPTS)


@pytest.mark.parametrize("option,error,match", [
    # Speculative decoding, the scoring tenant, tp, ep and sp are ported
    # (tests/test_torch_tp.py, test_torch_ep.py, test_torch_ring.py run
    # them over ranks): ep on this dense model is refused with the JAX
    # engine's message, even beside tp; the other axes need a process
    # group of their ranks, which this process has not joined; and a
    # quant mode the JAX engine lacks is refused.
    (dict(tp=2, ep=2), ValueError, "requires an MoE family"),
    (dict(ep=2), ValueError, "requires an MoE family"),
    (dict(sp=2), RuntimeError, "process group of 2 ranks"),
    (dict(spec_tokens=2, tp=2, sp=2), RuntimeError,
     "process group of 4 ranks"),
    (dict(scoring=True, sp=2), RuntimeError, "process group of 2 ranks"),
    (dict(quant="int4"), ValueError, "unsupported quant mode"),
])
def test_unported_engine_options_raise(option, error, match):
    with pytest.raises(error, match=match):
        _port_engine(**option)


QUANT_OPTIONS = {"int8": dict(quant="int8"), "kv_quant": dict(kv_quant=True),
                 "both": dict(quant="int8", kv_quant=True)}


@pytest.fixture(scope="module", params=sorted(QUANT_OPTIONS))
def quant_engines(request):
    """(JAX TutoringEngine, port engine, options) with int8 weights and/or
    an int8 KV cache; the port holds the JAX engine's (quantized) tree."""
    opts = QUANT_OPTIONS[request.param]
    jeng = JaxEngine(
        JaxEngineConfig(
            model="tiny", sampling=JaxSampling.greedy(max_new_tokens=8),
            length_buckets=(16, 32), batch_buckets=(1, 2, 4),
            dtype=jnp.float32, param_dtype=jnp.float32, **opts,
        ),
        devices=jax.devices()[:1],
    )
    peng = _port_engine(fused_attention=True, **opts)
    peng.params = params_from_jax(jax.device_get(jeng.params), device="cpu")
    return jeng, peng, opts


@pytest.mark.parametrize("prompts", [PROMPTS, ["x" * 40] * 2])
def test_quantized_greedy_byte_equal_to_jax(quant_engines, prompts):
    """The bucketed engine with int8 weights and/or an int8 KV cache, as
    the JAX engine serves them (tests/test_quant.py): greedy tokens in
    float32 byte-equal. The JAX engine refuses its Pallas kernel with an
    int8 cache; the port's decode goes through its kernel's plain version
    in every mode."""
    jeng, peng, opts = quant_engines
    assert peng.cfg.quant_kv == opts.get("kv_quant", False)
    assert peng.cfg.fused_decode_attention
    ids, mask, _ = peng.encode_prompts(prompts)
    want = jeng.generate_ids(ids, mask)
    got = peng.generate_ids(ids, mask)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def test_quantized_fused_and_plain_attention_agree(quant_engines):
    _, peng, opts = quant_engines
    plain = _port_engine(fused_attention=False, **opts)
    plain.params = peng.params
    ids, mask, _ = peng.encode_prompts(PROMPTS)
    np.testing.assert_array_equal(peng.generate_ids(ids, mask).tokens,
                                  plain.generate_ids(ids, mask).tokens)


def test_quantized_engine_quantizes_its_own_weights():
    eng = _port_engine(quant="int8", kv_quant=True)
    wqkv = eng.params["blocks"]["attn"]["wqkv"]
    assert wqkv["q"].dtype == torch.int8 and wqkv["s"].shape == (2, 96)
    assert eng.params["wte"]["s"].shape == (384,)
    assert len(eng.answer_batch(PROMPTS)) == len(PROMPTS)
    with pytest.raises(ValueError, match="quant mode"):
        _port_engine(quant="int4")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        _port_engine(device="cuda")


def test_position_budget_checked_explicitly():
    with pytest.raises(ValueError, match="max_new_tokens"):
        _port_engine(sampling=SamplingParams(max_new_tokens=64))


def test_batching_queue_coalesces():
    eng = _port_engine(sampling=SamplingParams.greedy(max_new_tokens=4),
                       length_buckets=(16,))
    calls = []
    orig = eng.answer_batch

    def spy(prompts):
        calls.append(len(prompts))
        return orig(prompts)

    eng.answer_batch = spy

    async def run():
        q = BatchingQueue(eng, max_batch=4, max_wait_ms=200)
        await q.start()
        try:
            return await asyncio.gather(*[q.submit(f"q{i}") for i in range(4)])
        finally:
            await q.close()

    answers = asyncio.run(run())
    assert len(answers) == 4 and max(calls) >= 2
    assert answers == orig([f"q{i}" for i in range(4)])


def test_tutoring_service_answers_without_grpc_context():
    eng = _port_engine()
    query = "what is a linked list?"

    async def run():
        q = BatchingQueue(eng, max_batch=4, max_wait_ms=1)
        await q.start()
        service = tutoring_server.TutoringService(q, tutoring_server.Metrics(),
                                                  auth_key="k")
        try:
            ok = await service.GetLLMAnswer(lms_pb2.QueryRequest(
                query=query, token=auth.sign_query("k", query)), None)
            bad = await service.GetLLMAnswer(
                lms_pb2.QueryRequest(query=query, token="1:x"), None)
            empty = await service.GetLLMAnswer(lms_pb2.QueryRequest(
                query="  ", token=auth.sign_query("k", "  ")), None)
            return ok, bad, empty
        finally:
            await q.close()

    ok, bad, empty = asyncio.run(run())
    want = eng.answer_batch(
        [tutoring_server.PROMPT_TEMPLATE.format(query=query)])[0]
    assert ok.success and ok.response == want.strip()
    assert not bad.success and bad.response.startswith("Unauthorized")
    assert not empty.success and empty.response == "Empty query."


def test_port_imports_no_jax():
    """The port's entry points load neither `jax` nor any module of the JAX
    package (whose name is a prefix of the port's own)."""
    code = (
        "import json, sys\n"
        "import distributed_lms_raft_llm_tpu_torch.engine\n"
        "import distributed_lms_raft_llm_tpu_torch.engine.paged\n"
        "import distributed_lms_raft_llm_tpu_torch.models.quant\n"
        "import distributed_lms_raft_llm_tpu_torch.models.llama\n"
        "import distributed_lms_raft_llm_tpu_torch.models.moe\n"
        "import distributed_lms_raft_llm_tpu_torch.ops\n"
        "import distributed_lms_raft_llm_tpu_torch.ops.quant_matmul\n"
        "import distributed_lms_raft_llm_tpu_torch.serving.tutoring_server\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.tracing\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.healthz\n"
        "import distributed_lms_raft_llm_tpu_torch.config\n"
        "import distributed_lms_raft_llm_tpu_torch.engine.scoring\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.guards\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.timeline\n"
        "import distributed_lms_raft_llm_tpu_torch.raft\n"
        "import distributed_lms_raft_llm_tpu_torch.raft.grpc_transport\n"
        "import distributed_lms_raft_llm_tpu_torch.lms.service\n"
        "import distributed_lms_raft_llm_tpu_torch.lms.tutoring_pool\n"
        "import distributed_lms_raft_llm_tpu_torch.serving.lms_server\n"
        "import distributed_lms_raft_llm_tpu_torch.client.client\n"
        "import distributed_lms_raft_llm_tpu_torch.lms.group_router\n"
        "import distributed_lms_raft_llm_tpu_torch.client.cli\n"
        "import distributed_lms_raft_llm_tpu_torch.client.gui\n"
        "import distributed_lms_raft_llm_tpu_torch.serving.lms_cluster\n"
        "import distributed_lms_raft_llm_tpu_torch.train\n"
        "import distributed_lms_raft_llm_tpu_torch.train.train\n"
        "import distributed_lms_raft_llm_tpu_torch.train.data\n"
        "import distributed_lms_raft_llm_tpu_torch.train.checkpoint\n"
        "import distributed_lms_raft_llm_tpu_torch.sim\n"
        "import distributed_lms_raft_llm_tpu_torch.sim.__main__\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.scrape\n"
        "import distributed_lms_raft_llm_tpu_torch.utils.locks\n"
        "import distributed_lms_raft_llm_tpu_torch.parallel\n"
        "import distributed_lms_raft_llm_tpu_torch.engine.program_inventory\n"
        "import distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory\n"
        "import distributed_lms_raft_llm_tpu_torch.tools.gen_metrics_table\n"
        "import distributed_lms_raft_llm_tpu_torch.tools.trace_report\n"
        "import distributed_lms_raft_llm_tpu_torch.tools.telemetry\n"
        "from distributed_lms_raft_llm_tpu_torch.tools import "
        "gen_program_inventory as g\n"
        "g.shipped_domains()\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("ops.attention", "ops.quant_matmul", "models.quant",
                   "models.bert", "models.llama", "models.moe", "engine.gate",
                   "engine.paged", "engine.batcher", "utils.tracing",
                   "utils.healthz", "utils.metrics_registry",
                   "serving.tutoring_server", "config", "engine.scoring",
                   "utils.guards", "utils.timeline", "raft", "raft.core",
                   "raft.storage", "raft.grpc_transport", "lms.node",
                   "lms.service", "lms.tutoring_pool", "lms.persistence",
                   "serving.lms_server", "client.client", "utils.faults",
                   "utils.diskfaults", "utils.pdf", "lms.group_router",
                   "client.cli", "client.gui", "serving.lms_cluster",
                   "train", "train.train", "train.data", "train.checkpoint",
                   "parallel", "parallel.mesh", "parallel.partition",
                   "parallel.spmd"):
        assert f"distributed_lms_raft_llm_tpu_torch.{module}" in mods
    jax_mods = [m for m in mods if m == "jax" or m.startswith("jax.")]
    ref_mods = [m for m in mods if m == "distributed_lms_raft_llm_tpu"
                or m.startswith("distributed_lms_raft_llm_tpu.")]
    assert jax_mods == [] and ref_mods == []
