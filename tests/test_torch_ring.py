"""Ring attention and sequence-parallel scoring in the port: gloo ranks on
the CPU, held against the JAX package's ring path (its 8-virtual-device
mesh) on the same inputs and JAX-initialised weights.

Two rank pools start once for the module (`tests/torch_tp_ranks.py`): two
ranks (sp 2) and four (sp 4, and sp 2 x tp 2). Held here:

- `parallel.ring.ring_attention` against dense causal `attend` (the JAX
  package's) at sp 2 and 4 and at sp 2 x tp 2 (heads over tp), within
  atol/rtol 2e-5 (tests/test_ring_attention.py's);
- the GPT-2 and Llama ring forwards (the models at tests/
  test_model_parallel.py's sizes, Llama's 8 query heads over 4 KV heads)
  and moe-tiny's (its expert layer routing the gathered sequence) against
  the JAX ring forwards at sp 4, and GPT-2's at sp 2 x tp 2,
  within atol 2e-4 (that file's bound between ring and dense), equal on
  every rank of an sp line; a padding mask and explicit positions refused
  with the JAX package's message;
- the engine's scoring at sp 2 against the JAX `tiny_tutoring(sp=2)` of
  tests/test_scoring.py, truncation included: equal token counts and
  flags, log probabilities within rtol 1e-5 / atol 1e-4, and the same
  warmed shapes as the JAX derivation (with dp 1: a port engine's ranks
  are tp x ep x sp);
- the paged engine refuses sp with the JAX engine's message.
"""

import dataclasses

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
from distributed_lms_raft_llm_tpu.engine import scoring as jax_scoring
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import llama as jax_llama
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.models.common import attend as jax_attend
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu_torch.engine import EngineConfig
from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams
from distributed_lms_raft_llm_tpu_torch.engine import TutoringEngine
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax

# ring_attention against dense attention (tests/test_ring_attention.py's).
ATTN_TOL = 2e-5
# A ring forward against JAX's (tests/test_model_parallel.py's bound).
FORWARD_ATOL = 2e-4
# Scores against JAX's ring scores: float32 sums in another order.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-4
LONG_TEXT = " ".join(["leader election term"] * 40)  # > 32 tokens
TEXTS = ["the leader replicates logs", LONG_TEXT]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by world size, started on first use."""
    made = {}

    def get(world):
        if world not in made:
            made[world] = Ranks(world, tmp_path_factory.mktemp(
                f"sp_rendezvous_{world}"))
        return made[world]

    yield get
    for ranks in made.values():
        ranks.close()


def _dense_causal(q, k, v):
    t = q.shape[2]
    pos = jnp.arange(t)
    mask = (pos[None, :] <= pos[:, None])[None, None]
    return np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mask))


@pytest.mark.parametrize("world,sp", [(2, 2), (4, 4), (4, 2)],
                         ids=["sp2", "sp4", "sp2_tp2"])
def test_ring_attention_matches_dense_causal(pools, world, sp):
    rng = np.random.default_rng(0)
    b, h, t, dh = 2, 4, 32, 16
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    want = _dense_causal(q, k, v)
    tp = world // sp
    got = np.zeros_like(want)
    hh, tt = h // tp, t // sp
    for out in pools(world).run("ring", q=q, k=k, v=v, sp=sp):
        got[:, out["tp"] * hh:(out["tp"] + 1) * hh,
            out["sp"] * tt:(out["sp"] + 1) * tt] = out["out"]
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


GPT2_KW = dict(hidden_size=64, num_layers=4, num_heads=8, vocab_size=512,
               max_position_embeddings=64)
LLAMA_KW = dict(hidden_size=64, num_layers=3, num_heads=8, num_kv_heads=4,
                intermediate_size=128)
MODELS = {
    "gpt2": ("tiny", jax_gpt2, jax_gpt2.GPT2Config(
        dtype=jnp.float32, param_dtype=jnp.float32), GPT2_KW, 0),
    "llama": ("llama-tiny", jax_llama, jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, param_dtype=jnp.float32), LLAMA_KW, 1),
    # The expert layer routes the whole sequence: each rank gathers it.
    "moe": ("moe-tiny", jax_moe, jax_moe.GPT2MoEConfig.tiny(
        dtype=jnp.float32, param_dtype=jnp.float32), {}, 2),
}


def _jax_ring(module, cfg, params, ids, sizes):
    mesh = jax_mesh.make_mesh(dict(sizes, dp=-1), devices=jax.devices()[:8])
    ring_cfg = dataclasses.replace(cfg, ring_mesh=mesh)
    with mesh:
        return np.asarray(jax.jit(
            lambda p, i: module.forward(p, ring_cfg, i)[0])(params, ids))


@pytest.mark.parametrize("name,world,sp", [
    ("gpt2", 4, 4), ("llama", 4, 4), ("gpt2", 4, 2), ("moe", 4, 4)],
    ids=["gpt2_sp4", "llama_sp4", "gpt2_sp2_tp2", "moe_sp4"])
def test_ring_forward_matches_jax_ring_forward(pools, name, world, sp):
    preset, module, base, kw, seed = MODELS[name]
    cfg = dataclasses.replace(base, **kw)
    params = module.init_params(jax.random.key(seed), cfg)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 32))
    sizes = {"sp": sp, "tp": world // sp}
    want = _jax_ring(module, cfg, params, jnp.asarray(ids, jnp.int32), sizes)
    tree = params_from_jax(jax.device_get(params), device="cpu")
    got = pools(world).run("ring_forward", model=preset, tree=tree, ids=ids,
                           cfg_kw=kw, sp=sp)
    for out in got:
        assert out["local_t"] == ids.shape[1] // sp
        np.testing.assert_array_equal(out["logits"], got[0]["logits"])
        np.testing.assert_allclose(out["logits"], want, rtol=0,
                                   atol=FORWARD_ATOL)
        assert len(out["errors"]) == 2
        for message in out["errors"]:
            assert "supports full causal sequences only" in message
    ring_cfg = dataclasses.replace(cfg, ring_mesh=jax_mesh.make_mesh(
        {"sp": 4, "dp": -1}))
    with pytest.raises(ValueError, match="supports full causal sequences"):
        module.forward(params, ring_cfg, jnp.ones((2, 16), jnp.int32),
                       kv_mask=jnp.ones((2, 16), bool))


def _jax_tutoring(**kw):
    """tests/test_scoring.py's tiny_tutoring."""
    return JaxEngine(JaxConfig(
        model="tiny", sampling=JaxSampling(max_new_tokens=4),
        length_buckets=(16, 32), batch_buckets=(1, 2), dtype=jnp.float32,
        param_dtype=jnp.float32, **kw))


def test_scoring_at_sp2_matches_jax_ring_scores(pools):
    jeng = _jax_tutoring(sp=2)
    want = jeng.score(TEXTS)
    tree = params_from_jax(jax.device_get(jeng.params), device="cpu")
    config_kw = dict(sp=2, max_new=4, length_buckets=(16, 32),
                     batch_buckets=(1, 2), scoring=True)
    got = pools(2).run("score", model="tiny", tree=tree, texts=TEXTS,
                       config_kw=config_kw)
    for rank in got:
        assert [s["tokens"] for s in rank["scores"]] == [
            w["tokens"] for w in want]
        assert [s["truncated"] for s in rank["scores"]] == [False, True]
        np.testing.assert_allclose(
            [s["logprob"] for s in rank["scores"]],
            [w["logprob"] for w in want], rtol=SCORE_RTOL, atol=SCORE_ATOL)
        assert rank["shapes"] == jax_scoring.derive_score_shapes(
            (16, 32), (1, 2), jeng.cfg.max_position_embeddings, sp=2, dp=1)
    # The port at sp 1 on the same weights, in this process.
    port = TutoringEngine(EngineConfig(
        model="tiny", device="cpu", dtype=torch.float32,
        param_dtype=torch.float32, sampling=SamplingParams(max_new_tokens=4),
        length_buckets=(16, 32), batch_buckets=(1, 2)))
    port.params = tree
    dense = port.score(TEXTS)
    np.testing.assert_allclose(
        [s["logprob"] for s in got[0]["scores"]],
        [d["logprob"] for d in dense], rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_paged_engine_refuses_sp_as_jax_does():
    with pytest.raises(ValueError) as jax_err:
        JaxPaged(JaxConfig(model="tiny", sp=2))
    with pytest.raises(ValueError) as err:
        PagedEngine(EngineConfig(model="tiny", sp=2, device="cpu"))
    assert str(err.value) == str(jax_err.value)
