"""The port's GPT-2-MoE family and the expert kernel's wrapper against the
JAX package (CPU, float32), and the larger GPT-2 presets.

Both packages hold the same weights: a JAX init exported to numpy and
carried across with `convert.params_from_jax`. `moe_mlp` is held against
the JAX layer on `tests/test_moe.py::TestMoELayer`'s cases (no drops at
k = 1 and 2, drops routed to zero, C = 1 with slot-major priority, the aux
scalar) and on a planted top-k tie; the forward in its four modes (full
sequence; prefill then steps; per-row offsets; the admission chunk's rows)
in float32, with int8 weights and with an int8 KV cache; both engines'
greedy answers at `moe-tiny` (the preset's capacity factor 1.25, drops
active) and their scores; the expert kernel's launch plan and wrapper.
The larger GPT-2 presets: logits and the int8 tree at each width, cut to
2 layers.

Tolerances: logits within atol 1e-5 (both sides float32; they differ by
the expert products' summation order, `torch.bmm` against XLA's einsum);
`moe_mlp` within 1e-6 of JAX (the dispatch and combine are exact, see
`models/moe.py`); the brute-force float64 reference within the JAX
tests' 2e-4; int8 trees and cache planes equal; engines byte-equal.
"""

import ast
import dataclasses
import functools
import inspect
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from test_moe import _brute_force

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.engine import generate as jax_generate
from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu.models import registry as jax_registry
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
    TutoringEngine,
    spec,
)
from distributed_lms_raft_llm_tpu_torch.engine.generate import decode, prefill
from distributed_lms_raft_llm_tpu_torch.models import common as port_common
from distributed_lms_raft_llm_tpu_torch.models import (
    convert,
    gpt2,
    moe,
    quant,
    registry,
)
from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

ATOL = 1e-5
MLP_ATOL = 1e-6

_jax_forward = jax.jit(jax_moe.forward, static_argnums=(1,))
VARIANTS = ("float32", "int8_weights", "int8_kv")


def _port_cfg(jcfg, **kw):
    fields = {f.name for f in dataclasses.fields(moe.GPT2MoEConfig)}
    same = {k: getattr(jcfg, k) for k in fields
            if k not in ("dtype", "param_dtype", "fused_decode_attention",
                         "quant_kv", "tensor_parallel", "expert_parallel",
                         "sequence_parallel")}
    return moe.GPT2MoEConfig(dtype=torch.float32, param_dtype=torch.float32,
                             **same, **kw)


def _tree(jparams):
    return convert.params_from_jax(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params) at moe-tiny."""
    jcfg = jax_moe.GPT2MoEConfig.tiny()
    jparams = jax_moe.init_params(jax.random.key(0), jcfg)
    return jcfg, jparams, _port_cfg(jcfg), _tree(jparams)


def _variant(models, variant, fused=False):
    jcfg, jparams, pcfg, pparams = models
    if variant == "int8_weights":
        jparams = jax_quant.quantize_params(jparams, "gpt2_moe")
        pparams = _tree(jparams)
    quant_kv = variant == "int8_kv"
    return (dataclasses.replace(jcfg, quant_kv=quant_kv), jparams,
            dataclasses.replace(pcfg, quant_kv=quant_kv,
                                fused_decode_attention=fused), pparams)


def _jax_layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])


def _mlp_pair(jcfg, jmp, h, **kw):
    """JAX's and the port's moe_mlp on the same layer and rows."""
    pcfg = _port_cfg(jcfg)
    pmp = {k: convert.params_from_jax(jax.device_get(v), device="cpu")
           if isinstance(v, dict)
           else torch.from_numpy(np.array(v)) for k, v in jmp.items()}
    want = jax_moe.moe_mlp(jnp.asarray(h), jmp, jcfg, **kw)
    got = moe.moe_mlp(torch.from_numpy(h), pmp, pcfg, **kw)
    return got, want, pmp


def _close(port_logits, jax_logits, atol=ATOL):
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(jax_logits),
                               atol=atol, rtol=0)


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_matches_jax_without_drops(k):
    jcfg = jax_moe.GPT2MoEConfig.tiny(capacity_factor=100.0,
                                      experts_per_token=k)
    jmp = _jax_layer0(jax_moe.init_params(jax.random.key(0), jcfg))
    h = np.random.default_rng(1).standard_normal(
        (2, 5, jcfg.hidden_size)).astype(np.float32)
    got, want, _ = _mlp_pair(jcfg, jmp, h)
    _close(got, want, MLP_ATOL)
    ref = _brute_force(h.reshape(-1, jcfg.hidden_size), jmp, jcfg)
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref,
                               atol=2e-4)


@pytest.mark.parametrize("variant", ["float32", "int8_weights"])
def test_capacity_drops_route_to_zero_as_in_jax(variant):
    """C = 1: at most E capacity slots carry tokens; every dropped token's
    output is exactly 0, the same rows as JAX's."""
    jcfg = jax_moe.GPT2MoEConfig.tiny(capacity_factor=1e-9)
    jparams = jax_moe.init_params(jax.random.key(0), jcfg)
    if variant == "int8_weights":
        jparams = jax_quant.quantize_params(jparams, "gpt2_moe")
    jmp = _jax_layer0(jparams)
    h = np.random.default_rng(2).standard_normal(
        (4, 8, jcfg.hidden_size)).astype(np.float32)
    assert moe.capacity(_port_cfg(jcfg), 32) == 1
    got, want, _ = _mlp_pair(jcfg, jmp, h)
    _close(got, want, MLP_ATOL)
    rows = got.reshape(-1, jcfg.hidden_size)
    nonzero = int((rows.abs() > 0).any(dim=1).sum())
    assert 0 < nonzero <= jcfg.num_experts
    np.testing.assert_array_equal(
        (rows.abs() > 0).any(dim=1).numpy(),
        np.any(np.abs(np.asarray(want).reshape(rows.shape)) > 0, axis=1))


def test_slot_priority_is_first_choice_first():
    """The JAX test's crafted collision at capacity 1: both tokens keep
    their first choice, both second picks drop (an inverted priority
    would hand each its second choice)."""
    jcfg = jax_moe.GPT2MoEConfig.tiny(capacity_factor=1e-9)
    jmp = dict(_jax_layer0(jax_moe.init_params(jax.random.key(0), jcfg)))
    d, e = jcfg.hidden_size, jcfg.num_experts
    wr = np.full((d, e), -30.0, np.float32)
    wr[0, 0], wr[0, 1] = 3.0, 2.0
    wr[1, 1], wr[1, 0] = 3.0, 2.0
    jmp["wr"] = jnp.asarray(wr)
    h = np.zeros((1, 2, d), np.float32)
    h[0, 0, 0] = 1.0
    h[0, 1, 1] = 1.0
    got, want, pmp = _mlp_pair(jcfg, jmp, h)
    _close(got, want, MLP_ATOL)
    w1 = float(np.exp(3.0) / (np.exp(3.0) + np.exp(2.0)))

    def expert(x, idx):
        v = x @ pmp["wi"][idx].double() + pmp["bi"][idx].double()
        g = 0.5 * v * (1 + torch.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))
        return g @ pmp["wo"][idx].double() + pmp["bo"][idx].double()

    x = torch.from_numpy(h[0]).double()
    np.testing.assert_allclose(got[0, 0].numpy(), w1 * expert(x[0], 0),
                               atol=2e-4)
    np.testing.assert_allclose(got[0, 1].numpy(), w1 * expert(x[1], 1),
                               atol=2e-4)


def test_aux_scalar_and_load_balance_loss_match_jax(models):
    jcfg, jparams, pcfg, pparams = models
    h = np.random.default_rng(4).standard_normal(
        (2, 8, jcfg.hidden_size)).astype(np.float32)
    (got, aux), (want, jaux), _ = _mlp_pair(jcfg, _jax_layer0(jparams), h,
                                            return_aux=True)
    _close(got, want, MLP_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    for layer in (0, 1):
        loss = moe.load_balance_loss(pparams, pcfg, torch.from_numpy(h),
                                     layer)
        jloss = jax_moe.load_balance_loss(jparams, jcfg, jnp.asarray(h),
                                          layer)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        assert 0.9 <= float(loss) <= jcfg.num_experts + 1e-3


def test_planted_top_k_tie_takes_the_lower_expert_first():
    """Equal router probabilities: the port's top-k orders them as
    `jax.lax.top_k` does (lower index first), so the same experts win
    the same capacity slots."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    w, i = moe.top_k(probs, 2)
    jw, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert i.tolist() == [[1, 2], [0, 1], [0, 2]]
    # through the layer: a token whose router ties experts 1, 2 and 3, at
    # capacity 1 (the tie decides which expert's slot it takes)
    jcfg = jax_moe.GPT2MoEConfig.tiny(capacity_factor=1e-9,
                                      experts_per_token=1)
    jmp = dict(_jax_layer0(jax_moe.init_params(jax.random.key(0), jcfg)))
    d, e = jcfg.hidden_size, jcfg.num_experts
    wr = np.zeros((d, e), np.float32)
    wr[0, 1:] = 2.0
    jmp["wr"] = jnp.asarray(wr)
    h = np.zeros((1, 3, d), np.float32)
    h[0, :, 0] = 1.0
    got, want, _ = _mlp_pair(jcfg, jmp, h)
    _close(got, want, MLP_ATOL)
    assert bool((got[0, 0] != 0).any()) and bool((got[0, 1:] == 0).all())


# ---------------------------------------------------- the quantized tree


def test_quantized_tree_equals_the_jax_quantizer(models):
    _, jparams, _, pparams = models
    jq = jax.device_get(jax_quant.quantize_params(jparams, "gpt2_moe"))
    pq = quant.quantize_params(pparams, "gpt2_moe")
    for path in (("wte",), ("blocks", "attn", "wqkv"),
                 ("blocks", "attn", "wo"), ("blocks", "moe", "wi"),
                 ("blocks", "moe", "wo")):
        j, p = jq, pq
        for k in path:
            j, p = j[k], p[k]
        np.testing.assert_array_equal(p["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(p["s"].numpy(), np.asarray(j["s"]))
    wi = pq["blocks"]["moe"]["wi"]
    assert wi["q"].shape == (2, 4, 32, 128) and wi["s"].shape == (2, 4, 128)
    assert pq["blocks"]["moe"]["wo"]["s"].shape == (2, 4, 32)
    assert not quant.is_quantized(pq["blocks"]["moe"]["wr"])


def test_init_params_shapes_dtypes_and_seed():
    cfg = moe.GPT2MoEConfig.tiny(param_dtype=torch.bfloat16)
    a = moe.init_params(cfg, seed=5, device="cpu")
    b = moe.init_params(cfg, seed=5, device="cpu")
    shapes = jax.tree_util.tree_map(lambda x: x.shape, jax.eval_shape(
        functools.partial(jax_moe.init_params,
                          cfg=jax_moe.GPT2MoEConfig.tiny()),
        jax.random.key(0)))

    def walk(p, s, q):
        if isinstance(p, dict):
            assert set(p) == set(s)
            for k in p:
                walk(p[k], s[k], q[k])
            return
        assert tuple(p.shape) == tuple(s) and p.dtype == torch.bfloat16
        assert torch.equal(p, q)

    walk(a, shapes, b)
    wi = a["blocks"]["moe"]["wi"].float()
    assert 0.015 < wi.std() < 0.025
    assert not torch.equal(wi[0, 0], wi[0, 1])  # experts differ
    assert not torch.equal(wi[0], wi[1])        # layers differ


# -------------------------------------------------------- the four modes


@pytest.mark.parametrize("variant", VARIANTS)
def test_full_sequence_matches_jax(models, variant):
    jcfg, jparams, pcfg, pparams = _variant(models, variant)
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 17))
    want, _ = _jax_forward(jparams, jcfg, jnp.asarray(ids))
    got, cache = moe.forward(pparams, pcfg, torch.from_numpy(ids))
    assert cache is None and got.shape == (2, 17, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_then_steps_match_jax(models, variant, port_fused):
    jcfg, jparams, pcfg, pparams = _variant(models, variant, port_fused)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 11))
    jcache = jax_moe.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    pcache = moe.init_cache(pcfg, 2, 16, device="cpu")
    for lo, hi in ((0, 7), (7, 8), (8, 9), (9, 10), (10, 11)):
        want, jcache = _jax_forward(jparams, jcfg,
                                    jnp.asarray(ids[:, lo:hi]), cache=jcache)
        got, pcache = moe.forward(pparams, pcfg,
                                  torch.from_numpy(ids[:, lo:hi]),
                                  cache=pcache)
        _close(got, want)
    assert pcache.length == int(jcache.length) == 11


def _ragged_caches(jcfg, quant_kv, seed, offsets, width=24):
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, len(offsets), jcfg.num_heads, width,
             jcfg.head_dim)
    if quant_kv:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    offsets = np.asarray(offsets, np.int32)
    jcache = jax_common.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(offsets),
        ks=None if ks is None else jnp.asarray(ks),
        vs=None if vs is None else jnp.asarray(vs))

    def t(x):
        return None if x is None else torch.from_numpy(x.copy())

    pcache = port_common.KVCache(k=t(k), v=t(v), ks=t(ks), vs=t(vs),
                                 lengths=torch.from_numpy(offsets))
    return jcache, pcache


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ragged_offsets_match_jax(models, variant, t):
    """Per-row offsets (the paged engine's decode step at T = 1, fused: the
    append kernel's plain version; a verify window at T = 4)."""
    jcfg, jparams, pcfg, pparams = _variant(models, variant, fused=True)
    jcache, pcache = _ragged_caches(jcfg, variant == "int8_kv", 40 + t,
                                    [3, 0, 11, 7])
    ids = np.random.default_rng(41 + t).integers(0, jcfg.vocab_size, (4, t))
    want, jnew = _jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jcache)
    got, pnew = moe.forward(pparams, pcfg, torch.from_numpy(ids),
                            cache=pcache)
    _close(got, want)
    np.testing.assert_array_equal(pnew.lengths.numpy(),
                                  np.asarray(jnew.length))


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("variant", VARIANTS)
def test_admission_chunk_rows_match_jax(models, variant, cf):
    """The fused admission chunk: batch row 0 prefills cache row 2 of 4 at
    its cursor 5, six tokens of which the last two are pad past the
    prompt's 9. The chunk's six rows (pad tail included) share the
    expert capacity, in the port as in JAX's `_admission_chunk`: the pad
    rows write and attend their own keys there (the engine's write mask
    drops only writes past the width), so the real rows' logits agree at
    moe-tiny's capacity and at 0.25, where drops decide them."""
    jcfg, jparams, pcfg, pparams = _variant(models, variant)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    pcfg = dataclasses.replace(pcfg, capacity_factor=cf)
    slot, cur, c, true_len = 2, 5, 6, 9
    jfull, pcache = _ragged_caches(jcfg, variant == "int8_kv", 50,
                                   [4, 1, cur, 2])

    def row(x):
        return None if x is None else x[:, slot:slot + 1]

    jcache = jax_common.KVCache(k=row(jfull.k), v=row(jfull.v),
                                length=jnp.asarray([cur], jnp.int32),
                                ks=row(jfull.ks), vs=row(jfull.vs))
    ids = np.random.default_rng(51).integers(0, jcfg.vocab_size, (1, c))
    positions = np.minimum(cur + np.arange(c), true_len - 1)[None]
    want, _ = _jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jcache,
                           positions=jnp.asarray(positions, jnp.int32))
    pcache = dataclasses.replace(
        pcache, lengths=torch.tensor([cur], dtype=torch.int32),
        rows=torch.tensor([slot]))
    write = torch.ones((1, c), dtype=torch.bool)  # all inside the width
    got, _ = moe.forward(pparams, pcfg, torch.from_numpy(ids), cache=pcache,
                         positions=torch.from_numpy(positions).long(),
                         write_mask=write)
    _close(got[:, :true_len - cur], want[:, :true_len - cur])


# ------------------------------------------------------------ conversion


def _native(jparams):
    """The native slash-joined layout of a JAX tree, as numpy."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                out["/".join(path + (key,))] = np.asarray(value)

    walk(jax.device_get(jparams), ())
    return out


def test_params_from_hf_reads_the_native_layout(models):
    jcfg, jparams, pcfg, _ = models
    sd = _native(jparams)
    want = jax_moe.params_from_hf(sd, jcfg)
    got = moe.params_from_hf(sd, pcfg, device="cpu")

    def walk(p, j):
        if isinstance(p, dict):
            assert set(p) == set(j)
            for k in p:
                walk(p[k], j[k])
            return
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))

    walk(got, want)
    ids = torch.tensor([[5, 9, 200, 3]])
    _close(moe.forward(got, pcfg, ids)[0],
           _jax_forward(want, jcfg, jnp.asarray(ids.numpy()))[0])
    bf = moe.params_from_hf(sd, moe.GPT2MoEConfig.tiny(
        param_dtype=torch.bfloat16), device="cpu")
    assert bf["blocks"]["moe"]["wi"].dtype == torch.bfloat16


def test_params_from_hf_keeps_the_jax_errors(models):
    jcfg, jparams, pcfg, _ = models
    hf_like = {"wte.weight": np.zeros((4, 4), np.float32)}
    for load in (lambda sd: jax_moe.params_from_hf(sd, jcfg),
                 lambda sd: moe.params_from_hf(sd, pcfg, device="cpu")):
        with pytest.raises(ValueError, match="looks like an HF state dict"):
            load(hf_like)
    dense = {k: v for k, v in _native(jparams).items()
             if not k.startswith("blocks/moe/")}
    for load in (lambda sd: jax_moe.params_from_hf(sd, jcfg),
                 lambda sd: moe.params_from_hf(sd, pcfg, device="cpu")):
        with pytest.raises(ValueError, match=r"missing \['blocks/moe'\]"):
            load(dense)


def test_registry_serves_every_jax_preset():
    """Every preset of the JAX registry resolves in the port, to the same
    family and the same configuration fields."""
    assert sorted(registry.PRESETS) == sorted(jax_registry.PRESETS)
    assert sorted(registry.PRESETS) == sorted([
        "gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl", "tiny", "llama3-8b",
        "llama-tiny", "gpt2-moe", "moe-tiny"])
    for name, (jfamily, jfactory) in jax_registry.PRESETS.items():
        family, cfg = registry.resolve(name, torch.bfloat16)
        assert family.name == jfamily.name, name
        jcfg = jfactory()
        for f in dataclasses.fields(jcfg):
            if hasattr(cfg, f.name) and f.name not in (
                    "dtype", "param_dtype", "fused_decode_attention",
                    "quant_kv"):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (
                    name, f.name)
    family, cfg = registry.resolve("gpt2-moe", torch.bfloat16)
    assert family is registry.MOE_FAMILY
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_experts,
            cfg.experts_per_token, cfg.capacity_factor, cfg.mlp_dim) == (
                12, 768, 8, 2, 1.25, 3072)


# ---------------------------------------------------- the larger GPT-2s

GPT2_WIDTHS = ("gpt2-medium", "gpt2-large", "gpt2-xl")


@pytest.mark.parametrize("preset", GPT2_WIDTHS)
def test_larger_gpt2_presets_match_jax_at_two_layers(preset):
    """Each larger GPT-2 at its published width and heads, cut to 2 layers
    (and a 384-id vocabulary, 64 positions): full-sequence logits in
    float32 and with int8 weights, the int8 tree equal to JAX's."""
    cut = dict(num_layers=2, vocab_size=384, max_position_embeddings=64)
    _, factory = jax_registry.PRESETS[preset]
    jcfg = dataclasses.replace(factory(dtype=jnp.float32,
                                       param_dtype=jnp.float32), **cut)
    _, pcfg = registry.resolve(preset, torch.float32)
    pcfg = dataclasses.replace(pcfg, **cut)
    assert (pcfg.hidden_size, pcfg.num_heads) == (jcfg.hidden_size,
                                                  jcfg.num_heads)
    jparams = jax_gpt2.init_params(jax.random.key(7), jcfg)
    ids = np.random.default_rng(8).integers(0, 384, (2, 9))
    fwd = jax.jit(jax_gpt2.forward, static_argnums=(1,))
    got, _ = gpt2.forward(_tree(jparams), pcfg, torch.from_numpy(ids))
    _close(got, fwd(jparams, jcfg, jnp.asarray(ids))[0])
    jq = jax_quant.quantize_params(jparams, "gpt2")
    pq = quant.quantize_params(_tree(jparams), "gpt2")
    for path in (("wte",), ("blocks", "attn", "wqkv"),
                 ("blocks", "mlp", "wo")):
        j, p = jax.device_get(jq), pq
        for k in path:
            j, p = j[k], p[k]
        np.testing.assert_array_equal(p["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(p["s"].numpy(), np.asarray(j["s"]))
    got, _ = gpt2.forward(_tree(jq), pcfg, torch.from_numpy(ids))
    _close(got, fwd(jq, jcfg, jnp.asarray(ids))[0])


# --------------------------------------------------------------- engines

MAX_NEW = 8
PROMPTS = ["what is raft?", "hello world", "explain paging", "k",
           "a longer question about logs"]


def _port_config(**kw):
    kw.setdefault("length_buckets", (16,))
    kw.setdefault("batch_buckets", (1, 2, 4))
    kw.setdefault("model", "moe-tiny")
    return EngineConfig(sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", **kw)


def _jax_config(**kw):
    kw.setdefault("length_buckets", (16,))
    kw.setdefault("batch_buckets", (1, 2, 4))
    kw.setdefault("model", "moe-tiny")
    return JaxConfig(sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW),
                     dtype=jnp.float32, param_dtype=jnp.float32, **kw)


def _carry(eng, jeng):
    eng.params = _tree(jeng.params)
    return eng


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = jax_attention.pl.pallas_call
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


# (JAX options, port options) of the bucketed engine: JAX's fused decode
# (its Pallas kernel, interpret mode) takes no int8 cache.
BUCKETED = {
    "plain": (dict(), dict(fused_attention=False)),
    "fused": (dict(fused_attention=True), dict(fused_attention=True)),
    "int8": (dict(quant="int8", kv_quant=True),
             dict(quant="int8", kv_quant=True, fused_attention=True)),
}


@pytest.mark.parametrize("mode", sorted(BUCKETED))
def test_bucketed_engine_greedy_byte_equal_to_jax(mode, pallas_interpret):
    """moe-tiny at its capacity factor 1.25 (drops active): the bucketed
    engines put the same rows into each forward (the batch bucket's filler
    rows included), so the answers are byte-equal."""
    jopts, popts = BUCKETED[mode]
    devices = jax.devices()[:1] if jopts.get("fused_attention") else None
    jeng = JaxEngine(_jax_config(**jopts), devices=devices)
    eng = _carry(TutoringEngine(_port_config(**popts)), jeng)
    assert eng.cfg.capacity_factor == 1.25
    want = jeng.answer_batch(PROMPTS)
    got = eng.answer_batch(PROMPTS)
    assert got == want
    assert any(got)


DEPLOYMENT = dict(megastep=2, megastep_max=4, prefill_chunk_tokens=4,
                  prefix_cache=True)
PAGED = {
    "dense": (dict(), dict()),
    "int8": (dict(quant="int8", kv_quant=True), dict()),
    "int8_deployment": (dict(quant="int8", kv_quant=True), DEPLOYMENT),
    # capacity 0.25: drops in most forwards, so every row's content counts
    "int8_deployment_cf0.25": (dict(quant="int8", kv_quant=True,
                                    model="moe-tiny-cf0.25"), DEPLOYMENT),
}


@pytest.mark.parametrize("mode", sorted(PAGED))
def test_paged_engine_greedy_byte_equal_to_jax(mode, monkeypatch):
    """The paged engines, more prompts than slots, capacity 1.25 (and
    0.25): dead slots feed their pad token at their clamped offset, the
    fused admission chunk writes and attends its pad tail, and a fresh or
    grown state's pages are zeros, in both, so the rows competing for
    capacity are the same; the port fuses attention (the append and
    admission routes' plain versions)."""
    monkeypatch.setitem(jax_registry.PRESETS, "moe-tiny-cf0.25", (
        jax_registry.MOE_FAMILY, functools.partial(
            jax_moe.GPT2MoEConfig.tiny, capacity_factor=0.25)))
    monkeypatch.setitem(registry.PRESETS, "moe-tiny-cf0.25", (
        registry.MOE_FAMILY, functools.partial(
            moe.GPT2MoEConfig.tiny, capacity_factor=0.25)))
    opts, kw = PAGED[mode]
    opts = dict(length_buckets=(8, 16), **opts)
    kw = dict(slots=3, **kw)
    jeng = JaxPaged(_jax_config(**opts), **kw)
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    want = [out[r] for r in rids]
    eng = _carry(PagedEngine(_port_config(fused_attention=True, **opts),
                             **kw), jeng)
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.drain()
    assert [out[r] for r in rids] == want
    assert any(want)


def test_scores_match_the_jax_engines():
    """Log-likelihoods through both engines (capacity 1.25, the batch's
    pad rows sharing capacity as in JAX), dense and int8, the scoring
    tests' float32 tolerance (rtol 1e-5, atol 1e-4)."""
    texts = ["raft logs", "leaders replicate the log", "a", "quorum " * 9]
    kw = dict(length_buckets=(16, 32), scoring=True)
    for quant_mode in (None, "int8"):
        jeng = JaxEngine(_jax_config(quant=quant_mode, **kw))
        want = jeng.score(texts)
        for cls in (TutoringEngine, PagedEngine):
            eng = _carry(cls(_port_config(quant=quant_mode, **kw)), jeng)
            got = eng.score(texts)
            for w, g in zip(want, got):
                assert g["tokens"] == w["tokens"]
                assert g["truncated"] == w["truncated"]
                np.testing.assert_allclose(g["logprob"], w["logprob"],
                                           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ["bucketed", "paged"])
def test_capacity_makes_answers_depend_on_companions_as_in_jax(
        engine, monkeypatch):
    """The capacity caveat, a property of the model and not of the port:
    with drops (cf 0.25 here, where the tiny model shows it) a prompt
    answered alone and the same prompt answered beside others may get
    different greedy answers, in JAX and in the port alike (byte-equal to
    each other both ways); without drops (cf = E) they may not. A serving
    run whose requests meet other companions (a second wave landing at
    another step, prefix hits shortening admission) can answer
    differently on either package."""
    answers = {}
    for cf in (0.25, 4.0):
        name = f"moe-tiny-cf{cf}"
        monkeypatch.setitem(jax_registry.PRESETS, name, (
            jax_registry.MOE_FAMILY, functools.partial(
                jax_moe.GPT2MoEConfig.tiny, capacity_factor=cf)))
        monkeypatch.setitem(registry.PRESETS, name, (
            registry.MOE_FAMILY, functools.partial(
                moe.GPT2MoEConfig.tiny, capacity_factor=cf)))
        if engine == "bucketed":
            jeng = JaxEngine(_jax_config(model=name,
                                         batch_buckets=(1, 2, 4, 8)))
            eng = _carry(TutoringEngine(_port_config(
                model=name, batch_buckets=(1, 2, 4, 8))), jeng)

            def runs(e):
                return ([e.answer_batch([p])[0] for p in PROMPTS],
                        e.answer_batch(PROMPTS))
        else:
            jeng = JaxPaged(_jax_config(model=name), slots=3)
            eng = _carry(PagedEngine(_port_config(model=name,
                                                  fused_attention=True),
                                     slots=3), jeng)

            def runs(e):
                alone = []
                for p in PROMPTS:
                    rid = e.submit(p)
                    alone.append(e.drain()[rid])
                rids = [e.submit(p) for p in PROMPTS]
                out = e.drain()
                return alone, [out[r] for r in rids]

        got, want = runs(eng), runs(jeng)
        assert got == want
        answers[cf] = got
    alone, batched = answers[0.25]
    assert alone != batched
    alone, batched = answers[4.0]
    assert alone == batched


def test_spec_without_drops_is_token_equal_to_plain_decode():
    """At cf >= E nothing drops, each token's output is its own, and the
    port's `decode_spec` emits its plain decode's greedy tokens (the JAX
    test's case, and JAX's tokens)."""
    jcfg = jax_moe.GPT2MoEConfig.tiny(capacity_factor=4.0)
    jparams = jax_moe.init_params(jax.random.key(0), jcfg)
    pcfg = _port_cfg(jcfg)
    params = _tree(jparams)
    family = registry.MOE_FAMILY
    ids = np.array(jax.random.randint(jax.random.key(7), (2, 8), 1,
                                      jcfg.vocab_size))
    mask = np.ones((2, 8), bool)
    sp = SamplingParams.greedy(max_new_tokens=12)

    def run(k):
        state = prefill(params, pcfg, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask), torch.Generator(), sp, 0, 0,
                        model=family)
        if k == 0:
            return decode(params, state, pcfg, sp, 0, 0, model=family)[0]
        return spec.decode_spec(params, state, torch.from_numpy(ids).long(),
                                pcfg, sp, 0, 0, model=family,
                                spec_tokens=k)[0]

    plain, spec3 = run(0), run(3)
    np.testing.assert_array_equal(spec3.tokens.numpy(), plain.tokens.numpy())
    jsp = JaxSampling.greedy(max_new_tokens=12)
    st = jax_generate.prefill(jparams, jcfg, jnp.asarray(ids),
                              jnp.asarray(mask), jax.random.key(1), jsp, 0,
                              0, model=jax_registry.MOE_FAMILY)
    want, _ = jax_generate.decode(jparams, st, jcfg, jsp, 0, 0,
                                  model=jax_registry.MOE_FAMILY)
    np.testing.assert_array_equal(plain.tokens.numpy(),
                                  np.asarray(want.tokens))


@pytest.mark.parametrize("cls", [TutoringEngine, PagedEngine])
def test_engines_refuse_spec_with_drops_and_ep(cls):
    """Spec at cf < E raises the JAX engines' ValueError in both port
    engines (fused attention, the port's recorded difference, does not
    lift it); `ep` is ported and runs one process a rank, so without a
    process group of its ranks it is refused (tests/test_torch_ep.py runs
    it)."""
    with pytest.raises(ValueError, match="capacity_factor >= num_experts"):
        cls(_port_config(spec_tokens=4, fused_attention=True))
    with pytest.raises(ValueError, match="capacity_factor"):
        JaxEngine(_jax_config(spec_tokens=4))
    with pytest.raises(RuntimeError, match="ep=2"):
        cls(_port_config(ep=2))


def test_quantized_engine_serves_the_expert_pairs():
    eng = TutoringEngine(_port_config(quant="int8", kv_quant=True))
    wi = eng.params["blocks"]["moe"]["wi"]
    assert quant.is_quantized(wi) and wi["q"].dtype == torch.int8
    assert wi["s"].shape == (2, 4, 128)
    assert len(eng.answer_batch(["hello"])) == 1


# --------------------------------------- the expert kernel's launch plan


def test_expert_plans_count_every_expert_in_the_wave():
    """gpt2-moe's two expert products at its four row counts (C = 5:
    decode at 16 slots; 10: a 32-token admission chunk; 80: a 256-token
    prefill; 640: a scoring quantum of 8 x 256): grid y holds E x the
    row tiles of C, the K split fills the wave with all of them, shared
    memory fits."""
    cases = {
        # (C, K, N): (mt, grid, splits, k_split)
        (5, 768, 3072): (1, (24, 8, 1), 1, 768),
        (5, 3072, 768): (1, (6, 8, 4), 4, 768),
        (10, 3072, 768): (1, (6, 8, 4), 4, 768),
        (80, 768, 3072): (4, (24, 16, 1), 1, 768),
        (80, 3072, 768): (4, (6, 16, 4), 4, 768),
        (640, 768, 3072): (4, (24, 80, 1), 1, 768),
        (640, 3072, 768): (4, (6, 80, 4), 4, 768),
    }
    for (c, k, n), want in cases.items():
        plan = quant_matmul.launch_plan(c, k, n, False, experts=8)
        assert (plan.mt, plan.grid, plan.splits, plan.k_split) == want, (
            c, k, n, plan)
        assert plan.smem_bytes <= quant_matmul.SMEM_LIMIT
        assert plan.smem_bytes == quant_matmul._smem_bytes(
            False, plan.mt, plan.k_split, plan.stages, plan.x_staged)
        one = quant_matmul.launch_plan(c, k, n, False)
        assert plan.grid[1] == 8 * one.grid[1]
    # the wave: wo at C = 5 alone would split 8 ways (6 x 1 x 8 = 48
    # blocks); its 8 experts fill 192 blocks at 4 splits
    assert quant_matmul.launch_plan(5, 3072, 768, False).splits == 8


@pytest.mark.parametrize("m", [1, 5, 16, 17, 32, 256, 2048])
@pytest.mark.parametrize("k,n,transposed", [
    (768, 2304, False), (768, 3072, False), (3072, 768, False),
    (768, 50257, True), (4096, 14336, False), (14336, 4096, False),
    (4096, 128256, True)])
def test_one_expert_plans_are_the_dense_plans(m, k, n, transposed):
    """experts = 1 (the default) plans exactly what the dense products
    planned: the GPT-2 and Llama instantiations are unchanged (their plans
    are pinned in tests/test_torch_quant.py)."""
    assert quant_matmul.launch_plan(m, k, n, transposed, experts=1) == \
        quant_matmul.launch_plan(m, k, n, transposed)


def test_expert_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="no expert batch"):
        quant_matmul.launch_plan(5, 768, 50257, True, experts=8)
    with pytest.raises(ValueError, match="empty product"):
        quant_matmul.launch_plan(5, 768, 768, False, experts=0)
    with pytest.raises(ValueError, match="65535"):
        quant_matmul.launch_plan(16, 768, 768, False, experts=65536)


# --------------------------------------------- the expert kernel's wrapper


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's
    dispatch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, x)


def _expert_inputs(e=3, c=5, k=32, n=48, seed=30):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (e, k, n), np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, (e, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((e, n)).astype(np.float32))
    return x, q, s, b


@pytest.mark.parametrize("with_bias", [False, True])
def test_experts_cpu_takes_the_plain_version(with_bias):
    """On the CPU: the plain version, which is JAX's `expert_dense` plus
    the bias, and each expert's `int8_matmul` product."""
    x, q, s, b = _expert_inputs()
    b = b if with_bias else None
    got = quant_matmul.int8_matmul_experts(x, q, s, b)
    assert got.shape == (3, 5, 48) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, quant_matmul.int8_matmul_experts_reference(x, q, s, b),
        rtol=0, atol=0)
    for i in range(3):
        torch.testing.assert_close(got[i], quant_matmul.int8_matmul(
            x[i], q[i], s[i], None if b is None else b[i]),
            rtol=1e-6, atol=1e-6)
    jy = jnp.einsum("ecd,edm->ecm", jnp.asarray(x.numpy()),
                    jnp.asarray(q.numpy()).astype(jnp.float32))
    jy = jy * jnp.asarray(s.numpy())[:, None, :]
    if b is not None:
        jy = jy + jnp.asarray(b.numpy())[:, None, :]
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_experts_cuda_tensors_launch_one_kernel(monkeypatch):
    """CUDA tensors: one launch for all experts, with the expert count and
    C in the argument struct, counted in all and on the expert route of
    x's dtype (float32: the CUDA cores; bf16: the tensor cores with the
    expert plan); the plain version is never taken."""
    calls = []

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    def fake_launch(*args):
        calls.append((quant_matmul._Args.from_address(args[0]),) + args[1:])
        return 0

    monkeypatch.setattr(quant_matmul, "int8_matmul_experts_reference",
                        no_plain)
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (fake_launch, lambda index: 0))
    x, q, s, b = _expert_inputs()
    before = dict(quant_matmul.launch_counts)
    out = quant_matmul.int8_matmul_experts(*map(_fake_cuda, (x, q, s, b)))
    assert out.shape == (3, 5, 48) and out.dtype == torch.float32
    out = quant_matmul.int8_matmul_experts(
        *map(_fake_cuda, (x.bfloat16(), q, s, b.bfloat16())))
    assert out.shape == (3, 5, 48) and out.dtype == torch.bfloat16
    out = quant_matmul.int8_matmul_experts(
        *map(_fake_cuda, (x.bfloat16(), q, s)))
    counts = quant_matmul.launch_counts
    assert {name: counts[name] - before[name] for name in counts} == {
        quant_matmul.KERNEL: 3, quant_matmul.FMA: 0, quant_matmul.MMA: 0,
        quant_matmul.MMA_UNEMBED: 0, quant_matmul.FMA_EXPERTS: 1,
        quant_matmul.MMA_EXPERTS: 2, quant_matmul.WGMMA: 0,
        quant_matmul.WGMMA_UNEMBED: 0, quant_matmul.WGMMA_EXPERTS: 0}
    assert [(a.M, a.N, a.K, a.transposed, a.dtype, a.experts)
            for a, *_ in calls] == [(5, 48, 32, 0, 0, 3), (5, 48, 32, 0, 1, 3),
                                    (5, 48, 32, 0, 1, 3)]
    assert calls[1][4] is not None and calls[2][4] is None
    plan = quant_matmul.launch_plan(5, 32, 48, False, experts=3)
    a = calls[1][0]
    assert (a.mt, a.splits, a.k_split, a.stages, a.grid_x, a.smem,
            a.x_staged) == (plan.mt, plan.splits, plan.k_split, plan.stages,
                            plan.grid[0], plan.smem_bytes,
                            int(plan.x_staged))
    assert calls[0][0].smem == 0  # the CUDA-core route plans in csrc
    # the dense layout's struct carries no experts
    quant_matmul.int8_matmul(*map(_fake_cuda, (x[0], q[0], s[0])))
    assert calls[-1][0].experts == 0


def test_experts_refuse_what_they_cannot_take(monkeypatch):
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (lambda *a: 0, lambda index: 0))
    x, q, s, b = _expert_inputs()
    run = quant_matmul.int8_matmul_experts
    with pytest.raises(ValueError, match=r"\[E, K, N\]"):
        run(x, q[0], s, b)
    with pytest.raises(ValueError, match="does not match"):
        run(x[:2], q, s, b)
    with pytest.raises(ValueError, match="does not match"):
        run(x[..., :16], q, s, b)
    with pytest.raises(ValueError, match=r"s must be \[3, 48\]"):
        run(x, q, s[0], b)
    with pytest.raises(ValueError, match=r"b must be \[3, 48\]"):
        run(x, q, s, b[:, :8])
    with pytest.raises(ValueError, match="several devices"):
        run(_fake_cuda(x), q, s, b)
    xo, qo, so, _ = _expert_inputs(k=24)
    with pytest.raises(ValueError, match="multiples of 16"):
        run(*map(_fake_cuda, (xo, qo, so)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        run(*map(_fake_cuda, (x.double(), q, s)))
    with pytest.raises(ValueError, match="contiguous"):
        run(*map(_fake_cuda, (x, q.transpose(1, 2).contiguous()
                              .transpose(1, 2), s)))


def test_experts_dispatch_is_static():
    """No try/except around the launch, the plain version only under
    `device.type == "cpu"`, the count moves only beside the launch."""
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(quant_matmul.int8_matmul_experts))).body[0]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain = [ast.unparse(n.test) for n in ast.walk(tree)
             if isinstance(n, ast.If) and any(
                 isinstance(c, ast.Call)
                 and getattr(c.func, "id", "")
                 == "int8_matmul_experts_reference"
                 for c in ast.walk(n))]
    assert plain == ["device.type == 'cpu'"]
    assert "launch_counts" not in inspect.getsource(
        quant_matmul.int8_matmul_experts_reference)


def test_moe_layer_launches_two_expert_products(monkeypatch):
    """On CUDA tensors the layer's expert products are two calls of the
    expert wrapper (one launch each), never a loop over experts, and the
    router stays a dense float32 product."""
    seen = []
    monkeypatch.setattr(quant_matmul, "int8_matmul_experts",
                        lambda x, q, s, b=None: seen.append(
                            (tuple(x.shape), tuple(q.shape)))
                        or quant_matmul.int8_matmul_experts_reference(
                            x, q, s, b))
    cfg = moe.GPT2MoEConfig.tiny(dtype=torch.float32,
                                 param_dtype=torch.float32)
    params = quant.quantize_params(moe.init_params(cfg, device="cpu"),
                                   "gpt2_moe")
    moe.forward(params, cfg, torch.zeros((2, 4), dtype=torch.long))
    c = moe.capacity(cfg, 8)
    assert seen == [((4, c, 32), (4, 32, 128)), ((4, c, 128), (4, 128, 32))
                    ] * cfg.num_layers
    assert not quant.is_quantized(params["blocks"]["moe"]["wr"])
