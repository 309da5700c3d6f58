"""The port's Llama family against the JAX package (CPU, float32).

Both packages hold the same weights: a JAX init exported to numpy and
carried across with `convert.params_from_jax`. Two shapes: `llama-tiny`
(4 query heads over 2 KV heads, head dim 8) and a GQA-4 config (4 query
heads over one KV head, head dim 16). The forward runs in its four modes
(full sequence; a scalar cache offset, prefill then single-token steps;
per-row offsets with `cache.rows` and `write_mask`, the fused admission
chunk; a T = 9 verify window) in float32, with int8 weights and with an
int8 KV cache. The port's fused routes take the kernel's plain versions on
the CPU; JAX runs its XLA einsums, and its Pallas decode kernel in
interpret mode where the JAX engine fuses attention.

Tolerances: logits within atol 1e-5 (the JAX tests' float32 tolerance;
both sides compute in float32 and differ by summation order and by a last
bit of RoPE's float32 cos/sin); int8 cache planes equal, their scales
within 1e-6 relative. Engines: greedy tokens byte-equal.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.models import llama as jax_llama
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu.utils import tokenizer as jax_tokenizer
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.models import common as port_common
from distributed_lms_raft_llm_tpu_torch.models import (
    convert,
    llama,
    quant,
    registry,
)
from distributed_lms_raft_llm_tpu_torch.utils import tokenizer as port_tok

ATOL = 1e-5

_jax_forward = jax.jit(jax_llama.forward, static_argnums=(1,))

# name -> JAX LlamaConfig factory keyword arguments (float32 throughout)
CONFIGS = {
    "tiny": dict(),
    # GQA 4 at head dim 16: groups as Llama-3-8B's (32 over 8)
    "gqa4": dict(hidden_size=64, num_heads=4, num_kv_heads=1,
                 intermediate_size=96),
}
VARIANTS = ("float32", "int8_weights", "int8_kv")


def _jax_cfg(name, **kw):
    base = dict(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    if name == "tiny":
        return jax_llama.LlamaConfig.tiny(**base)
    return jax_llama.LlamaConfig(
        vocab_size=384, max_position_embeddings=64, num_layers=2,
        rope_theta=10000.0, **CONFIGS[name], **base)


def _port_cfg(jcfg, **kw):
    fields = {f.name for f in dataclasses.fields(llama.LlamaConfig)}
    same = {k: getattr(jcfg, k) for k in fields
            if k not in ("dtype", "param_dtype", "fused_decode_attention",
                         "quant_kv", "tensor_parallel", "sequence_parallel")}
    return llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                             **same, **kw)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    """(JAX config, JAX params, port config, port params) of one shape."""
    jcfg = _jax_cfg(request.param)
    jparams = jax_llama.init_params(jax.random.key(3), jcfg)
    pparams = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, _port_cfg(jcfg), pparams


def _variant(models, variant, fused=False):
    """The pair's configs and params in one variant: int8 weights (the JAX
    quantizer's tree, carried across) or an int8 KV cache."""
    jcfg, jparams, pcfg, pparams = models
    if variant == "int8_weights":
        jparams = jax_quant.quantize_params(jparams, "llama")
        pparams = convert.params_from_jax(jax.device_get(jparams),
                                          device="cpu")
    quant_kv = variant == "int8_kv"
    return (dataclasses.replace(jcfg, quant_kv=quant_kv), jparams,
            dataclasses.replace(pcfg, quant_kv=quant_kv,
                                fused_decode_attention=fused), pparams)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = jax_attention.pl.pallas_call
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _close(port_logits, jax_logits):
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(jax_logits),
                               atol=ATOL, rtol=0)


def _same_cache(pcache, jcache, slots=None):
    """The caches' values (at `slots` of the slot axis, default all):
    float planes within ATOL, int8 planes exactly, scales within 1e-6
    relative."""
    for name in ("k", "v", "ks", "vs"):
        p, j = getattr(pcache, name), getattr(jcache, name)
        if p is None:
            assert j is None
            continue
        p, j = p.numpy(), np.asarray(j)
        if slots is not None:
            p, j = p[:, :, :, slots], j[:, :, :, slots]
        if p.dtype == np.int8:
            np.testing.assert_array_equal(p, j)
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)


# ------------------------------------------------------------ the pieces


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 5)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        want = jax_llama.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = llama.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                         theta)
        # float32 cos/sin of positions up to 8k: an ulp of the angle
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)
    # position 0 is the identity, the norm of each pair is kept
    zero = llama.rope(torch.from_numpy(x), torch.zeros((2, 5), dtype=torch.long),
                      500000.0)
    np.testing.assert_array_equal(zero.numpy(), x)


def test_rms_norm_and_repeat_kv_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = port_common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    bf = port_common.rms_norm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(scale), 1e-5)
    assert bf.dtype == torch.bfloat16
    kv = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    for reps in (1, 4):
        np.testing.assert_array_equal(
            port_common.repeat_kv(torch.from_numpy(kv), reps).numpy(),
            np.asarray(jax_common.repeat_kv(jnp.asarray(kv), reps)))
    scales = rng.standard_normal((2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_common.repeat_kv(torch.from_numpy(scales), 4).numpy(),
        np.repeat(scales, 4, axis=1))


def test_registry_resolves_llama_at_full_width():
    family, cfg = registry.resolve("llama3-8b", torch.bfloat16)
    assert family is registry.LLAMA_FAMILY and family.name == "llama"
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size,
            cfg.vocab_size, cfg.max_position_embeddings, cfg.rope_theta,
            cfg.rms_norm_eps) == (32, 4096, 32, 8, 128, 14336, 128256, 8192,
                                  500000.0, 1e-5)
    assert cfg == llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                              param_dtype=torch.bfloat16)
    ref = jax_llama.LlamaConfig.llama3_8b()
    for f in ("num_layers", "hidden_size", "num_heads", "num_kv_heads",
              "intermediate_size", "vocab_size", "max_position_embeddings",
              "rope_theta", "rms_norm_eps"):
        assert getattr(cfg, f) == getattr(ref, f), f
    _, tiny = registry.resolve("llama-tiny", torch.float32)
    assert (tiny.hidden_size, tiny.num_heads, tiny.num_kv_heads,
            tiny.vocab_size) == (32, 4, 2, 384)


def test_init_params_shapes_dtypes_and_seed():
    cfg = llama.LlamaConfig.tiny(param_dtype=torch.bfloat16)
    a = llama.init_params(cfg, seed=5, device="cpu")
    b = llama.init_params(cfg, seed=5, device="cpu")
    jcfg = jax_llama.LlamaConfig.tiny()
    shapes = jax.tree_util.tree_map(lambda x: x.shape, jax.eval_shape(
        functools.partial(jax_llama.init_params, cfg=jcfg),
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
    assert 0.015 < a["blocks"]["mlp"]["wd"].float().std() < 0.025
    assert not torch.equal(a["blocks"]["attn"]["wq"][0],
                           a["blocks"]["attn"]["wq"][1])


def test_quantized_tree_equals_the_jax_quantizer(models):
    jcfg, jparams, _, pparams = models
    jq = jax.device_get(jax_quant.quantize_params(jparams, "llama"))
    pq = quant.quantize_params(pparams, "llama")
    for path in (("embed",), ("lm_head",), ("blocks", "attn", "wk"),
                 ("blocks", "mlp", "wd")):
        j, p = jq, pq
        for k in path:
            j, p = j[k], p[k]
        np.testing.assert_array_equal(p["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(p["s"].numpy(), np.asarray(j["s"]))
    assert pq["embed"]["s"].shape == (jcfg.vocab_size,)  # per-row
    assert not quant.is_quantized(pq["blocks"]["ln1"]["scale"])


# -------------------------------------------------------- the four modes


@pytest.mark.parametrize("variant", VARIANTS)
def test_full_sequence_matches_jax(models, variant):
    jcfg, jparams, pcfg, pparams = _variant(models, variant)
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 17))
    want, _ = _jax_forward(jparams, jcfg, jnp.asarray(ids))
    got, cache = llama.forward(pparams, pcfg, torch.from_numpy(ids))
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 17, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_then_steps_match_jax(models, variant, port_fused):
    """A scalar offset (the bucketed engine): prefill 7 tokens, then
    single-token steps; the port's fused steps take the kernel's plain
    version (GQA by head index), JAX its einsums over repeated KV heads."""
    jcfg, jparams, pcfg, pparams = _variant(models, variant, port_fused)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 11))
    jcache = jax_llama.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    pcache = llama.init_cache(pcfg, 2, 16, device="cpu")
    assert pcache.k.shape == (jcfg.num_layers, 2, jcfg.num_kv_heads, 16,
                              jcfg.head_dim)
    for lo, hi in ((0, 7), (7, 8), (8, 9), (9, 10), (10, 11)):
        want, jcache = _jax_forward(jparams, jcfg,
                                    jnp.asarray(ids[:, lo:hi]), cache=jcache)
        got, pcache = llama.forward(pparams, pcfg,
                                    torch.from_numpy(ids[:, lo:hi]),
                                    cache=pcache)
        _close(got, want)
    assert pcache.length == int(jcache.length) == 11
    _same_cache(pcache, jcache)


def test_fused_steps_match_the_jax_pallas_kernel(models, pallas_interpret):
    """The JAX forward's fused decode step (its Pallas kernel, interpret
    mode, a float cache) against the port's fused step."""
    jcfg, jparams, pcfg, pparams = models
    jcfg_f = dataclasses.replace(jcfg, fused_decode_attention=True)
    pcfg_f = dataclasses.replace(pcfg, fused_decode_attention=True)
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 9))
    jcache = jax_llama.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    pcache = llama.init_cache(pcfg, 2, 16, device="cpu")
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        want, jcache = _jax_forward(jparams, jcfg_f,
                                    jnp.asarray(ids[:, lo:hi]), cache=jcache)
        got, pcache = llama.forward(pparams, pcfg_f,
                                    torch.from_numpy(ids[:, lo:hi]),
                                    cache=pcache)
        _close(got, want)


def _ragged_caches(jcfg, quant_kv, seed, offsets, width=24):
    """A JAX and a port cache of len(offsets) rows holding the same numpy
    values, with per-row offsets."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, len(offsets), jcfg.num_kv_heads, width,
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


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("t", [1, 9])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ragged_offsets_and_window_match_jax(models, variant, t, port_fused):
    """Per-row offsets (the paged engine): T = 1, the decode step (fused:
    the append kernel's plain version, which writes the row itself), and
    T = 9, the speculative verify window (fused: the window's plain
    version, each row at its own causal frontier). Logits and the caches
    afterwards agree with JAX's ragged scatter and einsums."""
    jcfg, jparams, pcfg, pparams = _variant(models, variant, port_fused)
    offsets = [3, 0, 11, 7]
    jcache, pcache = _ragged_caches(jcfg, variant == "int8_kv", 40 + t,
                                    offsets)
    ids = np.random.default_rng(41 + t).integers(0, jcfg.vocab_size, (4, t))
    want, jnew = _jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jcache)
    got, pnew = llama.forward(pparams, pcfg, torch.from_numpy(ids),
                              cache=pcache)
    _close(got, want)
    np.testing.assert_array_equal(pnew.lengths.numpy(),
                                  np.asarray(jnew.length))
    _same_cache(pnew, jnew)


@pytest.mark.parametrize("variant", VARIANTS)
def test_admission_chunk_rows_and_write_mask_match_jax(models, variant):
    """The fused admission chunk: batch row 0 prefills cache row 2 of 4
    (`cache.rows`) at its cursor 5, six tokens of which the last two are
    pad past the prompt's 9 (`write_mask` drops them), pad positions
    clamped to the last real one. JAX, as its `_admission_chunk`, runs the
    slot's pages alone at a ragged offset. The real positions' logits and
    the slot's real cache rows agree; nothing else in the port's cache
    moves."""
    jcfg, jparams, pcfg, pparams = _variant(models, variant)
    quant_kv = variant == "int8_kv"
    slot, cur, c, true_len = 2, 5, 6, 9
    jfull, pcache = _ragged_caches(jcfg, quant_kv, 50, [4, 1, cur, 2])
    before = {n: getattr(pcache, n).clone() for n in ("k", "v", "ks", "vs")
              if getattr(pcache, n) is not None}

    def row(x):
        return None if x is None else x[:, slot:slot + 1]

    jcache = jax_common.KVCache(k=row(jfull.k), v=row(jfull.v),
                                length=jnp.asarray([cur], jnp.int32),
                                ks=row(jfull.ks), vs=row(jfull.vs))
    ids = np.random.default_rng(51).integers(0, jcfg.vocab_size, (1, c))
    positions = np.minimum(cur + np.arange(c), true_len - 1)[None]
    want, jnew = _jax_forward(jparams, jcfg, jnp.asarray(ids), cache=jcache,
                              positions=jnp.asarray(positions, jnp.int32))
    pcache = dataclasses.replace(
        pcache, lengths=torch.tensor([cur], dtype=torch.int32),
        rows=torch.tensor([slot]))
    write = torch.from_numpy(cur + np.arange(c) < true_len)[None]
    got, pnew = llama.forward(pparams, pcfg, torch.from_numpy(ids),
                              cache=pcache,
                              positions=torch.from_numpy(positions).long(),
                              write_mask=write)
    real = true_len - cur
    _close(got[:, :real], want[:, :real])
    assert int(pnew.lengths[0]) == cur + c

    class Row:  # the port's written row, beside JAX's
        pass

    mine = Row()
    for n in ("k", "v", "ks", "vs"):
        x = getattr(pnew, n)
        setattr(mine, n, None if x is None else x[:, slot:slot + 1])
    _same_cache(mine, jnew, slots=slice(cur, true_len))
    for n, old in before.items():
        now = getattr(pnew, n)
        keep = torch.ones(now.shape[:4], dtype=torch.bool)
        keep[:, slot, :, cur:true_len] = False
        assert torch.equal(now[keep], old[keep]), n


def test_cache_overflow_and_mode_checks(models):
    _, _, pcfg, pparams = models
    cache = llama.init_cache(pcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cache overflow"):
        llama.forward(pparams, pcfg, torch.zeros((1, 5), dtype=torch.long),
                      cache=cache)
    cache = llama.init_cache(pcfg, 1, 8, device="cpu", quantized=True)
    with pytest.raises(ValueError, match="quant_kv"):
        llama.forward(pparams, pcfg, torch.zeros((1, 1), dtype=torch.long),
                      cache=cache)


def test_decode_step_feeds_the_append_kernel_alike_strided_k_and_v(
        models, monkeypatch):
    """The paged decode step's k and v reach `decode_attention_append` as
    views with the same strides (the kernel reads both with one pair; its
    check is not relaxed for RoPE's fresh k), launched as a programmatic
    dependent; q with a contiguous head dim."""
    from distributed_lms_raft_llm_tpu_torch.ops import attention

    _, _, pcfg, pparams = _variant(models, "int8_kv", fused=True)
    seen = []
    orig = attention.decode_attention_append

    def spy(q, k_new, v_new, *args, **kwargs):
        seen.append((q.stride(), k_new.stride(), v_new.stride(),
                     kwargs["dependent"]))
        return orig(q, k_new, v_new, *args, **kwargs)

    monkeypatch.setattr(attention, "decode_attention_append", spy)
    _, pcache = _ragged_caches(pcfg, True, 60, [3, 0, 5, 1])
    llama.forward(pparams, pcfg, torch.zeros((4, 1), dtype=torch.long),
                  cache=pcache)
    assert len(seen) == pcfg.num_layers
    for q_st, k_st, v_st, dependent in seen:
        assert k_st == v_st and k_st[3] == 1 and q_st[3] == 1 and dependent


# ---------------------------------------------------------- conversion


def _hf_state_dict(jcfg, seed):
    """An HF LlamaForCausalLM state dict of numpy arrays ([out, in]
    linears) at the config's shape."""
    rng = np.random.default_rng(seed)
    d, m, kvd = (jcfg.hidden_size, jcfg.intermediate_size,
                 jcfg.num_kv_heads * jcfg.head_dim)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(jcfg.vocab_size, d),
          "model.norm.weight": w(d), "lm_head.weight": w(jcfg.vocab_size, d)}
    for i in range(jcfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w(d),
            p + "post_attention_layernorm.weight": w(d),
            p + "self_attn.q_proj.weight": w(d, d),
            p + "self_attn.k_proj.weight": w(kvd, d),
            p + "self_attn.v_proj.weight": w(kvd, d),
            p + "self_attn.o_proj.weight": w(d, d),
            p + "mlp.gate_proj.weight": w(m, d),
            p + "mlp.up_proj.weight": w(m, d),
            p + "mlp.down_proj.weight": w(d, m),
        })
    return sd


@pytest.mark.parametrize("tied", [False, True])
def test_llama_params_from_hf_match_the_jax_converter(models, tied):
    jcfg, _, pcfg, _ = models
    sd = _hf_state_dict(jcfg, 7)
    if tied:
        del sd["lm_head.weight"]
    want = jax_convert.llama_params_from_hf(sd, jcfg)
    got = convert.llama_params_from_hf(sd, pcfg, device="cpu")

    def walk(p, j):
        if isinstance(p, dict):
            assert set(p) == set(j)
            for k in p:
                walk(p[k], j[k])
            return
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))

    walk(got, want)
    hf = {"vocab_size": 384, "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 1,
          "intermediate_size": 96, "max_position_embeddings": 64,
          "rope_theta": 10000.0, "rms_norm_eps": 1e-5}
    p = convert.llama_config_from_hf(hf, dtype=torch.float32)
    j = jax_convert.llama_config_from_hf(hf)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "intermediate_size", "rope_theta"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.head_dim == 16


def test_logits_match_hf_transformers():
    """tests/test_llama_golden.py's tiny HF config (GQA 2, untied head):
    the HF model's weights through `llama_params_from_hf`, logits within
    that test's 1e-4 (float32 here, float64 there)."""
    transformers = pytest.importorskip("transformers")
    from test_llama_golden import HF_CFG

    hf_cfg = transformers.LlamaConfig(**HF_CFG)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = convert.llama_config_from_hf(hf_cfg.to_dict(), dtype=torch.float32,
                                       param_dtype=torch.float32)
    params = convert.llama_params_from_hf(hf_model.state_dict(), cfg,
                                          device="cpu")
    ids = torch.tensor([[3, 77, 140, 9, 201, 55, 18, 4]])
    got, _ = llama.forward(params, cfg, ids)
    with torch.no_grad():
        want = hf_model(ids).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------- engines

MAX_NEW = 8
PROMPTS = ["what is raft?", "hello world", "explain paging", "k",
           "a longer question about logs"]


def _greedy(**kw):
    return JaxSampling.greedy(max_new_tokens=MAX_NEW, **kw)


def _port_config(**kw):
    kw.setdefault("length_buckets", (16,))
    return EngineConfig(model="llama-tiny", batch_buckets=(1, 2, 4),
                        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW),
                        dtype=torch.float32, param_dtype=torch.float32,
                        device="cpu", **kw)


def _jax_config(**kw):
    kw.setdefault("length_buckets", (16,))
    return JaxConfig(model="llama-tiny", batch_buckets=(1, 2, 4),
                     sampling=_greedy(), dtype=jnp.float32,
                     param_dtype=jnp.float32, **kw)


def _carry(eng, jeng):
    eng.params = convert.params_from_jax(jax.device_get(jeng.params),
                                         device="cpu")
    return eng


# (JAX options, port options) of the bucketed engine: JAX's fused decode
# (its Pallas kernel, interpret mode) takes no int8 cache and no spec.
BUCKETED = {
    "fused": (dict(fused_attention=True), dict(fused_attention=True)),
    "int8": (dict(quant="int8", kv_quant=True),
             dict(quant="int8", kv_quant=True, fused_attention=True)),
    "spec3": (dict(spec_tokens=3), dict(spec_tokens=3,
                                        fused_attention=True)),
    "int8_spec8": (dict(quant="int8", kv_quant=True, spec_tokens=8),
                   dict(quant="int8", kv_quant=True, spec_tokens=8,
                        fused_attention=False)),
}


@pytest.mark.parametrize("mode", sorted(BUCKETED))
def test_bucketed_engine_greedy_byte_equal_to_jax(mode, pallas_interpret):
    jopts, popts = BUCKETED[mode]
    devices = jax.devices()[:1] if jopts.get("fused_attention") else None
    jeng = JaxEngine(_jax_config(**jopts), devices=devices)
    eng = _carry(TutoringEngine(_port_config(**popts)), jeng)
    want = jeng.answer_batch(PROMPTS)
    got = eng.answer_batch(PROMPTS)
    assert got == want
    assert any(got)  # the tiny model answered something


PAGED = {
    "dense": dict(),
    "int8": dict(quant="int8", kv_quant=True),
    "int8_spec8": dict(quant="int8", kv_quant=True, spec_tokens=8),
}


@pytest.mark.parametrize("mode", sorted(PAGED))
def test_paged_engine_greedy_byte_equal_to_jax(mode):
    """The paged engines, more prompts than slots; the port fuses
    attention (the append, window and admission routes' plain versions)
    and, on the int8 spec-8 mode, runs the deployment's options: megastep,
    fused admission chunks, the prefix cache."""
    opts = dict(length_buckets=(8, 16), **PAGED[mode])
    kw = dict(slots=3)
    if mode == "int8_spec8":
        kw.update(megastep=2, megastep_max=4, prefill_chunk_tokens=4,
                  prefix_cache=True)
    jeng = JaxPaged(_jax_config(**opts), **kw)
    rids = [jeng.submit(p) for p in PROMPTS]
    out = jeng.drain()
    want = [out[r] for r in rids]
    eng = _carry(PagedEngine(_port_config(fused_attention=True, **opts),
                             **kw), jeng)
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.drain()
    assert [out[r] for r in rids] == want
    assert eng.state.cache.k.shape[2] == eng.cfg.num_kv_heads


def test_scores_match_the_jax_engines():
    """The scoring tenant's log-likelihoods (a full-sequence forward over
    right-padded texts) against the JAX engines' on the same weights, the
    scoring tests' float32 tolerance (rtol 1e-5, atol 1e-4)."""
    texts = ["raft logs", "leaders replicate the log", "a", "quorum " * 9]
    kw = dict(length_buckets=(16, 32), scoring=True)
    for quant_mode in (None, "int8"):
        jeng = JaxEngine(_jax_config(quant=quant_mode, **kw))
        eng = _carry(TutoringEngine(_port_config(quant=quant_mode, **kw)),
                     jeng)
        want, got = jeng.score(texts), eng.score(texts)
        for w, g in zip(want, got):
            assert g["tokens"] == w["tokens"]
            assert g["truncated"] == w["truncated"]
            np.testing.assert_allclose(g["logprob"], w["logprob"],
                                       rtol=1e-5, atol=1e-4)


def test_llama_checkpoint_without_tokenizer_json_raises(tmp_path):
    """Both engines refuse a Llama checkpoint served with byte/GPT-2 ids,
    before reading it (the JAX TutoringEngine's rule)."""
    path = str(tmp_path / "missing.safetensors")
    for cls in (TutoringEngine, PagedEngine):
        with pytest.raises(ValueError, match="tokenizer_json"):
            cls(_port_config(checkpoint=path))
    with pytest.raises(ValueError, match="tokenizer_json"):
        JaxEngine(_jax_config(checkpoint=path))


def test_tokenizer_vocab_and_budget_checks(tmp_path):
    big = _write_tokenizer(tmp_path, extra=400)  # 657 ids > 384
    for cls in (TutoringEngine, PagedEngine):
        with pytest.raises(ValueError, match="exceeds model vocab"):
            cls(_port_config(tokenizer_json=big))
    with pytest.raises(ValueError, match="max_new_tokens"):
        TutoringEngine(dataclasses.replace(
            _port_config(), model="llama3-8b",
            sampling=SamplingParams.greedy(max_new_tokens=8192)))


# ------------------------------------------------------------ tokenizer


def _write_tokenizer(tmp_path, extra=0):
    """A byte-level BPE tokenizer.json of the 256 byte symbols, a few
    merges, `extra` filler tokens and an end-of-text special."""
    tokenizers = pytest.importorskip("tokenizers")
    enc = port_tok._bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    merges = [("r", "a"), ("ra", "f"), ("raf", "t"), ("Ġ", "l")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    for i in range(extra):
        vocab[f"<filler_{i}>"] = len(vocab)
    model = tokenizers.models.BPE(vocab=vocab, merges=merges)
    tok = tokenizers.Tokenizer(model)
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    tok.add_special_tokens(["<|end_of_text|>"])
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    json.loads(path.read_text())  # a valid tokenizer.json
    return str(path)


def test_hf_tokenizer_round_trips_and_matches_jax(tmp_path):
    path = _write_tokenizer(tmp_path)
    tok = port_tok.load_gpt2_tokenizer(tokenizer_json=path)
    ref = jax_tokenizer.load_gpt2_tokenizer(tokenizer_json=path)
    assert isinstance(tok, port_tok.HFTokenizer)
    text = "raft leaders log é"
    ids = tok.encode(text)
    assert ids == ref.encode(text) and tok.decode(ids) == text
    assert ids[0] == tok._vocab["raft"]
    assert (tok.eos_id, tok.pad_id, tok.vocab_size) == (
        ref.eos_id, ref.pad_id, ref.vocab_size)
    assert tok.eos_id == tok._vocab["<|end_of_text|>"]
    assert tok.decode(ids + [tok.eos_id]) == text
    # the cut tail of a two-byte character is held back
    assert tok.decode_complete(ids[:-1]) == "raft leaders log "


def test_engines_serve_with_a_tokenizer_json(tmp_path):
    path = _write_tokenizer(tmp_path)
    eng = TutoringEngine(_port_config(tokenizer_json=path))
    assert isinstance(eng.tokenizer, port_tok.HFTokenizer)
    assert len(eng.answer_batch(["raft"])) == 1
    paged = PagedEngine(_port_config(tokenizer_json=path), slots=2)
    rid = paged.submit("raft")
    assert isinstance(paged.drain()[rid], str)
