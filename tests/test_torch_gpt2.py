"""GPT-2 forward of the PyTorch port against the JAX package (CPU, f32).

Both packages hold the same weights: a JAX init exported to numpy and
carried across with `convert.params_from_jax`. The cases are those of
tests/test_models_golden.py (full sequence, prefill + single-token steps,
left-padded prefill), then the paged engine's ragged per-row offsets and
the int8 KV cache and weights. The JAX single-token steps run the Pallas decode
kernel in interpret mode; the port runs its plain paths on the CPU.
Tolerance atol=1e-5: both sides compute in float32 and differ only by
summation order.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import registry as jax_registry
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu_torch.models import common as port_common
from distributed_lms_raft_llm_tpu_torch.models import convert, gpt2, registry

ATOL = 1e-5

# Jitted once per shape: the eager op-by-op path is the slow part on CPU.
_jax_forward = jax.jit(jax_gpt2.forward, static_argnums=(1,))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jparams = jax_gpt2.init_params(jax.random.key(0), jcfg)
    pcfg = gpt2.GPT2Config.tiny(dtype=torch.float32, param_dtype=torch.float32)
    pparams = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, pcfg, pparams


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = jax_attention.pl.pallas_call
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _close(port_logits, jax_logits):
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(jax_logits),
                               atol=ATOL, rtol=0)


def test_full_sequence_matches_jax(models):
    jcfg, jparams, pcfg, pparams = models
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 17))
    want, jcache = _jax_forward(jparams, jcfg, jnp.asarray(ids))
    got, pcache = gpt2.forward(pparams, pcfg, torch.from_numpy(ids))
    assert jcache is None and pcache is None
    assert got.dtype == torch.float32 and got.shape == (2, 17, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("port_fused", [False, True])
def test_prefill_then_steps_match_jax(models, pallas_interpret, port_fused):
    """Prefill 7 tokens, then 5 single-token steps; the JAX steps go
    through the Pallas kernel (interpret mode), the port's through
    `attend` (fused off) or `decode_attention`'s plain version (fused on)."""
    jcfg, jparams, pcfg, pparams = models
    jcfg_f = dataclasses.replace(jcfg, fused_decode_attention=True)
    pcfg_f = dataclasses.replace(pcfg, fused_decode_attention=port_fused)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 12))

    jcache = jax_gpt2.init_cache(jcfg, batch=2, max_len=32,
                                 dtype=jnp.float32)
    pcache = gpt2.init_cache(pcfg, batch=2, max_len=32, device="cpu")
    want, jcache = _jax_forward(jparams, jcfg_f, jnp.asarray(ids[:, :7]),
                                cache=jcache)
    got, pcache = gpt2.forward(pparams, pcfg_f, torch.from_numpy(ids[:, :7]),
                               cache=pcache)
    _close(got, want)
    for t in range(7, 12):
        step = ids[:, t:t + 1]
        want, jcache = _jax_forward(jparams, jcfg_f, jnp.asarray(step),
                                    cache=jcache)
        got, pcache = gpt2.forward(pparams, pcfg_f, torch.from_numpy(step),
                                   cache=pcache)
        _close(got, want)
    assert pcache.length == int(jcache.length) == 12
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(jcache.k),
                               atol=ATOL, rtol=0)


def test_left_padded_prefill_matches_jax(models):
    jcfg, jparams, pcfg, pparams = models
    rng = np.random.default_rng(2)
    ids = rng.integers(1, jcfg.vocab_size, size=(1, 6))
    pad = 3
    padded = np.concatenate([np.zeros((1, pad), ids.dtype), ids], axis=1)
    positions = np.concatenate(
        [np.zeros((1, pad), np.int32), np.arange(6, dtype=np.int32)[None]],
        axis=1,
    )
    kv_mask = (np.arange(16) >= pad)[None, :]
    want, _ = _jax_forward(
        jparams, jcfg, jnp.asarray(padded),
        cache=jax_gpt2.init_cache(jcfg, 1, 16, dtype=jnp.float32),
        positions=jnp.asarray(positions), kv_mask=jnp.asarray(kv_mask),
    )
    got, _ = gpt2.forward(
        pparams, pcfg, torch.from_numpy(padded),
        cache=gpt2.init_cache(pcfg, 1, 16, device="cpu"),
        positions=torch.from_numpy(positions).long(),
        kv_mask=torch.from_numpy(kv_mask),
    )
    _close(got, want)
    # The padded rows' real positions agree with the unpadded forward.
    clean, _ = gpt2.forward(pparams, pcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got[:, pad:].numpy(), clean.numpy(),
                               atol=ATOL, rtol=0)


def test_cache_overflow_raises_instead_of_clamping(models):
    _, _, pcfg, pparams = models
    cache = gpt2.init_cache(pcfg, batch=1, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="cache overflow"):
        gpt2.forward(pparams, pcfg, torch.zeros((1, 5), dtype=torch.long),
                     cache=cache)


def test_safetensors_round_trip_from_jax_writer(models, tmp_path):
    """A file written by the JAX package's `save_safetensors` loads through
    the port's reader and `gpt2_params_from_hf` into the same weights
    `params_from_jax` carries across."""
    jcfg, jparams, pcfg, pparams = models
    path = str(tmp_path / "tiny.safetensors")
    hf_sd = jax_convert.gpt2_params_to_hf(jax.device_get(jparams))
    jax_convert.save_safetensors(path, hf_sd)
    sd = convert.load_safetensors(path)
    want_sd = jax_convert.load_safetensors(path)
    assert sorted(sd) == sorted(want_sd)
    for name in sd:
        np.testing.assert_array_equal(sd[name], want_sd[name])
    loaded = convert.gpt2_params_from_hf(sd, pcfg, device="cpu")
    flat_loaded = jax.tree_util.tree_leaves_with_path(loaded)
    flat_port = dict(jax.tree_util.tree_leaves_with_path(pparams))
    assert len(flat_loaded) == len(flat_port)
    for key, tensor in flat_loaded:
        torch.testing.assert_close(tensor, flat_port[key], rtol=0, atol=0)


def test_bf16_safetensors_and_params_from_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 8)), jnp.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    jax_convert.save_safetensors(path, {"x": np.asarray(x)})
    got = convert.load_safetensors(path)["x"]
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))
    t = convert.params_from_jax({"x": np.asarray(x)}, device="cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_hf_weights_cast_to_param_dtype(models):
    jcfg, jparams, _, _ = models
    hf_sd = jax_convert.gpt2_params_to_hf(jax.device_get(jparams))
    cfg = gpt2.GPT2Config.tiny(param_dtype=torch.bfloat16)
    params = convert.gpt2_params_from_hf(hf_sd, cfg, device="cpu")
    assert params["wte"].dtype == torch.bfloat16
    assert params["blocks"]["attn"]["wqkv"].shape == (2, 32, 96)


@pytest.mark.parametrize("preset", ["gpt2-medium", "gpt2-xl", "moe-tiny"])
def test_registry_refuses_unported_presets(preset):
    """Once refused, these presets now resolve to the JAX registry's
    widths; a name the JAX registry does not know is still refused."""
    family, cfg = registry.resolve(preset, torch.float32)
    jfamily, jfactory = jax_registry.PRESETS[preset]
    jcfg = jfactory()
    assert family.name == jfamily.name
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.vocab_size) == (jcfg.num_layers, jcfg.hidden_size,
                                jcfg.num_heads, jcfg.vocab_size)
    with pytest.raises(ValueError, match="unknown model preset"):
        registry.resolve(preset + "-unported", torch.float32)


def test_registry_gpt2_is_full_width():
    _, cfg = registry.resolve("gpt2", torch.bfloat16)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.vocab_size,
            cfg.max_position_embeddings) == (12, 768, 12, 50257, 1024)


# ---------------------------------------------- ragged per-row offsets

RAGGED_OFFSETS = [3, 0, 7, 5]


def _ragged_caches(jcfg, pcfg, quantized, seed):
    """A JAX and a port cache of 4 rows x 16 slots holding the same numpy
    values, with per-row offsets RAGGED_OFFSETS."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, 4, jcfg.num_heads, 16, jcfg.head_dim)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)
        vs = rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    offsets = np.array(RAGGED_OFFSETS, np.int32)
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
@pytest.mark.parametrize("quantized", [False, True])
def test_ragged_offsets_match_jax(models, quantized, port_fused):
    """T=1 with per-row offsets [3, 0, 7, 5] (the paged engine's decode
    step), a float or int8 cache: logits agree with JAX `forward` within
    1e-5 and the caches hold the same values afterwards (each row's new
    key/value at its own offset; int8 values exactly, their scales within
    1e-6 relative: the keys they scale come out of float32 products
    summed in another order). The port
    runs plain attention or, fused, the kernel's plain version with
    per-row lengths; JAX runs its XLA einsums."""
    jcfg, jparams, pcfg, pparams = models
    jcfg_q = dataclasses.replace(jcfg, quant_kv=quantized)
    pcfg_q = dataclasses.replace(pcfg, quant_kv=quantized,
                                 fused_decode_attention=port_fused)
    jcache, pcache = _ragged_caches(jcfg, pcfg, quantized, seed=40)
    ids = np.random.default_rng(41).integers(0, jcfg.vocab_size, (4, 1))
    want, jnew = _jax_forward(jparams, jcfg_q, jnp.asarray(ids), cache=jcache)
    got, pnew = gpt2.forward(pparams, pcfg_q, torch.from_numpy(ids),
                             cache=pcache)
    _close(got, want)
    np.testing.assert_array_equal(pnew.lengths.numpy(),
                                  np.asarray(jnew.length))
    _same_cache(pnew, jnew)


def _same_cache(pcache, jcache):
    """The caches' values: float planes within ATOL; int8 planes exactly,
    their scales within 1e-6 relative."""
    for name in ("k", "v", "ks", "vs"):
        p, j = getattr(pcache, name), getattr(jcache, name)
        if p is None:
            assert j is None
            continue
        p, j = p.numpy(), np.asarray(j)
        if p.dtype == np.int8:
            np.testing.assert_array_equal(p, j)
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)


def test_ragged_scatter_writes_each_row_at_its_offset(models):
    """Rows are written at their own slots and nowhere else: every other
    slot of the cache keeps its value."""
    jcfg, _, pcfg, pparams = models
    _, pcache = _ragged_caches(jcfg, pcfg, False, seed=42)
    before = pcache.k.clone()
    ids = torch.zeros((4, 1), dtype=torch.long)
    gpt2.forward(pparams, pcfg, ids, cache=pcache)
    changed = (pcache.k != before).any(dim=(0, 2, 4))  # [rows, slots]
    want = torch.zeros_like(changed)
    for row, off in enumerate(RAGGED_OFFSETS):
        want[row, off] = True
    assert torch.equal(changed, want)


@pytest.mark.parametrize("port_fused", [False, True])
def test_int8_cache_prefill_then_steps_match_jax(models, port_fused):
    """An int8 KV cache at a scalar offset (the bucketed engine with
    kv_quant): prefill 7 tokens, then single-token steps; the port's fused
    steps take the int8 plain version of the kernel, JAX's `attend_quant`
    (its Pallas kernel refuses an int8 cache)."""
    jcfg, jparams, pcfg, pparams = models
    jcfg_q = dataclasses.replace(jcfg, quant_kv=True)
    pcfg_q = dataclasses.replace(pcfg, quant_kv=True,
                                 fused_decode_attention=port_fused)
    ids = np.random.default_rng(43).integers(0, jcfg.vocab_size, (2, 10))
    jcache = jax_gpt2.init_cache(jcfg_q, batch=2, max_len=16)
    pcache = gpt2.init_cache(pcfg_q, batch=2, max_len=16, device="cpu")
    assert pcache.k.dtype == torch.int8 and pcache.ks.shape == (2, 2, 4, 16)
    for lo, hi in ((0, 7), (7, 8), (8, 9), (9, 10)):
        want, jcache = _jax_forward(jparams, jcfg_q, jnp.asarray(ids[:, lo:hi]),
                                    cache=jcache)
        got, pcache = gpt2.forward(pparams, pcfg_q,
                                   torch.from_numpy(ids[:, lo:hi]),
                                   cache=pcache)
        _close(got, want)
    _same_cache(pcache, jcache)


def test_cache_mode_must_match_config(models):
    _, _, pcfg, pparams = models
    cache = gpt2.init_cache(pcfg, 1, 8, device="cpu", quantized=True)
    with pytest.raises(ValueError, match="quant_kv"):
        gpt2.forward(pparams, pcfg, torch.zeros((1, 1), dtype=torch.long),
                     cache=cache)


def test_int8_weights_forward_matches_jax(models):
    """Weight-only int8 (the JAX quantizer's tree carried across) through
    the full-sequence forward."""
    from distributed_lms_raft_llm_tpu.models import quant as jax_quant

    jcfg, jparams, pcfg, _ = models
    jq = jax_quant.quantize_params(jparams, "gpt2")
    pq = convert.params_from_jax(jax.device_get(jq), device="cpu")
    ids = np.random.default_rng(44).integers(0, jcfg.vocab_size, (2, 9))
    want, _ = _jax_forward(jq, jcfg, jnp.asarray(ids))
    got, _ = gpt2.forward(pq, pcfg, torch.from_numpy(ids))
    _close(got, want)
