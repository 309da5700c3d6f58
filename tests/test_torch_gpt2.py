"""GPT-2 forward of the PyTorch port against the JAX package (CPU, f32).

Both packages hold the same weights: a JAX init exported to numpy and
carried across with `convert.params_from_jax`. The cases are those of
tests/test_models_golden.py (full sequence, prefill + single-token steps,
left-padded prefill). The JAX single-token steps run the Pallas decode
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

from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
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


@pytest.mark.parametrize("preset", ["gpt2-medium", "llama3-8b", "moe-tiny"])
def test_registry_refuses_unported_presets(preset):
    with pytest.raises(ValueError, match="not ported"):
        registry.resolve(preset, torch.float32)


def test_registry_gpt2_is_full_width():
    _, cfg = registry.resolve("gpt2", torch.bfloat16)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.vocab_size,
            cfg.max_position_embeddings) == (12, 768, 12, 50257, 1024)
