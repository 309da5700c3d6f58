"""The port's BERT encoder against the JAX package's (CPU, tiny width).

Both packages hold the same weights: a JAX init exported to numpy and
carried across with `convert.params_from_jax`, the int8 tree quantized by
each package from the same float32 tree, and one HF-layout state dict
(made with numpy) through both converters. The cases follow
tests/test_models_golden.py:147-187 (padded rows compared over their
valid region) and tests/test_quant.py (int8 leaves bit-equal).

Tolerances: float32, atol 1e-5 (both sides compute in float32 and differ
by summation order); bf16, atol 2e-2 of the hidden state's largest
magnitude (the tolerance of `chip_smoke.py`'s bf16 kernel checks: the two
frameworks round bf16 at other places); the pooled embeddings in bf16,
the same 2e-2 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.models import bert as jax_bert
from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu_torch.models import bert, convert, quant

ATOL = 1e-5
BF16_OF_SCALE = 2e-2

_jax_forward = jax.jit(jax_bert.forward, static_argnums=(1,))
_jax_embed = jax.jit(jax_bert.embed, static_argnums=(1,))


def _flat(tree, path=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, path + (key,)))
        else:
            out[path + (key,)] = value
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = jax_bert.BertConfig.tiny(dtype=jnp.float32)
    jparams = jax_bert.init_params(jax.random.key(0), jcfg)
    cfg = bert.BertConfig.tiny(dtype=torch.float32)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed, lengths, t):
    """Right-padded ids and mask: row i holds lengths[i] real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(len(lengths), t))
    mask = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return ids, mask


def _port(fn, params, cfg, ids, mask, **kw):
    with torch.no_grad():
        return fn(params, cfg, torch.from_numpy(ids),
                  attention_mask=None if mask is None
                  else torch.from_numpy(mask), **kw)


@pytest.mark.parametrize("lengths,t", [((20, 13), 20), ((7, 32, 1), 32),
                                       ((64,), 64)])
def test_forward_matches_jax_on_the_valid_region(models, lengths, t):
    jcfg, jparams, cfg, params = models
    ids, mask = _batch(cfg, t, lengths, t)
    want = np.asarray(_jax_forward(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    got = _port(bert.forward, params, cfg, ids, mask).numpy()
    assert got.shape == (len(lengths), t, cfg.hidden_size)
    for row, n in enumerate(lengths):  # padded positions are undefined
        np.testing.assert_allclose(got[row, :n], want[row, :n], atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("with_mask", [True, False])
def test_embed_matches_jax(models, with_mask):
    jcfg, jparams, cfg, params = models
    ids, mask = _batch(cfg, 5, (16, 9, 3), 16)
    mask = mask if with_mask else None
    want = np.asarray(_jax_embed(jparams, jcfg, jnp.asarray(ids),
                                 None if mask is None else jnp.asarray(mask)))
    got = _port(bert.embed, params, cfg, ids, mask)
    assert got.dtype == torch.float32 and got.shape == (3, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_token_types_match_jax(models):
    jcfg, jparams, cfg, params = models
    ids, mask = _batch(cfg, 6, (12, 12), 12)
    types = np.zeros_like(ids)
    types[:, 6:] = 1
    want = np.asarray(_jax_forward(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(mask), jnp.asarray(types)))
    got = _port(bert.forward, params, cfg, ids, mask,
                token_type_ids=torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_embedding_is_independent_of_the_bucket(models):
    """Mask-weighted pooling: a row padded to a wider bucket embeds as it
    does alone (what lets the gate cache a context's embedding)."""
    _, _, cfg, params = models
    ids, mask = _batch(cfg, 7, (10,), 10)
    wide_ids = np.concatenate([ids, np.zeros((1, 22), ids.dtype)], axis=1)
    wide_mask = np.concatenate([mask, np.zeros((1, 22), mask.dtype)], axis=1)
    narrow = _port(bert.embed, params, cfg, ids, mask)
    wide = _port(bert.embed, params, cfg, wide_ids, wide_mask)
    np.testing.assert_allclose(narrow.numpy(), wide.numpy(), atol=ATOL,
                               rtol=0)


def test_a_row_with_no_token_divides_by_one(models):
    _, _, cfg, params = models
    ids, mask = _batch(cfg, 8, (5, 0), 8)
    got = _port(bert.embed, params, cfg, ids, mask)
    assert bool(torch.isfinite(got).all())
    assert bool((got[1] == 0).all())


def test_cosine_similarity_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 4, 32)).astype(np.float32)
    b[3] = 0.0  # a zero vector: the denominator's floor
    want = np.asarray(jax_bert.cosine_similarity(jnp.asarray(a),
                                                 jnp.asarray(b)))
    got = bert.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert float(got[3]) == 0.0


def test_positions_beyond_the_table_raise(models):
    _, _, cfg, params = models
    ids = torch.zeros((1, cfg.max_position_embeddings + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="position table"):
        bert.forward(params, cfg, ids)


def test_bf16_matches_jax(models):
    """bf16 compute over float32 parameters (the gate's default): JAX casts
    each weight inside the product; the port casts the products' weights
    once (`cast_products`)."""
    _, jparams, cfg32, params = models
    jcfg = jax_bert.BertConfig.tiny(dtype=jnp.bfloat16)
    cfg = bert.BertConfig.tiny(dtype=torch.bfloat16)
    ids, mask = _batch(cfg, 10, (30, 17), 30)
    want = np.asarray(_jax_forward(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(mask)).astype(jnp.float32))
    got = _port(bert.forward, bert.cast_products(params, torch.bfloat16),
                cfg, ids, mask)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    atol = BF16_OF_SCALE * np.abs(want).max()
    for row, n in enumerate((30, 17)):
        np.testing.assert_allclose(got[row, :n], want[row, :n], atol=atol,
                                   rtol=0)
    want_e = np.asarray(_jax_embed(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    got_e = _port(bert.embed, bert.cast_products(params, torch.bfloat16),
                  cfg, ids, mask).numpy()
    np.testing.assert_allclose(got_e, want_e,
                               atol=BF16_OF_SCALE * np.abs(want_e).max(),
                               rtol=0)


def test_cast_products_gives_the_same_numbers(models):
    """Casting the products' weights once at load computes exactly what the
    per-call cast computes; the tables and norms stay float32."""
    _, _, _, params = models
    cfg = bert.BertConfig.tiny(dtype=torch.bfloat16)
    cast = bert.cast_products(params, torch.bfloat16)
    for group, w, b in bert.PRODUCTS:
        assert cast["blocks"][group][w].dtype == torch.bfloat16
        assert cast["blocks"][group][b].dtype == torch.bfloat16
        assert params["blocks"][group][w].dtype == torch.float32
    for path, leaf in _flat(cast).items():
        if path[0] == "embeddings" or path[1].endswith("_ln"):
            assert leaf.dtype == torch.float32, path
    ids, mask = _batch(cfg, 11, (24, 5), 24)
    per_call = _port(bert.forward, params, cfg, ids, mask)
    at_load = _port(bert.forward, cast, cfg, ids, mask)
    assert torch.equal(per_call, at_load)


def test_int8_leaves_are_bit_equal_to_jax(models):
    _, jparams, _, params = models
    jq = jax.device_get(jax_quant.quantize_params(jparams, "bert"))
    q = quant.quantize_params(params, "bert")
    jflat, flat = _flat(jq), _flat(q)
    assert sorted(jflat) == sorted(flat)
    quantized = {p[:-1] for p in flat if p[-1] == "q"}
    assert quantized == {("embeddings", "word"), ("blocks", "attn", "wqkv"),
                         ("blocks", "attn", "wo"), ("blocks", "mlp", "wi"),
                         ("blocks", "mlp", "wo")}
    for path, value in jflat.items():
        np.testing.assert_array_equal(flat[path].numpy(), np.asarray(value))
        assert flat[path].numpy().dtype == np.asarray(value).dtype, path
    # The word table scales per row (token), the products per out column.
    assert q["embeddings"]["word"]["s"].shape == (384,)
    assert q["blocks"]["mlp"]["wi"]["s"].shape == (2, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(models, dtype):
    _, jparams, _, params = models
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jax_bert.BertConfig.tiny(dtype=jdt)
    cfg = bert.BertConfig.tiny(dtype=dt)
    jq = jax_quant.quantize_params(jparams, "bert")
    q = bert.cast_products(quant.quantize_params(params, "bert"), dt)
    ids, mask = _batch(cfg, 12, (40, 21), 40)
    want = np.asarray(_jax_embed(jq, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    got = _port(bert.embed, q, cfg, ids, mask).numpy()
    atol = ATOL if dtype == "float32" else BF16_OF_SCALE * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _hf_state_dict(cfg, seed):
    """A random HF `BertForPreTraining`-layout state dict (numpy; torch
    Linear weights [out, in], the "bert." prefix, a pooler the gate does
    not use)."""
    rng = np.random.default_rng(seed)
    d, m = cfg.hidden_size, cfg.mlp_dim

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {
        "bert.embeddings.word_embeddings.weight": r(cfg.vocab_size, d),
        "bert.embeddings.position_embeddings.weight":
            r(cfg.max_position_embeddings, d),
        "bert.embeddings.token_type_embeddings.weight": r(2, d),
        "bert.embeddings.LayerNorm.weight": r(d),
        "bert.embeddings.LayerNorm.bias": r(d),
        "bert.pooler.dense.weight": r(d, d),
        "bert.pooler.dense.bias": r(d),
    }
    for i in range(cfg.num_layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[p + f"attention.self.{name}.weight"] = r(d, d)
            sd[p + f"attention.self.{name}.bias"] = r(d)
        sd[p + "attention.output.dense.weight"] = r(d, d)
        sd[p + "attention.output.dense.bias"] = r(d)
        sd[p + "attention.output.LayerNorm.weight"] = r(d)
        sd[p + "attention.output.LayerNorm.bias"] = r(d)
        sd[p + "intermediate.dense.weight"] = r(m, d)
        sd[p + "intermediate.dense.bias"] = r(m)
        sd[p + "output.dense.weight"] = r(d, m)
        sd[p + "output.dense.bias"] = r(d)
        sd[p + "output.LayerNorm.weight"] = r(d)
        sd[p + "output.LayerNorm.bias"] = r(d)
    return sd


def test_params_from_hf_equal_jax_leaf_for_leaf():
    hf_config = {"vocab_size": 384, "max_position_embeddings": 64,
                 "type_vocab_size": 2, "hidden_size": 32,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "layer_norm_eps": 1e-12}
    jcfg = jax_convert.bert_config_from_hf(hf_config)
    cfg = convert.bert_config_from_hf(hf_config)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.max_position_embeddings) == (
        jcfg.vocab_size, jcfg.hidden_size, jcfg.num_layers, jcfg.num_heads,
        jcfg.max_position_embeddings)
    sd = _hf_state_dict(cfg, 13)
    jflat = _flat(jax_convert.bert_params_from_hf(sd, jcfg))
    flat = _flat(convert.bert_params_from_hf(sd, cfg, device="cpu"))
    assert sorted(jflat) == sorted(flat)
    for path, value in jflat.items():
        np.testing.assert_array_equal(flat[path].numpy(), np.asarray(value))
    # torch tensors in, as a state_dict() holds them, give the same tree.
    tflat = _flat(convert.bert_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, device="cpu"))
    for path, value in flat.items():
        assert torch.equal(tflat[path], value), path
