"""Sampling of the PyTorch port against the JAX package on fixed logits.

The filters (repetition penalty, top-k, top-p) must give the same logits
as the JAX ops, ties included; greedy picks must be equal. Random streams
differ between `torch.Generator` and `jax.random`, so sampled tokens are
compared as a distribution: the empirical frequencies of many port draws
against the probabilities the JAX filters leave.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import sampling as jax_sampling
from distributed_lms_raft_llm_tpu_torch.engine import sampling

V = 64


def _tied_logits(seed, rows=6):
    """Few distinct values: many ties, also at every top-k / top-p edge."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 6, size=(rows, V)) * 0.5).astype(np.float32)


def _seen(seed, rows=6):
    return np.random.default_rng(seed).random((rows, V)) < 0.3


def _params(**kw):
    return (sampling.SamplingParams(**kw),
            jax_sampling.SamplingParams(**kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax_argmax(seed):
    logits = _tied_logits(seed)
    logits[:, 3] = logits.max()  # an exact tie for the maximum
    seen = _seen(seed)
    port_p, jax_p = _params(temperature=0.0, top_k=0, top_p=1.0,
                            repetition_penalty=1.2)
    want = jax_sampling.sample_step(jax.random.key(0), jnp.asarray(logits),
                                    jnp.asarray(seen), jax_p)
    got = sampling.sample_step(torch.Generator().manual_seed(0),
                               torch.from_numpy(logits),
                               torch.from_numpy(seen), port_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 5, 17, V])
def test_top_k_matches_jax(k):
    logits = _tied_logits(2)
    want = jax_sampling.apply_top_k(jnp.asarray(logits), k)
    got = sampling.apply_top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.3, 0.5, 0.9, 1.0])
def test_top_p_matches_jax_including_ties(p):
    logits = _tied_logits(3)
    want = jax_sampling.apply_top_p(jnp.asarray(logits), p)
    got = sampling.apply_top_p(torch.from_numpy(logits), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("penalty", [1.0, 1.2])
def test_repetition_penalty_matches_jax(penalty):
    logits = _tied_logits(4) - 1.0  # both signs
    seen = _seen(4)
    want = jax_sampling.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(seen), penalty)
    got = sampling.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(seen), penalty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_seen_masks_match_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, V, size=(3, 9))
    valid = rng.random((3, 9)) < 0.7
    want = jax_sampling.seen_mask_from_ids(jnp.asarray(ids),
                                           jnp.asarray(valid), V)
    got = sampling.seen_mask_from_ids(torch.from_numpy(ids),
                                      torch.from_numpy(valid), V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok = rng.integers(0, V, size=(3,))
    np.testing.assert_array_equal(
        sampling.update_seen(got, torch.from_numpy(tok)).numpy(),
        np.asarray(jax_sampling.update_seen(want, jnp.asarray(tok))),
    )


@pytest.mark.parametrize("top_k,top_p", [(5, 0.9), (0, 0.8), (10, 1.0)])
def test_sampled_distribution_matches_jax_filters(top_k, top_p):
    """Empirical frequencies of 40k port draws on one row of logits against
    softmax of the JAX-filtered logits. The standard error of each
    frequency is below 0.0025, so 0.012 is about five of them."""
    rng = np.random.default_rng(6)
    row = rng.standard_normal(V).astype(np.float32) * 2.0
    temperature = 0.7
    seen = np.zeros((1, V), bool)
    seen[0, :8] = True
    port_p, jax_p = _params(temperature=temperature, top_k=top_k,
                            top_p=top_p, repetition_penalty=1.2)

    filt = jax_sampling.apply_repetition_penalty(
        jnp.asarray(row[None]), jnp.asarray(seen), 1.2) / temperature
    filt = jax_sampling.apply_top_k(filt, top_k)
    filt = jax_sampling.apply_top_p(filt, top_p)
    want = np.asarray(jax.nn.softmax(filt, axis=-1))[0]

    n = 40_000
    draws = sampling.sample_step(
        torch.Generator().manual_seed(1),
        torch.from_numpy(np.repeat(row[None], n, axis=0)),
        torch.from_numpy(np.repeat(seen, n, axis=0)), port_p,
    ).numpy()
    freq = np.bincount(draws, minlength=V) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want > 0))
    np.testing.assert_allclose(freq, want, atol=0.012)
