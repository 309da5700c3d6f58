"""Speculative decoding in the port on the CPU, against the JAX package.

The pieces of `engine/draft.py` and the bucketed `engine/spec.py`, held
against `distributed_lms_raft_llm_tpu.engine.draft`/`.spec` on the same
numpy-seeded inputs:

- drafts equal to JAX's id for id (`build_drafts`, `build_drafts_ngram`),
  on tests/test_spec.py's hand-built transcripts and on random ones;
- `_processed_top` values within 1e-6 of JAX's, ids equal;
- `verify_window` under greedy decoding: emissions, validity, seen set and
  eos flags equal to JAX's; sampled, its first emission distributed as the
  processed distribution (enumerated exactly on a 64-id vocabulary) and
  as `sample_step`'s draws, the bonus token as the next row's: the random
  streams differ, so sampled tokens are never compared one for one;
- the verify window's attention (T query rows at per-row offsets) in the
  kernel's plain version against JAX's ragged multi-token path, float and
  int8 caches (tests/test_spec.py's TestRaggedMultiTokenCacheWrite);
- `decode_spec` and the bucketed engine: greedy tokens byte-equal to the
  JAX `decode_spec`/`TutoringEngine` with speculation and to the port
  without it; the position budget; the engine's acceptance gauge.

Tolerances: float32 logits within 2e-5 (summation order); the sampled
frequencies within 5 binomial standard deviations.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine import TutoringEngine as JaxEngine
from distributed_lms_raft_llm_tpu.engine import draft as jax_draft
from distributed_lms_raft_llm_tpu.engine import generate as jax_generate
from distributed_lms_raft_llm_tpu.engine import spec as jax_spec
from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu_torch.engine import (
    BatchingQueue,
    EngineConfig,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.engine import draft, spec
from distributed_lms_raft_llm_tpu_torch.engine.generate import decode, prefill
from distributed_lms_raft_llm_tpu_torch.engine.sampling import (
    sample_step,
    seen_mask_from_ids,
)
from distributed_lms_raft_llm_tpu_torch.models import convert, gpt2, registry
from distributed_lms_raft_llm_tpu_torch.models.common import KVCache
from distributed_lms_raft_llm_tpu_torch.ops import attention
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

PROMPTS = ["what is raft?", "hello world", "the the the the", "k"]


def _jax_sampling(sp: SamplingParams) -> JaxSampling:
    return JaxSampling(**dataclasses.asdict(sp))


def _t(x, dtype=torch.long):
    return torch.as_tensor(np.asarray(x)).to(dtype)


# ------------------------------------------------------------------ drafts

HAND_CASES = {
    # ... 5 9 ... 7 9 ... [7 9]: the bigram (7, 9) matches at the second 9
    "bigram_over_unigram": (
        [[5, 9, 1, 2, 7, 9, 3, 4, 7, 9, 0, 0]], [[True] * 9 + [False] * 3],
        [7], [9], 3, [[3, 4, 7]]),
    # prev 8 matches nowhere: unigram on 9, the most recent (slot 3)
    "unigram_fallback_and_recency": (
        [[9, 1, 2, 9, 3, 4, 0, 0]], [[True] * 6 + [False, False]],
        [8], [9], 2, [[3, 4]]),
    "no_match_repeats_last": (
        [[1, 2, 3, 4]], [[True] * 4], [6], [7], 2, [[7, 7]]),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_built_drafts_equal_jax(case):
    tr, valid, prev, last, k, want = HAND_CASES[case]
    got = draft.build_drafts(_t(tr), _t(valid, torch.bool), _t(prev),
                             _t(last), k)
    jgot = jax_draft.build_drafts(jnp.asarray(tr, jnp.int32),
                                  jnp.asarray(valid), jnp.asarray(prev),
                                  jnp.asarray(last), k)
    assert got.tolist() == want == np.asarray(jgot).tolist()
    for fn, jfn in ((draft.build_drafts_ngram, jax_draft.build_drafts_ngram),):
        assert fn(_t(tr), _t(valid, torch.bool), _t(prev), _t(last),
                  k).tolist() == np.asarray(jfn(
                      jnp.asarray(tr, jnp.int32), jnp.asarray(valid),
                      jnp.asarray(prev), jnp.asarray(last), k)).tolist()


def _random_transcripts(seed, b=6, w=40, vocab=5):
    """Rows of a few ids (so n-grams repeat), each valid up to its own
    frontier as the engines build match_valid."""
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, vocab, (b, w)).astype(np.int32)
    frontier = rng.integers(0, w, b)
    frontier[0] = w - 1
    valid = np.arange(w)[None, :] <= frontier[:, None]
    prev = rng.integers(0, vocab, b).astype(np.int32)
    last = rng.integers(0, vocab + 1, b).astype(np.int32)  # one may miss
    return tr, valid, prev, last


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("source", ["prompt_lookup", "ngram"])
def test_random_drafts_equal_jax(source, seed, k):
    tr, valid, prev, last = _random_transcripts(seed)
    fn, jfn = {"prompt_lookup": (draft.build_drafts, jax_draft.build_drafts),
               "ngram": (draft.build_drafts_ngram,
                         jax_draft.build_drafts_ngram)}[source]
    got = fn(_t(tr), _t(valid, torch.bool), _t(prev), _t(last), k)
    want = jfn(jnp.asarray(tr), jnp.asarray(valid), jnp.asarray(prev),
               jnp.asarray(last), k)
    assert got.shape == (len(tr), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ the processed top

SAMPLINGS = {
    "reference": SamplingParams.reference_defaults(),
    "no_top_k": SamplingParams(temperature=0.9, top_k=0, top_p=0.8,
                               repetition_penalty=1.3),
    "top_k_only": SamplingParams(temperature=0.5, top_k=16, top_p=1.0,
                                 repetition_penalty=1.0),
    "greedy_penalty": SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                     repetition_penalty=1.2),
}


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_processed_top_equals_jax(name):
    sp = SAMPLINGS[name]
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2.0, (5, 96)).astype(np.float32)
    seen = rng.random((5, 96)) < 0.2
    vals, idx = draft._processed_top(torch.from_numpy(logits),
                                     torch.from_numpy(seen), sp)
    jvals, jidx = jax_draft._processed_top(jnp.asarray(logits),
                                           jnp.asarray(seen),
                                           _jax_sampling(sp))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ------------------------------------------------------------ the verifier


@pytest.mark.parametrize("penalty", [1.0, 1.2])
@pytest.mark.parametrize("k", [1, 4])
def test_greedy_verify_window_equals_jax(k, penalty):
    """Drafts that agree with the argmax for a while, then not; an eos
    inside one row's window; an inactive row."""
    b, v = 6, 48
    rng = np.random.default_rng(k)
    logits = rng.normal(0, 2.0, (b, k + 1, v)).astype(np.float32)
    seen = rng.random((b, v)) < 0.1
    drafts = np.argmax(logits[:, :k], axis=-1).astype(np.int32)
    drafts[1, -1] = (drafts[1, -1] + 1) % v   # a late rejection
    drafts[2, 0] = (drafts[2, 0] + 1) % v     # an early one
    eos = int(np.argmax(logits[3, 0]))        # row 3 emits eos first
    active = np.ones(b, bool)
    active[4] = False
    sp = SamplingParams.greedy(repetition_penalty=penalty)
    got = draft.verify_window(None, torch.from_numpy(logits),
                              torch.from_numpy(drafts).long(),
                              torch.from_numpy(seen), torch.from_numpy(active),
                              sp, eos_id=eos, pad_id=-1)
    want = jax_draft.verify_window(jax.random.key(0), jnp.asarray(logits),
                                   jnp.asarray(drafts), jnp.asarray(seen),
                                   jnp.asarray(active), _jax_sampling(sp),
                                   eos_id=eos, pad_id=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[1][4].any() and got[3][3]


class TestVerifierDistribution:
    """The accept/resample rule reproduces the processed distribution: with
    a point-mass draft d, accepting with p(d) and otherwise resampling from
    p without d is p itself (tests/test_spec.py). Frequencies over 4000
    windows against the exact processed distribution on a 64-id
    vocabulary, and against `sample_step`'s draws."""

    V = 64
    N = 4000
    SP = SamplingParams(temperature=0.7, top_k=16, top_p=0.9,
                        repetition_penalty=1.0, max_new_tokens=4)

    def _logits(self, seed):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            0, 2.0, (self.V,)).astype(np.float32))

    def _exact(self, row, seen=None):
        """The processed distribution of one logit row, enumerated."""
        seen = torch.zeros(self.V, dtype=torch.bool) if seen is None else seen
        vals, idx = draft._processed_top(row[None], seen[None], self.SP)
        p = torch.zeros(self.V, dtype=torch.float64)
        p[idx[0]] = torch.softmax(vals[0].double(), dim=-1)
        return p.numpy()

    def _window(self, rows, drafts, seed):
        gen = torch.Generator().manual_seed(seed)
        n = self.N
        logits = rows[None].expand(n, *rows.shape).contiguous()
        dr = torch.tensor(drafts).expand(n, len(drafts)).contiguous()
        return draft.verify_window(
            gen, logits, dr, torch.zeros((n, self.V), dtype=torch.bool),
            torch.ones(n, dtype=torch.bool), self.SP, eos_id=-1, pad_id=-1)

    def _freq(self, toks, support):
        return np.array([(toks == s).mean() for s in support])

    def _check(self, toks, p):
        tol = 5 * np.sqrt(p * (1 - p) / len(toks)) + 1e-3
        got = self._freq(toks, range(self.V))
        assert (np.abs(got - p) <= tol).all(), np.abs(got - p).max()

    @pytest.mark.parametrize("rank", [0, 1, 5, 40])
    def test_first_emission_is_the_processed_distribution(self, rank):
        """Drafts from the most likely id to one outside the top-k (p = 0:
        never emitted, always resampled)."""
        row = self._logits(0)
        d = int(torch.argsort(row, descending=True)[rank])
        emitted, valid, _, _ = self._window(
            torch.stack([row, row]), [d], seed=rank)
        assert valid[:, 0].all()
        p = self._exact(row)
        self._check(emitted[:, 0].numpy(), p)
        if p[d] == 0:
            assert (emitted[:, 0] != d).all()
        # And as sample_step draws it (its own golden tests hold it to HF).
        ref = sample_step(torch.Generator().manual_seed(99),
                          row[None].expand(self.N, self.V).contiguous(),
                          torch.zeros((self.N, self.V), dtype=torch.bool),
                          self.SP)
        support = sorted(set(ref.tolist()) | set(emitted[:, 0].tolist()))
        np.testing.assert_allclose(self._freq(emitted[:, 0].numpy(), support),
                                   self._freq(ref.numpy(), support),
                                   atol=0.04)

    def test_bonus_token_is_the_next_rows_distribution(self):
        """Where the draft is accepted, the bonus token follows row 1's
        processed distribution (the seen set holds the draft, no penalty
        here)."""
        row0, row1 = self._logits(1), self._logits(2)
        d = int(torch.argmax(row0))
        emitted, valid, _, _ = self._window(torch.stack([row0, row1]), [d],
                                            seed=5)
        accepted = emitted[:, 0] == d
        assert (valid[:, 1] == accepted).all() and accepted.sum() > 1000
        self._check(emitted[accepted, 1].numpy(), self._exact(row1))


# -------------------------------------------------- the window's attention

L, B, H, S, DH = 2, 3, 4, 24, 8


def _window_inputs(seed, quant):
    rng = np.random.default_rng(seed)
    t = 4
    q = rng.standard_normal((B, H, t, DH)).astype(np.float32)
    k = rng.standard_normal((L, B, H, S, DH)).astype(np.float32)
    v = rng.standard_normal((L, B, H, S, DH)).astype(np.float32)
    offs = np.array([0, 7, S - t], np.int32)  # one window ends at the width
    kv_mask = np.ones((B, S), bool)
    kv_mask[1, :3] = False                    # left padding
    return q, k, v, offs, kv_mask


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_reference_equals_jax_attend(quant, with_mask):
    """`decode_attention_reference` with T rows (row b's query j sees keys
    < offs[b] + 1 + j), against JAX's `attend`/`attend_quant` under the
    causal window mask of the ragged path, float and int8 caches, with the
    bucketed path's padding as the shared bias."""
    q, k, v, offs, kv_mask = _window_inputs(5, quant)
    t = q.shape[2]
    slots = offs[:, None] + np.arange(t)[None, :]
    mask = (np.arange(S)[None, None, :] <= slots[:, :, None])[:, None]
    bias = None
    if with_mask:
        mask = mask & kv_mask[:, None, None, :]
        bias = attention.mask_to_bias(torch.from_numpy(
            kv_mask[:, None, None, :]))
    lengths = torch.from_numpy(offs + 1)
    tq = torch.from_numpy(q)
    if quant:
        (k8, ks), (v8, vs) = (jax_common.quantize_kv(jnp.asarray(x))
                              for x in (k, v))
        got = attention.decode_attention(
            tq, _t(k8, torch.int8), _t(v8, torch.int8), 1, bias,
            lengths=lengths, k_scale=_t(ks, torch.float32),
            v_scale=_t(vs, torch.float32))
        want = jax_common.attend_quant(jnp.asarray(q), k8[1], ks[1], v8[1],
                                       vs[1], jnp.asarray(mask))
    else:
        got = attention.decode_attention(tq, torch.from_numpy(k),
                                         torch.from_numpy(v), 1, bias,
                                         lengths=lengths)
        want = jax_common.attend(jnp.asarray(q), jnp.asarray(k[1]),
                                 jnp.asarray(v[1]), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_window_row_equals_its_single_row_call():
    q, k, v, offs, _ = _window_inputs(6, False)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    lengths = torch.from_numpy(offs + 1)
    got = attention.decode_attention(torch.from_numpy(q), tk, tv, 0,
                                     lengths=lengths)
    for j in range(q.shape[2]):
        one = attention.decode_attention(
            torch.from_numpy(q[:, :, j:j + 1].copy()), tk, tv, 0,
            lengths=lengths + j)
        torch.testing.assert_close(got[:, :, j:j + 1], one, rtol=0, atol=1e-6)


def test_window_bounds_are_checked():
    q = torch.zeros((1, H, attention.MAX_WINDOW + 1, DH))
    k = torch.zeros((L, 1, H, S, DH))
    with pytest.raises(ValueError, match="T <= 16"):
        attention.decode_attention(q, k, k, 0)


@pytest.mark.parametrize("group,t,rows,chunks", [
    (1, 1, 1, 1), (4, 1, 4, 1), (8, 1, 8, 1), (1, 2, 2, 1), (1, 4, 4, 1),
    (1, 5, 3, 2), (1, 9, 3, 3), (1, 16, 4, 4), (3, 9, 4, 7), (8, 2, 4, 4),
])
def test_window_rows_cut(group, t, rows, chunks):
    """Decode keeps its G heads in one block; a float32 window's G x T rows
    (the CUDA-core kernel) go in blocks of at most 4, of equal size; a bf16
    window's (the tensor-core kernel) in one block of 16-row tiles."""
    assert attention.window_rows(group, t, torch.float32) == (rows, chunks)
    if t > 1:
        assert rows <= attention.F32_WINDOW_ROWS
        assert rows * chunks >= group * t
        assert rows * (chunks - 1) < group * t
        tiles = -(-group * t // attention.WINDOW_ROWS)
        assert attention.window_rows(group, t, torch.bfloat16) == (
            attention.WINDOW_ROWS * (1 << (tiles - 1).bit_length()), 1)
    else:
        assert attention.window_rows(group, t, torch.bfloat16) == (rows,
                                                                   chunks)


def test_window_kernel_layout():
    """What the kernel is told for a verify window: q's window stride, the
    rows a block and the blocks a (row, KV head), the window variants. A
    bf16 window takes the tensor-core kernel: one 16-row tile a (row, KV
    head), tiles of 16-key blocks."""
    b, s, t, dh = 16, 384, 9, 64
    qkv = torch.zeros((b, t, 3 * 12 * dh), dtype=torch.bfloat16)
    q = qkv[..., :12 * dh].reshape(b, t, 12, dh).transpose(1, 2)
    k = torch.zeros((12, b, 12, 512, dh), dtype=torch.int8)[:, :, :, :s]
    sc = torch.zeros((12, b, 12, 512))[..., :s]
    lengths = torch.ones((b,), dtype=torch.int32)
    lay = attention._kernel_layout(q, k, k, None, lengths, sc, sc)
    a = lay.args
    assert (a.q_sb, a.q_sh, a.q_sw) == (t * 3 * 12 * dh, dh, 3 * 12 * dh)
    assert (a.W, a.rows, a.n_chunks, a.S_alloc) == (t, 16, 1, 512)
    assert lay.variant == attention.WINDOW_INT8KV
    assert lay.plan == attention.launch_plan(b, 12, s, dh, torch.int8,
                                             group=16, tensor_cores=True)
    assert lay.plan.tile_keys % 16 == 0 and lay.plan.blocks == b * 12
    f32 = attention._kernel_layout(q.float(), k, k, None, lengths, sc, sc)
    assert (f32.args.rows, f32.args.n_chunks) == (3, 3)
    assert f32.plan == attention.launch_plan(b, 12, s, dh, torch.int8,
                                             group=3, chunks=3)
    assert f32.plan.tile_keys <= 64
    kb = k.to(torch.bfloat16)
    assert attention._kernel_layout(
        q, kb, kb, torch.zeros((b, 1, s)), lengths).variant == \
        attention.WINDOW
    with pytest.raises(ValueError, match="kernel limits"):
        attention._kernel_layout(q[..., :32], kb[..., :32], kb[..., :32],
                                 None, lengths)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jparams = jax_gpt2.init_params(jax.random.key(0), jcfg)
    family, cfg = registry.resolve("tiny", torch.float32, torch.float32)
    params = convert.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, family, cfg, params


@pytest.mark.parametrize("quant_kv", [False, True])
def test_ragged_window_matches_scalar_path_and_jax(tiny, quant_kv):
    """A 4-token window at the same offset for every row: the ragged path
    (through the kernel's plain window version) equals the scalar path and
    JAX's ragged path; the caches are written alike."""
    jcfg, jparams, family, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, quant_kv=quant_kv)
    cfg = dataclasses.replace(cfg, quant_kv=quant_kv,
                              fused_decode_attention=True)
    b, t0, tw = 2, 6, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, (b, t0))
    window = rng.integers(1, cfg.vocab_size, (b, tw))

    jcache = jax_gpt2.init_cache(jcfg, b, t0 + tw, dtype=jnp.float32)
    _, jcache = jax_gpt2.forward(jparams, jcfg, jnp.asarray(prompt),
                                 cache=jcache)
    want, _ = jax_gpt2.forward(
        jparams, jcfg, jnp.asarray(window),
        cache=jcache._replace(length=jnp.full((b,), t0, jnp.int32)))

    caches = []
    for ragged in (False, True):
        cache = gpt2.init_cache(cfg, b, t0 + tw, device="cpu")
        gpt2.forward(params, cfg, torch.from_numpy(prompt), cache=cache)
        if ragged:
            cache = dataclasses.replace(
                cache, lengths=torch.full((b,), t0, dtype=torch.int32))
        else:
            cache = dataclasses.replace(cache, length=t0)
        got, _ = gpt2.forward(params, cfg, torch.from_numpy(window),
                              cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)
        caches.append(cache)
    for name in ("k", "v", "ks", "vs"):
        a, c = getattr(caches[0], name), getattr(caches[1], name)
        assert (a is None) == (c is None)
        if a is not None:
            torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_window_wider_than_the_kernel_raises_not_falls_back(tiny):
    """With fused attention every ragged window without cache.rows goes to
    the kernel's wrapper: a T = 17 window raises (the kernel takes 16
    rows) instead of running the plain attention; without fused attention
    it runs the plain path."""
    _, _, family, cfg, params = tiny
    b, t, width = 2, attention.MAX_WINDOW + 1, 40
    window = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (b, t)))
    lengths = torch.tensor([1, 3], dtype=torch.int32)
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_decode_attention=fused)
        cache = dataclasses.replace(gpt2.init_cache(c, b, width,
                                                    device="cpu"),
                                    lengths=lengths)
        if fused:
            with pytest.raises(ValueError, match="T <= 16"):
                gpt2.forward(params, c, window, cache=cache)
        else:
            logits, _ = gpt2.forward(params, c, window, cache=cache)
            assert logits.shape == (b, t, cfg.vocab_size)


def test_ragged_window_rows_at_different_offsets(tiny):
    """Row r's window lands at its own offset; other slots stay as they
    were (cross-row isolation of the per-row write)."""
    _, _, family, cfg, params = tiny
    cfg = dataclasses.replace(cfg, fused_decode_attention=True)
    b, tw, width = 2, 3, 12
    cache = gpt2.init_cache(cfg, b, width, device="cpu")
    cache = KVCache(k=torch.full_like(cache.k, 7.0),
                    v=torch.full_like(cache.v, 7.0),
                    lengths=torch.tensor([2, 5], dtype=torch.int32))
    window = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (b, tw)))
    _, out = gpt2.forward(params, cfg, window, cache=cache)
    assert out.lengths.tolist() == [2 + tw, 5 + tw]
    for r, o in enumerate([2, 5]):
        touched = (cache.k[:, r] != 7.0).any(dim=(0, 1, 3))
        assert touched[o:o + tw].all()
        assert not touched[:o].any() and not touched[o + tw:].any()


# ------------------------------------------------------------ decode_spec


def _prompt(vocab, b=3, t=8, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, t)).astype(np.int32)
    ids[:, 4:6] = ids[:, 0:2]  # a repeated bigram: the drafter finds anchors
    mask = np.ones((b, t), bool)
    mask[1, :3] = False
    return ids, mask


def _run_port(tiny, sp, k, eos=0, quant_kv=False, fused=True):
    _, _, family, cfg, params = tiny
    cfg = dataclasses.replace(cfg, quant_kv=quant_kv,
                              fused_decode_attention=fused)
    ids, mask = _prompt(cfg.vocab_size)
    state = prefill(params, cfg, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask),
                             torch.Generator().manual_seed(1), sp, eos, 0,
                             model=family)
    if k == 0:
        res, _ = decode(params, state, cfg, sp, eos, 0,
                                 model=family)
        return res, None
    return spec.decode_spec(params, state, torch.from_numpy(ids).long(), cfg,
                            sp, eos, 0, model=family, spec_tokens=k)


def _run_jax(tiny, sp, k, eos=0, quant_kv=False):
    jcfg, jparams, *_ = tiny
    jcfg = dataclasses.replace(jcfg, quant_kv=quant_kv)
    ids, mask = _prompt(jcfg.vocab_size)
    jsp = _jax_sampling(sp)
    st = jax_generate.prefill(jparams, jcfg, jnp.asarray(ids),
                              jnp.asarray(mask), jax.random.key(1), jsp, eos,
                              0)
    res, fin = jax_spec.decode_spec(jparams, st, jnp.asarray(ids), jcfg, jsp,
                                    eos, 0, spec_tokens=k)
    return jax.device_get(res), int(fin.windows)


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("k,max_new,penalty", [
    (1, 16, 1.0), (3, 16, 1.0), (4, 20, 1.2), (5, 7, 1.0),
])
def test_decode_spec_greedy_equals_jax_and_plain(tiny, k, max_new, penalty,
                                                 quant_kv):
    """Greedy: the port's decode_spec emits JAX's decode_spec tokens, in as
    many windows, and the port's plain decode's tokens (the budget not a
    multiple of the window; the penalty's seen set through the window)."""
    sp = SamplingParams.greedy(max_new_tokens=max_new,
                               repetition_penalty=penalty)
    got, state = _run_port(tiny, sp, k, quant_kv=quant_kv)
    want, windows = _run_jax(tiny, sp, k, quant_kv=quant_kv)
    plain, _ = _run_port(tiny, sp, 0, quant_kv=quant_kv)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    assert state.windows == windows
    assert state.cache.max_len == 8 + max_new + k - 1


def test_decode_spec_stops_rows_at_eos(tiny):
    sp = SamplingParams.greedy(max_new_tokens=16)
    probe, _ = _run_port(tiny, sp, 0)
    eos = int(probe.tokens[0, 4])  # a token greedy decoding reaches
    got, _ = _run_port(tiny, sp, 3, eos=eos)
    want, _ = _run_jax(tiny, sp, 3, eos=eos)
    plain, _ = _run_port(tiny, sp, 0, eos=eos)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
    assert int(got.lengths[0]) < 16


def test_decode_spec_plain_and_kernel_attention_agree(tiny):
    sp = SamplingParams.greedy(max_new_tokens=12)
    fused, _ = _run_port(tiny, sp, 4, fused=True)
    plain, _ = _run_port(tiny, sp, 4, fused=False)
    np.testing.assert_array_equal(fused.tokens.numpy(), plain.tokens.numpy())


def test_decode_spec_rejects_an_oversubscribed_position_budget(tiny):
    """prefill's own guard passes (t + max_new == the table) but the
    window's k-1 overhang does not fit: a loud error, not clamped
    positions (tests/test_spec.py)."""
    _, _, family, cfg, params = tiny
    t = 8
    sp = SamplingParams.greedy(max_new_tokens=cfg.max_position_embeddings - t)
    ids = torch.ones((1, t), dtype=torch.long)
    state = prefill(params, cfg, ids,
                             torch.ones((1, t), dtype=torch.bool),
                             torch.Generator().manual_seed(1), sp, 0, 0,
                             model=family)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        spec.decode_spec(params, state, ids, cfg, sp, 0, 0, model=family,
                         spec_tokens=4)


# ------------------------------------------------------ the bucketed engine


def _engines(sampling, k, **kw):
    """(JAX spec engine, port spec engine, port plain engine) on the same
    float32 weights; the port attends through the kernel's plain version
    (fused_attention, which the JAX engine refuses with speculation)."""
    common = dict(model="tiny", length_buckets=(16,), batch_buckets=(1, 2, 4),
                  **kw)
    jeng = JaxEngine(JaxConfig(sampling=_jax_sampling(sampling),
                               spec_tokens=k, dtype=jnp.float32,
                               param_dtype=jnp.float32, **common),
                     devices=jax.devices()[:1])
    tree = convert.params_from_jax(jax.device_get(jeng.params), device="cpu")
    out = []
    for kk in (k, 0):
        eng = TutoringEngine(EngineConfig(
            sampling=sampling, spec_tokens=kk, dtype=torch.float32,
            param_dtype=torch.float32, device="cpu", fused_attention=True,
            **common))
        eng.params = tree
        out.append(eng)
    return jeng, out[0], out[1]


@pytest.mark.parametrize("k,opts", [
    (4, {}), (1, {}), (3, dict(quant="int8", kv_quant=True)),
])
def test_engine_spec_answers_equal_jax_and_plain(k, opts):
    sp = SamplingParams.greedy(max_new_tokens=12, repetition_penalty=1.2)
    jeng, peng, plain = _engines(sp, k, **opts)
    want = jeng.answer_batch(PROMPTS)
    assert peng.answer_batch(PROMPTS) == want == plain.answer_batch(PROMPTS)
    assert peng.last_spec_tokens_per_window == pytest.approx(
        jeng.last_spec_tokens_per_window, abs=1e-9)
    assert 0.0 < peng.last_spec_tokens_per_window <= k + 1
    assert peng.decode_steps < plain.decode_steps


def test_engine_reports_tokens_per_window_and_counts_windows():
    eng = TutoringEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=12),
        length_buckets=(16,), batch_buckets=(1,), spec_tokens=4,
        dtype=torch.float32, param_dtype=torch.float32, device="cpu"))
    assert eng.last_spec_tokens_per_window is None
    eng.answer_batch(["the the the the"])
    tpw = eng.last_spec_tokens_per_window
    assert tpw is not None and 1.0 <= tpw <= 5.0
    assert eng.decode_steps == pytest.approx(11 / tpw)


def test_warmup_caps_the_bucket_inside_the_position_budget():
    """tiny's table is 64: bucket 48 + 16 new + k 4 - 1 would not fit, so
    warmup and encode_prompts cap the bucket at 64 - 16 - 3."""
    eng = TutoringEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=16),
        length_buckets=(48,), batch_buckets=(1,), spec_tokens=4,
        dtype=torch.float32, param_dtype=torch.float32, device="cpu"))
    assert eng._max_prompt_len() == 64 - 16 - 3
    eng.warmup(batch=1)
    assert len(eng.answer_batch(["a question after warmup " * 8])) == 1


def test_engine_refuses_the_ngram_drafter():
    with pytest.raises(ValueError, match="paged-engine feature"):
        TutoringEngine(EngineConfig(model="tiny", spec_tokens=2,
                                    draft_source="ngram", device="cpu"))


def test_spec_with_fused_attention_is_a_deliberate_difference():
    """The JAX engine refuses spec_tokens with fused_attention (its Pallas
    kernel takes one query row); the port attends through the kernel's
    window variant and takes both."""
    with pytest.raises(ValueError, match="spec_tokens"):
        JaxEngine(JaxConfig(model="tiny", spec_tokens=4,
                            fused_attention=True))
    eng = TutoringEngine(EngineConfig(
        model="tiny", spec_tokens=4, fused_attention=True, device="cpu",
        dtype=torch.float32, param_dtype=torch.float32,
        sampling=SamplingParams.greedy(max_new_tokens=4),
        length_buckets=(16,), batch_buckets=(1,)))
    assert eng.cfg.fused_decode_attention
    assert len(eng.answer_batch(["x"])) == 1


@pytest.mark.parametrize("fused", [True, False])
def test_spec_window_wider_than_the_kernel_is_refused(fused):
    """spec_tokens 16 is a 17-row verify window, one more than the kernel
    takes: with fused attention construction raises (no window may drop to
    the plain version); without it the engine builds."""
    conf = EngineConfig(model="tiny", spec_tokens=attention.MAX_WINDOW,
                        fused_attention=fused, device="cpu",
                        dtype=torch.float32, param_dtype=torch.float32,
                        sampling=SamplingParams.greedy(max_new_tokens=4),
                        length_buckets=(16,), batch_buckets=(1,))
    if fused:
        with pytest.raises(ValueError, match="exceeds the attention kernel"):
            TutoringEngine(conf)
    else:
        assert TutoringEngine(conf).cfg.fused_decode_attention is False
    edge = TutoringEngine(dataclasses.replace(
        conf, spec_tokens=attention.MAX_WINDOW - 1))
    assert edge.cfg.fused_decode_attention is fused


def test_batching_queue_reports_tokens_per_window():
    metrics = Metrics()
    engine = TutoringEngine(EngineConfig(
        model="tiny", sampling=SamplingParams.greedy(max_new_tokens=8),
        length_buckets=(16,), batch_buckets=(1, 2), spec_tokens=3,
        dtype=torch.float32, param_dtype=torch.float32, device="cpu"))

    async def run():
        q = BatchingQueue(engine, metrics=metrics)
        await q.start()
        try:
            return await asyncio.gather(*[q.submit(p) for p in PROMPTS[:2]])
        finally:
            await q.close()

    assert len(asyncio.run(run())) == 2
    tpw = metrics.snapshot()["gauges"]["spec_tokens_per_window"]
    assert tpw == engine.last_spec_tokens_per_window and 1.0 <= tpw <= 4.0


def test_seen_update_marks_only_emitted_tokens():
    """The verifier's seen set gains exactly the valid emissions."""
    logits = torch.zeros((2, 3, 10))
    logits[:, :, 4] = 5.0  # argmax 4 everywhere
    drafts = torch.tensor([[4, 6], [3, 4]])
    seen = torch.zeros((2, 10), dtype=torch.bool)
    emitted, valid, seen2, _ = draft.verify_window(
        None, logits, drafts, seen, torch.tensor([True, True]),
        SamplingParams.greedy(), eos_id=-1, pad_id=-1)
    assert emitted.tolist() == [[4, 4, -1], [4, -1, -1]]
    assert valid.sum(1).tolist() == [2, 1]
    assert torch.equal(seen2, seen_mask_from_ids(emitted, valid, 10))
