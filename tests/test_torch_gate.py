"""The port's RelevanceGate against the JAX package's, on the CPU.

Both gates hold the same weights (the JAX gate's tree carried across with
`params_from_jax`) at the tiny width, under the byte fallback tokenizer,
with length buckets (32, 40, 48, 64) so the pairs land in each bucket as
the deployment's (64, 128, 256, 512) do at full width (a miss embeds the
question and the context in one batch: the longer picks the bucket). The
pairs are `chip_smoke.py`'s phase 6 cut to size: 8 questions against a
context for each bucket, one longer than the 64 positions (truncated, its
[SEP] dropped) and the empty context the LMS passes for an assignment
with no text.

Tolerances: float32 similarities within 1e-5 (summation order) with equal
decisions on every pair; bf16 within 2e-2 (`chip_smoke.py`'s bf16
tolerance); int8 against full precision within 0.05 (the JAX package's
bound, tests/test_quant.py); a cache hit within 1e-5 of the joint miss
(tests/test_quant.py).
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine.gate import (
    GateConfig as JaxGateConfig,
    RelevanceGate as JaxGate,
)
from distributed_lms_raft_llm_tpu_torch.engine import GateConfig, RelevanceGate
from distributed_lms_raft_llm_tpu_torch.engine import gate as gate_lib
from distributed_lms_raft_llm_tpu_torch.models import bert, convert

BUCKETS = (32, 40, 48, 64)
QUESTIONS = [
    "What is a binary search tree?",
    "How does Raft elect a leader?",
    "Explain the difference between a process and a thread.",
    "Why is quicksort O(n log n) on average?",
    "What does a hash table trade for constant-time lookup?",
    "How do I find a cycle in a linked list?",
    "What is dynamic programming?",
    "When should I use a heap instead of a sorted array?",
]
NOTES = ("Raft keeps a replicated log consistent across servers: a leader "
         "is elected by majority vote for a term, appends entries and "
         "replicates them to followers before they commit. ")
# One context per bucket (byte ids: a character is a token, plus [CLS] and
# [SEP]), one past the position table, and an empty one.
CONTEXTS = [NOTES[:10], NOTES[:36], NOTES[:44], NOTES[:60], NOTES * 2, ""]
PAIRS = [(q, c) for q in QUESTIONS for c in CONTEXTS]
F32_TOL = 1e-5


def _gates(dtype="float32", quant=None, threshold=0.6):
    jgate = JaxGate(JaxGateConfig(model="tiny", dtype=getattr(jnp, dtype),
                                  quant=quant, length_buckets=BUCKETS,
                                  threshold=threshold))
    gate = RelevanceGate(GateConfig(model="tiny", dtype=getattr(torch, dtype),
                                    quant=quant, length_buckets=BUCKETS,
                                    threshold=threshold, device="cpu"))
    gate.params = bert.cast_products(
        convert.params_from_jax(jax.device_get(jgate.params), device="cpu"),
        gate.cfg.dtype)
    return jgate, gate


@pytest.fixture(scope="module")
def f32_gates():
    return _gates()


@pytest.fixture(scope="module")
def jax_sims(f32_gates):
    jgate, _ = f32_gates
    return [jgate.check(q, c)[1] for q, c in PAIRS]


def test_pairs_land_in_every_bucket(f32_gates):
    _, gate = f32_gates
    widths = {gate._encode([q, c])[0].shape[1] for q, c in PAIRS}
    assert widths == set(BUCKETS)
    ids, mask = gate._encode([QUESTIONS[0], NOTES * 2])
    assert ids.shape == (2, 64) and int(mask[1].sum()) == 64
    assert ids[1, -1] != gate.tokenizer.sep_id  # truncated: [SEP] dropped


def test_similarities_and_decisions_equal_jax(f32_gates, jax_sims):
    _, gate = f32_gates
    sims = [gate.check(q, c)[1] for q, c in PAIRS]
    np.testing.assert_allclose(sims, jax_sims, atol=F32_TOL, rtol=0)
    # Random tiny weights put every similarity above 0.6; the median of
    # JAX's similarities splits the pairs into passes and refusals.
    for threshold in (0.6, float(np.median(jax_sims))):
        got = [s >= threshold for s in sims]
        want = [s >= threshold for s in jax_sims]
        assert got == want, threshold
    assert 0 < sum(s >= np.median(jax_sims) for s in sims) < len(sims)


def test_check_returns_python_values(f32_gates):
    _, gate = f32_gates
    passed, sim = gate.check(QUESTIONS[0], NOTES[:25])
    assert type(passed) is bool and type(sim) is float


def test_embed_texts_equals_jax(f32_gates):
    jgate, gate = f32_gates
    texts = QUESTIONS[:3] + CONTEXTS
    got = gate.embed_texts(texts)
    assert got.dtype == np.float32 and got.shape == (len(texts), 32)
    np.testing.assert_allclose(got, jgate.embed_texts(texts), atol=F32_TOL,
                               rtol=0)


def test_bf16_gate_matches_jax():
    jgate, gate = _gates("bfloat16")
    assert gate.params["blocks"]["mlp"]["wi"].dtype == torch.bfloat16
    assert gate.params["embeddings"]["word"].dtype == torch.float32
    for q, c in PAIRS[::5]:
        assert gate.check(q, c)[1] == pytest.approx(jgate.check(q, c)[1],
                                                    abs=2e-2)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", 2e-2)])
def test_int8_gate_matches_jax_and_full_precision(f32_gates, jax_sims, dtype,
                                                  tol):
    jgate, gate = _gates(dtype, quant="int8")
    assert gate.params["embeddings"]["word"]["q"].dtype == torch.int8
    for i, (q, c) in enumerate(PAIRS[::3]):
        sim = gate.check(q, c)[1]
        assert sim == pytest.approx(jgate.check(q, c)[1], abs=tol)
        assert abs(sim - jax_sims[3 * i]) < 0.05


def test_cache_hit_equals_the_joint_miss(f32_gates):
    """tests/test_quant.py's case: the cached path (query embedded alone,
    the context from the joint batch) reproduces the joint cosine, where
    the short query alone picks a narrower bucket than the context."""
    _, gate = f32_gates
    query, ctx = "short query", "a much longer assignment context " * 12
    emb = gate.embed_texts([query, ctx])
    joint = float(np.dot(emb[0], emb[1])
                  / (np.linalg.norm(emb[0]) * np.linalg.norm(emb[1])))
    gate._ctx_cache.clear()
    before = gate.forwards
    _, miss = gate.check(query, ctx)
    assert ctx in gate._ctx_cache and gate.forwards == before + 1
    _, hit = gate.check(query, ctx)
    assert gate.forwards == before + 2
    assert miss == pytest.approx(joint, abs=F32_TOL)
    assert hit == pytest.approx(joint, abs=F32_TOL)


def test_context_cache_is_cleared_wholesale_when_full(f32_gates):
    _, gate = f32_gates
    gate._ctx_cache.clear()
    for i in range(gate_lib.CONTEXT_CACHE_ENTRIES):
        gate.check("q", f"context {i}")
    assert len(gate._ctx_cache) == gate_lib.CONTEXT_CACHE_ENTRIES
    gate.check("q", "one more context")
    assert list(gate._ctx_cache) == ["one more context"]


def test_concurrent_checks_give_the_single_thread_answers(f32_gates):
    """8 threads check the pairs at once (the LMS's executor threads), with
    a short switch interval: each answer is the single-thread one (a hit
    or a miss, whichever the race gave, within 1e-5), and the cache holds
    each context once with its single-thread embedding."""
    _, gate = f32_gates
    pairs = PAIRS[:24]
    gate._ctx_cache.clear()
    want = {pair: gate.check(*pair) for pair in pairs}
    ctx_emb = {c: gate._ctx_cache[c] for _, c in pairs}
    gate._ctx_cache.clear()
    got, errors = {}, []
    lock = threading.Lock()

    def worker(k):
        try:
            for pair in pairs[3 * k:] + pairs[:3 * k]:  # rotated
                result = gate.check(*pair)
                with lock:
                    got.setdefault(pair, []).append(result)
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for pair, results in got.items():
        assert len(results) == 8  # one a thread
        for passed, sim in results:
            assert sim == pytest.approx(want[pair][1], abs=F32_TOL)
            assert passed == want[pair][0]
    assert set(gate._ctx_cache) == set(ctx_emb)
    for c, emb in gate._ctx_cache.items():
        np.testing.assert_allclose(emb, ctx_emb[c], atol=F32_TOL, rtol=0)


def test_warmup_runs_one_forward(f32_gates):
    _, gate = f32_gates
    before = gate.forwards
    gate.warmup()
    assert gate.forwards == before + 1


def test_tensor_parallel_is_refused():
    """tp is ported and runs one process a rank (tests/
    test_torch_gate_tp.py): without a process group of its ranks it is
    refused."""
    with pytest.raises(RuntimeError, match="tp=2"):
        RelevanceGate(GateConfig(model="tiny", tp=2, device="cpu"))


def test_unknown_quant_mode_is_refused():
    with pytest.raises(ValueError, match="quant"):
        RelevanceGate(GateConfig(model="tiny", quant="int4", device="cpu"))


def test_vocabulary_larger_than_the_model_is_refused(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"w{i}" for i in range(400)) + "\n")
    for make in (lambda: JaxGate(JaxGateConfig(model="tiny",
                                               vocab_path=str(vocab))),
                 lambda: RelevanceGate(GateConfig(
                     model="tiny", vocab_path=str(vocab), device="cpu"))):
        with pytest.raises(ValueError, match="vocab"):
            make()


def test_default_gate_needs_a_card(monkeypatch):
    """GateConfig() asks for the card: without one the gate raises, and
    never runs on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        RelevanceGate(GateConfig())
    assert GateConfig().device == "cuda"
    assert GateConfig().dtype == torch.bfloat16
    assert GateConfig().length_buckets == (64, 128, 256, 512)


def test_random_init_warns(caplog):
    with caplog.at_level("WARNING"):
        RelevanceGate(GateConfig(model="tiny", device="cpu"))
    assert "no BERT checkpoint configured" in caplog.text
