"""The port's CUDA kernels against their plain versions, on the card, and
the paged engine's CUDA graphs against its eager chunks.

Marked `cuda`: each test skips where there is no NVIDIA GPU (the fixture
decides, at run time). Imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from distributed_lms_raft_llm_tpu_torch.ops import attention as port_attention
from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("b,h,hkv,s,s_alloc", [
    (1, 12, 12, 64, 64), (8, 12, 12, 384, 384), (8, 12, 4, 300, 384),
    (2, 12, 12, 320, 384), (4, 12, 12, 33, 64), (8, 12, 12, 1024, 1024),
    (1, 12, 12, 1024, 1024),
])
def test_kernel_matches_plain_on_the_card(card, dtype, atol, b, h, hkv, s,
                                          s_alloc):
    """The CUDA kernel against its plain version at GPT-2-small widths, on
    a window of a larger cache, with left padding. Tolerances: bf16 rounds
    the plain version's probabilities before the weighted sum, the kernel
    keeps them in float32; in float32 only the summation order differs."""
    rng = np.random.default_rng(b * s + hkv)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, h, 1, 64), np.float32))
    kv = rng.standard_normal((2, 12, b, hkv, s_alloc, 64), np.float32)
    k, v = (torch.from_numpy(x).to(card, dt)[:, :, :, :s] for x in kv)
    mask = np.ones((b, 1, 1, s), bool)
    for row, pad in enumerate(rng.integers(0, s, size=b)):
        mask[row, ..., :pad] = False  # ragged left padding
    bias = port_attention.mask_to_bias(torch.from_numpy(mask).to(card))
    q = q.to(card, dt)
    before = port_attention.launch_counts[port_attention.KERNEL]
    got = port_attention.decode_attention(q, k, v, 7, bias)
    want = port_attention.decode_attention_reference(q, k, v, 7, bias)
    torch.cuda.synchronize()
    assert port_attention.launch_counts[port_attention.KERNEL] == before + 1
    assert got.dtype == dt and got.shape == (b, h, 1, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("b,s", [(1, 384), (2, 320), (4, 384), (8, 1024)])
def test_strided_q_and_fully_masked_leading_splits(card, dtype, atol, b, s):
    """q as the model passes it (a view of the fused qkv projection, read in
    place) against a cache where every row but the first pads all its
    slots but the last: every split of those rows but the last is fully
    masked and must weigh exactly nothing."""
    h, dh = 12, 64
    rng = np.random.default_rng(b + s)
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(
        rng.standard_normal((b, 1, 3 * h * dh), np.float32)).to(card, dt)
    q = qkv[..., :h * dh].reshape(b, 1, h, dh).transpose(1, 2)
    assert q.stride(1) == dh and (b == 1 or q.stride(0) == 3 * h * dh)
    kv = rng.standard_normal((2, 12, b, h, s, dh), np.float32)
    k, v = (torch.from_numpy(x).to(card, dt) for x in kv)
    mask = np.ones((b, 1, 1, s), bool)
    mask[1:, ..., :s - 1] = False
    bias = port_attention.mask_to_bias(torch.from_numpy(mask).to(card))
    plan = port_attention.launch_plan(b, h, s, dh, dt)
    assert plan.n_split > 1
    got = port_attention.decode_attention(q, k, v, 3, bias)
    want = port_attention.decode_attention_reference(q.contiguous(), k, v, 3,
                                                     bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    # a fully padded row attends to its last slot alone: out == V[last]
    torch.testing.assert_close(got[1:, :, 0].float(),
                               v[3, 1:, :, s - 1].float(), rtol=0, atol=atol)



def _paged_lengths(rng, s, width):
    """Per-row key counts spread over [1, width]: one row at 1, one at the
    full width."""
    lengths = rng.integers(1, width + 1, size=s)
    lengths[0], lengths[-1] = 1, width
    return lengths.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("s,width,s_alloc", [
    (8, 160, 384), (16, 384, 384), (16, 160, 384),
    # two rows split four ways: the short row's later splits are empty
    (2, 384, 384),
])
def test_ragged_and_int8_kernel_matches_plain(card, dtype, atol, int8_cache,
                                              s, width, s_alloc):
    """The paged engine's decode step: per-row lengths (keys past them are
    neither copied nor read), no bias, a window of the preallocated cache,
    a float or int8 cache with per-slot scales; q strided as the model
    passes it. Tolerances as above, relative to the output's largest
    magnitude where the dequantized values exceed 1: the plain version
    rounds its probabilities (times the value scales) to q's dtype, the
    kernel keeps them in float32."""
    rng = np.random.default_rng(s * width + int8_cache)
    h, dh, layers = 12, 64, 12
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(
        rng.standard_normal((s, 1, 3 * h * dh), np.float32)).to(card, dt)
    q = qkv[..., :h * dh].reshape(s, 1, h, dh).transpose(1, 2)
    shape = (layers, s, h, s_alloc, dh)
    if int8_cache:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                .to(card) for _ in range(2))
        ks, vs = (torch.from_numpy(
            rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)).to(card)
            for _ in range(2))
        scales = dict(k_scale=ks[..., :width], v_scale=vs[..., :width])
        variant = port_attention.INT8KV
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(card, dt) for _ in range(2))
        scales = {}
        variant = port_attention.RAGGED
    k, v = k[:, :, :, :width], v[:, :, :, :width]
    lengths = torch.from_numpy(_paged_lengths(rng, s, width)).to(card)
    before = port_attention.launch_counts[variant]
    got = port_attention.decode_attention(q, k, v, 5, None, lengths=lengths,
                                          **scales)
    want = port_attention.decode_attention_reference(
        q, k, v, 5, None, lengths, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    assert port_attention.launch_counts[variant] == before + 1
    assert torch.isfinite(got.float()).all()
    atol *= max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_int8_kernel_with_bias_matches_plain(card, dtype, atol):
    """The bucketed engine with an int8 cache: left-padding bias, scalar
    offset, no lengths. Tolerance relative to the output's largest
    magnitude, as in the ragged test."""
    rng = np.random.default_rng(7)
    b, h, dh, s = 8, 12, 64, 320
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, h, 1, dh), np.float32)).to(
        card, dt)
    k, v = (torch.from_numpy(rng.integers(-127, 128, (12, b, h, s, dh),
                                          np.int8)).to(card) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.05, (12, b, h, s))
                               .astype(np.float32)).to(card)
              for _ in range(2))
    mask = np.ones((b, 1, 1, s), bool)
    for row, pad in enumerate(rng.integers(0, s, size=b)):
        mask[row, ..., :pad] = False
    bias = port_attention.mask_to_bias(torch.from_numpy(mask).to(card))
    got = port_attention.decode_attention(q, k, v, 2, bias, k_scale=ks,
                                          v_scale=vs)
    want = port_attention.decode_attention_reference(q, k, v, 2, bias, None,
                                                     ks, vs)
    torch.cuda.synchronize()
    atol *= max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _window_lengths(rng, s, width, t):
    """Per-row offsets + 1 of a verify window of t rows: one row at 1, one
    whose last query sees the full width, the rest between."""
    lengths = rng.integers(1, width - t + 2, size=s)
    lengths[0], lengths[-1] = 1, width - t + 1
    return lengths.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("t", [2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("s,hkv,width,dh,with_bias", [
    (16, 12, 384, 64, False), (8, 12, 640, 64, False),
    (8, 12, 384, 64, True), (4, 4, 384, 64, False), (4, 12, 320, 128, True),
    # The deployment's paged widths at spec 8 (167 and 391 of 167, 199,
    # 263, 391) and the bucketed engine's (bucket 256 + 32 + 8 - 1).
    (16, 12, 167, 64, False), (16, 12, 391, 64, False),
    (8, 12, 295, 64, True),
])
def test_window_kernel_matches_plain(card, dtype, atol, int8_cache, t, s,
                                     hkv, width, dh, with_bias):
    """The speculative verify window: t query rows a batch row, row b's
    query j seeing the keys before lengths[b] + j (one row's last query
    reaches the width), q strided as the model passes it, a window of a
    larger cache, a float or int8 cache, GQA (12 heads on 4 KV heads: 3t
    rows a KV head, cut into blocks of at most 4), and the bucketed path's
    shared pad bias. Each query row is held to its own largest output
    (`sweep_attention.window_error`): a limit scaled by the call's largest
    output, a one-key row's raw v, would pass a long row's frontier one
    key off. Tolerances as in the ragged test, per row."""
    rng = np.random.default_rng(s * width + t * 7 + int8_cache)
    h, layers, s_alloc = 12, 12, width + 64
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(
        rng.standard_normal((s, t, 3 * h * dh), np.float32)).to(card, dt)
    q = qkv[..., :h * dh].reshape(s, t, h, dh).transpose(1, 2)
    shape = (layers, s, hkv, s_alloc, dh)
    if int8_cache:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                .to(card) for _ in range(2))
        ks, vs = (torch.from_numpy(
            rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)).to(card)
            for _ in range(2))
        scales = dict(k_scale=ks[..., :width], v_scale=vs[..., :width])
        variant = port_attention.WINDOW_INT8KV
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(card, dt) for _ in range(2))
        scales = {}
        variant = port_attention.WINDOW
    k, v = k[:, :, :, :width], v[:, :, :, :width]
    lengths = torch.from_numpy(_window_lengths(rng, s, width, t)).to(card)
    bias = None
    if with_bias:  # left padding below each row's first real slot
        mask = np.ones((s, 1, 1, width), bool)
        for row, n in enumerate(lengths.cpu().numpy()):
            mask[row, ..., :rng.integers(0, n)] = False
        bias = port_attention.mask_to_bias(torch.from_numpy(mask).to(card))
    before = dict(port_attention.launch_counts)
    got = port_attention.decode_attention(q, k, v, 5, bias, lengths=lengths,
                                          **scales)
    want = port_attention.decode_attention_reference(
        q, k, v, 5, bias, lengths, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in
            port_attention.launch_counts.items()} == {
        n: int(n == variant) for n in before}
    assert got.shape == (s, h, t, dh) and torch.isfinite(got.float()).all()
    check = sweep_attention.window_error(got, want, dtype)
    assert check["max_row_rel_err"] <= atol, check


@pytest.mark.cuda
@pytest.mark.parametrize("int8_cache", [False, True])
def test_window_rows_equal_single_row_calls(card, int8_cache):
    """Each row of a window equals the decode kernel called on that row
    alone with its own frontier (lengths + j), to float32 rounding: the
    window changes which rows share a key stream, not what a row sees."""
    rng = np.random.default_rng(11 + int8_cache)
    s, h, dh, width, t = 8, 12, 64, 384, 9
    shape = (12, s, h, width, dh)
    q = torch.from_numpy(rng.standard_normal((s, h, t, dh), np.float32)).to(
        card)
    if int8_cache:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                .to(card) for _ in range(2))
        ks, vs = (torch.from_numpy(
            rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)).to(card)
            for _ in range(2))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(card) for _ in range(2))
        scales = {}
    lengths = torch.from_numpy(_window_lengths(rng, s, width, t)).to(card)
    got = port_attention.decode_attention(q, k, v, 3, lengths=lengths,
                                          **scales)
    for j in range(t):
        one = port_attention.decode_attention(
            q[:, :, j:j + 1].contiguous(), k, v, 3, lengths=lengths + j,
            **scales)
        torch.testing.assert_close(got[:, :, j:j + 1], one, rtol=0,
                                   atol=1e-5)


# The GPT-2-small products of the int8 path: (K, N, transposed), and a
# table whose last 64-row tile holds a single row.
INT8_PRODUCTS = [(768, 2304, False), (768, 3072, False), (768, 768, False),
                 (3072, 768, False), (768, 50257, True), (768, 129, True)]


def _int8_inputs(card, dtype, m, k, n, transposed, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(card, dt)
    shape = (n, k) if transposed else (k, n)
    q = torch.from_numpy(rng.integers(-127, 128, shape, np.int8)).to(card)
    s = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(
        card)
    b = None if transposed else torch.from_numpy(
        rng.standard_normal(n, np.float32)).to(card, dt)
    return x, q, s, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 32, 100, 128, 256, 1024])
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_int8_matmul_matches_plain(card, dtype, m, k, n, transposed):
    """The weight-only int8 product against its plain version (the JAX
    expression) and against a float64 product, at decode (M = 1, 16),
    partial row tiles (15, 17, 100), the fused admission chunk (32: one
    64-row tile, half filled), prefill (256) and the relevance gate's
    rows (128 and 1,024: texts x length bucket). float32, and the
    float32 logits of the transposed layout: the summation order over K
    differs (bf16 x int8 products are exact in float32 on the tensor
    cores), rtol 1e-5 with atol 1e-5 of the output's scale. bf16 dense: the
    plain version rounds to bf16 after the product, after the scale and
    after the bias, the kernel once at the end: up to about two bf16 ulps
    (rtol 1.6e-2, atol 1e-2 of the output's scale). bf16 x takes the
    tensor-core route, float32 x the CUDA-core route."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    x, q, s, b = _int8_inputs(card, dtype, m, k, n, transposed, m * 7 + n)
    route = (quant_matmul.FMA if dtype == "float32" else
             quant_matmul.MMA_UNEMBED if transposed else quant_matmul.MMA)
    before = dict(quant_matmul.launch_counts)
    got = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    want = quant_matmul.int8_matmul_reference(x, q, s, b, transposed)
    torch.cuda.synchronize()
    counts = quant_matmul.launch_counts
    assert counts[quant_matmul.KERNEL] == before[quant_matmul.KERNEL] + 1
    assert {name: counts[name] - before[name]
            for name in (quant_matmul.MMA, quant_matmul.MMA_UNEMBED,
                         quant_matmul.FMA)} == {
        name: int(name == route) for name in (
            quant_matmul.MMA, quant_matmul.MMA_UNEMBED, quant_matmul.FMA)}
    assert got.dtype == (torch.float32 if transposed else x.dtype)
    assert got.shape == (m, n)
    w = q.double().t() if transposed else q.double()
    exact = (x.double() @ w) * s.double() + (0 if b is None else b.double())
    scale = exact.abs().max().item()
    if dtype == "float32" or transposed:
        tol = dict(rtol=1e-5, atol=1e-5 * scale)
    else:
        tol = dict(rtol=1.6e-2, atol=1e-2 * scale)
    torch.testing.assert_close(got.double(), want.double(), **tol)
    torch.testing.assert_close(got.double(), exact, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 256])
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_int8_matmul_is_deterministic(card, m, k, n, transposed):
    """Two calls on the same inputs are bit-equal (the K splits are summed
    in rank order, no atomics): greedy answers cannot drift between runs."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    x, q, s, b = _int8_inputs(card, "bfloat16", m, k, n, transposed, n + m)
    first = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    second = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ------------------------------------------------ the relevance gate

GATE_PAIRS = [("How does Raft elect a leader?",
               "Raft elects a leader by majority vote for each term. " * k)
              for k in (1, 3, 8, 12)] + [("What is a heap?", "")]


@pytest.mark.cuda
def test_bf16_and_int8_gates_track_the_float32_gate(card):
    """The relevance gate at bert-base width on the card (seeded random
    weights, byte tokenizer): bf16 similarities within 2e-2 of float32's
    (`chip_smoke.py`'s bf16 tolerance), the int8 gate's within 0.05 (the
    JAX package's bound), a cache hit within 1e-5 of the joint miss in
    float32; the int8 gate runs 48 tensor-core int8 products a forward,
    the others none."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig,
        RelevanceGate,
    )
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    gates = {name: RelevanceGate(GateConfig(dtype=dtype, quant=quant))
             for name, dtype, quant in (("f32", torch.float32, None),
                                        ("bf16", torch.bfloat16, None),
                                        ("int8", torch.bfloat16, "int8"))}
    sims = {}
    for name, gate in gates.items():
        quant_matmul.reset_launch_counts()
        before = gate.forwards
        sims[name] = [gate.check(q, c)[1] for q, c in GATE_PAIRS]
        mma = quant_matmul.launch_counts[quant_matmul.MMA]
        assert quant_matmul.launch_counts[quant_matmul.KERNEL] == mma
        assert mma == (48 * (gate.forwards - before) if name == "int8"
                       else 0)
    for f32, bf16, int8 in zip(sims["f32"], sims["bf16"], sims["int8"]):
        assert abs(bf16 - f32) <= 2e-2 and abs(int8 - f32) < 0.05
    gate = gates["f32"]
    query, ctx = GATE_PAIRS[2]
    emb = gate.embed_texts([query, ctx])
    joint = float(np.dot(emb[0], emb[1])
                  / (np.linalg.norm(emb[0]) * np.linalg.norm(emb[1])))
    gate._ctx_cache.clear()
    assert gate.check(query, ctx)[1] == pytest.approx(joint, abs=1e-5)
    assert gate.check(query, ctx)[1] == pytest.approx(joint, abs=1e-5)


# ------------------------------------- the paged engine's CUDA graphs

GRAPH_PROMPTS = ["What is a binary search tree?", "How does Raft elect a "
                 "leader?", "Explain recursion.", "What is a deadlock?",
                 "Course notes: logs, terms and votes. Why a majority?",
                 "Course notes: logs, terms and votes. What is a term?",
                 "What is a binary search tree?", "k"]
DEPLOYMENT = dict(megastep=4, megastep_max=8, prefix_cache=True,
                  prefix_cache_blocks=512, prefill_chunk_tokens=32)


def _paged(sampling, **kw):
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
    )

    cfg = EngineConfig(model="gpt2", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, quant="int8",
                       kv_quant=True, sampling=sampling,
                       length_buckets=(32, 64), device="cuda", seed=0)
    return PagedEngine(cfg, slots=8, chunk=4, inflight=3, **kw)


def _tokens(eng, prompts):
    """Each request's generated token ids, in submit order."""
    reqs = []
    for p in prompts:
        eng.submit(p)
        reqs.append(eng._pending[-1])
    eng.drain()
    return [list(r.tokens) for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("options", [dict(megastep=4, megastep_max=4),
                                     DEPLOYMENT], ids=["k4", "deployment"])
@pytest.mark.parametrize("greedy", [True, False])
def test_megastep_replays_equal_the_eager_chunks(card, options, greedy):
    """Graph replays of a megastep give the tokens that the same engine's
    chunks give run eagerly, greedy and seeded-sampled (the generator is
    registered with the graphs: each replay draws fresh numbers)."""
    from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams

    sampling = (SamplingParams.greedy(max_new_tokens=16) if greedy
                else SamplingParams.reference_defaults(max_new_tokens=16))
    graphs = _paged(sampling, **options)
    eager = _paged(sampling, cuda_graphs=False, **options)
    assert graphs.cuda_graphs and not eager.cuda_graphs
    graphs.warmup()
    eager.warmup()
    got = _tokens(graphs, GRAPH_PROMPTS)
    assert graphs.graph_replays > 0
    assert got == _tokens(eager, GRAPH_PROMPTS)
    if not greedy:  # the replays did not repeat the captured noise
        assert len({tuple(t) for t in got}) > 2


@pytest.mark.cuda
def test_replayed_launches_count_as_captured(card):
    """The launch counters after N replays grow by N times what the graph
    captured, and the capture itself adds nothing."""
    from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    eng = _paged(SamplingParams.greedy(max_new_tokens=16), **DEPLOYMENT)
    eng.warmup()
    decode, admission = eng._graphs[eng.widths[0]]
    per_decode = decode.captured_launches()
    assert per_decode[port_attention.INT8KV] == 12 * eng.chunk
    assert per_decode[quant_matmul.MMA] == 48 * eng.chunk
    assert per_decode[quant_matmul.MMA_UNEMBED] == eng.chunk
    assert admission.captured_launches()[quant_matmul.KERNEL] == 49
    before = {**port_attention.launch_counts, **quant_matmul.launch_counts}
    for _ in range(3):
        decode.replay()
        admission.replay()
    torch.cuda.synchronize()
    after = {**port_attention.launch_counts, **quant_matmul.launch_counts}
    want = {k: 3 * (per_decode.get(k, 0)
                    + admission.captured_launches().get(k, 0))
            for k in after}
    assert {k: after[k] - before[k] for k in after} == want


@pytest.mark.cuda
def test_graph_kernel_nodes_equal_the_captured_counts(card):
    """Each captured graph's kernel nodes, read back through the driver and
    counted by function name, are the launches its counters re-add per
    replay, route by route."""
    from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        kernel_nodes, routes_of_counts, routes_of_names)

    eng = _paged(SamplingParams.greedy(max_new_tokens=16), **DEPLOYMENT)
    eng.warmup()
    for decode, admission in eng._graphs.values():
        for graph in (decode, admission):
            nodes = routes_of_names(kernel_nodes(graph.graph))
            assert nodes == routes_of_counts(graph.captured_launches())
        assert routes_of_names(decode.kernels) == {
            "decode_attention": 12 * eng.chunk, "decode_attention_window": 0,
            "int8_matmul_mma": 48 * eng.chunk,
            "int8_matmul_mma_unembed": eng.chunk, "int8_matmul_fma": 0}


@pytest.mark.cuda
def test_reset_keeps_the_planes_the_graphs_read(card):
    """reset() and an idle width change zero the state planes in place: the
    graphs keep reading them, and answers after a reset equal an eager
    engine's."""
    from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams

    sampling = SamplingParams.greedy(max_new_tokens=16)
    eng = _paged(sampling, **DEPLOYMENT)
    eng.warmup()

    def pointers():
        s = eng.state
        return [x.data_ptr() for x in (
            s.cache.k, s.cache.v, s.cache.ks, s.cache.vs, s.cache.lengths,
            s.tok, s.active, s.seen, s.transcript, s.staged,
            s.stage_cursor, s.stage_len, s.stage_seq, s.stage_noise)]

    first = _tokens(eng, GRAPH_PROMPTS)
    before = pointers()
    eng.submit(GRAPH_PROMPTS[0])
    eng.step()
    eng.reset()
    assert pointers() == before
    assert _tokens(eng, GRAPH_PROMPTS[::-1]) == _tokens(
        _paged(sampling, cuda_graphs=False, **DEPLOYMENT),
        GRAPH_PROMPTS[::-1])
    assert first and pointers() == before
