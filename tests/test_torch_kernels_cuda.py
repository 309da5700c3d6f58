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
import torch_threads  # noqa: F401 (caps torch's threads)

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


APPEND_SHAPES = [
    (16, 12, 384, 64, None), (8, 12, 160, 64, None),
    (16, 12, 1024, 64, None),           # two splits a row
    (16, 3, 384, 64, None),             # GQA, G = 4
    (2, 12, 384, 64, [1, 150]),         # four splits, two of them empty
    (4, 2, 200, 128, None), (4, 4, 96, 16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache,s,hkv,width,dh,lengths", [
    (q_dtype, cache, *shape)
    for q_dtype, cache in (("bfloat16", "int8"), ("bfloat16", "bfloat16"),
                           ("float32", "int8"), ("float32", "float32"))
    for shape in APPEND_SHAPES
    if cache != "int8" or shape[3] in port_attention.INT8_HEAD_DIMS])
def test_append_kernel_matches_plain(card, q_dtype, cache, s, hkv, width, dh,
                                     lengths):
    """The paged step's append kernel against its plain version on copies
    of one cache: q, k_new and v_new strided views of one qkv row, lengths
    spread over [1, width] with a dead slot at the width (it writes slot
    width - 1). The cache afterwards (int8 rows and scales, or float rows)
    equal byte for byte; the output row by row within the window tolerance
    (`sweep_attention.window_error`: a long row's outputs average down
    near 0.1, so a limit scaled by the call's largest output would pass a
    new key dropped there). A planted fault, the long rows' (over half the
    longest) new key left out of the fold, must fail that check: the
    attend-only kernel over their older keys gives what such a kernel
    would."""
    from distributed_lms_raft_llm_tpu_torch.models.common import quantize_kv

    rng = np.random.default_rng(s * width + dh + hkv)
    h, layers = 12, 4
    dt = getattr(torch, q_dtype)
    qkv = torch.from_numpy(rng.standard_normal(
        (s, 1, (h + 2 * hkv) * dh), np.float32)).to(card, dt)
    q = qkv[..., :h * dh].reshape(s, 1, h, dh).transpose(1, 2)
    k_new, v_new = (qkv[..., (h + i * hkv) * dh:(h + (i + 1) * hkv) * dh]
                    .reshape(s, 1, hkv, dh).transpose(1, 2) for i in (0, 1))
    full = [torch.from_numpy(rng.standard_normal(
        (layers, s, hkv, width + 8, dh), np.float32)).to(card)
        for _ in range(2)]
    if cache == "int8":
        (k, ks), (v, vs) = (quantize_kv(x) for x in full)
        mine = [k, v, ks, vs]
        variant = port_attention.APPEND_INT8KV
    else:
        mine = [x.to(dt) for x in full] + [None, None]
        variant = port_attention.APPEND
    theirs = [None if x is None else x.clone() for x in mine]
    lengths = torch.from_numpy(
        np.asarray(lengths, np.int32) if lengths is not None
        else _paged_lengths(rng, s, width)).to(card)

    def window(x):
        return None if x is None else x[..., :width, :] if x.dim() == 5 \
            else x[..., :width]

    want = port_attention.decode_attention_append_reference(
        q, k_new, v_new, *map(window, theirs[:2]), 2, lengths=lengths,
        k_scale=window(theirs[2]), v_scale=window(theirs[3]))
    before = dict(port_attention.launch_counts)
    got = port_attention.decode_attention_append(
        q, k_new, v_new, *map(window, mine[:2]), 2, lengths=lengths,
        k_scale=window(mine[2]), v_scale=window(mine[3]))
    torch.cuda.synchronize()
    delta = {n: port_attention.launch_counts[n] - before[n] for n in before}
    assert delta == {n: int(n == variant) for n in before}
    for a, b in zip(mine, theirs):
        assert a is None or torch.equal(a, b)
    assert torch.isfinite(got.float()).all()
    check = sweep_attention.window_error(got, want, q_dtype)
    assert check["ok"], check
    long = (lengths > lengths.max() // 2).to(lengths.dtype)
    dropped = port_attention.decode_attention(
        q, *map(window, mine[:2]), 2, lengths=lengths - long,
        k_scale=window(mine[2]), v_scale=window(mine[3]))
    assert not sweep_attention.window_error(dropped, want, q_dtype)["ok"]


@pytest.mark.cuda
def test_decode_graphs_keep_the_programmatic_launch(card):
    """Under capture the append kernel's launch attribute becomes one
    programmatic edge a launch in each decode chunk graph (behind the qkv
    product), and none in the admission graphs, which do not run it."""
    from distributed_lms_raft_llm_tpu_torch.engine import SamplingParams

    eng = _paged(SamplingParams.greedy(max_new_tokens=16), **DEPLOYMENT)
    eng.warmup()
    for decode, admission in eng._graphs.values():
        appends = decode.captured_launches()[port_attention.APPEND_INT8KV]
        assert appends == 12 * eng.chunk
        assert decode.programmatic_edges == appends
        assert admission.programmatic_edges == 0


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
    # The sweep's widest case: 16 slots at width 640 (two splits a
    # cluster); and a GQA window past one m16 tile (4 heads a KV head).
    (16, 12, 640, 64, False), (2, 3, 391, 64, True),
])
def test_window_kernel_matches_plain(card, dtype, atol, int8_cache, t, s,
                                     hkv, width, dh, with_bias):
    """The speculative verify window: t query rows a batch row, row b's
    query j seeing the keys before lengths[b] + j (one row's last query
    reaches the width), q strided as the model passes it, a window of a
    larger cache, a float or int8 cache, GQA (12 heads on 4 or 3 KV heads:
    3t or 4t rows a KV head, in up to four m16 tiles of one block in bf16,
    in blocks of at most 4 rows in float32), and the bucketed path's
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_cache", [False, True])
@pytest.mark.parametrize("width,t", [(384, 9), (640, 9), (384, 16),
                                     (640, 16)])
def test_window_rows_equal_single_row_calls(card, dtype, int8_cache, width,
                                            t):
    """Each row of a window equals the decode kernel called on that row
    alone with its own frontier (lengths + j): the window changes which
    rows share a key stream, not what a row sees. float32 (the CUDA-core
    window) to float32 rounding, 1e-5; bf16 (the tensor-core window, whose
    probabilities times vs are rounded to bf16 before P V, while the decode
    kernel keeps them in float32) row by row within 2e-2 of each row's
    largest output, phase 7's limit. Width 640 takes two splits a
    cluster."""
    rng = np.random.default_rng(11 + int8_cache + width + t)
    s, h, dh = 8, 12, 64
    dt = getattr(torch, dtype)
    shape = (12, s, h, width, dh)
    q = torch.from_numpy(rng.standard_normal((s, h, t, dh), np.float32)).to(
        card, dt)
    if int8_cache:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                .to(card) for _ in range(2))
        ks, vs = (torch.from_numpy(
            rng.uniform(0.001, 0.05, shape[:4]).astype(np.float32)).to(card)
            for _ in range(2))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(card, dt) for _ in range(2))
        scales = {}
    lengths = torch.from_numpy(_window_lengths(rng, s, width, t)).to(card)
    got = port_attention.decode_attention(q, k, v, 3, lengths=lengths,
                                          **scales)
    rows = torch.cat([port_attention.decode_attention(
        q[:, :, j:j + 1].contiguous(), k, v, 3, lengths=lengths + j,
        **scales) for j in range(t)], dim=2)
    torch.cuda.synchronize()
    if dtype == "float32":
        torch.testing.assert_close(got, rows, rtol=0, atol=1e-5)
    else:
        check = sweep_attention.window_error(got, rows, dtype)
        assert check["ok"], check


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


INT8_ROWS = [1, 15, 16, 17, 32, 100, 128, 256, 1024, 512, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", INT8_ROWS)
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_int8_matmul_matches_plain(card, dtype, m, k, n, transposed):
    """The weight-only int8 product against its plain version (the JAX
    expression) and against a float64 product, at decode (M = 1, 16),
    partial row tiles (15, 17, 100), the fused admission chunk (32),
    prefill (256), the relevance gate's rows (128 and 1,024: texts x
    length bucket) and the scoring tenant's (512 and 2,048: a quantum of 8
    texts at length buckets 64 and 256).
    float32, and the float32 logits of the transposed layout: the
    summation order over K differs (bf16 x int8 products are exact in
    float32 on the tensor cores), rtol 1e-5 with atol 1e-5 of the output's
    scale. bf16 dense: the
    plain version rounds to bf16 after the product, after the scale and
    after the bias, the kernel once at the end: up to about two bf16 ulps
    (rtol 1.6e-2, atol 1e-2 of the output's scale). bf16 x takes the
    tensor-core routes (mma.sync up to 16 rows, wgmma from
    WGMMA_MIN_ROWS), float32 x the CUDA-core route."""
    _check_int8_matmul(card, dtype, m, k, n, transposed)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [17, 32, 100, 256, 2048])
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_replaced_int8_route_matches_plain(card, m, k, n, transposed):
    """The mma.sync route that bf16 x above 16 rows took before the wgmma
    route (`int8_matmul_replaced`, kept to be timed beside it) still
    matches its plain version with `test_int8_matmul_matches_plain`'s
    tolerances, and counts on the mma.sync routes."""
    _check_int8_matmul(card, "bfloat16", m, k, n, transposed, replaced=True)


# Llama-3-8B's products: wq and wo, wk and wv, wg and wu, wd, and the
# untied 128,256 x 4,096 unembedding; then deep shapes whose last ring item
# is partial: a down projection K of 14,336 + 16 (its last split's last box
# 16 rows) and a table of K = 4,096 + 64 (its last chunk 64 deep) whose
# last tile holds one row.
LLAMA_PRODUCTS = [(4096, 4096, False), (4096, 1024, False),
                  (4096, 14336, False), (14336, 4096, False),
                  (4096, 128256, True), (14352, 256, False),
                  (4160, 129, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 16, 17, 32, 100, 512, 2048])
@pytest.mark.parametrize("k,n,transposed", LLAMA_PRODUCTS)
def test_int8_matmul_matches_plain_at_llama_shapes(card, dtype, m, k, n,
                                                   transposed):
    """`test_int8_matmul_matches_plain` at Llama-3-8B's products: decode
    (M = 1, 16), the admission chunk (32), a partial row tile (17, 100) and
    the scoring quanta (512, 2,048), through the deep-K plans (`x_staged`:
    the down projection beyond M = 16, the unembedding at every M) and the
    whole-split ones; the same tolerances."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    if dtype == "bfloat16" and (k, n) in ((14336, 4096), (4096, 128256)):
        plan = quant_matmul.launch_plan(m, k, n, transposed)
        assert plan.x_staged == (transposed or m > 16)
    _check_int8_matmul(card, dtype, m, k, n, transposed)


def _check_int8_matmul(card, dtype, m, k, n, transposed, replaced=False):
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul as qm

    x, q, s, b = _int8_inputs(card, dtype, m, k, n, transposed, m * 7 + n)
    wgmma = dtype == "bfloat16" and qm.uses_wgmma(m) and not replaced
    route = (qm.FMA if dtype == "float32" else
             (qm.WGMMA_UNEMBED if transposed else qm.WGMMA) if wgmma else
             qm.MMA_UNEMBED if transposed else qm.MMA)
    before = dict(qm.launch_counts)
    call = qm.int8_matmul_replaced if replaced else qm.int8_matmul
    got = call(x, q, s, b, transposed=transposed)
    want = qm.int8_matmul_reference(x, q, s, b, transposed)
    torch.cuda.synchronize()
    counts = qm.launch_counts
    assert {name: counts[name] - before[name] for name in counts} == {
        name: int(name in (qm.KERNEL, route)) for name in counts}
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
@pytest.mark.parametrize("m", [16] + [m for m in INT8_ROWS if m > 16])
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_int8_matmul_is_deterministic(card, m, k, n, transposed):
    """Two calls on the same inputs are bit-equal (the K splits are summed
    in rank order, no atomics): greedy answers cannot drift between runs.
    Decode's mma.sync tile and the wgmma route at every M it takes."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    x, q, s, b = _int8_inputs(card, "bfloat16", m, k, n, transposed, n + m)
    first = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    second = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# gpt2-moe's expert products (E = 8, wi 768 -> 3,072, wo 3,072 -> 768) at
# its capacities: C = 5 (decode, 16 slots), 10 (a 32-token admission
# chunk), 80 (a 256-token prefill), 640 (a scoring quantum of 8 x 256);
# then ragged shapes: C = 17 (a partial 64-row tile), 3 experts, K and N
# not multiples of 128.
EXPERT_PRODUCTS = [(8, 768, 3072), (8, 3072, 768), (3, 144, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c", [5, 10, 17, 80, 640])
@pytest.mark.parametrize("e,k,n", EXPERT_PRODUCTS)
def test_int8_matmul_experts_matches_plain(card, dtype, c, e, k, n):
    """The expert layout against its plain version and a float64 product,
    expert by expert, in one launch on the expert route of x's dtype;
    the tolerances of `test_int8_matmul_matches_plain` (bf16: the plain
    version rounds after the product, the scale and the bias, the kernel
    once), bit-equal run to run. Each expert's rows come from its own
    slice: a kernel that mixed experts up would fail against the float64
    product. bf16 C = 5 and 10 (decode, an admission chunk) take the
    mma.sync expert route, C = 17, 80 and 640 the wgmma one."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    rng = np.random.default_rng(e * c + n)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((e, c, k), np.float32)).to(
        card, dt)
    q = torch.from_numpy(rng.integers(-127, 128, (e, k, n), np.int8)).to(card)
    s = torch.from_numpy(rng.uniform(1e-4, 1e-3, (e, n)).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((e, n), np.float32)).to(card, dt)
    route = (quant_matmul.FMA_EXPERTS if dtype == "float32"
             else quant_matmul.WGMMA_EXPERTS if quant_matmul.uses_wgmma(c)
             else quant_matmul.MMA_EXPERTS)
    before = dict(quant_matmul.launch_counts)
    got = quant_matmul.int8_matmul_experts(x, q, s, b)
    again = quant_matmul.int8_matmul_experts(x, q, s, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    delta = {name: quant_matmul.launch_counts[name] - before[name]
             for name in before}
    assert delta == {name: 2 * int(name in (quant_matmul.KERNEL, route))
                     for name in before}
    want = quant_matmul.int8_matmul_experts_reference(x, q, s, b)
    exact = (torch.bmm(x.double(), q.double()) * s.double()[:, None, :]
             + b.double()[:, None, :])
    assert got.shape == (e, c, n) and got.dtype == x.dtype
    for i in range(e):
        scale = exact[i].abs().max().item()
        tol = (dict(rtol=1e-5, atol=1e-5 * scale) if dtype == "float32"
               else dict(rtol=1.6e-2, atol=1e-2 * scale))
        torch.testing.assert_close(got[i].double(), want[i].double(), **tol)
        torch.testing.assert_close(got[i].double(), exact[i], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [17, 80, 640])
@pytest.mark.parametrize("e,k,n", EXPERT_PRODUCTS)
def test_replaced_expert_route_matches_plain(card, c, e, k, n):
    """The mma.sync expert route the wgmma one replaced above 16 rows an
    expert (`int8_matmul_replaced(..., experts=True)`) still matches the
    plain version, bf16, with the tolerances above."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    rng = np.random.default_rng(e * c + n + 1)
    x = torch.from_numpy(rng.standard_normal((e, c, k), np.float32)).to(
        card, torch.bfloat16)
    q = torch.from_numpy(rng.integers(-127, 128, (e, k, n), np.int8)).to(card)
    s = torch.from_numpy(rng.uniform(1e-4, 1e-3, (e, n)).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((e, n), np.float32)).to(
        card, torch.bfloat16)
    before = quant_matmul.launch_counts[quant_matmul.MMA_EXPERTS]
    got = quant_matmul.int8_matmul_replaced(x, q, s, b, experts=True)
    torch.cuda.synchronize()
    assert quant_matmul.launch_counts[quant_matmul.MMA_EXPERTS] == before + 1
    want = quant_matmul.int8_matmul_experts_reference(x, q, s, b)
    for i in range(e):
        scale = want[i].float().abs().max().item()
        torch.testing.assert_close(got[i].double(), want[i].double(),
                                   rtol=1.6e-2, atol=1e-2 * scale)


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_its_plain_version(card):
    """gpt2-moe's expert layer at full width (one layer, 16 decode rows
    and a 32-row admission chunk), int8 experts: the kernels' layer
    against the same layer with the plain expert product, in float32
    (summation order only) and bf16 (the products' rounding, relative to
    the output's scale); two expert launches a call."""
    from distributed_lms_raft_llm_tpu_torch.models import moe, quant
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        cfg = moe.GPT2MoEConfig.moe_small(num_layers=1, vocab_size=512,
                                          dtype=dtype, param_dtype=dtype)
        params = quant.quantize_params(
            moe.init_params(cfg, seed=3, device="cuda"), "gpt2_moe")
        mp = {k: ({kk: vv[0] for kk, vv in v.items()}
                  if isinstance(v, dict) else v[0])
              for k, v in params["blocks"]["moe"].items()}
        for rows in (16, 32):
            h = torch.randn((1, rows, 768), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                rows)).to(dtype)
            before = quant_matmul.launch_counts[quant_matmul.KERNEL]
            got = moe.moe_mlp(h, mp, cfg)
            assert quant_matmul.launch_counts[quant_matmul.KERNEL] == \
                before + 2
            kernel = quant_matmul.int8_matmul_experts
            quant_matmul.int8_matmul_experts = (
                quant_matmul.int8_matmul_experts_reference)
            try:
                want = moe.moe_mlp(h, mp, cfg)
            finally:
                quant_matmul.int8_matmul_experts = kernel
            torch.cuda.synchronize()
            scale = want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= (
                tol * scale)


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
    float32; the int8 gate runs 48 int8 products a forward on the wgmma
    route, the others none."""
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
        # a forward's rows (texts x length bucket) are 64 or more: the
        # wgmma route
        mma = quant_matmul.launch_counts[quant_matmul.WGMMA]
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
    assert per_decode[port_attention.APPEND_INT8KV] == 12 * eng.chunk
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
            "decode_attention": 0,
            "decode_attention_append": 12 * eng.chunk,
            "decode_attention_window": 0,
            "int8_matmul_mma": 48 * eng.chunk,
            "int8_matmul_mma_unembed": eng.chunk, "int8_matmul_fma": 0,
            "int8_matmul_mma_experts": 0, "int8_matmul_fma_experts": 0,
            "int8_matmul_wgmma": 0, "int8_matmul_wgmma_unembed": 0,
            "int8_matmul_wgmma_experts": 0}


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
