"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where there is no NVIDIA GPU (the fixture
decides, at run time). Imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from distributed_lms_raft_llm_tpu_torch.ops import attention as port_attention


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


# The GPT-2-small products of the int8 path: (K, N, transposed).
INT8_PRODUCTS = [(768, 2304, False), (768, 3072, False), (768, 768, False),
                 (3072, 768, False), (768, 50257, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 16, 256])
@pytest.mark.parametrize("k,n,transposed", INT8_PRODUCTS)
def test_int8_matmul_matches_plain(card, dtype, m, k, n, transposed):
    """The weight-only int8 product against its plain version (the JAX
    expression) and against a float64 product. float32: the summation
    order over K differs, rtol 1e-5 with atol 1e-5 of the output's scale.
    bf16: the plain version rounds to bf16 after the product, after the
    scale and after the bias, the kernel once at the end: up to about two
    bf16 ulps (rtol 1.6e-2, atol 1e-2 of the output's scale)."""
    from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

    rng = np.random.default_rng(m * 7 + n)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(card, dt)
    shape = (n, k) if transposed else (k, n)
    q = torch.from_numpy(rng.integers(-127, 128, shape, np.int8)).to(card)
    s = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(
        card)
    b = None if transposed else torch.from_numpy(
        rng.standard_normal(n, np.float32)).to(card, dt)
    before = quant_matmul.launch_counts[quant_matmul.KERNEL]
    got = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    want = quant_matmul.int8_matmul_reference(x, q, s, b, transposed)
    torch.cuda.synchronize()
    assert quant_matmul.launch_counts[quant_matmul.KERNEL] == before + 1
    assert got.dtype == (torch.float32 if transposed else dt)
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
