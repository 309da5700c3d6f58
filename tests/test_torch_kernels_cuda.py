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

