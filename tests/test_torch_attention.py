"""Decode attention of the PyTorch port against the JAX package.

The port's plain version (`decode_attention_reference`) and `mask_to_bias`
are held against the JAX Pallas kernel, run in interpret mode on the CPU,
and against `common.attend` on the indexed layer. The CUDA kernel itself
runs only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py);
here its wrapper's dispatch is checked: CPU tensors take the plain version,
CUDA tensors never do.
"""

import ast
import functools
import inspect
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu_torch.ops import attention as port_attention

L, LAYER, H, S, DH = 3, 1, 4, 16, 8


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernel in interpret mode on the CPU."""
    orig = jax_attention.pl.pallas_call
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _inputs(b, hkv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, 1, DH)).astype(np.float32)
    k = rng.standard_normal((L, b, hkv, S, DH)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, S, DH)).astype(np.float32)
    mask = rng.random((b, 1, 1, S)) < 0.6
    mask[..., 0] = True  # every row keeps one valid key
    return q, k, v, mask


CASES = [(b, hkv) for b in (1, 3) for hkv in (4, 2)]


@pytest.mark.parametrize("b,hkv", CASES)
def test_reference_matches_pallas_kernel(pallas_interpret, b, hkv):
    q, k, v, mask = _inputs(b, hkv, seed=10 * b + hkv)
    want = jax_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LAYER, jnp.int32),
        jax_attention.mask_to_bias(jnp.asarray(mask)),
    )
    bias = port_attention.mask_to_bias(torch.from_numpy(mask))
    got = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        LAYER, bias,
    )
    assert got.shape == (b, H, 1, DH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("b,hkv", CASES)
def test_reference_matches_common_attend(b, hkv):
    q, k, v, mask = _inputs(b, hkv, seed=100 + 10 * b + hkv)
    kl = jax_common.repeat_kv(jnp.asarray(k[LAYER]), H // hkv)
    vl = jax_common.repeat_kv(jnp.asarray(v[LAYER]), H // hkv)
    want = jax_common.attend(jnp.asarray(q), kl, vl, jnp.asarray(mask))
    got = port_attention.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), LAYER,
        port_attention.mask_to_bias(torch.from_numpy(mask)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("b", [1, 3])
def test_mask_to_bias_matches_jax(b):
    _, _, _, mask = _inputs(b, 4, seed=b)
    want = np.asarray(jax_attention.mask_to_bias(jnp.asarray(mask)))
    got = port_attention.mask_to_bias(torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 1, S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_reads_a_window_of_a_larger_cache():
    """A view over the first S slots of a bigger cache (the engine's decode
    window) attends exactly like a cache of S slots."""
    q, k, v, mask = _inputs(2, 2, seed=7)
    big_k = np.zeros((L, 2, 2, 2 * S, DH), np.float32)
    big_v = np.zeros_like(big_k)
    big_k[:, :, :, :S] = k
    big_v[:, :, :, :S] = v
    bias = port_attention.mask_to_bias(torch.from_numpy(mask))
    window = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(big_k)[:, :, :, :S],
        torch.from_numpy(big_v)[:, :, :, :S], LAYER, bias,
    )
    exact = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        LAYER, bias,
    )
    torch.testing.assert_close(window, exact, rtol=0, atol=0)
    assert port_attention._slot_stride(torch.from_numpy(big_k)[:, :, :, :S]) \
        == 2 * S


@pytest.mark.parametrize("layer", [-1, L])
def test_layer_index_is_checked_not_clamped(layer):
    q, k, v, mask = _inputs(1, 4, seed=3)
    bias = port_attention.mask_to_bias(torch.from_numpy(mask))
    with pytest.raises(IndexError):
        port_attention.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            layer, bias,
        )


# ------------------------------------------------------------ dispatch


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's
    dispatch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(x))


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    calls = []

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    def fake_launch(q, k_cache, v_cache, layer, bias):
        calls.append(layer)
        return "launched"

    monkeypatch.setattr(port_attention, "decode_attention_reference", no_plain)
    monkeypatch.setattr(port_attention, "_launch_kernel", fake_launch)
    q, k, v, mask = _inputs(1, 4, seed=5)
    bias = np.where(mask[:, 0, 0, :], 0.0, -1e30).astype(np.float32)[:, None]
    out = port_attention.decode_attention(
        _fake_cuda(q), _fake_cuda(k), _fake_cuda(v), LAYER, _fake_cuda(bias)
    )
    assert out == "launched" and calls == [LAYER]


def test_device_mismatch_raises():
    q, k, v, mask = _inputs(1, 4, seed=6)
    bias = port_attention.mask_to_bias(torch.from_numpy(mask))
    with pytest.raises(ValueError, match="several devices"):
        port_attention.decode_attention(
            torch.from_numpy(q), _fake_cuda(k), _fake_cuda(v), LAYER,
            _fake_cuda(bias.numpy()),
        )
    with pytest.raises(ValueError, match="cuda or cpu"):
        meta = [torch.empty(x.shape, device="meta") for x in (q, k, v)]
        port_attention.decode_attention(
            *meta, LAYER, torch.empty(tuple(bias.shape), device="meta")
        )


def _function_ast(fn):
    return ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]


def test_wrapper_dispatch_is_static():
    """Source-level pins: the wrapper has no try (nothing falls back), it
    calls the plain version once, under `device.type == "cpu"`, and the
    launch count moves only beside the kernel launch."""
    tree = _function_ast(port_attention.decode_attention)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain_calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        for inner in ast.walk(node):
            if isinstance(inner, ast.Call) and getattr(inner.func, "id", "") \
                    == "decode_attention_reference":
                plain_calls.append(ast.unparse(node.test))
    assert plain_calls == ["device.type == 'cpu'"]

    launch = _function_ast(port_attention._launch_kernel)
    names = {n.id for n in ast.walk(launch) if isinstance(n, ast.Name)}
    assert "decode_attention_reference" not in names
    increments = [n for n in ast.walk(launch) if isinstance(n, ast.AugAssign)]
    assert [ast.unparse(n) for n in increments] == [
        "launch_counts[KERNEL] += 1"
    ]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(launch))
    for fn in (port_attention.decode_attention_reference,
               port_attention.mask_to_bias):
        assert "launch_counts" not in inspect.getsource(fn)
