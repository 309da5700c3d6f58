"""Weight-only int8 and the int8 KV cache of the PyTorch port, against JAX.

The quantizers keep the JAX package's op order, so their int8 values and
scales are bit-equal to its own on the same numpy-seeded inputs. The int8
products (`dense`, `unembed`, `embed_lookup`) and `attend_quant` agree with
the JAX functions within 1e-5 in float32: both sides compute in float32
and differ only by summation order. On the CPU `int8_matmul` takes its
plain version; its wrapper's dispatch and argument checks are pinned here,
the kernel itself on the card (tests/test_torch_kernels_cuda.py).
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu_torch.models import common as port_common
from distributed_lms_raft_llm_tpu_torch.models import convert
from distributed_lms_raft_llm_tpu_torch.models import quant as port_quant
from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul

ATOL = 1e-5


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _equal(port, jax_value):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))


# --------------------------------------------------------- the quantizers


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 96), (2, 128, 32)])
def test_quantize_array_bit_equal_to_jax(shape):
    w = _normal(shape, seed=sum(shape), scale=0.02)
    w[..., 0, :] = 0.0  # a row of zeros: the 1e-8 floor never divides by 0
    want = jax_quant.quantize_array(jnp.asarray(w))
    got = port_quant.quantize_array(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    _equal(got["q"], want["q"])
    _equal(got["s"], want["s"])


@pytest.mark.parametrize("shape", [(384, 32), (50, 768)])
def test_quantize_embedding_bit_equal_to_jax(shape):
    w = _normal(shape, seed=shape[0], scale=0.02)
    w[3] *= 50.0  # an outlier row keeps its own scale
    w[5] = 0.0
    want = jax_quant.quantize_embedding(jnp.asarray(w))
    got = port_quant.quantize_embedding(torch.from_numpy(w))
    _equal(got["q"], want["q"])
    _equal(got["s"], want["s"])


def test_quantizers_round_half_to_even_like_jax():
    """Values exactly between two int8 steps round to the even one on both
    sides (`torch.round` and `jnp.round`)."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32).T
    want = jax_quant.quantize_array(jnp.asarray(w))
    got = port_quant.quantize_array(torch.from_numpy(w))
    _equal(got["q"], want["q"])
    assert got["q"][:, 0].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape", [(2, 4, 6, 8), (1, 12, 3, 64)])
def test_quantize_kv_bit_equal_to_jax(shape):
    x = _normal(shape, seed=shape[-1])
    x[0, 0, 0] = 0.0
    want_q, want_s = jax_common.quantize_kv(jnp.asarray(x))
    got_q, got_s = port_common.quantize_kv(torch.from_numpy(x))
    _equal(got_q, want_q)
    _equal(got_s, want_s)


# ---------------------------------------------------- the int8 functions


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_int8_dense_matches_jax(with_bias, lead):
    x = _normal(lead + (96,), seed=1)
    w = _normal((96, 64), seed=2, scale=0.05)
    b = _normal((64,), seed=3) if with_bias else None
    qw = jax_quant.quantize_array(jnp.asarray(w))
    want = jax_common.dense(jnp.asarray(x), qw,
                            None if b is None else jnp.asarray(b))
    pw = {"q": torch.from_numpy(np.array(qw["q"])),
          "s": torch.from_numpy(np.array(qw["s"]))}
    got = port_common.dense(torch.from_numpy(x), pw,
                            None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == lead + (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_int8_embed_lookup_and_unembed_match_jax():
    table = _normal((384, 32), seed=4, scale=0.02)
    qt = jax_quant.quantize_embedding(jnp.asarray(table))
    pt = {"q": torch.from_numpy(np.array(qt["q"])),
          "s": torch.from_numpy(np.array(qt["s"]))}
    ids = np.random.default_rng(5).integers(0, 384, (2, 7))
    want = jax_quant.embed_lookup(qt, jnp.asarray(ids))
    got = port_quant.embed_lookup(pt, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = _normal((2, 7, 32), seed=6)
    want = jax_quant.unembed(jnp.asarray(x), qt)
    got = port_quant.unembed(torch.from_numpy(x), pt)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_dense_embed_lookup_and_unembed_match_jax():
    table = _normal((384, 32), seed=7)
    ids = np.random.default_rng(8).integers(0, 384, (2, 5))
    np.testing.assert_array_equal(
        port_quant.embed_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)).numpy(),
        np.asarray(jax_quant.embed_lookup(jnp.asarray(table),
                                          jnp.asarray(ids))))
    x = _normal((2, 5, 32), seed=9)
    np.testing.assert_allclose(
        port_quant.unembed(torch.from_numpy(x),
                           torch.from_numpy(table)).numpy(),
        np.asarray(jax_quant.unembed(jnp.asarray(x), jnp.asarray(table))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [1, 5])
def test_attend_quant_matches_jax(t):
    rng = np.random.default_rng(10 + t)
    q = _normal((2, 4, t, 8), seed=11 + t)
    k = _normal((2, 4, 12, 8), seed=12)
    v = _normal((2, 4, 12, 8), seed=13)
    mask = rng.random((2, 1, t, 12)) < 0.7
    mask[..., 0] = True
    k8, ks = jax_common.quantize_kv(jnp.asarray(k))
    v8, vs = jax_common.quantize_kv(jnp.asarray(v))
    want = jax_common.attend_quant(jnp.asarray(q), k8, ks, v8, vs,
                                   jnp.asarray(mask))
    got = port_common.attend_quant(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                               for a in (k8, ks, v8, vs)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------- parameter trees


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    return jax.device_get(jax_gpt2.init_params(jax.random.key(0), cfg))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def test_params_from_jax_carries_int8_pairs_and_equals_port_quantizer(
        jax_tiny):
    """A JAX-quantized tree carried across keeps its int8/f32 pairs (even
    when the dense leaves are cast), and equals the port's own
    `quantize_params` of the carried dense tree, leaf for leaf."""
    jq = jax.device_get(jax_quant.quantize_params(jax_tiny, "gpt2"))
    carried = convert.params_from_jax(jq, dtype=torch.bfloat16, device="cpu")
    assert carried["wte"]["q"].dtype == torch.int8
    assert carried["wte"]["s"].dtype == torch.float32
    assert carried["blocks"]["attn"]["wqkv"]["q"].shape == (2, 32, 96)
    assert carried["blocks"]["ln1"]["scale"].dtype == torch.bfloat16
    carried = convert.params_from_jax(jq, device="cpu")
    own = port_quant.quantize_params(
        convert.params_from_jax(jax_tiny, device="cpu"), "gpt2")
    got, want = dict(_leaves(own)), dict(_leaves(carried))
    assert sorted(got) == sorted(want)
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        torch.testing.assert_close(got[path], want[path], rtol=0, atol=0)
    assert port_quant.is_quantized(own["blocks"]["mlp"]["wo"])
    assert not port_quant.is_quantized(own["wpe"])


def test_quantize_params_refuses_unported_families(jax_tiny):
    with pytest.raises(ValueError, match="not ported"):
        port_quant.quantize_params({}, "llama")


# ----------------------------------------------------- the kernel wrapper


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's
    dispatch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, x)


def _mm_inputs(m=4, k=32, n=48, transposed=False, seed=20):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (n, k) if transposed
                                      else (k, n), np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    return x, q, s


@pytest.mark.parametrize("transposed", [False, True])
def test_int8_matmul_cpu_takes_the_plain_version(transposed):
    x, q, s = _mm_inputs(transposed=transposed)
    b = None if transposed else torch.ones(48)
    got = quant_matmul.int8_matmul(x, q, s, b, transposed=transposed)
    w = q.double().t() if transposed else q.double()
    exact = (x.double() @ w) * s.double() + (0 if b is None else 1.0)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        got, quant_matmul.int8_matmul_reference(x, q, s, b, transposed),
        rtol=0, atol=0)


def test_int8_matmul_cuda_tensors_launch_the_kernel(monkeypatch):
    """CUDA tensors go to the kernel with the product's shape, flattened
    leading dims and the layout flag; the plain version is never taken;
    the launch is counted."""
    calls = []

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    def fake_launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(quant_matmul, "int8_matmul_reference", no_plain)
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (fake_launch, lambda index: 0))
    x, q, s = _mm_inputs(m=6, k=32, n=48)
    x3 = x.reshape(2, 3, 32)
    before = quant_matmul.launch_counts[quant_matmul.KERNEL]
    out = quant_matmul.int8_matmul(_fake_cuda(x3), _fake_cuda(q),
                                   _fake_cuda(s), _fake_cuda(torch.zeros(48)))
    assert out.shape == (2, 3, 48) and out.dtype == torch.float32
    xq, qq, sq = _mm_inputs(m=6, k=32, n=16, transposed=True)
    out = quant_matmul.int8_matmul(_fake_cuda(xq), _fake_cuda(qq),
                                   _fake_cuda(sq), transposed=True)
    assert out.shape == (6, 16)
    assert quant_matmul.launch_counts[quant_matmul.KERNEL] == before + 2
    # (x, q, s, b, y, M, N, K, transposed, dtype, stream)
    assert [c[5:10] for c in calls] == [(6, 48, 32, 0, 0), (6, 16, 32, 1, 0)]
    assert calls[0][3] is not None and calls[1][3] is None


def test_int8_matmul_refuses_what_it_cannot_take(monkeypatch):
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (lambda *a: 0, lambda index: 0))
    x, q, s = _mm_inputs()
    with pytest.raises(ValueError, match="does not match"):
        quant_matmul.int8_matmul(x[:, :16], q, s)
    with pytest.raises(ValueError, match="int8"):
        quant_matmul.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match=r"s must be \[48\]"):
        quant_matmul.int8_matmul(x, q, s[:3])
    with pytest.raises(ValueError, match="no bias"):
        quant_matmul.int8_matmul(x, q.t().contiguous(), s, torch.zeros(48),
                                 transposed=True)
    with pytest.raises(ValueError, match="several devices"):
        quant_matmul.int8_matmul(_fake_cuda(x), q, s)
    # the kernel's own limits, on CUDA tensors
    xo, qo, so = _mm_inputs(k=24, n=48)
    with pytest.raises(ValueError, match="multiples of 16"):
        quant_matmul.int8_matmul(*map(_fake_cuda, (xo, qo, so)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul.int8_matmul(*map(_fake_cuda, (x.double(), q, s)))
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.t().contiguous().t()
        quant_matmul.int8_matmul(*map(_fake_cuda, (x, qt, s)))


def test_int8_matmul_dispatch_is_static():
    """Source-level pins: no try (nothing falls back), the plain version
    only under `device.type == "cpu"`, the count moves only beside the
    launch."""
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(quant_matmul.int8_matmul))).body[0]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain = [ast.unparse(n.test) for n in ast.walk(tree)
             if isinstance(n, ast.If) and any(
                 isinstance(c, ast.Call)
                 and getattr(c.func, "id", "") == "int8_matmul_reference"
                 for c in ast.walk(n))]
    assert plain == ["device.type == 'cpu'"]
    launch = ast.parse(textwrap.dedent(
        inspect.getsource(quant_matmul._launch_kernel))).body[0]
    assert [ast.unparse(n) for n in ast.walk(launch)
            if isinstance(n, ast.AugAssign)] == ["launch_counts[KERNEL] += 1"]
    assert "launch_counts" not in inspect.getsource(
        quant_matmul.int8_matmul_reference)
