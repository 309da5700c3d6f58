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
    leading dims and the layout flag in the layout's argument struct; the
    plain version is never taken; the launch is counted in all and by
    route (float32 x: the CUDA cores; bf16 x: the tensor cores, with the
    launch plan in the struct)."""
    calls = []

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    def fake_launch(*args):
        calls.append((quant_matmul._Args.from_address(args[0]),) + args[1:])
        return 0

    monkeypatch.setattr(quant_matmul, "int8_matmul_reference", no_plain)
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (fake_launch, lambda index: 0))
    x, q, s = _mm_inputs(m=6, k=32, n=48)
    x3 = x.reshape(2, 3, 32)
    before = dict(quant_matmul.launch_counts)
    out = quant_matmul.int8_matmul(_fake_cuda(x3), _fake_cuda(q),
                                   _fake_cuda(s), _fake_cuda(torch.zeros(48)))
    assert out.shape == (2, 3, 48) and out.dtype == torch.float32
    xq, qq, sq = _mm_inputs(m=6, k=64, n=16, transposed=True)
    out = quant_matmul.int8_matmul(_fake_cuda(xq), _fake_cuda(qq),
                                   _fake_cuda(sq), transposed=True)
    assert out.shape == (6, 16)
    out = quant_matmul.int8_matmul(_fake_cuda(xq.bfloat16()), _fake_cuda(qq),
                                   _fake_cuda(sq), transposed=True)
    assert out.shape == (6, 16) and out.dtype == torch.float32
    out = quant_matmul.int8_matmul(_fake_cuda(x3.bfloat16()), _fake_cuda(q),
                                   _fake_cuda(s),
                                   _fake_cuda(torch.zeros(48).bfloat16()))
    assert out.shape == (2, 3, 48) and out.dtype == torch.bfloat16
    counts = quant_matmul.launch_counts
    assert {name: counts[name] - before[name] for name in counts} == {
        quant_matmul.KERNEL: 4, quant_matmul.FMA: 2, quant_matmul.MMA: 1,
        quant_matmul.MMA_UNEMBED: 1}
    # (args, x, q, s, b, y, stream)
    assert [(a.M, a.N, a.K, a.transposed, a.dtype) for a, *_ in calls] == [
        (6, 48, 32, 0, 0), (6, 16, 64, 1, 0), (6, 16, 64, 1, 1),
        (6, 48, 32, 0, 1)]
    assert calls[0][4] is not None and calls[1][4] is None
    plan = quant_matmul.launch_plan(6, 32, 48, False)
    a = calls[3][0]
    assert (a.mt, a.splits, a.k_split, a.stages, a.grid_x, a.smem) == (
        plan.mt, plan.splits, plan.k_split, plan.stages, plan.grid[0],
        plan.smem_bytes)
    assert calls[0][0].smem == 0  # the CUDA-core route plans in csrc


def test_int8_matmul_layout_is_validated_once_per_key(monkeypatch):
    """A layout (shapes, strides, dtypes, bias or not) is checked once and
    its struct reused; the pointers' alignment is checked on every call."""
    monkeypatch.setattr(quant_matmul, "_entry_point",
                        lambda: (lambda *a: 0, lambda index: 0))
    built = []
    real = quant_matmul._kernel_layout
    monkeypatch.setattr(quant_matmul, "_kernel_layout",
                        lambda *a: built.append(a[-1]) or real(*a))
    quant_matmul._layouts.clear()
    x, q, s = _mm_inputs(m=4, k=32, n=48)
    for _ in range(3):
        quant_matmul.int8_matmul(*map(_fake_cuda, (x, q, s)))
    quant_matmul.int8_matmul(*map(_fake_cuda, (x[:3], q, s)))
    assert built == [False, False]
    misaligned = torch.zeros(4 * 32 + 1)[1:].reshape(4, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_matmul.int8_matmul(*map(_fake_cuda, (misaligned, q, s)))
    assert len(built) == 2  # same layout: not validated again
    quant_matmul._layouts.clear()


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
    # the bf16 unembedding reads K in chunks of 64
    xt, qt, st = _mm_inputs(k=96, n=16, transposed=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant_matmul.int8_matmul(*map(_fake_cuda, (xt.bfloat16(), qt, st)),
                                 transposed=True)


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
            if isinstance(n, ast.AugAssign)] == [
        "launch_counts[KERNEL] += 1", "launch_counts[lay.route] += 1"]
    assert "launch_counts" not in inspect.getsource(
        quant_matmul.int8_matmul_reference)


# -------------------------------------- the tensor-core route's launch plan

GPT2_PRODUCTS = [(768, 2304, False), (768, 3072, False), (768, 768, False),
                 (3072, 768, False), (768, 50257, True)]


@pytest.mark.parametrize("m", [1, 16, 256])
@pytest.mark.parametrize("k,n,transposed", GPT2_PRODUCTS)
def test_launch_plan_invariants_at_gpt2_products(m, k, n, transposed):
    """What csrc relies on (valid_mma_plan) and what the design claims:
    row tiles cover M; dense splits are whole boxes that cover K without an
    empty split, fill about one wave and keep a split's boxes in flight;
    the transposed grid is at most one wave whose tiles cover the table;
    shared memory within the card's limit and equal to csrc's sum."""
    plan = quant_matmul.launch_plan(m, k, n, transposed)
    rows = 16 * plan.mt
    assert plan.mt == (1 if m <= 16 else 4)
    assert plan.grid[1] == -(-m // rows)
    assert plan.smem_bytes <= quant_matmul.SMEM_LIMIT
    assert plan.smem_bytes == quant_matmul._smem_bytes(
        transposed, plan.mt, plan.k_split, plan.stages)
    if transposed:
        n_vt = -(-n // quant_matmul.TABLE_ROWS)
        assert plan.grid[0] * plan.grid[1] <= quant_matmul.TARGET_BLOCKS
        assert plan.grid[0] * plan.tiles_per_block >= n_vt
        assert plan.grid[0] <= n_vt  # every block has a tile
        assert 2 <= plan.stages <= quant_matmul.MAX_TABLE_STAGES
        assert plan.splits == 1 and plan.grid[2] == 1
        return
    assert plan.grid[0] == -(-n // quant_matmul.DENSE_COLS)
    assert plan.k_split % quant_matmul.DENSE_ROWS == 0
    assert plan.splits * plan.k_split >= k > (plan.splits - 1) * plan.k_split
    assert 1 <= plan.splits <= quant_matmul.MAX_SPLIT
    assert plan.grid[2] == plan.splits
    # a wave of blocks, or splits as fine as 8 allow in whole boxes
    blocks = plan.grid[0] * plan.grid[1] * plan.splits
    rows = quant_matmul.DENSE_ROWS
    assert (blocks >= quant_matmul.TARGET_BLOCKS
            or plan.k_split == -(-k // (quant_matmul.MAX_SPLIT * rows)) * rows)
    assert plan.stages == plan.tiles_per_block  # every box in flight


def test_launch_plan_worked_examples():
    """The decode products (M=16): wqkv 18 column tiles x 6 splits of one
    128-row box (8 splits round up to whole boxes); mlp.wo 6 x 8 splits of
    384 rows, three boxes each; the unembedding one wave of 132 blocks, 6
    tiles each through 4 stages; at M=256, 33 blocks for each of 4 row
    tiles, 24 tiles each, 2 stages."""
    plan = quant_matmul.launch_plan
    assert plan(16, 768, 2304, False) == quant_matmul.LaunchPlan(
        mt=1, grid=(18, 1, 6), splits=6, k_split=128, stages=1,
        smem_bytes=21776, tiles_per_block=1)
    assert plan(16, 3072, 768, False).grid == (6, 1, 8)
    assert plan(16, 3072, 768, False).k_split == 384
    p = plan(16, 768, 50257, True)
    assert (p.grid, p.tiles_per_block, p.stages) == ((132, 1, 1), 6, 4)
    p = plan(256, 768, 50257, True)
    assert (p.mt, p.grid, p.tiles_per_block, p.stages) == (
        4, (33, 4, 1), 24, 2)
    assert plan(256, 768, 2304, False).grid == (18, 4, 2)


@pytest.mark.parametrize("m", [1, 16, 256])
def test_launch_plan_ragged_vocab_edge_covers_every_row_once(m):
    """A table of 129 rows: tiles of 64, the last holding one row. Block
    b walks tiles b, b + grid, ..; every row is some block's exactly once."""
    p = quant_matmul.launch_plan(m, 768, 129, True)
    rows = quant_matmul.TABLE_ROWS
    covered = []
    for b in range(p.grid[0]):
        for tile in range(b, -(-129 // rows), p.grid[0]):
            covered += range(tile * rows, min(129, (tile + 1) * rows))
    assert sorted(covered) == list(range(129))
    assert p.grid[0] == 3 and p.stages >= 1


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="empty product"):
        quant_matmul.launch_plan(0, 768, 768, False)
    with pytest.raises(ValueError, match="too deep"):
        quant_matmul.launch_plan(256, 8192, 50257, True)


# ------------------------------- the tensor-core route's fragment maps
#
# A model of the kernels' register fragments, written from the PTX
# definitions of mma.m16n8k16 and ldmatrix, run through the index maps of
# quant_matmul (the kernels' formulas): each block's sums must equal x @ q.


def _i8x2_to_bf16x2(h):
    """csrc i8x2_to_bf16x2 on numpy uint32: bytes 0 and 2 of h -> two
    float values (what the packed bf16 fma a * 1 + b computes)."""
    a = (h & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    b = (h & np.uint32(0x00800080)) | np.uint32(0xC300C300)

    def halves(w):
        lo = ((w & np.uint32(0xFFFF)) << np.uint32(16)).astype(np.uint32)
        hi = (w & np.uint32(0xFFFF0000)).astype(np.uint32)
        return lo.view(np.float32), hi.view(np.float32)

    (alo, ahi), (blo, bhi) = halves(a), halves(b)
    return alo + blo, ahi + bhi  # exact: the sum is an integer |v| <= 128


def _byte_perm(a, b, sel):
    """CUDA __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes (a, b)."""
    src = np.frombuffer(np.array([a, b], np.uint32).tobytes(), np.uint8)
    out = bytes(int(src[(sel >> (4 * i)) & 7]) for i in range(4))
    return np.frombuffer(out, np.uint32)[0]


def _mma(a_of, b_of):
    """mma.m16n8k16 row.col on per-lane fragments: a_of(lane, reg, half)
    and b_of(lane, reg, half) give the values the lane holds; returns
    c[lane][i]. A[g + 8 (i & 1)][2t + h + 8 (i >> 1)], B[2t + h + 8 i][g],
    C[g + 8 (i >> 1)][2t + (i & 1)]."""
    a = np.full((16, 16), np.nan)
    b = np.full((16, 8), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            for h in range(2):
                a[g + 8 * (i & 1), 2 * t + h + 8 * (i >> 1)] = a_of(lane, i, h)
        for i in range(2):
            for h in range(2):
                b[2 * t + h + 8 * i, g] = b_of(lane, i, h)
    assert not np.isnan(a).any() and not np.isnan(b).any()
    c = a @ b
    return [[c[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)]
             for i in range(4)] for lane in range(32)]


def test_int8_to_bf16_pair_conversion_is_exact_for_every_byte():
    v = np.arange(-128, 128)
    u = (v & 0xFF).astype(np.uint32)
    lo, hi = _i8x2_to_bf16x2(u | (u[::-1] << np.uint32(16)))
    np.testing.assert_array_equal(lo, v.astype(np.float32))
    np.testing.assert_array_equal(hi, v[::-1].astype(np.float32))


def test_fragment_maps_are_permutations():
    """Permuted, then unpermuted, is the identity: within a warp the dense
    accumulators name each of its 32 columns exactly once per row pair, the
    B operand's lanes each of them once per mma; the transposed map names
    each k of a 32-deep chunk once."""
    for warp in range(8):
        b_cols = sorted(quant_matmul.dense_b_column(warp, lane, j)
                        for lane in range(0, 32, 4) for j in range(4))
        assert b_cols == list(range(32 * (warp % 4), 32 * (warp % 4) + 32))
        one_row = sorted(quant_matmul.dense_c_column(warp, t, j, c)
                         for t in range(4) for j in range(4) for c in (0, 1))
        assert one_row == b_cols
    ks = sorted(quant_matmul.table_k(t, step, reg, half) for t in range(4)
                for step in range(4) for reg in range(2) for half in range(2))
    assert ks == list(range(64))
    assert sorted(quant_matmul.table_b_row(lane)
                  for lane in range(0, 32, 4)) == list(range(8))
    for lane in range(32):  # the accumulators' rows are the B rows' sigma
        for c in range(4):
            t = lane & 3
            assert quant_matmul.table_c_row(lane, c) == \
                quant_matmul.table_b_row(4 * (2 * t + (c & 1)))
    # a quarter warp's 16-byte reads of its two rows: 8 distinct chunks
    for kc in (0, 64):
        for q0 in range(0, 32, 8):
            chunks = {quant_matmul.swizzle128(
                quant_matmul.table_b_row(lane), kc + 16 * (lane & 3)) % 128
                for lane in range(q0, q0 + 8)}
            assert len(chunks) == 8
    # the swizzle moves 16-byte chunks within a row, and rows 2t (+1)
    # read by one instruction fall on 32 distinct banks
    for row in range(32):
        assert sorted(quant_matmul.swizzle128(row, c) - 128 * row
                      for c in range(0, 128, 16)) == list(range(0, 128, 16))
    for base in (0, 1, 8, 9):
        for warp in range(4):
            banks = {(quant_matmul.swizzle128(
                base + 2 * (lane & 3), quant_matmul.dense_b_word(warp, lane))
                // 4) % 32 for lane in range(32)}
            assert len(banks) == 32


def test_dense_fragments_compute_the_block_product():
    """One dense block (M=16 rows, 128 columns, two 16-deep steps of one
    32-row box): the box swizzled as TMA writes it, each lane's words read
    at the kernel's offsets and paired by byte_perm, converted, x read as
    ldmatrix distributes it, the mma, then the accumulators placed at the
    epilogue's columns and the two k-parity warps summed."""
    rng = np.random.default_rng(0)
    k, n = 32, 128
    x = rng.integers(-8, 9, (16, k)).astype(np.float64)
    q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    box = np.zeros(k * 128, np.uint8)
    for r in range(k):
        for c in range(n):
            box[quant_matmul.swizzle128(r, c)] = q[r, c].view(np.uint8)

    def word(r, col):
        off = quant_matmul.swizzle128(r, col)
        return box[off:off + 4].view(np.uint32)[0]

    y = np.zeros((16, n))
    for warp in range(8):
        ks = warp >> 2  # this warp's k16 step of the box
        frags = {}
        for lane in range(32):
            t = lane & 3
            col = quant_matmul.dense_b_word(warp, lane)
            r = 16 * ks + 2 * t
            w = [word(r + d, col) for d in (0, 1, 8, 9)]
            for j in range(4):
                sel = j | ((4 + j) << 8)
                frags[lane, j] = (_i8x2_to_bf16x2(_byte_perm(w[0], w[1], sel)),
                                  _i8x2_to_bf16x2(_byte_perm(w[2], w[3], sel)))
        # ldmatrix.x4: lane L addresses row L & 15, k (L >> 4) * 8 of the
        # step; register i of lane l holds matrix i's row l >> 2, elements
        # 2 (l & 3) and + 1; matrices: rows 0-7 / 8-15 x k 0-7 / 8-15.
        def a_of(lane, i, h):
            row = (lane >> 2) + 8 * (i & 1)
            return x[row, 16 * ks + 8 * (i >> 1) + 2 * (lane & 3) + h]

        for j in range(4):
            c = _mma(a_of, lambda lane, i, h: frags[lane, j][i][h])
            for lane in range(32):
                for ci in range(4):
                    row = (lane >> 2) + 8 * (ci >> 1)
                    y[row, quant_matmul.dense_c_column(
                        warp, lane, j, ci)] += c[lane][ci]
    np.testing.assert_array_equal(y, x @ q.astype(np.float64))


def test_transposed_fragments_compute_the_block_product():
    """One transposed warp tile (16 rows of x, the warp's 8 table rows of a
    64-row tile, K = 256, two 128-byte boxes): the boxes swizzled as TMA
    writes them, each lane's 16 bytes of row sigma(g) at 16 t of a 64-deep
    chunk, converted pairs as B, x's reads of rows g and g + 8 as A through
    the same k map, accumulators stored at rows t + 4 (c & 1)."""
    rng = np.random.default_rng(1)
    k, warp = 256, 5
    x = rng.integers(-8, 9, (16, k)).astype(np.float64)
    q = rng.integers(-128, 128, (64, k)).astype(np.int8)
    boxes = [np.zeros(64 * 128, np.uint8) for _ in range(k // 128)]
    for r in range(64):
        for c in range(k):
            boxes[c // 128][quant_matmul.swizzle128(r, c % 128)] = \
                q[r, c].view(np.uint8)
    y = np.zeros((16, 8))
    for kc in range(0, k, 64):
        def words(lane):
            row = 8 * warp + quant_matmul.table_b_row(lane)
            off = quant_matmul.swizzle128(row, kc % 128 + 16 * (lane & 3))
            return boxes[kc // 128][off:off + 16].view(np.uint32)

        for step in range(4):
            def b_of(lane, reg, h):
                sel = 0x0100 if reg == 0 else 0x0302
                pair = _i8x2_to_bf16x2(_byte_perm(words(lane)[step], 0, sel))
                row = 8 * warp + quant_matmul.table_b_row(lane)
                assert pair[h] == q[row, kc + quant_matmul.table_k(
                    lane, step, reg, h)]
                return pair[h]

            def a_of(lane, i, h):
                row = (lane >> 2) + 8 * (i & 1)
                return x[row, kc + quant_matmul.table_k(lane, step, i >> 1,
                                                         h)]

            c = _mma(a_of, b_of)
            for lane in range(32):
                for ci in range(4):
                    y[(lane >> 2) + 8 * (ci >> 1),
                      quant_matmul.table_c_row(lane, ci)] += c[lane][ci]
    want = x @ q[8 * warp:8 * warp + 8].astype(np.float64).T
    np.testing.assert_array_equal(y, want)
