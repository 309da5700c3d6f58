"""Decode attention of the PyTorch port against the JAX package.

The port's plain version (`decode_attention_reference`) and `mask_to_bias`
are held against the JAX Pallas kernel, run in interpret mode on the CPU,
and against `common.attend` on the indexed layer. The CUDA kernel itself
runs only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py);
here its wrapper's dispatch is checked: CPU tensors take the plain version,
CUDA tensors never do. The kernel's launch plan (`launch_plan`) is pinned by
its invariants, and the maths it implements (keys split across a cluster,
online softmax over tiles, log-sum-exp combine) by a numpy model held
against the plain version and the Pallas kernel.
"""

import ast
import ctypes
import functools
import inspect
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.ops import attention as jax_attention
from distributed_lms_raft_llm_tpu_torch.models import common as port_common
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


# ------------------------------------------------------------ launch plan

MAIN_BATCHES = (1, 2, 4, 8)
# Windows the bucketed engine gives the kernel (bucket + new tokens), the
# smoke's shapes, and GPT-2's full window.
MAIN_WINDOWS = (1, 17, 32, 33, 64, 65, 96, 127, 128, 192, 200, 256, 300,
                320, 384, 512, 640, 1024)


def _check_plan(plan, b, hkv, s, dh, dtype, group):
    n = plan.n_split
    assert n in (1, 2, 4, 8)
    assert plan.blocks == b * hkv * n
    # every split non-empty, together they cover the S keys
    assert (n - 1) * plan.split_keys < s <= n * plan.split_keys
    cap = port_attention.max_tile_keys(group, dh, dtype.itemsize)
    if n > 1:  # split only what does not fit one tile, never below 64 keys
        assert s > cap and plan.split_keys >= port_attention.MIN_SPLIT_KEYS
    assert plan.tile_keys % 8 == 0 and 8 <= plan.tile_keys <= cap
    assert cap <= (128 if group == 1 else 64)
    assert cap * dh * dtype.itemsize <= port_attention.TILE_BYTES
    assert plan.smem_bytes <= 227 * 1024
    assert plan.smem_bytes == port_attention._smem_bytes(
        group, dh, plan.tile_keys, dtype.itemsize, plan.stages, n)
    n_tiles = -(-plan.split_keys // plan.tile_keys)
    assert 1 <= plan.stages <= n_tiles and (plan.stages >= 2 or n_tiles == 1)
    # Splits come in powers of two, so the count that first reaches the
    # plan's target of blocks is the power of two at or above
    # ceil(target / (B*Hkv)); wherever that count fits a cluster and leaves
    # MIN_SPLIT_KEYS keys a split, and the window does not fit one tile,
    # the launch has at least the target's blocks.
    target, least = port_attention.TARGET_BLOCKS, port_attention.MIN_SPLIT_KEYS
    need = -(-target // (b * hkv))
    p = 1 << (need - 1).bit_length()
    if p <= 8 and s >= least * p and s > cap:
        assert plan.blocks >= target, (b, hkv, s, plan)
    # and no split is longer than MAX_SPLIT_KEYS where a cluster could
    # take more splits of MIN_SPLIT_KEYS keys
    if plan.split_keys > port_attention.MAX_SPLIT_KEYS:
        assert n == 8 or s < least * 2 * n


@pytest.mark.parametrize("b", MAIN_BATCHES)
def test_launch_plan_invariants_on_main_path_shapes(b):
    """GPT-2 small: Hkv = H = 12, Dh = 64, bf16 serving and f32 checks."""
    for dtype in (torch.bfloat16, torch.float32):
        for s in MAIN_WINDOWS:
            plan = port_attention.launch_plan(b, 12, s, 64, dtype)
            _check_plan(plan, b, 12, s, 64, dtype, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", port_attention.HEAD_DIMS)
def test_launch_plan_invariants_over_head_dims(dh, dtype):
    for b, hkv in ((1, 1), (1, 4), (3, 2), (8, 4), (16, 8), (64, 12)):
        for group in (1, 3, port_attention.MAX_GROUP):
            for s in (1, 8, 31, 64, 100, 257, 1024, 4096):
                plan = port_attention.launch_plan(b, hkv, s, dh, dtype,
                                                  group=group)
                _check_plan(plan, b, hkv, s, dh, dtype, group)


def test_launch_plan_worked_examples():
    """The main shape's 96 (row, head) pairs are not split: each block
    streams 320 keys in tiles of 128 through a two-stage ring. A single
    row splits 384 keys four ways, its full window eight ways; a window
    that fits one tile is not split; GPT-2's full window at batch 8 is
    split in two of 512 keys."""
    main = port_attention.launch_plan(8, 12, 320, 64, torch.bfloat16)
    assert (main.n_split, main.split_keys, main.blocks) == (1, 320, 96)
    assert (main.tile_keys, main.stages) == (128, 2)
    full = port_attention.launch_plan(8, 12, 1024, 64, torch.bfloat16)
    assert (full.n_split, full.split_keys) == (2, 512)
    one = port_attention.launch_plan(1, 12, 384, 64, torch.bfloat16)
    assert (one.n_split, one.split_keys, one.blocks) == (4, 96, 48)
    one = port_attention.launch_plan(1, 12, 1024, 64, torch.bfloat16)
    assert (one.n_split, one.split_keys, one.blocks) == (8, 128, 96)
    for s in (33, 128):
        short = port_attention.launch_plan(8, 12, s, 64, torch.bfloat16)
        assert (short.n_split, short.split_keys) == (1, s)
    wide = port_attention.launch_plan(64, 12, 4096, 64, torch.bfloat16)
    assert (wide.n_split, wide.split_keys, wide.tile_keys) == (8, 512, 128)
    assert wide.stages == 2  # 2 x 32 KB of K and V in flight
    gqa = port_attention.launch_plan(8, 4, 384, 64, torch.bfloat16, group=3)
    assert (gqa.n_split, gqa.split_keys, gqa.tile_keys) == (4, 96, 64)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_launch_plan_forced_split(n):
    """The sweep's override: the split count as given, the rest of the
    plan as for any split."""
    plan = port_attention.launch_plan(8, 12, 320, 64, torch.bfloat16,
                                      n_split=n)
    assert plan.n_split == n and plan.split_keys == -(-320 // n)
    assert plan.blocks == 96 * n and plan.tile_keys == min(
        128, -(-plan.split_keys // 8) * 8)
    assert plan.smem_bytes == port_attention._smem_bytes(
        1, 64, plan.tile_keys, 2, plan.stages, n)


def test_launch_plan_refuses_a_split_no_cluster_takes():
    for n in (0, 3, 16):
        with pytest.raises(ValueError, match="n_split"):
            port_attention.launch_plan(8, 12, 320, 64, torch.bfloat16,
                                       n_split=n)


# ------------------------------------------- split-and-combine, in numpy

_LOWEST = np.float32(np.finfo(np.float32).min)


def _split_combine(q, k, v, layer, bias, n_split, split_keys, tile):
    """The kernel's arithmetic in float32 numpy: each split walks its keys
    in tiles with an online softmax from the finite lowest float, keeping
    (m, l, o) per query head; the splits are then combined with weights
    exp(m_k - max m)."""
    b, h, _, dh = q.shape
    hkv, s = k.shape[2], k.shape[3]
    group = h // hkv
    scale = np.float32(1.0 / np.sqrt(dh))
    out = np.zeros((b, h, 1, dh), np.float32)
    for row in range(b):
        for head in range(h):
            kh, vh = k[layer, row, head // group], v[layer, row, head // group]
            qh = q[row, head, 0]
            parts = []
            for split in range(n_split):
                start = split * split_keys
                stop = min(s, start + split_keys)
                m, l = _LOWEST, np.float32(0)
                o = np.zeros(dh, np.float32)
                for t0 in range(start, max(stop, start), tile):
                    t1 = min(stop, t0 + tile)
                    sc = (kh[t0:t1] @ qh) * scale + bias[row, 0, t0:t1]
                    m_new = max(m, sc.max())
                    alpha = np.exp(np.float32(m - m_new))
                    p = np.exp(sc - m_new)
                    l = l * alpha + p.sum(dtype=np.float32)
                    o = o * alpha + p @ vh[t0:t1]
                    m = m_new
                parts.append((np.float32(m), np.float32(l), o))
            m_all = max(m for m, _, _ in parts)
            w = [np.exp(np.float32(m - m_all)) for m, _, _ in parts]
            l_all = sum(wk * lk for wk, (_, lk, _) in zip(w, parts))
            o_all = sum(wk * ok for wk, (_, _, ok) in zip(w, parts))
            out[row, head, 0] = o_all / l_all
    return out


def _split_inputs(b, hkv, s, pads, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, 1, DH)).astype(np.float32)
    k = rng.standard_normal((L, b, hkv, s, DH)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, s, DH)).astype(np.float32)
    mask = np.ones((b, 1, 1, s), bool)
    for row, pad in enumerate(pads):
        mask[row, ..., :pad] = False
    return q, k, v, mask


def _plan_args(b, hkv, s):
    plan = port_attention.launch_plan(b, hkv, s, DH, torch.float32,
                                      group=H // hkv)
    return plan.n_split, plan.split_keys, plan.tile_keys


SPLIT_CASES = {
    # the launch plan's own cut; row 1 pads 383 of 384 slots, so every
    # split of it but the last is fully masked
    "plan_ragged": (2, 4, 384, [5, 383], _plan_args(2, 4, 384)),
    # every row padded to its last slot: three of four splits fully masked
    "all_rows_masked_leading": (2, 4, 96, [95, 95], (4, 24, 8)),
    # 8 splits of 3 keys over 20: the last split is empty
    "empty_split": (1, 4, 20, [2], (8, 3, 8)),
    # several tiles a split, GQA (two query heads per KV head)
    "tiles_gqa": (3, 2, 64, [40, 0, 63], (4, 16, 8)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_combine_model_matches_reference_and_pallas(pallas_interpret,
                                                          case):
    b, hkv, s, pads, (n_split, split_keys, tile) = SPLIT_CASES[case]
    q, k, v, mask = _split_inputs(b, hkv, s, pads, seed=len(case))
    bias_t = port_attention.mask_to_bias(torch.from_numpy(mask))
    model = _split_combine(q, k, v, LAYER, bias_t.numpy(), n_split,
                           split_keys, tile)
    assert np.isfinite(model).all()
    plain = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        LAYER, bias_t,
    )
    np.testing.assert_allclose(model, plain.numpy(), rtol=0, atol=1e-6)
    pallas = jax_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LAYER, jnp.int32),
        jax_attention.mask_to_bias(jnp.asarray(mask)),
    )
    np.testing.assert_allclose(model, np.asarray(pallas), rtol=0, atol=1e-6)


def test_fully_masked_split_weighs_exactly_zero():
    """A split whose keys are all masked combines with weight 0: the
    output equals attention over the unmasked split alone, bit for bit
    in the model."""
    q, k, v, mask = _split_inputs(1, 4, 64, [32], seed=11)
    bias = port_attention.mask_to_bias(torch.from_numpy(mask)).numpy()
    both = _split_combine(q, k, v, LAYER, bias, 2, 32, 8)
    tail = _split_combine(q, k[:, :, :, 32:].copy(), v[:, :, :, 32:].copy(),
                          LAYER, bias[:, :, 32:].copy(), 1, 32, 8)
    np.testing.assert_array_equal(both, tail)


# ------------------------------------------------------------- strided q


def _strided_q(b, seed):
    """q as the model hands it over: a view of the fused [B, 1, 3*H*Dh]
    projection, split into heads (batch stride 3*H*Dh, head stride Dh)."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(
        rng.standard_normal((b, 1, 3 * H * DH)).astype(np.float32))
    q, _, _ = qkv.split(H * DH, dim=-1)
    return port_common.split_heads(q, H)


def test_plain_path_takes_a_strided_q():
    q = _strided_q(3, seed=21)
    sb, sh, _, sd = q.stride()
    assert not q.is_contiguous() and (sb, sh, sd) == (3 * H * DH, DH, 1)
    _, k, v, mask = _inputs(3, 2, seed=22)
    bias = port_attention.mask_to_bias(torch.from_numpy(mask))
    got = port_attention.decode_attention(q, torch.from_numpy(k),
                                          torch.from_numpy(v), LAYER, bias)
    want = port_attention.decode_attention(q.contiguous(), torch.from_numpy(k),
                                           torch.from_numpy(v), LAYER, bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_layout_takes_a_strided_q_and_any_window():
    """What the kernel is told: q's strides as they are (no copy), S_alloc
    from the cache's strides, the launch plan; S past the old 1024 limit."""
    q = _strided_q(2, seed=23)
    s, s_alloc = 1500, 2048
    k = torch.zeros((L, 2, 2, s_alloc, DH))[:, :, :, :s]
    bias = torch.zeros((2, 1, s))
    lay = port_attention._kernel_layout(q, k, k, bias)
    a = lay.args
    assert (a.q_sb, a.q_sh) == (3 * H * DH, DH)
    assert (a.B, a.H, a.Hkv, a.S, a.S_alloc, a.Dh) == (2, H, 2, s, s_alloc,
                                                       DH)
    plan = port_attention.launch_plan(2, 2, s, DH, torch.float32, group=2)
    assert lay.plan == plan
    assert (a.n_split, a.split_keys, a.tile, a.stages, a.smem, a.dtype) == (
        plan.n_split, plan.split_keys, plan.tile_keys, plan.stages,
        plan.smem_bytes, 0)
    assert a.scale == pytest.approx(DH ** -0.5)
    assert lay.address == ctypes.addressof(a)


def test_kernel_layout_refuses_what_the_kernel_cannot_read():
    k = torch.zeros((L, 2, 2, S, DH))
    bias = torch.zeros((2, 1, S))
    q = torch.zeros((2, H, 1, DH))
    with pytest.raises(ValueError, match="contiguous head dim"):
        port_attention._kernel_layout(
            torch.zeros((2, H, 1, 2 * DH))[..., ::2], k, k, bias)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        port_attention._kernel_layout(
            torch.zeros((2, H * DH + 1))[:, :H * DH].reshape(2, H, 1, DH),
            k, k, bias)
    with pytest.raises(TypeError):
        port_attention._kernel_layout(q.half(), k.half(), k.half(), bias)
    with pytest.raises(ValueError, match="kernel limits"):
        port_attention._kernel_layout(torch.zeros((2, 9, 1, DH)),
                                      torch.zeros((L, 2, 1, S, DH)),
                                      torch.zeros((L, 2, 1, S, DH)), bias)
    with pytest.raises(ValueError, match="S_alloc"):
        port_attention._kernel_layout(q, k.transpose(3, 4).contiguous()
                                      .transpose(3, 4), k, bias)


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

    def fake_launch(q, k_cache, v_cache, layer, bias, *scales_and_lengths):
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
        "launch_counts[lay.variant] += 1"
    ]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(launch))
    for fn in (port_attention.decode_attention_reference,
               port_attention.mask_to_bias):
        assert "launch_counts" not in inspect.getsource(fn)


def test_kernel_layout_is_validated_once_per_layout(monkeypatch):
    """A decode step calls the kernel once a layer with one layout: it is
    validated on the first call; the layer index on every call."""
    checked, launched = [], []
    orig = port_attention._kernel_layout

    def counting_layout(*args):
        checked.append(1)
        return orig(*args)

    def fake_launch(*args):
        launched.append(args)
        return 0

    monkeypatch.setattr(port_attention, "_kernel_layout", counting_layout)
    monkeypatch.setattr(port_attention, "_entry_point",
                        lambda: (fake_launch, lambda index: 0))
    monkeypatch.setattr(port_attention, "_layouts", {})
    q, k, v, mask = _inputs(2, 2, seed=31)
    bias = np.where(mask[:, 0, 0, :], 0.0, -1e30).astype(np.float32)[:, None]
    args = [_fake_cuda(x) for x in (q, k, v)]
    before = port_attention.launch_counts[port_attention.KERNEL]
    for layer in range(L):
        out = port_attention.decode_attention(*args, layer, _fake_cuda(bias))
        assert tuple(out.shape) == q.shape
    assert len(checked) == 1 and len(launched) == L
    assert port_attention.launch_counts[port_attention.KERNEL] == before + L
    assert [a[9] for a in launched] == list(range(L))  # the layer argument
    with pytest.raises(IndexError):
        port_attention.decode_attention(*args, L, _fake_cuda(bias))
    assert len(checked) == 1



# ------------------------------------- per-row lengths and an int8 cache


def _lengths_mask(lengths, s):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None])[:, None,
                                                                  None, :]


@pytest.mark.parametrize("lengths", [[1, 16, 9], [3, 3, 3], [16, 1, 2]])
def test_lengths_reference_matches_jax_attend(lengths):
    """Keys at or past a row's length are masked: the plain version equals
    JAX `attend` with that mask (the paged step's causal mask)."""
    b = len(lengths)
    q, k, v, _ = _inputs(b, H, seed=sum(lengths))
    mask = _lengths_mask(lengths, S)
    want = jax_common.attend(jnp.asarray(q), jnp.asarray(k[LAYER]),
                             jnp.asarray(v[LAYER]), jnp.asarray(mask))
    got = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), LAYER,
        lengths=torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _int8_inputs(b, seed):
    q, k, v, mask = _inputs(b, H, seed)
    k8, ks = jax_common.quantize_kv(jnp.asarray(k))
    v8, vs = jax_common.quantize_kv(jnp.asarray(v))
    return q, mask, [np.array(a) for a in (k8, ks, v8, vs)]


@pytest.mark.parametrize("use_lengths", [False, True])
def test_int8_reference_matches_jax_attend_quant(use_lengths):
    """An int8 cache with per-slot scales: the plain version equals JAX
    `attend_quant` on the indexed layer, with the bias mask or per-row
    lengths."""
    b = 3
    q, mask, (k8, ks, v8, vs) = _int8_inputs(b, seed=50 + use_lengths)
    lengths = [5, 16, 1]
    if use_lengths:
        mask = _lengths_mask(lengths, S)
    want = jax_common.attend_quant(
        jnp.asarray(q), jnp.asarray(k8[LAYER]), jnp.asarray(ks[LAYER]),
        jnp.asarray(v8[LAYER]), jnp.asarray(vs[LAYER]), jnp.asarray(mask))
    extra = (dict(lengths=torch.tensor(lengths, dtype=torch.int32))
             if use_lengths else {})
    bias = None if use_lengths else port_attention.mask_to_bias(
        torch.from_numpy(mask))
    got = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        LAYER, bias, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs), **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_int8_reference_repeats_scales_for_gqa():
    """GQA over an int8 cache: query head h reads KV head h // G, scales
    included (the plain version equals a cache repeated per query head)."""
    q, _, (k8, ks, v8, vs) = _int8_inputs(2, seed=60)
    k8, ks, v8, vs = (a[:, :, :2] for a in (k8, ks, v8, vs))  # Hkv = 2
    lengths = torch.tensor([7, 12], dtype=torch.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    got = port_attention.decode_attention(
        t(q), t(k8), t(v8), LAYER, lengths=lengths, k_scale=t(ks),
        v_scale=t(vs))
    rep = [np.repeat(a, 2, axis=2) for a in (k8, ks, v8, vs)]
    want = port_attention.decode_attention(
        t(q), t(rep[0]), t(rep[2]), LAYER, lengths=lengths,
        k_scale=t(rep[1]), v_scale=t(rep[3]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_extended_arguments_are_checked():
    q, k, v, mask = _inputs(2, H, seed=70)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="lengths must be int32"):
        port_attention.decode_attention(tq, tk, tv, LAYER,
                                        lengths=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="neither"):
        port_attention.decode_attention(tq, tk, tv, LAYER,
                                        k_scale=torch.ones(L, 2, H, S),
                                        v_scale=torch.ones(L, 2, H, S))
    k8 = torch.zeros((L, 2, H, S, DH), dtype=torch.int8)
    with pytest.raises(ValueError, match="takes k_scale"):
        port_attention.decode_attention(tq, k8, k8, LAYER)
    with pytest.raises(ValueError, match="k_scale/v_scale must be"):
        port_attention.decode_attention(tq, k8, k8, LAYER,
                                        k_scale=torch.ones(L, 2, H, S - 1),
                                        v_scale=torch.ones(L, 2, H, S - 1))


@pytest.mark.parametrize("b", MAIN_BATCHES + (16,))
def test_launch_plan_invariants_for_an_int8_cache(b):
    """The plan of an int8 cache: one byte a K/V element; at the paged
    step's 16 slots x 12 heads no window is split (192 blocks)."""
    for s in MAIN_WINDOWS + (160, 192):
        plan = port_attention.launch_plan(b, 12, s, 64, torch.int8)
        _check_plan(plan, b, 12, s, 64, torch.int8, 1)
    for s in (160, 192, 256, 384):
        assert port_attention.launch_plan(16, 12, s, 64,
                                          torch.int8).n_split == 1


def test_kernel_layout_of_an_int8_cache_with_lengths():
    """What the kernel is told for the paged int8 step: the cache's type
    code, S_alloc from the cache and its scale planes (windows of a wider
    allocation), the plan for one-byte elements, the int8 variant."""
    b, s, s_alloc, dh = 4, 160, 384, 64
    q = torch.zeros((b, H, 1, dh), dtype=torch.bfloat16)
    k = torch.zeros((L, b, H, s_alloc, dh), dtype=torch.int8)[:, :, :, :s]
    sc = torch.zeros((L, b, H, s_alloc))[..., :s]
    lengths = torch.ones((b,), dtype=torch.int32)
    lay = port_attention._kernel_layout(q, k, k, None, lengths, sc, sc)
    a = lay.args
    assert (a.S, a.S_alloc, a.dtype, a.kv_dtype) == (s, s_alloc, 1, 2)
    assert lay.plan == port_attention.launch_plan(b, H, s, dh, torch.int8)
    assert lay.variant == port_attention.INT8KV
    ragged = port_attention._kernel_layout(
        q, k.to(torch.bfloat16), k.to(torch.bfloat16), None, lengths)
    assert ragged.variant == port_attention.RAGGED
    assert (ragged.args.kv_dtype, ragged.args.S_alloc) == (1, s)
    bias = torch.zeros((b, 1, s))
    assert port_attention._kernel_layout(
        q, k.to(torch.bfloat16), k.to(torch.bfloat16),
        bias).variant == port_attention.KERNEL
    with pytest.raises(ValueError, match="kernel limits"):
        k32 = torch.zeros((L, b, H, s, 32), dtype=torch.int8)
        port_attention._kernel_layout(
            torch.zeros((b, H, 1, 32), dtype=torch.bfloat16), k32, k32,
            None, lengths, sc, sc)
    with pytest.raises(ValueError, match="k_scale/v_scale must be contig"):
        heads_first = torch.zeros((L, H, b, s_alloc)).transpose(1, 2)
        port_attention._kernel_layout(q, k, k, None, lengths,
                                      heads_first[..., :s], sc)


def test_extended_launch_passes_scales_bias_and_lengths(monkeypatch):
    """The C entry point's argument order: (args, q, k, v, ks, vs, bias,
    lengths, out, layer, stream); absent tensors go as null pointers; each
    variant counts its own launches."""
    launched = []
    monkeypatch.setattr(port_attention, "_entry_point",
                        lambda: (lambda *a: launched.append(a) or 0,
                                 lambda index: 0))
    monkeypatch.setattr(port_attention, "_layouts", {})
    q, _, (k8, ks, v8, vs) = _int8_inputs(2, seed=80)
    k8, v8 = (np.ascontiguousarray(np.repeat(a, 8, axis=-1))
              for a in (k8, v8))  # Dh 64
    q = np.ascontiguousarray(np.repeat(q, 8, axis=-1))
    lengths = np.array([3, 9], np.int32)
    args = [_fake_cuda(x) for x in (q, k8, v8)]
    counts = dict(port_attention.launch_counts)
    port_attention.decode_attention(
        *args, LAYER, lengths=_fake_cuda(lengths), k_scale=_fake_cuda(ks),
        v_scale=_fake_cuda(vs))
    (call,) = launched
    assert call[4] is not None and call[5] is not None  # ks, vs
    assert call[6] is None and call[7] is not None      # no bias; lengths
    assert call[9] == LAYER
    assert port_attention.launch_counts[port_attention.INT8KV] == \
        counts[port_attention.INT8KV] + 1
    assert port_attention.launch_counts[port_attention.KERNEL] == \
        counts[port_attention.KERNEL]


# ------------------------------------------------ the verify window (T rows)


def _window_case(b, hkv, t, seed):
    """q [b, H, t, DH], a layer cache, per-row offsets (one window ending at
    the last slot), and the causal window mask of JAX's ragged path."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, t, DH)).astype(np.float32)
    _, k, v, _ = _inputs(b, hkv, seed)
    offs = rng.integers(0, S - t + 1, b).astype(np.int32)
    offs[0] = S - t
    slots = offs[:, None] + np.arange(t)[None, :]
    mask = (np.arange(S)[None, None, :] <= slots[:, :, None])[:, None]
    return q, k, v, offs, mask


@pytest.mark.parametrize("b,hkv", CASES)
@pytest.mark.parametrize("t", [2, 5])
def test_window_reference_matches_jax_ragged_attend(b, hkv, t):
    """T query rows a batch row, row b's query j seeing the keys through
    its own slot offs[b] + j (lengths = offs + 1): the plain version equals
    JAX `attend` under the ragged path's causal window mask, with GQA."""
    q, k, v, offs, mask = _window_case(b, hkv, t, seed=40 + 7 * b + hkv + t)
    kl = jax_common.repeat_kv(jnp.asarray(k[LAYER]), H // hkv)
    vl = jax_common.repeat_kv(jnp.asarray(v[LAYER]), H // hkv)
    want = jax_common.attend(jnp.asarray(q), kl, vl, jnp.asarray(mask))
    got = port_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), LAYER,
        lengths=torch.from_numpy(offs + 1))
    assert got.shape == (b, H, t, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("b", MAIN_BATCHES + (16,))
@pytest.mark.parametrize("t", [2, 5, 9, 16])
def test_launch_plan_invariants_for_a_window(b, t):
    """The plan of a verify window: the rows a block and the blocks a (row,
    KV head) (`window_rows`) shape the grid; the tile is that of a multi-row
    block (<= 64 keys), in both cache types."""
    for dtype in (torch.bfloat16, torch.int8):
        rows, chunks = port_attention.window_rows(1, t)
        for s in (160, 384, 1024):
            plan = port_attention.launch_plan(b, 12, s, 64, dtype,
                                              group=rows, chunks=chunks)
            assert plan.blocks == b * 12 * chunks * plan.n_split
            _check_plan(plan, b * chunks, 12, s, 64, dtype, rows)


def test_window_launches_count_as_their_variant(monkeypatch):
    """A window on CUDA tensors takes the kernel (never the plain version)
    and counts under its own variant, float or int8 cache."""
    launched = []
    monkeypatch.setattr(port_attention, "_entry_point",
                        lambda: (lambda *a: launched.append(a) or 0,
                                 lambda index: 0))
    monkeypatch.setattr(port_attention, "_layouts", {})

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    monkeypatch.setattr(port_attention, "decode_attention_reference",
                        no_plain)
    b, t, dh = 2, 3, 64
    q = np.zeros((b, H, t, dh), np.float32)
    k = np.zeros((L, b, H, S, dh), np.float32)
    lengths = np.array([1, S - t + 1], np.int32)
    counts = dict(port_attention.launch_counts)
    out = port_attention.decode_attention(
        _fake_cuda(q), _fake_cuda(k), _fake_cuda(k), LAYER,
        lengths=_fake_cuda(lengths))
    assert tuple(out.shape) == (b, H, t, dh)
    k8 = np.zeros((L, b, H, S, dh), np.int8)
    sc = np.ones((L, b, H, S), np.float32)
    port_attention.decode_attention(
        _fake_cuda(q), _fake_cuda(k8), _fake_cuda(k8), LAYER,
        lengths=_fake_cuda(lengths), k_scale=_fake_cuda(sc),
        v_scale=_fake_cuda(sc))
    assert len(launched) == 2
    delta = {n: port_attention.launch_counts[n] - counts[n] for n in counts}
    assert delta == {n: int(n in (port_attention.WINDOW,
                                  port_attention.WINDOW_INT8KV))
                     for n in counts}


def test_window_rows_match_the_kernel_source():
    """The wrapper's block cut and the kernel's instantiations agree: a
    window block holds WINDOW_ROWS rows (csrc kWindowRows), decode up to
    MAX_GROUP heads (csrc kMaxGroup)."""
    import re
    from pathlib import Path

    src = (Path(port_attention.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert constant("kWindowRows") == port_attention.WINDOW_ROWS
    assert constant("kMaxGroup") == port_attention.MAX_GROUP
    for t in range(2, port_attention.MAX_WINDOW + 1):
        rows, _ = port_attention.window_rows(1, t)
        assert 2 <= rows <= port_attention.WINDOW_ROWS


def _deployment_window(dtype, seed=8):
    """A verify window at the deployment's widest paged width: 16 slots,
    T = 9, width 391, GPT-2's 12 heads of 64, one short row, one long row
    inside the width and one whose last query reaches it."""
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention

    rng = np.random.default_rng(seed)
    s, h, t, width = 16, 12, 9, 391
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((s, h, t, DH), (1, s, h, width, DH),
                             (1, s, h, width, DH)))
    lengths = rng.integers(1, width - t + 2, s).astype(np.int32)
    lengths[0], lengths[1], lengths[-1] = 1, width // 2 + 1, width - t + 1
    lengths = torch.from_numpy(lengths)
    dt = getattr(torch, dtype)

    def plain(lens, cast=dt):
        return port_attention.decode_attention_reference(
            q.to(dt).to(cast), k.to(dt).to(cast), v.to(dt).to(cast), 0,
            None, lens)

    return sweep_attention, plain, lengths, width, t


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_window_check_passes_rounding_alone(dtype):
    """`sweep_attention.window_error`, which holds the kernel's window to
    its plain version row by row, passes the plain version in `dtype`
    against the same inputs computed wider (float32 for bf16, float64 for
    float32): rounding alone stays inside each row's limit."""
    sweep, plain, lengths, _, _ = _deployment_window(dtype)
    wide = torch.float32 if dtype == "bfloat16" else torch.float64
    check = sweep.window_error(plain(lengths), plain(lengths, wide), dtype)
    assert check["ok"], check


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fault", ["all_rows_plus_1", "long_rows_plus_1"])
def test_window_check_catches_a_planted_frontier_fault(dtype, fault):
    """A frontier one key late fails the row-by-row check, also when only
    the long rows (outputs averaged down near 0.1) carry it; rows whose
    last query reaches the width keep their lengths."""
    sweep, plain, lengths, width, t = _deployment_window(dtype)
    bad = sweep.window_faults(lengths, width, t)[fault]
    assert int((lengths + t - 1).max()) == width
    assert int((bad + t - 1).max()) == width  # no key past the width
    assert (bad != lengths).any()
    check = sweep.window_error(plain(bad), plain(lengths), dtype)
    assert not check["ok"], check
