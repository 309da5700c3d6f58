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
import dataclasses
import functools
import inspect
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

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


def _check_window_plan(plan, b, hkv, s, dh, elem, rows):
    """The tensor-core window's plan: one block a (row, KV head, split),
    tiles of 16-key blocks, its own shared-memory sum, inside the card's."""
    n = plan.n_split
    assert n in (1, 2, 4, 8) and plan.blocks == b * hkv * n
    assert (n - 1) * plan.split_keys < s <= n * plan.split_keys
    cap = min(port_attention.WINDOW_TILE_KEYS,
              port_attention.TILE_BYTES // (dh * elem))
    assert plan.tile_keys % 16 == 0 and 16 <= plan.tile_keys <= cap
    assert plan.tile_keys <= -(-plan.split_keys // 16) * 16
    n_tiles = -(-plan.split_keys // plan.tile_keys)
    assert 1 <= plan.stages <= n_tiles and (plan.stages >= 2 or n_tiles == 1)
    ring = plan.stages * 2 * plan.tile_keys * dh * elem
    assert ring <= max(port_attention.WINDOW_RING_BYTES,
                       2 * plan.tile_keys * dh * elem * 2)
    assert plan.smem_bytes == port_attention._window_smem_bytes(
        rows, dh, plan.tile_keys, elem, plan.stages, n)
    assert plan.smem_bytes <= port_attention.SMEM_LIMIT


@pytest.mark.parametrize("b", MAIN_BATCHES + (16,))
@pytest.mark.parametrize("t", [2, 5, 9, 16])
def test_launch_plan_invariants_for_a_window(b, t):
    """The plan of a verify window. bf16 q (tensor cores): every GPT-2
    window is one m16 tile a (row, head), so the launch has one block a
    (row, head, split) and K and V are read once a (row, head), in both
    cache types; the 16 slots x 12 heads of the paged step are not split
    up to GPT-2's 1,024 keys. float32 q (CUDA cores): the window's rows in blocks of at
    most F32_WINDOW_ROWS, the tile that of a multi-row block (<= 64 keys).
    """
    rows, chunks = port_attention.window_rows(1, t, torch.bfloat16)
    assert (rows, chunks) == (port_attention.WINDOW_ROWS, 1)
    for dtype in (torch.bfloat16, torch.int8):
        for s in (160, 167, 384, 391, 640, 1024):
            plan = port_attention.launch_plan(b, 12, s, 64, dtype,
                                              group=rows, chunks=chunks,
                                              tensor_cores=True)
            _check_window_plan(plan, b, 12, s, 64, dtype.itemsize, rows)
            if b == 16:  # 192 blocks: no split up to 1,024 keys
                assert plan.n_split == 1
    rows, chunks = port_attention.window_rows(1, t, torch.float32)
    assert rows <= port_attention.F32_WINDOW_ROWS
    for dtype in (torch.float32, torch.int8):
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
    """The wrapper's block cut and the kernel's constants agree: a bf16
    window's m16 tile of WINDOW_ROWS rows (csrc kWindowRows), at most
    MAX_WINDOW_TILES of them a block (kMaxTiles), over tiles of at most
    WINDOW_TILE_KEYS keys (kWindowTileKeys); a float32 window's blocks of
    at most F32_WINDOW_ROWS rows (kF32WindowRows); decode up to MAX_GROUP
    heads (kMaxGroup). Every GQA window up to MAX_GROUP x MAX_WINDOW rows
    fits one block of tiles, never more blocks a (row, KV head)."""
    import re
    from pathlib import Path

    src = (Path(port_attention.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert constant("kWindowRows") == port_attention.WINDOW_ROWS == 16
    assert constant("kMaxTiles") == port_attention.MAX_WINDOW_TILES
    assert constant("kWindowTileKeys") == port_attention.WINDOW_TILE_KEYS
    assert constant("kF32WindowRows") == port_attention.F32_WINDOW_ROWS
    assert constant("kMaxGroup") == port_attention.MAX_GROUP
    for group in range(1, port_attention.MAX_GROUP + 1):
        for t in range(2, port_attention.MAX_WINDOW + 1):
            rows, chunks = port_attention.window_rows(group, t,
                                                      torch.bfloat16)
            tiles = rows // port_attention.WINDOW_ROWS
            assert chunks == 1 and rows % port_attention.WINDOW_ROWS == 0
            assert tiles & (tiles - 1) == 0  # warps split evenly over tiles
            assert tiles <= port_attention.MAX_WINDOW_TILES
            assert rows >= group * t and (tiles == 1 or rows // 2 < group * t)
            rows, _ = port_attention.window_rows(group, t, torch.float32)
            assert 2 <= rows <= port_attention.F32_WINDOW_ROWS


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


# ------------------------------- the tensor-core window, modelled in numpy

def _bf16(x):
    """x rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _window_tile_model(q, k, v, layer, lengths, bias, ks, vs, plan, rows):
    """The tensor-core window kernel's arithmetic in float32 numpy.

    One block a (row, KV head, split) holds the G * T query rows (head-
    major) in rows // 16 m16 tiles; warp w takes tile w % n_mt and, of each
    staged tile of `plan.tile_keys` keys, the 16-key blocks kb = w // n_mt,
    + 8 // n_mt, ... Per 16-key block: S = Q K^T in float32 (bf16 q, bf16
    or int8 K: exact products), times ks[key] and Dh^-1/2, plus the bias;
    a row's keys at or past its own frontier min(lengths + t, S) have no
    weight (p = 0, the row's maximum untouched); the block's row maximum
    rescales (m, l, o); P times vs[key] is rounded to bf16 before P V.
    Then the warps of a tile merge, the splits merge (weights
    exp(m - max m)), and o / l is rounded to bf16. (The kernel takes the
    same softmax in base 2, scores times log2 e and exp2, which changes
    the weights by float rounding only.)"""
    b, h, t, dh = q.shape
    hkv, s = k.shape[2], k.shape[3]
    group, n_rows = h // hkv, (h // hkv) * t
    n_mt = rows // 16
    n_kw = 8 // n_mt
    scale = np.float32(1.0 / np.sqrt(dh))
    out = np.zeros((b, h, t, dh), np.float32)
    f = np.arange(rows)
    with np.errstate(over="ignore"):
        for row in range(b):
            s_max = min(int(lengths[row]) + t - 1, s)
            frontier = np.where(f < n_rows,
                                np.minimum(lengths[row] + f % t, s), 0)
            for g in range(hkv):
                Q = np.zeros((rows, dh), np.float32)
                Q[:n_rows] = q[row, g * group:(g + 1) * group].reshape(
                    n_rows, dh)
                K = k[layer, row, g].astype(np.float32)
                V = v[layer, row, g].astype(np.float32)
                kss = ks[layer, row, g] if ks is not None else np.ones(s)
                vss = vs[layer, row, g] if vs is not None else np.ones(s)
                bs = bias[row, 0] if bias is not None else np.zeros(s)
                parts = []
                for split in range(plan.n_split):
                    start = split * plan.split_keys
                    n_keys = max(min(s_max, start + plan.split_keys) - start,
                                 0)
                    nk = np.minimum(frontier - start, n_keys)
                    m = np.full((8, 16), _LOWEST, np.float32)
                    l = np.zeros((8, 16), np.float32)
                    o = np.zeros((8, 16, dh), np.float32)
                    for t0 in range(0, n_keys, plan.tile_keys):
                        n_kb = -(-min(plan.tile_keys, n_keys - t0) // 16)
                        for w in range(8):
                            rs = slice(16 * (w % n_mt), 16 * (w % n_mt) + 16)
                            for kb in range(w // n_mt, n_kb, n_kw):
                                j = t0 + 16 * kb + np.arange(16)
                                real = j < n_keys
                                jj = np.where(real, start + j, 0)
                                sc = (Q[rs] @ K[jj].T) * kss[jj].astype(
                                    np.float32) * scale + bs[jj]
                                seen = j[None, :] < nk[rs, None]
                                x = np.where(seen, sc, _LOWEST).astype(
                                    np.float32)
                                m_new = np.maximum(m[w], x.max(1))
                                alpha = np.exp(m[w] - m_new)
                                p = np.where(seen, np.exp(x - m_new[:, None]),
                                             np.float32(0))
                                pv = _bf16(p * np.where(real, vss[jj], 0))
                                l[w] = l[w] * alpha + p.sum(1,
                                                            dtype=np.float32)
                                o[w] = o[w] * alpha[:, None] + pv @ np.where(
                                    real[:, None], V[jj], 0)
                                m[w] = m_new
                    mm, ll, oo = [], [], []
                    for mt in range(n_mt):
                        ws = [mt + n_mt * kw for kw in range(n_kw)]
                        top = m[ws].max(0)
                        a = np.exp(m[ws] - top)
                        mm.append(top)
                        ll.append((a * l[ws]).sum(0))
                        oo.append((a[:, :, None] * o[ws]).sum(0))
                    parts.append((np.concatenate(mm), np.concatenate(ll),
                                  np.concatenate(oo)))
                top = np.max([pm for pm, _, _ in parts], axis=0)
                wts = [np.exp(pm - top) for pm, _, _ in parts]
                l_all = sum(wk * pl for wk, (_, pl, _) in zip(wts, parts))
                o_all = sum(wk[:, None] * po
                            for wk, (_, _, po) in zip(wts, parts))
                res = _bf16(o_all[:n_rows] / l_all[:n_rows, None])
                out[row, g * group:(g + 1) * group] = res.reshape(group, t,
                                                                  dh)
    return out


def _tile_case(t, width, cache, h=2, hkv=2, b=2, seed=0):
    """bf16 q [b, h, t, 64] and a two-layer cache of `width` slots in an
    allocation 32 slots wider; row 0's window starts at key 1 (its first
    query's frontier ends inside the first 16-key block), row b-1's last
    query reaches the width. `cache`: "int8" (quantized, with scales),
    "bf16", or "bf16_bias" (plus the bucketed engine's left padding)."""
    rng = np.random.default_rng(seed)
    dh, s_alloc = 64, width + 32
    q = _bf16(rng.standard_normal((b, h, t, dh)))
    kf = rng.standard_normal((2, b, hkv, s_alloc, dh)).astype(np.float32)
    vf = rng.standard_normal((2, b, hkv, s_alloc, dh)).astype(np.float32)
    lengths = rng.integers(1, width - t + 2, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, width - t + 1
    ks = vs = bias = None
    if cache == "int8":
        k8, ksj = jax_common.quantize_kv(jnp.asarray(kf))
        v8, vsj = jax_common.quantize_kv(jnp.asarray(vf))
        k, v, ks, vs = (np.ascontiguousarray(np.asarray(a)[:, :, :, :width])
                        for a in (k8, v8, ksj, vsj))
    else:
        k, v = (_bf16(a[:, :, :, :width]) for a in (kf, vf))
    keys = np.arange(width)
    frontier = lengths[:, None] + np.arange(t)[None, :]
    mask = (keys[None, None, :] < frontier[:, :, None])[:, None]  # B1TS
    if cache == "bf16_bias":
        pad = (rng.random(b) * lengths).astype(np.int64)
        valid = keys[None, :] >= pad[:, None]
        mask = mask & valid[:, None, None, :]
        bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, :]
    return q, k, v, lengths, bias, ks, vs, mask


def _torch_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _plain_and_plan(q, k, v, lengths, bias, ks, vs):
    """The plain version's output and the layout the wrapper would launch,
    on the same bf16 tensors."""
    tq = _torch_bf16(q)
    tk, tv = ((torch.from_numpy(a) if a.dtype == np.int8 else _torch_bf16(a))
              for a in (k, v))
    extra = ({} if ks is None else
             dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    tb = None if bias is None else torch.from_numpy(bias)
    tl = torch.from_numpy(lengths)
    plain = port_attention.decode_attention(tq, tk, tv, LAYER, tb,
                                            lengths=tl, **extra)
    lay = port_attention._kernel_layout(tq, tk, tv, tb, tl,
                                        extra.get("k_scale"),
                                        extra.get("v_scale"))
    return plain, lay


TILE_CASES = [(t, width, cache) for t in (2, 9, 16) for width in (167, 640)
              for cache in ("int8", "bf16", "bf16_bias")]


@pytest.mark.parametrize("t,width,cache", TILE_CASES)
def test_window_tile_model_matches_reference_and_jax(t, width, cache):
    """The tensor-core window's arithmetic (`_window_tile_model`: 16-row
    tiles, n8/k16 key blocks, ks on the score columns, per-row frontiers,
    the tile-wise online softmax, P x vs rounded to bf16 before P V) on the
    plan the wrapper launches, against the plain version and the JAX
    package's attend_quant / attend under the ragged path's mask, on the
    same numpy-seeded bf16 inputs. Tolerance: each query row within 2e-2
    of its own largest output (`sweep_attention.window_error`, phase 7's
    bf16 limit): both sides round probabilities and the output to bf16, at
    different places."""
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention

    q, k, v, lengths, bias, ks, vs, mask = _tile_case(t, width, cache,
                                                      seed=t + width)
    assert (lengths[0] + np.arange(t) < 16).any()  # inside the first block
    plain, lay = _plain_and_plan(q, k, v, lengths, bias, ks, vs)
    assert (lay.args.rows, lay.args.n_chunks) == (16, 1)
    model = _window_tile_model(q, k, v, LAYER, lengths, bias, ks, vs,
                               lay.plan, lay.args.rows)
    assert np.isfinite(model).all()
    jq = jnp.asarray(q, jnp.bfloat16)
    if cache == "int8":
        want = jax_common.attend_quant(
            jq, jnp.asarray(k[LAYER]), jnp.asarray(ks[LAYER]),
            jnp.asarray(v[LAYER]), jnp.asarray(vs[LAYER]), jnp.asarray(mask))
    else:
        want = jax_common.attend(jq, jnp.asarray(k[LAYER], jnp.bfloat16),
                                 jnp.asarray(v[LAYER], jnp.bfloat16),
                                 jnp.asarray(mask))
    got = torch.from_numpy(model)
    for ref in (plain, torch.from_numpy(np.asarray(want, np.float32))):
        check = sweep_attention.window_error(got, ref, "bfloat16")
        assert check["ok"], check


def test_window_tile_model_takes_gqa_tiles():
    """A GQA window past one m16 tile (4 query heads a KV head, T = 9: 36
    rows in 4 tiles, two warps a tile) against the plain version, which
    repeats K and V per query head."""
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention

    q, k, v, lengths, bias, ks, vs, _ = _tile_case(9, 167, "int8", h=4,
                                                   hkv=1, seed=5)
    plain, lay = _plain_and_plan(q, k, v, lengths, bias, ks, vs)
    assert (lay.args.rows, lay.args.n_chunks) == (64, 1)
    model = _window_tile_model(q, k, v, LAYER, lengths, bias, ks, vs,
                               lay.plan, lay.args.rows)
    check = sweep_attention.window_error(torch.from_numpy(model), plain,
                                         "bfloat16")
    assert check["ok"], check


def test_window_tile_model_fully_masked_tail_tile_weighs_zero():
    """A staged tile whose every key the bias masks (scores about -1e30)
    changes nothing: the model equals the model over the cache without that
    tile, bit for bit. A warp whose blocks are all masked merges with
    weight exp(-1e30 - max m) = 0; one that saw a real key keeps its
    maximum and adds p = 0."""
    t, width = 9, 256
    q, k, v, lengths, _, _, _, _ = _tile_case(t, width, "bf16", seed=12)
    lengths[:] = width  # every row sees every key
    bias = np.zeros((len(lengths), 1, width), np.float32)
    bias[..., 128:] = -1e30     # the second tile of 128 keys
    plan = port_attention.LaunchPlan(n_split=1, split_keys=width,
                                     tile_keys=128, stages=2, smem_bytes=0,
                                     blocks=0)
    both = _window_tile_model(q, k, v, LAYER, lengths, bias, None, None,
                              plan, 16)
    head = _window_tile_model(
        q, np.ascontiguousarray(k[:, :, :, :128]),
        np.ascontiguousarray(v[:, :, :, :128]), LAYER,
        np.full_like(lengths, 128), bias[..., :128].copy(), None,
        None, dataclasses.replace(plan, split_keys=128), 16)
    np.testing.assert_array_equal(both, head)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_bf16_windows_take_the_tensor_core_kernel(monkeypatch, kv):
    """The dispatch, pinned: a bf16 window on CUDA tensors, over a bf16 or
    an int8 cache, launches the kernel with the tensor-core plan (one block
    of 16-row tiles a (row, KV head, split)) and never the plain version; a
    float32 window gets the CUDA-core plan (blocks of at most 4 rows); one
    query row (decode) neither window plan. The kernel runs the tensor-core
    window exactly for bf16 q and refuses a plan of the other kind (csrc
    `tensor_core_window`, `valid_rows`)."""
    launched = []
    monkeypatch.setattr(port_attention, "_entry_point",
                        lambda: (lambda *a: launched.append(a) or 0,
                                 lambda index: 0))
    monkeypatch.setattr(port_attention, "_layouts", {})

    def no_plain(*args):
        raise AssertionError("plain path taken for CUDA tensors")

    monkeypatch.setattr(port_attention, "decode_attention_reference",
                        no_plain)
    b, t, dh, s = 4, 9, 64, 167
    lengths = _fake_cuda(np.array([1, 50, 100, s - t + 1], np.int32))
    extra, variant = {}, port_attention.WINDOW
    if kv == "int8":
        sc = _fake_cuda(np.ones((L, b, H, s), np.float32))
        extra, variant = dict(k_scale=sc, v_scale=sc), \
            port_attention.WINDOW_INT8KV

    def cache(qt):  # the cache beside queries of type qt
        zeros = _fake_cuda(np.zeros((L, b, H, s, dh), np.float32))
        return zeros.to(torch.int8 if kv == "int8" else qt)

    for qt in (torch.bfloat16, torch.float32):
        q = _fake_cuda(np.zeros((b, H, t, dh), np.float32)).to(qt)
        counts = dict(port_attention.launch_counts)
        port_attention.decode_attention(q, cache(qt), cache(qt), LAYER,
                                        lengths=lengths, **extra)
        (lay,) = port_attention._layouts.values()
        port_attention._layouts.clear()
        assert lay.variant == variant
        if qt == torch.bfloat16:
            assert port_attention.tensor_core_window(t, qt)
            assert (lay.args.rows, lay.args.n_chunks) == (16, 1)
            assert lay.plan == port_attention.launch_plan(
                b, H, s, dh, cache(qt).dtype, group=16, tensor_cores=True)
            assert lay.plan.blocks == b * H * lay.plan.n_split
        else:
            assert not port_attention.tensor_core_window(t, qt)
            assert lay.args.rows <= port_attention.F32_WINDOW_ROWS
            assert lay.args.n_chunks > 1
        delta = {n: port_attention.launch_counts[n] - counts[n]
                 for n in counts}
        assert delta == {n: int(n == variant) for n in counts}
    decode = _fake_cuda(np.zeros((b, H, 1, dh), np.float32)).to(
        torch.bfloat16)
    kd = cache(torch.bfloat16)
    port_attention.decode_attention(decode, kd, kd, LAYER, lengths=lengths,
                                    **extra)
    (lay,) = port_attention._layouts.values()
    assert not port_attention.tensor_core_window(1, torch.bfloat16)
    assert lay.args.rows == 1 and lay.variant in (port_attention.RAGGED,
                                                  port_attention.INT8KV)
    assert len(launched) == 3


def test_graph_routes_count_both_window_kernels():
    """A captured graph's window nodes, by device name, land in the window
    route whichever window kernel they are (tensor-core for bf16 q,
    CUDA-core for float32), and in no other route."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_names,
    )

    names = {
        "_ZN12_GLOBAL__N_134decode_attention_window_mma_kernelIaLi64EEEvPK"
        "13__nv_bfloat16": 12,
        "_ZN12_GLOBAL__N_130decode_attention_window_kernelIfaLi64ELi4EEEv": 3,
        "_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16": 5,
    }
    routes = routes_of_names(names)
    assert routes["decode_attention_window"] == 15
    assert routes["decode_attention"] == 5
    assert sum(routes.values()) == 20


def test_window_probe_instruments_the_kernel_source():
    """`ops/probe_window.py` stamps each phase of the tensor-core window
    kernel once, thread 0 only, and nothing outside that kernel; its
    anchors are lines of the shipped source, so an edit that moves one
    fails here rather than on the card."""
    from distributed_lms_raft_llm_tpu_torch.ops import build, probe_window

    src = (build.CSRC / "decode_attention.cu").read_text()
    out = probe_window.instrument(src)
    start = out.index(probe_window.KERNEL_START)
    end = out.index(probe_window.KERNEL_END)
    stamps = out[start:end].count("= probe_now();")
    assert stamps == len(probe_window.PHASES)
    assert out[start:end].count("= clock64();") == 2
    assert "probe_now" not in out[end:]
    assert out.replace("g_probe", "") != out and "g_probe" not in src


# ------------------------------ the paged step's append kernel (plain)


def _append_inputs(b, hkv, case, seed):
    """q [B, H, 1, DH], k_new/v_new [B, Hkv, 1, DH], a cache [L, B, Hkv, S,
    DH] with per-slot scales (int8 from `quantize_kv` of random rows) and
    per-row lengths: `case` "spread" (random lengths), "dead_slot" (a row
    at the cache's width: the engine's clamped dead or full slot),
    "zero_row" (an all-zero new row: scale 1e-8), "clip" (rows at plus and
    minus their amax: codes +-127) or "ties" (x / s exactly k + 0.5: round
    half to even)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, 1, DH)).astype(np.float32)
    new = rng.standard_normal((2, b, hkv, 1, DH)).astype(np.float32)
    cache = rng.standard_normal((2, L, b, hkv, S, DH)).astype(np.float32)
    lengths = rng.integers(1, S + 1, b).astype(np.int32)
    lengths[0] = 1
    if case == "dead_slot":
        lengths[-1] = S
    elif case == "zero_row":
        new[:, -1] = 0.0
    elif case == "clip":
        amax = np.abs(new).max(axis=-1, keepdims=True)
        new[..., :DH // 2] = amax
        new[..., DH // 2:] = -amax
    elif case == "ties":  # amax 127: s = 1 exactly, x / s = x
        halves = np.arange(DH, dtype=np.float32) - DH / 2 + 0.5
        new[:] = halves
        new[..., 0] = 127.0
    return q, new[0], new[1], cache, lengths


APPEND_CASES = ["spread", "dead_slot", "zero_row", "clip", "ties"]


@pytest.mark.parametrize("cache", ["int8", "float32"])
@pytest.mark.parametrize("case", APPEND_CASES)
def test_append_reference_matches_jax_quantize_and_set(cache, case):
    """The append kernel's plain version against the JAX paged step
    (distributed_lms_raft_llm_tpu/models/gpt2.py: `quantize_kv`, then
    `.at[layer, rows, :, slots].set` at slot lengths[b] - 1, then
    attend_quant / attend over lengths[b] keys): the cache (int8 rows and
    scales, or float rows) array-equal, the output within 1e-6 (float32,
    the sums' order)."""
    b, hkv = 3, 2
    q, k_new, v_new, kv, lengths = _append_inputs(
        b, hkv, case, seed=APPEND_CASES.index(case) + 7 * (cache == "int8"))
    rows = jnp.arange(b)[:, None]
    slots = jnp.asarray(lengths - 1)[:, None]
    mask = jnp.asarray(_lengths_mask(lengths, S))
    jq = jnp.asarray(q)
    if cache == "int8":
        (k8, ks), (v8, vs) = (jax_common.quantize_kv(jnp.asarray(x))
                              for x in kv)
        (kn, kns), (vn, vns) = (jax_common.quantize_kv(jnp.asarray(x))
                                for x in (k_new, v_new))
        want_cache = [
            k8.at[LAYER, rows, :, slots].set(kn.transpose(0, 2, 1, 3)),
            v8.at[LAYER, rows, :, slots].set(vn.transpose(0, 2, 1, 3)),
            ks.at[LAYER, rows, :, slots].set(kns.transpose(0, 2, 1)),
            vs.at[LAYER, rows, :, slots].set(vns.transpose(0, 2, 1))]
        rep = [jnp.repeat(x[LAYER], H // hkv, axis=1) for x in want_cache]
        want = jax_common.attend_quant(jq, rep[0], rep[2], rep[1], rep[3],
                                       mask)
        port = [torch.from_numpy(np.array(x)) for x in (k8, v8, ks, vs)]
    else:
        want_cache = [jnp.asarray(x).at[LAYER, rows, :, slots].set(
            jnp.asarray(n).transpose(0, 2, 1, 3))
            for x, n in zip(kv, (k_new, v_new))]
        rep = [jnp.repeat(x[LAYER], H // hkv, axis=1) for x in want_cache]
        want = jax_common.attend(jq, rep[0], rep[1], mask)
        port = [torch.from_numpy(x.copy()) for x in kv] + [None, None]
    got = port_attention.decode_attention_append(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        port[0], port[1], LAYER, lengths=torch.from_numpy(lengths),
        k_scale=port[2], v_scale=port[3])
    for mine, theirs in zip(port, want_cache):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if cache == "int8" and case in ("zero_row", "clip", "ties"):
        codes = port[0].numpy()[LAYER, np.arange(b), :, lengths - 1]
        scales = port[2].numpy()[LAYER, np.arange(b), :, lengths - 1]
        if case == "zero_row":
            assert (codes[-1] == 0).all()
            assert (scales[-1] == np.float32(1e-8)).all()
        elif case == "clip":
            assert set(np.unique(np.abs(codes))) == {127}
        else:  # ties to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0
            assert (scales == 1.0).all()
            want_codes = np.round(k_new[:, :, 0]).astype(np.int8)
            np.testing.assert_array_equal(codes, want_codes)
            assert codes[0, 0, DH // 2 + 2] == 2  # 2.5


def test_append_reference_equals_the_torch_route_it_replaces():
    """The plain version is the model's old route, bit for bit: the port's
    `quantize_kv` and `_write_rows` at the step's slots, then
    `decode_attention` with lengths."""
    from distributed_lms_raft_llm_tpu_torch.models.gpt2 import _write_rows

    b, hkv = 3, 4
    q, k_new, v_new, kv, lengths = _append_inputs(b, hkv, "dead_slot", 3)
    k_new, v_new, q = (torch.from_numpy(x) for x in (k_new, v_new, q))
    (k8, ks), (v8, vs) = (port_common.quantize_kv(torch.from_numpy(x))
                          for x in kv)
    lengths = torch.from_numpy(lengths)
    mine = [x.clone() for x in (k8, v8, ks, vs)]
    got = port_attention.decode_attention_append(
        q, k_new, v_new, mine[0], mine[1], LAYER, lengths=lengths,
        k_scale=mine[2], v_scale=mine[3])
    rows = torch.arange(b)[:, None]
    slots = (lengths.long() - 1)[:, None]
    (kw, kws), (vw, vws) = (port_common.quantize_kv(x) for x in (k_new,
                                                                 v_new))
    for buf, val in ((k8, kw), (v8, vw), (ks, kws), (vs, vws)):
        _write_rows(buf, LAYER, rows, slots, val.transpose(1, 2), None)
    want = port_attention.decode_attention(q, k8, v8, LAYER, lengths=lengths,
                                           k_scale=ks, v_scale=vs)
    for a, b_ in zip(mine, (k8, v8, ks, vs)):
        assert torch.equal(a, b_)
    assert torch.equal(got, want)


def test_append_arguments_are_checked():
    q, k_new, v_new, kv, lengths = _append_inputs(2, 4, "spread", 5)
    args = [torch.from_numpy(x) for x in (q, k_new, v_new, *kv)]
    with pytest.raises(ValueError, match="per-row lengths"):
        port_attention.decode_attention_append(*args, LAYER, lengths=None)
    with pytest.raises(ValueError, match="k_new must be"):
        port_attention.decode_attention_append(
            args[0], args[1][:, :2], *args[2:], LAYER,
            lengths=torch.from_numpy(lengths))


def test_append_dispatch_is_static():
    """Source-level pins: the append entry has no try, takes its plain
    version only under `device.type == "cpu"`, and launches through the
    one counted launch of `_launch_kernel` otherwise."""
    tree = _function_ast(port_attention.decode_attention_append)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain_calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        for inner in ast.walk(node):
            if isinstance(inner, ast.Call) and getattr(inner.func, "id", "") \
                    == "decode_attention_append_reference":
                plain_calls.append(ast.unparse(node.test))
    assert plain_calls == ["device.type == 'cpu'"]
    calls = {n.func.id for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)}
    assert "_launch_kernel" in calls
    assert "launch_counts" not in inspect.getsource(
        port_attention.decode_attention_append_reference)


def test_append_on_cuda_tensors_raises_without_a_build(monkeypatch,
                                                       tmp_path):
    """CUDA tensors given to the append entry where the kernel cannot be
    built (no nvcc): it raises; the plain version is never taken."""
    from distributed_lms_raft_llm_tpu_torch.ops import build

    def no_plain(*args, **kwargs):
        raise AssertionError("plain path taken for CUDA tensors")

    monkeypatch.setattr(port_attention, "decode_attention_append_reference",
                        no_plain)
    monkeypatch.setattr(port_attention, "_append_bound", None)
    monkeypatch.setattr(port_attention, "_layouts", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    q, k_new, v_new, kv, lengths = _append_inputs(2, 4, "spread", 5)
    q = np.ascontiguousarray(np.repeat(q, 2, axis=-1))  # Dh 16: 16-byte rows
    k_new, v_new = (np.repeat(x, 2, axis=-1) for x in (k_new, v_new))
    kv = np.ascontiguousarray(np.repeat(kv, 2, axis=-1))
    before = dict(port_attention.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        port_attention.decode_attention_append(
            _fake_cuda(q), _fake_cuda(k_new), _fake_cuda(v_new),
            _fake_cuda(kv[0]), _fake_cuda(kv[1]), LAYER,
            lengths=_fake_cuda(lengths))
    assert port_attention.launch_counts == before


@pytest.mark.parametrize("cache", ["int8", "float32"])
def test_append_launch_passes_new_rows_and_counts_its_variant(monkeypatch,
                                                              cache):
    """The wrapper's launch on CUDA tensors: the append entry point with q,
    k_new, v_new, the cache, its scales and lengths in the C order; the
    append plan (its shared memory) and the new rows' strides in the
    arguments; a programmatic dependent only when the caller asks; one
    count a launch on its variant, none on another."""
    launched = []
    monkeypatch.setattr(port_attention, "_append_entry_point",
                        lambda: (lambda *a: launched.append(a) or 0,
                                 lambda index: 0))
    monkeypatch.setattr(port_attention, "_entry_point", None)
    monkeypatch.setattr(port_attention, "_layouts", {})
    b, hkv, dh, s = 4, 4, 64, 40
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((b, 1, (H + 2 * hkv) * dh)).astype(np.float32)
    t = _fake_cuda(qkv)
    q = t[..., :H * dh].reshape(b, 1, H, dh).transpose(1, 2)
    k_new = t[..., H * dh:(H + hkv) * dh].reshape(b, 1, hkv, dh).transpose(
        1, 2)
    v_new = t[..., (H + hkv) * dh:].reshape(b, 1, hkv, dh).transpose(1, 2)
    shape = (L, b, hkv, s, dh)
    extra, variant = {}, port_attention.APPEND
    k = _fake_cuda(np.zeros(shape, np.float32))
    if cache == "int8":
        k = k.to(torch.int8)
        sc = _fake_cuda(np.ones(shape[:4], np.float32))
        extra, variant = dict(k_scale=sc, v_scale=sc), \
            port_attention.APPEND_INT8KV
    lengths = _fake_cuda(np.array([1, 9, 40, 17], np.int32))
    counts = dict(port_attention.launch_counts)
    out = port_attention.decode_attention_append(q, k_new, v_new, k, k, LAYER,
                                                 lengths=lengths, **extra)
    port_attention.decode_attention_append(q, k_new, v_new, k, k, LAYER,
                                           lengths=lengths, **extra,
                                           dependent=True)
    assert tuple(out.shape) == (b, H, 1, dh)
    (lay,) = port_attention._layouts.values()
    assert lay.variant == variant
    assert lay.plan == port_attention.launch_plan(b, hkv, s, dh, k.dtype,
                                                  group=H // hkv,
                                                  append=True)
    assert (lay.args.kn_sb, lay.args.kn_sh) == k_new.stride()[:2]
    args, dependent = launched
    assert args[0] == lay.address and args[-3] == LAYER
    assert (args[-2], dependent[-2]) == (0, 1)
    assert dependent[:10] + dependent[-3:-2] == args[:10] + args[-3:-2]
    assert args[1:6] == (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                         k.data_ptr(), k.data_ptr())
    scales = ((sc.data_ptr(), sc.data_ptr()) if cache == "int8"
              else (None, None))
    assert args[6:10] == (*scales, None, lengths.data_ptr())
    delta = {n: port_attention.launch_counts[n] - counts[n] for n in counts}
    assert delta == {n: 2 * int(n == variant) for n in counts}


def test_append_constants_match_the_kernel_source():
    """The kernels' block size (csrc kThreads, the append kernel's too) is
    the one the wrapper sizes its shared memory for, and the append plan
    adds exactly the new rows and their 16 bytes to the decode plan."""
    import re
    from pathlib import Path

    src = (Path(port_attention.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    assert threads == 32 * port_attention.WARPS
    for dtype, dh in ((torch.int8, 64), (torch.bfloat16, 64),
                      (torch.float32, 128)):
        for b, s, group in ((16, 384, 1), (16, 1024, 1), (2, 384, 4)):
            plan = port_attention.launch_plan(b, 12 // group, s, dh, dtype,
                                              group=group, append=True)
            base = port_attention.launch_plan(b, 12 // group, s, dh, dtype,
                                              group=group)
            rest = port_attention._smem_bytes(
                group, dh, plan.tile_keys, dtype.itemsize, plan.stages,
                plan.n_split)
            assert (plan.n_split, plan.tile_keys, plan.stages) == (
                base.n_split, base.tile_keys, base.stages)
            assert plan.smem_bytes == -(-rest // 16) * 16 \
                + 2 * dh * dtype.itemsize + 16


def test_graph_routes_count_the_append_kernel():
    """A captured graph's append-kernel nodes land in their own route, not
    in the one-row kernel's."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )

    names = {
        "_ZN12_GLOBAL__N_130decode_attention_append_kernelI13__nv_bfloat16"
        "aLi64ELi1EEEvPKT_": 12,
        "_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16": 5,
    }
    routes = routes_of_names(names)
    assert routes["decode_attention_append"] == 12
    assert routes["decode_attention"] == 5
    assert sum(routes.values()) == 17
    counts = routes_of_counts({port_attention.APPEND_INT8KV: 3,
                               port_attention.APPEND: 2,
                               port_attention.INT8KV: 1})
    assert counts["decode_attention_append"] == 5
    assert counts["decode_attention"] == 1


def test_decode_probe_instruments_the_kernel_source():
    """`ops/probe_decode.py` stamps each phase of the CUDA-core body once,
    thread 0 only, and nothing outside it; its anchors and patch points
    are lines of the shipped sources, so an edit that moves one fails here
    rather than on the card."""
    from distributed_lms_raft_llm_tpu_torch.ops import build, probe_decode

    src = (build.CSRC / "decode_attention.cu").read_text()
    for kw in ({}, dict(threads=128), dict(in_order=True)):
        out = probe_decode.instrument(src, **kw)
        start = out.index(probe_decode.KERNEL_START)
        end = out.index(probe_decode.KERNEL_END)
        assert out[start:end].count("= probe_now();") == len(
            probe_decode.PHASES)
        assert out[start:end].count("= clock64();") == 2
        assert "probe_now" not in out[end:]
    assert "constexpr int kThreads = 128;" in probe_decode.instrument(
        src, threads=128)
    assert "return (int)blockIdx.z;" in probe_decode.instrument(
        src, in_order=True)
    mm = (build.CSRC / "int8_matmul.cu").read_text()
    calls = mm.count(probe_decode.TRIGGER_LINE)
    assert calls == 2  # the two dense kernels trigger their dependents
    assert probe_decode.no_trigger(mm).count(probe_decode.TRIGGER_LINE) == 0
