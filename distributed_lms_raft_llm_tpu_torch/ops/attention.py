"""Fused decode attention: a CUDA kernel and its plain version.

Port of `distributed_lms_raft_llm_tpu/ops/attention.py` (the repository's
one Pallas kernel). The kernel, `csrc/decode_attention.cu`, is written by
hand for Hopper (`sm_90a`) and bound through ctypes (`ops/build.py`); its
source notes what bounds it and how it is laid out. It splits the keys of a
(row, KV head) across a thread-block cluster; `launch_plan` picks the split,
the tile and the shared memory from the cache's width alone.

Beyond the Pallas kernel it takes per-row `lengths` (the paged engine's
ragged offsets: keys past a row's length are neither read nor copied) and
an int8 cache with per-slot scales (`common.attend_quant` in one pass), so
the paged engine decodes through it in every cache mode; and a window of
T <= MAX_WINDOW query rows per batch row, the speculative verify window,
where row b's query t sees the keys before `lengths[b] + t` (its own causal
frontier; the JAX package computes this window in XLA). A bf16 window
runs on the tensor cores, all of a (row, KV head)'s query rows in one m16
tile, so K and V are read once; a float32 window (the exactness checks'
type) on the CUDA cores in blocks of at most four rows. `window_rows` says
how the window's rows are cut into blocks.

The paged engine's one-row decode step goes through
`decode_attention_append`: one launch of `decode_attention_append_kernel`
quantizes the step's new K/V row (`common.quantize_kv`, byte for byte; a
float cache takes it as it is), writes it at slot `lengths[b] - 1` and
attends over the row's `lengths[b]` keys, the new one from the block's
shared memory. The model launches it as a programmatic dependent of its
qkv product (`dependent=True`): its prologue (barriers, the copies of the
older cache rows) runs under the end of that product, and it reads q and
the new rows only after the product has ended.

`decode_attention` and `decode_attention_append` dispatch on where their
tensors live: CPU tensors take the plain PyTorch versions
(`decode_attention_reference`, `decode_attention_append_reference`, which
the CPU tests hold against JAX); CUDA tensors launch the kernel or raise.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import operator
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30  # the models' masked score (models/common.py NEG_INF)

KERNEL = "decode_attention"  # the source, csrc/decode_attention.cu
# The kernel's launches are counted by variant: a float or bf16 cache with a
# bias (the bucketed engine), with per-row lengths (the paged engine), and
# an int8 cache with per-slot scales (either engine, `kv_quant`).
RAGGED = "decode_attention_ragged"
INT8KV = "decode_attention_int8kv"
# A verify window (T > 1 query rows a batch row), float/bf16 or int8 cache.
WINDOW = "decode_attention_window"
WINDOW_INT8KV = "decode_attention_window_int8kv"
# The paged one-row decode step with its KV append fused in, over a float
# or bf16 cache and over an int8 cache (`decode_attention_append`).
APPEND = "decode_attention_append"
APPEND_INT8KV = "decode_attention_append_int8kv"
MAX_GROUP = 8     # query rows a block holds, at most (csrc kMaxGroup)
# A bf16 window on the tensor cores: its G * T query rows in m16 tiles of
# WINDOW_ROWS rows (csrc kWindowRows), at most MAX_WINDOW_TILES a block
# (csrc kMaxTiles), over staged tiles of at most WINDOW_TILE_KEYS keys
# (csrc kWindowTileKeys, 16-key blocks); a float32 window on the CUDA cores
# in blocks of at most F32_WINDOW_ROWS rows (csrc kF32WindowRows).
WINDOW_ROWS = 16
MAX_WINDOW_TILES = 8
WINDOW_TILE_KEYS = 128
F32_WINDOW_ROWS = 4
MAX_WINDOW = 16   # query rows a batch row, at most, in a window
HEAD_DIMS = (8, 16, 32, 64, 128)  # csrc instantiations
INT8_HEAD_DIMS = (64, 128)        # csrc instantiations for an int8 cache
WINDOW_HEAD_DIMS = (64, 128)      # csrc instantiations of the window
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launch geometry. The constants marked csrc must match the kernel source.
TARGET_BLOCKS = 96         # split a window until this many blocks run
MAX_SPLIT = 8              # blocks per cluster, the portable maximum (csrc)
MIN_SPLIT_KEYS = 64        # no split shorter than this
MAX_SPLIT_KEYS = 512       # nor longer than this, up to MAX_SPLIT splits
WINDOW_MAX_SPLIT_KEYS = 1024  # the same for a tensor-core window block
TILE_BYTES = 16 * 1024     # bytes of K (and of V) per tile, at most
RING_BYTES = 48 * 1024     # K and V staged per block, at most
WINDOW_RING_BYTES = 96 * 1024  # the same for a tensor-core window block
WARPS = 8                  # warps per block (csrc kThreads / 32)
SMEM_LIMIT = 227 * 1024    # dynamic shared memory a block may use

# Kernel launches by variant, incremented only where a kernel is launched
# (never by the plain path), and for each replay of a CUDA graph by the
# launches captured into it (`engine/graphs.py`). A run resets them, drives
# the main path, and reads them to show the path went through the kernel.
launch_counts: Dict[str, int] = {KERNEL: 0, RAGGED: 0, INT8KV: 0,
                                  WINDOW: 0, WINDOW_INT8KV: 0, APPEND: 0,
                                  APPEND_INT8KV: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, S] boolean attend-mask -> [B, 1, S] additive f32 bias
    (layer-invariant: computed once per decode step)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, 0, 0, :], zero, neg)[:, None, :]


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer: int,
                               bias: Optional[torch.Tensor] = None,
                               lengths: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """Plain PyTorch version: `common.attend` (or, for an int8 cache,
    `common.attend_quant`) on the indexed layer.

    Scores and softmax in f32 with the additive bias (shared by a window's
    rows); key slots at or past `lengths[b] + t` are masked for query row
    t (t = 0 outside a window). A float cache: probabilities cast to the
    cache dtype for the weighted sum. An int8 cache: scores scaled by
    `k_scale` on the key axis, probabilities times `v_scale` cast to q's
    dtype against the int8 values in q's dtype. Output in q's dtype. Query
    head h reads KV head h // (H / Hkv).
    """
    h, t, hkv, s = q.shape[1], q.shape[2], k_cache.shape[2], k_cache.shape[3]
    quant = k_scale is not None
    k = k_cache[layer]
    v = v_cache[layer]
    ks = k_scale[layer] if quant else None
    vs = v_scale[layer] if quant else None
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        if quant:
            ks = ks.repeat_interleave(h // hkv, dim=1)
            vs = vs.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if quant:
        scores = scores * ks[:, :, None, :]
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias[:, :, None, :]
    if lengths is not None:
        keys = torch.arange(s, device=q.device)
        frontier = lengths[:, None] + torch.arange(t, device=q.device)
        scores = torch.where(
            (keys[None, None, :] < frontier[:, :, None])[:, None], scores,
            torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = (probs * vs[:, :, None, :]).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(q.dtype))
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)


def decode_attention_append_reference(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
        bias: Optional[torch.Tensor] = None, *, lengths: torch.Tensor,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the append kernel: the new rows k_new and
    v_new [B, Hkv, 1, Dh] quantized by `common.quantize_kv` (an int8
    cache; a float cache takes them cast to its type), written in place at
    slot lengths[b] - 1 of row b of the indexed layer, with their scales
    beside them, then `decode_attention_reference` over lengths[b] keys."""
    from ..models.common import quantize_kv  # models import ops: not above

    rows = torch.arange(q.shape[0], device=q.device)
    slots = lengths.long() - 1
    if k_scale is not None:
        (k_w, k_s), (v_w, v_s) = quantize_kv(k_new), quantize_kv(v_new)
        k_scale[layer, rows, :, slots] = k_s[:, :, 0]
        v_scale[layer, rows, :, slots] = v_s[:, :, 0]
    else:
        k_w, v_w = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    k_cache[layer, rows, :, slots] = k_w[:, :, 0]
    v_cache[layer, rows, :, slots] = v_w[:, :, 0]
    return decode_attention_reference(q, k_cache, v_cache, layer, bias,
                                      lengths, k_scale, v_scale)


def tensor_core_window(t: int, dtype: torch.dtype) -> bool:
    """Whether a call of `t` query rows a batch row with queries of
    `dtype` runs on the tensor cores: a bf16 window (csrc
    `tensor_core_window`; a float32 one runs on the CUDA cores, and the
    kernel refuses a plan for the other)."""
    return t > 1 and dtype == torch.bfloat16


def window_rows(group: int, t: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(rows a block, blocks a (row, KV head)) of a call with `group` query
    heads a KV head, `t` query rows a batch row and queries of `dtype`.

    Decode (t = 1): one block of the group. A bf16 window (tensor cores):
    one block of n m16 tiles, n the least power of two with 16 n >= group
    * t (GPT-2, whose group is 1, takes one tile at every t <= 16), so K and
    V are read once a (row, KV head). A float32 window (CUDA cores, rows in
    registers): its group * t rows, head-major, cut into as few blocks of
    at most F32_WINDOW_ROWS rows as hold them, of equal size (GPT-2 at t =
    9: three blocks of 3)."""
    if t == 1:
        return group, 1
    n_rows = group * t
    if tensor_core_window(t, dtype):
        tiles = 1
        while tiles * WINDOW_ROWS < n_rows:
            tiles *= 2
        return tiles * WINDOW_ROWS, 1
    chunks = -(-n_rows // F32_WINDOW_ROWS)
    return -(-n_rows // chunks), chunks


# ------------------------------------------------------------ launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut: `n_split` blocks of one cluster share the
    `split_keys`-key ranges of a (row, KV head), each walking its range in
    tiles of `tile_keys` keys through a ring of `stages` tiles;
    `smem_bytes` of dynamic shared memory."""

    n_split: int
    split_keys: int
    tile_keys: int
    stages: int
    smem_bytes: int
    blocks: int


def _window_smem_bytes(rows: int, dh: int, tile: int, elem: int,
                       stages: int, n_split: int) -> int:
    """Dynamic shared memory of a tensor-core window block (csrc
    `window_smem_bytes`): the K/V ring (reused for the warps' 16-row o),
    the warps' m and l, the splits' (m, l, o) slots, and the K and V
    mbarriers of each stage."""
    ring = stages * 2 * tile * dh * elem
    reduce = WARPS * WINDOW_ROWS * dh * 4
    parts = n_split * rows * (dh + 2) if n_split > 1 else 0
    return max(ring, reduce) + 4 * (2 * WARPS * WINDOW_ROWS + parts) \
        + 8 * stages * 2


def _smem_bytes(group: int, dh: int, tile: int, elem: int, stages: int,
                n_split: int) -> int:
    """Dynamic shared memory of one block (csrc `smem_bytes`): the K/V ring
    (reused for the warps' o), the warps' m and l, the splits' (m, l, o)
    slots that rank 0 combines, and the K and V mbarriers of each stage."""
    ring = stages * 2 * tile * dh * elem
    reduce = WARPS * group * dh * 4
    parts = n_split * group * (dh + 2) if n_split > 1 else 0
    return max(ring, reduce) + 4 * (2 * WARPS * MAX_GROUP + parts) \
        + 8 * stages * 2


def _append_smem_bytes(group: int, dh: int, tile: int, elem: int,
                       stages: int, n_split: int) -> int:
    """The append kernel's (csrc `append_smem_bytes`): `_smem_bytes`,
    rounded up to 16 bytes, then its new K and V rows, their two scales
    and an mbarrier (16 bytes)."""
    rest = _smem_bytes(group, dh, tile, elem, stages, n_split)
    return -(-rest // 16) * 16 + 2 * dh * elem + 16


def max_tile_keys(group: int, dh: int, elem: int) -> int:
    """Keys per tile, at most: 128 with one query head a KV head, else 64
    (csrc `max_tile`: a lane group keeps its rows' scores in registers),
    and no more than TILE_BYTES of K."""
    return min(128 if group == 1 else 64, TILE_BYTES // (dh * elem))


def launch_plan(b: int, hkv: int, s: int, dh: int, dtype: torch.dtype,
                group: int = 1, n_split: Optional[int] = None,
                chunks: int = 1, tensor_cores: bool = False,
                append: bool = False) -> LaunchPlan:
    """Pick the split of the keys, the tile and the shared memory.

    A cluster costs latency of its own, about a microsecond on an H100
    (PERF.md, measured with `ops/sweep_attention.py`), so keys are split
    only as far as the card needs: a window that fits one tile is not
    split; a longer one doubles the split count (1, 2, 4, 8: a cluster
    stays within the portable 8 blocks) while the launch has fewer than
    TARGET_BLOCKS blocks or a split holds more than MAX_SPLIT_KEYS keys,
    and every split keeps MIN_SPLIT_KEYS keys. `n_split` forces the count
    instead (the sweep that measures the trade). The tile is at most
    `max_tile_keys`, a multiple of 8 keys and no longer than a split
    needs; the ring holds as many tiles as the split has, up to RING_BYTES
    of K and V (at least two, so a tile can land while another is read).
    `dtype` is the cache's (int8 for a quantized cache). Per-row lengths
    never enter the plan: they live on the device. `group` is the query
    rows a block holds and `chunks` the blocks a (row, KV head) takes over
    its rows (`window_rows`). `tensor_cores`: a bf16 window's block, whose
    warps take a staged tile's 16-key blocks in turn: tiles of up to
    WINDOW_TILE_KEYS keys (a multiple of 16; no more than TILE_BYTES of K),
    a ring of up to WINDOW_RING_BYTES (a split of a few hundred keys is
    staged whole), and its own shared-memory sum (`_window_smem_bytes`);
    its split is no shorter than WINDOW_MAX_SPLIT_KEYS while the launch
    has TARGET_BLOCKS blocks (16 slots x 12 heads at widths 384 and 640
    measured faster unsplit than in two splits on an H100: PERF.md,
    `ops/sweep_attention.py --window`'s forced splits). `append`: the
    append kernel's block (one query row a batch row), cut as decode, with
    its own shared-memory sum (`_append_smem_bytes`).
    """
    rows = b * hkv * chunks
    elem = dtype.itemsize
    cap = (min(WINDOW_TILE_KEYS, TILE_BYTES // (dh * elem)) if tensor_cores
           else max_tile_keys(group, dh, elem))
    step, ring_bytes, longest = (
        (16, WINDOW_RING_BYTES, WINDOW_MAX_SPLIT_KEYS) if tensor_cores
        else (8, RING_BYTES, MAX_SPLIT_KEYS))
    n = 1
    if n_split is not None:
        if n_split not in (1, 2, 4, MAX_SPLIT):
            raise ValueError(f"n_split must be 1, 2, 4 or 8, not {n_split}")
        n = n_split
    elif s > cap:
        while (n < MAX_SPLIT and s >= MIN_SPLIT_KEYS * 2 * n
               and (rows * n < TARGET_BLOCKS or -(-s // n) > longest)):
            n *= 2
    split = -(-s // n)
    tile = min(cap, -(-split // step) * step)
    n_tiles = -(-split // tile)
    stages = min(n_tiles, max(2, ring_bytes // (2 * tile * dh * elem)))
    smem = (_window_smem_bytes(group, dh, tile, elem, stages, n)
            if tensor_cores else
            _append_smem_bytes(group, dh, tile, elem, stages, n) if append
            else _smem_bytes(group, dh, tile, elem, stages, n))
    return LaunchPlan(n_split=n, split_keys=split, tile_keys=tile,
                      stages=stages, smem_bytes=smem, blocks=rows * n)


# ---------------------------------------------------------------- wrapper


def _check_args(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, layer: int,
                bias: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor],
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor]) -> None:
    if q.dim() != 4 or not 1 <= q.shape[2] <= MAX_WINDOW:
        raise ValueError(f"q must be [B, H, T, Dh] with 1 <= T <= "
                         f"{MAX_WINDOW}, got {tuple(q.shape)}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(
            "k_cache and v_cache must both be [L, B, Hkv, S, Dh], got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    b, h, _, dh = q.shape
    n_layers, cb, hkv, s, cdh = k_cache.shape
    if cb != b or cdh != dh or hkv == 0 or h % hkv:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}"
        )
    if bias is not None and (tuple(bias.shape) != (b, 1, s)
                             or bias.dtype != torch.float32):
        raise ValueError(
            f"bias must be float32 [{b}, 1, {s}], got {bias.dtype} "
            f"{tuple(bias.shape)}"
        )
    if lengths is not None and (tuple(lengths.shape) != (b,)
                                or lengths.dtype != torch.int32):
        raise ValueError(f"lengths must be int32 [{b}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    quant = k_cache.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or quant != (k_scale is not None):
        raise ValueError("an int8 cache takes k_scale and v_scale, a float "
                         "cache neither")
    if quant:
        for scale in (k_scale, v_scale):
            if (tuple(scale.shape) != tuple(k_cache.shape[:4])
                    or scale.dtype != torch.float32):
                raise ValueError(
                    f"k_scale/v_scale must be float32 "
                    f"{list(k_cache.shape[:4])}, got {scale.dtype} "
                    f"{tuple(scale.shape)}"
                )
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layer: int,
                     bias: Optional[torch.Tensor] = None, *,
                     lengths: Optional[torch.Tensor] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention against one layer of the stacked KV cache.

    q        [B, H, 1, Dh] — the decode step's queries; for the kernel any
             batch and head strides with Dh contiguous (a view of the
             fused qkv projection is read in place)
    k_cache  [L, B, Hkv, S, Dh] — stacked cache, float/bf16 in q's dtype
             or int8 (a view over the first S slots of a larger cache is
             fine: it is read in place)
    v_cache  [L, B, Hkv, S, Dh]
    layer    int — which layer's K/V to attend against
    bias     [B, 1, S] f32 — additive mask (0 = attend, NEG_INF = not),
             shared by a window's rows, or None
    lengths  [B] int32 — keys per row (slots >= lengths[b] are not read;
             a window's query t reads lengths[b] + t of them), or None;
             every row keeps at least one key (1 <= lengths[b])
    k_scale, v_scale  [L, B, Hkv, S] f32 — the per-slot scales of an int8
             cache (`common.quantize_kv`), exactly when it is int8
    returns  [B, H, T, Dh] in q's dtype.
    """
    layer = operator.index(layer)
    device = q.device
    tensors = [t for t in (q, k_cache, v_cache, bias, lengths, k_scale,
                           v_scale) if t is not None]
    if any(t.device != device for t in tensors):
        devices = {str(t.device) for t in tensors}
        raise ValueError(
            f"decode_attention tensors on several devices: {sorted(devices)}"
        )
    if device.type == "cpu":
        _check_args(q, k_cache, v_cache, layer, bias, lengths, k_scale,
                    v_scale)
        return decode_attention_reference(q, k_cache, v_cache, layer, bias,
                                          lengths, k_scale, v_scale)
    if device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {device}")
    return _launch_kernel(q, k_cache, v_cache, layer, bias, lengths, k_scale,
                          v_scale)


def _check_append_args(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, layer: int,
                       bias: Optional[torch.Tensor],
                       lengths: Optional[torch.Tensor],
                       k_scale: Optional[torch.Tensor],
                       v_scale: Optional[torch.Tensor]) -> None:
    _check_args(q, k_cache, v_cache, layer, bias, lengths, k_scale, v_scale)
    b, _, t, dh = q.shape
    if t != 1 or lengths is None:
        raise ValueError("decode_attention_append takes one query row a "
                         f"batch row and per-row lengths; got q "
                         f"{tuple(q.shape)}, lengths {lengths}")
    want = (b, k_cache.shape[2], 1, dh)
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != want or x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {list(want)}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def decode_attention_append(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, layer: int,
                            bias: Optional[torch.Tensor] = None, *,
                            lengths: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            dependent: bool = False) -> torch.Tensor:
    """The paged decode step's attention with its KV append: k_new and
    v_new [B, Hkv, 1, Dh] (q's dtype; on the card any batch and head
    strides with Dh contiguous, as views of the fused qkv projection) are
    written at slot lengths[b] - 1 of row b of `layer` (an int8 cache:
    quantized by `common.quantize_kv`, scales into k_scale/v_scale), in
    place, then q [B, H, 1, Dh] attends over the first lengths[b] keys.
    The other arguments and the result as `decode_attention`; lengths is
    required, 1 <= lengths[b] <= S.

    `dependent=True` launches the kernel on the card as a programmatic
    dependent of the kernel before it on the stream, which may then still
    be running while the prologue reads lengths, the bias and the cache
    rows below lengths[b] - 1 (with their scales): the caller vouches that
    that kernel writes none of them (q, k_new and v_new it may write).
    The models' decode route passes it (`models/common.py::
    CachedAttention`): before it comes GPT-2's qkv product or Llama's RoPE
    of k (a fresh tensor), lengths and the bias are built before the first
    layer, and only this kernel writes decode rows. Other callers launch
    it plainly.
    """
    layer = operator.index(layer)
    device = q.device
    tensors = [t for t in (q, k_new, v_new, k_cache, v_cache, bias, lengths,
                           k_scale, v_scale) if t is not None]
    if any(t.device != device for t in tensors):
        devices = {str(t.device) for t in tensors}
        raise ValueError(f"decode_attention_append tensors on several "
                         f"devices: {sorted(devices)}")
    if device.type == "cpu":
        _check_append_args(q, k_new, v_new, k_cache, v_cache, layer, bias,
                           lengths, k_scale, v_scale)
        return decode_attention_append_reference(
            q, k_new, v_new, k_cache, v_cache, layer, bias, lengths=lengths,
            k_scale=k_scale, v_scale=v_scale)
    if device.type != "cuda":
        raise ValueError(f"decode_attention_append runs on cuda or cpu, not "
                         f"{device}")
    return _launch_kernel(q, k_cache, v_cache, layer, bias, lengths, k_scale,
                          v_scale, k_new=k_new, v_new=v_new,
                          dependent=dependent)


class _Args(ctypes.Structure):
    """The kernel's arguments for one layout (csrc DecodeAttentionArgs),
    built once and passed by address."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "q_sb", "q_sh", "q_sw", "kn_sb", "kn_sh")] + [
        (name, ctypes.c_int) for name in (
            "B", "H", "Hkv", "S", "S_alloc", "Dh", "W", "rows", "n_chunks",
            "n_split", "split_keys", "tile", "stages", "smem", "dtype",
            "kv_dtype")
    ] + [("scale", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One validated (shape, strides, dtype): its launch plan, the kernel's
    arguments (kept alive here; `address` is what is passed) and the name
    its launches are counted under."""

    plan: LaunchPlan
    args: _Args
    address: int
    variant: str


# Validated layouts by (shape, strides, dtype) key: a decode step calls the
# kernel once per layer with the same layout, so it is checked once.
_layouts: Dict[tuple, _Layout] = {}
_MAX_LAYOUTS = 256
# Layouts validated in this process, never lowered (the cache above clears
# itself at _MAX_LAYOUTS, and a layout validated again then counts again):
# a warmed server's traffic must add none (`utils/guards.py`).
layouts_validated = 0


def _kernel_layout(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, bias: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None,
                   k_new: Optional[torch.Tensor] = None,
                   v_new: Optional[torch.Tensor] = None) -> _Layout:
    """Check what the kernel takes (everything but the layer index and the
    pointers' alignment, which change per call); raise on anything else.
    With k_new and v_new: the append kernel's layout."""
    append = k_new is not None
    if append:
        _check_append_args(q, k_new, v_new, k_cache, v_cache, 0, bias,
                           lengths, k_scale, v_scale)
    else:
        _check_args(q, k_cache, v_cache, 0, bias, lengths, k_scale, v_scale)
    b, h, t, dh = q.shape
    _, _, hkv, s, _ = k_cache.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    quant = k_cache.dtype == torch.int8
    if v_cache.dtype != k_cache.dtype or (not quant
                                          and k_cache.dtype != q.dtype):
        raise TypeError("k_cache and v_cache must share q's dtype, or both "
                        f"be int8; got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    head_dims = (WINDOW_HEAD_DIMS if t > 1
                 else INT8_HEAD_DIMS if quant else HEAD_DIMS)
    if h // hkv > MAX_GROUP or dh not in head_dims:
        raise ValueError(
            f"kernel limits: H/Hkv <= {MAX_GROUP}, Dh in {head_dims}; got "
            f"H/Hkv={h // hkv}, Dh={dh}"
        )
    elem = q.dtype.itemsize
    sb, sh, sw, sd = q.stride()
    # A dimension of size 1 is never stepped over: its stride is unread.
    sb, sh, sw = (sb if b > 1 else 0), (sh if h > 1 else 0), \
        (sw if t > 1 else 0)
    if sd != 1 or any((x * elem) % 16 for x in (sb, sh, sw)):
        raise ValueError(
            "q must have a contiguous head dim and 16-byte aligned rows (the "
            f"kernel reads 16-byte vectors); got strides {q.stride()}"
        )
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    if lengths is not None and not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    s_alloc = _slot_stride(k_cache)
    if s_alloc is None or _slot_stride(v_cache) != s_alloc:
        raise ValueError(
            "k_cache/v_cache must be contiguous [L, B, Hkv, S_alloc, Dh] "
            "tensors, or views of such over their first S slots"
        )
    if quant and any(_scale_stride(x) != s_alloc for x in (k_scale, v_scale)):
        raise ValueError(
            "k_scale/v_scale must be contiguous [L, B, Hkv, S_alloc] tensors "
            "(or views of such over their first S slots) beside the cache"
        )
    kn_sb = kn_sh = 0
    if append:
        if k_new.stride() != v_new.stride() or k_new.stride(3) != 1:
            raise ValueError(
                "k_new and v_new must share their strides, with a contiguous "
                f"head dim; got {k_new.stride()} and {v_new.stride()}")
        kn_sb = k_new.stride(0) if b > 1 else 0
        kn_sh = k_new.stride(1) if hkv > 1 else 0
    rows, chunks = window_rows(h // hkv, t, q.dtype)
    plan = launch_plan(b, hkv, s, dh, k_cache.dtype, group=rows,
                       chunks=chunks,
                       tensor_cores=tensor_core_window(t, q.dtype),
                       append=append)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"launch plan needs {plan.smem_bytes} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    args = _Args(sb, sh, sw, kn_sb, kn_sh, b, h, hkv, s, s_alloc, dh, t,
                 rows, chunks,
                 plan.n_split, plan.split_keys, plan.tile_keys, plan.stages,
                 plan.smem_bytes, _DTYPE_CODES[q.dtype],
                 _DTYPE_CODES[k_cache.dtype], 1.0 / math.sqrt(dh))
    if append:
        variant = APPEND_INT8KV if quant else APPEND
    elif t > 1:
        variant = WINDOW_INT8KV if quant else WINDOW
    else:
        variant = INT8KV if quant else (RAGGED if lengths is not None
                                        else KERNEL)
    return _Layout(plan=plan, args=args, address=ctypes.addressof(args),
                   variant=variant)


def _remember_layout(key: tuple, lay: _Layout) -> None:
    """Cache a layout just validated and count it."""
    global layouts_validated
    layouts_validated += 1
    if len(_layouts) >= _MAX_LAYOUTS:
        _layouts.clear()
    _layouts[key] = lay


def _launch_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, layer: int,
                   bias: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None, *,
                   k_new: Optional[torch.Tensor] = None,
                   v_new: Optional[torch.Tensor] = None,
                   dependent: bool = False) -> torch.Tensor:
    """Validate what the CUDA kernel takes, launch it, count the launch
    (with k_new and v_new: the append kernel, a programmatic dependent
    with `dependent`)."""
    key = (q.shape, q.stride(), q.dtype, k_cache.shape, k_cache.stride(),
           k_cache.dtype, v_cache.shape, v_cache.stride(), v_cache.dtype,
           None if bias is None else (bias.shape, bias.stride(), bias.dtype),
           None if lengths is None else (lengths.shape, lengths.stride(),
                                         lengths.dtype),
           None if k_scale is None else (k_scale.shape, k_scale.stride(),
                                         v_scale.shape, v_scale.stride()),
           None if k_new is None else (k_new.shape, k_new.stride(),
                                       k_new.dtype, v_new.shape,
                                       v_new.stride(), v_new.dtype))
    lay = _layouts.get(key)
    if lay is None:
        lay = _kernel_layout(q, k_cache, v_cache, bias, lengths, k_scale,
                             v_scale, k_new, v_new)
        _remember_layout(key, lay)
    n_layers = k_cache.shape[0]
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    qp, kp, vp = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("q, k_cache and v_cache must be 16-byte aligned "
                         "(the kernel reads 16-byte vectors)")
    out = q.new_empty(q.shape)  # contiguous, whatever q's strides
    scales = (None if k_scale is None else k_scale.data_ptr(),
              None if v_scale is None else v_scale.data_ptr(),
              None if bias is None else bias.data_ptr(),
              None if lengths is None else lengths.data_ptr())
    if k_new is None:
        launch, stream = _entry_point()
        err = launch(lay.address, qp, kp, vp, *scales, out.data_ptr(),
                     layer, stream(q.get_device()))
    else:
        launch, stream = _append_entry_point()
        err = launch(lay.address, qp, k_new.data_ptr(), v_new.data_ptr(),
                     kp, vp, *scales, out.data_ptr(), layer, int(dependent),
                     stream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts[lay.variant] += 1
    return out


def _slot_stride(cache: torch.Tensor) -> int | None:
    """S_alloc if `cache` is laid out as a contiguous [L, B, Hkv, S_alloc, Dh]
    buffer (possibly sliced to its first S slots), else None."""
    n_layers, b, hkv, s, dh = cache.shape
    st = cache.stride()
    if st[4] != 1 or st[3] != dh or st[2] % dh:
        return None
    s_alloc = st[2] // dh
    if s_alloc < s or st[1] != hkv * st[2] or st[0] != b * st[1]:
        return None
    return s_alloc


def _scale_stride(scale: torch.Tensor) -> int | None:
    """S_alloc if `scale` is a contiguous [L, B, Hkv, S_alloc] buffer
    (possibly sliced to its first S slots), else None."""
    n_layers, b, hkv, s = scale.shape
    st = scale.stride()
    if st[3] != 1 or st[2] < s or st[1] != hkv * st[2] or st[0] != b * st[1]:
        return None
    return st[2]


_bound: Optional[Tuple[Callable[..., int], Callable[[int], int]]] = None
_append_bound: Optional[Tuple[Callable[..., int],
                              Callable[[int], int]]] = None


def _entry_point() -> Tuple[Callable[..., int], Callable[[int], int]]:
    """The C launch function, bound once (built first if needed), and the
    device's current raw stream handle by index."""
    global _bound
    if _bound is None:
        fn = build.load(KERNEL).decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # The current stream's handle for a device index, without building
        # a torch.cuda.Stream object per call.
        _bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _bound


def _append_entry_point() -> Tuple[Callable[..., int], Callable[[int], int]]:
    """The append kernel's C launch function, bound once (built first if
    needed), and the current raw stream handle by device index."""
    global _append_bound
    if _append_bound is None:
        fn = build.load(KERNEL).decode_attention_append_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _append_bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _append_bound
