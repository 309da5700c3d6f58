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
frontier; the JAX package computes this window in XLA). `window_rows`
says how the window's rows are cut into blocks.

`decode_attention` dispatches on where its tensors live: CPU tensors take
`decode_attention_reference` (the plain PyTorch version, which the CPU
tests hold against JAX); CUDA tensors launch the kernel or raise. There is
no fallback from the card to the plain version.
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
MAX_GROUP = 8     # query rows a block holds, at most (csrc kMaxGroup)
WINDOW_ROWS = 4   # query rows a block of a window holds (csrc kWindowRows)
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
TILE_BYTES = 16 * 1024     # bytes of K (and of V) per tile, at most
RING_BYTES = 48 * 1024     # K and V staged per block, at most
WARPS = 8                  # warps per block (csrc kThreads / 32)
SMEM_LIMIT = 227 * 1024    # dynamic shared memory a block may use

# Kernel launches by variant, incremented only where a kernel is launched
# (never by the plain path), and for each replay of a CUDA graph by the
# launches captured into it (`engine/graphs.py`). A run resets them, drives
# the main path, and reads them to show the path went through the kernel.
launch_counts: Dict[str, int] = {KERNEL: 0, RAGGED: 0, INT8KV: 0,
                                  WINDOW: 0, WINDOW_INT8KV: 0}


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


def window_rows(group: int, t: int) -> Tuple[int, int]:
    """(rows a block, blocks a (row, KV head)) of a call with `group` query
    heads a KV head and `t` query rows a batch row. Decode (t = 1): one
    block of the group. A window: its group * t rows, head-major, cut into
    as few blocks of at most WINDOW_ROWS rows as hold them, of equal size
    (GPT-2 at t = 9: three blocks of 3 rows). A block's rows live in
    registers: blocks of 4 measured faster than blocks of 8 at every t > 2
    on an H100 (two blocks an SM against one; PERF.md), so the kernel's
    window is built for 4 rows a block alone."""
    if t == 1:
        return group, 1
    n_rows = group * t
    chunks = -(-n_rows // WINDOW_ROWS)
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


def max_tile_keys(group: int, dh: int, elem: int) -> int:
    """Keys per tile, at most: 128 with one query head a KV head, else 64
    (csrc `max_tile`: a lane group keeps its rows' scores in registers),
    and no more than TILE_BYTES of K."""
    return min(128 if group == 1 else 64, TILE_BYTES // (dh * elem))


def launch_plan(b: int, hkv: int, s: int, dh: int, dtype: torch.dtype,
                group: int = 1, n_split: Optional[int] = None,
                chunks: int = 1) -> LaunchPlan:
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
    its rows (`window_rows`).
    """
    rows = b * hkv * chunks
    elem = dtype.itemsize
    cap = max_tile_keys(group, dh, elem)
    n = 1
    if n_split is not None:
        if n_split not in (1, 2, 4, MAX_SPLIT):
            raise ValueError(f"n_split must be 1, 2, 4 or 8, not {n_split}")
        n = n_split
    elif s > cap:
        while (n < MAX_SPLIT and s >= MIN_SPLIT_KEYS * 2 * n
               and (rows * n < TARGET_BLOCKS
                    or -(-s // n) > MAX_SPLIT_KEYS)):
            n *= 2
    split = -(-s // n)
    tile = min(cap, -(-split // 8) * 8)
    n_tiles = -(-split // tile)
    stages = min(n_tiles, max(2, RING_BYTES // (2 * tile * dh * elem)))
    return LaunchPlan(n_split=n, split_keys=split, tile_keys=tile,
                      stages=stages,
                      smem_bytes=_smem_bytes(group, dh, tile, elem, stages, n),
                      blocks=rows * n)


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


class _Args(ctypes.Structure):
    """The kernel's arguments for one layout (csrc DecodeAttentionArgs),
    built once and passed by address."""

    _fields_ = [(name, ctypes.c_longlong) for name in ("q_sb", "q_sh",
                                                       "q_sw")] + [
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


def _kernel_layout(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, bias: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> _Layout:
    """Check what the kernel takes (everything but the layer index and the
    pointers' alignment, which change per call); raise on anything else."""
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
    rows, chunks = window_rows(h // hkv, t)
    plan = launch_plan(b, hkv, s, dh, k_cache.dtype, group=rows,
                       chunks=chunks)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"launch plan needs {plan.smem_bytes} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    args = _Args(sb, sh, sw, b, h, hkv, s, s_alloc, dh, t, rows, chunks,
                 plan.n_split, plan.split_keys, plan.tile_keys, plan.stages,
                 plan.smem_bytes, _DTYPE_CODES[q.dtype],
                 _DTYPE_CODES[k_cache.dtype], 1.0 / math.sqrt(dh))
    if t > 1:
        variant = WINDOW_INT8KV if quant else WINDOW
    else:
        variant = INT8KV if quant else (RAGGED if lengths is not None
                                        else KERNEL)
    return _Layout(plan=plan, args=args, address=ctypes.addressof(args),
                   variant=variant)


def _launch_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, layer: int,
                   bias: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validate what the CUDA kernel takes, launch it, count the launch."""
    key = (q.shape, q.stride(), q.dtype, k_cache.shape, k_cache.stride(),
           k_cache.dtype, v_cache.shape, v_cache.stride(), v_cache.dtype,
           None if bias is None else (bias.shape, bias.stride(), bias.dtype),
           None if lengths is None else (lengths.shape, lengths.stride(),
                                         lengths.dtype),
           None if k_scale is None else (k_scale.shape, k_scale.stride(),
                                         v_scale.shape, v_scale.stride()))
    lay = _layouts.get(key)
    if lay is None:
        lay = _kernel_layout(q, k_cache, v_cache, bias, lengths, k_scale,
                             v_scale)
        if len(_layouts) >= _MAX_LAYOUTS:
            _layouts.clear()
        _layouts[key] = lay
    n_layers = k_cache.shape[0]
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    qp, kp, vp = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("q, k_cache and v_cache must be 16-byte aligned "
                         "(the kernel reads 16-byte vectors)")
    out = q.new_empty(q.shape)  # contiguous, whatever q's strides
    launch, stream = _entry_point()
    err = launch(lay.address, qp, kp, vp,
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if lengths is None else lengths.data_ptr(),
                 out.data_ptr(), layer, stream(q.get_device()))
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
