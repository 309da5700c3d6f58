"""Weight-only int8 matrix product: CUDA kernels and their plain version.

The JAX package has no Pallas kernel here: its `common.dense` and
`quant.unembed` leave ``x @ q.astype(x.dtype) * s`` to XLA, which fuses the
int8-to-float convert into the product's operand load. In eager PyTorch the
same expression materialises a converted copy of the weight on every call
(int8 read, a 2- or 4-byte copy written and read again), so an int8 model
would move more bytes than a bf16 one. `csrc/int8_matmul.cu` reads the int8
weight once and converts it in registers.

Two layouts:

- dense:      y [M, N] = (x [M, K] @ q [K, N]) * s [N] (+ b [N]), in x's dtype
              (`common.dense`: q is [in, out] with per-out-channel scales);
- transposed: y [M, N] = (x [M, K] @ q [N, K]^T) * s [N], float32
              (`quant.unembed`: the tied table [V, D] with per-row scales).

Two routes, by x's dtype: bf16 x (the production dtype) runs the
tensor-core kernels (`mma.sync` on bf16 converted exactly from int8,
weights staged by TMA / bulk copies), whose launch `launch_plan` cuts;
float32 x runs the CUDA-core kernels, whose float32 products the float32
checks need (tensor cores would round x to TF32).

`int8_matmul` dispatches on where x lives: CPU tensors take
`int8_matmul_reference` (the plain version, the JAX expression written in
PyTorch); CUDA tensors launch a kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

KERNEL = "int8_matmul"                    # the source, csrc/int8_matmul.cu
# Launches are counted in all (KERNEL) and by route: bf16 x on the tensor
# cores in the dense and the transposed (unembedding) layout, float32 x on
# the CUDA cores in either layout.
MMA = "int8_matmul_mma"
MMA_UNEMBED = "int8_matmul_mma_unembed"
FMA = "int8_matmul_fma"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launch geometry of the tensor-core route. The constants marked csrc must
# match the kernel source.
DENSE_COLS = 128       # dense: output columns a block, a TMA box's bytes (csrc kBN)
DENSE_ROWS = 128       # dense: weight rows a box, one ring stage (csrc kBK)
PART_STRIDE = 132      # dense: floats a row of the epilogue tile (csrc)
TABLE_ROWS = 64        # transposed: table rows a tile (csrc kBV)
MAX_SPLIT = 8          # blocks a cluster, the portable maximum (csrc)
TARGET_BLOCKS = 132    # one wave of blocks on an H100 (132 SMs)
MIN_SPLIT_ROWS = 64    # no K split shorter than this
X_BYTES = 100 * 1024   # dense: staged x a block, at most
MAX_TABLE_STAGES = 4   # transposed: ring depth, at most
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use
ALIGN = 1024           # smem slack: the 128-byte swizzle repeats every 1 KB

# Kernel launches, incremented only where a kernel is launched (never by the
# plain path). A run resets them, drives the main path, and reads them to
# show the path went through the kernels.
launch_counts: Dict[str, int] = {KERNEL: 0, MMA: 0, MMA_UNEMBED: 0, FMA: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          transposed: bool = False) -> torch.Tensor:
    """Plain version: the JAX package's expression.

    dense      ``(x @ q.to(x.dtype)) * s.to(y.dtype) (+ b.to(y.dtype))``,
               rounded to x's dtype after the product and after the scale;
    transposed ``(x @ q^T) * s`` with float32 products and sums (the
               einsum's `preferred_element_type=float32`).
    """
    if transposed:
        return torch.matmul(x.float(), q.float().t()) * s.float()
    y = torch.matmul(x, q.to(x.dtype))
    y = y * s.to(y.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ------------------------------------------------------------ launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one bf16 call is cut (csrc Int8MatmulArgs). Both layouts: `mt`
    m16 row tiles a block (1 or 4), `grid` (x, y, z) blocks, `stages` ring
    tiles, `smem_bytes` of dynamic shared memory. Dense: `splits` blocks of
    one cluster share K in ranges of `k_split` rows; transposed: a block
    walks `tiles_per_block` tiles of TABLE_ROWS table rows (at most)."""

    mt: int
    grid: Tuple[int, int, int]
    splits: int
    k_split: int
    stages: int
    smem_bytes: int
    tiles_per_block: int


def dense_x_stride(k_split: int) -> int:
    """Staged x row, bf16 elements (csrc dense_x_stride)."""
    return k_split + 8


def table_x_stride(k: int) -> int:
    """Staged x row of the transposed layout, bf16 elements (csrc
    rows_x_stride)."""
    return k + 8


def table_stage_bytes(k: int) -> int:
    """One staged tile of the table: K / 128 boxes of TABLE_ROWS rows x
    128 bytes (csrc kTableBox)."""
    return -(-k // DENSE_COLS) * TABLE_ROWS * DENSE_COLS


def _smem_bytes(transposed: bool, mt: int, k: int, stages: int) -> int:
    """Dynamic shared memory of one block (csrc dense_smem / rows_smem);
    `k` is the split's rows (dense) or K (transposed)."""
    bars = 8 * (stages + 1)
    if transposed:
        return (ALIGN + stages * table_stage_bytes(k)
                + 16 * mt * table_x_stride(k) * 2 + bars)
    ring = max(stages * DENSE_ROWS * DENSE_COLS, 16 * mt * PART_STRIDE * 4)
    return ALIGN + ring + 16 * mt * dense_x_stride(k) * 2 + bars


def launch_plan(m: int, k: int, n: int, transposed: bool,
                splits: Optional[int] = None) -> LaunchPlan:
    """Cut a bf16 product on the tensor cores.

    Rows: one m16 tile a block up to M = 16 (decode), else four, so a
    staged weight tile serves 64 rows of x. Dense: 128 columns a block;
    while the blocks are fewer than TARGET_BLOCKS, K is split (1, 2, 4, 8:
    one cluster, at least MIN_SPLIT_ROWS rows a split), and further while a
    block's staged x would pass X_BYTES; a split is a multiple of
    DENSE_ROWS rows; the ring holds every box of a split where shared
    memory allows. Transposed: one wave of blocks (TARGET_BLOCKS over the
    row tiles), each walking its tiles through a ring of up to
    MAX_TABLE_STAGES tiles. `splits` forces the dense split count instead
    (`ops/sweep_int8.py --splits` measures the trade).
    """
    if m < 1 or k < 16 or n < 1:
        raise ValueError(f"empty product: M={m}, K={k}, N={n}")
    mt = 1 if m <= 16 else 4
    gy = -(-m // (16 * mt))
    if transposed:
        n_vt = -(-n // TABLE_ROWS)
        gx = min(n_vt, max(1, -(-TARGET_BLOCKS // gy)))
        tiles = -(-n_vt // gx)
        stages = min(tiles, MAX_TABLE_STAGES)
        while stages > 1 and _smem_bytes(True, mt, k, stages) > SMEM_LIMIT:
            stages -= 1
        smem = _smem_bytes(True, mt, k, stages)
        if smem > SMEM_LIMIT:
            raise ValueError(f"K={k} is too deep for the transposed kernel's "
                             f"shared memory ({smem} bytes)")
        return LaunchPlan(mt=mt, grid=(gx, gy, 1), splits=1, k_split=k,
                          stages=stages, smem_bytes=smem,
                          tiles_per_block=tiles)
    gx = -(-n // DENSE_COLS)

    def split_rows(splits: int) -> int:  # ceil(K / splits), in whole boxes
        return -(-k // (splits * DENSE_ROWS)) * DENSE_ROWS

    if splits is not None:
        if splits not in (1, 2, 4, MAX_SPLIT):
            raise ValueError(f"splits must be 1, 2, 4 or 8, not {splits}")
    else:
        splits = 1
        while (splits < MAX_SPLIT and gx * gy * splits < TARGET_BLOCKS
               and k // (2 * splits) >= MIN_SPLIT_ROWS):
            splits *= 2
        while (splits < MAX_SPLIT and 16 * mt * dense_x_stride(
                split_rows(splits)) * 2 > X_BYTES):
            splits *= 2
    k_split = split_rows(splits)
    splits = -(-k // k_split)
    tiles = -(-k_split // DENSE_ROWS)
    stages = tiles
    while stages > 1 and _smem_bytes(False, mt, k_split, stages) > SMEM_LIMIT:
        stages -= 1
    smem = _smem_bytes(False, mt, k_split, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={k} is too deep for the dense kernel's shared "
                         f"memory ({smem} bytes)")
    return LaunchPlan(mt=mt, grid=(gx, gy, splits), splits=splits,
                      k_split=k_split, stages=stages, smem_bytes=smem,
                      tiles_per_block=tiles)


# ------------------------------------------------- fragment index maps
#
# The tensor-core kernels permute the mma's n index (dense) or k index
# (transposed) between the operand loads and the epilogue (csrc note,
# "Fragment permutations"). These spell the kernels' formulas; the CPU
# tests run a model of the mma fragments through them.


def swizzle128(row: int, col: int) -> int:
    """Byte offset of (row, byte col) of a 128-byte-wide TMA box written
    with the 128-byte swizzle into a 1 KB aligned stage (csrc swz128)."""
    return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)


def dense_b_word(warp: int, lane: int) -> int:
    """Dense: the byte column of the 32-bit word that `lane` of `warp` reads
    from each weight row: columns w .. w + 3, w = 32 (warp % 4) + 4 g."""
    return 32 * (warp % 4) + 4 * (lane >> 2)


def dense_b_column(warp: int, lane: int, j: int) -> int:
    """Dense: the block's column that mma j's column g = lane // 4 stands
    for: byte j of the lane's word."""
    return dense_b_word(warp, lane) + j


def dense_c_column(warp: int, lane: int, j: int, c: int) -> int:
    """Dense: the block's column of accumulator c (0..3) of mma j, whose
    mma column is 2t + (c & 1) (t = lane % 4)."""
    return 32 * (warp % 4) + 4 * (2 * (lane & 3) + (c & 1)) + j


def table_k(lane: int, step: int, reg: int, half: int) -> int:
    """Transposed: the k (within a 64-deep chunk) that element `half` of B
    register `reg` holds in k16 step `step` (0..3), for `lane`; the mma
    reads it as k 2t + half + 8 reg (t = lane % 4). x's A fragment uses the
    same map."""
    return 16 * (lane & 3) + 4 * step + 2 * reg + half


def table_b_row(lane: int) -> int:
    """Transposed: the row (of a warp's 8 table rows) that the mma's
    column g = lane // 4 stands for: sigma(g) = g // 2 + 4 (g % 2)."""
    g = lane >> 2
    return (g >> 1) | ((g & 1) << 2)


def table_c_row(lane: int, c: int) -> int:
    """Transposed: the row of accumulator c, whose mma column is
    2t + (c & 1): sigma(2t + (c & 1)) = t + 4 (c & 1)."""
    return (lane & 3) + 4 * (c & 1)


# ---------------------------------------------------------------- wrapper


def _check_args(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor], transposed: bool) -> Tuple[int, int]:
    """(K, N) of the product; raises on shapes the function does not take."""
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"q must be a 2-D int8 tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    n, k = (q.shape[0], q.shape[1]) if transposed else (q.shape[1],
                                                        q.shape[0])
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)} (transposed={transposed})")
    if tuple(s.shape) != (n,):
        raise ValueError(f"s must be [{n}], got {tuple(s.shape)}")
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"b must be [{n}], got {tuple(b.shape)}")
    if transposed and b is not None:
        raise ValueError("the transposed (unembedding) layout takes no bias")
    return k, n


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                transposed: bool = False) -> torch.Tensor:
    """x [..., K] times the int8 weight `q` dequantized by `s` (see the
    module docstring for the two layouts); returns [..., N] in x's dtype
    (dense) or float32 (transposed)."""
    device = x.device
    if (q.device != device or s.device != device
            or (b is not None and b.device != device)):
        tensors = [x, q, s] + ([b] if b is not None else [])
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"int8_matmul tensors on several devices: {devices}")
    if device.type == "cpu":
        _check_args(x, q, s, b, transposed)
        return int8_matmul_reference(x, q, s, b, transposed)
    if device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {device}")
    return _launch_kernel(x, q, s, b, transposed)


class _Args(ctypes.Structure):
    """The kernel's arguments for one layout (csrc Int8MatmulArgs), built
    once and passed by address."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "N", "K", "transposed", "dtype", "mt", "splits", "k_split",
        "stages", "grid_x", "smem")]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One validated (shapes, strides, dtypes, bias or not): the kernel's
    arguments (kept alive here; `address` is what is passed; the bf16
    route's carry its launch plan), the route its launches are counted
    under, the output's shape and dtype, and which inputs need a per-call
    conversion (x copied to rows, s to float32, b to x's dtype)."""

    args: _Args
    address: int
    route: str
    out_shape: Tuple[int, ...]
    out_dtype: torch.dtype
    m: int
    x_copy: bool
    s_cast: bool
    b_cast: bool


# Validated layouts by key: a model call launches 49 products over a few
# layouts, so each is checked once.
_layouts: Dict[tuple, _Layout] = {}
_MAX_LAYOUTS = 256


def _kernel_layout(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   b: Optional[torch.Tensor], transposed: bool) -> _Layout:
    """Check what the kernels take (everything but the devices and the
    pointers' alignment, which change per call); raise on anything else."""
    k, n = _check_args(x, q, s, b, transposed)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul kernel takes float32 or bfloat16 x, "
                        f"not {x.dtype}")
    if k % 16 or (not transposed and n % 16):
        raise ValueError(
            f"kernel reads 16-byte vectors: K ({k}) and, for the dense "
            f"layout, N ({n}) must be multiples of 16"
        )
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and transposed and k % 64:
        raise ValueError(f"the bf16 transposed kernel reads K in chunks of "
                         f"64: K ({k}) must be a multiple of 64")
    m = x.numel() // k if k else 0
    x_copy = not x.is_contiguous()
    s_cast = s.dtype != torch.float32 or not s.is_contiguous()
    b_cast = b is not None and (b.dtype != x.dtype or not b.is_contiguous())
    plan = launch_plan(m, k, n, transposed) if bf16 and m else None
    if plan is None:
        args = _Args(m, n, k, int(transposed), _DTYPE_CODES[x.dtype], 0, 0,
                     0, 0, 0, 0)
    else:
        if plan.grid[1] > 65535:
            raise ValueError(f"M={m} needs {plan.grid[1]} row tiles, more "
                             f"than 65535")
        args = _Args(m, n, k, int(transposed), 1, plan.mt, plan.splits,
                     plan.k_split, plan.stages, plan.grid[0],
                     plan.smem_bytes)
    route = (MMA_UNEMBED if transposed else MMA) if bf16 else FMA
    return _Layout(args=args, address=ctypes.addressof(args), route=route,
                   out_shape=(*x.shape[:-1], n),
                   out_dtype=torch.float32 if transposed else x.dtype, m=m,
                   x_copy=x_copy, s_cast=s_cast, b_cast=b_cast)


def _launch_kernel(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   b: Optional[torch.Tensor], transposed: bool
                   ) -> torch.Tensor:
    """Validate the layout (once per key), launch the route's kernel, count
    the launch."""
    key = (x.shape, x.stride(), x.dtype, q.shape, q.stride(), q.dtype,
           s.shape, s.stride(), s.dtype,
           None if b is None else (b.shape, b.stride(), b.dtype), transposed)
    lay = _layouts.get(key)
    if lay is None:
        lay = _kernel_layout(x, q, s, b, transposed)
        if len(_layouts) >= _MAX_LAYOUTS:
            _layouts.clear()
        _layouts[key] = lay
    out = x.new_empty(lay.out_shape, dtype=lay.out_dtype)
    if lay.m == 0:
        return out
    if lay.x_copy:
        x = x.reshape(-1, x.shape[-1]).contiguous()
    if lay.s_cast:
        s = s.float().contiguous()
    if lay.b_cast:
        b = b.to(x.dtype).contiguous()
    xp, qp = x.data_ptr(), q.data_ptr()
    if (xp | qp) % 16:
        raise ValueError("x and q must be 16-byte aligned (the kernel reads "
                         "16-byte vectors)")
    launch, stream = _entry_point()
    err = launch(lay.address, xp, qp, s.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr(),
                 stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts[KERNEL] += 1
    launch_counts[lay.route] += 1
    return out


_bound: Optional[Tuple[Callable[..., int], Callable[[int], int]]] = None


def _entry_point() -> Tuple[Callable[..., int], Callable[[int], int]]:
    """The C launch function, bound once (built first if needed), and the
    device's current raw stream handle by index."""
    global _bound
    if _bound is None:
        fn = build.load(KERNEL).int8_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        _bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _bound
