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

A third, `int8_matmul_experts`, batches the dense layout over E experts in
one launch (the MoE layer's expert products, `models/moe.py`):

- experts:    y [E, C, N] = (x [E, C, K] @ q [E, K, N]) * s [E, 1, N]
              (+ b [E, 1, N]), in x's dtype.

Three routes, by x's dtype and rows: bf16 x (the production dtype) runs
the tensor cores on bf16 converted exactly from int8 (weights staged by
TMA): up to 16 rows (of each expert; decode) `mma.sync` tiles in
`csrc/int8_matmul.cu`, whose launch `launch_plan` cuts; from
WGMMA_MIN_ROWS rows (admission chunks, prefill, verify windows, the gate,
scoring) the warp-specialised TMA + `wgmma` kernels of
`csrc/int8_matmul_wgmma.cu`, whose launch `wgmma_plan` cuts. float32 x runs
the CUDA-core kernels, whose float32 products the float32 checks need
(tensor cores would round x to TF32). `int8_matmul_replaced` launches the
`mma.sync` route at any M: the variant the `wgmma` route replaced above 16
rows, kept to be timed and checked beside it; no main path calls it.

`int8_matmul` and `int8_matmul_experts` dispatch on where x lives: CPU
tensors take `int8_matmul_reference` / `int8_matmul_experts_reference`
(the plain versions, the JAX expressions written in PyTorch); CUDA tensors
launch a kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

KERNEL = "int8_matmul"                    # the source, csrc/int8_matmul.cu
WGMMA_SOURCE = "int8_matmul_wgmma"        # csrc/int8_matmul_wgmma.cu
# Launches are counted in all (KERNEL, both sources) and by route: bf16 x
# on the tensor cores (mma.sync up to 16 rows, wgmma from WGMMA_MIN_ROWS)
# in the dense and the transposed (unembedding) layout, float32 x on the
# CUDA cores in either layout; the expert layout on each.
MMA = "int8_matmul_mma"
MMA_UNEMBED = "int8_matmul_mma_unembed"
FMA = "int8_matmul_fma"
MMA_EXPERTS = "int8_matmul_mma_experts"
FMA_EXPERTS = "int8_matmul_fma_experts"
WGMMA = "int8_matmul_wgmma"
WGMMA_UNEMBED = "int8_matmul_wgmma_unembed"
WGMMA_EXPERTS = "int8_matmul_wgmma_experts"
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
# plain path), and for each replay of a CUDA graph by the launches captured
# into it (`engine/graphs.py`). A run resets them, drives the main path, and
# reads them to show the path went through the kernels.
launch_counts: Dict[str, int] = {KERNEL: 0, MMA: 0, MMA_UNEMBED: 0, FMA: 0,
                                 MMA_EXPERTS: 0, FMA_EXPERTS: 0, WGMMA: 0,
                                 WGMMA_UNEMBED: 0, WGMMA_EXPERTS: 0}


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


def int8_matmul_experts_reference(x: torch.Tensor, q: torch.Tensor,
                                  s: torch.Tensor,
                                  b: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain version of the expert layout: the JAX package's
    `moe.expert_dense` then its bias add, ``bmm(x, q.to(x.dtype)) *
    s[:, None, :] (+ b[:, None, :])``, rounded to x's dtype after the
    product, the scale and the bias."""
    y = torch.bmm(x, q.to(x.dtype))
    y = y * s.to(y.dtype)[:, None, :]
    if b is not None:
        y = y + b.to(y.dtype)[:, None, :]
    return y


# ------------------------------------------------------------ launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one bf16 call is cut (csrc Int8MatmulArgs). Both layouts: `mt`
    m16 row tiles a block (1 or 4), `grid` (x, y, z) blocks, `stages` ring
    tiles, `smem_bytes` of dynamic shared memory. Dense: `splits` blocks of
    one cluster share K in ranges of `k_split` rows; transposed: a block
    walks `tiles_per_block` tiles of TABLE_ROWS table rows (at most), each
    in chunks of `k_split` of K (all of K unless `x_staged`).

    `x_staged`: x is staged with each ring stage, beside the weight box or
    the table chunk it multiplies, instead of once a block (a dense
    split's rows, or all of K for the table). Shared memory then no longer
    grows with K: the deep products (Llama-3-8B's down projection at K =
    14,336 beyond M = 16, its unembedding at K = 4,096) take this route."""

    mt: int
    grid: Tuple[int, int, int]
    splits: int
    k_split: int
    stages: int
    smem_bytes: int
    tiles_per_block: int
    x_staged: bool = False


def dense_x_stride(k_split: int) -> int:
    """Staged x row, bf16 elements (csrc dense_x_stride)."""
    return k_split + 8


def table_x_stride(k: int) -> int:
    """Staged x row of the transposed layout, bf16 elements (csrc
    rows_x_stride); `k` is K, or the chunk with `x_staged`."""
    return k + 8


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def table_stage_bytes(k: int) -> int:
    """One staged tile of the table: K / 128 boxes of TABLE_ROWS rows x
    128 bytes (csrc kTableBox)."""
    return -(-k // DENSE_COLS) * TABLE_ROWS * DENSE_COLS


def dense_stage_bytes(mt: int, x_staged: bool) -> int:
    """One dense ring stage (csrc dense_stage_bytes): the weight box, and
    with `x_staged` the block's 16 mt rows of x over its 128 rows of K,
    padded to the 1 KB the next box's swizzle needs."""
    box = DENSE_ROWS * DENSE_COLS
    if not x_staged:
        return box
    return box + _round_up(16 * mt * dense_x_stride(DENSE_ROWS) * 2, ALIGN)


def table_chunk_stage_bytes(mt: int, k_chunk: int) -> int:
    """One transposed ring stage with `x_staged` (csrc rows_stage_bytes):
    a chunk of `k_chunk` of K of a tile's table rows, and the block's 16 mt
    rows of x over the same chunk, padded to 1 KB."""
    return table_stage_bytes(k_chunk) + _round_up(
        16 * mt * table_x_stride(k_chunk) * 2, ALIGN)


def _smem_bytes(transposed: bool, mt: int, k: int, stages: int,
                x_staged: bool = False) -> int:
    """Dynamic shared memory of one block (csrc dense_smem / rows_smem);
    `k` is the split's rows (dense) or K, or the chunk with `x_staged`
    (transposed)."""
    bars = 8 * (stages + 1)
    if transposed:
        if x_staged:
            return ALIGN + stages * table_chunk_stage_bytes(mt, k) + bars
        return (ALIGN + stages * table_stage_bytes(k)
                + 16 * mt * table_x_stride(k) * 2 + bars)
    ring = max(stages * dense_stage_bytes(mt, x_staged),
               16 * mt * PART_STRIDE * 4)
    xs = 0 if x_staged else 16 * mt * dense_x_stride(k) * 2
    return ALIGN + ring + xs + bars


def _fit_stages(most: int, smem: Callable[[int], int]) -> int:
    """The deepest ring of at most `most` stages within SMEM_LIMIT (1 if
    none is)."""
    stages = most
    while stages > 1 and smem(stages) > SMEM_LIMIT:
        stages -= 1
    return stages


def launch_plan(m: int, k: int, n: int, transposed: bool,
                splits: Optional[int] = None,
                experts: int = 1) -> LaunchPlan:
    """Cut a bf16 product on the tensor cores.

    `experts` > 1: the dense layout batched over that many experts of `m`
    rows each (`int8_matmul_experts`): grid y holds every expert's row
    tiles, and they count in the wave (TARGET_BLOCKS) as any row tiles do.
    At `experts` = 1 the plan is the dense product's.

    Rows: one m16 tile a block up to M = 16 (decode), else four, so a
    staged weight tile serves 64 rows of x. Dense: 128 columns a block;
    while the blocks are fewer than TARGET_BLOCKS, K is split (1, 2, 4, 8:
    one cluster, at least MIN_SPLIT_ROWS rows a split), and further while a
    block's staged x would pass X_BYTES; a split is a multiple of
    DENSE_ROWS rows; the ring holds every box of a split where shared
    memory allows. Where even 8 splits leave a split's x above X_BYTES or
    past shared memory, x is staged box by box in the ring instead
    (`x_staged`) and K is split for the wave alone. Transposed: one wave
    of blocks (TARGET_BLOCKS over the row tiles), each walking its tiles
    through a ring of up to MAX_TABLE_STAGES tiles with x staged whole;
    where that ring would hold fewer than two tiles, each tile is walked in
    chunks of K (1024, 512, 256 or 128, the longest with a ring of
    MAX_TABLE_STAGES chunks), x's chunk staged beside the table's
    (`x_staged`). `splits` forces the dense split count instead
    (`ops/sweep_int8.py --splits` measures the trade).

    Raises on an empty product and where M needs more than 65,535 row
    tiles (the grid's y limit; all experts' together).
    """
    if m < 1 or k < 16 or n < 1 or experts < 1:
        raise ValueError(f"empty product: M={m}, K={k}, N={n}, "
                         f"experts={experts}")
    if transposed and experts > 1:
        raise ValueError("the transposed layout has no expert batch")
    mt = 1 if m <= 16 else 4
    gy = experts * -(-m // (16 * mt))
    if gy > 65535:
        raise ValueError(f"M={m} x {experts} experts needs {gy} row tiles, "
                         f"more than 65535")
    if transposed:
        n_vt = -(-n // TABLE_ROWS)
        gx = min(n_vt, max(1, -(-TARGET_BLOCKS // gy)))
        tiles = -(-n_vt // gx)
        stages = _fit_stages(min(tiles, MAX_TABLE_STAGES),
                             lambda st: _smem_bytes(True, mt, k, st))
        smem = _smem_bytes(True, mt, k, stages)
        if smem <= SMEM_LIMIT and stages >= min(tiles, 2):
            return LaunchPlan(mt=mt, grid=(gx, gy, 1), splits=1, k_split=k,
                              stages=stages, smem_bytes=smem,
                              tiles_per_block=tiles)
        for chunk in (1024, 512, 256, 128):
            items = tiles * -(-k // chunk)
            stages = min(items, MAX_TABLE_STAGES)
            smem = _smem_bytes(True, mt, chunk, stages, x_staged=True)
            if chunk < k and smem <= SMEM_LIMIT:
                return LaunchPlan(mt=mt, grid=(gx, gy, 1), splits=1,
                                  k_split=chunk, stages=stages,
                                  smem_bytes=smem, tiles_per_block=tiles,
                                  x_staged=True)
        raise ValueError(f"K={k} is too deep for the transposed kernel's "
                         f"shared memory ({smem} bytes)")
    gx = -(-n // DENSE_COLS)

    def split_rows(splits: int) -> int:  # ceil(K / splits), in whole boxes
        return -(-k // (splits * DENSE_ROWS)) * DENSE_ROWS

    def x_bytes(splits: int) -> int:  # a split's staged x, whole
        return 16 * mt * dense_x_stride(split_rows(splits)) * 2

    if splits is not None:
        if splits not in (1, 2, 4, MAX_SPLIT):
            raise ValueError(f"splits must be 1, 2, 4 or 8, not {splits}")
        wave = splits
    else:
        splits = 1
        while (splits < MAX_SPLIT and gx * gy * splits < TARGET_BLOCKS
               and k // (2 * splits) >= MIN_SPLIT_ROWS):
            splits *= 2
        wave = splits
        while splits < MAX_SPLIT and x_bytes(splits) > X_BYTES:
            splits *= 2
    x_staged = (x_bytes(splits) > X_BYTES
                or _smem_bytes(False, mt, split_rows(splits), 1) > SMEM_LIMIT)
    if x_staged:
        splits = wave
    k_split = split_rows(splits)
    splits = -(-k // k_split)
    tiles = -(-k_split // DENSE_ROWS)
    stages = _fit_stages(tiles, lambda st: _smem_bytes(
        False, mt, k_split, st, x_staged))
    smem = _smem_bytes(False, mt, k_split, stages, x_staged)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={k} is too deep for the dense kernel's shared "
                         f"memory ({smem} bytes)")
    return LaunchPlan(mt=mt, grid=(gx, gy, splits), splits=splits,
                      k_split=k_split, stages=stages, smem_bytes=smem,
                      tiles_per_block=tiles, x_staged=x_staged)


# ---------------------------------------------- the wgmma route's plan

# bf16 x with at least this many rows (of each expert) takes the wgmma
# route; fewer (decode's 16 slots) keep the mma.sync tile built for them.
# From 17 rows the wgmma route is the faster at every GPT-2 product (an
# H100, PERF.md runs FA and FD: at M = 32, 6.6-7.9 us against the mma.sync
# route's 7.7-10.3, the unembedding 19.2 against 37.9); at 16 the mma.sync
# tile is as fast or faster but for the unembedding.
WGMMA_MIN_ROWS = 17
# Launch geometry of the wgmma route. The constants marked csrc must match
# csrc/int8_matmul_wgmma.cu.
WGMMA_COLS = 128        # weight columns (table rows) a tile (csrc kCols)
WGMMA_BK = 64           # K a ring stage (csrc kBK)
WGMMA_TILE_ROWS = (32, 64, 128, 256)  # x rows a tile: the compiled instances
WGMMA_PART_STRIDE = 132  # floats a row of a split's partial tile (csrc)
WGMMA_MAX_STAGES = 8    # ring depth, at most
# The plan's cost model, in units of 128 bytes staged by one SM: the
# kernel is bound by how fast an SM's ring fills (~45 GB/s an SM, about
# the L2's rate over an H100's 132 SMs; `ops/sweep_int8.py --plans`,
# PERF.md runs FB-FD), not by its tensor cores. A ring stage moves the
# weight box (64 units) and bn rows of x (one unit each); a tile adds its
# epilogue and the ring's fill; a K split adds the cluster's two barriers
# and, a
# tile row, the partial tile's 512 bytes that the ranks read through
# distributed shared memory (slower than the ring fills: 6 units a row).
# Persistent blocks share the tiles: the busiest block's share sets the
# time.
WGMMA_STAGE_COST = 64
WGMMA_TILE_COST = 300
WGMMA_SPLIT_COST = 150
WGMMA_REDUCE_COST = 6
# Clusters of `splits` blocks (one a SM) an H100 holds at once (csrc
# int8_matmul_wgmma_cluster_slots, cudaOccupancyMaxActiveClusters, run FC):
# a cluster must fit one GPC, so wider clusters strand SMs. A K split is
# planned only where every tile's cluster runs in the first wave.
WGMMA_CLUSTER_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                       8: 15}


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """How one call on the wgmma route is cut (csrc Int8WgmmaArgs): `bn` x
    rows a tile (wgmma's N), `splits` blocks of one cluster sharing K in
    `k_stages` stages of WGMMA_BK each (one tile a cluster when splits >
    1), `stages` ring depth, `grid` blocks (persistent: a block walks tiles
    b, b + grid, ..), `smem_bytes` of dynamic shared memory, `tiles` output
    tiles (experts x column tiles x row tiles)."""

    bn: int
    splits: int
    k_stages: int
    stages: int
    grid: int
    smem_bytes: int
    tiles: int


def wgmma_stage_bytes(bn: int) -> int:
    """One ring stage (csrc stage_bytes): the weight box (WGMMA_BK x
    WGMMA_COLS bytes), then x's box of `bn` rows x WGMMA_BK bf16."""
    return WGMMA_BK * WGMMA_COLS + bn * WGMMA_BK * 2


def wgmma_smem_bytes(bn: int, stages: int, splits: int) -> int:
    """Dynamic shared memory of one block (csrc smem_bytes): alignment
    slack, the ring (where K is split, at least the split's partial tile,
    which reuses it after the K loop), two mbarriers a stage."""
    ring = stages * wgmma_stage_bytes(bn)
    if splits > 1:
        ring = max(ring, bn * WGMMA_PART_STRIDE * 4)
    return ALIGN + ring + 16 * stages


def uses_wgmma(rows: int) -> bool:
    """Whether bf16 x with `rows` rows (of each expert) takes the wgmma
    route (the static dispatch; float32 x never does)."""
    return rows >= WGMMA_MIN_ROWS


def wgmma_plans(m: int, k: int, n: int, transposed: bool,
                experts: int = 1) -> Dict[WgmmaPlan, int]:
    """Every cut of a bf16 product on the wgmma route that csrc takes, with
    its cost under the plan's model: `m` rows of x (of each of `experts`),
    x [m, k] times q [k, n] (dense) or [n, k] (transposed).

    Tile heights from WGMMA_TILE_ROWS up to the first that holds every row;
    K splits of 1-8 in whole stages, none empty (one cluster, one tile a
    cluster, only in the dense layouts, only while every cluster fits the
    first wave, WGMMA_CLUSTER_SLOTS); the ring as deep as shared memory
    allows, up to WGMMA_MAX_STAGES and to the stages a block walks. The
    cost: tiles a block x (stages a split x (bn + WGMMA_STAGE_COST) +
    WGMMA_TILE_COST), plus a split's WGMMA_SPLIT_COST and WGMMA_REDUCE_COST
    a tile row.
    """
    if m < 1 or k < 16 or n < 1 or experts < 1:
        raise ValueError(f"empty product: M={m}, K={k}, N={n}, "
                         f"experts={experts}")
    if transposed and experts > 1:
        raise ValueError("the transposed layout has no expert batch")
    kst = -(-k // WGMMA_BK)
    col_tiles = -(-n // WGMMA_COLS)
    plans: Dict[WgmmaPlan, int] = {}
    for bn in WGMMA_TILE_ROWS:
        if bn > WGMMA_TILE_ROWS[0] and bn // 2 >= m:
            break  # a lower tile holds every row
        tiles = experts * col_tiles * -(-m // bn)
        for splits in sorted({-(-kst // -(-kst // want))
                              for want in range(1, MAX_SPLIT + 1)}):
            if splits > 1 and (transposed
                               or tiles > WGMMA_CLUSTER_SLOTS[splits]):
                continue
            per = -(-kst // splits)
            grid = min(tiles, TARGET_BLOCKS) if splits == 1 else (
                tiles * splits)
            # no deeper than the stages a block walks
            stages = _fit_stages(min(WGMMA_MAX_STAGES,
                                     per * -(-tiles // grid)),
                                 lambda st: wgmma_smem_bytes(bn, st, splits))
            smem = wgmma_smem_bytes(bn, stages, splits)
            if smem > SMEM_LIMIT:
                continue
            plan = WgmmaPlan(bn=bn, splits=splits, k_stages=per,
                             stages=stages, grid=grid, smem_bytes=smem,
                             tiles=tiles)
            cost = -(-tiles // grid) * (per * (bn + WGMMA_STAGE_COST)
                                        + WGMMA_TILE_COST)
            if splits > 1:
                cost += WGMMA_SPLIT_COST + WGMMA_REDUCE_COST * bn
            plans[plan] = cost
    return plans


def wgmma_plan(m: int, k: int, n: int, transposed: bool,
               experts: int = 1) -> WgmmaPlan:
    """Cut a bf16 product on the wgmma route: the cheapest of
    `wgmma_plans`, the fewer splits and then the taller tile on a tie.
    Raises on an empty product."""
    plans = wgmma_plans(m, k, n, transposed, experts)
    return min(plans, key=lambda p: (plans[p], p.splits, -p.bn))


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


def dense_stage_x_offset(row: int, col: int) -> int:
    """Dense with `x_staged`: the byte offset, within a ring stage, of x's
    element (block row `row`, column `col` of the stage's 128 rows of K),
    beside the weight box (csrc fill, xd + r * xs_stride)."""
    return DENSE_ROWS * DENSE_COLS + (row * dense_x_stride(DENSE_ROWS)
                                      + col) * 2


def table_stage_x_offset(k_chunk: int, row: int, col: int) -> int:
    """Transposed with `x_staged`: the byte offset, within a ring stage, of
    x's element (block row `row`, column `col` of the chunk), after the
    chunk's table boxes (csrc stage_item, xd + r * xs_stride)."""
    return table_stage_bytes(k_chunk) + (row * table_x_stride(k_chunk)
                                         + col) * 2


def table_c_row(lane: int, c: int) -> int:
    """Transposed: the row of accumulator c, whose mma column is
    2t + (c & 1): sigma(2t + (c & 1)) = t + 4 (c & 1)."""
    return (lane & 3) + 4 * (c & 1)


# The wgmma route's weight fragments (csrc int8_matmul_wgmma.cu, "The
# weight as wgmma's A operand"): lane l of warp w (0..3) of consumer
# warpgroup wg, g = l // 4, t = l % 4, holds A rows 16 w + g and
# 16 w + g + 8 of its warpgroup's 64, k 2t + h + 8 i of each 16-deep step.


def swizzle64(row: int, col: int) -> int:
    """Byte offset of (row, byte col) of a 64-byte-wide TMA box written
    with the 64-byte swizzle (csrc swz64): the 16-byte chunk index XOR
    (row // 2) mod 4."""
    return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15)


def wgmma_dense_column(wg: int, warp: int, lane: int, hi: int) -> int:
    """Dense and experts: the tile column (weight column) that A row
    16 warp + g + 8 hi of warpgroup `wg` stands for: the lane reads the
    16-bit pair of columns c, c + 1, c = 64 wg + 16 warp + 2 g; A row g is
    column c, A row g + 8 column c + 1."""
    return 64 * wg + 16 * warp + 2 * (lane >> 2) + hi


def wgmma_table_row(wg: int, warp: int, lane: int, hi: int) -> int:
    """Transposed: the tile's table row of A row 16 warp + g + 8 hi (the
    identity on the warpgroup's 64 rows)."""
    return 64 * wg + 16 * warp + (lane >> 2) + 8 * hi


def wgmma_x_row(lane: int, reg: int) -> int:
    """The tile's x row of accumulator `reg` (wgmma's D layout: n8 block
    reg // 4, column 2t + (reg & 1))."""
    return 8 * (reg >> 2) + 2 * (lane & 3) + (reg & 1)


def wgmma_acc_hi(reg: int) -> int:
    """Whether accumulator `reg` holds A row g + 8 (1) or g (0)."""
    return (reg >> 1) & 1


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


def _check_expert_args(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       b: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(K, N) of the expert layout; raises on shapes it does not take."""
    if q.dim() != 3 or q.dtype != torch.int8:
        raise ValueError(f"q must be a 3-D int8 tensor [E, K, N], got "
                         f"{q.dtype} {tuple(q.shape)}")
    e, k, n = q.shape
    if x.dim() != 3 or x.shape[0] != e or x.shape[2] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)} (x must be [E, C, K])")
    if tuple(s.shape) != (e, n):
        raise ValueError(f"s must be [{e}, {n}], got {tuple(s.shape)}")
    if b is not None and tuple(b.shape) != (e, n):
        raise ValueError(f"b must be [{e}, {n}], got {tuple(b.shape)}")
    return k, n


def _same_device(name: str, x: torch.Tensor, q: torch.Tensor,
                 s: torch.Tensor, b: Optional[torch.Tensor]) -> None:
    device = x.device
    if (q.device != device or s.device != device
            or (b is not None and b.device != device)):
        tensors = [x, q, s] + ([b] if b is not None else [])
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{name} tensors on several devices: {devices}")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                transposed: bool = False) -> torch.Tensor:
    """x [..., K] times the int8 weight `q` dequantized by `s` (see the
    module docstring for the two layouts); returns [..., N] in x's dtype
    (dense) or float32 (transposed)."""
    _same_device("int8_matmul", x, q, s, b)
    device = x.device
    if device.type == "cpu":
        _check_args(x, q, s, b, transposed)
        return int8_matmul_reference(x, q, s, b, transposed)
    if device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {device}")
    return _launch_kernel(x, q, s, b, transposed)


def int8_matmul_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert layout: x [E, C, K] times each expert's int8 weight
    q [E, K, N] dequantized by s [E, N] (+ b [E, N]); returns [E, C, N] in
    x's dtype. One kernel launch for all E experts on the card."""
    _same_device("int8_matmul_experts", x, q, s, b)
    device = x.device
    if device.type == "cpu":
        _check_expert_args(x, q, s, b)
        return int8_matmul_experts_reference(x, q, s, b)
    if device.type != "cuda":
        raise ValueError(f"int8_matmul_experts runs on cuda or cpu, not "
                         f"{device}")
    return _launch_kernel(x, q, s, b, False, experts=True)


def int8_matmul_replaced(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                         b: Optional[torch.Tensor] = None,
                         transposed: bool = False,
                         experts: bool = False) -> torch.Tensor:
    """The `mma.sync` tensor-core route at any M, bf16 CUDA tensors only:
    what bf16 x above 16 rows ran before the wgmma route replaced it there
    (`experts`: `int8_matmul_experts`'s layout). Kept to be timed and
    checked beside the new route (chip_smoke.py, ops/sweep_int8.py, the card
    tests); no main path calls it. Counted under MMA / MMA_UNEMBED /
    MMA_EXPERTS."""
    _same_device("int8_matmul_replaced", x, q, s, b)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul_replaced takes bf16 CUDA tensors, not "
                         f"{x.dtype} on {x.device}")
    return _launch_kernel(x, q, s, b, transposed, experts, replaced=True)


class _Args(ctypes.Structure):
    """The kernel's arguments for one layout (csrc Int8MatmulArgs), built
    once and passed by address."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "N", "K", "transposed", "dtype", "mt", "splits", "k_split",
        "stages", "grid_x", "smem", "x_staged", "experts")]


class _WgmmaArgs(ctypes.Structure):
    """The wgmma route's arguments for one layout (csrc Int8WgmmaArgs)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "N", "K", "layout", "experts", "bn", "splits", "k_stages",
        "stages", "grid", "smem")]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One validated (shapes, strides, dtypes, bias or not): the kernel's
    arguments (kept alive here; `address` is what is passed; the bf16
    routes' carry their launch plan), which source's entry point takes
    them (`wgmma`), the route its launches are counted under, the output's
    shape and dtype, its rows (all experts'), and which inputs need a
    per-call conversion (x copied to rows, s to float32, b to x's
    dtype)."""

    args: ctypes.Structure
    address: int
    wgmma: bool
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
# Layouts validated in this process, never lowered (the cache above clears
# itself at _MAX_LAYOUTS, and a layout validated again then counts again):
# a warmed server's traffic must add none (`utils/guards.py`).
layouts_validated = 0


def _kernel_layout(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   b: Optional[torch.Tensor], transposed: bool,
                   experts: bool = False, replaced: bool = False) -> _Layout:
    """Check what the kernels take (everything but the devices and the
    pointers' alignment, which change per call); raise on anything else.
    `experts`: the expert layout (M is then C, the rows of one expert).
    The route is static: bf16 x from WGMMA_MIN_ROWS rows (of each expert)
    takes the wgmma route unless `replaced` asks for the mma.sync one."""
    if experts:
        k, n = _check_expert_args(x, q, s, b)
    else:
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
    n_exp = q.shape[0] if experts else 0
    m = x.shape[1] if experts else (x.numel() // k if k else 0)
    rows = n_exp * m if experts else m
    wgmma = bf16 and not replaced and uses_wgmma(m)
    if bf16 and transposed and k % 64 and not wgmma:
        raise ValueError(f"the bf16 transposed kernel reads K in chunks of "
                         f"64: K ({k}) must be a multiple of 64")
    x_copy = not x.is_contiguous()
    s_cast = s.dtype != torch.float32 or not s.is_contiguous()
    b_cast = b is not None and (b.dtype != x.dtype or not b.is_contiguous())
    args: ctypes.Structure
    if wgmma:
        wp = wgmma_plan(m, k, n, transposed, experts=max(n_exp, 1))
        args = _WgmmaArgs(m, n, k, 2 if experts else int(transposed),
                          max(n_exp, 1), wp.bn, wp.splits, wp.k_stages,
                          wp.stages, wp.grid, wp.smem_bytes)
    else:
        plan = (launch_plan(m, k, n, transposed, experts=max(n_exp, 1))
                if bf16 and rows else None)
        if plan is None:
            args = _Args(m, n, k, int(transposed), _DTYPE_CODES[x.dtype], 0,
                         0, 0, 0, 0, 0, 0, n_exp)
        else:
            args = _Args(m, n, k, int(transposed), 1, plan.mt, plan.splits,
                         plan.k_split, plan.stages, plan.grid[0],
                         plan.smem_bytes, int(plan.x_staged), n_exp)
    if wgmma:
        route = (WGMMA_EXPERTS if experts else
                 WGMMA_UNEMBED if transposed else WGMMA)
    elif experts:
        route = MMA_EXPERTS if bf16 else FMA_EXPERTS
    else:
        route = (MMA_UNEMBED if transposed else MMA) if bf16 else FMA
    out_shape = ((n_exp, m, n) if experts else (*x.shape[:-1], n))
    return _Layout(args=args, address=ctypes.addressof(args), wgmma=wgmma,
                   route=route,
                   out_shape=out_shape,
                   out_dtype=torch.float32 if transposed else x.dtype,
                   m=rows, x_copy=x_copy, s_cast=s_cast, b_cast=b_cast)


def _remember_layout(key: tuple, lay: _Layout) -> None:
    """Cache a layout just validated and count it."""
    global layouts_validated
    layouts_validated += 1
    if len(_layouts) >= _MAX_LAYOUTS:
        _layouts.clear()
    _layouts[key] = lay


def _launch_kernel(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   b: Optional[torch.Tensor], transposed: bool,
                   experts: bool = False,
                   replaced: bool = False) -> torch.Tensor:
    """Validate the layout (once per key), launch the route's kernel, count
    the launch."""
    key = (x.shape, x.stride(), x.dtype, q.shape, q.stride(), q.dtype,
           s.shape, s.stride(), s.dtype,
           None if b is None else (b.shape, b.stride(), b.dtype), transposed,
           experts, replaced)
    lay = _layouts.get(key)
    if lay is None:
        lay = _kernel_layout(x, q, s, b, transposed, experts, replaced)
        _remember_layout(key, lay)
    out = x.new_empty(lay.out_shape, dtype=lay.out_dtype)
    if lay.m == 0:
        return out
    if lay.x_copy:
        x = (x if experts else x.reshape(-1, x.shape[-1])).contiguous()
    if lay.s_cast:
        s = s.float().contiguous()
    if lay.b_cast:
        b = b.to(x.dtype).contiguous()
    xp, qp = x.data_ptr(), q.data_ptr()
    if (xp | qp) % 16:
        raise ValueError("x and q must be 16-byte aligned (the kernel reads "
                         "16-byte vectors)")
    launch, stream = _wgmma_entry_point() if lay.wgmma else _entry_point()
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
_wgmma_bound: Optional[Tuple[Callable[..., int], Callable[[int], int]]] = None


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


def wgmma_cluster_slots(splits: int, smem: int) -> int:
    """How many clusters of `splits` blocks of `smem` bytes the card holds
    at once (cudaOccupancyMaxActiveClusters through csrc); needs the card.
    What WGMMA_CLUSTER_SLOTS records for the H100."""
    fn = build.load(WGMMA_SOURCE).int8_matmul_wgmma_cluster_slots
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = fn(splits, smem)
    if got < 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                           f"{-got}")
    return got


def _wgmma_entry_point() -> Tuple[Callable[..., int], Callable[[int], int]]:
    """The wgmma route's C launch function (csrc/int8_matmul_wgmma.cu),
    bound once (built first if needed), and the current-stream getter."""
    global _wgmma_bound
    if _wgmma_bound is None:
        fn = build.load(WGMMA_SOURCE).int8_matmul_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        _wgmma_bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _wgmma_bound
