"""The int8 matmul's wgmma route (csrc/int8_matmul_wgmma.cu) on the CPU.

The kernel runs only on the card (tests/test_torch_kernels_cuda.py holds
it against its plain version there). Here: a numpy model of its register
fragments, written from the PTX definitions of wgmma's A-register and D
layouts and of TMA's swizzles, run through quant_matmul's maps (the
kernel's formulas) for the dense, transposed and expert layouts with
ragged rows, K splits summed in rank order; the launch plan's invariants
at GPT-2's, Llama-3-8B's and gpt2-moe's products; the static dispatch on
fake CUDA tensors; and the plain versions against the JAX package's
expressions at rows the new route takes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.models import common as jax_common
from distributed_lms_raft_llm_tpu.models import quant as jax_quant
from distributed_lms_raft_llm_tpu_torch.ops import quant_matmul as qm
from test_torch_quant import (
    _byte_perm,
    _fake_cuda,
    _i8x2_to_bf16x2,
)

# ------------------------------------------------------ the fragment model


def _u16(box, off):
    return np.uint32(box[off]) | (np.uint32(box[off + 1]) << np.uint32(8))


def _a_fragments(box, layout, wg, warp, lane, step):
    """The four A registers (each two values) one lane converts for one
    16-deep step of a stage, read at the kernel's offsets."""
    t = lane & 3
    k = 16 * step + 2 * t
    if layout == "transposed":
        rows = [qm.wgmma_table_row(wg, warp, lane, hi) for hi in (0, 1)]
        raw = [_u16(box, qm.swizzle64(rows[0], k)),
               _u16(box, qm.swizzle64(rows[1], k)),
               _u16(box, qm.swizzle64(rows[0], k + 8)),
               _u16(box, qm.swizzle64(rows[1], k + 8))]
        return [_i8x2_to_bf16x2(_byte_perm(r, 0, 0x0100)) for r in raw]
    c = qm.wgmma_dense_column(wg, warp, lane, 0)
    raw = [_u16(box, qm.swizzle128(k + d, c)) for d in (0, 1, 8, 9)]
    return [_i8x2_to_bf16x2(_byte_perm(raw[0], raw[1], 0x0400)),
            _i8x2_to_bf16x2(_byte_perm(raw[0], raw[1], 0x0501)),
            _i8x2_to_bf16x2(_byte_perm(raw[2], raw[3], 0x0400)),
            _i8x2_to_bf16x2(_byte_perm(raw[2], raw[3], 0x0501))]


def _weight_box(q, layout, n0, k0):
    """One stage's weight box as TMA writes it, zeros outside q: dense
    [64 K rows x 128 bytes] under the 128-byte swizzle, transposed [128
    table rows x 64 bytes] under the 64-byte swizzle."""
    box = np.zeros(qm.WGMMA_BK * qm.WGMMA_COLS, np.uint8)
    for r in range(qm.WGMMA_COLS if layout == "transposed" else qm.WGMMA_BK):
        for c in range(qm.WGMMA_BK if layout == "transposed"
                       else qm.WGMMA_COLS):
            if layout == "transposed":
                v, k, off = n0 + r, k0 + c, qm.swizzle64(r, c)
                val = q[v, k] if v < q.shape[0] and k < q.shape[1] else 0
            else:
                k, n, off = k0 + r, n0 + c, qm.swizzle128(r, c)
                val = q[k, n] if k < q.shape[0] and n < q.shape[1] else 0
            box[off] = np.int8(val).view(np.uint8)
    return box


def _tile_model(x, q, layout, bn, n0, m0, stages):
    """One output tile's accumulators, lane by lane: for each stage in
    `stages` the boxes (x's rows past its end read as zeros, as TMA fills
    them), the A fragments of each lane assembled into each warpgroup's
    64 x 16 A matrix (wgmma's register layout: lane (g, t) of warp w holds
    A[16 w + g + 8 (i & 1)][2t + h + 8 (i >> 1)] in register i, half h),
    B = x's box (K-major: B[k][j] is x row j, k), D += A B. Returns d[wg]
    [64, bn], and checks each A entry is the weight the maps name."""
    m_all, k_all = x.shape
    d = [np.zeros((64, bn)) for _ in range(2)]
    for ks in stages:
        k0 = ks * qm.WGMMA_BK
        box = _weight_box(q, layout, n0, k0)
        xb = np.zeros((bn, qm.WGMMA_BK))
        rows = x[m0:m0 + bn, k0:k0 + qm.WGMMA_BK]
        xb[:rows.shape[0], :rows.shape[1]] = rows
        for wg in range(2):
            for step in range(4):
                a = np.full((64, 16), np.nan)
                for warp in range(4):
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        frags = _a_fragments(box, layout, wg, warp, lane,
                                             step)
                        for i in range(4):
                            for h in range(2):
                                a[16 * warp + g + 8 * (i & 1),
                                  2 * t + h + 8 * (i >> 1)] = frags[i][h]
                        for hi in (0, 1):
                            for kk in range(16):
                                k = k0 + 16 * step + kk
                                if layout == "transposed":
                                    v = n0 + qm.wgmma_table_row(wg, warp,
                                                                lane, hi)
                                    want = (q[v, k] if v < q.shape[0]
                                            and k < k_all else 0)
                                else:
                                    n = n0 + qm.wgmma_dense_column(
                                        wg, warp, lane, hi)
                                    want = (q[k, n] if k < k_all
                                            and n < q.shape[1] else 0)
                                row = 16 * warp + g + 8 * hi
                                if 2 * t <= kk % 8 < 2 * t + 2:
                                    assert a[row, kk] == want
                assert not np.isnan(a).any()
                b = xb[:, 16 * step:16 * step + 16].T
                d[wg] += a @ b
    return d


def _store(d, y, layout, bn, n0, m0, m_rows, n_cols, scale=None):
    """The epilogue: accumulator `reg` of each lane into y at the maps'
    row and column, rows past m_rows and columns past n_cols masked."""
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                g = lane >> 2
                for reg in range(bn // 2):
                    hi = qm.wgmma_acc_hi(reg)
                    xr = qm.wgmma_x_row(lane, reg)
                    col = (qm.wgmma_table_row(wg, warp, lane, hi)
                           if layout == "transposed"
                           else qm.wgmma_dense_column(wg, warp, lane, hi))
                    m, n = m0 + xr, n0 + col
                    if m < m_rows and n < n_cols:
                        val = d[wg][16 * warp + g + 8 * hi, xr]
                        y[m, n] = val if scale is None else val * scale[n]


def _product_model(x, q, layout, plan):
    """y = x @ q (dense) or x @ q^T (transposed) through the plan: every
    tile the grid's clusters walk, each split's partial tile, the splits
    summed in rank order."""
    m_rows, k = x.shape
    n_cols = q.shape[0] if layout == "transposed" else q.shape[1]
    kst = -(-k // qm.WGMMA_BK)
    col_tiles = -(-n_cols // qm.WGMMA_COLS)
    row_tiles = -(-m_rows // plan.bn)
    y = np.full((m_rows, n_cols), np.nan)
    clusters = plan.grid // plan.splits
    seen = []
    for cl in range(clusters):
        for ti in range(cl, plan.tiles, clusters):
            seen.append(ti)
            n0 = (ti // row_tiles) * qm.WGMMA_COLS
            m0 = (ti % row_tiles) * plan.bn
            total = np.zeros((m_rows, n_cols))
            for rank in range(plan.splits):
                ks0 = rank * plan.k_stages
                nks = min(plan.k_stages, kst - ks0)
                assert nks > 0
                part = np.zeros((m_rows, n_cols))
                d = _tile_model(x, q, layout, plan.bn, n0, m0,
                                range(ks0, ks0 + nks))
                _store(d, part, layout, plan.bn, n0, m0, m_rows, n_cols)
                total += part  # rank order
            sl = (slice(m0, min(m0 + plan.bn, m_rows)),
                  slice(n0, min(n0 + qm.WGMMA_COLS, n_cols)))
            y[sl] = total[sl]
    assert sorted(seen) == list(range(plan.tiles))
    assert col_tiles * row_tiles == plan.tiles
    return y


@pytest.mark.parametrize("m,k,n", [(17, 128, 128), (40, 192, 48),
                                   (100, 64, 256)])
def test_dense_wgmma_fragments_compute_the_product(m, k, n):
    """Dense tiles with ragged rows (17, 40: a partial tile of 32 or 64),
    N past the last column tile (48 of 128) and K split across a cluster
    where the plan splits it: the model's y equals x @ q exactly."""
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-8, 9, (m, k)).astype(np.float64)
    q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    plan = qm.wgmma_plan(m, k, n, False)
    np.testing.assert_array_equal(_product_model(x, q, "dense", plan),
                                  x @ q.astype(np.float64))


def test_dense_wgmma_split_partials_sum_in_rank_order():
    """A plan with K split across a cluster (the admission chunk's shape,
    cut to one column tile): every split holds whole stages, and the model
    through it is exact."""
    plan = qm.wgmma_plan(32, 384, 128, False)
    assert plan.splits > 1 and plan.grid == plan.tiles * plan.splits
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (32, 384)).astype(np.float64)
    q = rng.integers(-128, 128, (384, 128)).astype(np.int8)
    np.testing.assert_array_equal(_product_model(x, q, "dense", plan),
                                  x @ q.astype(np.float64))


@pytest.mark.parametrize("m,k,n", [(17, 128, 129), (33, 64, 256)])
def test_transposed_wgmma_fragments_compute_the_product(m, k, n):
    """The table layout: 128-row tiles, the last holding one row (129),
    ragged rows of x, the 64-byte swizzle, k in the hardware's order; the
    model's logits equal x @ q^T times the row scales exactly."""
    rng = np.random.default_rng(m * n)
    x = rng.integers(-8, 9, (m, k)).astype(np.float64)
    q = rng.integers(-128, 128, (n, k)).astype(np.int8)
    plan = qm.wgmma_plan(m, k, n, True)
    assert plan.splits == 1
    np.testing.assert_array_equal(_product_model(x, q, "transposed", plan),
                                  x @ q.astype(np.float64).T)


def test_expert_wgmma_tiles_stay_in_their_expert():
    """The expert layout: tile ti of E x column x row tiles reads expert
    e = ti // (column x row tiles); rows past C of one expert read as
    zeros (TMA's 3-D box), never the next expert's rows."""
    e, c, k, n = 3, 17, 128, 128
    rng = np.random.default_rng(9)
    x = rng.integers(-8, 9, (e, c, k)).astype(np.float64)
    q = rng.integers(-128, 128, (e, k, n)).astype(np.int8)
    plan = qm.wgmma_plan(c, k, n, False, experts=e)
    per_expert = plan.tiles // e
    row_tiles = -(-c // plan.bn)
    y = np.full((e, c, n), np.nan)
    clusters = plan.grid // plan.splits
    for cl in range(clusters):
        for ti in range(cl, plan.tiles, clusters):
            ex, r = divmod(ti, per_expert)
            n0 = (r // row_tiles) * qm.WGMMA_COLS
            m0 = (r % row_tiles) * plan.bn
            kst = -(-k // qm.WGMMA_BK)
            total = np.zeros((c, n))
            for rank in range(plan.splits):
                ks0 = rank * plan.k_stages
                d = _tile_model(x[ex], q[ex], "dense", plan.bn, n0, m0,
                                range(ks0, min(ks0 + plan.k_stages, kst)))
                part = np.zeros((c, n))
                _store(d, part, "dense", plan.bn, n0, m0, c, n)
                total += part
            y[ex, m0:m0 + plan.bn, n0:n0 + qm.WGMMA_COLS] = \
                total[m0:m0 + plan.bn, n0:n0 + qm.WGMMA_COLS]
    np.testing.assert_array_equal(
        y, np.einsum("eck,ekn->ecn", x, q.astype(np.float64)))


def test_wgmma_fragment_maps_and_reads():
    """Each warpgroup's lanes name its 64 columns (rows) exactly once per A
    row pair; a lane's accumulators name its tile's x rows once each; and
    every 16-bit read instruction's 32 lanes fall on distinct 4-byte banks
    or share a word (no bank conflict) under both swizzles."""
    for wg in range(2):
        cols = sorted(qm.wgmma_dense_column(wg, w, lane, hi)
                      for w in range(4) for lane in range(0, 32, 4)
                      for hi in (0, 1))
        assert cols == list(range(64 * wg, 64 * wg + 64))
        rows = sorted(qm.wgmma_table_row(wg, w, lane, hi)
                      for w in range(4) for lane in range(0, 32, 4)
                      for hi in (0, 1))
        assert rows == list(range(64 * wg, 64 * wg + 64))
    for bn in qm.WGMMA_TILE_ROWS:
        for lane in range(4):
            xs = sorted({qm.wgmma_x_row(lane, reg) for reg in range(bn // 2)
                         if qm.wgmma_acc_hi(reg) == 0})
            assert xs == sorted(8 * j + 2 * lane + h for j in range(bn // 8)
                                for h in (0, 1))
    for r in range(16):
        assert sorted(qm.swizzle64(r, c) - 64 * r
                      for c in range(0, 64, 16)) == list(range(0, 64, 16))
    for wg in range(2):
        for w in range(4):
            for step in range(4):
                for d in (0, 1, 8, 9):  # dense: one load per K row offset
                    words = {}
                    for lane in range(32):
                        off = qm.swizzle128(
                            16 * step + 2 * (lane & 3) + d,
                            qm.wgmma_dense_column(wg, w, lane, 0))
                        words.setdefault((off // 4) % 32, set()).add(off // 4)
                    assert all(len(v) == 1 for v in words.values())
                for hi in (0, 1):
                    for kh in (0, 8):  # transposed: rows R (+ 8), k (+ 8)
                        words = {}
                        for lane in range(32):
                            off = qm.swizzle64(
                                qm.wgmma_table_row(wg, w, lane, hi),
                                16 * step + 2 * (lane & 3) + kh)
                            words.setdefault((off // 4) % 32,
                                             set()).add(off // 4)
                        assert all(len(v) == 1 for v in words.values())


# ---------------------------------------------------------------- the plan

GPT2 = [(768, 2304, False), (768, 3072, False), (768, 768, False),
        (3072, 768, False), (768, 50257, True)]
LLAMA = [(4096, 4096, False), (4096, 1024, False), (4096, 14336, False),
         (14336, 4096, False), (4096, 128256, True)]
MOE = [(768, 3072, False, 8), (3072, 768, False, 8)]
PRODUCTS = ([p + (1,) for p in GPT2] + [p + (1,) for p in LLAMA] + MOE)


@pytest.mark.parametrize("m", [17, 32, 128, 512, 1024, 2048])
@pytest.mark.parametrize("k,n,transposed,experts", PRODUCTS,
                         ids=lambda v: str(v))
def test_wgmma_plan_invariants(m, k, n, transposed, experts):
    """What csrc's valid_plan checks and what the design claims: a tile
    height from the compiled set, no taller than the rows need; tiles
    that cover every output once (row and column tiles covering M and N,
    the grid's clusters walking each tile once); K splits of whole stages,
    none empty, within one cluster, only in the dense layouts, one tile a
    cluster and the clusters within one wave; shared memory within the
    card's limit and equal to csrc's sum."""
    p = qm.wgmma_plan(m, k, n, transposed, experts=experts)
    assert p.bn in qm.WGMMA_TILE_ROWS
    assert p.bn == qm.WGMMA_TILE_ROWS[0] or p.bn // 2 < m
    row_tiles = -(-m // p.bn)
    col_tiles = -(-n // qm.WGMMA_COLS)
    assert row_tiles * p.bn >= m > (row_tiles - 1) * p.bn
    assert p.tiles == experts * row_tiles * col_tiles
    clusters = p.grid // p.splits
    assert p.grid % p.splits == 0
    walked = [ti for cl in range(clusters)
              for ti in range(cl, p.tiles, clusters)]
    assert sorted(walked) == list(range(p.tiles))
    kst = -(-k // qm.WGMMA_BK)
    assert p.k_stages * p.splits >= kst > p.k_stages * (p.splits - 1)
    assert 1 <= p.splits <= qm.MAX_SPLIT
    if p.splits == 1:
        assert p.grid == min(p.tiles, qm.TARGET_BLOCKS)
    else:
        assert not transposed and p.grid == p.tiles * p.splits
        assert p.tiles <= qm.WGMMA_CLUSTER_SLOTS[p.splits]
    assert 1 <= p.stages <= qm.WGMMA_MAX_STAGES
    assert p.smem_bytes == qm.wgmma_smem_bytes(p.bn, p.stages, p.splits)
    assert p.smem_bytes <= qm.SMEM_LIMIT


def test_wgmma_plan_worked_examples():
    """The admission chunk (M = 32): one 32-row tile, K split over a
    cluster (wqkv: 18 column tiles x 4 splits of 3 stages; 6 splits would
    need 18 clusters of 6, one more than an H100 holds at once, run FC);
    the unembedding one wave of persistent blocks over 393 tiles; the
    scoring quantum (M = 2,048) 128-row tiles; Llama's lm_head at M = 512
    256-row tiles, a 5-stage ring; mlp.wo at M = 32 8 splits of 6 stages
    (48 blocks, where one split would leave 6 SMs streaming 2.4 MB)."""
    p = qm.wgmma_plan(32, 768, 2304, False)
    assert (p.bn, p.splits, p.k_stages, p.grid) == (32, 4, 3, 72)
    assert qm.WGMMA_CLUSTER_SLOTS[6] < 18 <= qm.WGMMA_CLUSTER_SLOTS[4]
    p = qm.wgmma_plan(32, 768, 50257, True)
    assert (p.bn, p.splits, p.grid, p.tiles) == (32, 1, 132, 393)
    p = qm.wgmma_plan(2048, 768, 2304, False)
    assert (p.bn, p.splits, p.grid, p.tiles) == (128, 1, 132, 288)
    p = qm.wgmma_plan(512, 4096, 128256, True)
    assert (p.bn, p.stages, p.tiles) == (256, 5, 2004)
    p = qm.wgmma_plan(32, 3072, 768, False)
    assert (p.bn, p.splits, p.k_stages, p.grid) == (32, 8, 6, 48)


def test_wgmma_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="empty product"):
        qm.wgmma_plan(0, 768, 768, False)
    with pytest.raises(ValueError, match="no expert batch"):
        qm.wgmma_plan(32, 768, 768, True, experts=2)


# ------------------------------------------------------------ the dispatch


def _inputs(m, k, n, transposed=False, e=0, seed=3):
    rng = np.random.default_rng(seed)
    lead = (e, m) if e else (m,)
    x = torch.from_numpy(rng.standard_normal(lead + (k,), np.float32))
    shape = ((e,) if e else ()) + ((n, k) if transposed else (k, n))
    q = torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, ((e,) if e else ()) + (n,))
                         .astype(np.float32))
    return x, q, s


def test_bf16_rows_past_the_crossover_launch_the_wgmma_route(monkeypatch):
    """bf16 CUDA tensors with WGMMA_MIN_ROWS rows (of each expert) or more
    go to the wgmma entry point with wgmma_plan's cut in its struct and
    count on the wgmma routes; fewer rows go to the mma.sync entry point;
    float32 to the CUDA cores; `int8_matmul_replaced` to the mma.sync
    route at any M; CPU tensors to the plain version (no launch)."""
    old, new = [], []

    def fake(calls, struct):
        def launch(*args):
            calls.append((struct.from_address(args[0]),) + args[1:])
            return 0
        return launch

    monkeypatch.setattr(qm, "_entry_point",
                        lambda: (fake(old, qm._Args), lambda i: 0))
    monkeypatch.setattr(qm, "_wgmma_entry_point",
                        lambda: (fake(new, qm._WgmmaArgs), lambda i: 0))
    qm._layouts.clear()
    lo, hi = qm.WGMMA_MIN_ROWS - 1, qm.WGMMA_MIN_ROWS
    before = dict(qm.launch_counts)
    cuda = _fake_cuda
    bf = torch.bfloat16
    x, q, s = _inputs(hi, 64, 48)
    b = torch.zeros(48)
    assert qm.int8_matmul(cuda(x.to(bf)), cuda(q), cuda(s),
                          cuda(b.to(bf))).dtype == bf
    qm.int8_matmul(cuda(x[:lo].to(bf)), cuda(q), cuda(s))
    qm.int8_matmul(cuda(x), cuda(q), cuda(s))            # float32
    xt, qt, st = _inputs(32, 64, 129, transposed=True)
    assert qm.int8_matmul(cuda(xt.to(bf)), cuda(qt), cuda(st),
                          transposed=True).dtype == torch.float32
    qm.int8_matmul(cuda(xt[:lo].to(bf)), cuda(qt), cuda(st), transposed=True)
    xe, qe, se = _inputs(hi, 32, 48, e=3)
    qm.int8_matmul_experts(cuda(xe.to(bf)), cuda(qe), cuda(se))
    qm.int8_matmul_experts(cuda(xe[:, :lo].to(bf)), cuda(qe), cuda(se))
    qm.int8_matmul_replaced(cuda(x.to(bf)), cuda(q), cuda(s))
    qm.int8_matmul_replaced(cuda(xe.to(bf)), cuda(qe), cuda(se),
                            experts=True)
    qm.int8_matmul(x, q, s)                               # CPU: plain
    counts = qm.launch_counts
    assert {k: counts[k] - before[k] for k in counts} == {
        qm.KERNEL: 9, qm.WGMMA: 1, qm.WGMMA_UNEMBED: 1, qm.WGMMA_EXPERTS: 1,
        qm.MMA: 2, qm.MMA_UNEMBED: 1, qm.MMA_EXPERTS: 2, qm.FMA: 1,
        qm.FMA_EXPERTS: 0}
    assert [(a.M, a.N, a.K, a.layout, a.experts) for a, *_ in new] == [
        (hi, 48, 64, 0, 1), (32, 129, 64, 1, 1), (hi, 48, 32, 2, 3)]
    for (a, *_), (m, k, n, tr, e) in zip(new, [(hi, 64, 48, False, 1),
                                               (32, 64, 129, True, 1),
                                               (hi, 32, 48, False, 3)]):
        p = qm.wgmma_plan(m, k, n, tr, experts=e)
        assert (a.bn, a.splits, a.k_stages, a.stages, a.grid, a.smem) == (
            p.bn, p.splits, p.k_stages, p.stages, p.grid, p.smem_bytes)
    assert new[0][4] is not None and new[1][4] is None  # the bias pointer
    assert [(a.M, a.dtype, a.experts) for a, *_ in old] == [
        (lo, 1, 0), (hi, 0, 0), (lo, 1, 0), (lo, 1, 3), (hi, 1, 0),
        (hi, 1, 3)]
    qm._layouts.clear()


def test_replaced_route_refuses_what_it_is_not_for():
    x, q, s = _inputs(32, 64, 48)
    with pytest.raises(ValueError, match="bf16 CUDA tensors"):
        qm.int8_matmul_replaced(x.bfloat16(), q, s)
    with pytest.raises(ValueError, match="bf16 CUDA tensors"):
        qm.int8_matmul_replaced(_fake_cuda(x), _fake_cuda(q), _fake_cuda(s))


def test_graph_routes_name_the_wgmma_kernels():
    """A captured graph's wgmma nodes, by their device names (mangled in
    the source's anonymous namespace, as nvcc emits them), land in the
    wgmma routes, and the mma.sync kernels' in theirs."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )

    ns = "_ZN53_GLOBAL__N__87e81917_20_int8_matmul_wgmma_cu_4a6699fe"
    names = {
        ns + "23int8_wgmma_dense_kernelILi128EEEv14CUtensorMap_st": 48,
        ns + "22int8_wgmma_rows_kernelILi32EEEv14CUtensorMap_stS1_": 1,
        ns + "25int8_wgmma_experts_kernelILi64EEEv14CUtensorMap_s": 24,
        "_ZN12_GLOBAL__N_121int8_mma_dense_kernelILi1ELb0EEEv": 5,
        "_ZN12_GLOBAL__N_120int8_mma_rows_kernelILi1ELb0EEEv": 2,
    }
    routes = routes_of_names(names)
    assert {k: v for k, v in routes.items() if v} == {
        "int8_matmul_wgmma": 48, "int8_matmul_wgmma_unembed": 1,
        "int8_matmul_wgmma_experts": 24, "int8_matmul_mma": 5,
        "int8_matmul_mma_unembed": 2}
    counts = routes_of_counts({qm.WGMMA: 3, qm.WGMMA_UNEMBED: 2,
                               qm.WGMMA_EXPERTS: 1, qm.KERNEL: 6})
    assert {k: v for k, v in counts.items() if v} == {
        "int8_matmul_wgmma": 3, "int8_matmul_wgmma_unembed": 2,
        "int8_matmul_wgmma_experts": 1}


def test_crossover_is_decode_s_rows():
    """Decode's 16 slots keep the mma.sync tile; an admission chunk of 32
    and everything larger take the wgmma route."""
    assert not qm.uses_wgmma(16) and qm.uses_wgmma(17)
    assert all(qm.uses_wgmma(m) for m in (32, 128, 144, 512, 2048))


# --------------------------------------------- the plain versions vs JAX


@pytest.mark.parametrize("m", [17, 32, 100])
def test_plain_versions_match_jax_at_wgmma_rows(m):
    """At rows the wgmma route takes, the plain versions the card holds it
    against equal the JAX package's expressions in float32: common.dense
    (with a bias), quant.unembed, and moe.py's expert_dense einsum then
    the bias add."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 96)).astype(np.float32)
    q = rng.integers(-127, 128, (96, 48)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, 48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    got = qm.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(q),
                                   torch.from_numpy(s), torch.from_numpy(b))
    want = jax_common.dense(jnp.asarray(x), {"q": jnp.asarray(q),
                                             "s": jnp.asarray(s)},
                            jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    table = rng.integers(-127, 128, (40, 96)).astype(np.int8)
    ts = rng.uniform(1e-3, 1e-2, 40).astype(np.float32)
    got = qm.int8_matmul_reference(torch.from_numpy(x),
                                   torch.from_numpy(table),
                                   torch.from_numpy(ts), transposed=True)
    want = jax_quant.unembed(jnp.asarray(x)[None], {"q": jnp.asarray(table),
                                                    "s": jnp.asarray(ts)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], rtol=1e-5,
                               atol=1e-5)
    xe = rng.standard_normal((3, m, 96)).astype(np.float32)
    qe = rng.integers(-127, 128, (3, 96, 48)).astype(np.int8)
    se = rng.uniform(1e-3, 1e-2, (3, 48)).astype(np.float32)
    be = rng.standard_normal((3, 48)).astype(np.float32)
    got = qm.int8_matmul_experts_reference(*map(torch.from_numpy,
                                                (xe, qe, se, be)))
    jy = jnp.einsum("ecd,edm->ecm", jnp.asarray(xe),
                    jnp.asarray(qe).astype(jnp.float32))
    jy = jy * jnp.asarray(se)[:, None, :] + jnp.asarray(be)[:, None, :]
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
