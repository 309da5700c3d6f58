// Weight-only int8 matrix product for many rows of bf16 x: a warp-
// specialised, persistent TMA + wgmma kernel for Hopper (sm_90a), plain C
// interface.
//
// What it replaces. No Pallas kernel stands behind it. The JAX package
// leaves these products to XLA-fused einsums, the int8 -> bf16 convert fused
// into the operand load:
//   distributed_lms_raft_llm_tpu/models/common.py:58-60 (dense: x @ q * s,
//     then + b at :63-64), models/quant.py:139-146 (unembed: x @ table^T in
//     float32, * s), models/moe.py:168-170 (expert_dense: the einsum
//     "ecd,edm->ecm" * s, the bias added by the caller).
// It computes what ops/csrc/int8_matmul.cu's tensor-core route computes:
// y = (x @ q.astype(bf16)) * s (+ b), each int8 converted to bf16 exactly
// (i8x2_to_bf16x2), bf16 x bf16 products summed in float32, one scale per
// output column, then one rounding: to bf16 (dense, experts) or stored
// float32 (the logits). No atomics and no global scratch: the result does
// not depend on the schedule, and every launch can be captured in a graph.
// The wrapper (ops/quant_matmul.py) sends bf16 x with more than
// WGMMA_MIN_ROWS - 1 rows (of each expert) here; int8_matmul.cu keeps
// decode (M <= 16) and float32 x.
//
// Layouts (row-major, contiguous; K a multiple of 16):
//   dense       x [M, K] bf16, q [K, N] int8 (N a multiple of 16), s [N] f32,
//               b [N] bf16 or null; y [M, N] bf16
//   transposed  x [M, K] bf16, q [N, K] int8 (the embedding table), s [N];
//               y [M, N] float32 (logits)
//   experts     x [E, C, K] bf16, q [E, K, N], s [E, N], b [E, N] or null;
//               y [E, C, N] bf16 (M = C)
//
// What bounds it. At M = 32 (one slot's fused admission chunk, the
// deployment's prefill_chunk_tokens) each weight byte feeds 32
// multiply-adds: bytes bound it (GPT-2's 768 x 3072: 0.78 us at 3.35 TB/s,
// the same work at 989 TFLOP/s 0.15 us). From about M = 512 up the products
// bound it (Llama's 4096 x 14336 at M = 2,048: 243 us of bf16 operations,
// 18 us of bytes). In between, both.
//
// Design, against the faults of the M > 16 mma.sync route it takes over
// (int8_matmul.cu's decode tile stacked four deep):
// - wgmma instead of mma.sync, operands swapped: the tile computes
//   y^T = q^T x^T, so the int8 weight is wgmma's register-sourced A operand
//   (converted in registers, as CUTLASS's Hopper mixed-input collective does
//   for a narrow weight) and x is its shared-memory B operand, read by a
//   descriptor straight from the TMA box. A consumer warpgroup owns 64
//   weight columns (wgmma's M = 64); the block's x rows are wgmma's N:
//   kBN = 32, 64, 128 or 256, compile-time instances the plan picks
//   (ops/quant_matmul.py::wgmma_plan). A 32-row admission chunk is one
//   m64n32k16 a step with no padded rows (the old route padded it to 64).
//   Ragged rows arrive as zeros from the TMA box; the epilogue masks them.
// - Each weight byte is staged and converted once per kBN rows (up to
//   256), not once per 64: the old route re-staged and re-converted the
//   whole weight tile for every 64 rows of x.
// - x is staged once per tile and stage, by TMA into the canonical K-major
//   128-byte-swizzled layout wgmma reads, and shared by both consumer
//   warpgroups: the old deep-K transposed route staged x's rows beside
//   every 64-row table tile and every K chunk. Here x is re-read once per
//   128 table rows, through L2.
// - Warp specialisation: warpgroup 2 is the producer (one thread issues the
//   TMA loads of a ring of `stages` stages, each the weight box and x's box,
//   completion counted on mbarriers; setmaxnreg gives its registers to the
//   consumers), warpgroups 0 and 1 convert and multiply. A consumer frees a
//   stage once the wgmma that last read it has completed.
// - Persistent blocks walk the output tiles with a stride of the grid, the
//   row tiles of one column tile next to each other, so the blocks that run
//   together re-read one weight column tile from L2, not from memory.
// - Where the tiles do not fill the card (the admission chunk: 18 column
//   tiles of 128 for GPT-2's wqkv), K is split across a thread-block
//   cluster of up to 8 blocks, one tile a cluster; rank r sums slice r of
//   the tile over the ranks' partial tiles in rank order through
//   distributed shared memory (deterministic, as int8_matmul.cu is).
// - Experts: the same body with an expert coordinate, the grid walking
//   E x column x row tiles; the tensor maps span [E, K, N] and [E, C, K].
//
// The weight as wgmma's A operand (lane l of warp w of consumer warpgroup
// wg, g = l / 4, t = l % 4; A rows 16 w + g and 16 w + g + 8 of the
// warpgroup's 64, k 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-deep step):
// - dense [K, N]: the A row is a weight column. The lane reads 16-bit words
//   (columns c, c + 1, c = 64 wg + 16 w + 2g of the 128-byte box) of K rows
//   2t, 2t + 1, 2t + 8, 2t + 9 under the 128-byte swizzle and pairs them
//   with prmt, so A row g stands for column c and A row g + 8 for c + 1
//   (quant_matmul.py::wgmma_dense_column); the epilogue stores the two as
//   one bf16 pair;
// - transposed [N, K]: the A row is a table row, K-contiguous: the lane
//   reads 16-bit pairs of rows 64 wg + 16 w + g (and + 8) at k 2t and
//   2t + 8 of the step, in the hardware's k order (x reaches wgmma from
//   shared memory in its own order), under the 64-byte swizzle of a
//   128-row x 64-byte box (quant_matmul.py::swizzle64).
// The CPU tests run a numpy model of these fragments
// (tests/test_torch_int8_wgmma.py).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

// The launch's arguments, prepared once per layout by the wrapper (ctypes
// structure `_WgmmaArgs` in ops/quant_matmul.py, plan from `wgmma_plan`)
// and passed by address. Outside the anonymous namespace, so the C entry
// point that takes it keeps external linkage.
struct Int8WgmmaArgs {
  int M, N, K;     // M: rows of x (of one expert: C)
  int layout;      // 0 dense [K, N], 1 transposed [N, K], 2 experts [E, K, N]
  int experts;     // E: 1 unless the expert layout
  int bn;          // x rows a tile: 32, 64, 128 or 256
  int splits;      // K splits, the blocks of one cluster (1..8)
  int k_stages;    // 64-deep stages a split (the last split may have fewer)
  int stages;      // ring depth
  int grid;        // blocks: min(tiles, SMs), or tiles x splits
  int smem;        // dynamic shared memory, bytes
};

namespace {

constexpr int kDense = 0, kRows = 1, kExperts = 2;
constexpr int kThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kCols = 128;       // weight columns (table rows) a tile
constexpr int kBK = 64;          // K a stage: x's box is 128 bytes wide
constexpr int kWBox = kBK * kCols;       // the weight box, 8 KB
constexpr int kPartStride = kCols + 4;   // floats a row of a partial tile
constexpr int kMaxCluster = 8;
constexpr int kAlign = 1024;     // the 128-byte swizzle repeats every 1 KB

// One ring stage: the weight box, then x's box (kBN rows x 128 bytes).
__host__ __device__ constexpr int stage_bytes(int bn) {
  return kWBox + bn * kBK * 2;
}

// Dynamic shared memory of a launch (ops/quant_matmul.py::wgmma_smem_bytes
// computes the same sum): alignment slack, the ring (where K is split, at
// least the split's partial tile, which reuses the ring once the block's
// one tile is multiplied), two mbarriers a stage.
__host__ __device__ constexpr int ring_bytes(int bn, int stages,
                                             int splits) {
  return splits > 1 && bn * kPartStride * 4 > stages * stage_bytes(bn)
             ? bn * kPartStride * 4
             : stages * stage_bytes(bn);
}
__host__ __device__ constexpr int smem_bytes(int bn, int stages,
                                             int splits) {
  return kAlign + ring_bytes(bn, stages, splits) + 16 * stages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A
// wait past kWaitLimitNs traps (the launch fails with an error) instead of
// hanging the card: no healthy wait here takes a millisecond.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kWaitLimitNs) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of (row r, byte c) of a box TMA wrote with the 128-byte
// swizzle (rows of 128 bytes) or the 64-byte swizzle (rows of 64 bytes)
// into a 1 KB aligned stage: 16-byte chunk c / 16 XOR (r mod 8), or
// (r / 2 mod 4).
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Two int8 -> two bf16, exactly: the bytes at positions 0 and 2 of h become
// the low and high halves (int8_matmul.cu's i8x2_to_bf16x2: 128 + (v & 127)
// plus -128 or -256, one packed fma).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t h) {
  const uint32_t a = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (h & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// x's box as wgmma's B operand: K-major, 128-byte swizzle, 8-row groups
// 1 KB apart (SBO), start 1 KB aligned; +2 in the descriptor moves it 32
// bytes, one 16-deep step along K.
__device__ __forceinline__ uint64_t x_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a register's value at this point for the compiler: the wgmma that
// reads it asynchronously is complete only after the wait before it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Every thread of the cluster; release/acquire orders the shared-memory
// writes before it with the peers' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// d[64 x N] += A[64 x 16] (registers, bf16) x B[16 x N] (shared, bf16), f32.
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}


template <int kBN>
__device__ __forceinline__ void wgmma(float* d, const uint32_t (&a)[4],
                                      uint64_t b) {
  if constexpr (kBN == 32) {
    wgmma_n32(d, a, b);
  } else if constexpr (kBN == 64) {
    wgmma_n64(d, a, b);
  } else if constexpr (kBN == 128) {
    wgmma_n128(d, a, b);
  } else {
    wgmma_n256(d, a, b);
  }
}

// One layout's kernel body. Accumulator i of a consumer lane: n8 block
// j = i / 4 of the tile's x rows, x row 8 j + 2t + (i & 1), A row
// g + 8 ((i >> 1) & 1) of the lane's warp (wgmma's D layout).
template <int kBN, int kLayout>
__device__ __forceinline__ void wgmma_body(
    const CUtensorMap& wmap, const CUtensorMap& xmap,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ bias,
    void* __restrict__ yv, int M, int N, int K, int E, int k_stages,
    int stages, int splits) {
  constexpr int kStage = stage_bytes(kBN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((kAlign - (smem_addr(smem_raw) % kAlign)) % kAlign);
  uint8_t* ring = smem;
  float* part = reinterpret_cast<float*>(ring);  // splits > 1, after K
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + ring_bytes(kBN, stages, splits));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int col_tiles = (N + kCols - 1) / kCols;
  const int row_tiles = (M + kBN - 1) / kBN;
  const int tiles = E * col_tiles * row_tiles;
  const int rank = (int)blockIdx.x % splits;  // the cluster spans grid x
  const int cluster = (int)blockIdx.x / splits;
  const int clusters = (int)gridDim.x / splits;
  const int ks0 = rank * k_stages;
  const int nks = min(k_stages, (K + kBK - 1) / kBK - ks0);  // > 0

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  launch_dependents();
  __syncthreads();  // the barriers are initialised

  if (tid >= 256) {
    // The producer: one thread keeps the ring full, tile after tile.
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int ti = cluster; ti < tiles; ti += clusters) {
        const int e = ti / (col_tiles * row_tiles);
        const int r = ti - e * col_tiles * row_tiles;
        const int n0 = (r / row_tiles) * kCols, m0 = (r % row_tiles) * kBN;
        for (int kk = 0; kk < nks; ++kk) {
          const int k0 = (ks0 + kk) * kBK;
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* dst = ring + st * kStage;
          mbar_expect_tx(&full[st], kStage);
          if constexpr (kLayout == kRows) {
            tma_load_2d(dst, &wmap, k0, n0, &full[st]);
          } else {
            tma_load_3d(dst, &wmap, n0, k0, e, &full[st]);
          }
          tma_load_3d(dst + kWBox, &xmap, k0, m0, e, &full[st]);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // The consumers.
  setmaxnreg_inc<232>();
  const int wg = tid >> 7;         // tile columns (table rows) 64 wg ..
  const int w = (tid >> 5) & 3;    // A rows 16 w .. of the warpgroup
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int c = 64 * wg + 16 * w + 2 * g;  // dense: A rows g, g + 8
  const int R = 64 * wg + 16 * w + g;      // transposed: A rows g, g + 8
  float acc[kBN / 2];
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[0][i] = a[1][i] = 0u;
  int st = 0;
  uint32_t ph = 0;
  for (int ti = cluster; ti < tiles; ti += clusters) {
    const int e = ti / (col_tiles * row_tiles);
    const int r = ti - e * col_tiles * row_tiles;
    const int n0 = (r / row_tiles) * kCols, m0 = (r % row_tiles) * kBN;
    // This lane's scales and bias, read now and used after the K loop.
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if constexpr (kLayout == kRows) {
      if (n0 + R < N) s0 = s[n0 + R];
      if (n0 + R + 8 < N) s1 = s[n0 + R + 8];
    } else if (n0 + c < N) {  // N is even: then c + 1 < N too
      const long long off = (long long)e * N + n0 + c;
      s0 = s[off];
      s1 = s[off + 1];
      if (bias != nullptr) {
        b0 = __bfloat162float(bias[off]);
        b1 = __bfloat162float(bias[off + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      acc[i] = 0.f;
      fence_reg(acc[i]);
    }
    int prev = -1;  // the stage the last issued wgmmas read
    for (int kk = 0; kk < nks; ++kk) {
      mbar_wait(&full[st], ph);
      const uint8_t* wt = ring + st * kStage;
      const uint64_t desc = x_desc(wt + kWBox);
      // The stage's weight bytes for this lane's four 16-deep steps.
      uint32_t raw[4][4];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        if constexpr (kLayout == kRows) {
          const int k = 16 * s4 + 2 * t;
          raw[s4][0] = ld_u16(wt + swz64(R, k));
          raw[s4][1] = ld_u16(wt + swz64(R + 8, k));
          raw[s4][2] = ld_u16(wt + swz64(R, k + 8));
          raw[s4][3] = ld_u16(wt + swz64(R + 8, k + 8));
        } else {
          const int k = 16 * s4 + 2 * t;
          raw[s4][0] = ld_u16(wt + swz128(k, c));
          raw[s4][1] = ld_u16(wt + swz128(k + 1, c));
          raw[s4][2] = ld_u16(wt + swz128(k + 8, c));
          raw[s4][3] = ld_u16(wt + swz128(k + 9, c));
        }
      }
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        uint32_t(&A)[4] = a[s4 & 1];
        if constexpr (kLayout == kRows) {
          // rows R (A row g) and R + 8 (g + 8), k 2t .. and 2t + 8 ..
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            A[i] = i8x2_to_bf16x2(__byte_perm(raw[s4][i], 0u, 0x0100u));
          }
        } else {
          // K rows 2t and 2t + 1 (then 2t + 8, 2t + 9) byte by byte:
          // column c's bytes for A row g, column c + 1's for g + 8.
          A[0] = i8x2_to_bf16x2(__byte_perm(raw[s4][0], raw[s4][1], 0x0400u));
          A[1] = i8x2_to_bf16x2(__byte_perm(raw[s4][0], raw[s4][1], 0x0501u));
          A[2] = i8x2_to_bf16x2(__byte_perm(raw[s4][2], raw[s4][3], 0x0400u));
          A[3] = i8x2_to_bf16x2(__byte_perm(raw[s4][2], raw[s4][3], 0x0501u));
        }
        wgmma_fence();
        wgmma<kBN>(acc, A, desc + 2 * s4);
        wgmma_commit();
        wgmma_wait<1>();  // the step before this one is complete
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_reg(a[(s4 + 1) & 1][i]);
        if (s4 == 0 && prev >= 0 && (tid & 127) == 0) {
          mbar_arrive(&empty[prev]);  // its last reader is done
        }
      }
      prev = st;
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_reg(acc[i]);
    if (prev >= 0 && (tid & 127) == 0) mbar_arrive(&empty[prev]);

    if constexpr (kLayout == kRows) {
      // Logits: y[m][n0 + R (+ 8)], float32, times the row's scale.
      float* y = static_cast<float*>(yv);
      const int v = n0 + R;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * t + h;
          if (m < M) {
            float* out = y + (long long)m * N + v;
            if (v < N) out[0] = acc[4 * j + h] * s0;
            if (v + 8 < N) out[8] = acc[4 * j + 2 + h] * s1;
          }
        }
      }
    } else if (splits == 1) {
      // y[m][n0 + c, c + 1] as one bf16 pair: a lane quad's stores of a
      // row fill 32 contiguous bytes.
      __nv_bfloat16* y =
          static_cast<__nv_bfloat16*>(yv) + (long long)e * M * N;
      const int n = n0 + c;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * j + 2 * t + h;
            if (m < M) {
              *reinterpret_cast<__nv_bfloat162*>(y + (long long)m * N + n) =
                  __floats2bfloat162_rn(acc[4 * j + h] * s0 + b0,
                                        acc[4 * j + 2 + h] * s1 + b1);
            }
          }
        }
      }
    } else {
      // This split's partial tile at [x row][column], over the ring: the
      // block's one tile is multiplied, the producer has nothing more to
      // load, and both consumer warpgroups are past their last wgmma once
      // they meet at this named barrier. Then rank r sums elements
      // r * 256 + tid, stepping by splits * 256, over the ranks' tiles in
      // rank order, the remote reads of kGroup elements in flight at once.
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(
              part + (8 * j + 2 * t + h) * kPartStride + c) =
              make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
        }
      }
      cluster_sync();  // every partial tile is written
      __nv_bfloat16* y =
          static_cast<__nv_bfloat16*>(yv) + (long long)e * M * N;
      cg::cluster_group cl = cg::this_cluster();
      constexpr int kGroup = 4;
      const int step = splits * 256;
      for (int o0 = rank * 256 + tid; o0 < kBN * kCols;
           o0 += kGroup * step) {
        float vals[kGroup][kMaxCluster];
#pragma unroll
        for (int gi = 0; gi < kGroup; ++gi) {
          const int o = min(o0 + gi * step, kBN * kCols - 1);
          float* mine = part + (o / kCols) * kPartStride + o % kCols;
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k) {
            if (k < splits) vals[gi][k] = *cl.map_shared_rank(mine, k);
          }
        }
#pragma unroll
        for (int gi = 0; gi < kGroup; ++gi) {
          const int o = o0 + gi * step;
          const int m = m0 + o / kCols, n = n0 + o % kCols;
          if (o >= kBN * kCols || m >= M || n >= N) continue;
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k) {
            if (k < splits) v += vals[gi][k];
          }
          const long long off = (long long)e * N + n;
          const float bb =
              bias != nullptr ? __bfloat162float(bias[off]) : 0.f;
          y[(long long)m * N + n] = __float2bfloat16(v * s[off] + bb);
        }
      }
      cluster_sync();  // every tile stays alive until its peers read it
    }
  }
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_dense_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const float* __restrict__ s,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, int M, int N, int K,
                        int k_stages, int stages, int splits) {
  wgmma_body<kBN, kDense>(wmap, xmap, s, bias, y, M, N, K, 1, k_stages,
                          stages, splits);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_rows_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ s, float* __restrict__ y,
                       int M, int N, int K, int k_stages, int stages) {
  wgmma_body<kBN, kRows>(wmap, xmap, s, nullptr, y, M, N, K, 1, k_stages,
                         stages, 1);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_experts_kernel(const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap xmap,
                          const float* __restrict__ s,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ y, int M, int N, int K,
                          int E, int k_stages, int stages, int splits) {
  wgmma_body<kBN, kExperts>(wmap, xmap, s, bias, y, M, N, K, E, k_stages,
                            stages, splits);
}

// ------------------------------------------------ tensor maps, launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

std::mutex g_mu;
EncodeTiled g_encode = nullptr;  // guarded by g_mu

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_fn() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return g_encode;
}

// The weights' tensor maps by (address, K, N, E, layout): a map holds
// nothing else, so an entry is never stale. A model call walks a few
// hundred weights at most; the table keeps them.
struct MapEntry {
  const void* q;
  int K, N, E, layout;
  CUtensorMap map;
};
constexpr int kMapSlots = 1024;
MapEntry g_maps[kMapSlots];  // guarded by g_mu

// q's map, zeros outside: dense and experts [E][K][N] in boxes of 64 K rows
// x 128 bytes (128-byte swizzle); transposed [N][K] in boxes of 128 table
// rows x 64 bytes (64-byte swizzle).
bool weight_map(EncodeTiled encode, const void* q, int K, int N, int E,
                int layout, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  const int home = (int)((reinterpret_cast<uintptr_t>(q) >> 8) % kMapSlots);
  int slot = home;
  for (int i = 0; i < 8; ++i) {
    MapEntry& e = g_maps[(home + i) % kMapSlots];
    if (e.q == q && e.K == K && e.N == N && e.E == E && e.layout == layout) {
      *out = e.map;
      return true;
    }
    if (e.q == nullptr) {
      slot = (home + i) % kMapSlots;
      break;
    }
  }
  MapEntry& e = g_maps[slot];
  CUresult res;
  if (layout == kRows) {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kCols};
    const cuuint32_t elem[2] = {1, 1};
    res = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                 const_cast<void*>(q), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
    const cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)kBK, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    res = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                 const_cast<void*>(q), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (res != CUDA_SUCCESS) {
    e.q = nullptr;
    return false;
  }
  e.q = q;
  e.K = K;
  e.N = N;
  e.E = E;
  e.layout = layout;
  *out = e.map;
  return true;
}

// x's map, [E][M][K] bf16 in boxes of bn rows x 64 (128 bytes, 128-byte
// swizzle), zeros past M; cached like the weights' by everything it holds
// (x is a new activation most calls, but the allocator hands the same
// addresses back; under a CUDA graph the captured map stays right, as the
// addresses do).
struct XMapEntry {
  const void* x;
  int M, K, E, bn;
  CUtensorMap map;
};
XMapEntry g_xmaps[kMapSlots];  // guarded by g_mu

bool x_map(EncodeTiled encode, const void* x, int M, int K, int E, int bn,
           CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  const uintptr_t key = reinterpret_cast<uintptr_t>(x) ^ ((uintptr_t)M << 20);
  XMapEntry& e = g_xmaps[(key >> 8) % kMapSlots];
  if (e.x == x && e.M == M && e.K == K && e.E == E && e.bn == bn) {
    *out = e.map;
    return true;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)bn, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(x), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.x = nullptr;
    return false;
  }
  e.x = x;
  e.M = M;
  e.K = K;
  e.E = E;
  e.bn = bn;
  *out = e.map;
  return true;
}

// The plan's invariants (the wrapper's wgmma_plan keeps them).
bool valid_plan(const Int8WgmmaArgs& a) {
  if (a.M <= 0 || a.N <= 0 || a.K <= 0 || a.K % 16 != 0 || a.experts < 1 ||
      (a.layout != kDense && a.layout != kRows && a.layout != kExperts) ||
      (a.layout != kExperts && a.experts != 1) ||
      (a.layout != kRows && a.N % 16 != 0) ||
      (a.bn != 32 && a.bn != 64 && a.bn != 128 && a.bn != 256) ||
      a.splits < 1 || a.splits > kMaxCluster ||
      (a.layout == kRows && a.splits != 1) || a.stages < 1 ||
      a.k_stages < 1 || a.grid < 1 || a.grid % a.splits != 0 ||
      a.smem < smem_bytes(a.bn, a.stages, a.splits) ||
      a.smem > 227 * 1024) {
    return false;
  }
  const int kst = (a.K + kBK - 1) / kBK;
  if ((long long)a.k_stages * a.splits < kst ||
      (long long)a.k_stages * (a.splits - 1) >= kst) {
    return false;  // every split holds at least one stage
  }
  const long long tiles = (long long)a.experts * ((a.N + kCols - 1) / kCols) *
                          ((a.M + a.bn - 1) / a.bn);
  // One tile a cluster where K is split (the partial tile's two cluster
  // barriers); at most one block a tile otherwise.
  return a.splits == 1 ? a.grid <= tiles
                       : (long long)a.grid == tiles * a.splits;
}

// Raise a kernel's dynamic shared-memory ceiling once per size.
template <typename F>
cudaError_t allow_smem(F kernel, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

template <int kBN, int kLayout>
int launch(const Int8WgmmaArgs& a, const CUtensorMap& wmap,
           const CUtensorMap& xmap, const void* s, const void* bias, void* y,
           cudaStream_t stream) {
  static int configured = 48 * 1024;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const float* sp = static_cast<const float*>(s);
  const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(bias);
  cudaError_t err;
  if constexpr (kLayout == kRows) {
    auto kernel = int8_wgmma_rows_kernel<kBN>;
    err = allow_smem(kernel, a.smem, configured);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, sp,
                             static_cast<float*>(y), a.M, a.N, a.K,
                             a.k_stages, a.stages);
  } else if constexpr (kLayout == kExperts) {
    auto kernel = int8_wgmma_experts_kernel<kBN>;
    err = allow_smem(kernel, a.smem, configured);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, sp, bp,
                             static_cast<__nv_bfloat16*>(y), a.M, a.N, a.K,
                             a.experts, a.k_stages, a.stages, a.splits);
  } else {
    auto kernel = int8_wgmma_dense_kernel<kBN>;
    err = allow_smem(kernel, a.smem, configured);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, sp, bp,
                             static_cast<__nv_bfloat16*>(y), a.M, a.N, a.K,
                             a.k_stages, a.stages, a.splits);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int kLayout>
int launch_layout(const Int8WgmmaArgs& a, const CUtensorMap& wmap,
                  const CUtensorMap& xmap, const void* s, const void* bias,
                  void* y, cudaStream_t stream) {
  switch (a.bn) {
    case 32:
      return launch<32, kLayout>(a, wmap, xmap, s, bias, y, stream);
    case 64:
      return launch<64, kLayout>(a, wmap, xmap, s, bias, y, stream);
    case 128:
      return launch<128, kLayout>(a, wmap, xmap, s, bias, y, stream);
    default:
      return launch<256, kLayout>(a, wmap, xmap, s, bias, y, stream);
  }
}

}  // namespace

// `args`: the layout and the launch plan (see Int8WgmmaArgs). Returns the
// CUDA error of the launch (0 = launched). The caller validates shapes,
// contiguity and 16-byte alignment, and allocates `y`.
extern "C" int int8_matmul_wgmma_launch(const Int8WgmmaArgs* args,
                                        const void* x, const void* q,
                                        const void* s, const void* bias,
                                        void* y, void* stream) {
  const Int8WgmmaArgs& a = *args;
  if (!valid_plan(a) || (a.layout == kRows && bias != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiled encode = encode_fn();
  CUtensorMap wmap, xmap;
  if (encode == nullptr ||
      !weight_map(encode, q, a.K, a.N, a.experts, a.layout, &wmap) ||
      !x_map(encode, x, a.M, a.K, a.experts, a.bn, &xmap)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.layout == kRows) {
    return launch_layout<kRows>(a, wmap, xmap, s, bias, y, st);
  }
  if (a.layout == kExperts) {
    return launch_layout<kExperts>(a, wmap, xmap, s, bias, y, st);
  }
  return launch_layout<kDense>(a, wmap, xmap, s, bias, y, st);
}

// How many clusters of `splits` blocks (one a SM, `smem` bytes each) the
// card holds at once, or minus the CUDA error: the wave the plan's K
// splits are priced in (ops/quant_matmul.py::WGMMA_CLUSTER_SLOTS holds the
// H100's, read through this by ops/sweep_int8.py --plans).
extern "C" int int8_matmul_wgmma_cluster_slots(int splits, int smem) {
  auto kernel = int8_wgmma_dense_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 132);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}
