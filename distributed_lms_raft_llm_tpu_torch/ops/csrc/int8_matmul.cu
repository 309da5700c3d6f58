// Weight-only int8 matrix product for Hopper, sm_90a, plain C interface.
//
// No Pallas kernel stands behind this one. The JAX package's
// models/common.py::dense and models/quant.py::unembed compute
//   y = (x @ q.astype(x.dtype)) * s (+ b)
// and XLA fuses the int8 -> float convert into the product's operand load,
// so device memory sees int8 weights. Eager PyTorch would write and re-read
// a converted copy of the weight on every call instead. These kernels read
// the int8 weight once, convert it in registers, sum in float32 and scale
// once per output.
//
// Layouts (row-major, contiguous):
//   x    [M, K]  T = float or bf16
//   q    dense:      [K, N] int8 (in, out), s [N] f32 per output column,
//                    b [N] T or null; y [M, N] T
//        transposed: [N, K] int8 (the tied embedding table [V, D]), s [N]
//                    f32 per row; y [M, N] float32 (logits)
//   K a multiple of 16 (of 64 for a bf16 x in the transposed layout); N a
//   multiple of 16 in the dense layout.
//
// Two routes, chosen by x's dtype in the wrapper (ops/quant_matmul.py) and
// nowhere else: there is no fallback from one to the other.
//
// bf16 x: tensor cores (int8_mma_dense_kernel, int8_mma_rows_kernel).
//   What bounds it. At decode (M = 16 slots) every weight byte is read once
//   for 16 multiply-adds: the int8 bytes over 3.35 TB/s bound it (the
//   768 x 3072 MLP weight, 2.36 MB: 0.70 us; the 50257 x 768 table, 38.6
//   MB: 11.5 us). The CUDA-core kernels below reach 1.5-7% of that: float32
//   FMAs (16 a weight byte, which alone need ~1.6x the bytes' time in the
//   unembedding), chunk phases that never overlapped, 4-byte weight loads,
//   and a 16 x 32 output tile with a heavy reduction. At prefill (M up to
//   256) each weight byte feeds up to 256 multiply-adds, which only the
//   tensor cores do at the bytes' pace.
//   Design:
//   - Products on the tensor cores: mma.sync m16n8k16 bf16 x bf16 with
//     float32 accumulators; M = 16 is exactly one A tile. An int8 weight
//     converts to bf16 exactly (|q| <= 128 fits bf16's 8 significant bits),
//     and a bf16 x bf16 product is exact in float32, so the products and
//     sums are those of x @ q.astype(bf16) up to the order of the sums.
//   - Conversion in registers, two weights at a time (i8x2_to_bf16x2):
//     prmt places two bytes in the low bytes of two 16-bit halves; then
//       a = (h & 0x007F) | 0x4300  per half: bf16 128 + (v & 127), exact
//       b = (h & 0x0080) | 0xC300  per half: bf16 -128, or -256 when v < 0
//     and one packed fma a * 1 + b gives v exactly (two's complement:
//     v = (v & 127) - 128 * sign).
//   - Fragment permutations instead of byte gathers. The mma's n index
//     (dense) or k index (transposed) is a label, so it is permuted
//     consistently between the operand loads and the epilogue:
//       dense: lane (g, t) reads one 32-bit word, four neighbouring columns
//         32 w + 4 g .. +3, of weight rows k + 2t, k + 2t + 1, k + 2t + 8,
//         k + 2t + 9; prmt pairs row k + 2t with k + 2t + 1 byte by byte,
//         so four words feed four mmas, mma j's column g being the block's
//         column 32 w + 4 g + j (accumulator c's column 2t + (c & 1) is
//         then 32 w + 4 (2t + (c & 1)) + j);
//       transposed: a table row is K-contiguous, the natural "col" B
//         operand; lane t reads 16 bytes, k = 16t .. 16t + 15 of a 64-deep
//         chunk: step s (0..3) of the chunk takes k = 16t + 4s .. +3 as its
//         logical k 2t, 2t + 1, 2t + 8, 2t + 9, and x's A fragment is read
//         with the same map (16-byte loads of rows g and g + 8); the n
//         index g stands for table row sigma(g) = g / 2 + 4 (g % 2) of the
//         warp's 8, which keeps a quarter warp's reads off each other's
//         banks under the swizzle.
//     ops/quant_matmul.py spells these maps in Python; the CPU tests run a
//     model of the fragments through them (tests/test_torch_quant.py).
//   - Bytes in flight. Dense: a 2-D TMA tensor map over q stages boxes of
//     128 rows x 128 bytes (16 KB, 128-byte swizzle) into a ring in dynamic
//     shared memory, every box of a block requested at its start where the
//     ring holds them (it does at decode); the swizzle makes the lanes'
//     32-bit reads of rows 2t (+1, +8, +9) fall on 32 distinct banks.
//     Transposed: a 2-D tensor map over the table stages a tile of 64 rows
//     as K / 128 boxes of 64 rows x 128 bytes (128-byte swizzle), a ring of
//     up to 4 tiles. An SM stages only about 10-15 GB/s this way, and
//     fewer, larger copies do better than many small ones (PERF.md),
//     hence the large boxes and the K splits that put every SM to work. x
//     is staged once per block by one bulk copy (cp.async.bulk) a row,
//     rows padded for conflict-free ldmatrix / 16-byte reads. Completion is
//     counted on mbarriers.
//   - Grid and reduction. Dense: a block owns 128 columns and 16 or 64 rows
//     (MT = 1 or 4 m16 tiles, so a staged weight tile serves every row tile
//     of the block); 8 warps, warp w takes columns 32 (w % 4) .. and the
//     k16 steps of parity w / 4. Where the column tiles leave SMs idle, K is
//     split across a thread-block cluster of up to 8 blocks; each block's
//     partial tile stays in its shared memory and rank r sums slice r of
//     the tile over the ranks in rank order (distributed shared memory,
//     two cluster barriers). Transposed: one wave of blocks walks the
//     vocabulary tiles (64 rows) with a stride of the grid; warp w owns rows
//     8 w .. 8 w + 7 of a tile, so no reduction is needed.
//   - Epilogue: the float32 sums times s (+ b), rounded once to bf16
//     (dense, coalesced stores from the reduced tile) or stored float32
//     (logits, a lane quad writes two runs of 16 contiguous bytes a row).
//   No atomics, no global scratch: the result does not depend on the
//   schedule (greedy answers stay byte-identical run to run), and every
//   launch is capturable in a CUDA graph.
//
// float32 x: CUDA cores (int8_matmul_dense_kernel, int8_matmul_rows_kernel,
//   the first design). Tensor cores would need TF32 and lose the float32
//   product, which the float32 checks hold token for token. x is staged 256
//   K-values x 16 rows at a time as float; dense: a block owns 32 output
//   columns, each thread 4 int8 of 8 weight rows at a time, the block's row
//   groups summed by shuffles and through shared memory, K split across a
//   cluster of up to 8 blocks with a DSMEM sum on rank 0; transposed: one
//   table row a thread, x read as a broadcast.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

// The per-layout arguments, prepared once by the wrapper (ctypes structure
// `_Args` in ops/quant_matmul.py, plan from `launch_plan`) and passed by
// address. Outside the anonymous namespace, so the C entry point that takes
// it keeps external linkage.
struct Int8MatmulArgs {
  int M, N, K;
  int transposed;  // 0 dense [K, N], 1 transposed [N, K]
  int dtype;       // x (and a dense y, b): 0 float32, 1 bfloat16
  // bf16 route only (the float32 route picks its own split):
  int mt;          // m16 row tiles a block: 1 or 4
  int splits;      // dense: K splits, the blocks of one cluster
  int k_split;     // dense: rows of K a split, a multiple of kBK
  int stages;      // ring depth, in tiles
  int grid_x;      // dense: column tiles; transposed: blocks a row tile
  int smem;        // dynamic shared memory, bytes
};

namespace {

// ------------------------------------------------ float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 16;        // rows of x per block
constexpr int kKC = 256;       // K values of x staged per chunk
constexpr int kBNf = 32;       // dense: output columns per block
constexpr int kMaxCluster = 8;  // K splits per cluster (portable maximum)
constexpr int kTargetBlocks = 132;  // one wave of blocks on an H100

// Eight consecutive x elements as float (two 16-byte vectors).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// N int8 packed in one (N = 4) or four (N = 16) words, as float.
template <int N, typename W>
__device__ __forceinline__ void widen(const W& w, float* out) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = static_cast<float>(b[i]);
}

// Stage x[m0 .. m0+16)[k0 .. k0+256) (k < kend, zeros elsewhere) into
// xs[k - k0][m] as float. Thread t takes row t % 16 and 16 consecutive k
// at (t / 16) * 16: the 16 threads of a half-warp store 16 neighbours.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x,
                                        float (*xs)[kMT], int M, int K,
                                        int m0, int k0, int kend) {
  const int row = threadIdx.x % kMT;
  const int seg = threadIdx.x / kMT;  // 0..15
  const int k = k0 + seg * 16;
  float v[16];
  if (m0 + row < M && k < kend) {
    const T* p = x + (long long)(m0 + row) * K + k;
    load8(p, v);
    load8(p + 8, v + 8);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) xs[seg * 16 + e][row] = v[e];
}

// acc[m][j] += x[k][m] * w[j] for the 16 rows m of one staged k.
template <int N>
__device__ __forceinline__ void fma_rows(const float* xk, const float* w,
                                         float (*acc)[N]) {
  const float4* xr = reinterpret_cast<const float4*>(xk);
#pragma unroll
  for (int c = 0; c < kMT / 4; ++c) {
    const float4 xv = xr[c];
    const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) acc[4 * c + i][j] += xm[i] * w[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_dense_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ s,
                         const T* __restrict__ bias, T* __restrict__ y, int M,
                         int N, int K, int k_split) {
  __shared__ __align__(16) float xs[kKC][kMT];            // 16 KB
  __shared__ __align__(16) float red[kWarps][kMT][kBNf];  // 16 KB
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tc = tid % 8;  // columns n0 + 4 tc .. +3
  const int tr = tid / 8;  // weight rows k0 + tr + 32 i
  const int n0 = blockIdx.x * kBNf;
  const int m0 = blockIdx.y * kMT;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int n = n0 + 4 * tc;
  const bool col_ok = n < N;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  }
  for (int k0 = kbeg; k0 < kend; k0 += kKC) {
    stage_x(x, xs, M, K, m0, k0, kend);
    // This thread's 8 weight rows of the chunk, all in flight at once.
    uint32_t w[kKC / 32];
#pragma unroll
    for (int i = 0; i < kKC / 32; ++i) {
      const int k = k0 + tr + 32 * i;
      w[i] = col_ok && k < kend
                 ? *reinterpret_cast<const uint32_t*>(q + (long long)k * N + n)
                 : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kKC / 32; ++i) {
      float wf[4];
      widen<4>(w[i], wf);
      fma_rows<4>(xs[tr + 32 * i], wf, acc);
    }
    __syncthreads();
  }

  // Sum the block's 32 row groups: the 4 of a warp by shuffles (lanes
  // that share tc), the 8 warps through shared memory.
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][m][4 * tc + j] = v;
    }
  }
  __syncthreads();
  float* part = &xs[0][0];  // this block's [16][32] tile, for the cluster
  float sums[kMT * kBNf / kThreads];
#pragma unroll
  for (int i = 0; i < kMT * kBNf / kThreads; ++i) {
    const int o = tid + i * kThreads;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += red[w8][o / kBNf][o % kBNf];
    sums[i] = v;
    part[o] = v;
  }
  const int n_split = gridDim.z;
  if (n_split > 1) {
    // Rank 0 adds its peers' tiles once every tile is written; the second
    // barrier keeps every peer's shared memory alive until it has.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int r = 1; r < n_split; ++r) {
        const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < kMT * kBNf / kThreads; ++i) {
          sums[i] += peer[tid + i * kThreads];
        }
      }
    }
    cluster.sync();
    if (cluster.block_rank() != 0) return;
  }
#pragma unroll
  for (int i = 0; i < kMT * kBNf / kThreads; ++i) {
    const int o = tid + i * kThreads;
    const int m = m0 + o / kBNf, nn = n0 + o % kBNf;
    if (m < M && nn < N) {
      const float bb = bias != nullptr ? to_float(bias[nn]) : 0.f;
      store(y + (long long)m * N + nn, sums[i] * s[nn] + bb);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_rows_kernel(const T* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ y,
                        int M, int N, int K) {
  __shared__ __align__(16) float xs[kKC][kMT];  // 16 KB
  const int n = blockIdx.x * kThreads + threadIdx.x;  // this thread's row
  const int m0 = blockIdx.y * kMT;
  const bool row_ok = n < N;
  const int8_t* qrow = q + (long long)(row_ok ? n : 0) * K;
  float acc[kMT][1];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m][0] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    stage_x(x, xs, M, K, m0, k0, K);
    __syncthreads();
    const int kc = min(kKC, K - k0);
    for (int kk = 0; kk < kc; kk += 64) {
      // 64 contiguous bytes of the row in flight (two whole sectors).
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + kk + 16 * i;
        w[i] = row_ok && k < K
                   ? *reinterpret_cast<const uint4*>(qrow + k)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float wf[16];
        widen<16>(w[i], wf);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          fma_rows<1>(xs[kk + 16 * i + e], wf + e, acc);
        }
      }
    }
    __syncthreads();
  }
  if (!row_ok) return;
  const float sc = s[n];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m0 + m < M) y[(long long)(m0 + m) * N + n] = acc[m][0] * sc;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        count <= 0) {
      count = kTargetBlocks;
    }
  }
  return count;
}

int launch_fma(const void* x, const void* q, const void* s, const void* bias,
               void* y, int M, int N, int K, int transposed,
               cudaStream_t stream) {
  const int gy = (M + kMT - 1) / kMT;
  if (transposed) {
    const dim3 grid((N + kThreads - 1) / kThreads, gy);
    int8_matmul_rows_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(y), M, N, K);
    return (int)cudaGetLastError();
  }
  // Split K across a cluster until about one wave of blocks runs, keeping
  // at least 64 weight rows a split.
  const int gx = (N + kBNf - 1) / kBNf;
  int splits = 1;
  while (splits < kMaxCluster && gx * gy * splits < sm_count() &&
         K / (2 * splits) >= 64) {
    splits *= 2;
  }
  const int k_split = ((K + splits - 1) / splits + 31) / 32 * 32;
  splits = (K + k_split - 1) / k_split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_matmul_dense_kernel<float>, static_cast<const float*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K,
      k_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// --------------------------------------------------- bf16: tensor cores

constexpr int kTcThreads = 256;   // 8 warps
constexpr int kBN = 128;          // dense: columns a block, a box's bytes
constexpr int kBK = 128;          // dense: weight rows a box (a stage)
constexpr int kStageDense = kBK * kBN;   // 16 KB, 1024-byte aligned stages
constexpr int kPartStride = kBN + 4;     // floats: the epilogue tile's rows
constexpr int kBV = 64;           // transposed: table rows a tile (stage)
constexpr int kTableBox = kBV * kBN;     // a 64 x 128-byte box, 8 KB
constexpr int kAlign = 1024;      // the 128-byte swizzle repeats every 1 KB

// Staged x rows, in bf16 elements, padded by 16 bytes: dense, 8 rows at a
// stride of an odd number of 16-byte units (conflict-free ldmatrix);
// transposed (K a multiple of 64), rows g and g + 1 of a quarter warp's
// 16-byte reads on disjoint banks.
__host__ __device__ constexpr int dense_x_stride(int k_split) {
  return k_split + 8;
}
__host__ __device__ constexpr int rows_x_stride(int K) { return K + 8; }

// Dynamic shared memory of a launch (ops/quant_matmul.py::_smem_bytes
// computes the same sums): alignment slack, the ring (dense: reused for the
// epilogue's partial tile), staged x, the mbarriers (x, then one a stage).
__host__ __device__ constexpr int dense_smem(int mt, int k_split,
                                             int stages) {
  return kAlign +
         (stages * kStageDense > 16 * mt * kPartStride * 4
              ? stages * kStageDense
              : 16 * mt * kPartStride * 4) +
         16 * mt * dense_x_stride(k_split) * 2 + 8 * (stages + 1);
}
__host__ __device__ constexpr int rows_smem(int mt, int K, int stages) {
  return kAlign + stages * ((K + kBN - 1) / kBN) * kTableBox +
         16 * mt * rows_x_stride(K) * 2 + 8 * (stages + 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((kAlign - (a % kAlign)) % kAlign);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One contiguous global -> shared copy; completion counted on `bar`.
// dst, src 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D tensor map (c0 the inner coordinate) into `dst`; the
// box's full size is counted on `bar`, out-of-bounds bytes read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of (row r, byte c) of a 128-byte-wide box that TMA wrote with
// the 128-byte swizzle into a 1024-byte aligned stage: the 16-byte chunk
// index is XORed with the row's index mod 8.
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// Two int8 -> two bf16, exactly: the bytes at positions 0 and 2 of h (1 and
// 3 are ignored) become the low and high halves. See the note at the top.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t h) {
  const uint32_t a = (h & 0x007F007Fu) | 0x43004300u;  // 128 + (v & 127)
  const uint32_t b = (h & 0x00800080u) | 0xC300C300u;  // -128 or -256
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// Dense layout: y[m0 .. m0 + 16 MT)[n0 .. n0 + 128) of split blockIdx.z.
template <int kMTiles>
__global__ void __launch_bounds__(kTcThreads)
int8_mma_dense_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ s,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int M, int N, int K,
                      int k_split, int stages) {
  constexpr int kBM = 16 * kMTiles;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgrp = warp & 3;  // columns 32 cgrp .. +31 of the block
  const int kh = warp >> 2;   // k16 steps of this parity within a stage
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_split = gridDim.z;
  const int kbeg = blockIdx.z * k_split;
  const int nk = min(K, kbeg + k_split) - kbeg;  // > 0, a multiple of 16
  const int n_tiles = (nk + kBK - 1) / kBK;
  const int rows = min(kBM, M - m0);
  const int ring_bytes = max(stages * kStageDense, kBM * kPartStride * 4);
  const int xs_stride = dense_x_stride(k_split);
  uint8_t* ring = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + ring_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kBM * xs_stride);
  // bars[0]: x; bars[1 + st]: ring stage st

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&qmap))
                 : "memory");
    for (int i = 0; i <= stages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], (uint32_t)(rows * nk * 2));
    for (int st = 0; st < stages && st < n_tiles; ++st) {
      mbar_expect_tx(&bars[1 + st], kStageDense);
      tma_load_2d(ring + st * kStageDense, &qmap, n0, kbeg + st * kBK,
                  &bars[1 + st]);
    }
  }
  __syncthreads();  // the barriers are initialised
  if (warp == 1) {  // this block's rows of x, one bulk copy each
    for (int r = lane; r < rows; r += 32) {
      bulk_load(xs + r * xs_stride, x + (long long)(m0 + r) * K + kbeg,
                (uint32_t)(nk * 2), &bars[0]);
    }
  }
  // Rows of xs at or past `rows` are never written: they only feed
  // accumulator rows that are never stored.
  // Every output this thread stores lies in column n0 + tid % 128 (see the
  // reduction below): its scale and bias are read now, off the tail.
  const int n_out = n0 + tid % kBN;
  const float s_out = n_out < N ? s[n_out] : 0.f;
  const float b_out =
      n_out < N && bias != nullptr ? __bfloat162float(bias[n_out]) : 0.f;

  float acc[kMTiles][4][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
    }
  }
  const int colb = 32 * cgrp + 4 * g;  // this lane's 4 bytes of a row
  mbar_wait(&bars[0], 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % stages;
    mbar_wait(&bars[1 + st], (uint32_t)((kt / stages) & 1));
    const uint8_t* tile = ring + st * kStageDense;
    const int steps = min(kBK, nk - kt * kBK) / 16;
    for (int ks = kh; ks < steps; ks += 2) {
      const int r = ks * 16 + 2 * t;
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(tile + swz128(r, colb));
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(tile + swz128(r + 1, colb));
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(tile + swz128(r + 8, colb));
      const uint32_t w3 =
          *reinterpret_cast<const uint32_t*>(tile + swz128(r + 9, colb));
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = (uint32_t)(j | ((4 + j) << 8));
        b[j][0] = i8x2_to_bf16x2(__byte_perm(w0, w1, sel));
        b[j][1] = i8x2_to_bf16x2(__byte_perm(w2, w3, sel));
      }
      const int kx = kt * kBK + ks * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + (16 * mt + (lane & 15)) * xs_stride + kx);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
    if (kt + stages < n_tiles) {  // refill this stage once all have read it
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(&bars[1 + st], kStageDense);
        tma_load_2d(ring + st * kStageDense, &qmap, n0,
                    kbeg + (kt + stages) * kBK, &bars[1 + st]);
      }
    }
  }

  // The block's partial tile, at the physical columns: the warps of k
  // parity 0 write it, those of parity 1 add theirs (a fixed order).
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (kh == pass) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = 16 * mt + g + 8 * (c >> 1);
            const int col = 32 * cgrp + 4 * (2 * t + (c & 1)) + j;
            float* p = part + row * kPartStride + col;
            *p = pass == 0 ? acc[mt][j][c] : *p + acc[mt][j][c];
          }
        }
      }
    }
    __syncthreads();
  }

  // Sum the splits' tiles: rank r takes elements r * 256 + tid, stepping
  // by n_split * 256 (so always column tid % 128), and adds the ranks'
  // partial tiles in rank order, all remote reads in flight at once.
  const int rank = (int)blockIdx.z;  // the cluster spans grid z
  if (n_split > 1) cg::this_cluster().sync();  // every partial tile written
  for (int o = rank * kTcThreads + tid; o < kBM * kBN;
       o += n_split * kTcThreads) {
    const int r = o / kBN, m = m0 + r;
    if (m >= M || n_out >= N) continue;
    float* mine = part + r * kPartStride + tid % kBN;
    float v;
    if (n_split == 1) {
      v = *mine;
    } else {
      float vals[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < n_split) vals[k] = *cg::this_cluster().map_shared_rank(mine, k);
      }
      v = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < n_split) v += vals[k];
      }
    }
    y[(long long)m * N + n_out] = __float2bfloat16(v * s_out + b_out);
  }
  if (n_split > 1) cg::this_cluster().sync();  // tiles live until read
}

// Transposed layout: y[m0 .. m0 + 16 MT)[tiles of 64 rows of the table].
template <int kMTiles>
__global__ void __launch_bounds__(kTcThreads)
int8_mma_rows_kernel(const __grid_constant__ CUtensorMap tmap,
                     const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ s, float* __restrict__ y,
                     int M, int N, int K, int stages) {
  constexpr int kBM = 16 * kMTiles;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM;
  const int rows = min(kBM, M - m0);
  const int boxes = (K + kBN - 1) / kBN;  // 128-byte columns of a tile
  const int stage_bytes = boxes * kTableBox;
  const int xs_stride = rows_x_stride(K);
  uint8_t* ring = smem;
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kBM * xs_stride);
  // bars[0]: x; bars[1 + st]: ring stage st
  const int n_vt = (N + kBV - 1) / kBV;
  // This block's tiles: blockIdx.x + i * gridDim.x (gridDim.x <= n_vt).
  const int my_tiles = (n_vt - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;

  auto stage_tile = [&](int i) {  // one thread: tile i's boxes
    const int v0 = ((int)blockIdx.x + i * (int)gridDim.x) * kBV;
    uint8_t* dst = ring + (i % stages) * stage_bytes;
    uint64_t* bar = &bars[1 + i % stages];
    mbar_expect_tx(bar, (uint32_t)stage_bytes);
    for (int b = 0; b < boxes; ++b) {
      tma_load_2d(dst + b * kTableBox, &tmap, b * kBN, v0, bar);
    }
  };

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tmap))
                 : "memory");
    for (int i = 0; i <= stages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], (uint32_t)(rows * K * 2));
    for (int i = 0; i < stages && i < my_tiles; ++i) stage_tile(i);
  }
  __syncthreads();  // the barriers are initialised
  if (warp == 1) {
    for (int r = lane; r < rows; r += 32) {
      bulk_load(xs + r * xs_stride, x + (long long)(m0 + r) * K,
                (uint32_t)(K * 2), &bars[0]);
    }
  }
  // Rows of xs at or past `rows` are never written, and table rows past N
  // read as zeros: both only feed outputs that are never stored.
  mbar_wait(&bars[0], 0);

  // The mma's column g stands for row 8 warp + sigma(g) of the tile,
  // sigma(g) = g / 2 + 4 (g % 2): lanes g and g + 1 (one quarter warp's
  // 16-byte reads) then read rows whose swizzles differ in bit 2, so their
  // eight 16-byte chunks are distinct. Accumulator c's column 2t + (c & 1)
  // is row t + 4 (c & 1).
  const int qrow = 8 * warp + ((g >> 1) | ((g & 1) << 2));
  const int sw = qrow & 7;
  for (int i = 0; i < my_tiles; ++i) {
    const int st = i % stages;
    const int v = ((int)blockIdx.x + i * (int)gridDim.x) * kBV + 8 * warp +
                  t;
    const float s0 = v < N ? s[v] : 0.f;  // read now, used after the loop
    const float s1 = v + 4 < N ? s[v + 4] : 0.f;
    mbar_wait(&bars[1 + st], (uint32_t)((i / stages) & 1));
    const uint8_t* tile = ring + st * stage_bytes + qrow * kBN;
    // One accumulator for even and one for odd k16 steps: two mma chains.
    float acc[kMTiles][2][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[mt][c / 4][c % 4] = 0.f;
    }
    for (int kc = 0; kc < K; kc += 64) {
      // 16 bytes of the row: k = kc + 16 t .. +15; word j feeds step j.
      const int chunk = ((kc & (kBN - 1)) >> 4) + t;
      const uint4 wq = *reinterpret_cast<const uint4*>(
          tile + (kc >> 7) * kTableBox + ((chunk ^ sw) << 4));
      const uint32_t words[4] = {wq.x, wq.y, wq.z, wq.w};
      uint32_t bq[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j][0] = i8x2_to_bf16x2(__byte_perm(words[j], 0u, 0x0100u));
        bq[j][1] = i8x2_to_bf16x2(__byte_perm(words[j], 0u, 0x0302u));
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const __nv_bfloat16* xr =
            xs + (16 * mt + g) * xs_stride + kc + 16 * t;
        const uint4 xa0 = *reinterpret_cast<const uint4*>(xr);
        const uint4 xa1 = *reinterpret_cast<const uint4*>(xr + 8);
        const uint4 xb0 =
            *reinterpret_cast<const uint4*>(xr + 8 * xs_stride);
        const uint4 xb1 =
            *reinterpret_cast<const uint4*>(xr + 8 * xs_stride + 8);
        const uint32_t a0[4] = {xa0.x, xb0.x, xa0.y, xb0.y};
        const uint32_t a1[4] = {xa0.z, xb0.z, xa0.w, xb0.w};
        const uint32_t a2[4] = {xa1.x, xb1.x, xa1.y, xb1.y};
        const uint32_t a3[4] = {xa1.z, xb1.z, xa1.w, xb1.w};
        mma_bf16(acc[mt][0], a0, bq[0][0], bq[0][1]);
        mma_bf16(acc[mt][1], a1, bq[1][0], bq[1][1]);
        mma_bf16(acc[mt][0], a2, bq[2][0], bq[2][1]);
        mma_bf16(acc[mt][1], a3, bq[3][0], bq[3][1]);
      }
    }
    // Logits: accumulator c of row 16 mt + g + 8 (c >> 1), table row
    // 8 warp + t + 4 (c & 1) of the tile, times the row's scale.
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * mt + g + 8 * h;
        if (m < M) {
          float* out = y + (long long)m * N + v;
          if (v < N) out[0] = (acc[mt][0][2 * h] + acc[mt][1][2 * h]) * s0;
          if (v + 4 < N) {
            out[4] = (acc[mt][0][2 * h + 1] + acc[mt][1][2 * h + 1]) * s1;
          }
        }
      }
    }
    if (i + stages < my_tiles) {  // refill this stage once all have read it
      __syncthreads();
      if (tid == 0) stage_tile(i + stages);
    }
  }
}

// ----------------------------------------- bf16 launches and tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The weights' tensor maps, by (address, K, N, layout): a map holds
// nothing else (the boxes are fixed), so an entry is never stale. A decode
// step walks 49 weights; the table keeps them all.
struct MapEntry {
  const void* q;
  int K, N, transposed;
  CUtensorMap map;
};
constexpr int kMapSlots = 512;
std::mutex g_map_mu;
MapEntry g_maps[kMapSlots];  // guarded by g_map_mu
EncodeTiled g_encode = nullptr;  // guarded by g_map_mu

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_fn() {
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

// The tensor map of q, 128-byte swizzle, zeros outside: dense [K, N] in
// boxes of kBK rows x 128 bytes, transposed [N, K] in boxes of kBV rows x
// 128 bytes. Returns false if the driver refuses it.
bool weight_map(const void* q, int K, int N, int transposed,
                CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  const uintptr_t key = reinterpret_cast<uintptr_t>(q);
  const int home = (int)((key >> 8) % kMapSlots);
  int slot = home;
  for (int i = 0; i < 8; ++i) {
    MapEntry& e = g_maps[(home + i) % kMapSlots];
    if (e.q == q && e.K == K && e.N == N && e.transposed == transposed) {
      *out = e.map;
      return true;
    }
    if (e.q == nullptr) {
      slot = (home + i) % kMapSlots;
      break;
    }
  }
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  MapEntry& e = g_maps[slot];
  const int inner = transposed ? K : N, outer = transposed ? N : K;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};  // bytes, of dim 1
  const cuuint32_t box[2] = {(cuuint32_t)kBN,
                             (cuuint32_t)(transposed ? kBV : kBK)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.q = nullptr;
    return false;
  }
  e.q = q;
  e.K = K;
  e.N = N;
  e.transposed = transposed;
  *out = e.map;
  return true;
}

// Raise a kernel's dynamic shared-memory ceiling once per size, not on
// every call.
template <typename F>
cudaError_t allow_smem(F kernel, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

template <int kMTiles>
int launch_rows(const Int8MatmulArgs& a, const CUtensorMap& map,
                const void* x, const void* s, void* y, cudaStream_t stream) {
  static int configured = 48 * 1024;
  auto kernel = int8_mma_rows_kernel<kMTiles>;
  cudaError_t err = allow_smem(kernel, a.smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.grid_x, (a.M + 16 * kMTiles - 1) / (16 * kMTiles));
  kernel<<<grid, kTcThreads, a.smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), static_cast<float*>(y), a.M, a.N, a.K,
      a.stages);
  return (int)cudaGetLastError();
}

template <int kMTiles>
int launch_dense(const Int8MatmulArgs& a, const CUtensorMap& map,
                 const void* x, const void* s, const void* bias, void* y,
                 cudaStream_t stream) {
  static int configured = 48 * 1024;
  auto kernel = int8_mma_dense_kernel<kMTiles>;
  cudaError_t err = allow_smem(kernel, a.smem, configured);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid_x, (a.M + 16 * kMTiles - 1) / (16 * kMTiles),
                     a.splits);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), a.M, a.N, a.K, a.k_split, a.stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 plan's invariants (the wrapper's launch_plan keeps them).
bool valid_mma_plan(const Int8MatmulArgs& a) {
  if ((a.mt != 1 && a.mt != 4) || a.stages < 1 || a.grid_x < 1 ||
      a.smem < 0 || a.smem > 227 * 1024) {
    return false;
  }
  if (a.transposed) {
    const int n_vt = (a.N + kBV - 1) / kBV;
    return a.K % 64 == 0 && a.grid_x <= n_vt &&
           a.smem >= rows_smem(a.mt, a.K, a.stages);
  }
  return a.splits >= 1 && a.splits <= kMaxCluster && a.k_split > 0 &&
         a.k_split % kBK == 0 && (long long)a.k_split * a.splits >= a.K &&
         (long long)a.k_split * (a.splits - 1) < a.K &&
         a.grid_x == (a.N + kBN - 1) / kBN &&
         a.smem >= dense_smem(a.mt, a.k_split, a.stages);
}

}  // namespace

// `args`: the layout and, for bf16, the launch plan (see Int8MatmulArgs).
// Returns the CUDA error of the launch (0 = launched). The caller
// validates shapes, contiguity and 16-byte alignment, and allocates `y`.
extern "C" int int8_matmul_launch(const Int8MatmulArgs* args, const void* x,
                                  const void* q, const void* s,
                                  const void* bias, void* y, void* stream) {
  const Int8MatmulArgs& a = *args;
  if (a.M <= 0 || a.N <= 0 || a.K <= 0 || a.K % 16 != 0 ||
      (!a.transposed && a.N % 16 != 0) || (a.transposed && bias != nullptr) ||
      (a.M + kMT - 1) / kMT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dtype == 0) {
    return launch_fma(x, q, s, bias, y, a.M, a.N, a.K, a.transposed, st);
  }
  if (a.dtype != 1 || !valid_mma_plan(a)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!weight_map(q, a.K, a.N, a.transposed, &map)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.transposed) {
    return a.mt == 1 ? launch_rows<1>(a, map, x, s, y, st)
                     : launch_rows<4>(a, map, x, s, y, st);
  }
  return a.mt == 1 ? launch_dense<1>(a, map, x, s, bias, y, st)
                   : launch_dense<4>(a, map, x, s, bias, y, st);
}
