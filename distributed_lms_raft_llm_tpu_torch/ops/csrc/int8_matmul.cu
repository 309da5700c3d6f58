// Weight-only int8 matrix product for Hopper, sm_90a, plain C interface.
//
// No Pallas kernel stands behind this one. The JAX package's
// models/common.py::dense and models/quant.py::unembed compute
//   y = (x @ q.astype(x.dtype)) * s (+ b)
// and XLA fuses the int8 -> float convert into the product's operand load,
// so device memory sees int8 weights. Eager PyTorch would write and re-read
// a converted copy of the weight on every call instead. This kernel reads
// the int8 weight once, converts it in registers, sums in float32 and
// scales once per output.
//
// Layouts (row-major, contiguous):
//   x    [M, K]  T = float or bf16
//   q    dense:      [K, N] int8 (in, out), s [N] f32 per output column,
//                    b [N] T or null; y [M, N] T
//        transposed: [N, K] int8 (the tied embedding table [V, D]), s [N]
//                    f32 per row; y [M, N] float32 (logits)
//   K a multiple of 16; N a multiple of 16 in the dense layout.
//
// What bounds it. At decode M = 16 slots every weight byte is read once
// for M multiply-adds: the int8 bytes over 3.35 TB/s bound it (the
// 768 x 3072 MLP weight, 2.36 MB: 0.70 us), though 16 float32 FMAs a byte
// on the CUDA cores come within 2x of that rate. At prefill (M up to the
// prompt bucket) a weight tile is re-read from L2 once per 16 rows of x.
//
// Design. The product is a matrix-vector product 16 rows at a time, so
// it is built for bytes in flight, not for tensor cores (a float32 x would
// need TF32, which loses the float32 product):
//  - x is staged in shared memory 256 K-values x 16 rows at a time, as
//    float, k-major, so a thread reads one k's 16 rows as 4 float4;
//  - dense layout: a block owns 32 output columns; each thread loads 4
//    int8 of a weight row (8 threads cover the 32 columns, 32 bytes in a
//    row), 8 rows in flight at once, and sums 16 x 4 outputs in
//    registers; the 32 row groups of the block are summed by shuffles and
//    through shared memory. Few columns and long K (768 wide outputs)
//    would leave most SMs idle, so K is split across a thread-block
//    cluster of up to 8 blocks (grid z) until ~132 blocks run, and rank 0
//    adds its peers' partial tiles through distributed shared memory, in
//    the same launch;
//  - transposed layout (a row per output): a thread owns one table row
//    and all 16 rows of x, loading 64 contiguous int8 of its row at a time
//    (4 x 16 bytes) and reading each k's 16 x values as a broadcast; no
//    reduction across threads. The table's 50257 rows give enough blocks
//    without a split. At M = 16 this layout is bound by the CUDA cores'
//    float32 FMA rate (16 FMAs a weight byte), about 1.6x the bytes' time.
// No atomics, no global scratch: the result does not depend on the
// schedule, and the launch is capturable in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 16;        // rows of x per block
constexpr int kKC = 256;       // K values of x staged per chunk
constexpr int kBN = 32;        // dense: output columns per block
constexpr int kMaxCluster = 8;  // K splits per cluster (portable maximum)
constexpr int kTargetBlocks = 132;  // one wave of blocks on an H100

// Eight consecutive x elements as float (one 16-byte vector of bf16, two
// of float).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
  __shared__ __align__(16) float red[kWarps][kMT][kBN];   // 16 KB
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tc = tid % 8;  // columns n0 + 4 tc .. +3
  const int tr = tid / 8;  // weight rows k0 + tr + 32 i
  const int n0 = blockIdx.x * kBN;
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
  float sums[kMT * kBN / kThreads];
#pragma unroll
  for (int i = 0; i < kMT * kBN / kThreads; ++i) {
    const int o = tid + i * kThreads;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += red[w8][o / kBN][o % kBN];
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
        for (int i = 0; i < kMT * kBN / kThreads; ++i) {
          sums[i] += peer[tid + i * kThreads];
        }
      }
    }
    cluster.sync();
    if (cluster.block_rank() != 0) return;
  }
#pragma unroll
  for (int i = 0; i < kMT * kBN / kThreads; ++i) {
    const int o = tid + i * kThreads;
    const int m = m0 + o / kBN, nn = n0 + o % kBN;
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

template <typename T>
int launch(const void* x, const void* q, const void* s, const void* bias,
           void* y, int M, int N, int K, int transposed,
           cudaStream_t stream) {
  const int gy = (M + kMT - 1) / kMT;
  if (transposed) {
    const dim3 grid((N + kThreads - 1) / kThreads, gy);
    int8_matmul_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(y), M, N, K);
    return (int)cudaGetLastError();
  }
  // Split K across a cluster until about one wave of blocks runs, keeping
  // at least 64 weight rows a split.
  const int gx = (N + kBN - 1) / kBN;
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
      &cfg, int8_matmul_dense_kernel<T>, static_cast<const T*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(bias), static_cast<T*>(y), M, N, K, k_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). `dtype` is x's (and
// the dense output's and bias's) type: 0 float32, 1 bfloat16. The caller
// validates shapes, contiguity and 16-byte alignment, and allocates `y`.
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* s,
                                  const void* bias, void* y, int M, int N,
                                  int K, int transposed, int dtype,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (!transposed && N % 16 != 0) || (transposed && bias != nullptr) ||
      (M + kMT - 1) / kMT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, q, s, bias, y, M, N, K, transposed, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, q, s, bias, y, M, N, K, transposed, st);
  }
  return (int)cudaErrorInvalidValue;
}
