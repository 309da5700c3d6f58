// Single-token (decode) attention for Hopper, sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel
// distributed_lms_raft_llm_tpu/ops/attention.py::decode_attention (body
// _decode_attn_kernel): softmax(q . K^T * Dh^-1/2 + bias) . V for one query
// token per batch row, against one layer of the stacked KV cache, with
// scores and softmax in float32 and the output in q's dtype.
//
// Layouts (all row-major):
//   q, out   [B, H, 1, Dh]                  T = float or bf16
//   k, v     [L, B, Hkv, S_alloc, Dh]       stacked cache, same T; the
//            kernel attends over the first S slots (S <= S_alloc) of layer
//            `layer`, read in place by pointer offset: no slice copy.
//   bias     [B, 1, S] float32, 0 (attend) or -1e30 (masked)
//
// Design. One block per (KV head, batch row). The block serves all
// G = H / Hkv query heads of its KV group, so each K/V element is read
// from device memory once per group (GQA without materialising repeat_kv).
//   1. scores: one thread per key; the thread reads the key's row as
//      16-byte vectors, all of them issued before the first is used, and
//      takes G dot products against q held in shared memory. The G x S
//      float32 scores stay in shared memory (S <= 1024, checked by the
//      wrapper);
//   2. softmax: block-wide max and sum reductions per query head;
//   3. weighted sum: a row of V is read by Dh/VEC neighbouring threads, one
//      16-byte vector each, so a warp reads whole rows (coalesced) and the
//      block walks kThreads/(Dh/VEC) rows at a time; partial sums are
//      reduced across rows with warp shuffles, then across warps through
//      shared memory, and scaled by 1/sum.
// The head dim is a template parameter (8 to 128, a power of two), so the
// per-row vector loops unroll completely.
//
// What bounds it. Nothing is reused: every K and V byte is read once, so
// the kernel is bound by memory bandwidth. The least time is
//   2 * B * Hkv * S * Dh * sizeof(T) / 3.35 TB/s   (H100 SXM HBM3),
// e.g. B=8, Hkv=12, S=384, Dh=64 in bf16: 9.4 MB, about 2.8 us. At GPT-2
// serving sizes that is near the launch latency. With B * Hkv blocks the
// card is not full below 132 blocks; splitting S across blocks
// (flash-decoding), TMA staging and CUDA graphs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads per KV head (H / Hkv)
constexpr float kLowest = -3.402823466e38f;

// 16-byte vector loads, widened to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reduction; every thread gets the result. scratch: kWarps floats.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float y = lane < kWarps ? scratch[lane] : (kMax ? kLowest : 0.f);
  y = kMax ? warp_max(y) : warp_sum(y);
  __syncthreads();  // scratch may be reused after this
  return y;
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int B, int H, int Hkv, int S, int S_alloc, int layer,
                        float scale) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kChunks = kDh / kN;          // vectors per row
  constexpr int kRows = kThreads / kChunks;  // V rows walked at a time
  static_assert(kDh % kN == 0 && kChunks <= 32 && 32 % kChunks == 0,
                "head dim must be a power of two from 8 to 128");

  extern __shared__ float smem[];
  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // batch row
  const int G = H / Hkv;
  float* s_scores = smem;                   // [G][S]
  float* s_q = s_scores + G * S;            // [G][kDh]
  float* s_red = s_q + G * kDh;             // [kWarps][G][kDh]
  float* s_scratch = s_red + kWarps * G * kDh;  // [kWarps]
  float* s_inv = s_scratch + kWarps;        // [G]

  const long long kv_off =
      (((long long)layer * B + b) * Hkv + g) * (long long)S_alloc * kDh;
  const T* K = k_cache + kv_off;
  const T* V = v_cache + kv_off;
  const float* bias_row = bias + (long long)b * S;
  // The G query heads of this group are h = g*G .. g*G+G-1, contiguous.
  const long long q_off = ((long long)b * H + (long long)g * G) * kDh;
  const T* Q = q + q_off;
  T* O = out + q_off;

  for (int i = threadIdx.x; i < G * kDh; i += kThreads) {
    s_q[i] = Vec<T>::to_float(Q[i]);
  }
  __syncthreads();

  // 1. Scores: one thread per key, the row read as kChunks vectors.
#pragma unroll 2
  for (int s = threadIdx.x; s < S; s += kThreads) {
    float kv[kDh];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      Vec<T>::load(K + (long long)s * kDh + c * kN, kv + c * kN);
    }
    const float bs = bias_row[s];
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < G) {
        const float* qj = s_q + j * kDh;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc += qj[d] * kv[d];
        s_scores[j * S + s] = acc * scale + bs;
      }
    }
  }
  __syncthreads();

  // 2. Softmax numerators in place, 1/sum per query head.
  for (int j = 0; j < G; ++j) {
    float* row = s_scores + j * S;
    float m = kLowest;
    for (int s = threadIdx.x; s < S; s += kThreads) m = fmaxf(m, row[s]);
    m = block_reduce<true>(m, s_scratch);
    float sum = 0.f;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const float p = expf(row[s] - m);
      row[s] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, s_scratch);
    if (threadIdx.x == 0) s_inv[j] = 1.f / sum;
  }
  __syncthreads();

  // 3. Weighted sum of V: thread (r, c) reads vector c of rows r, r+kRows..
  const int c = threadIdx.x % kChunks;
  const int r = threadIdx.x / kChunks;
  float acc[kMaxGroup][kN];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[j][e] = 0.f;
  }
#pragma unroll 4
  for (int s = r; s < S; s += kRows) {
    float vv[kN];
    Vec<T>::load(V + (long long)s * kDh + c * kN, vv);
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < G) {
        const float p = s_scores[j * S + s];
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[j][e] += p * vv[e];
      }
    }
  }
  // Rows of one warp that share vector c: lanes c, c+kChunks, ...
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) {
    if (j < G) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        float x = acc[j][e];
#pragma unroll
        for (int o = kChunks; o < 32; o <<= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
        }
        if (lane < kChunks) s_red[(warp * G + j) * kDh + c * kN + e] = x;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * kDh; i += kThreads) {
    const int j = i / kDh;
    const int d = i - j * kDh;
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += s_red[(w * G + j) * kDh + d];
    Vec<T>::store(O + i, tot * s_inv[j]);
  }
}

template <typename T, int kDh>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* bias, void* out, int B, int H, int Hkv, int S,
           int S_alloc, int layer, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * S + (size_t)G * kDh +
                                       (size_t)kWarps * G * kDh + kWarps + G);
  auto kernel = decode_attention_kernel<T, kDh>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(bias),
      static_cast<T*>(out), B, H, Hkv, S, S_alloc, layer, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k_cache, const void* v_cache,
              const void* bias, void* out, int B, int H, int Hkv, int S,
              int S_alloc, int Dh, int layer, float scale,
              cudaStream_t stream) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                          S_alloc, layer, scale, stream);
    case 16:
      return launch<T, 16>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                           S_alloc, layer, scale, stream);
    case 32:
      return launch<T, 32>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                           S_alloc, layer, scale, stream);
    case 64:
      return launch<T, 64>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                           S_alloc, layer, scale, stream);
    case 128:
      return launch<T, 128>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                            S_alloc, layer, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched). The caller validates shapes, dtypes, strides,
// 16-byte alignment and the layer index, and allocates `out`.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* bias,
                                       void* out, int B, int H, int Hkv, int S,
                                       int S_alloc, int Dh, int layer,
                                       int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || S <= 0 ||
      S > S_alloc) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch_dh<float>(q, k_cache, v_cache, bias, out, B, H, Hkv, S,
                            S_alloc, Dh, layer, scale, st);
  }
  if (dtype == 1) {
    return launch_dh<__nv_bfloat16>(q, k_cache, v_cache, bias, out, B, H,
                                    Hkv, S, S_alloc, Dh, layer, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
