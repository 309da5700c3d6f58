// Single-token (decode) attention for Hopper, sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel
// distributed_lms_raft_llm_tpu/ops/attention.py::decode_attention (body
// _decode_attn_kernel): softmax(q . K^T * Dh^-1/2 + bias) . V for one query
// token per batch row, against one layer of the stacked KV cache, with
// scores and softmax in float32 and the output in q's dtype. Two things the
// Pallas kernel does not do, for the paged engine (engine/paged.py), whose
// JAX original therefore ran XLA einsums instead:
//  - per-row lengths: keys j >= lengths[b] are skipped, not masked, and a
//    tile wholly past a row's length is never copied; the bias may be null;
//  - an int8 cache with per-slot scales (models/common.py::attend_quant in
//    one pass): score = (q . k_int8[j]) * ks[j] * Dh^-1/2, and the output
//    sums p_j * vs[j] * v_int8[j], so K and V cross device memory as int8;
//  - a window of W query rows per batch row (the speculative verify window,
//    W = k + 1), `decode_attention_window_kernel`: row b's query w sees the
//    keys j < lengths[b] + w (its own causal frontier), in every cache mode.
//    The JAX package computes this in XLA (models/gpt2.py's ragged scatter
//    path); the Pallas kernel takes one query row.
//
// Layouts (row-major):
//   q        [B, H, W, Dh]   T = float or bf16; any batch, head and window
//            strides (in elements), Dh stride 1, rows 16-byte aligned: a
//            strided view of the fused qkv projection is read in place;
//            W = 1 but for the window kernel;
//   out      [B, H, W, Dh]   contiguous, T;
//   k, v     [L, B, Hkv, S_alloc, Dh]  the stacked cache, KV = T or int8;
//            the kernel attends over the first S slots (S <= S_alloc) of
//            layer `layer`, read in place: slots [S, S_alloc) are stale and
//            never read;
//   ks, vs   [L, B, Hkv, S_alloc] float32 per-slot scales (int8 KV only);
//   bias     [B, 1, S] float32, 0 (attend) or -1e30 (masked), or null;
//   lengths  [B] int32 valid keys per row (1 <= lengths[b]), or null (all S);
//            query w of a window sees min(lengths[b] + w, S) keys.
//
// What bounds it. Nothing is reused: every K and V byte is read once, and
// q.K^T is a matrix-vector product (G <= 8 query rows per KV head, against
// the 64-row tile a tensor-core `wgmma` takes), so the kernel is bound by
// bytes, not operations. The least time is
//   (2 * B * Hkv * S * Dh * sizeof(KV) [+ 2 * 4 * B * Hkv * S scales]
//    + 2 * B * H * Dh * sizeof(T) + 4 * B * S bias) / 3.35 TB/s
// (H100 SXM HBM3), e.g. B=8, Hkv=12, S=320, Dh=64 in bf16: 7.9 MB, 2.36 us;
// with per-row lengths only the keys below each length count. Tensor cores
// would multiply mostly padding; the design spends its effort on having
// the bytes in flight early instead.
//
// Design, against what held the first version (one block per (KV head,
// row), three serial phases, scores of the whole row in shared memory):
//  1. Too few blocks. The keys of a (row, KV head) are split across a
//     thread-block cluster of n_split <= 8 blocks (flash-decoding inside one
//     launch): grid (n_split, Hkv, B), cluster (n_split, 1, 1). The wrapper's
//     `launch_plan` picks n_split from the width S alone (see there for the
//     measured trade: a cluster costs latency of its own); lengths live on
//     the device and never shape the launch.
//  2. Serial phases, latency paid twice. Each block walks its key range in
//     tiles through a ring of `stages` tiles in shared memory, deep enough
//     to hold a whole split at serving sizes, so every byte of the block is
//     requested at its start. One thread stages a tile of K and a tile of V,
//     each one contiguous run of bytes in the cache, with one-dimensional
//     bulk asynchronous copies (cp.async.bulk ... mbarrier::complete_tx);
//     no tensor map is needed. K and V have separate mbarriers: scores start
//     as soon as K lands while V is in flight; a freed stage is refilled
//     with the next tile before the current tile is consumed. A row's key
//     range ends at its length: tiles past it are neither copied nor read.
//     The int8 scales (4 bytes a key, beside 2 * Dh bytes of K and V) are
//     read by the lane groups themselves a tile ahead, like the bias, so no
//     copy needs a 16-byte multiple of them.
//  3. Scores of the whole row in shared memory (hence S <= 1024), and a
//     block-wide softmax between the phases. Softmax is online and local:
//     8 lanes share a key row, and each such lane group keeps its own
//     running max m, sum l and slice of o[G][Dh] in float32 registers over
//     its rows of every tile (rows grp, grp + 32, ..), so the key loop has
//     no block-wide barrier at all. Nothing in shared memory grows with S,
//     and S has no limit. After the loop the groups of a warp merge by
//     shuffles, the warps through shared memory, the splits as below; every
//     merge weighs a state by exp(m - max m) (log-sum-exp).
//  4. Host cost: the wrapper validates a (shape, strides, dtype) once and
//     takes q strided, so the caller needs no copy; one launch per call.
// The splits are combined through distributed shared memory in the same
// launch. Every block arrives (relaxed) on the cluster barrier at its
// start and waits on it before its first remote access, which proves that
// rank 0 is running. Each block then stores its (m, l, o) into its slot of
// rank 0's shared memory and arrives again (release); rank 0 waits
// (acquire), weighs slot k by exp(m_k - max m) (log-sum-exp) and writes
// `out`. Only rank 0's memory is accessed remotely and rank 0 leaves last,
// so no block exits while a peer still uses its memory; a block whose split
// starts past its row's length walks no tile but still reaches both
// barriers. No second kernel, no global scratch, no atomic counter: the
// launch is capturable in a CUDA graph and replays unchanged.
//
// Masking is exact. "No key yet" is the finite lowest float, never -inf, so
// an empty or fully masked split cannot give -inf - -inf = NaN; its
// maximum stays the lowest float (or about -1e30 when masked), so its
// combine weight exp(m - max m) is exactly 0 beside any split with a valid
// key. Every row keeps at least one valid key (the caller's contract); with
// lengths, split 0 always holds key 0.
//
// The window. Its W rows share the keys of their (row, KV head), so they
// ride the group dimension: a block holds G * W query rows (head-major),
// each with its own frontier, and streams K and V once for all of them;
// a row's keys past its frontier weigh exactly nothing (p = 0, the max
// untouched), and the block walks the keys of its widest row. The rows of
// a block are held in registers (q, o, m, l per row), so a block holds at
// most kWindowRows = 4 of them: a window with more is cut into n_chunks
// blocks of ceil(G * W / n_chunks) rows, grid (n_split, Hkv * n_chunks, B),
// and each chunk reads K and V again, mostly from L2, since the chunks'
// blocks run at once (GPT-2's G = 1 at W = 9, for spec_tokens = 8, is 3
// blocks of 3; ops/attention.py::window_rows). 16 rows would hold 16 q and
// 16 o slices of a lane in registers (~300 at Dh 64) and spill; 8 rows
// took 217 registers, one 256-thread block an SM, against 127 and two for
// 4, and measured slower than 4 at every W > 2 on an H100, so a window
// block is instantiated for 4 rows alone.
//
// Reading shared memory: the 8 lanes of a group read a K or V row as
// vectors (16 bytes of a float or bf16 row, 8 bytes of an int8 row: a warp
// reads 4 whole rows, no bank conflicts); a 3-step shuffle sums their
// slices of q.k. One block serves the G = H / Hkv query heads of its KV
// head, so each K/V byte is read once per group (GQA without repeating
// K/V). Blocks are 256 threads: an unsplit window of a few hundred keys is
// then walked by 32 lane groups at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// The per-layout arguments, prepared once by the wrapper (ctypes
// structure `_Args` in ops/attention.py): passing them by pointer keeps the
// per-call argument list short. Outside the anonymous namespace, so the
// C entry point that takes it keeps external linkage.
struct DecodeAttentionArgs {
  long long q_sb, q_sh, q_sw;  // q's batch, head and window strides
  int B, H, Hkv, S, S_alloc, Dh;
  int W;         // query rows a batch row (1, or a verify window)
  int rows;      // query rows a block: G, or ceil(G * W / n_chunks)
  int n_chunks;  // blocks a (row, KV head) over its query rows
  int n_split, split_keys, tile, stages, smem;  // the launch plan
  int dtype;     // q and out: 0 float32, 1 bfloat16
  int kv_dtype;  // the cache: 0 float32, 1 bfloat16, 2 int8 (with scales)
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query rows a block (H / Hkv for decode)
constexpr int kWindowRows = 4;  // query rows a block of a window
constexpr int kMaxSplit = 8;  // blocks per cluster (the portable maximum)
constexpr float kLowest = -3.402823466e38f;

// Vector loads, widened to float: 16 bytes of float or bf16, 8 bytes of
// int8 (so an int8 lane holds as many elements as a bf16 one).
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
  }
};

// kN consecutive elements of T as float, in Vec<T>-sized loads (q's slice
// matching a lane's slice of a K row, whatever the cache's type).
template <typename T, int kN>
__device__ __forceinline__ void load_span(const T* p, float* out) {
  static_assert(kN % Vec<T>::kN == 0, "span of whole vectors");
#pragma unroll
  for (int i = 0; i < kN / Vec<T>::kN; ++i) {
    Vec<T>::load(p + i * Vec<T>::kN, out + i * Vec<T>::kN);
  }
}

// ---------------------------------------------- mbarrier, bulk, cluster

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ the layout

// Keys per tile, at most: a lane group holds its rows' scores of a tile
// in registers, so the cap is lower where G heads need G scores a row.
__host__ __device__ constexpr int max_tile(int G) { return G == 1 ? 128 : 64; }

// Shared memory, in bytes (the wrapper's ops/attention.py::_smem_bytes
// computes the same sum; the launch checks it was given at least this):
//   [ring | reduce]  K/V ring [stages][2][tile][Dh] KV, reused after the key
//                    loop for the warps' o [kWarps][G][Dh] f32
//   m, l             [kWarps][kMaxGroup] f32 each: the warps' softmax state
//   parts            n_split > 1 only, read on rank 0: o [n_split][G][Dh],
//                    m [n_split][G], l [n_split][G] f32
//   barriers         [stages][2] u64 (K, V)
__host__ __device__ inline size_t region0_bytes(int G, int Dh, int tile,
                                                int elem, int stages) {
  const size_t ring = (size_t)stages * 2 * tile * Dh * elem;
  const size_t reduce = (size_t)kWarps * G * Dh * sizeof(float);
  return ring > reduce ? ring : reduce;
}

__host__ __device__ inline size_t smem_bytes(int G, int Dh, int tile,
                                             int elem, int stages,
                                             int n_split) {
  const size_t parts =
      n_split > 1 ? (size_t)n_split * G * (Dh + 2) : (size_t)0;
  return region0_bytes(G, Dh, tile, elem, stages) +
         sizeof(float) * (2 * kWarps * kMaxGroup + parts) +
         sizeof(uint64_t) * stages * 2;
}

// Merges softmax state (m, l, o) with another's: both rescaled to the
// larger maximum. With the finite lowest float as "no key yet", two empty
// states merge to an empty one (weights 1, sums 0), never NaN.
__device__ __forceinline__ void merge_weights(float& m, float& l, float m2,
                                              float l2, float& a, float& a2) {
  const float mm = fmaxf(m, m2);
  a = expf(m - mm);
  a2 = expf(m2 - mm);
  l = l * a + l2 * a2;
  m = mm;
}

// ------------------------------------------------------------ the kernel

// Where a block's query rows are: row j of the block is query row
// f = chunk * rows + j of its (batch row, KV head), f = head * W + w over
// the G heads and the W window positions (W = 1: row j is head j).
struct RowMap {
  int chunk, rows, n_rows;  // n_rows: this block's rows (<= rows)
  int G, W;
  __device__ __forceinline__ int head(int j) const {
    return (chunk * rows + j) / W;
  }
  __device__ __forceinline__ int pos(int j) const {
    return (chunk * rows + j) % W;
  }
};

// The body of both kernels. kWindow: the rows have their own frontiers
// (lengths[b] + w); otherwise every row of the block sees the same keys.
template <typename T, typename KV, int kDh, int kG, bool kWindow>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_sw,
    const KV* __restrict__ k_cache, const KV* __restrict__ v_cache,
    const float* __restrict__ ks_cache, const float* __restrict__ vs_cache,
    const float* __restrict__ bias, const int* __restrict__ lengths,
    T* __restrict__ out, int B, int H, int Hkv, int S, int S_alloc, int W,
    int rows, int n_chunks, int layer, int split_keys, int tile, int stages,
    float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;   // int8 K/V with scales
  constexpr int kN = Vec<KV>::kN;            // elements per K/V vector
  constexpr int kChunks = kDh / kN;          // vectors per row
  constexpr int kLpr = kChunks < 8 ? kChunks : 8;  // lanes per key row
  constexpr int kVpl = kChunks / kLpr;       // vectors per lane
  constexpr int kE = kVpl * kN;              // elements per lane
  constexpr int kGroups = kThreads / kLpr;   // lane groups per block
  constexpr int kRows = (max_tile(kG) + kGroups - 1) / kGroups;  // a tile
  static_assert(kDh % kN == 0 && kChunks <= 32 && 32 % kChunks == 0,
                "head dim must be a power of two from 8 to 128");
  static_assert(kG >= 1 && kG <= kMaxGroup, "group bound");

  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x;  // == rank in the cluster
  const int n_split = gridDim.x;
  const int g = blockIdx.y / n_chunks;  // KV head
  const int b = blockIdx.z;             // batch row
  const int G = H / Hkv;
  const RowMap map{(int)blockIdx.y % n_chunks, rows,
                   min(rows, G * W - ((int)blockIdx.y % n_chunks) * rows),
                   G, W};
  const int R = rows;            // the shared-memory layout's row count
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lr = tid % kLpr;     // lane within its group
  const int grp = tid / kLpr;    // lane group: rows grp, grp + kGroups, ..

  KV* ring = reinterpret_cast<KV*>(smem);          // [stages][2][tile][kDh]
  float* w_o = reinterpret_cast<float*>(smem);     // after the key loop
  float* w_m = reinterpret_cast<float*>(
      smem + region0_bytes(R, kDh, tile, sizeof(KV), stages));
  float* w_l = w_m + kWarps * kMaxGroup;           // [kWarps][kMaxGroup]
  float* p_o = w_l + kWarps * kMaxGroup;           // [n_split][R][kDh]
  float* p_m = p_o + (n_split > 1 ? n_split * R * kDh : 0);  // [n_split][R]
  float* p_l = p_m + (n_split > 1 ? n_split * R : 0);        // [n_split][R]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      p_l + (n_split > 1 ? n_split * R : 0));
  // bars[2 * stage] K, bars[2 * stage + 1] V

  if (n_split > 1) cluster_arrive_relaxed();  // "this block is running"

  // This row's keys: all S, or the first lengths[b] of them; a window row
  // w sees w more. A split that starts past them walks no tile.
  const int s_row = lengths != nullptr ? min(max(lengths[b], 0), S) : S;
  const long long slot0 =
      (((long long)layer * B + b) * Hkv + g) * (long long)S_alloc;
  const int start = split * split_keys;
  // Each row's keys in this split (window rows only; else n_keys for all).
  [[maybe_unused]] int nk[kWindow ? kG : 1];
  int s_max = s_row;
  if constexpr (kWindow) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int lim = j < map.n_rows ? min(s_row + map.pos(j), S) : 0;
      nk[j] = lim - start;
      s_max = max(s_max, lim);
    }
  }
  const int n_keys = max(min(s_max, start + split_keys) - start, 0);
  const int n_tiles = (n_keys + tile - 1) / tile;
  const KV* K = k_cache + (slot0 + start) * kDh;
  const KV* V = v_cache + (slot0 + start) * kDh;
  const float* bias_row =
      bias != nullptr ? bias + (long long)b * S + start : nullptr;
  const float* ks_row = kQuant ? ks_cache + slot0 + start : nullptr;
  const float* vs_row = kQuant ? vs_cache + slot0 + start : nullptr;
  const size_t tile_elems = (size_t)tile * kDh;

  auto stage_tile = [&](int t) {  // one thread: copy tile t's K and V
    const int st = t % stages;
    const int n = min(tile, n_keys - t * tile);
    const uint32_t bytes = (uint32_t)(n * kDh * sizeof(KV));
    KV* kd = ring + (size_t)(2 * st) * tile_elems;
    KV* vd = kd + tile_elems;
    mbar_expect_tx(&bars[2 * st], bytes);
    bulk_load(kd, K + (long long)t * tile * kDh, bytes, &bars[2 * st]);
    mbar_expect_tx(&bars[2 * st + 1], bytes);
    bulk_load(vd, V + (long long)t * tile * kDh, bytes, &bars[2 * st + 1]);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 * stages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int t = 0; t < stages && t < n_tiles; ++t) stage_tile(t);
  }
  // The bias and scales of this group's rows of tile t, a tile ahead of
  // their use, so that their latency overlaps the copies and the previous
  // tile.
  auto row_params = [&](int t, float* bs, float* kss, float* vss) {
    const int n = min(tile, n_keys - t * tile);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = grp + kGroups * i;
      const bool valid = row < n;
      const int j = t * tile + row;
      bs[i] = valid && bias_row != nullptr ? bias_row[j] : 0.f;
      if constexpr (kQuant) {
        kss[i] = valid ? ks_row[j] : 0.f;
        vss[i] = valid ? vs_row[j] : 0.f;
      } else {
        kss[i] = vss[i] = 1.f;
      }
    }
  };
  float bs[kRows], kss[kRows], vss[kRows];
  row_params(0, bs, kss, vss);

  // This lane's slice of the block's query rows (heads g*G .. g*G+G-1,
  // window positions 0 .. W-1): vectors lr, lr + kLpr, .. of each row, the
  // same slice it reads of K and V.
  const T* Q = q + (long long)b * q_sb + (long long)g * G * q_sh;
  float qr[kG][kE];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const T* Qj = Q + (long long)map.head(j) * q_sh +
                  (long long)map.pos(j) * q_sw;
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      if (j < map.n_rows) {
        load_span<T, kN>(Qj + (lr + kLpr * i) * kN, qr[j] + i * kN);
      }
    }
  }
  __syncthreads();  // the barriers are initialised

  // Online softmax state of this lane group, per query row; o is this
  // lane's slice of it.
  float m[kG], l[kG], acc[kG][kE];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    m[j] = kLowest;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[j][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % stages;
    const uint32_t parity = (uint32_t)((t / stages) & 1);
    const int n = min(tile, n_keys - t * tile);
    const KV* Ks = ring + (size_t)(2 * st) * tile_elems;
    const KV* Vs = Ks + tile_elems;

    float bs_next[kRows], kss_next[kRows], vss_next[kRows];
    row_params(t + 1, bs_next, kss_next, vss_next);

    // Whether query row j sees key row `row` of this tile.
    auto sees = [&](int row, int j) {
      if constexpr (kWindow) {
        return row < n && t * tile + row < nk[j];
      } else {
        return row < n;
      }
    };

    // Scores of this group's rows, once K has landed: the kLpr lanes of a
    // row sum their slices with a shuffle (every lane runs it).
    mbar_wait(&bars[2 * st], parity);
    float s[kRows][kG];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = grp + kGroups * i;
      const bool valid = row < n;
      float kf[kE];
#pragma unroll
      for (int v = 0; v < kVpl; ++v) {
        if (valid) {
          Vec<KV>::load(Ks + row * kDh + (lr + kLpr * v) * kN, kf + v * kN);
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) kf[v * kN + e] = 0.f;
        }
      }
      // attend_quant's order: the dot, times the key's scale, times Dh^-1/2
      const float ksc = kQuant ? kss[i] : 1.f;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        float dot = 0.f;
        if (j < map.n_rows) {
#pragma unroll
          for (int e = 0; e < kE; ++e) dot += qr[j][e] * kf[e];
        }
#pragma unroll
        for (int o = 1; o < kLpr; o <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        s[i][j] = sees(row, j) ? dot * ksc * scale + bs[i] : kLowest;
      }
    }

    // Fold the tile into the running state: one rescale per tile.
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j < map.n_rows) {
        float m_new = m[j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) m_new = fmaxf(m_new, s[i][j]);
        const float alpha = expf(m[j] - m_new);
        m[j] = m_new;
        l[j] *= alpha;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[j][e] *= alpha;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = sees(grp + kGroups * i, j) ? expf(s[i][j] - m_new)
                                               : 0.f;  // now p
          l[j] += s[i][j];
        }
      }
    }
    mbar_wait(&bars[2 * st + 1], parity);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = grp + kGroups * i;
      if (row < n) {
        float vf[kE];
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
          Vec<KV>::load(Vs + row * kDh + (lr + kLpr * v) * kN, vf + v * kN);
        }
        // The value's scale folds into its weight (l sums p alone).
        const float vsc = kQuant ? vss[i] : 1.f;
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (j < map.n_rows) {
            const float pv = s[i][j] * vsc;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[j][e] += pv * vf[e];
          }
        }
      }
    }
    if (t + stages < n_tiles) {  // refill this stage once all have read it
      __syncthreads();
      if (tid == 0) stage_tile(t + stages);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bs[i] = bs_next[i];
      kss[i] = kss_next[i];
      vss[i] = vss_next[i];
    }
  }

  // Merge the lane groups of each warp (lanes that share lr), then the
  // warps through shared memory.
#pragma unroll
  for (int o = kLpr; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], o);
      float a, a2;
      merge_weights(m[j], l[j], m2, l2, a, a2);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        acc[j][e] = acc[j][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[j][e], o) * a2;
      }
    }
  }
  __syncthreads();  // the ring is free: reuse it for the warps' o
  if (lane < kLpr) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j < map.n_rows) {
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            w_o[(warp * R + j) * kDh + (lr + kLpr * v) * kN + e] =
                acc[j][v * kN + e];
          }
        }
        if (lane == 0) {
          w_m[warp * kMaxGroup + j] = m[j];
          w_l[warp * kMaxGroup + j] = l[j];
        }
      }
    }
  }
  __syncthreads();

  // Row j's output: out[b, g*G + head, pos] (W = 1: out[b, g*G + j]).
  T* O = out + (long long)b * H * W * kDh;
  auto out_row = [&](int j) {
    return O + ((long long)(g * G + map.head(j)) * W + map.pos(j)) * kDh;
  };
  float* r_o = p_o;
  float* r_m = p_m;
  float* r_l = p_l;
  if (n_split > 1) {
    // Push into this split's slot on rank 0, once rank 0 is known to run.
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    r_o = cluster.map_shared_rank(p_o, 0) + split * R * kDh;
    r_m = cluster.map_shared_rank(p_m, 0) + split * R;
    r_l = cluster.map_shared_rank(p_l, 0) + split * R;
  }
  // Each output element merges the warps' states at once: the common
  // maximum first, then independent weights (no chain of rescales).
  for (int i = tid; i < map.n_rows * kDh; i += kThreads) {
    const int j = i / kDh;
    float mm = kLowest;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w_m[w * kMaxGroup + j]);
    float ll = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(w_m[w * kMaxGroup + j] - mm);
      ll += a * w_l[w * kMaxGroup + j];
      o += a * w_o[(w * R + j) * kDh + (i - j * kDh)];
    }
    if (n_split == 1) {
      Vec<T>::store(out_row(j) + (i - j * kDh), o / ll);
    } else {
      r_o[i] = o;
      if (i - j * kDh == 0) {
        r_m[j] = mm;
        r_l[j] = ll;
      }
    }
  }
  if (n_split == 1) return;
  cluster_arrive_release();
  if (split != 0) return;  // rank 0 waits for every slot; peers are done
  cluster_wait();
  for (int i = tid; i < map.n_rows * kDh; i += kThreads) {
    const int j = i / kDh;
    float mm = kLowest;
    for (int k = 0; k < n_split; ++k) mm = fmaxf(mm, p_m[k * R + j]);
    float ll = 0.f;
    float o = 0.f;
    for (int k = 0; k < n_split; ++k) {
      const float a = expf(p_m[k * R + j] - mm);
      ll += a * p_l[k * R + j];
      o += a * p_o[k * R * kDh + i];
    }
    Vec<T>::store(out_row(j) + (i - j * kDh), o / ll);
  }
}

#define DECODE_ATTENTION_PARAMS                                               \
  const T *__restrict__ q, long long q_sb, long long q_sh, long long q_sw,    \
      const KV *__restrict__ k_cache, const KV *__restrict__ v_cache,         \
      const float *__restrict__ ks_cache, const float *__restrict__ vs_cache, \
      const float *__restrict__ bias, const int *__restrict__ lengths,        \
      T *__restrict__ out, int B, int H, int Hkv, int S, int S_alloc, int W,  \
      int rows, int n_chunks, int layer, int split_keys, int tile,            \
      int stages, float scale
#define DECODE_ATTENTION_ARGS                                                 \
  q, q_sb, q_sh, q_sw, k_cache, v_cache, ks_cache, vs_cache, bias, lengths,   \
      out, B, H, Hkv, S, S_alloc, W, rows, n_chunks, layer, split_keys, tile, \
      stages, scale

// One query row a batch row (decode): a block holds the G query heads of
// its KV head.
template <typename T, typename KV, int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(DECODE_ATTENTION_PARAMS) {
  attend_rows<T, KV, kDh, kG, false>(DECODE_ATTENTION_ARGS);
}

// A verify window of W query rows a batch row, each with its own frontier
// (a kernel of its own name, so a captured graph's nodes tell the two
// apart).
template <typename T, typename KV, int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_window_kernel(DECODE_ATTENTION_PARAMS) {
  attend_rows<T, KV, kDh, kG, true>(DECODE_ATTENTION_ARGS);
}

// One of the two kernels, instantiated alone.
template <typename T, typename KV, int kDh, int kG, bool kWindow>
constexpr auto kernel_of() {
  if constexpr (kWindow) {
    return decode_attention_window_kernel<T, KV, kDh, kG>;
  } else {
    return decode_attention_kernel<T, KV, kDh, kG>;
  }
}

// The launch's pointers, as the C entry point received them.
struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *bias, *lengths;
  void* out;
};

template <typename T, typename KV, int kDh, int kG, bool kWindow>
int launch(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
           cudaStream_t stream) {
  auto kernel = kernel_of<T, KV, kDh, kG, kWindow>();
  // Raise the dynamic shared-memory ceiling once per instantiation and
  // size, not on every call.
  static int configured = 48 * 1024;
  if (a.smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return (int)err;
    configured = a.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.Hkv * a.n_chunks, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.n_split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(p.q), a.q_sb, a.q_sh, a.q_sw,
      static_cast<const KV*>(p.k), static_cast<const KV*>(p.v),
      static_cast<const float*>(p.ks), static_cast<const float*>(p.vs),
      static_cast<const float*>(p.bias), static_cast<const int*>(p.lengths),
      static_cast<T*>(p.out), a.B, a.H, a.Hkv, a.S, a.S_alloc, a.W, a.rows,
      a.n_chunks, layer, a.split_keys, a.tile, a.stages, a.scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The rows a block holds are a template bound (1, 4 or 8 heads for decode;
// 4 rows for a window), so the per-row arrays live in registers.
template <typename T, typename KV, int kDh>
int launch_decode(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
                  cudaStream_t stream) {
  if (a.rows == 1) return launch<T, KV, kDh, 1, false>(a, p, layer, stream);
  if (a.rows <= 4) return launch<T, KV, kDh, 4, false>(a, p, layer, stream);
  return launch<T, KV, kDh, kMaxGroup, false>(a, p, layer, stream);
}

template <typename T, typename KV, int kDh>
int launch_window(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
                  cudaStream_t stream) {
  return launch<T, KV, kDh, kWindowRows, true>(a, p, layer, stream);
}

// Head dims: 8-128 for a float or bf16 cache; 64 and 128 (GPT-2 small and
// the larger models) for an int8 cache, whose 8-byte row vectors need Dh
// >= 64 for a 16-byte multiple a row at any tile length. A window takes 64
// and 128 in every cache mode.
template <typename T, typename KV>
int launch_dh(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
              cudaStream_t stream) {
  if (a.W > 1) {
    switch (a.Dh) {
      case 64:
        return launch_window<T, KV, 64>(a, p, layer, stream);
      case 128:
        return launch_window<T, KV, 128>(a, p, layer, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (a.Dh) {
    case 64:
      return launch_decode<T, KV, 64>(a, p, layer, stream);
    case 128:
      return launch_decode<T, KV, 128>(a, p, layer, stream);
    default:
      break;
  }
  if constexpr (sizeof(KV) != 1) {
    switch (a.Dh) {
      case 8:
        return launch_decode<T, KV, 8>(a, p, layer, stream);
      case 16:
        return launch_decode<T, KV, 16>(a, p, layer, stream);
      case 32:
        return launch_decode<T, KV, 32>(a, p, layer, stream);
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// `args`: the layout and launch plan (ops/attention.py::launch_plan), see
// DecodeAttentionArgs. `ks`/`vs` are given exactly for an int8 cache;
// `bias` and `lengths` may each be null. Returns the CUDA error of the
// launch (0 = launched). The caller validates shapes, dtypes, strides,
// 16-byte alignment and the layer index, and allocates `out` contiguous.
extern "C" int decode_attention_launch(const DecodeAttentionArgs* args,
                                       const void* q, const void* k_cache,
                                       const void* v_cache, const void* ks,
                                       const void* vs, const void* bias,
                                       const void* lengths, void* out,
                                       int layer, void* stream) {
  const DecodeAttentionArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup ||
      a.S <= 0 || a.S > a.S_alloc || a.n_split < 1 ||
      a.n_split > kMaxSplit || (a.n_split & (a.n_split - 1)) != 0 ||
      a.split_keys < 1 || (long long)a.split_keys * a.n_split < a.S ||
      a.tile < 8 || a.tile % 8 != 0 || a.tile > max_tile(a.rows)) {
    return (int)cudaErrorInvalidValue;
  }
  // Decode: a block holds its KV head's G heads. A window: n_chunks blocks
  // of `rows` rows cover the G * W rows, none of them empty.
  const int G = a.H / a.Hkv;
  const bool rows_ok =
      a.W == 1 ? (a.rows == G && a.n_chunks == 1)
               : (a.W > 1 && a.rows >= 2 && a.rows <= kWindowRows &&
                  a.n_chunks >= 1 && a.rows * a.n_chunks >= G * a.W &&
                  a.rows * (a.n_chunks - 1) < G * a.W);
  if (!rows_ok) return (int)cudaErrorInvalidValue;
  // A one-stage ring holds a split of one tile only: a later tile would
  // wait on a copy that never starts.
  const int max_tiles = (a.split_keys + a.tile - 1) / a.tile;
  if (a.stages < 1 || (a.stages < 2 && max_tiles > 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool quant = a.kv_dtype == 2;
  if (quant != (ks != nullptr && vs != nullptr) ||
      (!quant && (ks != nullptr || vs != nullptr || a.kv_dtype != a.dtype))) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem = quant ? 1 : (a.kv_dtype == 0 ? 4 : 2);
  if (a.smem < 0 || (size_t)a.smem < smem_bytes(a.rows, a.Dh, a.tile, elem,
                                                 a.stages, a.n_split)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ptrs p{q, k_cache, v_cache, ks, vs, bias, lengths, out};
  if (a.dtype == 0) {
    return quant ? launch_dh<float, int8_t>(a, p, layer, st)
                 : launch_dh<float, float>(a, p, layer, st);
  }
  if (a.dtype == 1) {
    return quant ? launch_dh<__nv_bfloat16, int8_t>(a, p, layer, st)
                 : launch_dh<__nv_bfloat16, __nv_bfloat16>(a, p, layer, st);
  }
  return (int)cudaErrorInvalidValue;
}
