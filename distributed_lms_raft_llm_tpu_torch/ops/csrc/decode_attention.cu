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
//    W = k + 1), `decode_attention_window_mma_kernel` for bf16 q (tensor
//    cores) and `decode_attention_window_kernel` for float32 q: row b's
//    query w sees the keys j < lengths[b] + w (its own causal frontier), in
//    every cache mode. The JAX package computes this in XLA
//    (models/common.py attend / attend_quant under the ragged path's mask);
//    the Pallas kernel takes one query row.
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
// The window (W > 1 query rows a batch row), two kernels, chosen by q's type
// (the wrapper plans for the one that runs, and a plan for the other is
// refused); neither falls back to the other.
//
// bf16 queries over a bf16 or int8 cache: decode_attention_window_mma_kernel,
// on the tensor cores. The first window kernel (the CUDA-core body below)
// held at most 4 query rows a block in registers, so a T = 9 window took 3
// blocks a (row, KV head), each streaming K and V again, and every (row, key)
// score was a CUDA-core dot product with a 3-step shuffle. Now:
//  - All G * W <= 16 query rows of a (row, KV head) are one m16 A tile of
//    mma.sync.m16n8k16 (bf16 in, float32 sums; rows past G * W are zero), so
//    K and V are read once a (row, KV head, split): one block each. A wider
//    (GQA) window takes n_mt = 2, 4 or 8 tiles in the same block, warp w the
//    tile w % n_mt. wgmma's 64-row minimum would waste 3/4 of each product.
//  - K and V are staged as for decode (bulk copies into a ring, a K and a V
//    mbarrier a stage, the cluster split for wide caches); the warps of a
//    tile take each staged tile's 16-key blocks in turn. The first tile's
//    copy starts before the row's length is read, and each lane reads the
//    scales and bias of its keys a block ahead, without waiting for it.
//  - Scores S = Q K^T on the tensor cores, keys the n dimension and Dh the k
//    dimension. Lane (g, t) reads dims 16t .. 16t + 15 (+ 64) of its q rows
//    and of a K row, and k16 step s takes dims 16t + 4s .. + 3 as its logical
//    k 2t, 2t+1, 2t+8, 2t+9 (a permutation of the sum, the same for q and K,
//    as in int8_matmul.cu's transposed route). int8 K converts to bf16
//    exactly in registers (prmt + split-sign fma, as in int8_matmul.cu), so
//    the products are attend_quant's q . k_int8 in float32; the columns are
//    then scaled by ks[key] and Dh^-1/2 (its order), the bias is added, and a
//    row's keys past its own frontier get exactly no weight (p = 0, its
//    maximum untouched).
//  - The online softmax lives in the accumulator layout: a row's columns of
//    an n8 tile sit on a quad of lanes, so a 16-key block's row maximum takes
//    2 shuffles (the first kernel: ~3 a (row, key)); m is kept per row in
//    float32 registers, l as lane sums reduced once at the end; o is
//    rescaled only where some row's maximum rose. It runs in base 2: scores
//    times log2 e, exp2 on the SFU (ex2.approx), the same weights as exp up
//    to float rounding.
//  - P V on the tensor cores: the score accumulators, times vs[key] and
//    rounded to bf16 (attend_quant's cast), are the A fragment where they lie
//    (FlashAttention-2's register reuse). V's B fragment pairs two keys in a
//    register: 4-byte (int8) or 8-byte (bf16) reads of dims 4g .. 4g + 3 of
//    each key row, paired across keys with prmt, so column n of n8 tile J is
//    dim 32 (J / 4) + 4 n + J % 4; O stays in float32 accumulators.
//  - Key labels: logical key k of a 16-key block is row k ^ ((k >> 1) & 1)
//    of it, so an int8 K read has no bank conflict and an int8 V read at most
//    two-way (a bf16 row is 128 bytes: K reads are 2-way, V reads 4-way).
//  - The warps' (m, l, o) merge through shared memory, each thread 4 dims
//    of a row with all its warps' states read up front, and the splits
//    over DSMEM, as for decode; each valid row is written in bf16.
// What bounds it: bytes, as for decode (T * 4 * Dh operations a K/V row
// pair, at most 64 a byte of int8 against the ~295 the card needs before
// the tensor cores would be the limit). What holds it back, measured with
// ops/probe_window.py (PERF.md): the latency before a block's first K tile
// lands, then the key loop's instruction issue where an SM holds two
// blocks (for an int8 cache the conversions to bf16 weigh in), and the
// merge.
//
// float32 queries (over a float32 or int8 cache): decode_attention_window_
// kernel, the CUDA-core body below, a test and exactness route (float32
// speculation equals non-speculative decoding token for token), not the
// production type; TF32 tensor cores would lose the float32 product. Its W
// rows ride the group dimension: a block holds G * W query rows
// (head-major), each with its own frontier, and streams K and V once for
// all of them, at most kF32WindowRows = 4 of them (q, o, m, l per row in
// registers): a window with more is cut into n_chunks blocks of
// ceil(G * W / n_chunks) rows, grid (n_split, Hkv * n_chunks, B), each
// reading K and V again (ops/attention.py::window_rows).
//
// The paged engine's one-row decode step: decode_attention_append_kernel
// (the same CUDA-core body, kAppend). Before it, a step ran ~20 launches a
// layer in front of the attention kernel: quantize_kv on the new K and V
// rows (about 9 elementwise kernels each) and four index writes into k, v,
// ks and vs (models/gpt2.py), all for one 64-element row a (slot, head),
// and the attention kernel started only when the last of them had ended.
// One launch a layer now does all of it:
//  - the block whose split holds slot nr = lengths[b] - 1 (one a batch row
//    and KV head) reads k_new and v_new in place (strided views of the
//    fused qkv projection, like q); warp 0 quantizes the K row, warp 1 the
//    V row, exactly as quantize_kv (append_row: float32 amax, s = amax /
//    127 by IEEE division, max(s, 1e-8), rint(x / s) clipped to +-127; a
//    float cache takes the row as it is), writes it and its scale at slot
//    nr of the cache, and stages the same bytes in shared memory; the
//    block attends over the older keys (tiles stop before nr) and folds the
//    new key in from shared memory after the key loop (an mbarrier says the
//    rows are staged, so no other warp waits for warps 0 and 1). The cache
//    afterwards is byte for byte what quantize_kv and the index writes made.
//  - The model launches it as a programmatic dependent of the kernel just
//    before it: GPT-2's qkv product (whose dense int8 kernels trigger their
//    dependents at their start) or Llama's RoPE of k (a PyTorch kernel that
//    triggers none, so the launch waits for its end); another caller
//    launches it plainly unless it asks. Before
//    griddepcontrol.wait a block reads lengths, initialises its barriers,
//    issues the bulk copies of the older rows and reads their scales;
//    invariant: all of that was written by kernels that ended before the
//    previous kernel began (lengths and the bias before the first layer,
//    older rows by earlier steps), and no other kernel of the port is
//    launched with the attribute. q, k_new and v_new are read after it.
//  - Blocks take batch rows longest first (row_of_rank; the grid stays
//    fixed, so graph replays hold), so the blocks an SM holds alone carry
//    the long rows and those that share an SM the short ones.
//  - An int8 byte becomes a float by a byte permute and an add (Vec<int8_t>)
//    instead of the conversion unit, which issues a quarter as many a
//    clock: the int8 key loop was bound by those conversions.
// Measured with ops/probe_decode.py (PERF.md): 256 threads a block beat
// 128 (the key loop's rows per lane group double); staging the split's
// scales in shared memory before the wait bought nothing once the
// conversions were cheap, and cost registers and shared memory, so the
// tiles' scales are read a tile ahead as in decode.
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
  long long kn_sb, kn_sh;      // k_new's and v_new's (append kernel only)
  int B, H, Hkv, S, S_alloc, Dh;
  int W;         // query rows a batch row (1, or a verify window)
  int rows;      // query rows a block: G; a float32 window's
                 // ceil(G * W / n_chunks); a bf16 window's 16 * n_mt
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
constexpr int kWindowRows = 16;    // query rows of a tensor-core window tile
constexpr int kMaxTiles = 8;       // m16 tiles a tensor-core window block
constexpr int kWindowTileKeys = 128;  // keys a staged tile of it, at most
constexpr int kF32WindowRows = 4;  // query rows a block of a float32 window
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

// int8 to float without the conversion unit (16 results a clock an SM on
// Hopper, against 64 byte permutes and 128 adds): byte i, its sign bit
// flipped (x + 128 as an unsigned byte), becomes the low byte of the float
// 2^23 + (x + 128), exactly; subtracting 2^23 + 128 leaves x, exactly.
template <>
struct Vec<int8_t> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                           0x7540u + (i % 4))) -
               8388736.f;
    }
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

// One arrival (release: this thread's earlier writes are visible to a
// thread whose wait sees the phase complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// Programmatic dependent launch: waits until the grids this one depends
// on have completed and their writes are visible (a no-op for a kernel
// not launched as a programmatic dependent).
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
// The append kernel adds its new K and V rows at the end
// (append_smem_bytes).
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

// The append kernel's own, after the rest rounded up to 16 bytes: the new
// rows K [Dh] KV and V [Dh] KV, then their scales ks, vs f32 and the
// mbarrier that says both rows are staged (16 bytes).
__host__ __device__ inline size_t append_offset(size_t rest) {
  return (rest + 15) / 16 * 16;
}

__host__ __device__ inline size_t append_smem_bytes(int G, int Dh, int tile,
                                                    int elem, int stages,
                                                    int n_split) {
  return append_offset(smem_bytes(G, Dh, tile, elem, stages, n_split)) +
         (size_t)2 * Dh * elem + 16;
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

// ------------------------------------------- the tensor-core window

// Two int8 -> two bf16, exactly: the bytes at positions 0 and 2 of h (1 and
// 3 are ignored) become the low and high halves; a = 128 + (v & 127) and
// b = -128 or -256 by the sign bit, a * 1 + b = v (int8_matmul.cu's
// conversion).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t h) {
  const uint32_t a = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (h & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// c += a . b, one m16n8k16 product, bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx, relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of the tensor-core window, in bytes (the wrapper's
// ops/attention.py::_window_smem_bytes computes the same sum):
//   [ring | reduce]  K/V ring [stages][2][tile][Dh] KV, reused after the key
//                    loop for the warps' o [kWarps][16][Dh] f32
//   m, l             [kWarps][16] f32 each
//   parts            n_split > 1 only, read on rank 0: o [n_split][rows][Dh],
//                    m [n_split][rows], l [n_split][rows] f32
//   barriers         [stages][2] u64 (K, V)
__host__ __device__ inline size_t window_region0_bytes(int Dh, int tile,
                                                       int elem, int stages) {
  const size_t ring = (size_t)stages * 2 * tile * Dh * elem;
  const size_t reduce = (size_t)kWarps * kWindowRows * Dh * sizeof(float);
  return ring > reduce ? ring : reduce;
}

__host__ __device__ inline size_t window_smem_bytes(int rows, int Dh,
                                                    int tile, int elem,
                                                    int stages,
                                                    int n_split) {
  const size_t parts =
      n_split > 1 ? (size_t)n_split * rows * (Dh + 2) : (size_t)0;
  return window_region0_bytes(Dh, tile, elem, stages) +
         sizeof(float) * (2 * kWarps * kWindowRows + parts) +
         sizeof(uint64_t) * stages * 2;
}

// One block per (split, KV head, batch row): all G * W query rows of the
// (row, KV head) in n_mt = rows / 16 m16 tiles (see the note at the top).
// q and out are bf16; KV is bf16 or int8 (with ks, vs).
template <typename KV, int kDh>
__global__ void __launch_bounds__(kThreads)
    decode_attention_window_mma_kernel(
        const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh,
        long long q_sw, const KV* __restrict__ k_cache,
        const KV* __restrict__ v_cache, const float* __restrict__ ks_cache,
        const float* __restrict__ vs_cache, const float* __restrict__ bias,
        const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
        int B, int H, int Hkv, int S, int S_alloc, int W, int rows,
        int n_chunks, int layer, int split_keys, int tile, int stages,
        float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;  // int8 K/V with scales
  constexpr int kC = kDh / 64;   // 64-dim chunks of a row
  constexpr int kNT = kDh / 8;   // n8 tiles of o
  constexpr int kVW = kDh / 32;  // 4-dim groups of a V row a lane reads
  static_assert(kDh == 64 || kDh == 128, "head dim 64 or 128");
  (void)n_chunks;

  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x;  // == rank in the cluster
  const int n_split = gridDim.x;
  const int g = blockIdx.y;  // KV head
  const int b = blockIdx.z;  // batch row
  const int G = H / Hkv;
  const int n_rows = G * W;           // query rows of this (row, KV head)
  const int n_mt = rows / kWindowRows;  // m16 tiles: 1, 2, 4 or 8
  const int mt_bits = __ffs(n_mt) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lg = lane >> 2;  // the mma's row / column group
  const int lt = lane & 3;   // its thread in the group
  const int mt = warp & (n_mt - 1);    // this warp's m16 tile
  const int kw = warp >> mt_bits;      // its turn among the tile's warps
  const int n_kw = kWarps >> mt_bits;
  // The softmax runs in base 2 (scores times log2 e, exp2 on the SFU): the
  // same weights as exp up to float rounding.
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;

  KV* ring = reinterpret_cast<KV*>(smem);       // [stages][2][tile][kDh]
  float* w_o = reinterpret_cast<float*>(smem);  // after the key loop
  float* w_m = reinterpret_cast<float*>(
      smem + window_region0_bytes(kDh, tile, sizeof(KV), stages));
  float* w_l = w_m + kWarps * kWindowRows;  // [kWarps][16]
  float* p_o = w_l + kWarps * kWindowRows;  // [n_split][rows][kDh]
  float* p_m = p_o + (n_split > 1 ? n_split * rows * kDh : 0);
  float* p_l = p_m + (n_split > 1 ? n_split * rows : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      p_l + (n_split > 1 ? n_split * rows : 0));

  if (n_split > 1) cluster_arrive_relaxed();  // "this block is running"

  const long long slot0 =
      (((long long)layer * B + b) * Hkv + g) * (long long)S_alloc;
  const int start = split * split_keys;
  const int split_end = min(S - start, split_keys);  // keys of the split
  const KV* K = k_cache + (slot0 + start) * kDh;
  const KV* V = v_cache + (slot0 + start) * kDh;
  const float* ks_row = kQuant ? ks_cache + slot0 + start : nullptr;
  const float* vs_row = kQuant ? vs_cache + slot0 + start : nullptr;
  const float* bias_row =
      bias != nullptr ? bias + (long long)b * S + start : nullptr;
  const size_t tile_elems = (size_t)tile * kDh;

  // One thread: copy `n` keys of tile t's K and V.
  auto stage_keys = [&](int t, int n) {
    const int st = t % stages;
    const uint32_t bytes = (uint32_t)(n * kDh * sizeof(KV));
    KV* kd = ring + (size_t)(2 * st) * tile_elems;
    KV* vd = kd + tile_elems;
    mbar_expect_tx(&bars[2 * st], bytes);
    bulk_load(kd, K + (long long)t * tile * kDh, bytes, &bars[2 * st]);
    mbar_expect_tx(&bars[2 * st + 1], bytes);
    bulk_load(vd, V + (long long)t * tile * kDh, bytes, &bars[2 * st + 1]);
  };
  // Split 0 copies its first tile before the row's length is known (split
  // 0 always holds key 0, so the tile is always read): the copy's latency
  // overlaps the length's. Its keys past the widest frontier are never
  // read.
  const int first = split == 0 ? min(tile, split_end) : 0;
  if (tid == 0) {
    for (int i = 0; i < 2 * stages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    if (first > 0) stage_keys(0, first);
  }

  // Logical key k of a 16-key block is its row k ^ ((k >> 1) & 1). This
  // lane's score columns (n8 tile nt, column 2 lt + x) are keys
  // kk[2 nt + x]; the K rows it reads for column lg are krow[nt].
  const int sw = lt & 1;
  const int kk[4] = {(2 * lt) ^ sw, (2 * lt + 1) ^ sw, (8 + 2 * lt) ^ sw,
                     (9 + 2 * lt) ^ sw};
  const int krow0 = lg ^ ((lg >> 1) & 1);
  const int krow[2] = {krow0, 8 + krow0};

  // The key parameters of this lane's four keys of the block at split key
  // j0: ks and vs (1 for a float cache) and the bias; 0 past the split.
  // Loads only, issued a block ahead of their use, whatever the row's
  // length: a key no row sees gets no weight whatever its parameters
  // (p * vs is selected, not multiplied, to 0).
  auto key_params = [&](int j0, float (&kp)[3][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + kk[i];
      const bool valid = j < split_end;
      kp[0][i] = kQuant ? (valid ? ks_row[j] : 0.f) : 1.f;
      kp[1][i] = kQuant ? (valid ? vs_row[j] : 0.f) : 1.f;
      kp[2][i] = valid && bias_row != nullptr ? bias_row[j] : 0.f;
    }
  };
  float kp[3][4];
  key_params(16 * kw, kp);

  // This lane's two rows of its tile: r = 16 mt + lg + 8 h is query row f of
  // the (row, KV head), head f / W, window position f % W. Its q fragments:
  // dims 64 c + 16 lt .. + 15, as bf16 pairs (word w: dims + 2w, + 2w + 1).
  // A row past the window's reads the last real one (no key is seen by
  // it, and it is never written): the loads are unconditional, so nothing
  // before the barrier waits for one.
  uint32_t qa[kC][2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = min(kWindowRows * mt + lg + 8 * h, n_rows - 1);
    const __nv_bfloat16* Qr = q + (long long)b * q_sb +
                              (long long)(g * G + f / W) * q_sh +
                              (long long)(f % W) * q_sw + 16 * lt;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(Qr + 64 * c);
      const uint4 x1 = *reinterpret_cast<const uint4*>(Qr + 64 * c + 8);
      const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) qa[c][h][i] = w[i];
    }
  }
  __syncthreads();  // the barriers are initialised

  // The keys of this split that some row sees: through the widest row's
  // frontier, min(lengths[b] + W - 1, S); the rest of the split's copies.
  const int s_row = lengths != nullptr ? min(max(lengths[b], 0), S) : S;
  const int s_max = min(s_row + W - 1, S);
  const int n_keys = max(min(s_max, start + split_keys) - start, 0);
  const int n_tiles = (n_keys + tile - 1) / tile;
  auto stage_tile = [&](int t) {
    stage_keys(t, min(tile, n_keys - t * tile));
  };
  if (tid == 0) {
    for (int t = first > 0 ? 1 : 0; t < stages && t < n_tiles; ++t) {
      stage_tile(t);
    }
  }
  int nk[2];  // keys of this split each row sees (0 past the window's rows)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = kWindowRows * mt + lg + 8 * h;
    nk[h] = f < n_rows ? min(min(s_row + f % W, S) - start, n_keys) : 0;
  }

  // Online softmax state of the lane's two rows (m quad-uniform, l this
  // lane's columns), and its o accumulators: o[J][2h + x] is row
  // lg + 8h, dim 32 (J / 4) + 4 (2 lt + x) + J % 4.
  float m[2] = {kLowest, kLowest}, l[2] = {0.f, 0.f};
  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  }

  bool fresh = true;  // no block folded yet: o is 0, nothing to rescale
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % stages;
    const uint32_t parity = (uint32_t)((t / stages) & 1);
    const int n = min(tile, n_keys - t * tile);
    const KV* Ks = ring + (size_t)(2 * st) * tile_elems;
    const KV* Vs = Ks + tile_elems;
    const int n_kb = (n + 15) / 16;
    if (kw < n_kb) mbar_wait(&bars[2 * st], parity);
    for (int kb = kw; kb < n_kb; kb += n_kw) {
      const int j0 = t * tile + kb * 16;  // the block's first key
      // This warp's next block: the next turn in this tile, else its first
      // in the next; its parameters load while this one is computed.
      float kp_next[3][4];
      key_params(kb + n_kw < n_kb ? j0 + 16 * n_kw : (t + 1) * tile + 16 * kw,
                 kp_next);
      // S = Q K^T for the block's 16 keys: two n8 tiles, kDh / 16 k steps.
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
        const KV* kr = Ks + (kb * 16 + krow[nt]) * kDh + 16 * lt;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          uint32_t kw8[8];
          if constexpr (kQuant) {
            const uint4 x = *reinterpret_cast<const uint4*>(kr + 64 * c);
            const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              kw8[2 * i] = i8x2_to_bf16x2(__byte_perm(w[i], 0u, 0x0100u));
              kw8[2 * i + 1] = i8x2_to_bf16x2(__byte_perm(w[i], 0u, 0x0302u));
            }
          } else {
            const uint4 x0 = *reinterpret_cast<const uint4*>(kr + 64 * c);
            const uint4 x1 = *reinterpret_cast<const uint4*>(kr + 64 * c + 8);
            const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w,
                                   x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) kw8[i] = w[i];
          }
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4) {
            const uint32_t a[4] = {qa[c][0][2 * s4], qa[c][1][2 * s4],
                                   qa[c][0][2 * s4 + 1],
                                   qa[c][1][2 * s4 + 1]};
            mma_bf16(sc[nt], a, kw8[2 * s4], kw8[2 * s4 + 1]);
          }
        }
      }
      // attend_quant's order: the dot, times the key's scale, times
      // Dh^-1/2 (one factor here, with log2 e), plus the bias; then the
      // block's step of the online softmax.
      uint32_t pa[4];  // P * vs as the A fragment of P V
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sv[4];
        float mx = kLowest;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool seen = j0 + kk[i] < nk[h];
          const float x = sc[i >> 1][2 * h + (i & 1)] * kp[0][i] * scale2 +
                          kp[2][i] * kLog2e;
          sv[i] = seen ? x : kLowest;
          mx = fmaxf(mx, sv[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = exp2_approx(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool seen = j0 + kk[i] < nk[h];
          const float p = seen ? exp2_approx(sv[i] - m_new) : 0.f;
          l[h] += p;
          pv[i] = seen ? p * kp[1][i] : 0.f;
        }
        pa[h] = pack_bf16x2(pv[0], pv[1]);      // keys kk[0], kk[1]
        pa[2 + h] = pack_bf16x2(pv[2], pv[3]);  // keys kk[2], kk[3]
      }
      // Rescale o where some row's maximum rose (never before the first
      // block, whose o is 0).
      if (!fresh && __any_sync(0xffffffffu,
                               alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) o[j][c] *= alpha[c >> 1];
        }
      }
      fresh = false;
      // V's B fragments: dims 32 v + 4 lg .. + 3 of the lane's four key
      // rows kk, pairs (kk[0], kk[1]) and (kk[2], kk[3]) across keys.
      mbar_wait(&bars[2 * st + 1], parity);
      const bool tail = j0 + 16 > n_keys;  // rows past n_keys are stale
#pragma unroll
      for (int v = 0; v < kVW; ++v) {
        if constexpr (kQuant) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = *reinterpret_cast<const uint32_t*>(
                Vs + (kb * 16 + kk[i]) * kDh + 32 * v + 4 * lg);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t sel = (uint32_t)(e | ((4 + e) << 8));
            mma_bf16(o[4 * v + e], pa,
                     i8x2_to_bf16x2(__byte_perm(w[0], w[1], sel)),
                     i8x2_to_bf16x2(__byte_perm(w[2], w[3], sel)));
          }
        } else {
          uint2 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = *reinterpret_cast<const uint2*>(
                Vs + (kb * 16 + kk[i]) * kDh + 32 * v + 4 * lg);
            if (tail && j0 + kk[i] >= n_keys) w[i] = make_uint2(0u, 0u);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
            const uint32_t b0 = __byte_perm(e < 2 ? w[0].x : w[0].y,
                                            e < 2 ? w[1].x : w[1].y, sel);
            const uint32_t b1 = __byte_perm(e < 2 ? w[2].x : w[2].y,
                                            e < 2 ? w[3].x : w[3].y, sel);
            mma_bf16(o[4 * v + e], pa, b0, b1);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) kp[a][i] = kp_next[a][i];
      }
    }
    if (t + stages < n_tiles) {  // refill this stage once all have read it
      __syncthreads();
      if (tid == 0) stage_tile(t + stages);
    }
  }

  // The lane sums of l over the quad; then each warp's (m, l, o) into
  // shared memory (the ring is free once every warp is past the loop).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lg + 8 * h;
    float* wo = w_o + (warp * kWindowRows + r) * kDh + 8 * lt;
#pragma unroll
    for (int v = 0; v < kVW; ++v) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        *reinterpret_cast<float4*>(wo + 32 * v + 4 * x) =
            make_float4(o[4 * v][2 * h + x], o[4 * v + 1][2 * h + x],
                        o[4 * v + 2][2 * h + x], o[4 * v + 3][2 * h + x]);
      }
    }
    if (lt == 0) {
      w_m[warp * kWindowRows + r] = m[h];
      w_l[warp * kWindowRows + r] = l[h];
    }
  }
  __syncthreads();

  // Row f (head f / W, window position f % W) of the (row, KV head) is
  // out[b, g*G + f / W, f % W], so its rows are contiguous in out.
  __nv_bfloat16* O = out + ((long long)b * H + g * G) * W * kDh;
  float* r_o = p_o;
  float* r_m = p_m;
  float* r_l = p_l;
  if (n_split > 1) {
    // Push into this split's slot on rank 0, once rank 0 is known to run.
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    r_o = cluster.map_shared_rank(p_o, 0) + split * rows * kDh;
    r_m = cluster.map_shared_rank(p_m, 0) + split * rows;
    r_l = cluster.map_shared_rank(p_l, 0) + split * rows;
  }
  // Each 4 output dims of a row merge the row's warps at once: every
  // warp's (m, l, o) is read up front (a warp past the tile's n_kw rereads
  // the last one and weighs 0, so every load is unconditional), then the
  // weights exp2(m_k - max m), the sum l and o.
  for (int i = tid; i < n_rows * (kDh / 4); i += kThreads) {
    const int f = i / (kDh / 4);
    const int d = 4 * (i % (kDh / 4));
    float mk[kWarps], lk[kWarps];
    float4 xk[kWarps];
    float mm = kLowest;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int w = f + n_mt * min(k, n_kw - 1) * kWindowRows;
      mk[k] = w_m[w];
      lk[k] = w_l[w];
      xk[k] = *reinterpret_cast<const float4*>(w_o + w * kDh + d);
      mm = fmaxf(mm, mk[k]);
    }
    float ll = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float a = k < n_kw ? exp2_approx(mk[k] - mm) : 0.f;
      ll += a * lk[k];
      acc.x += a * xk[k].x;
      acc.y += a * xk[k].y;
      acc.z += a * xk[k].z;
      acc.w += a * xk[k].w;
    }
    if (n_split == 1) {
      const float inv = __fdividef(1.f, ll);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv,
                                                      acc.y * inv);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv,
                                                      acc.w * inv);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(O + f * kDh + d) = packed;
    } else {
      *reinterpret_cast<float4*>(r_o + f * kDh + d) = acc;
      if (d == 0) {
        r_m[f] = mm;
        r_l[f] = ll;
      }
    }
  }
  if (n_split == 1) return;
  cluster_arrive_release();
  if (split != 0) return;  // rank 0 waits for every slot; peers are done
  cluster_wait();
  for (int i = tid; i < n_rows * kDh; i += kThreads) {
    const int f = i / kDh;
    float mm = kLowest;
    for (int k = 0; k < n_split; ++k) mm = fmaxf(mm, p_m[k * rows + f]);
    float ll = 0.f;
    float acc = 0.f;
    for (int k = 0; k < n_split; ++k) {
      const float a = exp2_approx(p_m[k * rows + f] - mm);
      ll += a * p_l[k * rows + f];
      acc += a * p_o[k * rows * kDh + i];
    }
    O[i] = __float2bfloat16(acc / ll);
  }
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

// The append kernel's new rows: k_new and v_new [B, Hkv, 1, Dh] in q's
// type (strided, Dh contiguous), and where they go: the cache and its
// scales again, as writable pointers (only row lengths[b] - 1 of them is
// written, and no pointer of the const cache arguments reads that row).
template <typename T, typename KV>
struct AppendRows {
  const T* k_new;
  const T* v_new;
  long long sb, sh;  // k_new's and v_new's batch and head strides
  KV* k;
  KV* v;
  float* ks;
  float* vs;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One new row of the append kernel, by one warp: the int8 cache takes
// quantize_kv's row (models/common.py), the float cache a plain copy; the
// row goes to slot `dst` of the cache (and its scale beside it) and to
// `row_s` in shared memory, the bytes the block attends to.
template <typename T, typename KV, int kDh>
__device__ __forceinline__ void append_row(const T* __restrict__ src,
                                           KV* dst, float* dst_scale,
                                           KV* row_s, float* scale_s,
                                           int lane) {
  if constexpr (sizeof(KV) == 1) {
    // quantize_kv, in its order: amax of |x| in float32, s = amax / 127 by
    // IEEE division, s = max(s, 1e-8), q = clip(rint(x / s), -127, 127)
    // (rint rounds half to even, as jnp.round).
    constexpr int kPer = kDh / 32;
    static_assert(kDh % 32 == 0, "an int8 row is 64 or 128 wide");
    float x[kPer];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x[i] = to_float(src[lane + 32 * i]);
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(x[i], s)), -127.f), 127.f);
      const KV v = static_cast<KV>(static_cast<int>(r));
      dst[lane + 32 * i] = v;
      row_s[lane + 32 * i] = v;
    }
    if (lane == 0) {
      *dst_scale = s;
      *scale_s = s;
    }
  } else {
    static_assert(sizeof(KV) == sizeof(T), "a float cache is in q's type");
    for (int d = lane; d < kDh; d += 32) {
      const KV v = src[d];
      dst[d] = v;
      row_s[d] = v;
    }
  }
}

// The batch row whose length ranks `rank` in descending order (ties by
// index). Every thread ranks rows t, t + kThreads, .. by the lengths
// (read once each); the row that ranks `rank` publishes itself. Contains a
// block barrier, so every thread calls it.
__device__ __forceinline__ int row_of_rank(const int* __restrict__ lengths,
                                           int B, int rank) {
  __shared__ int found;
  for (int t = threadIdx.x; t < B; t += kThreads) {
    const int lt = lengths[t];
    int r = 0;
    for (int u = 0; u < B; ++u) {
      const int lu = lengths[u];
      r += lu > lt || (lu == lt && u < t);
    }
    if (r == rank) found = t;
  }
  __syncthreads();
  return found;
}

// The body of the three CUDA-core kernels. kWindow: the rows have their
// own frontiers (lengths[b] + w); otherwise every row of the block sees
// the same keys. kAppend: the step's new K/V row is quantized, written at
// slot lengths[b] - 1 and attended from shared memory (the note at the
// top).
template <typename T, typename KV, int kDh, int kG, bool kWindow,
          bool kAppend = false>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_sw,
    const KV* __restrict__ k_cache, const KV* __restrict__ v_cache,
    const float* __restrict__ ks_cache, const float* __restrict__ vs_cache,
    const float* __restrict__ bias, const int* __restrict__ lengths,
    T* __restrict__ out, int B, int H, int Hkv, int S, int S_alloc, int W,
    int rows, int n_chunks, int layer, int split_keys, int tile, int stages,
    float scale, AppendRows<T, KV> app = {}) {
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
  static_assert(!(kAppend && kWindow), "one new row a batch row");

  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x;  // == rank in the cluster
  const int n_split = gridDim.x;
  const int g = blockIdx.y / n_chunks;  // KV head
  // The batch row: blockIdx.z, or for the append kernel the row of that
  // rank by length, longest first (ties by index), so that the blocks the
  // card dispatches first, one an SM, hold the longest rows and the ones
  // that share an SM the shortest. The grid stays fixed.
  const int b = [&] {
    if constexpr (kAppend) {
      return row_of_rank(lengths, B, blockIdx.z);
    } else {
      return (int)blockIdx.z;
    }
  }();
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
  // The append kernel's new K and V rows, then their scales.
  KV* new_kv = reinterpret_cast<KV*>(
      smem + append_offset(static_cast<size_t>(
                 reinterpret_cast<unsigned char*>(bars + 2 * stages) - smem)));
  float* new_sc = reinterpret_cast<float*>(new_kv + 2 * kDh);
  uint64_t* new_bar = reinterpret_cast<uint64_t*>(new_sc + 2);

  if (n_split > 1) cluster_arrive_relaxed();  // "this block is running"

  // This row's keys: all S, or the first lengths[b] of them; a window row
  // w sees w more. A split that starts past them walks no tile. The append
  // kernel's last key, slot nr, is the new row: its tiles stop before it.
  const int s_row = lengths != nullptr ? min(max(lengths[b], 0), S) : S;
  [[maybe_unused]] const int nr = max(s_row, 1) - 1;
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
  const int n_keys =
      max(min(kAppend ? nr : s_max, start + split_keys) - start, 0);
  const int n_tiles = (n_keys + tile - 1) / tile;
  // Whether this block's split holds the new row (one block a batch row
  // and KV head does).
  [[maybe_unused]] const bool holds_new =
      kAppend && nr >= start && nr < start + split_keys;
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
    if (kAppend) mbar_init(new_bar, 2);  // warps 0 and 1, one row each
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
  if constexpr (kAppend) {
    // The barriers are published before the wait, and only the new row's
    // fold, after the key loop, waits for the new rows (new_bar): the
    // other warps do not wait for warps 0 and 1 to stage them.
    __syncthreads();
    // Programmatic dependent launch: everything above reads only what
    // kernels that ended before the previous kernel began wrote (lengths,
    // the bias, cache rows below the new one and their scales); q, k_new
    // and v_new are the previous kernel's output.
    griddep_wait();
  }

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
  if constexpr (kAppend) {  // warp 0 the new K row, warp 1 the new V row
    if (holds_new && warp < 2) {
      const long long src = (long long)b * app.sb + (long long)g * app.sh;
      const long long dst = slot0 + nr;
      if (warp == 0) {
        append_row<T, KV, kDh>(app.k_new + src, app.k + dst * kDh,
                               kQuant ? app.ks + dst : nullptr, new_kv,
                               new_sc, lane);
      } else {
        append_row<T, KV, kDh>(app.v_new + src, app.v + dst * kDh,
                               kQuant ? app.vs + dst : nullptr,
                               new_kv + kDh, new_sc + 1, lane);
      }
      __syncwarp();  // the warp's shared-memory writes, then its arrival
      if (lane == 0) mbar_arrive(new_bar);
    }
  } else {
    __syncthreads();  // the barriers are initialised
  }

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

  // The new row, from shared memory (the bytes this block wrote to the
  // cache): every lane group scores it (the shuffle needs whole warps),
  // one group folds it into its state.
  if constexpr (kAppend) {
    if (holds_new) {
      mbar_wait(new_bar, 0);
      float kf[kE], vf[kE];
#pragma unroll
      for (int v = 0; v < kVpl; ++v) {
        Vec<KV>::load(new_kv + (lr + kLpr * v) * kN, kf + v * kN);
        Vec<KV>::load(new_kv + kDh + (lr + kLpr * v) * kN, vf + v * kN);
      }
      const float ksc = kQuant ? new_sc[0] : 1.f;
      const float vsc = kQuant ? new_sc[1] : 1.f;
      const float bsn = bias_row != nullptr ? bias_row[nr - start] : 0.f;
      const bool folds = grp == n_keys % kGroups;
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
        if (folds && j < map.n_rows) {
          const float sc = dot * ksc * scale + bsn;
          const float m_new = fmaxf(m[j], sc);
          const float alpha = expf(m[j] - m_new);
          const float p = expf(sc - m_new);
          m[j] = m_new;
          l[j] = l[j] * alpha + p;
          const float pv = p * vsc;
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            acc[j][e] = acc[j][e] * alpha + pv * vf[e];
          }
        }
      }
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

// A float32 verify window of W query rows a batch row, each with its own
// frontier, on the CUDA cores (a kernel of its own name, so a captured
// graph's nodes tell the routes apart).
template <typename T, typename KV, int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_window_kernel(DECODE_ATTENTION_PARAMS) {
  attend_rows<T, KV, kDh, kG, true>(DECODE_ATTENTION_ARGS);
}

// The paged engine's one-row decode step: append the step's K/V row and
// attend (the note at the top), a programmatic dependent where the caller
// asks.
template <typename T, typename KV, int kDh, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_append_kernel(DECODE_ATTENTION_PARAMS,
                                   AppendRows<T, KV> app) {
  attend_rows<T, KV, kDh, kG, false, true>(DECODE_ATTENTION_ARGS, app);
}

// The four kernels: decode, the float32 window, the bf16 window on the
// tensor cores (T = bf16, kG unused), and the append kernel.
enum Kind { kDecode, kWindowF32, kWindowMma, kAppendDecode };

template <typename T, typename KV, int kDh, int kG, Kind kKind>
constexpr auto kernel_of() {
  if constexpr (kKind == kWindowMma) {
    return decode_attention_window_mma_kernel<KV, kDh>;
  } else if constexpr (kKind == kWindowF32) {
    return decode_attention_window_kernel<T, KV, kDh, kG>;
  } else if constexpr (kKind == kAppendDecode) {
    return decode_attention_append_kernel<T, KV, kDh, kG>;
  } else {
    return decode_attention_kernel<T, KV, kDh, kG>;
  }
}

// The launch's pointers, as the C entry points received them (k_new and
// v_new for the append kernel only, which also writes k, v, ks and vs),
// and whether the append kernel is launched as a programmatic dependent.
struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *bias, *lengths;
  void* out;
  const void *k_new, *v_new;
  bool dependent;
};

template <typename T, typename KV, int kDh, int kG, Kind kKind>
int launch(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
           cudaStream_t stream) {
  auto kernel = kernel_of<T, KV, kDh, kG, kKind>();
  constexpr bool kAppend = kKind == kAppendDecode;
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
  cudaLaunchAttribute attr[2];
  int n_attr = 0;
  if (a.n_split > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = a.n_split;
    attr[n_attr].val.clusterDim.y = 1;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  if (kAppend && p.dependent) {
    // The append kernel may start before the previous kernel on the stream
    // has ended; it waits for it (griddepcontrol.wait) before it reads q,
    // k_new and v_new. Invariant, which the caller that asks for this
    // vouches for: what it reads before that wait was written by kernels
    // that ended before the previous kernel began. No other kernel of the
    // port is launched with this attribute.
    attr[n_attr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attr].val.programmaticStreamSerializationAllowed = 1;
    ++n_attr;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  cudaError_t err;
  if constexpr (kAppend) {
    const AppendRows<T, KV> app{
        static_cast<const T*>(p.k_new), static_cast<const T*>(p.v_new),
        a.kn_sb, a.kn_sh,
        static_cast<KV*>(const_cast<void*>(p.k)),
        static_cast<KV*>(const_cast<void*>(p.v)),
        static_cast<float*>(const_cast<void*>(p.ks)),
        static_cast<float*>(const_cast<void*>(p.vs))};
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(p.q), a.q_sb, a.q_sh, a.q_sw,
        static_cast<const KV*>(p.k), static_cast<const KV*>(p.v),
        static_cast<const float*>(p.ks), static_cast<const float*>(p.vs),
        static_cast<const float*>(p.bias),
        static_cast<const int*>(p.lengths), static_cast<T*>(p.out), a.B,
        a.H, a.Hkv, a.S, a.S_alloc, a.W, a.rows, a.n_chunks, layer,
        a.split_keys, a.tile, a.stages, a.scale, app);
  } else {
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(p.q), a.q_sb, a.q_sh, a.q_sw,
        static_cast<const KV*>(p.k), static_cast<const KV*>(p.v),
        static_cast<const float*>(p.ks), static_cast<const float*>(p.vs),
        static_cast<const float*>(p.bias),
        static_cast<const int*>(p.lengths), static_cast<T*>(p.out), a.B,
        a.H, a.Hkv, a.S, a.S_alloc, a.W, a.rows, a.n_chunks, layer,
        a.split_keys, a.tile, a.stages, a.scale);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The rows a block holds are a template bound (1, 4 or 8 heads for decode;
// 4 rows for a float32 window), so the per-row arrays live in registers.
template <typename T, typename KV, int kDh, Kind kKind = kDecode>
int launch_decode(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
                  cudaStream_t stream) {
  if (a.rows == 1) return launch<T, KV, kDh, 1, kKind>(a, p, layer, stream);
  if (a.rows <= 4) return launch<T, KV, kDh, 4, kKind>(a, p, layer, stream);
  return launch<T, KV, kDh, kMaxGroup, kKind>(a, p, layer, stream);
}

// A window: bf16 q on the tensor cores, float32 q on the CUDA cores.
template <typename T, typename KV, int kDh>
int launch_window(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
                  cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch<T, KV, kDh, kWindowRows, kWindowMma>(a, p, layer, stream);
  } else {
    return launch<T, KV, kDh, kF32WindowRows, kWindowF32>(a, p, layer,
                                                          stream);
  }
}

// Head dims: 8-128 for a float or bf16 cache; 64 and 128 (GPT-2 small and
// the larger models) for an int8 cache, whose 8-byte row vectors need Dh
// >= 64 for a 16-byte multiple a row at any tile length. A window takes 64
// and 128 in every cache mode. The append kernel takes the head dims of
// decode.
template <typename T, typename KV, Kind kKind>
int launch_one_row(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
                   cudaStream_t stream) {
  switch (a.Dh) {
    case 64:
      return launch_decode<T, KV, 64, kKind>(a, p, layer, stream);
    case 128:
      return launch_decode<T, KV, 128, kKind>(a, p, layer, stream);
    default:
      break;
  }
  if constexpr (sizeof(KV) != 1) {
    switch (a.Dh) {
      case 8:
        return launch_decode<T, KV, 8, kKind>(a, p, layer, stream);
      case 16:
        return launch_decode<T, KV, 16, kKind>(a, p, layer, stream);
      case 32:
        return launch_decode<T, KV, 32, kKind>(a, p, layer, stream);
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KV>
int launch_dh(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
              cudaStream_t stream, bool append) {
  if (append) {
    return launch_one_row<T, KV, kAppendDecode>(a, p, layer, stream);
  }
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
  return launch_one_row<T, KV, kDecode>(a, p, layer, stream);
}

// Whether the plan's rows, chunks and tile fit the kernel that runs it.
// Decode: a block holds its KV head's G heads. A float32 window: n_chunks
// blocks of `rows` rows cover the G * W rows, none of them empty. A bf16
// window: one block of n_mt m16 tiles, the fewest powers of two that hold
// G * W rows, over 16-key blocks.
bool tensor_core_window(const DecodeAttentionArgs& a) {
  return a.W > 1 && a.dtype == 1;
}

bool valid_rows(const DecodeAttentionArgs& a) {
  const int G = a.H / a.Hkv;
  if (a.W == 1) {
    return a.rows == G && a.n_chunks == 1 && a.tile >= 8 &&
           a.tile % 8 == 0 && a.tile <= max_tile(a.rows);
  }
  if (a.W < 2) return false;
  if (tensor_core_window(a)) {
    int n_mt = 1;
    while (n_mt * kWindowRows < G * a.W) n_mt *= 2;
    return n_mt <= kMaxTiles && a.rows == n_mt * kWindowRows &&
           a.n_chunks == 1 && a.tile >= 16 && a.tile % 16 == 0 &&
           a.tile <= kWindowTileKeys;
  }
  return a.rows >= 2 && a.rows <= kF32WindowRows && a.n_chunks >= 1 &&
         a.rows * a.n_chunks >= G * a.W &&
         a.rows * (a.n_chunks - 1) < G * a.W && a.tile >= 8 &&
         a.tile % 8 == 0 && a.tile <= max_tile(a.rows);
}

// Checks the arguments of either entry point and launches. The append
// kernel takes one query row, per-row lengths and its own shared memory.
int dispatch(const DecodeAttentionArgs& a, const Ptrs& p, int layer,
             cudaStream_t st, bool append) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup ||
      a.S <= 0 || a.S > a.S_alloc || a.n_split < 1 ||
      a.n_split > kMaxSplit || (a.n_split & (a.n_split - 1)) != 0 ||
      a.split_keys < 1 || (long long)a.split_keys * a.n_split < a.S ||
      !valid_rows(a)) {
    return (int)cudaErrorInvalidValue;
  }
  if (append && (a.W != 1 || p.lengths == nullptr || p.k_new == nullptr ||
                 p.v_new == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // A one-stage ring holds a split of one tile only: a later tile would
  // wait on a copy that never starts.
  const int max_tiles = (a.split_keys + a.tile - 1) / a.tile;
  if (a.stages < 1 || (a.stages < 2 && max_tiles > 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool quant = a.kv_dtype == 2;
  if (quant != (p.ks != nullptr && p.vs != nullptr) ||
      (!quant &&
       (p.ks != nullptr || p.vs != nullptr || a.kv_dtype != a.dtype))) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem = quant ? 1 : (a.kv_dtype == 0 ? 4 : 2);
  const size_t need =
      append ? append_smem_bytes(a.rows, a.Dh, a.tile, elem, a.stages,
                                 a.n_split)
      : tensor_core_window(a)
          ? window_smem_bytes(a.rows, a.Dh, a.tile, elem, a.stages, a.n_split)
          : smem_bytes(a.rows, a.Dh, a.tile, elem, a.stages, a.n_split);
  if (a.smem < 0 || (size_t)a.smem < need) return (int)cudaErrorInvalidValue;
  if (a.dtype == 0) {
    return quant ? launch_dh<float, int8_t>(a, p, layer, st, append)
                 : launch_dh<float, float>(a, p, layer, st, append);
  }
  if (a.dtype == 1) {
    return quant
               ? launch_dh<__nv_bfloat16, int8_t>(a, p, layer, st, append)
               : launch_dh<__nv_bfloat16, __nv_bfloat16>(a, p, layer, st,
                                                          append);
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
  const Ptrs p{q, k_cache, v_cache, ks, vs, bias, lengths, out,
               nullptr, nullptr, false};
  return dispatch(*args, p, layer, static_cast<cudaStream_t>(stream),
                  false);
}

// The paged one-row decode step (decode_attention_append_kernel): the new
// rows k_new and v_new [B, Hkv, 1, Dh] (strides args->kn_sb, kn_sh) are
// written at slot lengths[b] - 1 of layer `layer` (quantized, with their
// scales, for an int8 cache), then every query row attends over its
// lengths[b] keys. `lengths` is required, `bias` may be null; the rest as
// decode_attention_launch. `dependent` != 0 launches it as a programmatic
// dependent of the kernel before it on the stream, which must not write
// lengths, the bias or the cache rows below lengths[b] - 1 (the note at
// the top).
extern "C" int decode_attention_append_launch(
    const DecodeAttentionArgs* args, const void* q, const void* k_new,
    const void* v_new, void* k_cache, void* v_cache, void* ks, void* vs,
    const void* bias, const void* lengths, void* out, int layer,
    int dependent, void* stream) {
  const Ptrs p{q, k_cache, v_cache, ks, vs, bias, lengths, out,
               k_new, v_new, dependent != 0};
  return dispatch(*args, p, layer, static_cast<cudaStream_t>(stream), true);
}
