// Banded (causal and/or sliding-window) flash attention, forward only, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/swa_attention.py.
//
// Replaces the Pallas TPU kernel `_swa_kernel` / `swa_attention_pallas`
// (src/repro/kernels/swa_attention.py).  Same semantics: q (B,H,S,D),
// k/v (B,KH,S,D) with KH | H, query head h reads kv head h / (H/KH) with no
// repeated heads; scores scaled by 1/sqrt(D) in fp32; the running max m,
// the normaliser l and the output accumulator stay in fp32 (online
// softmax); masked scores are -1e30 and the denominator is clamped at
// 1e-30; the output is written in q's dtype.
//
// Two kernels, chosen by dtype:
//  * bf16 / fp16: `tc::swa_tc_kernel`, on the tensor cores (wgmma) fed by
//    TMA.  This is the prefill path of the port.
//  * fp32: `simt::swa_fwd_kernel`, fp32 FMAs on the CUDA cores.  wgmma takes
//    fp32 only as TF32 (10-bit mantissa), which would break fp32's 2e-5
//    agreement with the reference; no bf16 path runs it.
//
// What bounds it on this card.  At the serving prefill shape (B 4, H 32,
// KH 8, S 512, D 128, bf16, causal) the call needs ~8.6 GFLOP of products
// over 42 MB of q/k/v/o: ~205 flops per byte, under the H100's ~295 ridge,
// so its least time (12.5 us) is set by HBM bytes.  At a 4096-token prompt
// it is operation-bound: 1.4e11 FLOP, 139 us at 989 TFLOP/s of dense bf16.
// Either way only the tensor cores can get near the bound: the fp32 FMA
// kernel peaks at 67 TFLOP/s and reached ~16.
//
// The tensor-core design.
//  * Work shape.  One block of two warpgroups (256 threads) per (128-row q
//    tile, query head, batch row); each warpgroup owns 64 query rows.  The
//    k loop visits only the tiles of the live band
//    [max(0, q_lo - window + 1), q_last] and masks only on diagonal,
//    band-edge and ragged tiles.  Blocks are numbered heaviest causal tile
//    first (the last wave is short) and with the n_rep query heads of one
//    kv head adjacent (their K/V reads meet in L2).  A row's output depends
//    only on its own (batch, head, position) and its live keys: no split-KV,
//    no atomics, and tiles past a row's last key add exact zeros, so
//    neither B nor a padded S changes it by a bit.
//  * Products.  S = Q K^T is wgmma m64nBKk16 with Q and K K-major in shared
//    memory (BK = 128 keys at D <= 128, 64 at D 256).  O += P V is one
//    wgmma m64nDk16 per 16-key slice, A = P from registers, B = V MN-major
//    (D contiguous) with the transpose bit.  Accumulators are fp32.  The
//    scale (times log2 e, for ex2) multiplies the fp32 scores after the
//    product; P is rounded to the input dtype only as the A operand, and l
//    sums the unrounded fp32 probabilities.
//  * Overlap.  Tile i's Q K^T and tile i-1's P V are issued together; the
//    warpgroup waits for the first only (wait_group 1), runs tile i's
//    softmax on the CUDA cores while P V runs, then rescales O.  The two
//    warpgroups take turns to issue (named barriers), so one's products
//    overlap the other's softmax; ex2 alone costs half the products' time.
//  * Loads.  Thread 0 loads the Q tile once and keeps K and V tiles in two
//    rings of STAGES (3 at D <= 128) with their own full barriers (one
//    arrival plus the TMA transaction bytes) and empty barriers (one arrival
//    per warp after its last wgmma on the tile).  It issues between its own
//    products, so no producer warp is needed; a third warpgroup would cap
//    the kernel at 168 registers a thread, and with setmaxnreg raising the
//    consumers' share ptxas serialises the wgmmas (C7512, measured).
//    Tensor maps are 4-D, (D, S, H, B) with the caller's byte strides, so
//    (B,S,H,D) activations pass as transposed views; rows past S come in as
//    TMA's zero fill and are masked.  Shared memory at D 128: Q 32 KB +
//    3 x (K 32 KB + V 32 KB) = 224 KB, one block per SM.
//
// What was hard, and how it is resolved here.
//  * Swizzle.  Each tile is stored as D/CW chunks of CW = min(D, 64)
//    columns; a chunk row is CW*2 bytes and the TMA map swizzles by exactly
//    that span (128, 64 or 32 B), the layout type the wgmma descriptors name
//    (1, 2, 3).  A D-128 bf16 row (256 B) is two 64-column boxes.  Tiles
//    start on 1024-byte boundaries, so TMA's and wgmma's address-bit XORs
//    agree.
//  * Descriptor offsets.  K-major (Q, K): SBO = 8 rows x CW*2 bytes (the
//    next 8-row core group), LBO unused (1); the k-th 16-column slice of a
//    chunk starts (16 k mod CW)*2 bytes in.  MN-major (V): SBO = 8 keys x
//    CW*2 bytes (the next 8 keys along K), LBO = one chunk (the next CW
//    columns along N); the k-th 16-key slice starts 16 k rows down.
//  * Transpose bit.  imm-trans-b = 0 for K (K-major B of Q K^T), 1 for V
//    (MN-major B of P V); bf16 and fp16 allow it, tf32 would not.
//  * Fragments.  Accumulator register i of a thread holds row
//    16*warp + lane/4 + 8*((i/2)&1) and column 8*(i/4) + 2*(lane%4) + (i&1)
//    (PTX ISA, wgmma D fragment), so each thread owns two rows and a row's
//    max and sum reduce over the 4 lanes of a quad.  Registers 8j..8j+7 of
//    S, packed in pairs, are exactly the A fragment of P's 16-key slice j
//    (rows g, g+8 x columns 2t, 2t+8 of the k16 A layout).
//  * Ordering.  wgmma.fence before each issue (the accumulators and P were
//    last written by ordinary instructions), commit, wait_group 1 before S
//    is read and wait_group 0 before O or P are touched again, and an empty
//    compiler fence on those registers at each wait so no ordinary
//    instruction moves into the asynchronous window.
//  * Masked scores.  The SIMT kernel's -1e30 does not survive the fused
//    ex2(fma(s, scale, -m)): for a row whose keys so far are all masked,
//    m = round(-1e30 * scale) and the fma's exact product leaves a residual
//    of up to ~1e21, so ex2 gave inf and the later rescale inf * 0 = NaN
//    (seen at D 256 with a window).  -inf with the max taken as 0 where it
//    is subtracted gives exact zeros instead.
//  * Ring phases.  Tile t uses stage t % STAGES for the n-th time, n =
//    t / STAGES: consumers wait on the full barrier with parity n & 1, the
//    loader on the empty one with parity (n & 1) ^ 1, which passes at once
//    on a stage's first use.  A wait that never completes traps.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Strides {        // element strides of (batch, head, seq); dim is 1
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel (fp32 FMAs on the CUDA cores)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BLOCK_Q = 64;     // queries per thread block
constexpr int BLOCK_K = 32;     // keys per inner tile
constexpr int THREADS = 128;    // 16 row groups x 8 lanes
constexpr int ROWS_PER_THREAD = BLOCK_Q / 16;   // 4
constexpr int KCOLS_PER_THREAD = BLOCK_K / 8;   // 4
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// max / sum over the 8 lanes that hold one row's columns
__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}
__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, Strides qs,
               Strides ks, Strides vs, Strides os, int S, int n_rep,
               int window, int causal, float scale) {
  constexpr int DP = D + 1;            // padded row: conflict-free columns
  constexpr int COLS = D / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                               // BLOCK_Q x DP
  float* k_s = q_s + BLOCK_Q * DP;                 // BLOCK_K x DP
  float* v_s = k_s + BLOCK_K * DP;                 // BLOCK_K x D
  float* p_s = v_s + BLOCK_K * D;                  // BLOCK_Q x (BLOCK_K+1)

  const int tid = threadIdx.x;
  const int ty = tid >> 3;             // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;              // lane in group: cols tx + 8*j
  const int q_lo = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / n_rep;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < BLOCK_Q * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int pos = q_lo + r;
    q_s[r * DP + d] = pos < S ? to_f32(qb[pos * qs.s + d]) * scale : 0.f;
  }

  float m[ROWS_PER_THREAD], l[ROWS_PER_THREAD];
  float acc[ROWS_PER_THREAD][COLS];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;
  }

  // live band of keys for this q tile
  const int q_last = min(q_lo + BLOCK_Q, S) - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;

  for (int k_lo = (k_begin / BLOCK_K) * BLOCK_K; k_lo < k_end;
       k_lo += BLOCK_K) {
    __syncthreads();    // previous tile's k_s / v_s / p_s fully consumed
    for (int idx = tid; idx < BLOCK_K * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int pos = k_lo + r;
      const bool in = pos < S;
      k_s[r * DP + d] = in ? to_f32(kb[pos * ks.s + d]) : 0.f;
      v_s[r * D + d] = in ? to_f32(vb[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[ROWS_PER_THREAD][KCOLS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS_PER_THREAD; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS_PER_THREAD], kv[KCOLS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        qv[i] = q_s[(ty * ROWS_PER_THREAD + i) * DP + d];
#pragma unroll
      for (int j = 0; j < KCOLS_PER_THREAD; ++j) kv[j] = k_s[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS_PER_THREAD; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = ty * ROWS_PER_THREAD + i;
      const int qpos = q_lo + r;
      float tile_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS_PER_THREAD; ++j) {
        const int kpos = k_lo + tx + 8 * j;
        bool live = kpos < S;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        if (!live) s[i][j] = NEG_INF;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = group8_max(tile_max);
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS_PER_THREAD; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        p_s[r * (BLOCK_K + 1) + tx + 8 * j] = p;
      }
      row_sum = group8_sum(row_sum);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float pv[ROWS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        pv[i] = p_s[(ty * ROWS_PER_THREAD + i) * (BLOCK_K + 1) + kk];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float vv = v_s[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i)
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int qpos = q_lo + ty * ROWS_PER_THREAD + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      ob[qpos * os.s + tx + 8 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) +
                          BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int B, int H, int S, int n_rep, int window,
           int causal, float scale, cudaStream_t stream) {
  auto kernel = swa_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, S, n_rep,
      window, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                 const int64_t* st, int B, int H, int S, int n_rep,
                 int window, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BLOCK_Q = 128;          // query rows per block
constexpr int CONSUMERS = 2;          // warpgroups, 64 query rows each
// No producer warp: 65,536 registers over 256 threads leave each thread up
// to 255, and ptxas's wgmma pipeline keeps the products asynchronous.  (A
// third, producer warpgroup caps the kernel at 168 registers; setmaxnreg
// raises what the consumers may hold, but ptxas then serialises the
// wgmmas, C7512.)  Thread 0 issues the TMA loads between its own products.
constexpr int THREADS = CONSUMERS * 128;
constexpr float MASKED = -INFINITY;   // a masked score (see softmax)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;     // columns per chunk
  static constexpr int NCH = D / CW;             // chunks per row
  static constexpr int SWZ = CW * 2;             // chunk row bytes = swizzle
  static constexpr int BLOCK_K = D <= 128 ? 128 : 64;
  static constexpr int STAGES = D <= 128 ? 3 : 2;   // K/V ring depth
  static constexpr int Q_BYTES = BLOCK_Q * D * 2;
  static constexpr int KV_BYTES = BLOCK_K * D * 2;   // one of K, V
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES +
                              BAR_BYTES;
  static constexpr uint64_t LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static_assert(D % 16 == 0 && Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "tiles must keep 1024-byte alignment");
  static_assert(SMEM <= 232448, "one block must fit the SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete.  A wait that spins
// 2^24 times (seconds; a K/V stage takes microseconds) has lost an arrival:
// trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads/writes across the
// asynchronous wgmma region
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor (PTX ISA, wgmma matrix descriptor)
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Tile<D>::LAYOUT << 62);
}

#define ACC8(i)                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// SS: A and B from shared memory, both K-major.  RS: A from registers, B
// MN-major (transpose bit set).  scale_d 0 overwrites the accumulator.
#define WGMMA_SS_N64(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                              \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24) \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_SS_N128(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                              \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56) \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_RS_N16(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"    \
      : ACC8(0) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define WGMMA_RS_N32(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"    \
      : ACC8(0), ACC8(8) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define WGMMA_RS_N128(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"    \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define WGMMA_RS_N256(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                    \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "        \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"    \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 128) {
    if constexpr (BF) { WGMMA_SS_N128("bf16"); } else { WGMMA_SS_N128("f16"); }
  } else {
    static_assert(N == 64, "QK^T tiles are 64 or 128 keys");
    if constexpr (BF) { WGMMA_SS_N64("bf16"); } else { WGMMA_SS_N64("f16"); }
  }
}

template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t db) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const int scale_d = 1;
  if constexpr (N == 256) {
    if constexpr (BF) { WGMMA_RS_N256("bf16"); } else { WGMMA_RS_N256("f16"); }
  } else if constexpr (N == 128) {
    if constexpr (BF) { WGMMA_RS_N128("bf16"); } else { WGMMA_RS_N128("f16"); }
  } else if constexpr (N == 64) {
    if constexpr (BF) { WGMMA_RS_N64("bf16"); } else { WGMMA_RS_N64("f16"); }
  } else if constexpr (N == 32) {
    if constexpr (BF) { WGMMA_RS_N32("bf16"); } else { WGMMA_RS_N32("f16"); }
  } else {
    static_assert(N == 16, "P.V covers the whole head_dim: 16 to 256");
    if constexpr (BF) { WGMMA_RS_N16("bf16"); } else { WGMMA_RS_N16("f16"); }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// One consumer warpgroup's state: 64 query rows against the k tiles of the
// band.  Members, not lambdas, so every step is force-inlined and the
// arrays stay in registers.
template <typename T, int D>
struct Consumer {
  using L = Tile<D>;
  static constexpr int BK = L::BLOCK_K;
  static constexpr uint32_t SBO = 8 * L::SWZ;   // next 8-row core group

  float acc[D / 2];               // O, fp32
  float sc[BK / 2];               // scores of the current tile, then P
  uint32_t pa[BK / 16][4];        // P in T: the A fragments of P.V
  float m[2], l[2], alpha[2];     // per row: max (log2 domain), sum, rescale
  uint32_t q_wg;                  // this warpgroup's 64 rows of Q
  int S, wg_first, row0, quad, window, causal;
  float scale_log2;

  // S = Q K^T over D in k16 slices (issued and committed, not waited for)
  __device__ __forceinline__ void issue_qk(uint32_t ks) {
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = (kk * 16) / L::CW;
      const uint32_t off = ((kk * 16) % L::CW) * 2;
      mma_ss<T, BK>(sc,
                    make_desc<D>(q_wg + c * BLOCK_Q * L::SWZ + off, 16, SBO),
                    make_desc<D>(ks + c * BK * L::SWZ + off, 16, SBO),
                    kk > 0);
    }
    wg_commit();
  }

  // O += P V, one m64nDk16 wgmma per 16-key slice; B spans the D/CW
  // column chunks at LBO = one chunk
  __device__ __forceinline__ void issue_pv(uint32_t vs) {
    fence_acc();
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      mma_rs<T, D>(acc, pa[j],
                   make_desc<D>(vs + j * 16 * L::SWZ, BK * L::SWZ, SBO));
    wg_commit();
  }

  // keep acc and P in place while the tensor cores own them
  __device__ __forceinline__ void fence_acc() { reg_fence(acc); }
  __device__ __forceinline__ void fence_pa() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(pa[j][r]) :: "memory");
  }

  // online softmax of the tile at k_lo in the log2 domain: m, l and alpha
  // per row, P (fp32) in sc.  Masks only where the tile crosses the
  // diagonal, the band's left edge or S.  A masked score is -inf here
  // (the reference's -1e30 gives the same exact zero to every row that
  // has a live key, as each row below S has): ex2(-inf) is exactly 0, and
  // a row whose keys so far are all masked keeps m = -inf, l = 0, O = 0
  // (its max counts as 0 where it is subtracted, so nothing is inf - inf).
  __device__ __forceinline__ void softmax(int k_lo) {
    reg_fence(sc);
    const bool need_mask = k_lo + BK > S ||
                           (causal && k_lo + BK - 1 > wg_first) ||
                           (window > 0 && k_lo <= wg_first + 63 - window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = row0 + 8 * rr;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * rr + e;
          if (need_mask) {
            const int kpos = k_lo + 8 * j + 2 * quad + e;
            bool live = kpos < S;
            if (causal) live = live && kpos <= qpos;
            if (window > 0) live = live && kpos > qpos - window;
            if (!live) sc[idx] = MASKED;
          }
          mx = fmaxf(mx, sc[idx]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx * scale_log2);
      const float m_use = m_new == MASKED ? 0.f : m_new;
      alpha[rr] = ex2(m[rr] - m_use);
      m[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * rr + e;
          const float p = ex2(fmaf(sc[idx], scale_log2, -m_use));
          sc[idx] = p;
          sum += p;
        }
      l[rr] = l[rr] * alpha[rr] + sum;    // this thread's columns only
    }
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }

  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[j][r] = pack2<T>(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
  }

  // full row sums over the quad, normalise, store this thread's rows in T
  __device__ __forceinline__ void store(T* ob, int64_t row_stride) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int qpos = row0 + 8 * rr;
      if (qpos >= S) continue;
      T* orow = ob + qpos * row_stride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
            pack2<T>(acc[4 * j + 2 * rr] * inv, acc[4 * j + 2 * rr + 1] * inv);
    }
  }
};

// The K/V ring, seen from the thread that loads it and the warpgroups that
// read it.  Tile t lives in stage t % STAGES; its n-th use of the stage
// (n = t / STAGES) completes the full barrier's phase of parity n & 1, and
// the load waits for the release of the stage's previous tile, the empty
// barrier's phase of parity (n & 1) ^ 1 (which passes at once for n = 0).
template <int D>
struct Ring {
  using L = Tile<D>;
  uint32_t k_s, v_s, bars;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  int t_begin, n_tiles, kh, b;

  __device__ __forceinline__ uint32_t full_k(int t) const {
    return bars + 8u * (1 + t % L::STAGES);
  }
  __device__ __forceinline__ uint32_t full_v(int t) const {
    return bars + 8u * (1 + L::STAGES + t % L::STAGES);
  }
  __device__ __forceinline__ uint32_t empty_k(int t) const {
    return bars + 8u * (1 + 2 * L::STAGES + t % L::STAGES);
  }
  __device__ __forceinline__ uint32_t empty_v(int t) const {
    return bars + 8u * (1 + 3 * L::STAGES + t % L::STAGES);
  }
  __device__ __forceinline__ uint32_t k_tile(int t) const {
    return k_s + (t % L::STAGES) * L::KV_BYTES;
  }
  __device__ __forceinline__ uint32_t v_tile(int t) const {
    return v_s + (t % L::STAGES) * L::KV_BYTES;
  }
  __device__ __forceinline__ static uint32_t parity(int t) {
    return (t / L::STAGES) & 1;
  }

  // thread 0 only: start the loads of tile t's K or V, once its stage is free
  __device__ __forceinline__ void load(int t, bool v) const {
    if (t >= n_tiles) return;
    mbar_wait(v ? empty_v(t) : empty_k(t), parity(t) ^ 1);
    const uint32_t full = v ? full_v(t) : full_k(t);
    mbar_expect_tx(full, L::KV_BYTES);
    const uint32_t dst = v ? v_tile(t) : k_tile(t);
    const int k_lo = (t_begin + t) * L::BLOCK_K;
#pragma unroll 1
    for (int c = 0; c < L::NCH; ++c)
      tma_load(dst + c * L::BLOCK_K * L::SWZ, v ? tm_v : tm_k, full,
               c * L::CW, k_lo, kh, b);
  }
  // a warpgroup is done reading tile t's K or V (one arrival per warp)
  __device__ __forceinline__ void release(int t, bool v, int lane) const {
    if (lane == 0) mbar_arrive(v ? empty_v(t) : empty_k(t));
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
              Strides os, int B, int H, int S, int n_rep, int window,
              int causal, float scale_log2) {
  using L = Tile<D>;
  constexpr int BK = L::BLOCK_K;
  constexpr int AHEAD = L::STAGES - 1;   // K tiles in flight ahead
  extern __shared__ uint8_t smem_raw[];
  // shared memory: Q | K stages | V stages | barriers
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = q_s + L::Q_BYTES + 2 * L::STAGES * L::KV_BYTES;

  // heaviest causal q tile first; query head fastest, so the n_rep heads of
  // one kv head run side by side
  const int n_qt = (S + BLOCK_Q - 1) / BLOCK_Q;
  int id = blockIdx.x;
  const int h = id % H;
  id /= H;
  const int b = id % B;
  id /= B;
  const int qt = causal ? n_qt - 1 - id : id;
  const int q_lo = qt * BLOCK_Q;
  const int q_last = min(q_lo + BLOCK_Q, S) - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;

  Ring<D> ring;
  ring.k_s = q_s + L::Q_BYTES;
  ring.v_s = ring.k_s + L::STAGES * L::KV_BYTES;
  ring.bars = q_full;
  ring.tm_k = &tm_k;
  ring.tm_v = &tm_v;
  ring.t_begin = k_begin / BK;
  ring.n_tiles = (k_end + BK - 1) / BK - ring.t_begin;
  ring.kh = h / n_rep;
  ring.b = b;
  const int n_tiles = ring.n_tiles;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool loader = threadIdx.x == 0;
  if (loader) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(ring.full_k(s), 1);
      mbar_init(ring.full_v(s), 1);
      mbar_init(ring.empty_k(s), CONSUMERS * 4);
      mbar_init(ring.empty_v(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll 1
    for (int c = 0; c < L::NCH; ++c)
      tma_load(q_s + c * BLOCK_Q * L::SWZ, &tm_q, q_full, c * L::CW, q_lo, h,
               b);
    // K(0 .. AHEAD-1) and V(0 .. AHEAD-2) into empty stages
#pragma unroll 1
    for (int t = 0; t < AHEAD; ++t) {
      ring.load(t, false);
      if (t + 1 < AHEAD) ring.load(t, true);
    }
  }
  __syncthreads();

  Consumer<T, D> cw;
  const int wg = warp / 4;
  cw.S = S;
  cw.window = window;
  cw.causal = causal;
  cw.scale_log2 = scale_log2;
  cw.quad = lane & 3;
  cw.wg_first = q_lo + wg * 64;
  cw.row0 = cw.wg_first + (warp & 3) * 16 + (lane >> 2);   // and row0 + 8
  cw.q_wg = q_s + wg * 64 * L::SWZ;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) cw.acc[i] = 0.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    cw.m[rr] = MASKED;
    cw.l[rr] = 0.f;
  }

  // Tile i's Q K^T runs on the tensor cores with tile i-1's P V issued
  // behind it, while tile i's softmax runs on the CUDA cores.  The two
  // warpgroups take turns to issue (named barriers 1 and 2), so one's
  // products run while the other's softmax does.  After tile i's Q K^T,
  // thread 0 loads V(i + AHEAD - 1) and K(i + AHEAD): their stages were
  // released by both warpgroups a tile earlier.
  const uint32_t my_turn = 1 + wg, other_turn = 2 - wg;
  auto take_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" :: "r"(my_turn) : "memory");
  };
  auto pass_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(other_turn) : "memory");
  };
  if (wg == 1) pass_turn();              // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  mbar_wait(ring.full_k(0), 0);
  take_turn();
  cw.issue_qk(ring.k_tile(0));
  pass_turn();
  wg_wait<0>();
  ring.release(0, false, lane);
  if (loader) {
    ring.load(AHEAD - 1, true);
    ring.load(AHEAD, false);
  }
  __syncwarp();
  cw.softmax(ring.t_begin * BK);
  cw.pack_p();
#pragma unroll 1
  for (int i = 1; i < n_tiles; ++i) {
    mbar_wait(ring.full_k(i), Ring<D>::parity(i));
    mbar_wait(ring.full_v(i - 1), Ring<D>::parity(i - 1));
    take_turn();
    cw.issue_qk(ring.k_tile(i));
    cw.issue_pv(ring.v_tile(i - 1));
    pass_turn();
    wg_wait<1>();                       // Q K^T of tile i is done
    ring.release(i, false, lane);
    if (loader) {
      ring.load(i + AHEAD - 1, true);
      ring.load(i + AHEAD, false);
    }
    __syncwarp();
    cw.softmax((ring.t_begin + i) * BK);
    wg_wait<0>();                       // P V of tile i-1 is done
    cw.fence_acc();
    cw.fence_pa();
    ring.release(i - 1, true, lane);
    cw.rescale();
    cw.pack_p();
  }
  mbar_wait(ring.full_v(n_tiles - 1), Ring<D>::parity(n_tiles - 1));
  take_turn();
  cw.issue_pv(ring.v_tile(n_tiles - 1));
  pass_turn();
  if (wg == 0) take_turn();              // consume warpgroup 1's last pass
  wg_wait<0>();
  cw.fence_acc();
  cw.store(o + b * os.b + h * os.h, os.s);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D, S, heads, B) over a (B, heads, S, D) operand with element
// strides st = (batch, head, seq); boxes of CW columns x rows.
template <int D>
int encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt, int S,
           int heads, int B, const int64_t* st, int rows) {
  using L = Tile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CW, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::SWZ == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUresult r = fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // zero fill
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int B, int H, int S, int n_rep, int window,
           int causal, float scale, cudaStream_t stream) {
  using L = Tile<D>;
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  int err = encode<D>(&tq, q, dt, S, H, B, st + 0, BLOCK_Q);
  if (err == 0) err = encode<D>(&tk, k, dt, S, H / n_rep, B, st + 3, L::BLOCK_K);
  if (err == 0) err = encode<D>(&tv, v, dt, S, H / n_rep, B, st + 6, L::BLOCK_K);
  if (err != 0) return err;
  auto kernel = swa_tc_kernel<T, D>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const Strides os{st[9], st[10], st[11]};
  const int n_qt = (S + BLOCK_Q - 1) / BLOCK_Q;
  kernel<<<n_qt * H * B, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), os, B, H, S, n_rep, window, causal,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                 const int64_t* st, int B, int H, int S, int n_rep,
                 int window, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, B, H, S, n_rep, window, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, o in
// that order.  Each returns the CUDA error code of the launch (0 on
// success); the tensor-core entry returns -1 when the driver has no
// cuTensorMapEncodeTiled and -1000 - CUresult when it refuses a map.

// dtype 0 (float32): the SIMT kernel.
extern "C" int swa_attention_fwd_simt(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int dtype,
                                      int B, int H, int S, int D, int n_rep,
                                      int window, int causal, float scale,
                                      void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return simt::dispatch_dim<float>(D, q, k, v, o, strides, B, H, S, n_rep,
                                   window, causal, scale,
                                   static_cast<cudaStream_t>(stream));
}

// dtype: 1 bfloat16, 2 float16.  q, k, v 16-byte aligned with seq, head and
// batch strides in multiples of 16 bytes (TMA's rules; the wrapper checks).
extern "C" int swa_attention_fwd_tc(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int64_t* strides, int dtype, int B,
                                    int H, int S, int D, int n_rep,
                                    int window, int causal, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return tc::dispatch_dim<__nv_bfloat16>(D, q, k, v, o, strides, B, H, S, n_rep, window, causal, scale, st);
    case 2: return tc::dispatch_dim<__half>(D, q, k, v, o, strides, B, H, S, n_rep, window, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the tensor-core kernel at head_dim D (bytes)
extern "C" int swa_attention_tc_smem_bytes(int D) {
  switch (D) {
    case 16: return tc::Tile<16>::SMEM;
    case 32: return tc::Tile<32>::SMEM;
    case 64: return tc::Tile<64>::SMEM;
    case 128: return tc::Tile<128>::SMEM;
    case 256: return tc::Tile<256>::SMEM;
    default: return -1;
  }
}
