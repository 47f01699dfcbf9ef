// Banded (causal and/or sliding-window) flash attention, forward only, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/swa_attention.py.
//
// Replaces the Pallas TPU kernel `_swa_kernel` / `swa_attention_pallas`
// (src/repro/kernels/swa_attention.py).  Same semantics: q (B,H,S,D),
// k/v (B,KH,S,D) with KH | H, query head h reads kv head h / (H/KH) with no
// repeated heads; q is scaled by 1/sqrt(D) in fp32; the running max m, the
// normaliser l and the output accumulator stay in fp32 (online softmax);
// masked scores are -1e30 and the denominator is clamped at 1e-30; the
// output is written in q's dtype.
//
// What bounds it on this card.  At the serving prefill shape (B 4, H 32,
// KH 8, S 512, D 128, bf16, causal) the call needs ~8.6 GFLOP of products
// over 42 MB of q/k/v/o: ~205 flops per byte, under the H100's ~295 ridge,
// so its least time (12.5 us) is set by HBM bytes; with a longer prompt it
// turns operation-bound.  This first version multiplies with fp32 FMAs on
// the CUDA cores (no tensor cores), so its own limit is the FMA issue rate,
// far above both bounds; a wgmma/TMA version is later work.
//
// What the design does about it.
//  * One thread block per (q-tile, head, batch) — the TPU grid's
//    sequential k dimension becomes a loop inside the block, and the loop
//    visits only the k-tiles of the live band
//    [max(0, q_lo - window + 1), q_hi] instead of predicating dead tiles.
//  * The q tile is loaded once (pre-scaled, fp32) and reused against every
//    k/v tile from shared memory; k/v tiles are shared by all 64 queries of
//    the tile, so each k/v element is read from HBM once per q-tile.
//  * Scores, probabilities and the accumulator never leave the SM: scores
//    live in registers, the row max/sum are warp-shuffle reductions over
//    the 8 lanes that share a row, and P goes through one small shared
//    tile into the P.V product.
//  * Rows and keys past S are masked in the kernel, so S need not divide
//    the tile; strides are arguments, so (B,S,H,D) views need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;     // queries per thread block
constexpr int BLOCK_K = 32;     // keys per inner tile
constexpr int THREADS = 128;    // 16 row groups x 8 lanes
constexpr int ROWS_PER_THREAD = BLOCK_Q / 16;   // 4
constexpr int KCOLS_PER_THREAD = BLOCK_K / 8;   // 4
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
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

struct Strides {        // element strides of (batch, head, seq); dim is 1
  int64_t b, h, s;
};

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

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  strides: 12 int64 element
// strides, (batch, head, seq) for q, k, v, o in that order.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, const int64_t* strides, int dtype,
                                 int B, int H, int S, int D, int n_rep,
                                 int window, int causal, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(D, q, k, v, o, strides, B, H, S, n_rep, window, causal, scale, st);
    case 1: return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, strides, B, H, S, n_rep, window, causal, scale, st);
    case 2: return dispatch_dim<__half>(D, q, k, v, o, strides, B, H, S, n_rep, window, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
