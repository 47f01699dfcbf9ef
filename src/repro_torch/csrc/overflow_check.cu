// Fused gradient-overflow screen for Hopper (sm_90a): OR into a device flag
// whether any element of a contiguous fp32 / bf16 / fp16 region is Inf or
// NaN, by the all-ones-exponent test (paper Algorithm 1).
//
// Replaces the Pallas TPU kernel `_overflow_kernel` / `overflow_check_pallas`
// (src/repro/kernels/overflow_check.py).  That kernel walks a zero-padded
// (block_m, 128) tiling on a sequential grid and carries the flag from one
// grid step to the next; none of that is needed here.
//
// Bound: bytes.  One pass reads each element once (n * elem_bytes) and
// does a mask and a compare per element, far below the card's integer rate,
// so the least time is n * elem_bytes / 3.35 TB/s.  The design spends
// nothing beyond that read:
//   * a grid-stride loop of 16-byte vector loads (4 fp32 or 8 bf16/fp16
//     words a load), four loads in flight per thread, over the 16-byte-
//     aligned body of the region; the unaligned head and the tail (fewer
//     than 8 elements each) are read as scalars, so a region whose edges
//     fall mid-vector needs no padding and no copy;
//   * one block-wide vote (__syncthreads_or) and at most one atomicOr into
//     the int32 flag per block;
//   * each block reads the flag at entry and returns at once if it is
//     already set: the reference's "skip once flagged", across the blocks
//     of later launches that OR into the same flag.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// repro_torch/kernels/overflow_check.py.  The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

template <int ES>
__device__ __forceinline__ bool word_hit(uint32_t w, uint32_t mask) {
  if (ES == 4) return (w & mask) == mask;
  // two 16-bit elements in one 32-bit word
  return ((w & mask) == mask) | (((w >> 16) & mask) == mask);
}

template <int ES>
__device__ __forceinline__ bool vec_hit(const uint4& v, uint32_t mask) {
  return word_hit<ES>(v.x, mask) | word_hit<ES>(v.y, mask) |
         word_hit<ES>(v.z, mask) | word_hit<ES>(v.w, mask);
}

template <int ES>
__device__ __forceinline__ bool elem_hit(const unsigned char* p, long long i,
                                         uint32_t mask) {
  const uint32_t w =
      ES == 4 ? reinterpret_cast<const uint32_t*>(p)[i]
              : static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(p)[i]);
  return (w & mask) == mask;
}

// p: first element of the region; n elements of ES bytes; the first `head`
// elements precede the 16-byte-aligned body of `nvec` uint4 words, and the
// elements after the body form the tail.
template <int ES>
__global__ void __launch_bounds__(kThreads)
overflow_kernel(const unsigned char* __restrict__ p, long long n,
                long long head, long long nvec, uint32_t mask,
                int* __restrict__ flag) {
  __shared__ int flagged;
  if (threadIdx.x == 0) flagged = *reinterpret_cast<volatile int*>(flag);
  __syncthreads();
  if (flagged) return;  // uniform across the block

  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint4* body = reinterpret_cast<const uint4*>(p + head * ES);
  bool hit = false;

  long long i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) hit |= vec_hit<ES>(v[u], mask);
  }
  for (; i < nvec; i += stride) hit |= vec_hit<ES>(__ldg(body + i), mask);

  const long long tail0 = head + nvec * (16 / ES);
  const long long n_scalar = head + (n - tail0);
  for (long long j = tid; j < n_scalar; j += stride) {
    hit |= elem_hit<ES>(p, j < head ? j : tail0 + (j - head), mask);
  }

  if (__syncthreads_or(hit) && threadIdx.x == 0) atomicOr(flag, 1);
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

}  // namespace

// OR into *flag (device int32) whether any of the n elements of elem_bytes
// (4: fp32, 2: bf16/fp16) at x is Inf/NaN under `mask` (0x7F800000 fp32,
// 0x7F80 bf16, 0x7C00 fp16).  x must be aligned to elem_bytes.
extern "C" int overflow_flag(const void* x, long long n, int elem_bytes,
                             unsigned int mask, int* flag, void* stream) {
  if (n <= 0) return 0;
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % elem_bytes) return cudaErrorMisalignedAddress;
  long long head = static_cast<long long>((16 - (addr & 15)) & 15) /
                   elem_bytes;
  if (head > n) head = n;
  const long long per_vec = 16 / elem_bytes;
  const long long nvec = (n - head) / per_vec;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const unsigned char* p = static_cast<const unsigned char*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    overflow_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, n, head, nvec, mask, flag);
  } else {
    overflow_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, n, head, nvec, mask, flag);
  }
  return static_cast<int>(cudaGetLastError());
}
