// Host AdamW update over fp32 state, split over threads.
//
// The host Adam of the offloaded trainer (core/optimizer.py adam_update):
// master, m and v live in host staging buffers and are updated in place.
// Every element gets the reference's float32 operations in the
// reference's order (src/repro/core/optimizer.py, numpy):
//
//   m *= b1; t = g * (1 - b1); m += t;
//   v *= b2; t = g * g; t *= (1 - b2); v += t;
//   d = v / bias2; d = sqrt(d); d += eps;
//   u = m / bias1; u /= d; [t = p * wd; u += t;] u *= lr; p -= u;
//
// Each of those is one correctly rounded IEEE operation, so the result is
// the numpy loop's bits whatever the vector width: the file is compiled
// with -ffp-contract=off (no fused multiply-add) and without -ffast-math
// (no reassociation, no flush to zero).  -fno-math-errno only lets the
// square root vectorize; it changes no value.
//
// The loop is compiled three times, for the x86-64 baseline (SSE2), AVX2
// and AVX-512F, and the entry picks the widest the CPU has at run time, so
// one build runs on any x86-64 host.  [0, n) is split into contiguous
// ranges whose bounds are multiples of 16 elements (64 bytes), one a
// thread; the calling thread takes the last.  Plain C interface, no
// PyTorch headers: kernels/host_adam.py loads it with ctypes, which
// releases the GIL for the whole call.

#include <cmath>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Consts {
  float b1, omb1, b2, omb2, bias1, bias2, eps, wd, lr;
};

// always_inline: each ISA's range function gets its own vectorized copy
template <bool kDecay>
__attribute__((always_inline)) inline void adam_body(
    float* __restrict p, const float* __restrict g, float* __restrict m,
    float* __restrict v, int64_t lo, int64_t hi, const Consts c) {
  for (int64_t i = lo; i < hi; ++i) {
    const float gi = g[i];
    float mi = m[i] * c.b1;
    float t = gi * c.omb1;
    mi = mi + t;
    float vi = v[i] * c.b2;
    t = gi * gi;
    t = t * c.omb2;
    vi = vi + t;
    float d = vi / c.bias2;
    d = std::sqrt(d);
    d = d + c.eps;
    float u = mi / c.bias1;
    u = u / d;
    if (kDecay) {
      t = p[i] * c.wd;
      u = u + t;
    }
    u = u * c.lr;
    p[i] = p[i] - u;
    m[i] = mi;
    v[i] = vi;
  }
}

using RangeFn = void (*)(float*, const float*, float*, float*, int64_t,
                         int64_t, Consts);

#define HOST_ADAM_RANGE(NAME, ATTR)                                         \
  ATTR void NAME(float* p, const float* g, float* m, float* v, int64_t lo, \
                 int64_t hi, Consts c) {                                    \
    if (c.wd != 0.0f)                                                       \
      adam_body<true>(p, g, m, v, lo, hi, c);                               \
    else                                                                    \
      adam_body<false>(p, g, m, v, lo, hi, c);                              \
  }

HOST_ADAM_RANGE(range_base, )
#if defined(__x86_64__)
HOST_ADAM_RANGE(range_avx2, __attribute__((target("avx2"))))
HOST_ADAM_RANGE(range_avx512, __attribute__((target("avx512f"))))
#endif

// isa: 0 the baseline, 1 AVX2, 2 AVX-512F; nullptr where the CPU lacks it
RangeFn range_for(int isa) {
  switch (isa) {
    case 0:
      return range_base;
#if defined(__x86_64__)
    case 1:
      return __builtin_cpu_supports("avx2") ? range_avx2 : nullptr;
    case 2:
      return __builtin_cpu_supports("avx512f") ? range_avx512 : nullptr;
#endif
    default:
      return nullptr;
  }
}

int best_isa() {
  for (int isa = 2; isa > 0; --isa)
    if (range_for(isa) != nullptr) return isa;
  return 0;
}

constexpr int64_t kAlign = 16;  // elements: 64 bytes, one AVX-512 vector

int run(RangeFn fn, float* p, const float* g, float* m, float* v, int64_t n,
        Consts c, int threads) {
  if (threads < 1) threads = 1;
  const int64_t blocks = (n + kAlign - 1) / kAlign;
  if (threads > blocks) threads = static_cast<int>(blocks > 0 ? blocks : 1);
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  int64_t lo = 0;
  for (int k = 0; k < threads - 1; ++k) {
    const int64_t hi = (blocks * (k + 1) / threads) * kAlign;
    try {
      pool.emplace_back(fn, p, g, m, v, lo, hi, c);
    } catch (const std::system_error&) {
      break;  // no thread to be had: the caller takes the rest
    }
    lo = hi;
  }
  fn(p, g, m, v, lo, n, c);
  for (auto& t : pool) t.join();
  return static_cast<int>(pool.size()) + 1;
}

}  // namespace

extern "C" {

// In-place AdamW step on n fp32 elements with the widest ISA the CPU has.
// The constants are the float32 values numpy casts the Python floats to;
// bias1 and bias2 are 1 - beta**step, computed in double and then cast.
// Returns the number of threads that ran (at most `threads`).
int host_adam_f32(float* p, const float* g, float* m, float* v, int64_t n,
                  float b1, float omb1, float b2, float omb2, float bias1,
                  float bias2, float eps, float weight_decay, float lr,
                  int threads) {
  const Consts c{b1, omb1, b2, omb2, bias1, bias2, eps, weight_decay, lr};
  return run(range_for(best_isa()), p, g, m, v, n, c, threads);
}

// The same step on a named ISA (0 baseline, 1 AVX2, 2 AVX-512F), for the
// tests that hold the bits independent of it; -1 where the CPU lacks it.
int host_adam_f32_isa(int isa, float* p, const float* g, float* m, float* v,
                      int64_t n, float b1, float omb1, float b2, float omb2,
                      float bias1, float bias2, float eps, float weight_decay,
                      float lr, int threads) {
  const RangeFn fn = range_for(isa);
  if (fn == nullptr) return -1;
  const Consts c{b1, omb1, b2, omb2, bias1, bias2, eps, weight_decay, lr};
  return run(fn, p, g, m, v, n, c, threads);
}

int host_adam_best_isa() { return best_isa(); }

}  // extern "C"
