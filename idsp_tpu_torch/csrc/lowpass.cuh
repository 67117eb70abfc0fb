// Shared device code of K4 and K6: one lane of the integer Lowpass<N>
// (N = 1 or 2), lowpass.rs:48-77, bit-identical to `lowpass.step`.
//
// The state is N int64 words.  The input subtraction saturates in i32;
// every int64 sum wraps and is formed in uint64 (seq_bank.cuh wadd64);
// `>> 32` of a signed word is arithmetic, as in the JAX package.
#pragma once

#include <cstdint>

#include "seq_bank.cuh"

namespace idsp {

struct LpGains {
  int32_t k0, k1;  // k1 is unused for N = 1
};

template <int N>
struct LowpassLane {
  static_assert(N == 1 || N == 2, "Lowpass<N> exists for N = 1, 2");
  int64_t p0, p1;

  // state rows as in LowpassState.p (lanes, N)
  __device__ __forceinline__ void load(const int64_t* p, int lane) {
    p0 = p[N * lane];
    p1 = N == 2 ? p[N * lane + 1] : 0;
  }

  __device__ __forceinline__ void store(int64_t* p, int lane) const {
    p[N * lane] = p0;
    if constexpr (N == 2) p[N * lane + 1] = p1;
  }

  __device__ __forceinline__ int32_t step(const LpGains& g, int32_t x) {
    // x - (p0 >> 32) saturating in i32 (lowpass.rs:55), in 32 bits as
    // lowpass_pallas.py:33-39: the wrapped difference overflowed iff x
    // and hi0 differ in sign and the difference's sign differs from x's
    const int32_t hi0 = static_cast<int32_t>(p0 >> 32);
    const int32_t r = static_cast<int32_t>(static_cast<uint32_t>(x) -
                                           static_cast<uint32_t>(hi0));
    const int32_t e = ((x ^ hi0) & (x ^ r)) < 0
                          ? (x >= 0 ? INT32_MAX : INT32_MIN)
                          : r;
    int64_t d = int64_t{e} * g.k0;
    if constexpr (N == 1) {
      p0 = wadd64(p0, d);
      const int32_t y = static_cast<int32_t>(p0 >> 32);
      p0 = wadd64(p0, d);
      return y;
    } else {
      // (p1 >> 32) * k1 is an i32 x i32 product: exact in int64
      d = wadd64(d, (p1 >> 32) * int64_t{g.k1});
      p1 = wadd64(p1, d);
      p0 = wadd64(p0, p1);
      const int32_t y = static_cast<int32_t>(p0 >> 32);
      p0 = wadd64(p0, p1);
      p1 = wadd64(p1, d);
      return y;
    }
  }
};

}  // namespace idsp
