// Full-circle fixed-point atan2 as a device function (src/atan2.rs:6-82),
// bit-identical to `ops.trig.atan2` and to the TPU kernel helper
// idsp_tpu/filters/ddc_pallas.py `atan2_i32` (:375, with `_divi_kernel`
// and `_atani_kernel`), which emulated the 64-bit products in 16-bit
// limbs; here they are native 32x32->64 multiplies.
//
// Octant reduction with saturating negation (i32::MIN -> i32::MAX) and
// an XOR unmap key; y/x in Q31 by a reciprocal seeded from a 16-entry
// base/slope LUT and one Newton step; atan by an odd polynomial in
// Q32<32> Horner form.  The LUT is luts.atan2_divi_table() (build.rs:
// 43-67) in __constant__ memory: every thread of a warp reads its own
// entry, so the reads serialize over the distinct indices of the warp;
// a kept row needs two such reads.
#pragma once

#include <cstdint>

#include "seq_bank.cuh"

namespace idsp {
namespace atan2_detail {

// luts.atan2_divi_table() (held equal to it by the CPU tests)
static __constant__ uint32_t kBase[16] = {
    0x80000000u, 0x78787878u, 0x71C71C72u, 0x6BCA1AF3u,
    0x66666666u, 0x61861862u, 0x5D1745D1u, 0x590B2164u,
    0x55555555u, 0x51EB851Fu, 0x4EC4EC4Fu, 0x4BDA12F7u,
    0x49249249u, 0x469EE584u, 0x44444444u, 0x42108421u};
static __constant__ int32_t kSlope[16] = {
    -126322568, -112286727, -100467071, -90420364,
    -81808901,  -74371728,  -67904621,  -62245903,
    -57266231,  -52861136,  -48945496,  -45449389,
    -42314949,  -39493952,  -36945955,  -34636833};
constexpr int kFracBits = 27;  // 31 - ATAN2_DIVI_DEPTH

// (x*y) >> 31 of two u32, low 32 bits (src/atan2.rs:6-9)
__device__ __forceinline__ uint32_t mul_q31(uint32_t x, uint32_t y) {
  return static_cast<uint32_t>((static_cast<uint64_t>(x) * y) >> 31);
}

// y/x in Q31 for 0 <= y <= x (src/atan2.rs:12-29); 0 for x == 0
__device__ __forceinline__ uint32_t divi(uint32_t y, uint32_t x) {
  if (x == 0) return 0;
  const int shift = __clz(static_cast<int>(x));
  y <<= shift;
  const uint32_t xn = x << shift;
  const uint32_t rem = xn & ((1u << kFracBits) - 1);
  const uint32_t idx = (xn << 1) >> (1 + kFracBits);
  const uint32_t step = static_cast<uint32_t>(
      (int64_t{kSlope[idx]} * int64_t{rem}) >> kFracBits);
  const uint32_t r0 = kBase[idx] + step;  // wrapping u32 add
  return mul_q31(y, mul_q31(r0, 0u - mul_q31(xn, r0)));
}

// atan on the first octant, x u32 Q31 in [0, 1] (src/atan2.rs:32-48)
__device__ __forceinline__ uint32_t atani(uint32_t x) {
  // odd polynomial, Q32<32> (src/atan2.rs:33-40; ops/trig.py _ATANI)
  constexpr int32_t kAtani[6] = {0x0517C2CD, -0x06C6496B, 0x0FBDB021,
                                 -0x25B32E0A, 0x43B34C81, -0x3BC823DD};
  // (x*x) >> 32 as the JAX package forms it: int64 product, arithmetic
  // shift, low 32 bits
  const int64_t xx = static_cast<int64_t>(static_cast<uint64_t>(x) * x);
  const int32_t x2 = static_cast<int32_t>(static_cast<uint32_t>(xx >> 32));
  int32_t r = 0;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    // Q32<32> multiply: widen, >> 32, truncate to i32; wrapping add
    const int32_t hi = static_cast<int32_t>(
        static_cast<uint32_t>((int64_t{r} * x2) >> 32));
    r = wadd32(hi, kAtani[i]);
  }
  return static_cast<uint32_t>((int64_t{r} * int64_t{x}) >> 28);
}

}  // namespace atan2_detail

// atan2(y, x) of i32: the circle maps to i32, i32::MIN = -pi (== +pi)
__device__ __forceinline__ int32_t atan2_i32(int32_t y, int32_t x) {
  uint32_t k = 0;
  if (y < 0) {
    y = y == INT32_MIN ? INT32_MAX : -y;
    k ^= 0xFFFFFFFFu;
  }
  if (x < 0) {
    x = x == INT32_MIN ? INT32_MAX : -x;
    k ^= 0x7FFFFFFFu;
  }
  if (y > x) {
    const int32_t s = y;
    y = x;
    x = s;
    k ^= 0x3FFFFFFFu;
  }
  const uint32_t r = atan2_detail::atani(atan2_detail::divi(
      static_cast<uint32_t>(y), static_cast<uint32_t>(x)));
  return static_cast<int32_t>(r ^ k);
}

}  // namespace idsp
