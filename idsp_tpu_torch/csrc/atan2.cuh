// Full-circle fixed-point atan2 as a device function (src/atan2.rs:6-82),
// bit-identical to `ops.trig.atan2` and to the TPU kernel helper
// idsp_tpu/filters/ddc_pallas.py `atan2_i32` (:375, with `_divi_kernel`
// and `_atani_kernel`), which emulated the 64-bit products in 16-bit
// limbs; here they are native 32x32->64 multiplies.
//
// The signed 32 x 32 -> 64 products are `mul_wide`'s one instruction
// each (as a product of sign-extended words nvcc made four).
//
// Octant reduction with saturating negation (i32::MIN -> i32::MAX) and
// an XOR unmap key; y/x in Q31 by a reciprocal seeded from a 16-entry
// base/slope LUT and one Newton step; atan by an odd polynomial in
// Q32<32> Horner form.  The LUT is luts.atan2_divi_table() (build.rs:
// 43-67) in __constant__ memory: every thread of a warp reads its own
// entry, so the reads serialize over the distinct indices of the warp;
// a kept row needs two such reads.  A kernel that takes an angle on every
// row copies the LUT to shared memory (`load_atan2_lut`) and passes a
// `SharedLut`: its 32 words sit in 32 distinct banks, so a warp's reads
// of one table take one pass.
#pragma once

#include <cstdint>

#include "df1.cuh"  // mul_wide
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

// the seed LUT read from __constant__ memory
struct ConstLut {
  __device__ __forceinline__ uint32_t base(uint32_t i) const {
    return kBase[i];
  }
  __device__ __forceinline__ int32_t slope(uint32_t i) const {
    return kSlope[i];
  }
};

// the seed LUT read from a shared-memory copy (`load_atan2_lut`)
struct SharedLut {
  const uint32_t* b;
  const int32_t* s;
  __device__ __forceinline__ uint32_t base(uint32_t i) const { return b[i]; }
  __device__ __forceinline__ int32_t slope(uint32_t i) const { return s[i]; }
};

// y/x in Q31 for 0 <= y <= x (src/atan2.rs:12-29); 0 for x == 0.
// Branch-free (selects only), so a caller's unrolled rows schedule
// together.
template <class Lut>
__device__ __forceinline__ uint32_t divi(uint32_t y, uint32_t x0,
                                         const Lut& lut) {
  const uint32_t x = x0 ? x0 : 1u;
  const int shift = __clz(static_cast<int>(x));
  y <<= shift;
  const uint32_t xn = x << shift;
  const uint32_t rem = xn & ((1u << kFracBits) - 1);
  const uint32_t idx = (xn << 1) >> (1 + kFracBits);
  const uint32_t step = static_cast<uint32_t>(
      mul_wide(lut.slope(idx), static_cast<int32_t>(rem)) >> kFracBits);
  const uint32_t r0 = lut.base(idx) + step;  // wrapping u32 add
  const uint32_t r = mul_q31(y, mul_q31(r0, 0u - mul_q31(xn, r0)));
  return x0 ? r : 0u;
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
    const int32_t hi =
        static_cast<int32_t>(static_cast<uint32_t>(mul_wide(r, x2) >> 32));
    r = wadd32(hi, kAtani[i]);
  }
  return static_cast<uint32_t>((int64_t{r} * int64_t{x}) >> 28);
}

}  // namespace atan2_detail

// Copy the seed LUT to shared memory (16 + 16 words) with the block's
// first 16 threads; the caller synchronizes the block before using it.
__device__ __forceinline__ atan2_detail::SharedLut load_atan2_lut(
    uint32_t* base, int32_t* slope) {
  if (threadIdx.x < 16) {
    base[threadIdx.x] = atan2_detail::kBase[threadIdx.x];
    slope[threadIdx.x] = atan2_detail::kSlope[threadIdx.x];
  }
  return atan2_detail::SharedLut{base, slope};
}

// atan2(y, x) of i32: the circle maps to i32, i32::MIN = -pi (== +pi)
template <class Lut = atan2_detail::ConstLut>
__device__ __forceinline__ int32_t atan2_i32(int32_t y, int32_t x,
                                             const Lut& lut = Lut{}) {
  // saturating |v| (i32::MIN -> i32::MAX), as selects
  auto sat_abs = [](int32_t v) {
    const int32_t neg = static_cast<int32_t>(0u - static_cast<uint32_t>(v));
    return v == INT32_MIN ? INT32_MAX : (v < 0 ? neg : v);
  };
  uint32_t k = y < 0 ? 0xFFFFFFFFu : 0u;
  k ^= x < 0 ? 0x7FFFFFFFu : 0u;
  const int32_t ay = sat_abs(y);
  const int32_t ax = sat_abs(x);
  const bool swap = ay > ax;
  k ^= swap ? 0x3FFFFFFFu : 0u;
  const uint32_t r = atan2_detail::atani(atan2_detail::divi(
      static_cast<uint32_t>(swap ? ax : ay),
      static_cast<uint32_t>(swap ? ay : ax), lut));
  return static_cast<int32_t>(r ^ k);
}

}  // namespace idsp
