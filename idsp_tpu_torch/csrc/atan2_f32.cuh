// f32 full-circle atan2 returned as the i32 phase word (i32::MIN = -pi):
// the fast angle of the FM discriminator (K15 angle="fast").
//
// Device twin of `ops.trig.atan2_f32_word` and of the TPU kernel helper
// idsp_tpu/filters/ddc_pallas.py `atan2_f32_word` (:412, coefficients
// :405).  Every multiply, add and the divide is a single-rounding
// intrinsic (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`), issued
// in the plain version's order, so nvcc can neither contract a product
// into an FMA nor replace the divide by a reciprocal: kernel and plain
// version agree bit for bit.
//
// The 1e-38 divide guard lies below FLT_MIN (1.18e-38), in the
// subnormals.  It keeps its value only because the kernel library is
// built without `--use_fast_math` / `-ftz=true` (see _ext.NVCC_FLAGS):
// with flush-to-zero the guard would read as 0 and 0/0 would give NaN.
#pragma once

#include <cstdint>

namespace idsp {

__device__ __forceinline__ int32_t atan2_f32_word(float y, float x) {
  // np.float32 of the deg-13 odd fit (ops/trig.py _ATAN_F32_COEFFS)
  constexpr float kC[7] = {0x1.ffff9p-1f,   -0x1.552deep-2f, 0x1.95c648p-3f,
                           -0x1.0f4f1ap-3f, 0x1.46e7d8p-4f,  -0x1.1447f2p-5f,
                           0x1.c06eeap-8f};
  constexpr float kHalfPi = 0x1.921fb6p+0f;  // f32(pi / 2)
  constexpr float kPi = 0x1.921fb6p+1f;      // f32(pi)
  constexpr float kWord = 0x1.45f306p+29f;   // f32(2^31 / pi)
  constexpr float kGuard = 0x1.b38fb8p-127f;  // f32(1e-38), subnormal
  constexpr float kMaxWord = 0x1.fffffep+30f;  // largest f32 below 2^31
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float den = fmaxf(ax, ay);
  const float num = fminf(ax, ay);
  const float q = __fdiv_rn(num, fmaxf(den, kGuard));
  const float q2 = __fmul_rn(q, q);
  float p = kC[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, q2), kC[i]);
  float t = __fmul_rn(p, q);
  if (ay > ax) t = __fsub_rn(kHalfPi, t);
  if (x < 0.0f) t = __fsub_rn(kPi, t);
  if (y < 0.0f) t = -t;
  float w = __fmul_rn(t, kWord);
  // round half away from zero (the cast truncates), saturating at +pi
  w = __fadd_rn(w, w >= 0.0f ? 0.5f : -0.5f);
  w = fminf(w, kMaxWord);
  return __float2int_rz(w);
}

}  // namespace idsp
