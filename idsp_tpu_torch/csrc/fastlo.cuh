// Shared device code of K3 and K6: the coarse/fine fast-LO conjugate
// mix of one input sample (ops/fastlo.py `fastlo_mix_tables`; the TPU
// kernels' prologue idsp_tpu/filters/ddc_pallas.py `_fastlo_mix_chunk`
// :487):
//
//   xh    = x * AMPLITUDE
//   lo_re = ca*cb - sa*sb,  lo_im = sa*cb + ca*sb
//   I     = round_half_away(lo_re * xh)
//   Q     = round_half_away(-(lo_im * xh))
//
// with (ca, sa) the chunk's coarse factor and (cb, sb) the row's fine
// factor.  Every f32 operation is one __f*_rn intrinsic in the plain
// version's order, so nvcc cannot contract a*b - c*d into an FMA and
// the result matches eager PyTorch bit for bit.
#pragma once

#include <cstdint>

namespace idsp {

// (2^31 - 2^15) / 2^32, exact in f32 (ops/fastlo.py AMPLITUDE)
constexpr float kFastLoAmplitude = 0.5f - 1.0f / 131072.0f;

__device__ __forceinline__ float fastlo_scale(int32_t x) {
  return __fmul_rn(static_cast<float>(x), kFastLoAmplitude);
}

// the products before rounding: lo_re * xh (I) and -(lo_im * xh) (Q)
__device__ __forceinline__ float fastlo_prod_i(float ca, float sa, float cb,
                                               float sb, float xh) {
  return __fmul_rn(__fsub_rn(__fmul_rn(ca, cb), __fmul_rn(sa, sb)), xh);
}

__device__ __forceinline__ float fastlo_prod_q(float ca, float sa, float cb,
                                               float sb, float xh) {
  return -__fmul_rn(__fadd_rn(__fmul_rn(sa, cb), __fmul_rn(ca, sb)), xh);
}

// the mixed sample: the product rounded half away from zero to i32.
// ops/fastlo.round_half_away computes floor(v + 0.5) for v >= 0 and
// -floor(-v + 0.5) below; f32 addition is symmetric in sign, so both
// are trunc(v + copysign(0.5, v)): one add and one truncating convert.
__device__ __forceinline__ int32_t fastlo_round(float v) {
  return __float2int_rz(__fadd_rn(v, copysignf(0.5f, v)));
}

}  // namespace idsp
