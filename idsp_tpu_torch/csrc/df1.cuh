// Shared device code of the DDC-chain kernels: the Q<f> DF1 biquad step,
// the Q64 multiply-add and the f32 coefficients.
//
// y0 = (b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2) >> f   (biquad.rs:366-383)
//
// Each i32 x i32 product is exact in int64; the five-term sum wraps
// mod 2^64 and is formed in uint64, where wrapping is defined.  The
// shift is arithmetic (truncating toward -inf), and the result keeps
// the low 32 bits: bit-identical to the scan `df1_process_q`.  The
// anti-windup form (`Df1Clamp`) adds the offset and clamps before the
// output is fed back (the clamped value is both the result and the next
// y1; the unclamped one goes nowhere): bit-identical to
// `df1_clamp_process_q`.
//
// The wide-state DF1, which keeps each fed-back output as a full int64
// word, is K25/K32's serial warp (df1_ring.cuh `Df1WideSerial`).
//
// Another rung of the reference's precision ladder: Q64 (`mac_q64`, int64
// storage, 128-bit sums), bit-identical to its plain scan
// (`df1_process_q64`).  The Q16 DF1 is K28's serial warp
// (biquad_precision.cu `Q16Serial`), the error-feedback DF1 K31/K33's
// (df1_ring.cuh `Df1WSerial` with its dither flag), the f32 DF1 K16's and
// K30's (df1_ring.cuh `Df1F32Serial`: each product and each sum a
// single-rounding intrinsic, left to right, so nvcc cannot contract them
// into FMAs; bit-identical to the plain `df1_process`).
#pragma once

#include <cstddef>
#include <cstdint>

namespace idsp {

struct Df1Coefs {
  int32_t b0, b1, b2, a1, a2;
  int f;
};

// The anti-windup clamp of the reference's production biquad
// (`BiquadClamp`, biquad.rs:394-404): y0 + u at the summing junction,
// wrapping as int32 addition does (formed in uint32: signed overflow is
// undefined in C++), then min(max(v, lo), hi), jnp.clip's order, so
// lo > hi gives hi.
struct Df1Clamp {
  int32_t u, lo, hi;

  __device__ __forceinline__ int32_t operator()(int32_t y0) const {
    const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(y0) +
                                           static_cast<uint32_t>(u));
    return min(max(v, lo), hi);
  }
};

// a * b + c on 64-bit words, wrapping mod 2^64 (the product of two int32
// is exact in int64; the add wraps as PTX's integer add does)
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b,
                                            int64_t c) {
#ifdef __CUDA_ARCH__
  int64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
#else
  return static_cast<int64_t>(static_cast<uint64_t>(int64_t{a} * b) +
                              static_cast<uint64_t>(c));
#endif
}

// a * b as a 64-bit word (exact: the product of two int32 fits int64),
// one signed 32 x 32 -> 64 multiply (`mul.wide.s32`)
__device__ __forceinline__ int64_t mul_wide(int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
  int64_t d;
  asm("mul.wide.s32 %0, %1, %2;" : "=l"(d) : "r"(a), "r"(b));
  return d;
#else
  return int64_t{a} * b;
#endif
}

// a * b + c, unsigned 32 x 32 -> 64 plus a 64-bit word, wrapping mod
// 2^64 (`mad.wide.u32`)
__device__ __forceinline__ uint64_t mad_wide_u32(uint32_t a, uint32_t b,
                                                 uint64_t c) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
#else
  return uint64_t{a} * b + c;
#endif
}

// a * b, unsigned 32 x 32 -> 64 (`mul.wide.u32`)
__device__ __forceinline__ uint64_t mul_wide_u32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(d) : "r"(a), "r"(b));
  return d;
#else
  return uint64_t{a} * b;
#endif
}

struct Df1Lane {
  int32_t x1, x2, y1, y2;

  // state rows as in Df1State: x (lanes, 2) = [x1, x2], y = [y1, y2]
  __device__ __forceinline__ void load(const int32_t* sx, const int32_t* sy,
                                       int lane) {
    x1 = sx[2 * lane];
    x2 = sx[2 * lane + 1];
    y1 = sy[2 * lane];
    y2 = sy[2 * lane + 1];
  }

  __device__ __forceinline__ void store(int32_t* sx, int32_t* sy,
                                        int lane) const {
    sx[2 * lane] = x1;
    sx[2 * lane + 1] = x2;
    sy[2 * lane] = y1;
    sy[2 * lane + 1] = y2;
  }

  // y0 of the next step, before the delay lines move
  __device__ __forceinline__ int32_t output(const Df1Coefs& k,
                                            int32_t x0) const {
    const uint64_t acc = static_cast<uint64_t>(int64_t{k.b0} * x0) +
                         static_cast<uint64_t>(int64_t{k.b1} * x1) +
                         static_cast<uint64_t>(int64_t{k.b2} * x2) +
                         static_cast<uint64_t>(int64_t{k.a1} * y1) +
                         static_cast<uint64_t>(int64_t{k.a2} * y2);
    return static_cast<int32_t>(static_cast<uint32_t>(
        static_cast<uint64_t>(static_cast<int64_t>(acc) >> k.f)));
  }

  // output() with a1*y1, the only term on the recurrence's loop-carried
  // chain, added last: the other four products need only x0 and older
  // outputs, so they are summed off the chain, which keeps one 64-bit
  // multiply-add and the shift.  Each product-and-add is one signed
  // 32 x 32 + 64 -> 64 multiply-add (`mad_wide`; nvcc made each product
  // of sign-extended words four instructions); the sums wrap mod 2^64,
  // where addition is associative and commutative: the same bits as
  // output().
  __device__ __forceinline__ int32_t output_y1_last(const Df1Coefs& k,
                                                    int32_t x0) const {
    const int64_t pre = mad_wide(
        k.b0, x0, mad_wide(k.b1, x1, mad_wide(k.b2, x2,
                                              mad_wide(k.a2, y2, 0))));
    return static_cast<int32_t>(static_cast<uint32_t>(
        static_cast<uint64_t>(mad_wide(k.a1, y1, pre) >> k.f)));
  }

  __device__ __forceinline__ int32_t push(int32_t x0, int32_t y0) {
    x2 = x1;
    x1 = x0;
    y2 = y1;
    y1 = y0;
    return y0;
  }

  __device__ __forceinline__ int32_t step(const Df1Coefs& k, int32_t x0) {
    return push(x0, output(k, x0));
  }
};

// The reference's Q64 (`Q<i64, i128, f>`, dsp-fixedpoint/src/lib.rs:
// 473-492): int64 taps and coefficients, each product the full signed
// 128-bit one, the five summed mod 2^128, the output the low 64 bits of
// the arithmetic >> f.  K29 (biquad_precision.cu) splits the sum: its
// producer warps form b0*x0 + b1*x1 + b2*x2, its serial warp adds a2*y2
// and a1*y1 (`mac_q64`); the sum wraps mod 2^128, where addition is
// associative, so every split gives the same bits.
//
// A coefficient as `mac_q64` takes it: its bits, and all ones where it is
// negative.
struct Q64Coef {
  uint64_t bits, neg;

  static __host__ __device__ Q64Coef of(int64_t v) {
    return Q64Coef{static_cast<uint64_t>(v), v < 0 ? ~uint64_t{0} : 0};
  }
};

// (hi:lo) += c * y mod 2^128, c and y signed 64-bit.  With C, Y the
// unsigned readings of their bits, c * y = C * Y - 2^64 (C [y < 0] + Y
// [c < 0]) mod 2^128; C * Y is four 32 x 32 -> 64 products of 32-bit
// limbs, side by side, summed by columns: bits 0-31 one multiply-add, bits
// 32-63 (m) under 2^34, bits 64-127 mod 2^64 (the high product takes hi
// less the correction as its addend).
__device__ __forceinline__ void mac_q64(uint64_t& lo, uint64_t& hi,
                                        const Q64Coef& c, uint64_t y) {
  const uint32_t yl = static_cast<uint32_t>(y);
  const uint32_t yh = static_cast<uint32_t>(y >> 32);
  const uint32_t cl = static_cast<uint32_t>(c.bits);
  const uint32_t ch = static_cast<uint32_t>(c.bits >> 32);
  const uint64_t sign = static_cast<uint64_t>(static_cast<int64_t>(y) >> 63);
  const uint64_t corr = (c.bits & sign) + (y & c.neg);
  const uint64_t p00 = mad_wide_u32(yl, cl, static_cast<uint32_t>(lo));
  const uint64_t p01 = mul_wide_u32(yl, ch);
  const uint64_t p10 = mul_wide_u32(yh, cl);
  const uint64_t p11 = mad_wide_u32(yh, ch, hi - corr);
  const uint64_t m = (p00 >> 32) + (lo >> 32) + static_cast<uint32_t>(p01) +
                     static_cast<uint32_t>(p10);
  hi = p11 + (p01 >> 32) + (p10 >> 32) + (m >> 32);
  lo = (m << 32) | static_cast<uint32_t>(p00);
}

// The f32 DF1's coefficients (K16, K30).
struct Df1CoefsF32 {
  float b0, b1, b2, a1, a2;
};

}  // namespace idsp
