// Shared device code of the DDC-chain kernels: the Q<f> DF1 biquad step.
//
// y0 = (b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2) >> f   (biquad.rs:366-383)
//
// Each i32 x i32 product is exact in int64; the five-term sum wraps
// mod 2^64 and is formed in uint64, where wrapping is defined.  The
// shift is arithmetic (truncating toward -inf), and the result keeps
// the low 32 bits: bit-identical to the scan `df1_process_q`.
#pragma once

#include <cstdint>

namespace idsp {

struct Df1Coefs {
  int32_t b0, b1, b2, a1, a2;
  int f;
};

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

  __device__ __forceinline__ int32_t step(const Df1Coefs& k, int32_t x0) {
    const uint64_t acc = static_cast<uint64_t>(int64_t{k.b0} * x0) +
                         static_cast<uint64_t>(int64_t{k.b1} * x1) +
                         static_cast<uint64_t>(int64_t{k.b2} * x2) +
                         static_cast<uint64_t>(int64_t{k.a1} * y1) +
                         static_cast<uint64_t>(int64_t{k.a2} * y2);
    const int32_t y0 = static_cast<int32_t>(static_cast<uint32_t>(
        static_cast<uint64_t>(static_cast<int64_t>(acc) >> k.f)));
    x2 = x1;
    x1 = x0;
    y2 = y1;
    y1 = y0;
    return y0;
  }
};

}  // namespace idsp
