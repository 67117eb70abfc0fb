// Shared device code of K5 and K6: one channel of the type-2, order-3
// PLL (pll.rs:90-107), bit-identical to `pll.step`.
//
// The carried words are those of PllState: clamp.x0, clamp.clamp (i8 in
// the state, widened to i32 here by the wrapper), z0, y0, f0 (i64),
// f (i64) and y.  Signed overflow is undefined in C++, so every wrapping
// i32/i64 sum of the update is formed in uint32/uint64 (wadd32/wadd64)
// and the wrap detector's difference too: written on signed ints,
// ((xi - x0) >= 0) - (xi >= x0) may be folded to 0 by the compiler,
// and the PLL would never see a wrap.
#pragma once

#include <cstdint>

#include "seq_bank.cuh"

namespace idsp {

struct PllCoefs {
  int32_t b0, b1, a1;  // Q32<32> lead-lag
};

// Device pointers of the seven state words, in the order
// x0, clamp, z0, y0, f0, f, y (int32 except f0, f: int64).
struct PllWords {
  void* p[7];
};

struct PllLane {
  int32_t x0, cl, z0, y0, y;
  int64_t f0, f;

  __device__ __forceinline__ void load(const PllWords& w, int ch) {
    x0 = static_cast<const int32_t*>(w.p[0])[ch];
    cl = static_cast<const int32_t*>(w.p[1])[ch];
    z0 = static_cast<const int32_t*>(w.p[2])[ch];
    y0 = static_cast<const int32_t*>(w.p[3])[ch];
    f0 = static_cast<const int64_t*>(w.p[4])[ch];
    f = static_cast<const int64_t*>(w.p[5])[ch];
    y = static_cast<const int32_t*>(w.p[6])[ch];
  }

  __device__ __forceinline__ void store(const PllWords& w, int ch) const {
    static_cast<int32_t*>(w.p[0])[ch] = x0;
    static_cast<int32_t*>(w.p[1])[ch] = cl;
    static_cast<int32_t*>(w.p[2])[ch] = z0;
    static_cast<int32_t*>(w.p[3])[ch] = y0;
    static_cast<int64_t*>(w.p[4])[ch] = f0;
    static_cast<int64_t*>(w.p[5])[ch] = f;
    static_cast<int32_t*>(w.p[6])[ch] = y;
  }

  // One update on the input phase x; returns the new output phase y.
  __device__ __forceinline__ int32_t step(const PllCoefs& k, int32_t x) {
    // NCO advance: y += f >> 32 (the frequency high word)
    y = wadd32(y, static_cast<int32_t>(f >> 32));
    // wrap-clamped phase error (unwrap.rs:184-194), halved
    const int32_t xi = wadd32(x, y);
    const int32_t delta = static_cast<int32_t>(static_cast<uint32_t>(xi) -
                                               static_cast<uint32_t>(x0));
    const int32_t wrap = int32_t{delta >= 0} - int32_t{xi >= x0};
    cl = max(-1, min(1, cl + wrap));
    const int32_t ze = cl < 0 ? INT32_MIN : (cl > 0 ? INT32_MAX : xi);
    const int32_t z0n = ze >> 1;
    // Nyquist zero
    const int32_t y0n = wadd32(z0n, z0);
    // lead-lag: f0 += b0*y0 + b1*y0_old + a1*(f0 >> 32)
    //                 + ((a1 * f0_lo) >> 32), f0_lo the u32 low word
    // (pll.rs:99-102); every product is exact in int64 (|a1| <= 2^31)
    const int64_t f0_lo = static_cast<int64_t>(static_cast<uint32_t>(f0));
    int64_t acc = wadd64(f0, int64_t{k.b0} * y0n);
    acc = wadd64(acc, int64_t{k.b1} * y0);
    acc = wadd64(acc, int64_t{k.a1} * (f0 >> 32));
    acc = wadd64(acc, (int64_t{k.a1} * f0_lo) >> 32);
    f0 = acc;
    // DC pole
    f = wadd64(f, f0);
    x0 = xi;
    z0 = z0n;
    y0 = y0n;
    return y;
  }
};

}  // namespace idsp
