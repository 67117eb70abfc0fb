// Shared device code of K5 and K6/K13: one channel of the type-2, order-3
// PLL (pll.rs:90-107), bit-identical to `pll.step`; K5's serial warp
// (`PllSerial`) on df1_ring.cuh's depth-0 pipeline.
//
// The carried words are those of PllState: clamp.x0, clamp.clamp (i8),
// z0, y0, f0 (i64), f (i64) and y.  Signed overflow is undefined in C++,
// so every wrapping i32/i64 sum of the update is formed in uint32/uint64
// (wadd32/wadd64) and the wrap detector's difference too: written on
// signed ints, ((xi - x0) >= 0) - (xi >= x0) may be folded to 0 by the
// compiler, and the PLL would never see a wrap.
//
// The plain order (`PllLane::step`, K6/K13's back end) runs every
// operation on the loop-carried chain: y += hi(f), xi = x + y, the wrap's
// subtract and two compares, the clamp, ze >> 1, the Nyquist zero, four
// 64-bit adds of the lead-lag, f += f0.  The sums wrap mod 2^32 and 2^64,
// so they may be regrouped and every word keeps the plain bits
// (`PllLane::step_grouped`): the lead-lag's part that waits on no new
// phase (V = f0 + b1 y0 + a1 hi(f0) + (a1 lo(f0)) >> 32, W = f + V), x +
// y, the wrap's threshold x0 ^ INT32_MIN and what each outcome of its
// compare picks are formed beside the chain; on it, xi takes hi(f) with
// one add, one compare of xi gives the wrap, y0 is picked among two
// saturated candidates and (xi >> 1) + z0, and f = b0 y0 + W is a 64-bit
// multiply-add.
#pragma once

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"
#include "seq_bank.cuh"

namespace idsp {

struct PllCoefs {
  int32_t b0, b1, a1;  // Q32<32> lead-lag
};

// Device pointers of the seven state words, in the order
// x0, clamp, z0, y0, f0, f, y (int32 except clamp: int8, f0, f: int64).
struct PllWords {
  void* p[7];
};

// y0' of `PllLane::step_grouped`'s chain: flag = (xi < t) != (xneg !=
// 0); where flag, (xi >> 1) + z0 if m1 else k1, where not, (xi >> 1) + z0
// if m0 else k0.  In PTX the flag is one compare with its xor and each pick
// a select on a predicate: written in C++, the compiler kept the bools as
// 0/1 words and compared them again on the chain.
__device__ __forceinline__ int32_t pll_pick(int32_t xi, int32_t t,
                                            int32_t xneg, bool m1, bool m0,
                                            int32_t k1, int32_t k0,
                                            int32_t z0) {
#ifdef __CUDA_ARCH__
  int32_t y;
  asm("{\n\t.reg .pred q, p, r1, r0;\n\t.reg .s32 cx, u1, u0;\n\t"
      "setp.ne.s32 q, %3, 0;\n\t"
      "setp.ne.s32 r1, %4, 0;\n\t"
      "setp.ne.s32 r0, %5, 0;\n\t"
      "setp.lt.xor.s32 p, %1, %2, q;\n\t"
      "shr.s32 cx, %1, 1;\n\t"
      "add.s32 cx, cx, %8;\n\t"
      "selp.s32 u1, cx, %6, r1;\n\t"
      "selp.s32 u0, cx, %7, r0;\n\t"
      "selp.s32 %0, u1, u0, p;\n\t}"
      : "=r"(y)
      : "r"(xi), "r"(t), "r"(xneg), "r"(int32_t{m1}), "r"(int32_t{m0}),
        "r"(k1), "r"(k0), "r"(z0));
  return y;
#else
  const int32_t cx = wadd32(xi >> 1, z0);
  return (xi < t) != (xneg != 0) ? (m1 ? cx : k1) : (m0 ? cx : k0);
#endif
}

// x + y + h as one PTX sum the compiler cannot regroup: written in C++,
// x + (y + h) shared y' = y + h's add and put two adds on the chain.
__device__ __forceinline__ int32_t add3(int32_t x, int32_t y, int32_t h) {
#ifdef __CUDA_ARCH__
  int32_t d;
  asm("{\n\t.reg .s32 t;\n\tadd.s32 t, %1, %2;\n\tadd.s32 %0, t, %3;\n\t}"
      : "=r"(d) : "r"(x), "r"(y), "r"(h));
  return d;
#else
  return wadd32(wadd32(x, y), h);
#endif
}

struct PllLane {
  int32_t x0, cl, z0, y0, y;
  int64_t f0, f;

  __device__ __forceinline__ void load(const PllWords& w, int ch) {
    x0 = static_cast<const int32_t*>(w.p[0])[ch];
    cl = static_cast<const int8_t*>(w.p[1])[ch];
    z0 = static_cast<const int32_t*>(w.p[2])[ch];
    y0 = static_cast<const int32_t*>(w.p[3])[ch];
    f0 = static_cast<const int64_t*>(w.p[4])[ch];
    f = static_cast<const int64_t*>(w.p[5])[ch];
    y = static_cast<const int32_t*>(w.p[6])[ch];
  }

  __device__ __forceinline__ void store(const PllWords& w, int ch) const {
    static_cast<int32_t*>(w.p[0])[ch] = x0;
    static_cast<int8_t*>(w.p[1])[ch] = static_cast<int8_t>(cl);
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

  // `step` with its sums regrouped (the header's note): the same words.
  // The wrap compare: with t = x0 ^ INT32_MIN (x0 - 2^31 for x0 >= 0,
  // x0 + 2^31 below), wrap is +1 where x0 >= 0 and xi < t, -1 where x0 < 0
  // and xi >= t, else 0; so one compare of xi, flag = (xi < t) != (x0 <
  // 0), gives s = cl + wrap: s1 = cl + (x0 < 0 ? -1 : 1) where flag, cl
  // where not.  With h = hi(f),
  //   xi = (x + y) + h, y' = y + h,
  //   y0' = (INT32_MIN >> 1) + z0 (s < 0), (INT32_MAX >> 1) + z0 (s > 0),
  //         (xi >> 1) + z0 (s = 0): each flag's pick known before xi,
  //   V = f0 + b1 y0 + a1 hi(f0) + (a1 lo(f0)) >> 32,
  //   f0' = b0 y0' + V,  f' = b0 y0' + (f + V),
  //   cl' = clamp(s, -1, 1), z0' = y0' - z0, x0' = xi.
  __device__ __forceinline__ int32_t step_grouped(const PllCoefs& k,
                                                  int32_t x) {
    // off the chain: what waits on no new phase
    const int32_t t = x0 ^ INT32_MIN;
    const int32_t xneg = x0 >> 31;  // -1 where x0 < 0
    const int32_t s1 = cl + (xneg | 1);
    const int32_t ca = wadd32(z0, INT32_MIN >> 1);
    const int32_t cb = wadd32(z0, INT32_MAX >> 1);
    // V as (a1 hi(f0) + f0m) + uh + b1 y0: f0m is f0 with lo(f0) cleared
    // where a1 < 0 and uh the unsigned high product umulhi(a1, lo(f0)),
    // whose sum is f0 + (a1 lo(f0)) >> 32; the products a tree beside
    // f0's words (of the groupings timed, PERF.md §6, the fastest)
    const int64_t f0m = static_cast<int64_t>(
        static_cast<uint64_t>(f0) &
        ~static_cast<uint64_t>(k.a1 < 0 ? 0xFFFFFFFFu : 0u));
    const int64_t uh = static_cast<int64_t>(__umulhi(
        static_cast<uint32_t>(k.a1), static_cast<uint32_t>(f0)));
    const int64_t v = wadd64(
        wadd64(mad_wide(k.a1, static_cast<int32_t>(f0 >> 32), f0m), uh),
        mul_wide(k.b1, y0));
    const int64_t w = wadd64(f, v);
    // the chain: hi(f) into the phase, one compare, y0's pick, f
    const int32_t h = static_cast<int32_t>(f >> 32);
    const int32_t xi = add3(x, y, h);
    const int32_t y0n =
        pll_pick(xi, t, xneg, s1 == 0, cl == 0, s1 < 0 ? ca : cb,
                 cl < 0 ? ca : cb, z0);
    f = mad_wide(k.b0, y0n, w);
    f0 = mad_wide(k.b0, y0n, v);
    y = wadd32(y, h);
    cl = (xi < t) != (xneg != 0) ? max(-1, min(1, s1)) : cl;
    x0 = xi;
    z0 = static_cast<int32_t>(static_cast<uint32_t>(y0n) -
                              static_cast<uint32_t>(z0));
    y0 = y0n;
    return y;
  }
};

// K5's launch-wide PLL arguments: the state words in and out, the
// coefficients.
struct PllArgs {
  PllWords in, out;
  PllCoefs k;
};

// The PLL serial warp (`run_pipe`'s serial functor): lane `lane`'s state
// in registers (zero on a dead lane, which stores nothing); each row's
// phase from the input ring (this lane's column), y into the output ring,
// in groups of kGroup rows read a group ahead (`group_rows`), by the
// regrouped step; the state out after the last row.
struct PllSerial {
  const ring::Pipe* p;
  const PllArgs* a;

  __device__ __forceinline__ void operator()(const ring::Rings& R,
                                             uint32_t* out, int lid,
                                             int lane, bool live,
                                             uint32_t) const {
    using ring::kLanes;
    const PllCoefs k = a->k;
    PllLane s{};
    if (live) s.load(a->in, lane);
    const int chunk = p->d.chunk;
    ring::serial_chunks(p->d.t, chunk, p->d.depth, R, [&](int slot,
                                                          int rows) {
      const int32_t* in = R.in_slot(slot) + lid;
      int32_t* o = reinterpret_cast<int32_t*>(out) +
                   static_cast<size_t>(slot) * chunk * kLanes + lid;
      ring::group_rows(
          rows, [&](int r) { return in[r * kLanes]; },
          [&](int r, int32_t x) { o[r * kLanes] = s.step_grouped(k, x); });
    });
    if (live) s.store(a->out, lane);
  }
};

}  // namespace idsp
