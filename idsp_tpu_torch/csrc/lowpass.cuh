// Shared device code of K4 and K6: the serial warp of the integer
// Lowpass<N> (N = 1 or 2), lowpass.rs:48-77, bit-identical to
// `lowpass.step`, on df1_ring.cuh's depth-0 pipeline.
//
// The state is N int64 words.  The input subtraction saturates in i32;
// every int64 sum wraps and is formed in uint64; `>> 32` of a signed word
// is arithmetic, as in the JAX package.
//
// The plain order runs every operation on the loop-carried chain: e = x
// -sat (p0 >> 32), d = e k0 + (p1 >> 32) k1, p1 += d, p0 += p1, y = p0 >>
// 32, p0 += p1, p1 += d.  The sums wrap mod 2^64, so they may be
// regrouped and every word keeps the plain bits (`lp_step`): the part of
// d that waits on no e is formed beside the subtract.  e k0 can be 2^62,
// so every sum is formed mod 2^64.
#pragma once

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"

namespace idsp {

struct LpGains {
  int32_t k0, k1;  // k1 is unused for N = 1
};

// The Lowpass serial warp's launch-wide arguments: the state p (lanes, N)
// int64 in and out, and the gains.
struct LpArgs {
  const int64_t* p_in;
  int64_t* p_out;
  LpGains g;
};

// x - hi saturating in i32 (lowpass.rs:55 `saturating_sub`).
__device__ __forceinline__ int32_t sat_sub(int32_t x, int32_t hi) {
#ifdef __CUDA_ARCH__
  int32_t e;
  asm("sub.sat.s32 %0, %1, %2;" : "=r"(e) : "r"(x), "r"(hi));
  return e;
#else
  const int64_t e = int64_t{x} - hi;
  return static_cast<int32_t>(e > INT32_MAX ? INT32_MAX
                              : e < INT32_MIN ? INT32_MIN : e);
#endif
}

// One row: x in, the state words p0 (and p1 for N = 2) updated, y out,
// with e = x -sat (p0 >> 32), E = e k0 (each product a wide multiply or
// multiply-add):
//   N = 1:  y = (p0 + E) >> 32,  p0' = (p0 + E) + E;
//   N = 2:  q = (p1 + (p1 >> 32) k1) + E, the plain order's p1 + d,
//           y = (p0 + q) >> 32,  p0' = p0 + q + q,  p1' = q + q - p1
// (p0' = p0 + 2 p1 + 2 d, p1' = p1 + 2 d).  p1 + (p1 >> 32) k1 waits on
// no e: the chain from p0's high word to the next is the subtract, its
// saturation, E's multiply and the adds of q onto p0.  Of the forms timed
// on the H100 (among them p0' = (p0 + 2 p1 + 2 D) + 2 E with multiply-adds
// by 2 k0 and 2 k1, 2 E formed before the subtract is known and then
// selected, and the saturation as a clamp) these ran fastest (PERF.md §6).
template <int N>
__device__ __forceinline__ int32_t lp_step(int32_t x, uint64_t& p0,
                                           uint64_t& p1, int32_t k0,
                                           int32_t k1) {
  const int32_t e = sat_sub(x, static_cast<int32_t>(p0 >> 32));
  uint64_t y;
  if constexpr (N == 1) {
    const uint64_t E = static_cast<uint64_t>(mul_wide(e, k0));
    y = p0 + E;
    p0 = y + E;
  } else {
    const uint64_t v = static_cast<uint64_t>(mad_wide(
        static_cast<int32_t>(p1 >> 32), k1, static_cast<int64_t>(p1)));
    const uint64_t q =
        static_cast<uint64_t>(mad_wide(e, k0, static_cast<int64_t>(v)));
    y = p0 + q;
    p0 = p0 + q + q;
    p1 = q + q - p1;
  }
  return static_cast<int32_t>(y >> 32);
}

// The serial warp (`run_roles`' serial functor): state row `row` of
// a.p_in in registers (zero on a dead lane, which stores nothing); each
// row's x from the input ring (this lane's column), y into the output
// ring, in groups of kGroup rows read a group ahead (`group_rows`); the
// state to a.p_out after the last row.  K4 calls it with the tile's lane
// as the row, K6 with the paired lane's state row (I: ch, Q: c + ch).
template <int N>
struct LpSerial {
  static_assert(N == 1 || N == 2, "Lowpass<N> exists for N = 1, 2");
  const ring::Pipe* p;
  const LpArgs* a;

  __device__ __forceinline__ void operator()(const ring::Rings& R,
                                             uint32_t* out, int lid, int row,
                                             bool live, uint32_t) const {
    using ring::kLanes;
    const int32_t k0 = a->g.k0, k1 = a->g.k1;
    uint64_t p0 = 0, p1 = 0;
    if (live) {
      p0 = static_cast<uint64_t>(a->p_in[N * row]);
      if constexpr (N == 2) p1 = static_cast<uint64_t>(a->p_in[N * row + 1]);
    }
    const int chunk = p->d.chunk;
    ring::serial_chunks(p->d.t, chunk, p->d.depth, R, [&](int slot,
                                                          int rows) {
      const int32_t* in = R.in_slot(slot) + lid;
      int32_t* o = reinterpret_cast<int32_t*>(out) +
                   static_cast<size_t>(slot) * chunk * kLanes + lid;
      ring::group_rows(
          rows, [&](int r) { return in[r * kLanes]; },
          [&](int r, int32_t x) {
            o[r * kLanes] = lp_step<N>(x, p0, p1, k0, k1);
          });
    });
    if (live) {
      a->p_out[N * row] = static_cast<int64_t>(p0);
      if constexpr (N == 2) a->p_out[N * row + 1] = static_cast<int64_t>(p1);
    }
  }
};

}  // namespace idsp
