// Shared device code of K3, K6 and K12/K13: the coarse/fine fast-LO
// conjugate mix of one input sample (ops/fastlo.py `fastlo_mix_tables`;
// the TPU kernels' prologue idsp_tpu/filters/ddc_pallas.py
// `_fastlo_mix_chunk` :487):
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
//
// `fastlo_mix_rows` is the producer warp of K3 (ddc_cascade.cu) and of
// K12/K13 (ddc_bank.cu): the mixed rows of a depth-0 pipeline's input
// ring (df1_ring.cuh); `load_lo_rows` its loads, which K16's producers
// (ddc_lockin.cu, the same coarse/fine factorisation) share.
#pragma once

#include <cstddef>
#include <cstdint>

#include "df1_ring.cuh"
#include "hopper.cuh"

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

// The mixed sample of x with the coarse factor co = (ca, sa) and the fine
// factor fi = (cb, sb): `fastlo_prod_i` (I) or `fastlo_prod_q` (Q),
// rounded.  With u, v = ca, sa (I) or sa, ca (Q), u*cb -+ v*sb is lo_re
// or lo_im (a subtraction is the addition of the negated term, the same
// rounding), so a warp whose lanes are I and Q lanes (K12/K13's tiles)
// runs one sequence of operations.
__device__ __forceinline__ int32_t fastlo_mix(int32_t x, float2 co, float2 fi,
                                              bool is_q) {
  const float u = is_q ? co.y : co.x, v = is_q ? co.x : co.y;
  const float p = __fmul_rn(u, fi.x), q = __fmul_rn(v, fi.y);
  const float prod = __fmul_rn(__fadd_rn(p, is_q ? q : -q), fastlo_scale(x));
  return fastlo_round(is_q ? -prod : prod);
}

// A block's mix inputs: x (t,) i32, the coarse factors (ca, sa) (t / tc, c)
// and the fine factors (cb, sb) (tc, c), each pair one float2.
struct FastLoPlanes {
  const int32_t* x;
  const float2 *coarse, *fine;
  int c, tc;
};

// The plane offsets of `load_lo_rows` fit an int: the coarse plane's
// (t / tc, c) pairs and the fine plane's (tc, c) pairs.
__host__ __device__ inline bool fastlo_offsets_ok(int t, int tc, int c) {
  return static_cast<int64_t>(t / tc) * c < INT32_MAX &&
         static_cast<int64_t>(tc) * c < INT32_MAX;
}

// A batch of B consecutive rows of a block's mix inputs for one lane: x
// and the two LO factors a row (K3, K12/K13: int32 x; K16: f32 x).
template <int B, class X>
struct LoRows {
  X x[B];
  float2 co[B], fi[B];
};

// Rows g0 .. g0 + B - 1 (0 <= g0 < t; rows past t repeat row t - 1) of x
// and of the factor planes at this lane's column (co, fi): row g's
// coarse factor is pair g / tc, its fine factor pair g % tc.  A batch
// within one coarse block (every lane of the warp alike) loads its coarse
// pair once and its fine pairs a plane row apart; another counts the
// rows' indices as they advance.
template <int B, class X>
__device__ __forceinline__ void load_lo_rows(LoRows<B, X>& b, const X* x,
                                             const float2* co,
                                             const float2* fi, int c, int tc,
                                             int t, int g0) {
  const int kq = g0 / tc, fb = g0 - kq * tc;
  if (fb + B <= tc) {
    const float2 cv = __ldg(co + kq * c);
    const float2* f = fi + fb * c;
#pragma unroll
    for (int v = 0; v < B; ++v) {
      b.x[v] = __ldg(x + min(g0 + v, t - 1));
      b.co[v] = cv;
      b.fi[v] = __ldg(f + v * c);
    }
  } else {
    int k = kq, r = fb;
#pragma unroll
    for (int v = 0; v < B; ++v) {
      b.x[v] = __ldg(x + min(g0 + v, t - 1));
      b.co[v] = __ldg(co + k * c);
      b.fi[v] = __ldg(fi + r * c);
      const bool step = g0 + v + 1 < t;
      const bool wrap = step && r + 1 == tc;
      r = wrap ? 0 : r + step;
      k += wrap;
    }
  }
}

// Producer pw of P: its span of each chunk of a depth-0 pipeline (t rows,
// chunks of `chunk` rows, `depth` slots; df1_ring.cuh `span_batches`, in
// batches of kFastLoMix rows, the next batch loaded while one is mixed)
// into the input ring's column lid: channel ch's I sample, or its Q
// sample with is_q (`load_lo_rows`; the planes `fastlo_offsets_ok`).  A
// dead lane (not live) reads channel 0's factors and writes 0.
constexpr int kFastLoMix = 8;
__device__ __forceinline__ void fastlo_mix_rows(const FastLoPlanes& m, int t,
                                                int chunk, int depth,
                                                const ring::Rings& R, int P,
                                                int pw, int lid, int ch,
                                                bool is_q, bool live) {
  using Rows = LoRows<kFastLoMix, int32_t>;
  const int32_t* x = m.x;
  const int c = m.c, tc = m.tc, cl = live ? ch : 0;
  const float2 *co = m.coarse + cl, *fi = m.fine + cl;  // this lane's
  ring::span_batches<kFastLoMix, Rows>(
      t, chunk, depth, P, pw, R,
      [&](const ring::Batch& b, Rows& n, const Rows&, bool) {
        if (b.r0 < t) load_lo_rows(n, x, co, fi, c, tc, t, b.r0 + b.r);
      },
      [&](const ring::Batch& b, const Rows& n, int slot) {
        int32_t* s = R.in_slot(slot) + lid;
#pragma unroll
        for (int v = 0; v < kFastLoMix; ++v)
          if (b.r + v < b.hi)
            s[(b.r + v) * ring::kLanes] =
                live ? fastlo_mix(n.x[v], n.co[v], n.fi[v], is_q) : 0;
      });
}

}  // namespace idsp
