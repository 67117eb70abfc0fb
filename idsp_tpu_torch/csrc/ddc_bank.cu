// K6, K12 and K13: the BASELINE #5 per-channel stack in one kernel:
// fast-LO conjugate mix, a channel filter on I and Q, keep-1-in-d, and
// (K6, K13) atan2 and one PLL step per kept row.
//
// One template, four instances, by channel filter and back end:
//  * K6, `Lowpass<N>`, PLL with its output: replaces the Pallas kernel of
//    idsp_tpu/filters/ddc_pallas.py `fastlo_ddc_bank_block_lp` (:1066);
//  * K13, the Q<f> DF1 biquad, PLL without its output (the JAX wrapper
//    drops it): `fastlo_ddc_bank_block` (:1018);
//  both `_fastlo_ddc_bank_impl` (:1156, pallas_call :1265);
//  * K12, the DF1 without the back end: `fastlo_df1_dec_bank` (:870,
//    `_fastlo_df1_dec_impl` :906, pallas_call :987; body `_iir_df1_body`
//    :260), and with its `clamp=` the anti-windup DF1 (body
//    `_iir_df1_clamp_body` :273; `Df1ClampFilter`).
// On the TPU the grid walked time chunks with the I|Q lanes on
// (2c/128, 128) tiles: the chunk's mix and filter ran lane-parallel,
// then atan2 ran vectorized over the kept rows with I in lane ch and Q
// in lane c + ch, then the PLL scanned them.  Here one thread owns one
// channel (I and Q both) for the whole block: it needs no traffic
// between threads, and it computes the same values, since atan2 is
// elementwise and the PLL a scan over the kept rows in order.
//
// Per chunk q of tc rows (tc % d == 0) the thread makes two passes, as
// the TPU kernel did: (A) it reads the chunk's coarse LO factor; per
// row it reads x[row] (the same word for every thread) and the fine
// factor of its channel, mixes (fastlo.cuh, shared with K3) and steps
// the two filter recurrences (lowpass.cuh, shared with K4, or df1.cuh,
// shared with K1-K3 and K11; two independent chains), storing I and Q
// of the rows 0, d, 2d, ...; (B, not K12) over the chunk's tc/d kept
// rows, in order, it reads I and Q back, computes atan2_i32 (atan2.cuh)
// and steps the PLL (pll.cuh, shared with K5).
//
// What bounds it on the H100: the serial recurrences of the thread:
// the filter chain every row and the PLL update every d-th row, with
// c channels in c/32 warps, one warp on each of c/32 SMs.  Per block it
// reads x (t,) and the small LO tables and writes only the decimated
// outputs (8 B per channel and kept row, 12 B with K6's PLL output) and
// the state.
//
// What the design does about it: pass A's inputs are prefetched one
// group ahead (seq_bank.cuh `seq_rows`) and its I and Q chains
// interleave (ILP 2); pass B keeps atan2 and the PLL update out of the
// unrolled row loop, so that loop stays one small basic block (a first
// version with them inside the unrolled rows, behind the keep test,
// took 3.6x K4's time on an H100), and it loads the next kept row while
// the current one computes.  The mix's f32 operations are single
// roundings in the plain version's order (bit-identical to it).
#include <cuda_runtime.h>

#include <cstdint>

#include "atan2.cuh"
#include "df1.cuh"
#include "fastlo.cuh"
#include "lowpass.cuh"
#include "pll.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

// The channel filter of one lane behind one interface: its coefficients
// (Coefs), where its state is read and written (State), load/store of
// lane `lane`'s state and one step.
template <int N>
struct LpFilter {
  using Coefs = idsp::LpGains;
  struct State {
    const int64_t* in;  // LowpassState.p (2c, N)
    int64_t* out;
  };
  idsp::LowpassLane<N> s;
  __device__ __forceinline__ void load(const State& st, int lane) {
    s.load(st.in, lane);
  }
  __device__ __forceinline__ void store(const State& st, int lane) const {
    s.store(st.out, lane);
  }
  __device__ __forceinline__ int32_t step(const Coefs& g, int32_t x) {
    return s.step(g, x);
  }
};

struct Df1Filter {
  using Coefs = idsp::Df1Coefs;
  struct State {
    const int32_t* x_in;  // Df1State.x, .y (2c, 2)
    const int32_t* y_in;
    int32_t* x_out;
    int32_t* y_out;
  };
  idsp::Df1Lane s;
  __device__ __forceinline__ void load(const State& st, int lane) {
    s.load(st.x_in, st.y_in, lane);
  }
  __device__ __forceinline__ void store(const State& st, int lane) const {
    s.store(st.x_out, st.y_out, lane);
  }
  __device__ __forceinline__ int32_t step(const Coefs& k, int32_t x) {
    return s.step(k, x);
  }
};

// The anti-windup DF1 (K12's `clamp=`): offset and clamp before
// feedback (df1.cuh `Df1Clamp`).
struct Df1ClampFilter : Df1Filter {
  struct Coefs {
    idsp::Df1Coefs k;
    idsp::Df1Clamp cl;
  };
  __device__ __forceinline__ int32_t step(const Coefs& c, int32_t x) {
    return s.step_clamp(c.k, c.cl, x);
  }
};

struct MixIn {
  int32_t x;
  float cb, sb;  // the row's fine LO factor for this channel
};

// Pll: pass B (atan2 and the PLL); PllOut: with the PLL's output ypll.
template <class Filter, bool Pll, bool PllOut>
__global__ void __launch_bounds__(kBankLanes) ddc_bank_kernel(
    const int32_t* __restrict__ x, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cb,
    const float* __restrict__ sb, typename Filter::State fs,
    typename Filter::Coefs fk, idsp::PllWords pll_in, idsp::PllWords pll_out,
    int32_t* __restrict__ yiq, int32_t* __restrict__ ypll, int t, int c,
    int tc, int d, idsp::PllCoefs pk) {
  const int ch = blockIdx.x * kBankLanes + threadIdx.x;
  if (ch >= c) return;
  Filter f_i, f_q;
  f_i.load(fs, ch);
  f_q.load(fs, c + ch);
  idsp::PllLane pll;
  if constexpr (Pll) pll.load(pll_in, ch);
  const size_t c2 = 2 * static_cast<size_t>(c);
  const int nkeep = tc / d;  // kept rows per chunk
  const int nchunks = t / tc;
  for (int q = 0; q < nchunks; ++q) {
    const float cav = __ldg(ca + static_cast<size_t>(q) * c + ch);
    const float sav = __ldg(sa + static_cast<size_t>(q) * c + ch);
    const int32_t* xq = x + static_cast<size_t>(q) * tc;
    int32_t* iq_rows = yiq + static_cast<size_t>(q) * nkeep * c2 + ch;
    // (A) mix and filter, the kept rows to yiq
    idsp::Keep keep(d);
    int32_t* out = iq_rows;
    idsp::seq_rows(
        tc,
        [&](int u) {
          const size_t f = static_cast<size_t>(u) * c + ch;
          return MixIn{__ldg(xq + u), __ldg(cb + f), __ldg(sb + f)};
        },
        [&](int, const MixIn& m) {
          const float xh = idsp::fastlo_scale(m.x);
          const int32_t yi = f_i.step(fk, idsp::fastlo_round(
              idsp::fastlo_prod_i(cav, sav, m.cb, m.sb, xh)));
          const int32_t yq = f_q.step(fk, idsp::fastlo_round(
              idsp::fastlo_prod_q(cav, sav, m.cb, m.sb, xh)));
          if (keep.next()) {
            out[0] = yi;
            out[c] = yq;
            out += c2;
          }
        });
    if constexpr (Pll) {
      // (B) atan2 and the PLL over the kept rows (this thread's own
      // stores above, read back in program order)
      int32_t* yp = ypll + static_cast<size_t>(q) * nkeep * c + ch;
      int32_t ni = iq_rows[0], nq = iq_rows[c];
#pragma unroll 1
      for (int j = 0; j < nkeep; ++j) {
        const int32_t ci = ni, cq = nq;
        if (j + 1 < nkeep) {
          ni = iq_rows[(j + 1) * c2];
          nq = iq_rows[(j + 1) * c2 + c];
        }
        const int32_t y = pll.step(pk, idsp::atan2_i32(cq, ci));
        if constexpr (PllOut) yp[static_cast<size_t>(j) * c] = y;
      }
    }
  }
  f_i.store(fs, ch);
  f_q.store(fs, c + ch);
  if constexpr (Pll) pll.store(pll_out, ch);
}

idsp::PllWords words(void* const* p) {
  idsp::PllWords w{};
  for (int i = 0; i < 7; ++i) w.p[i] = p[i];
  return w;
}

template <class Filter, bool Pll, bool PllOut>
int launch(const void* x, const void* ca, const void* sa, const void* cb,
           const void* sb, const typename Filter::State& fs,
           const typename Filter::Coefs& fk, void* const* pll_in,
           void* const* pll_out, void* yiq, void* ypll, int t, int c,
           int tc, int d, const idsp::PllCoefs& pk, void* stream) {
  if (d < 1 || tc < 1) return static_cast<int>(cudaErrorInvalidValue);
  idsp::PllWords w_in{}, w_out{};
  if constexpr (Pll) {
    w_in = words(pll_in);
    w_out = words(pll_out);
  }
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  ddc_bank_kernel<Filter, Pll, PllOut>
      <<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(x), static_cast<const float*>(ca),
          static_cast<const float*>(sa), static_cast<const float*>(cb),
          static_cast<const float*>(sb), fs, fk, w_in, w_out,
          static_cast<int32_t*>(yiq), static_cast<int32_t*>(ypll), t, c, tc,
          d, pk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6: x (t,) i32 and the fast-LO factor tables ca/sa (t/tc, c), cb/sb
// (tc, c) f32 -> yiq (t/d, 2c) i32 (I lanes, then Q lanes) and ypll
// (t/d, c) i32.  Lowpass state lp (2c, n) i64 in and out; PLL state as
// two host arrays of the seven state-word device pointers (pll.cuh
// PllWords), each (c,).
extern "C" int idsp_ddc_bank_lp(const void* x, const void* ca, const void* sa,
                                const void* cb, const void* sb,
                                const void* lp_in, void* lp_out,
                                void* const* pll_in, void* const* pll_out,
                                void* yiq, void* ypll, int t, int c, int tc,
                                int d, int n, int k0, int k1, int b0, int b1,
                                int a1, void* stream) {
  const idsp::LpGains g{k0, k1};
  const idsp::PllCoefs pk{b0, b1, a1};
  if (n == 1) {
    const LpFilter<1>::State fs{static_cast<const int64_t*>(lp_in),
                                static_cast<int64_t*>(lp_out)};
    return launch<LpFilter<1>, true, true>(x, ca, sa, cb, sb, fs, g, pll_in,
                                           pll_out, yiq, ypll, t, c, tc, d,
                                           pk, stream);
  }
  if (n == 2) {
    const LpFilter<2>::State fs{static_cast<const int64_t*>(lp_in),
                                static_cast<int64_t*>(lp_out)};
    return launch<LpFilter<2>, true, true>(x, ca, sa, cb, sb, fs, g, pll_in,
                                           pll_out, yiq, ypll, t, c, tc, d,
                                           pk, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12 when pll_in is null, else K13: the same inputs with the Q<f> DF1
// state sx/sy (2c, 2) i32 in and out; yiq (t/d, 2c) i32.  K13 steps the
// PLL state (pll_in -> pll_out, coefficients pb0, pb1, pa1) and writes
// no PLL output.  clamp != 0 (K12 only) runs the anti-windup DF1 with
// offset u and bounds lo, hi.
extern "C" int idsp_ddc_bank_df1(const void* x, const void* ca,
                                 const void* sa, const void* cb,
                                 const void* sb, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 void* const* pll_in, void* const* pll_out,
                                 void* yiq, int t, int c, int tc, int d,
                                 int f, int b0, int b1, int b2, int a1,
                                 int a2, int pb0, int pb1, int pa1,
                                 int clamp, int u, int lo, int hi,
                                 void* stream) {
  const Df1Filter::State fs{
      static_cast<const int32_t*>(sx), static_cast<const int32_t*>(sy),
      static_cast<int32_t*>(sx_out), static_cast<int32_t*>(sy_out)};
  const idsp::Df1Coefs k{b0, b1, b2, a1, a2, f};
  const idsp::PllCoefs pk{pb0, pb1, pa1};
  if (clamp) {
    if (pll_in != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<Df1ClampFilter, false, false>(
        x, ca, sa, cb, sb, fs, Df1ClampFilter::Coefs{k, {u, lo, hi}},
        nullptr, nullptr, yiq, nullptr, t, c, tc, d, pk, stream);
  }
  if (pll_in == nullptr) {
    return launch<Df1Filter, false, false>(x, ca, sa, cb, sb, fs, k, nullptr,
                                           nullptr, yiq, nullptr, t, c, tc,
                                           d, pk, stream);
  }
  return launch<Df1Filter, true, false>(x, ca, sa, cb, sb, fs, k, pll_in,
                                        pll_out, yiq, nullptr, t, c, tc, d,
                                        pk, stream);
}
