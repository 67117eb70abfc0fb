// K6: the whole BASELINE #5 per-channel stack in one kernel, Lowpass
// variant: fast-LO conjugate mix, Lowpass<N> on I and Q, keep-1-in-d,
// atan2 and one PLL step per kept row.
//
// Replaces the Pallas kernel of idsp_tpu/filters/ddc_pallas.py
// `fastlo_ddc_bank_block_lp` (:1066; `_fastlo_ddc_bank_impl` :1156,
// pallas_call :1265).  On the TPU the grid walked time chunks with the
// I|Q lanes on (2c/128, 128) tiles: the chunk's mix and lowpass ran
// lane-parallel, then atan2 ran vectorized over the kept rows with I in
// lane ch and Q in lane c + ch, then the PLL scanned them.  Here one
// thread owns one channel (I and Q both) for the whole block: it needs
// no traffic between threads, and it computes the same values, since
// atan2 is elementwise and the PLL a scan over the kept rows in order.
//
// Per chunk q of tc rows (tc % d == 0) the thread makes two passes, as
// the TPU kernel did: (A) it reads the chunk's coarse LO factor; per
// row it reads x[row] (the same word for every thread) and the fine
// factor of its channel, mixes (fastlo.cuh, shared with K3) and steps
// the two Lowpass<N> recurrences (lowpass.cuh, shared with K4; two
// independent chains), storing I and Q of the rows 0, d, 2d, ...; (B)
// over the chunk's tc/d kept rows, in order, it reads I and Q back,
// computes atan2_i32 (atan2.cuh) and steps the PLL (pll.cuh, shared
// with K5).
//
// What bounds it on the H100: the serial recurrences of the thread:
// the lowpass chain every row and the PLL update every d-th row, with
// c channels in c/32 warps, one warp on each of c/32 SMs.  Per block it
// reads x (t,) and the small LO tables and writes only the decimated
// outputs (12 B per channel and kept row) and the state.
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
#include "fastlo.cuh"
#include "lowpass.cuh"
#include "pll.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

struct MixIn {
  int32_t x;
  float cb, sb;  // the row's fine LO factor for this channel
};

template <int N>
__global__ void __launch_bounds__(kBankLanes) ddc_bank_lp_kernel(
    const int32_t* __restrict__ x, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cb,
    const float* __restrict__ sb, const int64_t* __restrict__ lp_in,
    int64_t* __restrict__ lp_out, idsp::PllWords pll_in,
    idsp::PllWords pll_out, int32_t* __restrict__ yiq,
    int32_t* __restrict__ ypll, int t, int c, int tc, int d, idsp::LpGains g,
    idsp::PllCoefs pk) {
  const int ch = blockIdx.x * kBankLanes + threadIdx.x;
  if (ch >= c) return;
  idsp::LowpassLane<N> lp_i, lp_q;
  lp_i.load(lp_in, ch);
  lp_q.load(lp_in, c + ch);
  idsp::PllLane pll;
  pll.load(pll_in, ch);
  const size_t c2 = 2 * static_cast<size_t>(c);
  const int nkeep = tc / d;  // kept rows per chunk
  const int nchunks = t / tc;
  for (int q = 0; q < nchunks; ++q) {
    const float cav = __ldg(ca + static_cast<size_t>(q) * c + ch);
    const float sav = __ldg(sa + static_cast<size_t>(q) * c + ch);
    const int32_t* xq = x + static_cast<size_t>(q) * tc;
    int32_t* iq_rows = yiq + static_cast<size_t>(q) * nkeep * c2 + ch;
    // (A) mix and lowpass, the kept rows to yiq
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
          const int32_t yi = lp_i.step(g, idsp::fastlo_round(
              idsp::fastlo_prod_i(cav, sav, m.cb, m.sb, xh)));
          const int32_t yq = lp_q.step(g, idsp::fastlo_round(
              idsp::fastlo_prod_q(cav, sav, m.cb, m.sb, xh)));
          if (keep.next()) {
            out[0] = yi;
            out[c] = yq;
            out += c2;
          }
        });
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
      yp[static_cast<size_t>(j) * c] = pll.step(pk, idsp::atan2_i32(cq, ci));
    }
  }
  lp_i.store(lp_out, ch);
  lp_q.store(lp_out, c + ch);
  pll.store(pll_out, ch);
}

}  // namespace

// x (t,) i32 and the fast-LO factor tables ca/sa (t/tc, c), cb/sb
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
  if ((n != 1 && n != 2) || d < 1 || tc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  idsp::PllWords w_in, w_out;
  for (int i = 0; i < 7; ++i) {
    w_in.p[i] = pll_in[i];
    w_out.p[i] = pll_out[i];
  }
  const idsp::LpGains g{k0, k1};
  const idsp::PllCoefs pk{b0, b1, a1};
  auto kernel = n == 1 ? ddc_bank_lp_kernel<1> : ddc_bank_lp_kernel<2>;
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  kernel<<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const float*>(ca),
      static_cast<const float*>(sa), static_cast<const float*>(cb),
      static_cast<const float*>(sb), static_cast<const int64_t*>(lp_in),
      static_cast<int64_t*>(lp_out), w_in, w_out, static_cast<int32_t*>(yiq),
      static_cast<int32_t*>(ypll), t, c, tc, d, g, pk);
  return static_cast<int>(cudaGetLastError());
}
