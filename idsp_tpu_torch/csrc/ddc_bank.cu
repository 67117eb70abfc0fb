// K6, K12 and K13: the BASELINE #5 per-channel stack in one kernel:
// fast-LO conjugate mix, a channel filter on I and Q, keep-1-in-d, and
// (K6, K13) atan2 and one PLL step per kept row.
//
// One kernel, `ddc_bank_kernel`, a template over its serial warp and back
// end:
//  * K12 and K13, the Q<f> DF1 biquad: `fastlo_df1_dec_bank` (K12;
//    idsp_tpu/filters/ddc_pallas.py :870, `_fastlo_df1_dec_impl` :906,
//    pallas_call :987; body `_iir_df1_body` :260, and with its `clamp=`
//    the anti-windup DF1, body `_iir_df1_clamp_body` :273) and
//    `fastlo_ddc_bank_block` (K13, :1018: K12, then atan2 and the PLL,
//    whose output the JAX wrapper drops);
//  * K6, `Lowpass<N>` and the PLL with its output:
//    `fastlo_ddc_bank_block_lp` (:1066);
//  K6 and K13 both `_fastlo_ddc_bank_impl` (:1156, pallas_call :1265).
// On the TPU the grid walked time chunks with the I|Q lanes on
// (2c/128, 128) tiles: the chunk's mix and filter ran lane-parallel,
// then atan2 ran vectorized over the kept rows with I in lane ch and Q
// in lane c + ch, then the PLL scanned them.
//
// What bounds them on the H100: the filter's recurrence, serial in time
// in each of the 2c lanes: the DF1 warp of df1_ring.cuh takes ~42 cycles
// a row (PERF.md §6), 0.70 ms for a block of 32768 rows; the Lowpass
// serial warp (lowpass.cuh) the saturating subtract, a wide multiply and
// a two-word add a row.  The mix is three loads (x, the coarse and the
// fine (cos, sin) pairs) and eight f32 operations a row and lane, off that
// chain, but with the addresses, the selects and the rounding the
// producers' compiled batch loop holds ~70 instructions a row (both of its
// load paths): 4 producers set the pace (~73 cycles a row, PERF.md §6), 8
// keep up with the DF1; the back end (atan2 and the PLL's 64-bit update,
// itself serial in each channel) runs on 1 row in d.  Per block the
// kernel reads x (t,) and the LO factor tables and writes only the kept
// rows (8 B per channel and kept row; K6 4 B more of PLL output) and the
// state.
//
// What the design does about it: df1_ring.cuh's depth-0 pipeline
// (`run_roles`).  A block is a tile of 16 channels, paired: lane lid < 16
// is the I lane of channel ch0 + lid, lane lid >= 16 its Q lane (state
// row c + ch), so that a channel's I and Q meet in one CTA for atan2
// without a cluster; c / 16 tiles (64 at c = 1024, one CTA an SM).
// `producers` warps (8 by default), each a span of every chunk, compute
// the mixed rows into the input ring (fastlo.cuh `fastlo_mix_rows`, K3's
// producer: a batch's loads issued while the batch before is mixed, one
// coarse load a batch, the I and Q lanes one sequence of operations); the
// serial warp alone on its scheduler turns each slot into a slot of the
// output ring (K12/K13: the DF1 warp `df1_warp`, clamped for K12's
// `clamp=`; K6: lowpass.cuh's `LpSerial`, shared with K4); a back-end
// warp in the store warp's place takes each slot's kept rows -- the
// block's rows r with r % d == 0, whatever the chunk -- to yiq, two runs
// of 16 words a row (I at column ch0, Q at c + ch0), and for K6 and K13
// computes atan2(Q, I) of two kept rows at once (lanes 0-15 the first,
// 16-31 the second; the seed LUT in shared memory, `load_atan2_lut`) and
// steps the PLL over the kept rows in order on lanes 0-15, one a channel;
// K6 writes each step's output, 16 consecutive words a kept row.  The plan
// (warps, roles, chunk, ring depth, shared memory) is the host's
// (filters/ddc_bank_cuda.py `bank_plan` on filters/pipe_plan.py), which
// the entry points check.
//
// Numerics: the mix's f32 operations are single roundings in the plain
// version's order, the rest exact integer arithmetic (the Lowpass's sums
// regrouped mod 2^64): bit-identical to the plain versions, and no plan
// changes a value.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "atan2.cuh"
#include "df1.cuh"
#include "df1_ring.cuh"
#include "fastlo.cuh"
#include "lowpass.cuh"
#include "pll.cuh"

namespace {

using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;

constexpr int kPair = kLanes / 2;  // channels of a tile

// A launch: p.d the rows, chunk and ring depth (K12/K13: the DF1's state
// (2c, 2) in and out, coefficients, clamp too), p.c2 = 2c; m the mix's
// inputs; yiq (t/d, 2c); K6's and K13's PLL state words in and out and
// its coefficients; K6's PLL output ypll (t/d, c) and its Lowpass state
// (2c, N) in and out and gains.
struct BankArgs {
  Pipe p;
  idsp::FastLoPlanes m;
  int32_t* yiq;
  int32_t* ypll;
  int d;
  idsp::PllWords pll_in, pll_out;
  idsp::PllCoefs pk;
  idsp::LpArgs lp;
};

// Lane lid of tile blockIdx.x: channel ch, its I lane (lid < kPair) or Q
// lane; row, the lane's state row and yiq column (I: ch, Q: c + ch); a
// lane of a channel past c is dead (it still reaches every barrier).
struct PairLane {
  int ch, row;
  bool is_q, live;
};

__device__ __forceinline__ PairLane pair_lane(int c, int lid) {
  const int ch = blockIdx.x * kPair + lid % kPair;
  const bool is_q = lid >= kPair;
  return PairLane{ch, is_q ? c + ch : ch, is_q, ch < c};
}

// The serial warp of K12/K13: the DF1 warp on the tile's paired lanes.
template <bool Clamp>
struct BankSerial {
  const BankArgs* a;
  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int, bool,
                                             uint32_t) const {
    const PairLane me = pair_lane(a->m.c, lid);
    idsp::ring::df1_warp<Clamp>(a->p.d, R, reinterpret_cast<int32_t*>(out) +
                                               lid,
                                lid, me.row, me.live);
  }
};

// The serial warp of K6: lowpass.cuh's Lowpass<N> serial warp on the
// tile's paired lanes' state rows.
template <int N>
struct BankLpSerial {
  const BankArgs* a;
  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int, bool,
                                             uint32_t) const {
    const PairLane me = pair_lane(a->m.c, lid);
    idsp::LpSerial<N>{&a->p, &a->lp}(R, out, lid, me.row, me.live, 0);
  }
};

// What the back end does past the kept rows: nothing (K12), atan2 and the
// PLL's steps, its state stored (K13), and each step's output to ypll
// (K6).
enum class Back { kRows, kPll, kPllOut };

// The back end, in the store warp's place: for each output slot (out:
// slot 0) its kept rows -- block rows r with r % d == 0 -- to yiq; with a
// PLL (K6, K13), then atan2(Q, I) of two kept rows at once (lanes 0-15 the
// first, 16-31 the second, handed to lanes 0-15 by a shuffle) and the
// PLL's steps over them in order on lanes 0-15, one lane a channel (K6:
// each step's output to ypll at row (r0 + r) / d, 16 consecutive words a
// kept row); the PLL state stored at the end.
template <Back B>
__device__ __forceinline__ void back_end(
    const BankArgs& a, const Rings& R, const int32_t* out, int lid,
    const idsp::atan2_detail::SharedLut& lut) {
  constexpr bool kPll = B != Back::kRows;
  const Pipe& p = a.p;
  const int d = a.d, chunk = p.d.chunk, c = a.m.c;
  const size_t c2 = 2 * static_cast<size_t>(c);
  const PairLane me = pair_lane(c, lid);
  const int pc = lid % kPair;  // the channel's I word of a slot row
  const bool pll_lane = kPll && lid < kPair && me.live;
  idsp::PllLane pll{};
  if (pll_lane) pll.load(a.pll_in, me.ch);
  int first = 0;  // the chunk's first kept row
  idsp::sm90::Cursor u;
  for (int r0 = 0; r0 < p.d.t; r0 += chunk, u.next(p.d.depth)) {
    const int rows = min(chunk, p.d.t - r0);
    idsp::sm90::mbar_wait(R.full_out(u.k), u.ph);
    const int32_t* s = out + static_cast<size_t>(u.k) * chunk * kLanes;
    if (me.live) {
      int32_t* y =
          a.yiq + static_cast<size_t>((r0 + first) / d) * c2 + me.row;
      for (int r = first; r < rows; r += d, y += c2) *y = s[r * kLanes + lid];
    }
    if constexpr (kPll) {
      for (int r = first; r < rows; r += 2 * d) {
        const int32_t* w = s + min(r + lid / kPair * d, rows - 1) * kLanes;
        const int32_t ang = idsp::atan2_i32(w[kPair + pc], w[pc], lut);
        const int32_t next = __shfl_down_sync(0xFFFFFFFFu, ang, kPair);
        if (lid < kPair) {
          const bool two = r + d < rows;
          [[maybe_unused]] const int32_t y0 = pll.step(a.pk, ang);
          [[maybe_unused]] const int32_t y1 =
              two ? pll.step(a.pk, next) : 0;
          if constexpr (B == Back::kPllOut) {
            if (pll_lane) {
              int32_t* yp =
                  a.ypll + static_cast<size_t>((r0 + r) / d) * c + me.ch;
              yp[0] = y0;
              if (two) yp[c] = y1;
            }
          }
        }
      }
    }
    idsp::sm90::mbar_arrive(R.empty_out(u.k));
    const int kept = first < rows ? (rows - first + d - 1) / d : 0;
    first += kept * d - rows;
  }
  if (pll_lane) pll.store(a.pll_out, me.ch);
}

// K12 (BankSerial, Back::kRows; clamped for its clamp=), K13 (BankSerial,
// Back::kPll) and K6 (BankLpSerial, Back::kPllOut).
template <class Serial, Back B>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    ddc_bank_kernel(const __grid_constant__ BankArgs a) {
  __shared__ uint32_t lut_base[16];
  __shared__ int32_t lut_slope[16];
  extern __shared__ __align__(16) unsigned char smem[];
  // published by run_roles' barrier
  const auto lut = idsp::load_atan2_lut(lut_base, lut_slope);
  idsp::ring::run_roles<1>(
      a.p, smem, Serial{&a},
      [&](const Rings& R, int pw, int lid, int, bool, bool) {
        const PairLane me = pair_lane(a.m.c, lid);
        idsp::fastlo_mix_rows(a.m, a.p.d.t, a.p.d.chunk, a.p.d.depth, R,
                              a.p.producers, pw, lid, me.ch, me.is_q,
                              me.live);
      },
      [&](const Rings& R, const uint32_t* out, int lid, int) {
        back_end<B>(a, R, reinterpret_cast<const int32_t*>(out), lid, lut);
      });
}

idsp::PllWords words(void* const* p) {
  idsp::PllWords w{};
  for (int i = 0; i < 7; ++i) w.p[i] = p[i];
  return w;
}

// The checks every entry makes (the host plan's own, the mix's offsets,
// whole time chunks and kept rows); false for a call the kernel cannot
// run.
bool bank_ok(int t, int c, int tc, int d, int warps, int producers,
             int chunk, int ring, int smem) {
  return c >= 1 && d >= 1 && tc >= 1 &&
         idsp::ring::pipe_plan_ok(t, 2 * c, warps, producers, chunk, ring,
                                  smem) &&
         t % tc == 0 && t % d == 0 && idsp::fastlo_offsets_ok(t, tc, c);
}

// The launch-wide arguments every entry sets: the rows, the plan, the mix,
// yiq and d.
BankArgs bank_args(const void* x, const void* coarse, const void* fine,
                   void* yiq, int t, int c, int tc, int d, int warps,
                   int producers, int chunk, int ring) {
  BankArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.c2 = 2 * c;  // c / 16 tiles of 32 lanes
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.m = idsp::FastLoPlanes{static_cast<const int32_t*>(x),
                           static_cast<const float2*>(coarse),
                           static_cast<const float2*>(fine), c, tc};
  a.yiq = static_cast<int32_t*>(yiq);
  a.d = d;
  return a;
}

}  // namespace

// K6: x (t,) i32 and the fast-LO factor tables, coarse the (ca, sa) pairs
// (t/tc, c) and fine the (cb, sb) pairs (tc, c), float2 each, -> yiq
// (t/d, 2c) i32 (I lanes, then Q lanes) and ypll (t/d, c) i32.  Lowpass
// state lp (2c, n) i64 in and out, n = 1 or 2, gains k0 (and k1 for n =
// 2); PLL state as two host arrays of the seven state-word device
// pointers (pll.cuh PllWords), each (c,), coefficients b0, b1, a1.  warps,
// producers, chunk, ring (slots a ring) and smem are the host plan's
// (filters/ddc_bank_cuda.py `bank_plan`) over 2c lanes in c / 16 tiles.  A
// plan the kernel cannot run is refused; a refused call launches nothing
// and leaves no CUDA error pending.
extern "C" int idsp_ddc_bank_lp(const void* x, const void* coarse,
                                const void* fine, const void* lp_in,
                                void* lp_out, void* const* pll_in,
                                void* const* pll_out, void* yiq, void* ypll,
                                int t, int c, int tc, int d, int n, int k0,
                                int k1, int b0, int b1, int a1, int warps,
                                int producers, int chunk, int ring, int smem,
                                void* stream) {
  if ((n != 1 && n != 2) || pll_in == nullptr || pll_out == nullptr ||
      !bank_ok(t, c, tc, d, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  BankArgs a = bank_args(x, coarse, fine, yiq, t, c, tc, d, warps, producers,
                         chunk, ring);
  a.ypll = static_cast<int32_t*>(ypll);
  a.pll_in = words(pll_in);
  a.pll_out = words(pll_out);
  a.pk = idsp::PllCoefs{b0, b1, a1};
  a.lp = idsp::LpArgs{static_cast<const int64_t*>(lp_in),
                      static_cast<int64_t*>(lp_out), idsp::LpGains{k0, k1}};
  using idsp::ring::launch_pipe;
  constexpr Back kOut = Back::kPllOut;
  return n == 1 ? launch_pipe(ddc_bank_kernel<BankLpSerial<1>, kOut>, a, a.p,
                              smem, stream)
                : launch_pipe(ddc_bank_kernel<BankLpSerial<2>, kOut>, a, a.p,
                              smem, stream);
}

// K12 when pll_in is null, else K13: x (t,) i32 and the fast-LO factor
// tables, coarse the (ca, sa) pairs (t/tc, c) and fine the (cb, sb) pairs
// (tc, c), float2 each; the Q<f> DF1 state sx/sy (2c, 2) i32 in and out;
// yiq (t/d, 2c) i32.  K13 steps the
// PLL state (pll_in -> pll_out, coefficients pb0, pb1, pa1) and writes
// no PLL output.  clamp != 0 (K12 only) runs the anti-windup DF1 with
// offset u and bounds lo, hi.  warps, producers, chunk, ring (slots a
// ring) and smem are the host plan's (filters/ddc_bank_cuda.py
// `bank_plan`) over 2c lanes in c / 16 tiles.  A plan the kernel cannot
// run is refused; a refused call launches nothing and leaves no CUDA error
// pending.
extern "C" int idsp_ddc_bank_df1(const void* x, const void* coarse,
                                 const void* fine, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 void* const* pll_in, void* const* pll_out,
                                 void* yiq, int t, int c, int tc, int d,
                                 int f, int b0, int b1, int b2, int a1,
                                 int a2, int pb0, int pb1, int pa1,
                                 int clamp, int u, int lo, int hi, int warps,
                                 int producers, int chunk, int ring, int smem,
                                 void* stream) {
  if (f <= 0 || f >= 64 || (clamp && pll_in != nullptr) ||
      !bank_ok(t, c, tc, d, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  BankArgs a = bank_args(x, coarse, fine, yiq, t, c, tc, d, warps, producers,
                         chunk, ring);
  a.p.d = idsp::ring::Df1Ring{t,
                              chunk,
                              ring,
                              static_cast<const int32_t*>(sx),
                              static_cast<const int32_t*>(sy),
                              static_cast<int32_t*>(sx_out),
                              static_cast<int32_t*>(sy_out),
                              idsp::Df1Coefs{b0, b1, b2, a1, a2, f},
                              idsp::Df1Clamp{u, lo, hi}};
  a.pk = idsp::PllCoefs{pb0, pb1, pa1};
  using idsp::ring::launch_pipe;
  if (pll_in != nullptr) {
    a.pll_in = words(pll_in);
    a.pll_out = words(pll_out);
    return launch_pipe(ddc_bank_kernel<BankSerial<false>, Back::kPll>, a,
                       a.p, smem, stream);
  }
  return clamp ? launch_pipe(ddc_bank_kernel<BankSerial<true>, Back::kRows>,
                             a, a.p, smem, stream)
               : launch_pipe(ddc_bank_kernel<BankSerial<false>, Back::kRows>,
                             a, a.p, smem, stream);
}
