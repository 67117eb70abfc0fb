// K34-K37: the alternative filter structures over a bank of lanes.  K34
// is the Chamberlin state-variable filter (f32), K35 and K36 the
// normal-form (Rader-Gold) section in Q<f> int32 and f32, K37 the
// reciprocal PLL over masked timestamps.
//
// Replaces the Pallas kernels of idsp_tpu/filters/svf_pallas.py
// `svf_bank` (:28), normal_pallas.py `normal_bank_q` (:35) and
// `normal_bank_f32` (:105), and rpll_pallas.py `rpll_bank` (:35), all
// `_seq_bank_kernel` bodies run by biquad_pallas.py `_bank_call`
// (pallas_call :453).  The TPU had no 64-bit integers: the normal form's
// i64 MACs were 16-bit limb products, and the RPLL's u32 x u32 -> u64
// product one too, its `>> sf` split into sf < 32, = 32, > 32 (:96-101)
// and its masks packed beside the timestamps on the sublanes (:120-139).
// Here the MACs are native 64-bit multiply-adds, the RPLL's words native
// uint32_t/uint64_t, and the valid mask a byte plane of its own.
//
// What bounds them on the H100: the recurrence, as K1 (df1_bank.cu): a
// lane is one serial chain.  Per sample the bytes are 4 B in and 4 B out
// (K34-K36), 4 B and a mask byte in and 8 B out (K37).  K34 and K36 round
// every product and sum on its own (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`)
// in the plain version's order, so nvcc cannot contract them into FMAs:
// bit-identical to the plain scans.  K35's sums wrap mod 2^64, so any
// grouping of their terms gives the plain version's bits.
//
// What the design does: all four run on df1_ring.cuh's depth-0 pipeline, a
// block a 32-lane tile: producer warps, each a span of every chunk, load
// their rows a batch ahead into the input ring; the serial warp, alone on
// its scheduler, runs the recurrence from shared memory into the output
// ring; the store warp writes the rows, 16 bytes a thread where c % 4 == 0.
// K34: the producers copy x (df1_ring.cuh `copy_feed`); the serial warp
// holds lp, hp and bp, forms bp qi beside bp f (off the chain) and bp f, +
// lp, x - lp, - bp qi, hp f, + bp on it, each rounded on its own, br's hp +
// lp off it; one template instance an output.  K35: the producers form K1's
// feed-forward word W = b0 x0 + b1 x1 + b2 x2 mod 2^64 (`tap_feed`,
// `put_w`); the serial warp holds y0 and y1 and forms W + p_re y1 - p_im y0
// and p_im y1 + p_re y0 mod 2^64, each shifted right by f (one template
// instance a regime, f <= 32 or above, as K1's; the host picks it).  K36:
// the producers form (b0 x0 + b1 x1) + b2 x2, rounded as the plain version
// rounds it (df1_ring.cuh `f32_feed`, K30's too); the serial warp the 2x2 rotation of y0 and y1, each product
// and sum rounded on its own.  K37: the producers form each row's words --
// x, and dt = -x mod 2^dt2 with the mask in bit 31; the serial warp carries
// the last valid timestamp (dx and one select a row, off the chain) and
// runs the ff / f / y chain (rpll.rs:47-77), its `>> sf` one template
// instance a regime (the host picks it); the store warp writes the phase and
// frequency planes.  The plans (warps, producers, chunk, ring depth, shared
// memory) are the host's (filters/svf_cuda.py `svf_plan`,
// filters/normal_cuda.py `normal_plan`, filters/rpll_cuda.py `rpll_plan`),
// which the entry points check.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"

namespace {

using idsp::ring::Batch;
using idsp::ring::kLanes;
using idsp::ring::kWRows;
using idsp::ring::Pipe;
using idsp::ring::Rings;
using idsp::ring::TapRows;

// K34 (svf.rs:47-60): a launch; p.d holds the rows, chunk and ring depth
// (no DF1), p.y the (t, c) f32 output; state lp, hp, bp (c,) each.
struct SvfArgs {
  Pipe p;
  const float* xs;
  const float *lp, *hp, *bp;
  float *lp_out, *hp_out, *bp_out;
  float f, qi;
};

// The serial warp: lp, hp and bp of its lane in registers, each row's x
// from the input ring to the output Out -- lp (0), hp (1), bp (2) or br =
// hp + lp (3) -- in the output ring.  Each product and sum is rounded on
// its own in the plain version's order (`__f*_rn`: no contraction); bp qi
// is formed beside bp f, so the chain is bp f, + lp, x - lp, - bp qi, hp
// f, + bp: six rounded ops a row.
template <int Out>
struct SvfSerial {
  const SvfArgs* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const float f = a->f, qi = a->qi;
    float lp = 0.f, hp = 0.f, bp = 0.f;
    if (live) {
      lp = a->lp[lane];
      hp = a->hp[lane];
      bp = a->bp[lane];
    }
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const float* in =
              reinterpret_cast<const float*>(R.in_slot<1>(slot)) + lid;
          float* o = reinterpret_cast<float*>(out) +
                     static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, float x) {
                const float bf = __fmul_rn(bp, f);
                const float bq = __fmul_rn(bp, qi);  // off the chain
                lp = __fadd_rn(bf, lp);
                hp = __fsub_rn(__fsub_rn(x, lp), bq);
                bp = __fadd_rn(__fmul_rn(hp, f), bp);
                float y;
                if constexpr (Out == 0) y = lp;
                if constexpr (Out == 1) y = hp;
                if constexpr (Out == 2) y = bp;
                if constexpr (Out == 3) y = __fadd_rn(hp, lp);
                o[r * kLanes] = y;
              });
        });
    if (live) {
      a->lp_out[lane] = lp;
      a->hp_out[lane] = hp;
      a->bp_out[lane] = bp;
    }
  }
};

template <int Out>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    svf_kernel(const __grid_constant__ SvfArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, SvfSerial<Out>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::copy_feed(a.p, R, pw, lid, lane, live, a.xs);
      });
}

// K35 and K36: normal.rs:38-58 on the depth-0 pipeline.  A launch: p.d
// holds the rows, chunk and ring depth (no DF1), p.y the (t, c) output;
// state x = [x1, x2], y = [y0, y1] (c, 2) each (y the rotating I/Q pair,
// not DF1's [y1, y2]).  K35 only: n_im is -p_im (the entry refuses p_im ==
// INT32_MIN, as the JAX kernel does), f the Q<f> shift.
template <class T>
struct NormalArgs {
  Pipe p;
  const T* xs;
  const T *sx, *sy;
  T *sx_out, *sy_out;
  T b0, b1, b2, p_re, p_im, n_im;
  int f;
};

// K35's serial warp: y0, y1 of its lane in registers; each row's W = b0 x0
// + b1 x1 + b2 x2 mod 2^64 (the producers', df1_ring.cuh `put_w`) from the
// input ring, y0' into the output ring.  acc1 = W + p_re y1 + n_im y0 and
// acc0 = p_im y1 + p_re y0 wrap mod 2^64, so any order of their terms
// gives the plain version's bits; y1' and y0' are the low words of acc >>
// f: for f <= 32 bits [f, f + 32) of acc (`__funnelshift_rc`), for 32 < f
// < 64 (Hi) the high word shifted right by f - 32, sign-filled, as
// `Df1WSerial`'s.  On the chain: the products of the row before's y0 and
// y1, their adds onto W, the shift.  Whatever the source's grouping, ptxas
// forms acc1's two products apart and adds them onto W in one three-input
// add, and gives acc0's second product the first as its addend; forms that
// kept acc0 a three-input add too ran slower (PERF.md §6).
template <bool Hi>
struct NormalQSerial {
  const NormalArgs<int32_t>* a;

  __device__ __forceinline__ static int32_t shift(uint64_t acc, int f,
                                                  int sh) {
    const uint32_t lo = static_cast<uint32_t>(acc);
    const uint32_t hi = static_cast<uint32_t>(acc >> 32);
    if constexpr (Hi) {
      return static_cast<int32_t>(hi) >> sh;
    } else {
      return static_cast<int32_t>(__funnelshift_rc(lo, hi, f));
    }
  }

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    using idsp::mad_wide;
    using idsp::mul_wide;
    const Pipe& p = a->p;
    const int32_t p_re = a->p_re, p_im = a->p_im, n_im = a->n_im;
    const int f = a->f, sh = f - 32;
    int32_t y0 = 0, y1 = 0;
    if (live) {
      y0 = a->sy[2 * lane];
      y1 = a->sy[2 * lane + 1];
    }
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const uint2* in =
              reinterpret_cast<const uint2*>(R.in_slot<2>(slot)) + lid;
          int32_t* o = reinterpret_cast<int32_t*>(out) +
                       static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, uint2 w) {
                const int64_t acc1 = mad_wide(
                    n_im, y0,
                    mad_wide(p_re, y1,
                             static_cast<int64_t>(uint64_t{w.y} << 32 | w.x)));
                const int64_t acc0 = mad_wide(p_im, y1, mul_wide(p_re, y0));
                y1 = shift(static_cast<uint64_t>(acc1), f, sh);
                y0 = shift(static_cast<uint64_t>(acc0), f, sh);
                o[r * kLanes] = y0;
              });
        });
    if (live) {
      a->sy_out[2 * lane] = y0;
      a->sy_out[2 * lane + 1] = y1;
    }
  }
};

template <bool Hi>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    normal_q_kernel(const __grid_constant__ NormalArgs<int32_t> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<2, 1, idsp::ring::Layout::kWide>(
      a.p, smem, NormalQSerial<Hi>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile; producer 0 writes x = [x1, x2] out
        idsp::ring::tap_feed<kWRows>(
            a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
            [&](const Batch& b,
                const TapRows<int32_t, kWRows>& xv, int slot) {
              idsp::ring::put_w(R, slot, lid, b, xv, a.b0, a.b1, a.b2);
            });
      });
}

// K36's serial warp: y0, y1 of its lane in registers; each row's s =
// (b0 x0 + b1 x1) + b2 x2 (the producers', each product and sum rounded on
// its own) from the input ring, y0' into the output ring: y1' = (s + p_re
// y1) - p_im y0, y0' = p_im y1 + p_re y0, the plain version's order
// (`__f*_rn`: no contraction).  The four products do not wait on each
// other; on the chain are a multiply, an add and a subtract.
struct NormalF32Serial {
  const NormalArgs<float>* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const float p_re = a->p_re, p_im = a->p_im;
    float y0 = 0.f, y1 = 0.f;
    if (live) {
      y0 = a->sy[2 * lane];
      y1 = a->sy[2 * lane + 1];
    }
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const float* in =
              reinterpret_cast<const float*>(R.in_slot<1>(slot)) + lid;
          float* o = reinterpret_cast<float*>(out) +
                     static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, float s) {
                const float y1n = __fsub_rn(__fadd_rn(s, __fmul_rn(p_re, y1)),
                                            __fmul_rn(p_im, y0));
                y0 = __fadd_rn(__fmul_rn(p_im, y1), __fmul_rn(p_re, y0));
                y1 = y1n;
                o[r * kLanes] = y0;
              });
        });
    if (live) {
      a->sy_out[2 * lane] = y0;
      a->sy_out[2 * lane + 1] = y1;
    }
  }
};

// K36's producers: df1_ring.cuh `f32_feed` (K30's too), batches of
// kF32Rows (32) rows.
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    normal_f32_kernel(const __grid_constant__ NormalArgs<float> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, NormalF32Serial{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile; producer 0 writes x = [x1, x2] out
        idsp::ring::f32_feed(a, R, pw, lid, lane, live, a.b0, a.b1, a.b2);
      });
}

// K37: rpll.rs:47-77 on native unsigned words.  bias = 1 << (sf - 1),
// p_ref = (1 << (32 + dt2 - sf)) mod 2^32.
struct RpllParams {
  int dt2, sf, sp;
  uint64_t bias;
  uint32_t p_ref, dt_mask;
};

// A launch: p.d holds the rows, chunk and ring depth (no DF1), p.y the
// phase and frequency planes.
struct RpllArgs {
  Pipe p;
  const int32_t* xs;
  const uint8_t* valids;
  const int32_t *sx, *sff, *sf, *sy;
  int32_t *sx_out, *sff_out, *sf_out, *sy_out;
  RpllParams k;
};

// Producer pw of P: its span of each chunk (df1_ring.cuh `span_batches`),
// in batches of kRpll rows, each row's two words into the input ring: x
// and dt = -x mod 2^dt2 with the mask in bit 31 (dt2 < 32 leaves it
// free).  Every row stands alone: the running last valid timestamp is
// the serial warp's, one select a row off its chain.
constexpr int kRpll = 16;
struct RpllRows {
  uint32_t x[kRpll], v[kRpll];
};

__device__ __forceinline__ void rpll_feed(const RpllArgs& a, const Rings& R,
                                          int pw, int lid, int lane,
                                          bool live) {
  const Pipe& p = a.p;
  const size_t c = static_cast<size_t>(p.c2);
  const int ch = live ? lane : 0;  // dead lanes read lane 0's words
  const int32_t* xp = a.xs + ch;
  const uint8_t* vp = a.valids + ch;
  const uint32_t mask = a.k.dt_mask;
  idsp::ring::span_batches<kRpll, RpllRows>(
      p.d.t, p.d.chunk, p.d.depth, p.producers, pw, R,
      [&](const Batch& b, RpllRows& n, const RpllRows&, bool) {
        if (b.r0 >= p.d.t) return;
#pragma unroll
        for (int u = 0; u < kRpll; ++u) {
          const size_t o =
              static_cast<size_t>(b.r0 + min(b.r + u, b.hi - 1)) * c;
          n.x[u] = static_cast<uint32_t>(__ldg(xp + o));
          n.v[u] = __ldg(vp + o) != 0;
        }
      },
      [&](const Batch& b, const RpllRows& in, int slot) {
        uint2* s = reinterpret_cast<uint2*>(R.in_slot<2>(slot)) + lid;
#pragma unroll
        for (int u = 0; u < kRpll; ++u)
          if (b.r + u < b.hi)
            s[(b.r + u) * kLanes] =
                make_uint2(in.x[u], ((0u - in.x[u]) & mask) | (in.v[u] << 31));
      });
}

// The serial warp: x_prev (the last valid timestamp), ff, f and y of its
// lane in registers, each row's (x, dt | valid << 31) from the input ring
// to (y, f) in the output ring.
// Shift: the regime of `>> sf` (0: sf < 32, a funnel shift of the
// product's words; 1: sf == 32, its high word; 2: sf > 32, that word
// shifted).  On the chain: the product's multiply-add, the shift, the add
// to ff + p_ref, the select (ff); the shift, the multiply, the subtract,
// the shift, the add, the select (f).
template <int Shift>
struct RpllSerial {
  const RpllArgs* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const RpllParams k = a->k;
    const Pipe& p = a->p;
    uint32_t x_prev = 0, ff = 0, f = 0, y = 0;
    if (live) {
      x_prev = static_cast<uint32_t>(a->sx[lane]);
      ff = static_cast<uint32_t>(a->sff[lane]);
      f = static_cast<uint32_t>(a->sf[lane]);
      y = static_cast<uint32_t>(a->sy[lane]);
    }
    const int sh = Shift == 2 ? k.sf - 32 : k.sf, sdy = k.sp - k.dt2;
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const uint2* in =
              reinterpret_cast<const uint2*>(R.in_slot<2>(slot)) + lid;
          uint2* o = reinterpret_cast<uint2*>(out) +
                     static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, uint2 w) {
                const bool valid = static_cast<int32_t>(w.y) < 0;
                const uint32_t dx = w.x - x_prev;
                x_prev = valid ? w.x : x_prev;
                // advance phase: y += f, wrapping
                y += f;
                // frequency lock: the reference phase over dx at the
                // current estimate, rounded half up, against 2^(32 + dt2)
                const uint64_t p64 = idsp::mad_wide_u32(ff, dx, k.bias);
                const uint32_t hi = static_cast<uint32_t>(p64 >> 32);
                uint32_t p_sig;
                if constexpr (Shift == 0) {
                  p_sig = __funnelshift_r(static_cast<uint32_t>(p64), hi, sh);
                } else if constexpr (Shift == 1) {
                  p_sig = hi;
                } else {
                  p_sig = hi >> sh;
                }
                const uint32_t ff2 = ff + (k.p_ref - p_sig);
                // phase lock: the predicted reference phase "now" (f from
                // before this update) against the estimate; dy an
                // arithmetic i32 shift
                const uint32_t y_ref = (f >> k.dt2) * (w.y & 0x7FFFFFFFu);
                const uint32_t dy = static_cast<uint32_t>(
                    static_cast<int32_t>(y_ref - y) >> sdy);
                const uint32_t f2 = ff2 + dy;
                ff = valid ? ff2 : ff;
                f = valid ? f2 : f;
                o[r * kLanes] = make_uint2(y, f);
              });
        });
    if (live) {
      a->sx_out[lane] = static_cast<int32_t>(x_prev);
      a->sff_out[lane] = static_cast<int32_t>(ff);
      a->sf_out[lane] = static_cast<int32_t>(f);
      a->sy_out[lane] = static_cast<int32_t>(y);
    }
  }
};

template <int Shift>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    rpll_kernel(const __grid_constant__ RpllArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<2, 2, idsp::ring::Layout::kPlanes>(
      a.p, smem, RpllSerial<Shift>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        rpll_feed(a, R, pw, lid, lane, live);  // one CTA a tile
      });
}

// A K35 or K36 launch's arguments but the coefficients.
template <class T>
NormalArgs<T> normal_args(const void* xs, void* ys, const void* sx,
                          const void* sy, void* sx_out, void* sy_out, int t,
                          int c, int warps, int producers, int chunk,
                          int ring) {
  NormalArgs<T> a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const T*>(xs);
  a.sx = static_cast<const T*>(sx);
  a.sy = static_cast<const T*>(sy);
  a.sx_out = static_cast<T*>(sx_out);
  a.sy_out = static_cast<T*>(sy_out);
  return a;
}

}  // namespace

// K34: xs (t, c) f32 -> ys (t, c) f32; state lp, hp, bp (c,) f32 each, in
// and out; output 0 lp, 1 hp, 2 bp, 3 br.  warps, producers, chunk, ring
// (slots a ring) and smem are the host plan's (filters/svf_cuda.py
// `svf_plan`); a plan the kernel cannot run is refused.  A refused call
// launches nothing and leaves no CUDA error pending.
extern "C" int idsp_svf_bank(const void* xs, void* ys, const void* lp,
                             const void* hp, const void* bp, void* lp_out,
                             void* hp_out, void* bp_out, int t, int c,
                             int output, float f, float qi, int warps,
                             int producers, int chunk, int ring, int smem,
                             void* stream) {
  if (output < 0 || output > 3 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  SvfArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const float*>(xs);
  a.lp = static_cast<const float*>(lp);
  a.hp = static_cast<const float*>(hp);
  a.bp = static_cast<const float*>(bp);
  a.lp_out = static_cast<float*>(lp_out);
  a.hp_out = static_cast<float*>(hp_out);
  a.bp_out = static_cast<float*>(bp_out);
  a.f = f;
  a.qi = qi;
  using idsp::ring::launch_pipe;
  switch (output) {
    case 0:
      return launch_pipe(svf_kernel<0>, a, a.p, smem, stream);
    case 1:
      return launch_pipe(svf_kernel<1>, a, a.p, smem, stream);
    case 2:
      return launch_pipe(svf_kernel<2>, a, a.p, smem, stream);
    default:
      return launch_pipe(svf_kernel<3>, a, a.p, smem, stream);
  }
}

// K35: xs (t, c) i32 -> ys (t, c) i32; state x, y (c, 2) i32 each, in and
// out; 0 < f < 64, p_im != INT32_MIN.  warps, producers, chunk, ring
// (slots a ring) and smem are the host plan's (filters/normal_cuda.py
// `normal_plan`: two words a row and lane in, one out); a plan the kernel
// cannot run is refused.  A refused call launches nothing and leaves no
// CUDA error pending.
extern "C" int idsp_normal_bank_q(const void* xs, void* ys, const void* sx,
                                  const void* sy, void* sx_out, void* sy_out,
                                  int t, int c, int f, int b0, int b1, int b2,
                                  int p_re, int p_im, int warps,
                                  int producers, int chunk, int ring,
                                  int smem, void* stream) {
  if (f <= 0 || f >= 64 || p_im == INT32_MIN ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                2, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  NormalArgs<int32_t> a = normal_args<int32_t>(
      xs, ys, sx, sy, sx_out, sy_out, t, c, warps, producers, chunk, ring);
  a.b0 = b0;
  a.b1 = b1;
  a.b2 = b2;
  a.p_re = p_re;
  a.p_im = p_im;
  a.n_im = -p_im;
  a.f = f;
  if (f > 32)
    return idsp::ring::launch_pipe(normal_q_kernel<true>, a, a.p, smem,
                                   stream);
  return idsp::ring::launch_pipe(normal_q_kernel<false>, a, a.p, smem,
                                 stream);
}

// K36: xs (t, c) f32 -> ys (t, c) f32; state x, y (c, 2) f32 each; the
// plan as K35's (`normal_plan`: one word a row and lane each way).
extern "C" int idsp_normal_bank_f32(const void* xs, void* ys, const void* sx,
                                    const void* sy, void* sx_out,
                                    void* sy_out, int t, int c, float b0,
                                    float b1, float b2, float p_re,
                                    float p_im, int warps, int producers,
                                    int chunk, int ring, int smem,
                                    void* stream) {
  if (!idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  NormalArgs<float> a = normal_args<float>(
      xs, ys, sx, sy, sx_out, sy_out, t, c, warps, producers, chunk, ring);
  a.b0 = b0;
  a.b1 = b1;
  a.b2 = b2;
  a.p_re = p_re;
  a.p_im = p_im;
  return idsp::ring::launch_pipe(normal_f32_kernel, a, a.p, smem, stream);
}

// K37: xs (t, c) i32 timestamps and valids (t, c) bytes (0 or 1) ->
// phase, freq (t, c) i32; state x, ff, f, y (c,) i32 each (ff, f the u32
// bit patterns), in and out; 0 <= dt2 < 32, 0 < sf < 64, sf <= 32 + dt2,
// 0 <= sp - dt2 < 32.  warps, producers, chunk, ring (slots a ring) and
// smem are the host plan's (filters/rpll_cuda.py `rpll_plan`); a plan
// the kernel cannot run is refused.  A refused call launches nothing and
// leaves no CUDA error pending.
extern "C" int idsp_rpll_bank(const void* xs, const void* valids, void* phase,
                              void* freq, const void* x, const void* ff,
                              const void* f, const void* y, void* x_out,
                              void* ff_out, void* f_out, void* y_out, int t,
                              int c, int dt2, int sf, int sp, int warps,
                              int producers, int chunk, int ring, int smem,
                              void* stream) {
  if (dt2 < 0 || dt2 >= 32 || sf <= 0 || sf >= 64 || sf > 32 + dt2 ||
      sp < dt2 || sp - dt2 >= 32 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                2, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  RpllArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = phase;
  a.p.y[1] = freq;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(phase) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(freq) % 16 == 0;
  a.xs = static_cast<const int32_t*>(xs);
  a.valids = static_cast<const uint8_t*>(valids);
  a.sx = static_cast<const int32_t*>(x);
  a.sff = static_cast<const int32_t*>(ff);
  a.sf = static_cast<const int32_t*>(f);
  a.sy = static_cast<const int32_t*>(y);
  a.sx_out = static_cast<int32_t*>(x_out);
  a.sff_out = static_cast<int32_t*>(ff_out);
  a.sf_out = static_cast<int32_t*>(f_out);
  a.sy_out = static_cast<int32_t*>(y_out);
  a.k = RpllParams{
      dt2,
      sf,
      sp,
      uint64_t{1} << (sf - 1),
      static_cast<uint32_t>((uint64_t{1} << (32 + dt2 - sf)) & 0xFFFFFFFFu),
      static_cast<uint32_t>((uint64_t{1} << dt2) - 1)};
  if (sf < 32)
    return idsp::ring::launch_pipe(rpll_kernel<0>, a, a.p, smem, stream);
  if (sf == 32)
    return idsp::ring::launch_pipe(rpll_kernel<1>, a, a.p, smem, stream);
  return idsp::ring::launch_pipe(rpll_kernel<2>, a, a.p, smem, stream);
}
