// K16: the float DDC / lock-in bank in one kernel: quadrature mix with a
// factored LO, then an f32 DF1 lowpass on every I and Q lane.
//
// Replaces the Pallas kernel of idsp_tpu/filters/ddc_pallas.py
// `ddc_lockin_bank` (:1359; `_ddc_lockin_bank_impl` :1405, pallas_call
// :1502).  On the TPU each time chunk mixed its rows vectorized into a
// VMEM scratch ((tc, 2c) f32), then a sequential fori_loop ran the DF1
// over the scratch.
//
// The LO of channel ch at row i = k*tc + b factors by angle addition
// (`lockin_tables`: phases in f64 mod tau, cos/sin in f32):
//
//   lo_re = ca[k]*cb[b] - sa[k]*sb[b],   lo_im = sa[k]*cb[b] + ca[k]*sb[b]
//   I = x[i] * lo_re,                    Q = -(x[i] * lo_im)
//
// then y0 = b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2 per lane, summed left to
// right (the plain `df1_process`).  Every multiply and add is a
// single-rounding intrinsic in the plain version's order: kernel == plain
// bit for bit, given the same tables.  The factorisation depends on tc, so
// both take the same tc.
//
// What bounds it on the H100: the f32 DF1 recurrence, serial in time in
// each of the 2c lanes.  Only a1*y1 and the two adds after it wait on the
// row before: W = (b0*x0 + b1*x1) + b2*x2 needs the inputs alone, and
// a2*y2 the output of two rows before; the serial warp takes ~19 cycles a
// row.  The LO, the mix and W are ~15 f32 operations a row and lane and
// two loads (x and the fine (cos, sin) pair); with the addresses and the
// selects the producers' compiled batch loop holds ~80 instructions a row
// (both of its load paths), and they set the pace (~28 cycles a row with
// 11 of them, PERF.md §6).  Memory: the
// (t, 2c) f32 output, 4 B per lane and row; the input is one (t,) stream
// and tables of (t/tc + tc) rows.
//
// What the design does about it: df1_ring.cuh's depth-0 pipeline
// (`run_pipe`), a block a tile of 32 consecutive lanes of the 2c I|Q lanes.
// `producers` warps (11 by default), each a span of every chunk
// (`span_batches`, batches of kLockin rows, the next batch's loads in
// flight while one is formed; fastlo.cuh `load_lo_rows`: one coarse load a
// batch), form the LO, the mix and W of each row into the input ring: a
// span takes its first two rows' x1 and x2 from the mix of the rows before
// it (at the block's start from the state), later batches from the batch
// before.  The serial warp, alone on its scheduler, holds y1 and y2, forms
// a2*y2 a row ahead (off its chain) and runs three rounded ops a row on
// the chain, (W + a1*y1) + a2*y2, from shared memory into the output ring
// (df1_ring.cuh `Df1F32Serial`, K30's too);
// a store warp writes the rows, 16 bytes a thread where 2c % 4 == 0.
// Neither the LO nor the mix reaches device memory, and the chunk, which
// shared memory bounds, is the plan's, independent of tc.  The plan
// (warps, roles, chunk, ring depth, shared memory) is the host's
// (filters/ddc_lockin_cuda.py `lockin_plan` on filters/pipe_plan.py), which
// the entry point checks.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"
#include "fastlo.cuh"  // load_lo_rows

namespace {

using idsp::ring::Batch;
using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;

// A launch: p.d the rows, chunk and ring depth (no DF1), p.y[0] the
// (t, 2c) f32 output, p.c2 = 2c; x (t,); the coarse (ca, sa) (t/tc, c) and
// fine (cb, sb) (tc, c) LO factors, float2 each; the DF1 state (2c, 2) in
// and out.
struct LockinArgs {
  Pipe p;
  const float* x;
  const float2 *coarse, *fine;
  const float *sx, *sy;
  float *sx_out, *sy_out;
  int c, tc;
  idsp::Df1CoefsF32 k;
};

// A producer's batch: kLockin rows' x and LO factors, and where the batch
// starts a span, the two rows before it.
constexpr int kLockin = 8;
struct LockinRows {
  idsp::LoRows<kLockin, float> r;
  idsp::LoRows<2, float> pre;  // rows -2, -1 of the batch
  bool fresh;                  // starts a span: pre loaded
};

// The mixed sample of one row: lo_re * x (I) or -(lo_im * x) (Q), with co
// = (ca, sa) and fi = (cb, sb).  With u, v = ca, sa (I) or sa, ca (Q):
// u*cb -+ v*sb is lo_re or lo_im (a subtraction is the addition of the
// negated term, the same rounding).
__device__ __forceinline__ float lo_mix(float x, float2 co, float2 fi,
                                        bool is_q) {
  const float u = is_q ? co.y : co.x, v = is_q ? co.x : co.y;
  const float p = __fmul_rn(u, fi.x), q = __fmul_rn(v, fi.y);
  const float m = __fmul_rn(x, __fadd_rn(p, is_q ? q : -q));
  return is_q ? -m : m;
}

// Producer pw of P: its span of each chunk, the rows' W = (b0*x0 +
// b1*x1) + b2*x2 into the input ring (f32 words).  Producer 0 also writes
// the block's last two mixed samples out as the state's x.
__device__ __forceinline__ void lockin_feed(const LockinArgs& a,
                                            const Rings& R, int pw, int lid,
                                            int lane, bool live) {
  const int t = a.p.d.t, tc = a.tc, c = a.c;
  const int l = live ? lane : 0;  // dead lanes read lane 0's words
  const bool is_q = l >= c;
  const int ch = is_q ? l - c : l;
  const float* x = a.x;
  const float2 *co = a.coarse + ch, *fi = a.fine + ch;  // this lane's
  const float x1 = a.sx[2 * l], x2 = a.sx[2 * l + 1];  // rows -1, -2
  const idsp::Df1CoefsF32 k = a.k;
  auto row = [&](int g) {  // the mixed sample of block row g >= -2
    if (g < 0) return g == -1 ? x1 : x2;
    idsp::LoRows<1, float> w;
    idsp::load_lo_rows(w, x, co, fi, c, tc, t, g);
    return lo_mix(w.x[0], w.co[0], w.fi[0], is_q);
  };
  float m1 = 0.f, m2 = 0.f;  // the last two rows of the batch formed last
  idsp::ring::span_batches<kLockin, LockinRows>(
      t, a.p.d.chunk, a.p.d.depth, a.p.producers, pw, R,
      [&](const Batch& b, LockinRows& n, const LockinRows&, bool same) {
        if (b.r0 >= t) return;
        const int g0 = b.r0 + b.r;
        n.fresh = !same;
        if (!same && g0 >= 2) idsp::load_lo_rows(n.pre, x, co, fi, c, tc, t,
                                                 g0 - 2);
        if (!same && g0 == 1) idsp::load_lo_rows(n.pre, x, co, fi, c, tc, t,
                                                 0);
        idsp::load_lo_rows(n.r, x, co, fi, c, tc, t, g0);
      },
      [&](const Batch& b, const LockinRows& n, int slot) {
        const int g0 = b.r0 + b.r;
        float m[kLockin + 2];
        if (n.fresh) {  // rows g0 - 2, g0 - 1 (before the block: the state)
          const auto& p = n.pre;
          m[0] = g0 >= 2 ? lo_mix(p.x[0], p.co[0], p.fi[0], is_q)
                         : g0 == 1 ? x1 : x2;
          m[1] = g0 >= 2   ? lo_mix(p.x[1], p.co[1], p.fi[1], is_q)
                 : g0 == 1 ? lo_mix(p.x[0], p.co[0], p.fi[0], is_q)
                           : x1;
        } else {
          m[0] = m2;
          m[1] = m1;
        }
#pragma unroll
        for (int v = 0; v < kLockin; ++v)
          m[v + 2] = lo_mix(n.r.x[v], n.r.co[v], n.r.fi[v], is_q);
        float* s = reinterpret_cast<float*>(R.in_slot(slot)) + lid;
#pragma unroll
        for (int v = 0; v < kLockin; ++v) {
          const float w = __fadd_rn(
              __fadd_rn(__fmul_rn(k.b0, m[v + 2]), __fmul_rn(k.b1, m[v + 1])),
              __fmul_rn(k.b2, m[v]));
          if (b.r + v < b.hi) s[(b.r + v) * kLanes] = w;
        }
        // a batch of fewer rows ends its span: nothing continues from it
        m2 = m[kLockin];
        m1 = m[kLockin + 1];
      });
  if (pw == 0 && live) {
    a.sx_out[2 * lane] = row(t - 1);
    a.sx_out[2 * lane + 1] = row(t - 2);
  }
}

__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    ddc_lockin_kernel(const __grid_constant__ LockinArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::ring::Df1F32Serial<LockinArgs>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        lockin_feed(a, R, pw, lid, lane, live);  // one CTA a tile
      });
}

}  // namespace

// x (t,) f32; coarse, the (ca, sa) pairs (t/tc, c), and fine, the (cb, sb)
// pairs (tc, c), float2 each -> ys (t, 2c) f32, I lanes then Q lanes; DF1
// state x/y (2c, 2) f32 in and out; t % tc == 0.  warps, producers, chunk,
// ring (slots a ring) and smem are the host plan's
// (filters/ddc_lockin_cuda.py `lockin_plan`); a plan the kernel cannot run
// is refused.  A refused call launches nothing and leaves no CUDA error
// pending.
extern "C" int idsp_ddc_lockin(const void* x, const void* coarse,
                               const void* fine, const void* sx,
                               const void* sy, void* sx_out,
                               void* sy_out, void* ys, int t, int c, int tc,
                               float b0, float b1, float b2, float a1,
                               float a2, int warps, int producers, int chunk,
                               int ring, int smem, void* stream) {
  if (c < 1 || tc < 1 || t % tc != 0 || !idsp::fastlo_offsets_ok(t, tc, c) ||
      !idsp::ring::pipe_plan_ok(t, 2 * c, warps, producers, chunk, ring,
                                smem))
    return static_cast<int>(cudaErrorInvalidValue);
  LockinArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = 2 * c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = (2 * c) % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.x = static_cast<const float*>(x);
  a.coarse = static_cast<const float2*>(coarse);
  a.fine = static_cast<const float2*>(fine);
  a.sx = static_cast<const float*>(sx);
  a.sy = static_cast<const float*>(sy);
  a.sx_out = static_cast<float*>(sx_out);
  a.sy_out = static_cast<float*>(sy_out);
  a.c = c;
  a.tc = tc;
  a.k = idsp::Df1CoefsF32{b0, b1, b2, a1, a2};
  return idsp::ring::launch_pipe(ddc_lockin_kernel, a, a.p, smem, stream);
}
