// K1, K11 and K18: fixed-point DF1 biquad over a bank of lanes, every
// row out (K1), only the rows 0, d, 2d, ... (K11), or every row of the
// anti-windup DF1 (K18: offset and clamp before feedback).  K26 and K27
// are K1 and K18 with runtime coefficients: each lane loads its five
// words once from (5, c) int32 planes, so a retune is a new planes tensor
// and nothing is rebuilt.
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q` (:225), `df1_bank_q_dec` (:290, `_df1_bank_q_dec_impl`
// :319), `df1_clamp_bank_q` (:696), `df1_bank_q_coef` (:932) and
// `df1_clamp_bank_q_coef` (:999), all `_seq_bank_kernel` (:471; K11
// with its `dec` epilogue) run by `_bank_call` (:395, pallas_call :453).
// Those kernels emulated the 64-bit MACs in 16-bit limbs and tiled lanes
// as (c/128, 128) for the TPU's vector unit; here each product is a
// native 32 x 32 -> 64 multiply-add.
//
// What bounds them on the H100: the recurrence.  y0 of a step feeds the
// next step's a1 y1 and, a row later, a2 y2, so a lane is a serial chain;
// at 1024-2048 lanes the bank is 32-64 tiles of 32 lanes, far from
// filling the card's 132 SMs, and each row waits on the row before's
// latency.  The memory traffic (4 B in and out a sample; K11 4/d B out) is
// small next to that.  When one thread a lane issued the loads, the five
// products, the shift, the clamp and the store (the sequential-bank
// template), a row took ~105 cycles (PERF.md §6).
//
// What the design does: all five run on df1_ring.cuh's depth-0 pipeline,
// a block a 32-lane tile, as K31/K33 (biquad_precision.cu) do with the
// same code.  Producer warps, each a span of every chunk, form each row's
// feed-forward sum W = b0 x0 + b1 x1 + b2 x2 mod 2^64 (`w_feed`: rows 0 and
// 1 of a block take x1, x2 from the state, so spans are independent; K26/
// K27's producers read the lane's b0-b2 from the planes once) into the
// input ring.  The serial warp (`Df1WSerial` without the dither term),
// alone on its scheduler, holds y1 and y2, forms V = W + a2 y2 a row ahead
// and runs the chain -- a1 y1's multiply-add onto V, the shift, the clamp
// for K18/K27, whose clamped y0 is fed back -- from shared memory into the
// output ring.  The shift is one funnel shift for f <= 32 and the high
// word's arithmetic shift for 32 < f < 64, a template instance each.  A store
// warp (df1_ring.cuh `keep_store`, K4's too) writes the rows: K11 only the
// block's rows at r % d == 0 (the state still carries the full-rate
// recurrence; a chunk need not be a multiple of d), K1's f32 output through
// one round-to-nearest int32 -> f32 conversion, off the chain; 16 bytes a
// thread where c % 4 == 0.  The sums wrap mod 2^64, so the split is
// bit-identical to the plain `df1_process_q` and `df1_clamp_process_q`.  The
// plan (warps, producers, chunk, ring depth, shared memory) is the host's
// (filters/biquad_cuda.py `df1_plan`), which the entry points check.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"

namespace {

using idsp::ring::Df1WArgs;
using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;

// K1 (F32 the f32 output), K11 (a.dec > 1), K18 (Clamp), K26 (Planes) and
// K27 (both); Hi for 32 < f < 64.
template <bool F32, bool Clamp, bool Planes, bool Hi>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_pipe_kernel(const __grid_constant__ Df1WArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_roles<2>(
      a.p, smem, idsp::ring::Df1WSerial<false, Clamp, Planes, Hi>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::w_feed<Planes>(a, R, pw, lid, lane, live);
      },
      [&](const Rings& R, const uint32_t* out, int lid, int col0) {
        idsp::ring::keep_store<F32>(a.p, a.dec, R, out, lid, col0);
      });
}

template <bool F32, bool Clamp, bool Planes>
int launch_shift(const Df1WArgs& a, int smem, void* stream) {
  using idsp::ring::launch_pipe;
  return a.k.f > 32
             ? launch_pipe(df1_pipe_kernel<F32, Clamp, Planes, true>, a, a.p,
                           smem, stream)
             : launch_pipe(df1_pipe_kernel<F32, Clamp, Planes, false>, a, a.p,
                           smem, stream);
}

// Checks the call and the plan, then launches the instance of the output
// type, the clamp, the coefficients' source (planes, or k's when null)
// and the shift.  A refused call launches nothing and leaves no CUDA
// error pending.
int launch(const void* xs, void* ys, const void* sx, const void* sy,
           void* sx_out, void* sy_out, const void* planes, int t, int c,
           int dec, int f32_out, const idsp::Df1Coefs& k, int clamp,
           const idsp::Df1Clamp& cl, int warps, int producers, int chunk,
           int ring, int smem, void* stream) {
  if (k.f <= 0 || k.f >= 64 || dec < 1 || t % dec != 0 ||
      (f32_out && (clamp || planes)) ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                2, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Df1WArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const int32_t*>(xs);
  a.sx = static_cast<const int32_t*>(sx);
  a.sy = static_cast<const int32_t*>(sy);
  a.sx_out = static_cast<int32_t*>(sx_out);
  a.sy_out = static_cast<int32_t*>(sy_out);
  a.planes = static_cast<const int32_t*>(planes);
  a.k = k;
  a.cl = cl;
  a.dec = dec;
  if (planes)
    return clamp ? launch_shift<false, true, true>(a, smem, stream)
                 : launch_shift<false, false, true>(a, smem, stream);
  if (clamp) return launch_shift<false, true, false>(a, smem, stream);
  return f32_out ? launch_shift<true, false, false>(a, smem, stream)
                 : launch_shift<false, false, false>(a, smem, stream);
}

}  // namespace

// K1: xs (t, c) i32 -> ys (t, c) i32 or f32; state (c, 2) i32 x2 in and
// out; 0 < f < 64.  warps, producers, chunk, ring (slots a ring) and smem
// are the host plan's (filters/biquad_cuda.py `df1_plan`) here and in the
// four entries below; a plan the kernel cannot run is refused.
extern "C" int idsp_df1_bank_q(const void* xs, void* ys, const void* sx,
                               const void* sy, void* sx_out, void* sy_out,
                               int t, int c, int f, int f32_out, int b0,
                               int b1, int b2, int a1, int a2, int warps,
                               int producers, int chunk, int ring, int smem,
                               void* stream) {
  return launch(xs, ys, sx, sy, sx_out, sy_out, nullptr, t, c, 1, f32_out,
                idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, 0, idsp::Df1Clamp{},
                warps, producers, chunk, ring, smem, stream);
}

// K11: as K1, keeping the rows 0, dec, 2*dec, ...: ys (t/dec, c), t a
// multiple of dec.
extern "C" int idsp_df1_bank_q_dec(const void* xs, void* ys, const void* sx,
                                   const void* sy, void* sx_out,
                                   void* sy_out, int t, int c, int dec,
                                   int f, int f32_out, int b0, int b1, int b2,
                                   int a1, int a2, int warps, int producers,
                                   int chunk, int ring, int smem,
                                   void* stream) {
  return launch(xs, ys, sx, sy, sx_out, sy_out, nullptr, t, c, dec, f32_out,
                idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, 0, idsp::Df1Clamp{},
                warps, producers, chunk, ring, smem, stream);
}

// K18: K1 with the anti-windup clamp (df1.cuh `Df1Clamp`): xs (t, c) i32
// -> ys (t, c) i32; state (c, 2) i32 x2 in and out.
extern "C" int idsp_df1_clamp_bank_q(const void* xs, void* ys, const void* sx,
                                     const void* sy, void* sx_out,
                                     void* sy_out, int t, int c, int f,
                                     int b0, int b1, int b2, int a1, int a2,
                                     int u, int lo, int hi, int warps,
                                     int producers, int chunk, int ring,
                                     int smem, void* stream) {
  return launch(xs, ys, sx, sy, sx_out, sy_out, nullptr, t, c, 1, 0,
                idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, 1,
                idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk, ring,
                smem, stream);
}

// K26: xs (t, c) i32 -> ys (t, c) i32; planes (5, c) i32 (not null);
// state (c, 2) i32 x2 in and out.
extern "C" int idsp_df1_bank_q_coef(const void* xs, void* ys, const void* sx,
                                    const void* sy, void* sx_out,
                                    void* sy_out, const void* planes, int t,
                                    int c, int f, int warps, int producers,
                                    int chunk, int ring, int smem,
                                    void* stream) {
  if (!planes) return static_cast<int>(cudaErrorInvalidValue);
  return launch(xs, ys, sx, sy, sx_out, sy_out, planes, t, c, 1, 0,
                idsp::Df1Coefs{0, 0, 0, 0, 0, f}, 0, idsp::Df1Clamp{}, warps,
                producers, chunk, ring, smem, stream);
}

// K27: K26 with the anti-windup clamp (u, lo, hi).
extern "C" int idsp_df1_clamp_bank_q_coef(
    const void* xs, void* ys, const void* sx, const void* sy, void* sx_out,
    void* sy_out, const void* planes, int t, int c, int f, int u, int lo,
    int hi, int warps, int producers, int chunk, int ring, int smem,
    void* stream) {
  if (!planes) return static_cast<int>(cudaErrorInvalidValue);
  return launch(xs, ys, sx, sy, sx_out, sy_out, planes, t, c, 1, 0,
                idsp::Df1Coefs{0, 0, 0, 0, 0, f}, 1,
                idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk, ring,
                smem, stream);
}
