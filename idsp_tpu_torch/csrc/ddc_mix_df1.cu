// K14: the exact-LO conjugate mix fused into the Q<f> DF1 biquad bank.
//
// Replaces the Pallas kernel of idsp_tpu/filters/ddc_pallas.py
// `ddc_mix_df1_bank` (:47; `_ddc_mix_df1_bank_impl` :80, pallas_call
// :175).  On the TPU each time chunk first mixed its rows vectorized
// into VMEM scratch (the LO from `trig.cossin`, its 128-entry lookup a
// compare/select chain of 128 steps per sample, in sub-chunks to bound
// the temporaries), then ran the sequential DF1 over the scratch.
//
// Lane `lane` of the 2c I|Q lanes (I in [0, c), Q in [c, 2c)) belongs to
// channel ch = lane mod c; row i (0-based) of the block mixes with the
// LO at phase phase0[ch] + steps[ch] * (i + 1), wrapping (the `accu.ramp_t`
// convention):
//
//   I lanes  (cos * x[i]) >> 32,   Q lanes  (-sin * x[i]) >> 32
//
// the high word of the exact i64 product (`__mulhi`), which equals
// `fxp.q_apply(., x, 32)`; then the df1.cuh step, out as i32 or as f32.
//
// What bounds it on the H100: the DF1 recurrence, serial in time in each
// lane: ~42 cycles a row for the DF1 warp of df1_ring.cuh (K20's pace,
// PERF.md §6).  The mix is ~45 instructions a row and lane (the cossin,
// the multiply), none of them on that chain; the device memory traffic is
// x (t,) in and 4 B per lane and row out.
//
// What the design does about it: K3's pipeline at depth 0 (df1_ring.cuh
// `run_pipe`).  A block is one 32-lane tile of the 2c lanes; `producers`
// warps compute the mixed rows of their index mod their count into the
// input ring (the LUT in shared memory, x[i] one word for the whole warp,
// kMix rows' loads issued before their products), the DF1 warp alone on
// its scheduler turns each slot into a slot of the output ring, and a
// store warp writes those rows out, 128 bytes a row.  The LO is
// computed per lane, by the I and the Q tiles of a channel each.  The plan
// (warps, roles, chunk, ring depth, shared memory) is the host's
// (filters/pipe_plan.py `pipe_plan`), which the entry point checks.
//
// Numerics: cossin.cuh's exact LO, `__mulhi`, df1.cuh's exact int64
// recurrence, the f32 output one rounding of the int32 word: bit for bit
// the plain version's, and no plan changes a value.
#include <cuda_runtime.h>

#include <cstdint>

#include "cossin.cuh"
#include "df1.cuh"
#include "df1_ring.cuh"

namespace {

using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;
using idsp::sm90::Cursor;
using idsp::sm90::mbar_arrive;
using idsp::sm90::mbar_wait;

struct MixArgs {
  Pipe p;
  const int32_t *x, *phase0, *steps;
};

// Producer pw of P: the mixed rows pw, pw + P, ... of each chunk into the
// input ring, kMix of them at a time.
constexpr int kMix = 8;
__device__ __forceinline__ void mix(const MixArgs& a, const Rings& R,
                                    const uint32_t* lut, int pw, int lid,
                                    int lane, bool live) {
  const Pipe& p = a.p;
  const int P = p.producers, c = p.c2 / 2;
  const bool is_q = lane >= c;
  const int ch = is_q ? lane - c : lane;
  const uint32_t p0 = live ? static_cast<uint32_t>(a.phase0[ch]) : 0u;
  const uint32_t step = live ? static_cast<uint32_t>(a.steps[ch]) : 0u;
  Cursor u;
  for (int r0 = 0; r0 < p.d.t; r0 += p.d.chunk, u.next(p.d.depth)) {
    const int rows = min(p.d.chunk, p.d.t - r0);
    mbar_wait(R.empty_in(u.k), u.ph ^ 1);
    int32_t* s = R.in_slot(u.k) + lid;
    for (int r = pw; r < rows; r += P * kMix) {
      // every row of a batch computed (one past the chunk re-reads its
      // last x), so the kMix LOs are straight-line code that schedules
      // together; the stores keep the chunk's rows
      int32_t m[kMix];
#pragma unroll
      for (int v = 0; v < kMix; ++v) {
        const int rv = r + v * P;
        const int32_t xv = __ldg(a.x + r0 + min(rv, rows - 1));
        const idsp::CosSin lo =
            idsp::cossin(lut, p0 + step * static_cast<uint32_t>(r0 + rv + 1));
        const int32_t g =
            is_q ? static_cast<int32_t>(0u - static_cast<uint32_t>(lo.sin))
                 : lo.cos;
        m[v] = __mulhi(g, xv);
      }
#pragma unroll
      for (int v = 0; v < kMix; ++v)
        if (r + v * P < rows) s[(r + v * P) * kLanes] = m[v];
    }
    mbar_arrive(R.full_in(u.k));
  }
}

template <class Out>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    ddc_mix_df1_kernel(const __grid_constant__ MixArgs a) {
  __shared__ uint32_t lut[idsp::kCosSinLutSize];
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < idsp::kCosSinLutSize; i += blockDim.x)
    lut[i] = idsp::kCosSinLut[i];  // published by run_pipe's barrier
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::ring::Df1Serial<Out>{&a.p.d},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        mix(a, R, lut, pw, lid, lane, live);  // one CTA a tile
      });
}

}  // namespace

// x (t,) i32, phase0/steps (c,) i32 -> ys (t, 2c) i32 or f32 (f32_out);
// DF1 state (2c, 2) i32 x2 in and out.  warps, producers, chunk, ring
// (slots a ring) and smem are the host plan's (filters/ddc_cuda.py
// `mix_plan`); a plan the kernel cannot run (smem not its own sum, or
// more than a block may have) is refused.  A refused call launches
// nothing and leaves no CUDA error pending.
extern "C" int idsp_ddc_mix_df1(const void* x, const void* phase0,
                                const void* steps, const void* sx,
                                const void* sy, void* sx_out, void* sy_out,
                                void* ys, int t, int c, int f, int f32_out,
                                int b0, int b1, int b2, int a1, int a2,
                                int warps, int producers, int chunk,
                                int ring, int smem, void* stream) {
  if (c < 1 || f <= 0 || f >= 64 ||
      !idsp::ring::pipe_plan_ok(t, 2 * c, warps, producers, chunk, ring,
                                smem))
    return static_cast<int>(cudaErrorInvalidValue);
  MixArgs a{};
  a.p.d = idsp::ring::Df1Ring{t,
                              chunk,
                              ring,
                              static_cast<const int32_t*>(sx),
                              static_cast<const int32_t*>(sy),
                              static_cast<int32_t*>(sx_out),
                              static_cast<int32_t*>(sy_out),
                              idsp::Df1Coefs{b0, b1, b2, a1, a2, f},
                              idsp::Df1Clamp{}};
  a.p.y[0] = ys;
  a.p.c2 = 2 * c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = (2 * c) % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.x = static_cast<const int32_t*>(x);
  a.phase0 = static_cast<const int32_t*>(phase0);
  a.steps = static_cast<const int32_t*>(steps);
  return f32_out ? idsp::ring::launch_pipe(ddc_mix_df1_kernel<float>, a, a.p,
                                           smem, stream)
                 : idsp::ring::launch_pipe(ddc_mix_df1_kernel<int32_t>, a,
                                           a.p, smem, stream);
}
