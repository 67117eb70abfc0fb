// K4: the integer Lowpass<N> over a bank of lanes, with an optional
// keep-1-in-dec output.
//
// Replaces the Pallas kernel of idsp_tpu/filters/lowpass_pallas.py
// `lowpass_bank` (:69, body `_lp_body` :42, run by `_seq_bank_kernel`
// / `_bank_call` of biquad_pallas.py).  That kernel emulated the int64
// state as (hi i32, lo u32) plane pairs on (c/128, 128) tiles; here the
// state is two native 64-bit registers of one lane of a serial warp.
//
// What bounds it on the H100: the recurrence.  Each sample's update waits
// on the previous one's p0 high word; the #5 bank's 2048 lanes are 64
// tiles of 32, far from filling 132 SMs.  Traffic is 4 B in per sample
// and 4/dec B out.  When one thread a lane issued the loads, the whole
// step in the plain order and the stores (the sequential-bank template), a
// row took ~111 cycles (PERF.md §6).
//
// What the design does: df1_ring.cuh's depth-0 pipeline, a block a 32-lane
// tile, as K34's (structures_bank.cu).  Producer warps, each a span of
// every chunk, copy x into the input ring a batch ahead (`copy_feed`); the
// serial warp alone on its scheduler runs lowpass.cuh's `LpSerial`, whose
// chain is the saturating subtract, e k0's multiply and the adds onto p0
// (the rest of the regrouped sums formed beside it), from shared memory
// into the output ring; the store warp keeps the block's rows r
// with r % dec == 0 (`keep_store`, K1/K11's; a chunk need not be a
// multiple of dec), 16 bytes a thread where c % 4 == 0.  The sums wrap mod
// 2^64, so the regrouping is bit-identical to `lowpass.block` followed by
// ys[::dec].  The plan (warps, producers, chunk, ring depth, shared
// memory) is the host's (filters/lowpass_cuda.py `lowpass_plan`), which
// the entry point checks.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1_ring.cuh"
#include "lowpass.cuh"

namespace {

using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;

// A launch: p.d holds the rows, chunk and ring depth (no DF1), p.y the
// (t/dec, c) output; xs (t, c); the Lowpass state and gains.
struct LpBankArgs {
  Pipe p;
  const int32_t* xs;
  idsp::LpArgs lp;
  int dec;
};

template <int N>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    lowpass_pipe_kernel(const __grid_constant__ LpBankArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_roles<1>(
      a.p, smem, idsp::LpSerial<N>{&a.p, &a.lp},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::copy_feed(a.p, R, pw, lid, lane, live, a.xs);
      },
      [&](const Rings& R, const uint32_t* out, int lid, int col0) {
        idsp::ring::keep_store<false>(a.p, a.dec, R, out, lid, col0);
      });
}

}  // namespace

// xs (t, c) i32 -> ys (t/dec, c) i32 (the rows 0, dec, 2 dec, ...; t a
// multiple of dec); state p (c, n) i64 in and out; n = 1 or 2, gains k0
// (and k1 for n = 2).  warps, producers, chunk, ring (slots a ring) and
// smem are the host plan's (filters/lowpass_cuda.py `lowpass_plan`); a
// plan the kernel cannot run is refused.  A refused call launches nothing
// and leaves no CUDA error pending.
extern "C" int idsp_lowpass_bank(const void* xs, void* ys, const void* p_in,
                                 void* p_out, int t, int c, int n, int dec,
                                 int k0, int k1, int warps, int producers,
                                 int chunk, int ring, int smem,
                                 void* stream) {
  if ((n != 1 && n != 2) || dec < 1 || t % dec != 0 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  LpBankArgs a{};
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
  a.lp = idsp::LpArgs{static_cast<const int64_t*>(p_in),
                      static_cast<int64_t*>(p_out), idsp::LpGains{k0, k1}};
  a.dec = dec;
  using idsp::ring::launch_pipe;
  return n == 1 ? launch_pipe(lowpass_pipe_kernel<1>, a, a.p, smem, stream)
                : launch_pipe(lowpass_pipe_kernel<2>, a, a.p, smem, stream);
}
