// K5: the type-2, order-3 PLL over a bank of channels.
//
// Replaces the Pallas kernel of idsp_tpu/filters/pll_pallas.py
// `pll_bank` (:93, body `_pll_body` :43, run by `_seq_bank_kernel` /
// `_bank_call` of biquad_pallas.py, pallas_call :453).  That kernel carried
// a 9-row packed state with the two int64 words as (hi i32, lo u32) planes
// and the u32 x i32 noise-shaping product in limbs; here a lane of a serial
// warp keeps the seven state words in registers, two of them native int64
// (pll.cuh).
//
// What bounds it on the H100: the recurrence.  Each row's update is
// nonlinear (the wrap clamp) and waits on the previous row's frequency
// high word; the #5 bank's 1024 channels are 32 tiles of 32, far from
// filling 132 SMs.  Traffic is 4 B in and 4 B out per row and channel.
// When one thread a channel issued the loads, the whole step in the plain
// order and the stores (the sequential-bank template), a row took ~130-220
// cycles (PERF.md §6).
//
// What the design does: df1_ring.cuh's depth-0 pipeline, a block a 32-lane
// tile, as K4's (lowpass_bank.cu).  Producer warps, each a span of every
// chunk, copy the phases into the input ring a batch ahead (`copy_feed`);
// the serial warp alone on its scheduler runs pll.cuh's `PllSerial`, whose
// chain is hi(f)'s add into the phase, one compare for the wrap, y0's pick
// among three candidates and one 64-bit multiply-add (the rest of the
// regrouped sums formed beside it), from shared memory into the output
// ring; the store
// warp writes the rows, 16 bytes a thread where c % 4 == 0 (`store_warp`).
// The sums wrap mod 2^32 and 2^64, so the regrouping is bit-identical to
// `pll.block`.  The plan (warps, producers, chunk, ring depth, shared
// memory) is the host's (filters/pll_cuda.py `pll_plan`), which the entry
// point checks.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1_ring.cuh"
#include "pll.cuh"

namespace {

using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;

// A launch: p.d holds the rows, chunk and ring depth (no DF1), p.y the
// (t, c) output; xs (t, c); the PLL's state words and coefficients.
struct PllBankArgs {
  Pipe p;
  const int32_t* xs;
  idsp::PllArgs pll;
};

__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    pll_pipe_kernel(const __grid_constant__ PllBankArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::PllSerial{&a.p, &a.pll},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::copy_feed(a.p, R, pw, lid, lane, live, a.xs);
      });
}

}  // namespace

// xs (t, c) i32 phases -> ys (t, c) i32; state_in / state_out: host
// arrays of the seven state-word device pointers (pll.cuh PllWords),
// each (c,).  warps, producers, chunk, ring (slots a ring) and smem are
// the host plan's (filters/pll_cuda.py `pll_plan`); a plan the kernel
// cannot run is refused.  A refused call launches nothing and leaves no
// CUDA error pending.
extern "C" int idsp_pll_bank(const void* xs, void* ys,
                             void* const* state_in, void* const* state_out,
                             int t, int c, int b0, int b1, int a1, int warps,
                             int producers, int chunk, int ring, int smem,
                             void* stream) {
  if (!idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  PllBankArgs a{};
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
  for (int i = 0; i < 7; ++i) {
    a.pll.in.p[i] = state_in[i];
    a.pll.out.p[i] = state_out[i];
  }
  a.pll.k = idsp::PllCoefs{b0, b1, a1};
  return idsp::ring::launch_pipe(pll_pipe_kernel, a, a.p, smem, stream);
}
