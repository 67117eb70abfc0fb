// K1: fixed-point DF1 biquad over a bank of lanes.
//
// Replaces the Pallas kernel of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q` (:225; `_seq_bank_kernel` :471 run by `_bank_call` :453).
// That kernel emulated the 64-bit MACs in 16-bit limbs and tiled lanes
// as (c/128, 128) for the TPU's vector unit; here each product is a
// native 32x32->64 multiply and a lane is one thread.
//
// What bounds it on the H100: the recurrence.  y0 of a step feeds the
// next step's MACs, so one lane is a serial chain of five 64-bit
// multiply-adds, a shift and the register moves per sample.  At 1024
// lanes (c = 512 I|Q) the whole bank is 32 warps: a few per SM, far
// from filling the card, and each step waits on the previous one's
// latency.  The memory traffic (4 B in, 4 B out per sample) is small
// next to that.
//
// What the design does about it: one thread per lane with the state in
// registers, on the sequential-bank template of seq_bank.cuh: rows are
// read coalesced along lanes, and the next group of kBankGroup rows is
// loaded while the current group computes, so global load latency stays
// off the serial chain.  Blocks of 32 lanes spread the warps over as
// many SMs as there are warps.  Widening the parallelism beyond one
// thread per lane (the affine-prefix form of idsp_tpu/parallel) is
// later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

template <bool F32Out>
__global__ void __launch_bounds__(kBankLanes)
    df1_bank_kernel(const int32_t* __restrict__ xs, void* __restrict__ ys,
                    const int32_t* __restrict__ sx,
                    const int32_t* __restrict__ sy, int32_t* __restrict__ sx_out,
                    int32_t* __restrict__ sy_out, int t, int c,
                    idsp::Df1Coefs k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  idsp::seq_bank<false>(
      xs, t, c, lane, 1, [&](int32_t x) { return s.step(k, x); },
      [&](size_t i, int32_t y) {
        if constexpr (F32Out) {
          static_cast<float*>(ys)[i] = static_cast<float>(y);
        } else {
          static_cast<int32_t*>(ys)[i] = y;
        }
      });
  s.store(sx_out, sy_out, lane);
}

}  // namespace

// xs (t, c) i32 -> ys (t, c) i32 or f32; state (c, 2) i32 x2 in and out.
extern "C" int idsp_df1_bank_q(const void* xs, void* ys, const void* sx,
                               const void* sy, void* sx_out, void* sy_out,
                               int t, int c, int f, int f32_out, int b0,
                               int b1, int b2, int a1, int a2, void* stream) {
  const idsp::Df1Coefs k{b0, b1, b2, a1, a2, f};
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int32_t*>(sy);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int32_t*>(sy_out);
  if (f32_out) {
    df1_bank_kernel<true><<<grid, kBankLanes, 0, st>>>(x, ys, ix, iy, ox, oy, t, c, k);
  } else {
    df1_bank_kernel<false><<<grid, kBankLanes, 0, st>>>(x, ys, ix, iy, ox, oy, t, c, k);
  }
  return static_cast<int>(cudaGetLastError());
}
