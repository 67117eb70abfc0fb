// K5: the type-2, order-3 PLL over a bank of channels.
//
// Replaces the Pallas kernel of idsp_tpu/filters/pll_pallas.py
// `pll_bank` (:93, body `_pll_body` :43, run by `_seq_bank_kernel` /
// `_bank_call` of biquad_pallas.py).  That kernel carried a 9-row
// packed state with the two int64 words as (hi i32, lo u32) planes and
// the u32 x i32 noise-shaping product in limbs; here one thread per
// channel keeps the seven state words in registers, two of them native
// int64 (pll.cuh).
//
// What bounds it on the H100: the update is nonlinear (the wrap clamp)
// and serial, about forty dependent integer operations per sample, and
// c channels are only c/32 warps.  The traffic, 4 B in and 4 B out per
// sample, is small next to that.
//
// What the design does about it: the sequential-bank template
// (seq_bank.cuh): state in registers, the input phases prefetched one
// group ahead of the chain.
#include <cuda_runtime.h>

#include <cstdint>

#include "pll.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

__global__ void __launch_bounds__(kBankLanes)
    pll_bank_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys,
                    idsp::PllWords w_in, idsp::PllWords w_out, int t, int c,
                    idsp::PllCoefs k) {
  const int ch = blockIdx.x * kBankLanes + threadIdx.x;
  if (ch >= c) return;
  idsp::PllLane s;
  s.load(w_in, ch);
  idsp::seq_bank<false>(
      xs, t, c, ch, 1, [&](int32_t x) { return s.step(k, x); },
      [&](size_t i, int32_t y) { ys[i] = y; });
  s.store(w_out, ch);
}

}  // namespace

// xs (t, c) i32 phases -> ys (t, c) i32; state_in / state_out: host
// arrays of the seven state-word device pointers (pll.cuh PllWords),
// each (c,).
extern "C" int idsp_pll_bank(const void* xs, void* ys,
                             void* const* state_in, void* const* state_out,
                             int t, int c, int b0, int b1, int a1,
                             void* stream) {
  idsp::PllWords w_in, w_out;
  for (int i = 0; i < 7; ++i) {
    w_in.p[i] = state_in[i];
    w_out.p[i] = state_out[i];
  }
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  pll_bank_kernel<<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(ys), w_in, w_out,
      t, c, idsp::PllCoefs{b0, b1, a1});
  return static_cast<int>(cudaGetLastError());
}
