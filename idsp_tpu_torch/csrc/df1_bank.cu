// K1 and K11: fixed-point DF1 biquad over a bank of lanes, every row
// out (K1) or only the rows 0, d, 2d, ... (K11).
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q` (:225) and `df1_bank_q_dec` (:290, `_df1_bank_q_dec_impl`
// :319), both `_seq_bank_kernel` (:471; K11 with its `dec` epilogue) run
// by `_bank_call` (:395, pallas_call :453).  Those kernels emulated the
// 64-bit MACs in 16-bit limbs and tiled lanes as (c/128, 128) for the
// TPU's vector unit; here each product is a native 32x32->64 multiply
// and a lane is one thread.
//
// What bounds it on the H100: the recurrence.  y0 of a step feeds the
// next step's MACs, so one lane is a serial chain of five 64-bit
// multiply-adds, a shift and the register moves per sample.  At 1024
// lanes (c = 512 I|Q) the whole bank is 32 warps: a few per SM, far
// from filling the card, and each step waits on the previous one's
// latency.  The memory traffic (4 B in, 4 B out per sample; K11 4/d B
// out) is small next to that.
//
// What the design does about it: one thread per lane with the state in
// registers, on the sequential-bank template of seq_bank.cuh: rows are
// read coalesced along lanes, and the next group of kBankGroup rows is
// loaded while the current group computes, so global load latency stays
// off the serial chain.  Blocks of 32 lanes spread the warps over as
// many SMs as there are warps.  K11 is the same loop with the template's
// keep-1-in-d epilogue (seq_bank.cuh `Keep`, as K4 runs it): only the
// kept rows reach device memory, and the state carries the full-rate
// recurrence.  Widening the parallelism beyond one thread per lane (the
// affine-prefix form of idsp_tpu/parallel) is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

template <bool F32Out, bool Decimate>
__global__ void __launch_bounds__(kBankLanes)
    df1_bank_kernel(const int32_t* __restrict__ xs, void* __restrict__ ys,
                    const int32_t* __restrict__ sx,
                    const int32_t* __restrict__ sy, int32_t* __restrict__ sx_out,
                    int32_t* __restrict__ sy_out, int t, int c, int dec,
                    idsp::Df1Coefs k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  idsp::seq_bank<Decimate>(
      xs, t, c, lane, dec, [&](int32_t x) { return s.step(k, x); },
      [&](size_t i, int32_t y) {
        if constexpr (F32Out) {
          static_cast<float*>(ys)[i] = static_cast<float>(y);
        } else {
          static_cast<int32_t*>(ys)[i] = y;
        }
      });
  s.store(sx_out, sy_out, lane);
}

template <bool Decimate>
int launch(const void* xs, void* ys, const void* sx, const void* sy,
           void* sx_out, void* sy_out, int t, int c, int dec, int f32_out,
           const idsp::Df1Coefs& k, void* stream) {
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int32_t*>(sy);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int32_t*>(sy_out);
  if (f32_out) {
    df1_bank_kernel<true, Decimate><<<grid, kBankLanes, 0, st>>>(
        x, ys, ix, iy, ox, oy, t, c, dec, k);
  } else {
    df1_bank_kernel<false, Decimate><<<grid, kBankLanes, 0, st>>>(
        x, ys, ix, iy, ox, oy, t, c, dec, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: xs (t, c) i32 -> ys (t, c) i32 or f32; state (c, 2) i32 x2 in and
// out.
extern "C" int idsp_df1_bank_q(const void* xs, void* ys, const void* sx,
                               const void* sy, void* sx_out, void* sy_out,
                               int t, int c, int f, int f32_out, int b0,
                               int b1, int b2, int a1, int a2, void* stream) {
  return launch<false>(xs, ys, sx, sy, sx_out, sy_out, t, c, 1, f32_out,
                       idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, stream);
}

// K11: as K1, keeping the rows 0, dec, 2*dec, ...: ys (t/dec, c).
extern "C" int idsp_df1_bank_q_dec(const void* xs, void* ys, const void* sx,
                                   const void* sy, void* sx_out,
                                   void* sy_out, int t, int c, int dec,
                                   int f, int f32_out, int b0, int b1, int b2,
                                   int a1, int a2, void* stream) {
  if (dec < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(xs, ys, sx, sy, sx_out, sy_out, t, c, dec, f32_out,
                      idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, stream);
}
