// K1, K11 and K18: fixed-point DF1 biquad over a bank of lanes, every
// row out (K1), only the rows 0, d, 2d, ... (K11), or every row of the
// anti-windup DF1 (K18: offset and clamp before feedback).  K26 and K27
// are K1 and K18 with runtime coefficients: each lane loads its five
// words once from (5, c) int32 planes (`df1.cuh` `load_coefs`), so a
// retune is a new planes tensor and nothing is rebuilt.
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q` (:225), `df1_bank_q_dec` (:290, `_df1_bank_q_dec_impl`
// :319), `df1_clamp_bank_q` (:696), `df1_bank_q_coef` (:932) and
// `df1_clamp_bank_q_coef` (:999), all `_seq_bank_kernel` (:471; K11
// with its `dec` epilogue) run by `_bank_call` (:395, pallas_call :453).  Those kernels emulated the
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
// out) is small next to that.  K18's add, max and min sit on the same
// chain: y0 -> clamp -> y1 feeds the next step's MACs.
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

template <bool F32Out, bool Decimate, bool Clamp, bool Planes = false>
__global__ void __launch_bounds__(kBankLanes)
    df1_bank_kernel(const int32_t* __restrict__ xs, void* __restrict__ ys,
                    const int32_t* __restrict__ sx,
                    const int32_t* __restrict__ sy, int32_t* __restrict__ sx_out,
                    int32_t* __restrict__ sy_out, int t, int c, int dec,
                    idsp::Df1Coefs k, idsp::Df1Clamp cl,
                    const int32_t* __restrict__ planes = nullptr) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  if constexpr (Planes) k = idsp::load_coefs(planes, c, lane, k.f);
  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  idsp::seq_bank<Decimate>(
      xs, t, c, lane, dec,
      [&](int32_t x) {
        if constexpr (Clamp) {
          return s.step_clamp(k, cl, x);
        } else {
          return s.step(k, x);
        }
      },
      [&](size_t i, int32_t y) {
        if constexpr (F32Out) {
          static_cast<float*>(ys)[i] = static_cast<float>(y);
        } else {
          static_cast<int32_t*>(ys)[i] = y;
        }
      });
  s.store(sx_out, sy_out, lane);
}

template <bool Decimate, bool Clamp = false>
int launch(const void* xs, void* ys, const void* sx, const void* sy,
           void* sx_out, void* sy_out, int t, int c, int dec, int f32_out,
           const idsp::Df1Coefs& k, void* stream,
           const idsp::Df1Clamp& cl = idsp::Df1Clamp{}) {
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int32_t*>(sy);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int32_t*>(sy_out);
  if constexpr (Clamp) {  // K18: int32 out only, as the TPU kernel
    df1_bank_kernel<false, Decimate, true><<<grid, kBankLanes, 0, st>>>(
        x, ys, ix, iy, ox, oy, t, c, dec, k, cl);
  } else if (f32_out) {
    df1_bank_kernel<true, Decimate, false><<<grid, kBankLanes, 0, st>>>(
        x, ys, ix, iy, ox, oy, t, c, dec, k, cl);
  } else {
    df1_bank_kernel<false, Decimate, false><<<grid, kBankLanes, 0, st>>>(
        x, ys, ix, iy, ox, oy, t, c, dec, k, cl);
  }
  return static_cast<int>(cudaGetLastError());
}

// K26 (Clamp false) and K27: K1 / K18 with each lane's coefficients from
// (5, c) int32 planes; int32 out.
template <bool Clamp>
int launch_coef(const void* xs, void* ys, const void* sx, const void* sy,
                void* sx_out, void* sy_out, const void* planes, int t, int c,
                int f, const idsp::Df1Clamp& cl, void* stream) {
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  df1_bank_kernel<false, false, Clamp, true>
      <<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(xs), ys,
          static_cast<const int32_t*>(sx), static_cast<const int32_t*>(sy),
          static_cast<int32_t*>(sx_out), static_cast<int32_t*>(sy_out), t, c,
          1, idsp::Df1Coefs{0, 0, 0, 0, 0, f}, cl,
          static_cast<const int32_t*>(planes));
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

// K18: K1 with the anti-windup clamp (df1.cuh `Df1Clamp`): xs (t, c) i32
// -> ys (t, c) i32; state (c, 2) i32 x2 in and out.
extern "C" int idsp_df1_clamp_bank_q(const void* xs, void* ys, const void* sx,
                                     const void* sy, void* sx_out,
                                     void* sy_out, int t, int c, int f,
                                     int b0, int b1, int b2, int a1, int a2,
                                     int u, int lo, int hi, void* stream) {
  return launch<false, true>(xs, ys, sx, sy, sx_out, sy_out, t, c, 1, 0,
                             idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, stream,
                             idsp::Df1Clamp{u, lo, hi});
}

// K26: xs (t, c) i32 -> ys (t, c) i32; planes (5, c) i32; state (c, 2)
// i32 x2 in and out.
extern "C" int idsp_df1_bank_q_coef(const void* xs, void* ys, const void* sx,
                                    const void* sy, void* sx_out,
                                    void* sy_out, const void* planes, int t,
                                    int c, int f, void* stream) {
  return launch_coef<false>(xs, ys, sx, sy, sx_out, sy_out, planes, t, c, f,
                            idsp::Df1Clamp{}, stream);
}

// K27: K26 with the anti-windup clamp (u, lo, hi).
extern "C" int idsp_df1_clamp_bank_q_coef(const void* xs, void* ys,
                                          const void* sx, const void* sy,
                                          void* sx_out, void* sy_out,
                                          const void* planes, int t, int c,
                                          int f, int u, int lo, int hi,
                                          void* stream) {
  return launch_coef<true>(xs, ys, sx, sy, sx_out, sy_out, planes, t, c, f,
                           idsp::Df1Clamp{u, lo, hi}, stream);
}
