// K28-K31 and K33: the rest of the reference's DF1 precision ladder over
// a bank of lanes.  K28 runs Q16 (int16 storage, 32-bit sums), K29 Q64
// (int64 storage, 128-bit sums), K30 the f32 DF1, K31 the error-feedback
// (dither) DF1, optionally clamped, and K33 is K31 with runtime
// coefficients (shared (5,) or per-lane (5, c) planes, `df1.cuh`
// `load_coefs`, as K26/K27).  K32, K25 with runtime coefficients, is in
// biquad_bank.cu beside K25.
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q16` (:1352, body :1393-1402), `df1_bank_q64` (:1250),
// `df1_bank_f32` (:98), `df1_dither_bank` (:872, body `_dither_body`
// :856) and `df1_dither_bank_coef` (:1104), all `_seq_bank_kernel` (:471)
// run by `_bank_call` (:395, pallas_call :453).  The TPU had no 64-bit
// integers: Q64 kept each int64 as two 32-bit limbs and the 128-bit sum
// as four, built from 16-bit limb products (:1166-1248), and the dither
// step emulated its 64-bit sum in 16-bit limbs too.  Here Q64's products
// are a 64-bit multiply and `__mul64hi`, the dither sum native int64, and
// Q16 runs on 32-bit integers as the reference's accumulator does.
//
// What bounds them on the H100: the recurrence, as K1 (df1_bank.cu): y0
// of a step feeds the next step's products, one lane a serial chain.  Per
// sample the bytes are 2 B in and out (K28), 8 B (K29), 4 B (K30, K31,
// K33).  K29's chain is the longest: each 64x64 -> 128-bit product is
// several 32-bit multiply-adds, and the two feedback products, their
// carries and the funnel shift sit on the chain.  K30 rounds every
// product and sum on its own (`__fmul_rn`, `__fadd_rn`, in the plain
// version's order), so nvcc cannot contract them into FMAs: bit-identical
// to the plain `df1_process`.
//
// What the design does: one thread per lane with the state in registers,
// on the sequential-bank template of seq_bank.cuh over the row type of
// each rung (int16, int64, float or int32 rows, coalesced along lanes,
// the next 16 rows prefetched).  Simple first: speed is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

// K28, K29 and K30: one lane type, its row type T and its coefficients.
template <class Lane, class T, class Coefs>
__global__ void __launch_bounds__(kBankLanes)
    df1_typed_kernel(const T* __restrict__ xs, T* __restrict__ ys,
                     const T* __restrict__ sx, const T* __restrict__ sy,
                     T* __restrict__ sx_out, T* __restrict__ sy_out, int t,
                     int c, Coefs k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  Lane s;
  s.load(sx, sy, lane);
  idsp::seq_bank<false>(
      xs, t, c, lane, 1, [&](T x) { return s.step(k, x); },
      [&](size_t i, T y) { ys[i] = y; });
  s.store(sx_out, sy_out, lane);
}

// K31 (Planes false) and K33: the dither DF1, clamped or not.
template <bool Clamp, bool Planes>
__global__ void __launch_bounds__(kBankLanes)
    df1_dither_kernel(const int32_t* __restrict__ xs,
                      int32_t* __restrict__ ys,
                      const int32_t* __restrict__ sx,
                      const int32_t* __restrict__ sy,
                      const int64_t* __restrict__ se,
                      int32_t* __restrict__ sx_out,
                      int32_t* __restrict__ sy_out,
                      int64_t* __restrict__ se_out, int t, int c,
                      idsp::Df1Coefs k, idsp::Df1Clamp cl,
                      const int32_t* __restrict__ planes) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  if constexpr (Planes) k = idsp::load_coefs(planes, c, lane, k.f);
  idsp::Df1DitherLane s;
  s.load(sx, sy, se, lane);
  idsp::seq_bank<false>(
      xs, t, c, lane, 1,
      [&](int32_t x) {
        if constexpr (Clamp) {
          return s.step_clamp(k, cl, x);
        } else {
          return s.step(k, x);
        }
      },
      [&](size_t i, int32_t y) { ys[i] = y; });
  s.store(sx_out, sy_out, se_out, lane);
}

template <class Lane, class T, class Coefs>
int launch_typed(const void* xs, void* ys, const void* sx, const void* sy,
                 void* sx_out, void* sy_out, int t, int c, const Coefs& k,
                 void* stream) {
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  df1_typed_kernel<Lane, T, Coefs>
      <<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xs), static_cast<T*>(ys),
          static_cast<const T*>(sx), static_cast<const T*>(sy),
          static_cast<T*>(sx_out), static_cast<T*>(sy_out), t, c, k);
  return static_cast<int>(cudaGetLastError());
}

template <bool Planes>
int launch_dither(const void* xs, void* ys, const void* sx, const void* sy,
                  const void* se, void* sx_out, void* sy_out, void* se_out,
                  const void* planes, int t, int c, const idsp::Df1Coefs& k,
                  int clamp, const idsp::Df1Clamp& cl, void* stream) {
  if (k.f <= 0 || k.f > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto y = static_cast<int32_t*>(ys);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int32_t*>(sy);
  auto ie = static_cast<const int64_t*>(se);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int32_t*>(sy_out);
  auto oe = static_cast<int64_t*>(se_out);
  auto p = static_cast<const int32_t*>(planes);
  if (clamp) {
    df1_dither_kernel<true, Planes><<<grid, kBankLanes, 0, st>>>(
        x, y, ix, iy, ie, ox, oy, oe, t, c, k, cl, p);
  } else {
    df1_dither_kernel<false, Planes><<<grid, kBankLanes, 0, st>>>(
        x, y, ix, iy, ie, ox, oy, oe, t, c, k, cl, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K28: xs (t, c) i16 -> ys (t, c) i16; state (c, 2) i16 x2 in and out;
// 0 < f < 32; the coefficients int16 values in int words.
extern "C" int idsp_df1_bank_q16(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, int f, int b0, int b1, int b2,
                                 int a1, int a2, void* stream) {
  if (f <= 0 || f >= 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_typed<idsp::Df1LaneQ16, int16_t>(
      xs, ys, sx, sy, sx_out, sy_out, t, c,
      idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, stream);
}

// K29: xs (t, c) i64 -> ys (t, c) i64; state (c, 2) i64 x2 in and out;
// 0 < f < 64 (the wrapper holds the JAX kernel's 32 < f < 64).
extern "C" int idsp_df1_bank_q64(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, int f, long long b0,
                                 long long b1, long long b2, long long a1,
                                 long long a2, void* stream) {
  if (f <= 0 || f >= 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_typed<idsp::Df1LaneQ64, int64_t>(
      xs, ys, sx, sy, sx_out, sy_out, t, c,
      idsp::Df1CoefsQ64{b0, b1, b2, a1, a2, f}, stream);
}

// K30: xs (t, c) f32 -> ys (t, c) f32; state (c, 2) f32 x2 in and out.
extern "C" int idsp_df1_bank_f32(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, float b0, float b1, float b2,
                                 float a1, float a2, void* stream) {
  return launch_typed<idsp::Df1LaneF32, float>(
      xs, ys, sx, sy, sx_out, sy_out, t, c,
      idsp::Df1CoefsF32{b0, b1, b2, a1, a2}, stream);
}

// K31: xs (t, c) i32 -> ys (t, c) i32; state xy (c, 2) i32 x2 and e (c,)
// i64 in [0, 2^32), in and out; 0 < f <= 32; clamp != 0 runs the clamped
// step (u, lo, hi).
extern "C" int idsp_df1_dither_bank(const void* xs, void* ys, const void* sx,
                                    const void* sy, const void* se,
                                    void* sx_out, void* sy_out, void* se_out,
                                    int t, int c, int f, int b0, int b1,
                                    int b2, int a1, int a2, int clamp, int u,
                                    int lo, int hi, void* stream) {
  return launch_dither<false>(xs, ys, sx, sy, se, sx_out, sy_out, se_out,
                              nullptr, t, c,
                              idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, clamp,
                              idsp::Df1Clamp{u, lo, hi}, stream);
}

// K33: K31 with each lane's coefficients from (5, c) i32 planes.
extern "C" int idsp_df1_dither_bank_coef(const void* xs, void* ys,
                                         const void* sx, const void* sy,
                                         const void* se, void* sx_out,
                                         void* sy_out, void* se_out,
                                         const void* planes, int t, int c,
                                         int f, int clamp, int u, int lo,
                                         int hi, void* stream) {
  return launch_dither<true>(xs, ys, sx, sy, se, sx_out, sy_out, se_out,
                             planes, t, c, idsp::Df1Coefs{0, 0, 0, 0, 0, f},
                             clamp, idsp::Df1Clamp{u, lo, hi}, stream);
}
