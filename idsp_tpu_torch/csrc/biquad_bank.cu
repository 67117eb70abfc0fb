// K24 and K25: the compat surface's two banks.  K24 runs an N-stage
// fixed-point SOS cascade (every stage a Q32<f> DF1), K25 the wide-state
// DF1 (int64 feedback words), optionally clamped.  K32 is K25 with
// runtime coefficients: each lane loads its five words once from (5, c)
// int32 planes (`df1.cuh` `load_coefs`).
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `sos_bank_q` (:147, `_sos_bank_q_impl` :176), `df1_wide_bank` (:796,
// body `_wide_body` :763) and `df1_wide_bank_coef` (:1053), all
// `_seq_bank_kernel` (:471) run by `_bank_call` (:395, pallas_call :453).  The TPU kernels emulated every
// 64-bit product, add and shift in 16-bit limbs (`_mac5_q`,
// `_mul_u32_coef`, `_shl_i64`); Hopper has native int64, so the wide step
// is `df1_wide_step`'s arithmetic as written (biquad.rs:456-480).
//
// What bounds them on the H100: the recurrence, as K1 (df1_bank.cu).
// K24 chains N DF1 steps per row, stage n's output the input of stage
// n+1 in the same row, so one lane's serial chain is N times K1's; its
// bytes are K1's (4 B in, 4 B out a sample).  K25's step adds two
// split-word products, a shift and (clamped) the high-word splice to K1's
// chain.
//
// What the design does: one thread per lane on the sequential-bank
// template (seq_bank.cuh: coalesced rows, the next 16 prefetched), all N
// stages' delay lines in registers, advanced in turn for each row
// (bit-identical to the stage-major chaining of `df1_process_q`: each
// stage sees the same inputs in the same order).  N is a template
// argument up to kSosMaxStages; the wrapper runs a longer cascade as
// successive launches over groups of stages, which the stage-major
// composition leaves bit-identical.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

constexpr int kSosMaxStages = 8;

struct SosCoefs {
  int32_t ba[kSosMaxStages][5];
};

template <int N>
__global__ void __launch_bounds__(kBankLanes)
    sos_bank_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys,
                    const int32_t* __restrict__ sx,
                    const int32_t* __restrict__ sy,
                    int32_t* __restrict__ sx_out, int32_t* __restrict__ sy_out,
                    int t, int c, int f, SosCoefs ba) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  const size_t plane = 2 * static_cast<size_t>(c);  // one stage's (c, 2)
  idsp::Df1Lane s[N];
  idsp::Df1Coefs k[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s[n].load(sx + n * plane, sy + n * plane, lane);
    k[n] = idsp::Df1Coefs{ba.ba[n][0], ba.ba[n][1], ba.ba[n][2], ba.ba[n][3],
                          ba.ba[n][4], f};
  }
  idsp::seq_bank<false>(
      xs, t, c, lane, 1,
      [&](int32_t x) {
#pragma unroll
        for (int n = 0; n < N; ++n) x = s[n].step(k[n], x);
        return x;
      },
      [&](size_t i, int32_t y) { ys[i] = y; });
#pragma unroll
  for (int n = 0; n < N; ++n)
    s[n].store(sx_out + n * plane, sy_out + n * plane, lane);
}

template <bool Clamp, bool Planes = false>
__global__ void __launch_bounds__(kBankLanes)
    df1_wide_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys,
                    const int32_t* __restrict__ sx,
                    const int64_t* __restrict__ sy,
                    int32_t* __restrict__ sx_out, int64_t* __restrict__ sy_out,
                    int t, int c, idsp::Df1Coefs k, idsp::Df1Clamp cl,
                    const int32_t* __restrict__ planes = nullptr) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  if constexpr (Planes) k = idsp::load_coefs(planes, c, lane, k.f);
  idsp::Df1WideLane s;
  s.load(sx, sy, lane);
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
  s.store(sx_out, sy_out, lane);
}

template <int N>
void launch_sos(const dim3& grid, cudaStream_t st, const int32_t* xs,
                int32_t* ys, const int32_t* sx, const int32_t* sy,
                int32_t* sx_out, int32_t* sy_out, int t, int c, int f,
                const SosCoefs& ba) {
  sos_bank_kernel<N><<<grid, kBankLanes, 0, st>>>(xs, ys, sx, sy, sx_out,
                                                  sy_out, t, c, f, ba);
}

// K25 (Planes false) and K32, clamped or not; 0 < f <= 32.
template <bool Planes>
int launch_wide(const void* xs, void* ys, const void* sx, const void* sy,
                void* sx_out, void* sy_out, const void* planes, int t, int c,
                const idsp::Df1Coefs& k, int clamp, const idsp::Df1Clamp& cl,
                void* stream) {
  if (k.f <= 0 || k.f > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto y = static_cast<int32_t*>(ys);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int64_t*>(sy);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int64_t*>(sy_out);
  auto p = static_cast<const int32_t*>(planes);
  if (clamp) {
    df1_wide_kernel<true, Planes><<<grid, kBankLanes, 0, st>>>(
        x, y, ix, iy, ox, oy, t, c, k, cl, p);
  } else {
    df1_wide_kernel<false, Planes><<<grid, kBankLanes, 0, st>>>(
        x, y, ix, iy, ox, oy, t, c, k, cl, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K24: xs (t, c) i32 -> ys (t, c) i32 through n stages (1 <= n <= 8);
// state x, y (n, c, 2) i32 each, in and out; ba n x 5 i32 (host memory).
extern "C" int idsp_sos_bank_q(const void* xs, void* ys, const void* sx,
                               const void* sy, void* sx_out, void* sy_out,
                               int t, int c, int f, int n, const int32_t* ba,
                               void* stream) {
  if (n < 1 || n > kSosMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  SosCoefs k{};
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 5; ++j) k.ba[i][j] = ba[5 * i + j];
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto y = static_cast<int32_t*>(ys);
  auto ix = static_cast<const int32_t*>(sx);
  auto iy = static_cast<const int32_t*>(sy);
  auto ox = static_cast<int32_t*>(sx_out);
  auto oy = static_cast<int32_t*>(sy_out);
  switch (n) {
    case 1: launch_sos<1>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 2: launch_sos<2>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 3: launch_sos<3>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 4: launch_sos<4>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 5: launch_sos<5>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 6: launch_sos<6>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    case 7: launch_sos<7>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
    default: launch_sos<8>(grid, st, x, y, ix, iy, ox, oy, t, c, f, k); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K25: xs (t, c) i32 -> ys (t, c) i32; state x (c, 2) i32 and y (c, 2) i64,
// in and out; 0 < f <= 32; clamp != 0 runs the clamped step (u, lo, hi).
extern "C" int idsp_df1_wide_bank(const void* xs, void* ys, const void* sx,
                                  const void* sy, void* sx_out, void* sy_out,
                                  int t, int c, int f, int b0, int b1, int b2,
                                  int a1, int a2, int clamp, int u, int lo,
                                  int hi, void* stream) {
  return launch_wide<false>(xs, ys, sx, sy, sx_out, sy_out, nullptr, t, c,
                            idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, clamp,
                            idsp::Df1Clamp{u, lo, hi}, stream);
}

// K32: K25 with each lane's coefficients from (5, c) i32 planes.
extern "C" int idsp_df1_wide_bank_coef(const void* xs, void* ys,
                                       const void* sx, const void* sy,
                                       void* sx_out, void* sy_out,
                                       const void* planes, int t, int c,
                                       int f, int clamp, int u, int lo,
                                       int hi, void* stream) {
  return launch_wide<true>(xs, ys, sx, sy, sx_out, sy_out, planes, t, c,
                           idsp::Df1Coefs{0, 0, 0, 0, 0, f}, clamp,
                           idsp::Df1Clamp{u, lo, hi}, stream);
}
