// K16: the float DDC / lock-in bank in one kernel: quadrature mix with a
// factored LO, then an f32 DF1 lowpass on every I and Q lane.
//
// Replaces the Pallas kernel of idsp_tpu/filters/ddc_pallas.py
// `ddc_lockin_bank` (:1359; `_ddc_lockin_bank_impl` :1405, pallas_call
// :1502).  On the TPU each time chunk mixed its rows vectorized into a
// VMEM scratch ((tc, 2c) f32), then a sequential fori_loop ran the DF1
// over the scratch.
//
// The LO of channel ch at row i = k*tc + b factors by angle addition
// (`lockin_tables`: phases in f64 mod tau, cos/sin in f32):
//
//   lo_re = ca[k]*cb[b] - sa[k]*sb[b],   lo_im = sa[k]*cb[b] + ca[k]*sb[b]
//   I = x[i] * lo_re,                    Q = -(x[i] * lo_im)
//
// then y = b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2 per lane (df1.cuh
// `Df1LaneF32`).  Every multiply and add is a single-rounding intrinsic in
// the plain version's order: kernel == plain bit for bit, given the same
// tables.  The factorisation depends on tc, so both take the same tc.
//
// What bounds it on the H100: the f32 DF1 recurrence, a serial chain of
// a multiply and two adds per row and lane, with 2c/32 warps on the card
// (32 at c = 512).  Memory: the (t, 2c) f32 output, 4 B per lane and
// row; the input is one (t,) stream and tables of (t/tc + tc) rows.
//
// What the design does about it: one thread per lane, the state in
// registers.  Per chunk of tc rows the block stages x in shared memory
// (one word per row for all its lanes) and reads its channel's coarse
// pair once.  Rows then go in groups of kBankGroup: the fine-table words
// of the next group are loaded while the current one computes; the LO and
// the mix of a whole group run first, kBankGroup independent rows with no
// branch (I and Q lanes both form lo_re and lo_im and select), then the
// DF1 steps through the group.  The (t, 2c) LO and mix planes never reach
// device memory.
//
// (A first version ran the LO and mix as the `load` of seq_bank.cuh's
// `seq_rows`, behind an `if` on the lane's half: 5.42 ms at c = 512,
// t = 32768 on the H100.)
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "seq_bank.cuh"  // kBankLanes, kBankGroup

namespace {

using idsp::kBankLanes;
constexpr int kMaxChunk = 8192;  // rows of x staged: 32 KB of shared memory

__global__ void __launch_bounds__(kBankLanes) ddc_lockin_kernel(
    const float* __restrict__ x, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cb,
    const float* __restrict__ sb, const float* __restrict__ sx,
    const float* __restrict__ sy, float* __restrict__ sx_out,
    float* __restrict__ sy_out, float* __restrict__ ys, int t, int c, int tc,
    idsp::Df1CoefsF32 k) {
  constexpr int G = idsp::kBankGroup;
  extern __shared__ float xs[];  // the chunk's x, tc words
  const int c2 = 2 * c;
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  const bool active = lane < c2;  // every thread reaches the barriers
  const bool is_q = lane >= c;
  const int ch = is_q ? lane - c : lane;
  idsp::Df1LaneF32 s;
  if (active) s.load(sx, sy, lane);
  // the mixed sample of row b of a chunk, from its fine LO words
  auto mix = [&](float cav, float sav, float2 fine, float xv) {
    const float lo_re =
        __fsub_rn(__fmul_rn(cav, fine.x), __fmul_rn(sav, fine.y));
    const float lo_im =
        __fadd_rn(__fmul_rn(sav, fine.x), __fmul_rn(cav, fine.y));
    return is_q ? -__fmul_rn(xv, lo_im) : __fmul_rn(xv, lo_re);
  };
  auto fine = [&](int b) {
    const size_t o = static_cast<size_t>(b) * c + ch;
    return make_float2(__ldg(cb + o), __ldg(sb + o));
  };
  const int full = tc / G * G;
  for (int k0 = 0, kk = 0; k0 < t; k0 += tc, ++kk) {
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = threadIdx.x; i < tc; i += kBankLanes) xs[i] = x[k0 + i];
    __syncthreads();
    if (!active) continue;
    const float cav = ca[static_cast<size_t>(kk) * c + ch];
    const float sav = sa[static_cast<size_t>(kk) * c + ch];
    float* yrow = ys + static_cast<size_t>(k0) * c2 + lane;
    float2 cur[G];
#pragma unroll
    for (int u = 0; u < G; ++u) cur[u] = full > 0 ? fine(u) : float2{};
    for (int b0 = 0; b0 < full; b0 += G) {
      const bool more = b0 + G < full;
      float2 nxt[G];
#pragma unroll
      for (int u = 0; u < G; ++u) nxt[u] = more ? fine(b0 + G + u) : float2{};
      float m[G];
#pragma unroll
      for (int u = 0; u < G; ++u) m[u] = mix(cav, sav, cur[u], xs[b0 + u]);
#pragma unroll
      for (int u = 0; u < G; ++u)
        yrow[static_cast<size_t>(b0 + u) * c2] = s.step(k, m[u]);
#pragma unroll
      for (int u = 0; u < G; ++u) cur[u] = nxt[u];
    }
    for (int b = full; b < tc; ++b)  // the rows after the last full group
      yrow[static_cast<size_t>(b) * c2] =
          s.step(k, mix(cav, sav, fine(b), xs[b]));
  }
  if (active) s.store(sx_out, sy_out, lane);
}

}  // namespace

// x (t,) f32; ca, sa (t/tc, c), cb, sb (tc, c) f32 -> ys (t, 2c) f32,
// I lanes then Q lanes; DF1 state x/y (2c, 2) f32 in and out.
extern "C" int idsp_ddc_lockin(const void* x, const void* ca, const void* sa,
                               const void* cb, const void* sb,
                               const void* sx, const void* sy, void* sx_out,
                               void* sy_out, void* ys, int t, int c, int tc,
                               float b0, float b1, float b2, float a1,
                               float a2, void* stream) {
  if (tc < 1 || tc > kMaxChunk || t % tc)
    return static_cast<int>(cudaErrorInvalidValue);
  const idsp::Df1CoefsF32 k{b0, b1, b2, a1, a2};
  const dim3 grid((2 * c + kBankLanes - 1) / kBankLanes);
  const size_t smem = static_cast<size_t>(tc) * sizeof(float);
  ddc_lockin_kernel<<<grid, kBankLanes, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ca),
      static_cast<const float*>(sa), static_cast<const float*>(cb),
      static_cast<const float*>(sb), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<float*>(sx_out),
      static_cast<float*>(sy_out), static_cast<float*>(ys), t, c, tc, k);
  return static_cast<int>(cudaGetLastError());
}
