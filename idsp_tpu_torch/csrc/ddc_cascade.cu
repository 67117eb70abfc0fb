// K2, K3, K19, K20 and K21: DF1 biquad bank fused with a half-band
// decimation cascade, optionally with the fast-LO conjugate mix in its
// prologue and optionally with the anti-windup clamp in the DF1.
//
// Replaces the Pallas composer of idsp_tpu/filters/ddc_pallas.py
// `_run_fused_cascade` (:519, pallas_call :691) as instantiated by
// `df1_hbf_cascade_bank` (:789; K2, FastLo = false) and its depth-1 and
// depth-2 forms `df1_hbf1_bank` (:743; K20) and `df1_hbf12_bank` (:767;
// K21), `df1_clamp_hbf_cascade_bank` (:834, body `_iir_df1_clamp_body`
// :273; K19, Clamp = true) and `fastlo_ddc_cascade_bank` (:1298, mix
// prologue `_fastlo_mix_chunk` :487; K3, FastLo = true, with Clamp = true
// for its `clamp=`).  On the TPU the grid walked time chunks in
// order and kept the state and tails in VMEM scratch between steps;
// here a block owns kHbfLanes lanes for the whole block of time and walks
// the chunks in a loop, the state in registers and the parity buffers
// and tails in shared memory.
//
// Per chunk of tc rows and per lane (one thread):
//  1. (K3) mix: lo = coarse[chunk] * fine[row], x scaled by AMPLITUDE,
//     rounded half away from zero to i32 (fastlo.cuh, shared with K6);
//  2. the DF1 step (with Clamp, offset and clamp before feedback:
//     df1.cuh `Df1Clamp`); its f32 output goes to stage 0's parity buffers:
//     even rows behind the m-1 carried even-tail rows, odd rows behind
//     the 2m-1 carried odd-tail rows (ddc_pallas.py:613-617);
//  3. each FIR stage over the chunk and the tails' move to the front
//     of their buffers: the stage loop of hbf_stage.cuh.
//
// Numerics: every f32 operation is one __f*_rn intrinsic, in the order
// of the plain PyTorch version, so nvcc cannot contract a*b - c*d into
// an FMA and the kernel matches the eagerly-evaluated plain version bit
// for bit.  The DF1 is the exact int64 recurrence of df1.cuh.
//
// What bounds it on the H100: as for K1, the serial DF1 recurrence of
// each lane (one thread per lane, 2c lanes in all), now with the FIR
// work of the chunk added to the same thread (with Clamp, an add, a max
// and a min more on the serial chain of each step).  The device memory
// traffic is small: K2 reads 4 B per full-rate sample and lane and
// writes 4 B per eighth; K3 reads only x (t,) and the small factor
// tables.  The FIR stages read shared memory only.
//
// What the design does about it: everything between the input and the
// 1/2^depth-rate output stays on chip; each thread reads and writes
// only its own lane's column of shared memory (lane-contiguous rows, so
// no bank conflicts and no block-wide barrier).  Splitting a lane's FIR
// rows over several threads, and more lanes per SM, are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "fastlo.cuh"
#include "hbf_stage.cuh"

namespace {

using idsp::kHbfLanes;

struct CascadeParams {
  idsp::Df1Coefs k;
  idsp::Df1Clamp cl;
  idsp::HbfTaps h;
};

template <bool FastLo, bool Clamp>
__global__ void __launch_bounds__(kHbfLanes) ddc_cascade_kernel(
    const int32_t* __restrict__ xs, const int32_t* __restrict__ x,
    const float* __restrict__ ca, const float* __restrict__ sa,
    const float* __restrict__ cb, const float* __restrict__ sb,
    const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
    int32_t* __restrict__ sx_out, int32_t* __restrict__ sy_out,
    const float* __restrict__ tails_in, float* __restrict__ tails_out,
    float* __restrict__ y, int t, int c2, int tc, CascadeParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kHbfLanes + tid;
  if (lane >= c2) return;  // no block-wide barrier below

  float* col = smem + tid;
  int odd_off[idsp::kHbfMaxDepth], even_off[idsp::kHbfMaxDepth];
  idsp::hbf_dec_offsets(p.h, tc, odd_off, even_off);
  idsp::hbf_dec_tails<true>(p.h, col, odd_off, even_off, tails_in, c2,
                            lane);

  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  const idsp::Df1Coefs k = p.k;
  const idsp::Df1Clamp cl = p.cl;
  auto df1 = [&](int32_t x) {
    if constexpr (Clamp) {
      return s.step_clamp(k, cl, x);
    } else {
      return s.step(k, x);
    }
  };

  // fast-LO lane geometry: I lanes [0, c), Q lanes [c, 2c)
  const int c = c2 / 2;
  const bool is_q = lane >= c;
  const int ch = is_q ? lane - c : lane;

  float* odd0 = col + (odd_off[0] + 2 * p.h.m[0] - 1) * kHbfLanes;
  float* even0 = col + (even_off[0] + p.h.m[0] - 1) * kHbfLanes;
  const int nchunks = t / tc;
  const int nout = tc >> p.h.depth;
  for (int q = 0; q < nchunks; ++q) {
    float cav = 0.0f, sav = 0.0f;
    if constexpr (FastLo) {
      cav = __ldg(ca + static_cast<size_t>(q) * c + ch);
      sav = __ldg(sa + static_cast<size_t>(q) * c + ch);
    }
    // the DF1 input of chunk row u
    auto input = [&](int u) -> int32_t {
      const int row = q * tc + u;
      if constexpr (FastLo) {
        const float xh = idsp::fastlo_scale(__ldg(x + row));
        const float cbv = __ldg(cb + static_cast<size_t>(u) * c + ch);
        const float sbv = __ldg(sb + static_cast<size_t>(u) * c + ch);
        // one product and one rounding per lane: a select the compiler
        // can if-convert, so the unrolled rows stay one basic block
        float v;
        if (is_q) {
          v = idsp::fastlo_prod_q(cav, sav, cbv, sbv, xh);
        } else {
          v = idsp::fastlo_prod_i(cav, sav, cbv, sbv, xh);
        }
        return idsp::fastlo_round(v);
      } else {
        return __ldg(xs + static_cast<size_t>(row) * c2 + lane);
      }
    };
#pragma unroll 4
    for (int u = 0; u < tc; u += 2) {
      even0[(u >> 1) * kHbfLanes] = static_cast<float>(df1(input(u)));
      odd0[(u >> 1) * kHbfLanes] = static_cast<float>(df1(input(u + 1)));
    }
    float* yq = y + static_cast<size_t>(q) * nout * c2 + lane;
    idsp::hbf_dec_stages(p.h, col, odd_off, even_off, tc, [&](int j, float v) {
      yq[static_cast<size_t>(j) * c2] = v;
    });
  }

  s.store(sx_out, sy_out, lane);
  idsp::hbf_dec_tails<false>(p.h, col, odd_off, even_off, tails_out, c2,
                             lane);
}

}  // namespace

// K2 (K20, K21 at depth 1, 2) when x is null (xs (t, c2) i32 is the DF1
// input); K3 when x (t,) i32 and the factor tables ca/sa (t/tc, c2/2),
// cb/sb (tc, c2/2) are given.  clamp != 0 runs the anti-windup DF1 with
// offset u and bounds lo, hi (K19, and K3's clamp form).  ms (depth,) and
// taps (sum ms,) are host arrays, highest-rate stage first.  y is
// (t >> depth, c2) f32; tails are packed (3m-2) rows per stage.
extern "C" int idsp_ddc_cascade(
    const void* xs, const void* x, const void* ca, const void* sa,
    const void* cb, const void* sb, const void* sx, const void* sy,
    void* sx_out, void* sy_out, const void* tails_in, void* tails_out,
    void* y, int t, int c2, int tc, int f, int b0, int b1, int b2, int a1,
    int a2, int depth, int clamp, int u, int lo, int hi, const int* ms,
    const float* taps, void* stream) {
  CascadeParams p{};
  p.k = idsp::Df1Coefs{b0, b1, b2, a1, a2, f};
  p.cl = idsp::Df1Clamp{u, lo, hi};
  if (!idsp::hbf_taps_from_host(p.h, depth, ms, taps))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = idsp::hbf_dec_rows(p.h, tc) * kHbfLanes * sizeof(float);
  const bool fastlo = x != nullptr;
  auto kernel = fastlo ? (clamp ? ddc_cascade_kernel<true, true>
                                : ddc_cascade_kernel<true, false>)
                       : (clamp ? ddc_cascade_kernel<false, true>
                                : ddc_cascade_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // a refused size is also the runtime's last error: take it, or the
  // next launch of any kernel in this library would report it
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c2 + kHbfLanes - 1) / kHbfLanes);
  kernel<<<grid, kHbfLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(x),
      static_cast<const float*>(ca), static_cast<const float*>(sa),
      static_cast<const float*>(cb), static_cast<const float*>(sb),
      static_cast<const int32_t*>(sx), static_cast<const int32_t*>(sy),
      static_cast<int32_t*>(sx_out), static_cast<int32_t*>(sy_out),
      static_cast<const float*>(tails_in), static_cast<float*>(tails_out),
      static_cast<float*>(y), t, c2, tc, p);
  return static_cast<int>(cudaGetLastError());
}
