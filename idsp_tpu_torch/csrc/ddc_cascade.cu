// K2 and K3: DF1 biquad bank fused with a half-band decimation cascade,
// optionally with the fast-LO conjugate mix in its prologue.
//
// Replaces the Pallas composer of idsp_tpu/filters/ddc_pallas.py
// `_run_fused_cascade` (:519, pallas_call :691) as instantiated by
// `df1_hbf_cascade_bank` (:789; K2, FastLo = false) and
// `fastlo_ddc_cascade_bank` (:1298, mix prologue `_fastlo_mix_chunk`
// :487; K3, FastLo = true).  On the TPU the grid walked time chunks in
// order and kept the state and tails in VMEM scratch between steps;
// here a block owns kLanes lanes for the whole block of time and walks
// the chunks in a loop, the state in registers and the parity buffers
// and tails in shared memory.
//
// Per chunk of tc rows and per lane (one thread):
//  1. (K3) mix: lo = coarse[chunk] * fine[row], x scaled by AMPLITUDE,
//     rounded half away from zero to i32 (fastlo.cuh, shared with K6);
//  2. the DF1 step; its f32 output goes to stage 0's parity buffers:
//     even rows behind the m-1 carried even-tail rows, odd rows behind
//     the 2m-1 carried odd-tail rows (ddc_pallas.py:613-617);
//  3. each FIR stage over the chunk, acc += (b + a) * tap[i] for i
//     ascending, then + even (ddc_pallas.py:506-516); its output rows
//     split by parity into the next stage's buffers, even rows to even,
//     odd rows to odd (:632-638), or, for the last stage, to y;
//  4. the tails move to the front of their buffers (:641-644).
//
// Numerics: every f32 operation is one __f*_rn intrinsic, in the order
// of the plain PyTorch version, so nvcc cannot contract a*b - c*d into
// an FMA and the kernel matches the eagerly-evaluated plain version bit
// for bit.  The DF1 is the exact int64 recurrence of df1.cuh.
//
// What bounds it on the H100: as for K1, the serial DF1 recurrence of
// each lane (one thread per lane, 2c lanes in all), now with the FIR
// work of the chunk added to the same thread.  The device memory
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

namespace {

constexpr int kLanes = 32;    // lanes (threads) per block
constexpr int kMaxDepth = 4;  // half-band stages
constexpr int kMaxTaps = 32;  // one-sided taps per stage

struct CascadeParams {
  idsp::Df1Coefs k;
  int depth;
  int m[kMaxDepth];
  float taps[kMaxDepth][kMaxTaps];
};

template <bool FastLo>
__global__ void __launch_bounds__(kLanes) ddc_cascade_kernel(
    const int32_t* __restrict__ xs, const int32_t* __restrict__ x,
    const float* __restrict__ ca, const float* __restrict__ sa,
    const float* __restrict__ cb, const float* __restrict__ sb,
    const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
    int32_t* __restrict__ sx_out, int32_t* __restrict__ sy_out,
    const float* __restrict__ tails_in, float* __restrict__ tails_out,
    float* __restrict__ y, int t, int c2, int tc, CascadeParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kLanes + tid;
  if (lane >= c2) return;  // no block-wide barrier below
  const int depth = p.depth;

  // Shared-memory rows of stage d: odd buffer (2m-1 tail + n new rows),
  // then even buffer (m-1 tail + n new rows), n = tc >> (d+1).  Row r of
  // this thread's column is smem[r * kLanes + tid].
  int odd_off[kMaxDepth], even_off[kMaxDepth];
  {
    int off = 0;
    for (int d = 0; d < depth; ++d) {
      const int m = p.m[d], n = tc >> (d + 1);
      odd_off[d] = off;
      off += n + 2 * m - 1;
      even_off[d] = off;
      off += n + m - 1;
    }
  }
  float* col = smem + tid;

  // carried tails in: (3m-2, c2) per stage, packed one after the other
  {
    int trow = 0;
    for (int d = 0; d < depth; ++d) {
      const int ln = 2 * p.m[d] - 1, me = p.m[d] - 1;
      for (int r = 0; r < ln; ++r)
        col[(odd_off[d] + r) * kLanes] =
            tails_in[static_cast<size_t>(trow + r) * c2 + lane];
      for (int r = 0; r < me; ++r)
        col[(even_off[d] + r) * kLanes] =
            tails_in[static_cast<size_t>(trow + ln + r) * c2 + lane];
      trow += ln + me;
    }
  }

  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  const idsp::Df1Coefs k = p.k;

  // fast-LO lane geometry: I lanes [0, c), Q lanes [c, 2c)
  const int c = c2 / 2;
  const bool is_q = lane >= c;
  const int ch = is_q ? lane - c : lane;

  float* odd0 = col + (odd_off[0] + 2 * p.m[0] - 1) * kLanes;
  float* even0 = col + (even_off[0] + p.m[0] - 1) * kLanes;
  const int nchunks = t / tc;
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
      even0[(u >> 1) * kLanes] = static_cast<float>(s.step(k, input(u)));
      odd0[(u >> 1) * kLanes] = static_cast<float>(s.step(k, input(u + 1)));
    }

    for (int d = 0; d < depth; ++d) {
      const int m = p.m[d], ln = 2 * m - 1, me = m - 1, n = tc >> (d + 1);
      const float* tp = p.taps[d];
      float* odd = col + odd_off[d] * kLanes;
      float* even = col + even_off[d] * kLanes;
      const bool last = d + 1 == depth;
      float* nodd = nullptr;
      float* neven = nullptr;
      if (!last) {
        nodd = col + (odd_off[d + 1] + 2 * p.m[d + 1] - 1) * kLanes;
        neven = col + (even_off[d + 1] + p.m[d + 1] - 1) * kLanes;
      }
      for (int j = 0; j < n; ++j) {
        float acc = __fmul_rn(__fadd_rn(odd[(ln + j) * kLanes], odd[j * kLanes]), tp[0]);
        for (int i = 1; i < m; ++i)
          acc = __fadd_rn(
              acc, __fmul_rn(__fadd_rn(odd[(ln - i + j) * kLanes],
                                       odd[(i + j) * kLanes]),
                             tp[i]));
        const float yv = __fadd_rn(acc, even[j * kLanes]);
        if (last) {
          y[(static_cast<size_t>(q) * n + j) * c2 + lane] = yv;
        } else if (j & 1) {
          nodd[(j >> 1) * kLanes] = yv;
        } else {
          neven[(j >> 1) * kLanes] = yv;
        }
      }
      // carry: the last ln odd / me even rows move to the front
      // (ascending copy; the source always lies after the destination)
      for (int r = 0; r < ln; ++r) odd[r * kLanes] = odd[(n + r) * kLanes];
      for (int r = 0; r < me; ++r) even[r * kLanes] = even[(n + r) * kLanes];
    }
  }

  s.store(sx_out, sy_out, lane);
  int trow = 0;
  for (int d = 0; d < depth; ++d) {
    const int ln = 2 * p.m[d] - 1, me = p.m[d] - 1;
    for (int r = 0; r < ln; ++r)
      tails_out[static_cast<size_t>(trow + r) * c2 + lane] =
          col[(odd_off[d] + r) * kLanes];
    for (int r = 0; r < me; ++r)
      tails_out[static_cast<size_t>(trow + ln + r) * c2 + lane] =
          col[(even_off[d] + r) * kLanes];
    trow += ln + me;
  }
}

}  // namespace

// K2 when x is null (xs (t, c2) i32 is the DF1 input); K3 when x (t,)
// i32 and the factor tables ca/sa (t/tc, c2/2), cb/sb (tc, c2/2) are
// given.  ms (depth,) and taps (sum ms,) are host arrays, highest-rate
// stage first.  y is (t >> depth, c2) f32; tails are packed (3m-2) rows
// per stage.
extern "C" int idsp_ddc_cascade(
    const void* xs, const void* x, const void* ca, const void* sa,
    const void* cb, const void* sb, const void* sx, const void* sy,
    void* sx_out, void* sy_out, const void* tails_in, void* tails_out,
    void* y, int t, int c2, int tc, int f, int b0, int b1, int b2, int a1,
    int a2, int depth, const int* ms, const float* taps, void* stream) {
  if (depth < 1 || depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  CascadeParams p{};
  p.k = idsp::Df1Coefs{b0, b1, b2, a1, a2, f};
  p.depth = depth;
  size_t rows = 0;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    const int m = ms[d];
    if (m < 1 || m > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
    p.m[d] = m;
    for (int i = 0; i < m; ++i) p.taps[d][i] = taps[off + i];
    off += m;
    rows += 2 * static_cast<size_t>(tc >> (d + 1)) + 3 * m - 2;
  }
  const size_t smem = rows * kLanes * sizeof(float);
  const bool fastlo = x != nullptr;
  auto kernel = fastlo ? ddc_cascade_kernel<true> : ddc_cascade_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c2 + kLanes - 1) / kLanes);
  kernel<<<grid, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(x),
      static_cast<const float*>(ca), static_cast<const float*>(sa),
      static_cast<const float*>(cb), static_cast<const float*>(sb),
      static_cast<const int32_t*>(sx), static_cast<const int32_t*>(sy),
      static_cast<int32_t*>(sx_out), static_cast<int32_t*>(sy_out),
      static_cast<const float*>(tails_in), static_cast<float*>(tails_out),
      static_cast<float*>(y), t, c2, tc, p);
  return static_cast<int>(cudaGetLastError());
}
