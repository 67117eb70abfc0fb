// K7 and K8: the pure-FIR half-band rate-change cascades, decimate and
// interpolate by 2^depth, each in one kernel.
//
// Replaces the Pallas kernels of idsp_tpu/filters/hbf_pallas.py
// `hbf_dec_cascade_bank` (:52, pallas_call :174; K7) and
// `hbf_int_cascade_bank` (:210, pallas_call :332; K8).  On the TPU the
// grid walked time chunks in order with the tails in VMEM scratch; here
// a block owns kHbfLanes lanes for the whole block of time and walks the
// chunks in a loop, one thread per lane, its stage buffers and tails in
// its own column of shared memory (row r at smem[r * kHbfLanes + tid]:
// conflict-free, no barrier).
//
// K7 (stage d uses the caller's taps[d], highest rate and fewest taps
// first): per chunk of tc rows the input splits by parity into stage 0's
// buffers, then the stage loop of hbf_stage.cuh (shared with K2/K3) runs
// every stage and writes the last one's tc >> depth rows to y.
//
// K8 (stage d uses taps[d], lowest rate and most taps first): stage d's
// buffer holds its 2m-1 carried input rows, then the n = tc << d new
// ones.  Output j of a stage is the FIR sum in slot 2j and the M-delayed
// input (the center tap) in slot 2j+1 (hbf.py:196-221,
// hbf_pallas.py:292-309); it goes behind the next stage's carried rows,
// or, for the last stage, straight to y.  The last 2m-1 input rows are
// carried.  Shared memory per lane is sum_d (2m_d - 1 + tc << d) rows,
// so it doubles with every stage: at depth 4 with HBF_TAPS and the JAX
// kernel's chunk of 128 a 32-lane block would need 256 KB, above the
// 227 KB a block can have, and the launch would be refused; the wrapper's
// default chunk is 64 (133 KB).  Writing the last stage to y and not to
// shared memory keeps its 2x-wider output out of the budget.
//
// Numerics: every f32 operation is one __f*_rn intrinsic in the plain
// version's order (acc = (b + a) * tap[0]; acc += (b + a) * tap[i], i
// ascending; K7 then + even), so the kernels equal the eager plain
// versions bit for bit, and the chunk changes no value.
//
// What bounds them on the H100: as written, latency.  A FIR has no
// recurrence, but one thread walks its lane's whole block of time: at
// c = 512 lanes that is 16 warps on 132 SMs, each waiting on its own
// shared-memory loads and its serial chain of m adds per output.  The
// roofline bound is device-memory bytes (K7 reads 4 B per input sample,
// K8 writes 4 B per output sample), tens of microseconds at the suite's
// widths.  What the design does: keeps every intermediate stage on chip
// (the TPU kernel's point), and nothing else yet; a grid over lane tiles
// and time segments (each segment warmed up on enough earlier rows to
// rebuild every stage's tail exactly) is the next step.
#include <cuda_runtime.h>

#include <cstdint>

#include "hbf_stage.cuh"

namespace {

using idsp::kHbfLanes;

__global__ void __launch_bounds__(kHbfLanes) hbf_dec_cascade_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, idsp::HbfTaps p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kHbfLanes + tid;
  if (lane >= c) return;  // no block-wide barrier below

  float* col = smem + tid;
  int odd_off[idsp::kHbfMaxDepth], even_off[idsp::kHbfMaxDepth];
  idsp::hbf_dec_offsets(p, tc, odd_off, even_off);
  idsp::hbf_dec_tails<true>(p, col, odd_off, even_off, tails_in, c,
                            lane);
  float* odd0 = col + (odd_off[0] + 2 * p.m[0] - 1) * kHbfLanes;
  float* even0 = col + (even_off[0] + p.m[0] - 1) * kHbfLanes;
  const int nout = tc >> p.depth;
  for (int q = 0; q < t / tc; ++q) {
    const float* xq = xs + static_cast<size_t>(q) * tc * c + lane;
#pragma unroll 8
    for (int u = 0; u < tc; u += 2) {
      even0[(u >> 1) * kHbfLanes] = __ldg(xq + static_cast<size_t>(u) * c);
      odd0[(u >> 1) * kHbfLanes] = __ldg(xq + static_cast<size_t>(u + 1) * c);
    }
    float* yq = y + static_cast<size_t>(q) * nout * c + lane;
    idsp::hbf_dec_stages(p, col, odd_off, even_off, tc, [&](int j, float v) {
      yq[static_cast<size_t>(j) * c] = v;
    });
  }
  idsp::hbf_dec_tails<false>(p, col, odd_off, even_off, tails_out, c, lane);
}

// Shared-memory rows per lane of the interpolation cascade; *off gets
// each stage's buffer offset.
__host__ __device__ inline int hbf_int_rows(const idsp::HbfTaps& p, int tc,
                                            int* off) {
  int rows = 0;
  for (int d = 0; d < p.depth; ++d) {
    if (off != nullptr) off[d] = rows;
    rows += 2 * p.m[d] - 1 + (tc << d);
  }
  return rows;
}

__global__ void __launch_bounds__(kHbfLanes) hbf_int_cascade_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, idsp::HbfTaps p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kHbfLanes + tid;
  if (lane >= c) return;  // no block-wide barrier below
  const int depth = p.depth;
  float* col = smem + tid;
  int off[idsp::kHbfMaxDepth];
  hbf_int_rows(p, tc, off);

  // carried tails in: (2m-1, c) per stage, packed one after another
  int trow = 0;
  for (int d = 0; d < depth; ++d) {
    const int ln = 2 * p.m[d] - 1;
    for (int r = 0; r < ln; ++r)
      col[(off[d] + r) * kHbfLanes] =
          tails_in[static_cast<size_t>(trow + r) * c + lane];
    trow += ln;
  }

  const size_t ny = static_cast<size_t>(tc) << depth;  // y rows per chunk
  for (int q = 0; q < t / tc; ++q) {
    float* in0 = col + (off[0] + 2 * p.m[0] - 1) * kHbfLanes;
    const float* xq = xs + static_cast<size_t>(q) * tc * c + lane;
#pragma unroll 8
    for (int u = 0; u < tc; ++u)
      in0[u * kHbfLanes] = __ldg(xq + static_cast<size_t>(u) * c);
    float* yq = y + q * ny * c + lane;

    for (int d = 0; d < depth; ++d) {
      const int m = p.m[d], ln = 2 * m - 1, n = tc << d;
      const float* tp = p.taps[d];
      float* ext = col + off[d] * kHbfLanes;
      const bool last = d + 1 == depth;
      float* next = last ? nullptr
                         : col + (off[d + 1] + 2 * p.m[d + 1] - 1) * kHbfLanes;
      for (int j = 0; j < n; ++j) {
        float acc = __fmul_rn(
            __fadd_rn(ext[(ln + j) * kHbfLanes], ext[j * kHbfLanes]), tp[0]);
        for (int i = 1; i < m; ++i)
          acc = __fadd_rn(
              acc, __fmul_rn(__fadd_rn(ext[(ln - i + j) * kHbfLanes],
                                       ext[(i + j) * kHbfLanes]),
                             tp[i]));
        const float cen = ext[(m + j) * kHbfLanes];
        if (last) {
          yq[static_cast<size_t>(2 * j) * c] = acc;
          yq[static_cast<size_t>(2 * j + 1) * c] = cen;
        } else {
          next[(2 * j) * kHbfLanes] = acc;
          next[(2 * j + 1) * kHbfLanes] = cen;
        }
      }
      // carry: the last ln input rows move to the front (ascending copy;
      // the source always lies after the destination)
      for (int r = 0; r < ln; ++r) ext[r * kHbfLanes] = ext[(n + r) * kHbfLanes];
    }
  }

  trow = 0;
  for (int d = 0; d < depth; ++d) {
    const int ln = 2 * p.m[d] - 1;
    for (int r = 0; r < ln; ++r)
      tails_out[static_cast<size_t>(trow + r) * c + lane] =
          col[(off[d] + r) * kHbfLanes];
    trow += ln;
  }
}

using Kernel = void (*)(const float*, const float*, float*, float*, int, int,
                        int, idsp::HbfTaps);

int launch(Kernel kernel, size_t rows, const void* xs, const void* tails_in,
           void* tails_out, void* y, int t, int c, int tc,
           const idsp::HbfTaps& p, void* stream) {
  const size_t smem = rows * kHbfLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // a refused size is also the runtime's last error: take it, or the
  // next launch of any kernel in this library would report it
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kHbfLanes - 1) / kHbfLanes);
  kernel<<<grid, kHbfLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(tails_in),
      static_cast<float*>(tails_out), static_cast<float*>(y), t, c, tc, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7: xs (t, c) f32 -> y (t >> depth, c) f32; tails (3m-2, c) per stage,
// packed.  t % tc == 0, tc % 2^depth == 0.  ms (depth,) and taps
// (sum ms,) are host arrays in stage order.
extern "C" int idsp_hbf_dec_cascade(const void* xs, const void* tails_in,
                                    void* tails_out, void* y, int t, int c,
                                    int tc, int depth, const int* ms,
                                    const float* taps, void* stream) {
  idsp::HbfTaps p{};
  if (!idsp::hbf_taps_from_host(p, depth, ms, taps) || tc <= 0 ||
      t % tc != 0 || tc % (1 << depth) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(hbf_dec_cascade_kernel, idsp::hbf_dec_rows(p, tc), xs,
                tails_in, tails_out, y, t, c, tc, p, stream);
}

// K8: xs (t, c) f32 -> y (t << depth, c) f32; tails (2m-1, c) per stage,
// packed.  t % tc == 0.
extern "C" int idsp_hbf_int_cascade(const void* xs, const void* tails_in,
                                    void* tails_out, void* y, int t, int c,
                                    int tc, int depth, const int* ms,
                                    const float* taps, void* stream) {
  idsp::HbfTaps p{};
  if (!idsp::hbf_taps_from_host(p, depth, ms, taps) || tc <= 0 ||
      t % tc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(hbf_int_cascade_kernel, hbf_int_rows(p, tc, nullptr), xs,
                tails_in, tails_out, y, t, c, tc, p, stream);
}
