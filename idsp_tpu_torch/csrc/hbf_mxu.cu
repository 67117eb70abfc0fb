// K22 and K23: the half-band rate-change cascades in their banded-matrix
// form, decimate and interpolate by 2^depth, each in one kernel.
//
// Replaces the Pallas kernels of idsp_tpu/filters/hbf_pallas.py
// `hbf_dec_cascade_mxu` (:409, `_hbf_dec_mxu_impl` :465, pallas_call :567;
// K22) and `hbf_int_cascade_mxu` (:612, `_hbf_int_mxu_impl` :657,
// pallas_call :749; K23).  On the TPU every stage was one product of a
// fixed banded Toeplitz operator with a window of [carry | block] rows,
// and the grid walked time blocks in order with the carries in VMEM.
// Here the band's nonzero entries are summed directly (there are 2m+1 of
// them in a decimating row, 2m in an interpolating even row), and the
// blocks run in parallel:
//
// * Grid: lane tiles of kMxuLanes (blockIdx.x; a warp reads 128
//   contiguous bytes a row) x time segments (blockIdx.y).  A segment is
//   seg full-rate input rows (K22) or seg low-rate input rows (K23).
// * A block computes its segment's outputs of the last stage and, before
//   them, every earlier stage's outputs that those need: its segment plus
//   the cascade's halo, recomputed from xs.  Only an input row with a
//   negative index (before the block of time) comes from the carried
//   state.  The recomputed rows are the same fixed-order sums of the same
//   inputs, so they are the same bits as the segment before computed:
//   this keeps streaming (two half blocks == one block) and the segment
//   size exact.
// * Stage 0 reads xs straight from device memory (through L1); the inputs
//   of stages 1..depth-1 live in shared memory, row r of a stage's buffer
//   at smem[(off + r) * kMxuLanes + lane]; the last stage writes y.  A
//   barrier separates the stages.
// * A block has kMxuWarps = 32 warps.  A warp takes chunks of up to `sub`
//   output rows, cut to its share of the stage so that the short late
//   stages still spread over the warps, and a thread sums kIlp = 4 rows
//   side by side, four independent chains that hide the load and add
//   latencies.
// * The blocks of the last segment also write the new carries: the last
//   4m-2 (K22: packed 2m-1 odd then m-1 even rows, hbf_stage.cuh's layout)
//   or 2m-1 (K23) input rows of each stage.
// * Shared memory per block is the largest segment's stage buffers
//   (computed on the host with the kernel's own plan); a launch above
//   227 KB is refused, leaving no CUDA error pending.
//
// Numerics: output row j of a decimating stage is
//   tv[0]*x[2j-4m+3] + tv[1]*x[2j-4m+5] + ... + tv[m-1]*x[2j-2m+1]
//   + 1*x[2j-2m+2] + tv[m-1]*x[2j-2m+3] + ... + tv[0]*x[2j+1]
// (stage input rows, ascending band columns), and output pair j of an
// interpolating stage is the FIR tv[0]*x[j-2m+1] + ... + tv[m-1]*x[j-m]
// + tv[m-1]*x[j-m+1] + ... + tv[0]*x[j] in slot 2j and x[j-m+1] in slot
// 2j+1, each multiply and add one __f*_rn intrinsic (the unit center as a
// multiply by 1, exact), so the kernels equal the plain versions of
// filters/hbf_mxu.py bit for bit.
//
// What bounds them on the H100: device-memory bytes by the roofline (4 B
// per input row read and per output row written, about 21 us at c = 512,
// t = 32768 for either).  As written, the latency of the loads and of the
// serial adds of each output's sum, and for K22 the halo recomputed per
// segment: 907 full-rate rows for HBF_TAPS at depth 4 against the default
// segment of 256, so stage 0 computes 575 rows for 128 new ones (a
// segment of 1024 rows halves K22's time).  The tensor cores are not
// used: a 3xTF32 or bf16x3 banded product is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "hbf_stage.cuh"

namespace {

constexpr int kMxuLanes = 32;  // lanes of a tile (threadIdx.x)
constexpr int kMxuWarps = 32;  // warps of a block (threadIdx.y)
constexpr int kIlp = 4;        // rows a thread sums side by side
constexpr int kMaxSmem = 232448;
constexpr int kD = idsp::kHbfMaxDepth;

using idsp::HbfTaps;

// One block's rows: stage d computes its output rows (K22) or row pairs
// (K23) [a[d], b[d]) and reads its input rows [lo[d], hi[d]); the input of
// stage d >= 1 sits in shared memory at rows off[d] .. off[d] + hi[d] -
// base[d], row u at off[d] + u - base[d].
struct Plan {
  int a[kD], b[kD], lo[kD], hi[kD], base[kD], off[kD];
  int rows;  // shared-memory rows per lane
};

template <int N>
struct Ilp {
  static constexpr int n = N;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int floor_div2(int v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

// Shared-memory offsets of the stage buffers and their total.
__host__ __device__ inline void plan_buffers(const HbfTaps& p, Plan& q) {
  q.rows = 0;
  for (int d = 1; d < p.depth; ++d) {
    q.off[d] = q.rows;
    q.rows += q.hi[d] - q.base[d];
  }
}

// K22, segment k of seg full-rate rows: output j of stage d reads input
// rows 2j-4m+3 .. 2j+1; stage d's input rows are stage d-1's output rows.
__host__ __device__ inline void dec_plan(const HbfTaps& p, int t, int seg,
                                         int k, Plan& q) {
  const int depth = p.depth;
  const int n_out = t >> depth, s_out = seg >> depth;
  int a = k * s_out, b = imin(a + s_out, n_out);
  for (int d = depth - 1; d >= 0; --d) {
    q.a[d] = imax(a, 0);
    q.b[d] = b;
    q.lo[d] = 2 * q.a[d] - (4 * p.m[d] - 3);
    q.hi[d] = 2 * b;
    q.base[d] = q.lo[d];
    a = q.lo[d];
    b = q.hi[d];
  }
  plan_buffers(p, q);
}

// K23, segment k of seg low-rate rows: output pair j of stage d reads
// input rows j-2m+1 .. j; stage d's input rows are stage d-1's output
// rows, two a pair.
__host__ __device__ inline void int_plan(const HbfTaps& p, int t, int seg,
                                         int k, Plan& q) {
  const int depth = p.depth;
  const int last = depth - 1;
  int a = (k * seg) << last, b = imin((k + 1) * seg, t) << last;
  for (int d = last; d >= 0; --d) {
    q.a[d] = imax(a, 0);
    q.b[d] = b;
    q.lo[d] = q.a[d] - (2 * p.m[d] - 1);
    q.hi[d] = b;
    // stage d-1 writes whole pairs: from the even row below lo (rows
    // below 0 are carried and loaded as they are)
    q.base[d] = q.lo[d] < 0 ? q.lo[d] : q.lo[d] & ~1;
    a = floor_div2(q.lo[d]);
    b = b / 2;
  }
  plan_buffers(p, q);
}

// Carried input row u < 0 of a decimating stage (window row w = 4m-2+u):
// the packed tail holds odd rows (2m-1) then even rows from 2m (m-1);
// the even rows below 2m are never read.
__device__ __forceinline__ float dec_carried(const float* tails, int toff,
                                             int m, int c, int lane, int u) {
  const int w = 4 * m - 2 + u;
  if (w & 1) return tails[static_cast<size_t>(toff + (w >> 1)) * c + lane];
  if (w >= 2 * m)
    return tails[static_cast<size_t>(toff + 2 * m - 1 + ((w - 2 * m) >> 1)) *
                     c + lane];
  return 0.f;
}

__device__ __forceinline__ float int_carried(const float* tails, int toff,
                                             int m, int c, int lane, int u) {
  return tails[static_cast<size_t>(toff + 2 * m - 1 + u) * c + lane];
}

// Tail offsets (rows) of each stage in the packed tails.
__device__ __forceinline__ void tail_offsets(const HbfTaps& p, bool dec,
                                             int* toff) {
  int r = 0;
  for (int d = 0; d < p.depth; ++d) {
    toff[d] = r;
    r += dec ? 3 * p.m[d] - 2 : 2 * p.m[d] - 1;
  }
}

// Calls rows(j, n) for the rows [a, b) this thread's warp takes, n = kIlp
// rows at a time then single rows.  A warp takes chunks of up to sub
// consecutive rows, cut to its share of the stage (whole kIlp groups) so
// that a short stage still spreads over the warps.
template <typename Rows>
__device__ __forceinline__ void for_rows(int a, int b, int sub, Rows rows) {
  const int share = (b - a + kMxuWarps - 1) / kMxuWarps;
  const int per = imax(1, imin(sub, (share + kIlp - 1) / kIlp * kIlp));
  for (int r0 = a + threadIdx.y * per; r0 < b; r0 += kMxuWarps * per) {
    const int r1 = imin(r0 + per, b);
    int j = r0;
    for (; j + kIlp <= r1; j += kIlp) rows(j, Ilp<kIlp>{});
    for (; j < r1; ++j) rows(j, Ilp<1>{});
  }
}

// One decimating stage over this thread's rows [a, b): in(u) reads input
// row u, out(j, v) stores output row j.  N consecutive rows are summed side
// by side (independent chains), each in its own fixed order.
template <typename In, typename Out>
__device__ __forceinline__ void dec_stage(int a, int b, int sub, int m,
                                          const float* tp, In in, Out out) {
  for_rows(a, b, sub, [&](int j, auto ilp) {
    constexpr int N = decltype(ilp)::n;
    const int u0 = 2 * j - 4 * m + 3;
    float acc[N];
#pragma unroll
    for (int r = 0; r < N; ++r) acc[r] = __fmul_rn(tp[0], in(u0 + 2 * r));
    for (int i = 1; i < m; ++i) {
      const float w = tp[i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, in(u0 + 2 * (r + i))));
    }
#pragma unroll
    for (int r = 0; r < N; ++r)
      acc[r] = __fadd_rn(acc[r], __fmul_rn(1.f, in(u0 + 2 * (r + m) - 1)));
    for (int i = 0; i < m; ++i) {
      const float w = tp[m - 1 - i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, in(u0 + 2 * (r + m + i))));
    }
#pragma unroll
    for (int r = 0; r < N; ++r) out(j + r, acc[r]);
  });
}

// One interpolating stage over this thread's row pairs [a, b):
// out(j, fir, center) stores output rows 2j and 2j+1.
template <typename In, typename Out>
__device__ __forceinline__ void int_stage(int a, int b, int sub, int m,
                                          const float* tp, In in, Out out) {
  for_rows(a, b, sub, [&](int j, auto ilp) {
    constexpr int N = decltype(ilp)::n;
    const int u0 = j - 2 * m + 1;
    float acc[N];
#pragma unroll
    for (int r = 0; r < N; ++r) acc[r] = __fmul_rn(tp[0], in(u0 + r));
    for (int i = 1; i < m; ++i) {
      const float w = tp[i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, in(u0 + r + i)));
    }
    for (int i = 0; i < m; ++i) {
      const float w = tp[m - 1 - i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, in(u0 + r + m + i)));
    }
#pragma unroll
    for (int r = 0; r < N; ++r) out(j + r, acc[r], in(u0 + r + m));
  });
}

__global__ void __launch_bounds__(kMxuLanes* kMxuWarps) hbf_dec_mxu_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int seg, int sub, HbfTaps p) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kMxuLanes + threadIdx.x;
  const bool live = lane < c;  // dead lanes still reach every barrier
  const int depth = p.depth;
  Plan q;
  dec_plan(p, t, seg, blockIdx.y, q);
  int toff[kD];
  tail_offsets(p, true, toff);
  float* col = smem + threadIdx.x;
  auto x0 = [&](int u) {  // stage 0's input row u
    return u >= 0 ? __ldg(xs + static_cast<size_t>(u) * c + lane)
                  : dec_carried(tails_in, toff[0], p.m[0], c, lane, u);
  };

  // carried rows (u < 0) of the shared buffers
  if (live)
    for (int d = 1; d < depth; ++d)
      for (int u = q.lo[d] + threadIdx.y; u < imin(0, q.hi[d]);
           u += kMxuWarps)
        col[(q.off[d] + u - q.base[d]) * kMxuLanes] =
            dec_carried(tails_in, toff[d], p.m[d], c, lane, u);

  for (int d = 0; d < depth; ++d) {
    if (live) {
      const int sd = q.off[d] - q.base[d];
      const int so = d + 1 < depth ? q.off[d + 1] - q.base[d + 1] : 0;
      auto out = [&](int j, float v) {
        if (d + 1 == depth)
          y[static_cast<size_t>(j) * c + lane] = v;
        else
          col[(so + j) * kMxuLanes] = v;
      };
      if (d == 0)
        dec_stage(q.a[d], q.b[d], sub, p.m[d], p.taps[d], x0, out);
      else
        dec_stage(q.a[d], q.b[d], sub, p.m[d], p.taps[d],
                  [&](int u) { return col[(sd + u) * kMxuLanes]; }, out);
    }
    __syncthreads();
  }

  if (!live || blockIdx.y + 1 != gridDim.y) return;
  // new carries: of the last 4m-2 input rows of each stage, the odd rows
  // and the even rows from 2m
  for (int d = 0; d < depth; ++d) {
    const int m = p.m[d], u0 = (t >> d) - (4 * m - 2);
    for (int w = threadIdx.y; w < 4 * m - 2; w += kMxuWarps) {
      if (!(w & 1) && w < 2 * m) continue;
      const int r = w & 1 ? w >> 1 : 2 * m - 1 + ((w - 2 * m) >> 1);
      const int u = u0 + w;
      tails_out[static_cast<size_t>(toff[d] + r) * c + lane] =
          d == 0 ? x0(u) : col[(q.off[d] + u - q.base[d]) * kMxuLanes];
    }
  }
}

__global__ void __launch_bounds__(kMxuLanes* kMxuWarps) hbf_int_mxu_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int seg, int sub, HbfTaps p) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kMxuLanes + threadIdx.x;
  const bool live = lane < c;
  const int depth = p.depth;
  Plan q;
  int_plan(p, t, seg, blockIdx.y, q);
  int toff[kD];
  tail_offsets(p, false, toff);
  float* col = smem + threadIdx.x;
  auto x0 = [&](int u) {
    return u >= 0 ? __ldg(xs + static_cast<size_t>(u) * c + lane)
                  : int_carried(tails_in, toff[0], p.m[0], c, lane, u);
  };

  if (live)
    for (int d = 1; d < depth; ++d)
      for (int u = q.base[d] + threadIdx.y; u < imin(0, q.hi[d]);
           u += kMxuWarps)
        col[(q.off[d] + u - q.base[d]) * kMxuLanes] =
            int_carried(tails_in, toff[d], p.m[d], c, lane, u);

  for (int d = 0; d < depth; ++d) {
    if (live) {
      const int sd = q.off[d] - q.base[d];
      const int so = d + 1 < depth ? q.off[d + 1] - q.base[d + 1] : 0;
      auto out = [&](int j, float fir, float cen) {
        if (d + 1 == depth) {
          y[static_cast<size_t>(2 * j) * c + lane] = fir;
          y[static_cast<size_t>(2 * j + 1) * c + lane] = cen;
        } else {
          col[(so + 2 * j) * kMxuLanes] = fir;
          col[(so + 2 * j + 1) * kMxuLanes] = cen;
        }
      };
      if (d == 0)
        int_stage(q.a[d], q.b[d], sub, p.m[d], p.taps[d], x0, out);
      else
        int_stage(q.a[d], q.b[d], sub, p.m[d], p.taps[d],
                  [&](int u) { return col[(sd + u) * kMxuLanes]; }, out);
    }
    __syncthreads();
  }

  if (!live || blockIdx.y + 1 != gridDim.y) return;
  // new carries: the last 2m-1 input rows of each stage
  for (int d = 0; d < depth; ++d) {
    const int ln = 2 * p.m[d] - 1, u0 = (t << d) - ln;
    for (int r = threadIdx.y; r < ln; r += kMxuWarps)
      tails_out[static_cast<size_t>(toff[d] + r) * c + lane] =
          d == 0 ? x0(u0 + r)
                 : col[(q.off[d] + u0 + r - q.base[d]) * kMxuLanes];
  }
}

using Kernel = void (*)(const float*, const float*, float*, float*, int, int,
                        int, int, HbfTaps);
using PlanFn = void (*)(const HbfTaps&, int, int, int, Plan&);

int launch(Kernel kernel, PlanFn plan, int segments, const void* xs,
           const void* tails_in, void* tails_out, void* y, int t, int c,
           int seg, int sub, const HbfTaps& p, void* stream) {
  if (segments < 1 || segments > 65535 || c < 1 || sub < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  for (int k = 0; k < segments; ++k) {
    Plan q;
    plan(p, t, seg, k, q);
    rows = imax(rows, q.rows);
  }
  const size_t smem = static_cast<size_t>(rows) * kMxuLanes * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // a refused size is also the runtime's last error: take it, or the
  // next launch of any kernel in this library would report it
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kMxuLanes - 1) / kMxuLanes, segments);
  const dim3 block(kMxuLanes, kMxuWarps);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(tails_in),
      static_cast<float*>(tails_out), static_cast<float*>(y), t, c, seg, sub,
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K22: xs (t, c) f32 -> y (t >> depth, c) f32; tails (3m-2, c) per stage,
// packed (2m-1 odd rows, m-1 even rows).  t % 2^depth == 0; seg (the
// segment in full-rate rows) a multiple of 2^depth.  ms (depth,) and taps
// (sum ms,) are host arrays in stage order.
extern "C" int idsp_hbf_dec_mxu(const void* xs, const void* tails_in,
                                void* tails_out, void* y, int t, int c,
                                int seg, int sub, int depth, const int* ms,
                                const float* taps, void* stream) {
  HbfTaps p{};
  if (!idsp::hbf_taps_from_host(p, depth, ms, taps) || t <= 0 ||
      t % (1 << depth) != 0 || seg < (1 << depth) ||
      seg % (1 << depth) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int s_out = seg >> depth;
  return launch(hbf_dec_mxu_kernel, dec_plan,
                ((t >> depth) + s_out - 1) / s_out, xs, tails_in, tails_out,
                y, t, c, seg, sub, p, stream);
}

// K23: xs (t, c) f32 -> y (t << depth, c) f32; tails (2m-1, c) per stage,
// packed.  seg >= 1 low-rate rows a segment.
extern "C" int idsp_hbf_int_mxu(const void* xs, const void* tails_in,
                                void* tails_out, void* y, int t, int c,
                                int seg, int sub, int depth, const int* ms,
                                const float* taps, void* stream) {
  HbfTaps p{};
  if (!idsp::hbf_taps_from_host(p, depth, ms, taps) || t <= 0 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(hbf_int_mxu_kernel, int_plan, (t + seg - 1) / seg, xs,
                tails_in, tails_out, y, t, c, seg, sub, p, stream);
}
