// K7 and K8: the pure-FIR half-band rate-change cascades, decimate and
// interpolate by 2^depth, each in one kernel; and K22 and K23 at precision
// "highest", K7's and K8's walks with the stage's sum in the band order.
//
// Replaces the Pallas kernels of idsp_tpu/filters/hbf_pallas.py
// `hbf_dec_cascade_bank` (:52, `_hbf_dec_cascade_impl` :88, pallas_call
// :174; K7) and `hbf_int_cascade_bank` (:210, :242, pallas_call :332; K8).
// On the TPU the grid walked time chunks in order with the tails in VMEM
// scratch.  Here:
//
// * The grid is lane tiles (blockIdx.x, tile::kLanes lanes) x time ranges
//   (blockIdx.y).  Range k owns rows [k*seg, (k+1)*seg) of the last
//   stage's output (K7) or of the input (K8).  The host's plan
//   (filters/hbf_cuda.py `dec_range_plan` / `int_range_plan`) gives seg,
//   the input halo and each stage's halo; the number of ranges changes no
//   value.
// * A block walks its range in chunks of tc input rows, from `halo` input
//   rows before the range's start (never before row 0).  Stage d computes
//   its output rows from stage_halo[d] rows (K7) or row pairs (K8) before
//   the range's first on: what the range's outputs need, the halo
//   recomputed from xs.  A walk that starts at row 0 takes the carried
//   tails as its first carried rows; any other starts from zeros, which
//   feed only rows below those the range needs.  The recomputed rows are
//   the same fixed-order sums of the same inputs, so they are the same
//   bits as the range before computed.  The last range writes the new
//   tails.
// * Each stage's input lives in shared memory, its carried rows (4m-3
//   for K7, 2m-1 for K8) in front of the chunk's new rows; after the
//   chunk they move to the front (tile::move_front), so a range pays for
//   its halo once.  Stage 0's buffer holds two chunks behind its carried
//   rows: the next chunk of xs streams in through cp.async while the
//   current one is computed, and its carried rows move to the front after
//   every second chunk.  Within a chunk every warp works on one stage's
//   rows (hbf_tile.cuh), a barrier between stages; the last stage writes
//   y straight from registers.  Stage 0 takes the input rows in order
//   (parity is an index: a 128-byte row is conflict-free at any stride).
//
// K7 (stage d uses the caller's taps[d], highest rate and fewest taps
// first): output j of stage d reads its input rows 2j-4m+3 .. 2j+1.  The
// carried tails cross device memory packed (3m-2, c) a stage, 2m-1 odd
// rows then m-1 even rows (hbf_pallas.py:71-82); in shared memory the
// 4m-3 carried rows are contiguous, the even rows below 2m-2 unused.
//
// K22 "highest" (hbf_dec_band_kernel; replaces the "highest" path of
// idsp_tpu/filters/hbf_pallas.py `hbf_dec_cascade_mxu` :409, pallas_call
// :567, precisions :426-434): the same cascade, support and tails as K7,
// each output its band row's sum in ascending band column (hbf_tile.cuh
// `dec_band_stage`, the order of filters/hbf_mxu.py `_sum_band`), so it
// equals hbf_dec_cascade_mxu_plain(precision="highest") bit for bit and
// no value depends on the chunk or the ranges.  The TPU ran it as an f32
// banded-matrix product on the MXU; a band row has 2m+1 nonzero entries of
// 4m-1, so here the products are the nonzero ones on the CUDA cores.
//
// K23 "highest" (hbf_int_band_kernel; replaces the "highest" path of
// idsp_tpu/filters/hbf_pallas.py `hbf_int_cascade_mxu` :612, pallas_call
// :749): the same cascade, support and tails as K8, each FIR output its
// band row's sum in ascending band column (hbf_tile.cuh `int_band_stage`,
// `_sum_band`'s order: 4m-1 rounded operations a pair where K8's
// symmetric sum takes 3m-1), the odd rows the center copies, so it equals
// hbf_int_cascade_mxu_plain(precision="highest") bit for bit and no value
// depends on the chunk or the ranges.
//
// K8 (stage d uses taps[d], lowest rate and most taps first): output pair
// j of stage d reads its input rows j-2m+1 .. j and is the FIR sum in slot
// 2j and the input row j-m+1 (the center tap) in slot 2j+1 (hbf.py
// `hbf_int_block`); the tails are the last 2m-1 input rows of each stage.
//
// Numerics: every f32 operation is one __f*_rn intrinsic in the plain
// version's order (hbf_tile.cuh), so the kernels equal the eager plain
// versions bit for bit, and neither the chunk nor the ranges change a
// value.
//
// What bounds them on the H100: device-memory bytes by the roofline (xs
// read once, y written once: about 21 us at c = 512, t = 32768).  What
// holds them above it: the halo (at the default 33 ranges for c = 512 a
// K7 range does about two thirds more tap work than it keeps, 907
// full-rate rows of halo for HBF_TAPS at depth 4; K8 about 6 %), the
// sums (three f32 operations a tap and row, one at a time, the short
// late stages on few warps), and a fixed cost a chunk (a barrier a
// stage, the carried rows' moves, the chunk's bookkeeping).  What the
// design does about them: lane tiles x ranges fill the card
// (BLOCKS_PER_SM of filters/hbf_cuda.py), each range pays for its halo
// once, every stage stays on chip, the xs rows stream in behind the
// sums, the depth is a template argument (the per-stage numbers stay in
// registers), and a move loads all its rows before it stores any (one
// barrier where the rows overlap, no chain of dependent copies).
#include <cuda_runtime.h>

#include <cstdint>

#include "hbf_tile.cuh"

namespace {

using idsp::tile::kLanes;
using idsp::tile::kMaxDepth;
using idsp::tile::kWarps;
using idsp::tile::Taps;

constexpr int kMaxSmem = 232448;  // bytes a block may have

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Per-stage halos of the range plan (a kernel parameter).
struct Halos {
  int rows[kMaxDepth];
};

// Stage buffers in shared memory: stage d at rows off[d] of a lane's
// column, carry[d] carried rows then its chunk's input rows (stage 0: two
// chunks).  Dec: K7 (carries 4m-3, stage d takes tc >> d rows a chunk);
// else K8 (carries 2m-1, tc << d rows).  The kernels take the depth as a
// template argument, so that these per-stage numbers live in registers.
template <int D>
struct Layout {
  int off[D], carry[D];
  int rows;

  __host__ __device__ Layout(const Taps& p, int tc, bool dec) : rows(0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      carry[d] = dec ? 4 * p.m[d] - 3 : 2 * p.m[d] - 1;
      off[d] = rows;
      rows += carry[d] + (d == 0 ? 2 * tc : dec ? tc >> d : tc << d);
    }
  }
};

// The block's walk of its range, the same for both kernels.  The range's
// input rows end at `end`, its walk starts at p0; chunk q takes input
// rows [p0 + q*tc, min(p0 + (q+1)*tc, end)).  Per chunk: wait for its xs
// rows, a barrier, then for each stage stage(d, q, cs, ce) and a barrier,
// after it the stage's carried rows to the front (stage 0's after every
// second chunk) and, after stage 0, the next chunk's fetch.  Returns the
// last chunk's index.
template <int D, class Stage>
__device__ __forceinline__ int walk(const Layout<D>& L, float* col,
                                    const float* xs, int c, int lane,
                                    bool live, int p0, int end, int tc,
                                    bool dec, Stage stage) {
  const int chunks = (end - p0 + tc - 1) / tc;
  auto fetch = [&](int q) {
    const int r0 = p0 + q * tc;
    idsp::tile::fetch_rows(
        col + (L.off[0] + L.carry[0] + (q & 1) * tc) * kLanes, xs, c, lane,
        live, r0, imin(r0 + tc, end));
  };
  fetch(0);
  for (int q = 0; q < chunks; ++q) {
    const int cs = p0 + q * tc, ce = imin(cs + tc, end);
    const bool more = q + 1 < chunks;
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      stage(d, q, cs, ce);
      __syncthreads();
      if (!more) continue;  // the last chunk's rows stay for the tails
      if (d == 0) {
        // the moved rows may reach into the slot the fetch refills
        if (q & 1)
          idsp::tile::move_front(col + L.off[0] * kLanes, L.carry[0], 2 * tc,
                                 tc < L.carry[0]);
        fetch(q + 1);
      } else {
        const int n = dec ? (ce - cs) >> d : (ce - cs) << d;
        idsp::tile::move_front(col + L.off[d] * kLanes, L.carry[d], n, false);
      }
    }
  }
  return chunks - 1;
}

// The decimating walk of K7 (Band false: hbf.py's symmetric order) and
// of K22 "highest" (Band true: the band order of filters/hbf_mxu.py);
// the two differ only in the stage's sum.
template <int D, bool Band>
__device__ __forceinline__ void dec_cascade(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, const Taps& p, const Halos& h) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool live = lane < c;  // dead lanes still reach every barrier
  const Layout<D> L(p, tc, true);
  float* col = smem + threadIdx.x;
  const int s = blockIdx.y * seg, e = imin(s + seg, t >> D);
  const int end = e << D, p0 = imax(0, (s << D) - halo);
  int a[D];  // each stage's first output row the range needs
#pragma unroll
  for (int d = 0; d < D; ++d) a[d] = imax(0, (s << (D - 1 - d)) - h.rows[d]);

  int toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m = p.m[d];
    for (int r = threadIdx.y; r < L.carry[d]; r += kWarps)
      col[(L.off[d] + r) * kLanes] =
          p0 == 0 && live
              ? idsp::tile::dec_tail(tails_in, toff, m, c, lane, r)
              : 0.f;
    toff += 3 * m - 2;
  }

  // stage d's input row u sits at row u - base(d, q, cs) of its buffer
  auto base = [&](int d, int q, int cs) {
    return (cs >> d) - L.carry[d] - (d == 0 ? (q & 1) * tc : 0);
  };
  const int q_last = walk<D>(
      L, col, xs, c, lane, live, p0, end, tc, true,
      [&](int d, int q, int cs, int ce) {
        const int sd = L.off[d] - base(d, q, cs);
        auto in = [&](int u) { return col[(sd + u) * kLanes]; };
        const int lo = imax(cs >> (d + 1), a[d]), hi = ce >> (d + 1);
        auto sum = [&](auto out) {
          if constexpr (Band)
            idsp::tile::dec_band_stage(lo, hi, p.m[d], p.taps[d], in, out);
          else
            idsp::tile::dec_stage(lo, hi, p.m[d], p.taps[d], in, out);
        };
        if (d + 1 < D) {
          const int so = L.off[d + 1] - base(d + 1, q, cs);
          sum([&](int j, float v) { col[(so + j) * kLanes] = v; });
        } else {
          sum([&](int j, float v) {
            if (live) y[static_cast<size_t>(j) * c + lane] = v;
          });
        }
      });

  if (!live || blockIdx.y + 1 != gridDim.y) return;
  // new tails: the last 4m-3 input rows of each stage, odd rows then the
  // even rows from 2m-2 (filters/ddc_cuda.py `hbf1_tail_init`'s packing)
  const int cs = p0 + q_last * tc;
  toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m = p.m[d];
    const int sl = L.off[d] + (end >> d) - L.carry[d] - base(d, q_last, cs);
    for (int r = threadIdx.y; r < 3 * m - 2; r += kWarps)
      tails_out[static_cast<size_t>(toff + r) * c + lane] =
          col[(sl + idsp::tile::dec_packed(m, r)) * kLanes];
    toff += 3 * m - 2;
  }
}

template <int D>
__global__ void __launch_bounds__(kLanes* kWarps) hbf_dec_cascade_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, Taps p, Halos h) {
  dec_cascade<D, false>(xs, tails_in, tails_out, y, t, c, tc, seg, halo, p,
                        h);
}

template <int D>
__global__ void __launch_bounds__(kLanes* kWarps) hbf_dec_band_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, Taps p, Halos h) {
  dec_cascade<D, true>(xs, tails_in, tails_out, y, t, c, tc, seg, halo, p,
                       h);
}

// The interpolating walk of K8 (Band false: hbf.py's symmetric order) and
// of K23 "highest" (Band true: the band order of filters/hbf_mxu.py); the
// two differ only in the stage's sum.
template <int D, bool Band>
__device__ __forceinline__ void int_cascade(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, const Taps& p, const Halos& h) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool live = lane < c;
  const Layout<D> L(p, tc, false);
  float* col = smem + threadIdx.x;
  const int s = blockIdx.y * seg, end = imin(s + seg, t);
  const int p0 = imax(0, s - halo);
  int a[D];  // each stage's first output pair the range needs
#pragma unroll
  for (int d = 0; d < D; ++d) a[d] = imax(0, (s << d) - h.rows[d]);

  int toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    for (int r = threadIdx.y; r < L.carry[d]; r += kWarps)
      col[(L.off[d] + r) * kLanes] =
          p0 == 0 && live
              ? tails_in[static_cast<size_t>(toff + r) * c + lane]
              : 0.f;
    toff += L.carry[d];
  }

  auto base = [&](int d, int q, int cs) {
    return (cs << d) - L.carry[d] - (d == 0 ? (q & 1) * tc : 0);
  };
  const int q_last = walk<D>(
      L, col, xs, c, lane, live, p0, end, tc, false,
      [&](int d, int q, int cs, int ce) {
        const int sd = L.off[d] - base(d, q, cs);
        auto in = [&](int u) { return col[(sd + u) * kLanes]; };
        const int lo = imax(cs << d, a[d]), hi = ce << d;
        auto sum = [&](auto out) {
          if constexpr (Band)
            idsp::tile::int_band_stage(lo, hi, p.m[d], p.taps[d], in, out);
          else
            idsp::tile::int_stage(lo, hi, p.m[d], p.taps[d], in, out);
        };
        if (d + 1 < D) {
          const int so = L.off[d + 1] - base(d + 1, q, cs);
          sum([&](int j, float fir, float cen) {
            col[(so + 2 * j) * kLanes] = fir;
            col[(so + 2 * j + 1) * kLanes] = cen;
          });
        } else {
          sum([&](int j, float fir, float cen) {
            if (!live) return;
            y[static_cast<size_t>(2 * j) * c + lane] = fir;
            y[static_cast<size_t>(2 * j + 1) * c + lane] = cen;
          });
        }
      });

  if (!live || blockIdx.y + 1 != gridDim.y) return;
  // new tails: the last 2m-1 input rows of each stage
  const int cs = p0 + q_last * tc;
  toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int sl = L.off[d] + (end << d) - L.carry[d] - base(d, q_last, cs);
    for (int r = threadIdx.y; r < L.carry[d]; r += kWarps)
      tails_out[static_cast<size_t>(toff + r) * c + lane] =
          col[(sl + r) * kLanes];
    toff += L.carry[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kLanes* kWarps) hbf_int_cascade_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, Taps p, Halos h) {
  int_cascade<D, false>(xs, tails_in, tails_out, y, t, c, tc, seg, halo, p,
                        h);
}

template <int D>
__global__ void __launch_bounds__(kLanes* kWarps) hbf_int_band_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int seg, int halo, Taps p, Halos h) {
  int_cascade<D, true>(xs, tails_in, tails_out, y, t, c, tc, seg, halo, p,
                       h);
}

using Kernel = void (*)(const float*, const float*, float*, float*, int, int,
                        int, int, int, Taps, Halos);

// K7, K22 "highest", K8, K23 "highest"
enum Kind { kDec, kDecBand, kInt, kIntBand };

template <int D>
int launch(Kind kind, const void* xs, const void* tails_in, void* tails_out,
           void* y, int t, int c, int tc, int seg, int halo, const Taps& p,
           const Halos& h, void* stream) {
  const bool dec = kind == kDec || kind == kDecBand;
  const Kernel kernel = kind == kDec      ? hbf_dec_cascade_kernel<D>
                        : kind == kDecBand ? hbf_dec_band_kernel<D>
                        : kind == kInt     ? hbf_int_cascade_kernel<D>
                                           : hbf_int_band_kernel<D>;
  const int rows = dec ? t >> D : t;  // the rows the ranges cut
  const int ranges = (rows + seg - 1) / seg;
  if (ranges > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Layout<D>(p, tc, dec).rows) *
                      kLanes * sizeof(float);
  // a refused size leaves no CUDA error pending
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kLanes - 1) / kLanes, ranges);
  const dim3 block(kLanes, kWarps);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(tails_in),
      static_cast<float*>(tails_out), static_cast<float*>(y), t, c, tc, seg,
      halo, p, h);
  return static_cast<int>(cudaGetLastError());
}

int launch(Kind kind, const void* xs, const void* tails_in, void* tails_out,
           void* y, int t, int c, int tc, int seg, int halo, int depth,
           const int* ms, const float* taps, const int* stage_halo,
           void* stream) {
  Taps p{};
  if (!idsp::tile::taps_from_host(p, depth, ms, taps) || c < 1 || tc < 1 ||
      seg < 1 || halo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Halos h{};
  for (int d = 0; d < depth; ++d) {
    if (stage_halo[d] < 0) return static_cast<int>(cudaErrorInvalidValue);
    h.rows[d] = stage_halo[d];
  }
  switch (depth) {
    case 1:
      return launch<1>(kind, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                       p, h, stream);
    case 2:
      return launch<2>(kind, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                       p, h, stream);
    case 3:
      return launch<3>(kind, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                       p, h, stream);
    default:
      return launch<4>(kind, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                       p, h, stream);
  }
}

// K7 and K22 "highest": the checks of a decimating call, then the launch.
int launch_dec(Kind kind, const void* xs, const void* tails_in,
               void* tails_out, void* y, int t, int c, int tc, int seg,
               int halo, int depth, const int* ms, const float* taps,
               const int* stage_halo, void* stream) {
  if (depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = 1 << depth;
  if (t <= 0 || t % r != 0 || tc % r != 0 || halo % r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(kind, xs, tails_in, tails_out, y, t, c, tc, seg, halo, depth,
                ms, taps, stage_halo, stream);
}

}  // namespace

// K7: xs (t, c) f32 -> y (t >> depth, c) f32; tails (3m-2, c) per stage,
// packed.  t a positive multiple of 2^depth; tc, seg*2^depth and halo
// multiples of 2^depth.  ms (depth,), taps (sum ms,) and stage_halo
// (depth,) are host arrays in stage order.
extern "C" int idsp_hbf_dec_cascade(const void* xs, const void* tails_in,
                                    void* tails_out, void* y, int t, int c,
                                    int tc, int seg, int halo, int depth,
                                    const int* ms, const float* taps,
                                    const int* stage_halo, void* stream) {
  return launch_dec(kDec, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                    depth, ms, taps, stage_halo, stream);
}

// K22 "highest" (filters/hbf_mxu.py): K7's arguments, each output the
// band row's sum in the band order.
extern "C" int idsp_hbf_dec_band(const void* xs, const void* tails_in,
                                 void* tails_out, void* y, int t, int c,
                                 int tc, int seg, int halo, int depth,
                                 const int* ms, const float* taps,
                                 const int* stage_halo, void* stream) {
  return launch_dec(kDecBand, xs, tails_in, tails_out, y, t, c, tc, seg,
                    halo, depth, ms, taps, stage_halo, stream);
}

// K8: xs (t, c) f32 -> y (t << depth, c) f32; tails (2m-1, c) per stage,
// packed.  seg and tc low-rate rows.
extern "C" int idsp_hbf_int_cascade(const void* xs, const void* tails_in,
                                    void* tails_out, void* y, int t, int c,
                                    int tc, int seg, int halo, int depth,
                                    const int* ms, const float* taps,
                                    const int* stage_halo, void* stream) {
  if (t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kInt, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                depth, ms, taps, stage_halo, stream);
}

// K23 "highest" (filters/hbf_mxu.py): K8's arguments, each FIR output the
// band row's sum in the band order.
extern "C" int idsp_hbf_int_band(const void* xs, const void* tails_in,
                                 void* tails_out, void* y, int t, int c,
                                 int tc, int seg, int halo, int depth,
                                 const int* ms, const float* taps,
                                 const int* stage_halo, void* stream) {
  if (t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kIntBand, xs, tails_in, tails_out, y, t, c, tc, seg, halo,
                depth, ms, taps, stage_halo, stream);
}
