// The half-band FIR stages of one lane tile, a team of warps on the rows
// of one stage: the stage code of K7, K8 and K22 / K23 "highest"
// (hbf_cascade.cu; the team every warp of the block) and of K2, K3 and
// K19-K21 (ddc_cascade.cu; the team the block's FIR warps).
//
// Layout: a tile is kLanes lanes (a warp reads a 128-byte row); in
// hbf_cascade.cu a block is kLanes (threadIdx.x) x kWarps warps
// (threadIdx.y).  A stage's input rows sit in shared memory, row r of a
// buffer at buf[r * kLanes + lane], so any row a warp reads or writes is
// one conflict-free access.  A stage's output rows are cut into groups of
// kIlp consecutive rows, dealt round robin to the team's warps; a thread
// sums its group's rows side by side, kIlp independent chains that hide
// the load and add latencies.  A barrier separates the stages (the
// caller's).
//
// Numerics: each output is the plain version's sum in its order (hbf.py
// `symmetric_fir`): acc = (b + a) * tap[0], acc += (b + a) * tap[i] for i
// ascending, then + even (decimation; K22's and K23's band order:
// dec_band_stage, int_band_stage), every f32 operation one __f*_rn
// intrinsic, so nvcc cannot contract them into FMAs and the kernels equal
// the eager plain versions bit for bit.
#pragma once

#include <cuda_pipeline.h>

#include <cstddef>

namespace idsp {
namespace tile {

constexpr int kLanes = 32;   // lanes of a tile (threadIdx.x)
constexpr int kWarps = 8;    // warps of a block (threadIdx.y)
constexpr int kIlp = 4;      // rows a thread sums side by side
constexpr int kMaxDepth = 4;  // half-band stages
constexpr int kMaxTaps = 32;  // one-sided taps per stage

// Per-stage one-sided taps in stage order (a kernel parameter).
struct Taps {
  int depth;
  int m[kMaxDepth];
  float taps[kMaxDepth][kMaxTaps];
};

// Host side: fill p from ms (depth,) and the concatenated taps; false
// if a size is out of range.
inline bool taps_from_host(Taps& p, int depth, const int* ms,
                           const float* taps) {
  if (depth < 1 || depth > kMaxDepth) return false;
  p.depth = depth;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    const int m = ms[d];
    if (m < 1 || m > kMaxTaps) return false;
    p.m[d] = m;
    for (int i = 0; i < m; ++i) p.taps[d][i] = taps[off + i];
    off += m;
  }
  return true;
}

template <int N>
struct Ilp {
  static constexpr int n = N;
};

// The warps that share a stage's rows: this warp's index id() of n(), and
// their barrier sync(); kMin bounds n() from below (move_front's
// registers).  BlockTeam: every warp of a kLanes x kWarps block.
struct BlockTeam {
  static constexpr int kMin = kWarps;
  __device__ __forceinline__ int id() const { return threadIdx.y; }
  __device__ __forceinline__ int n() const { return kWarps; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Calls rows(j, Ilp<N>{}) for this warp's groups of the rows [a, b):
// groups of kIlp rows round robin over the team's warps, a short last
// group row by row.
template <class Team, class Rows>
__device__ __forceinline__ void for_rows(int a, int b, const Team& team,
                                         Rows rows) {
  for (int j = a + team.id() * kIlp; j < b; j += team.n() * kIlp) {
    if (j + kIlp <= b) {
      rows(j, Ilp<kIlp>{});
    } else {
      for (int k = j; k < b; ++k) rows(k, Ilp<1>{});
    }
  }
}

// A decimating stage's output rows [a, b): output j reads input rows
// 2j-4m+3 .. 2j+1 through in(u) (odd rows: the FIR, b = x[2j+1-2i],
// a = x[2j-4m+3+2i]; even row 2j-2m+2: the center) and goes to out(j, v).
template <class In, class Out, class Team = BlockTeam>
__device__ __forceinline__ void dec_stage(int a, int b, int m,
                                          const float* tp, In in, Out out,
                                          const Team& team = Team{}) {
  for_rows(a, b, team, [&](int j, auto ilp) {
    constexpr int N = decltype(ilp)::n;
    const int lo = 2 * j - 4 * m + 3, hi = 2 * j + 1;
    float acc[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      acc[r] = __fmul_rn(__fadd_rn(in(hi + 2 * r), in(lo + 2 * r)), tp[0]);
    for (int i = 1; i < m; ++i) {
      const float w = tp[i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(
            acc[r], __fmul_rn(__fadd_rn(in(hi + 2 * (r - i)),
                                        in(lo + 2 * (r + i))),
                              w));
    }
#pragma unroll
    for (int r = 0; r < N; ++r)
      out(j + r, __fadd_rn(acc[r], in(lo + 2 * m - 1 + 2 * r)));
  });
}

// dec_stage's rows in the band order of K22 "highest" (filters/hbf_mxu.py
// `_sum_band`, `dec_band_row`): output j is the sum over its band row's
// nonzero entries in ascending input row, u0 = 2j-4m+3: tap[i] * x[u0+2i]
// for i ascending, the unit center 1 * x[u0+2m-1], tap[m-1-i] *
// x[u0+2m+2i] for i ascending, the first product the sum's start.
template <class In, class Out>
__device__ __forceinline__ void dec_band_stage(int a, int b, int m,
                                               const float* tp, In in,
                                               Out out) {
  for_rows(a, b, BlockTeam{}, [&](int j, auto ilp) {
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

// An interpolating stage's output row pairs [a, b): pair j reads input
// rows j-2m+1 .. j through in(u) (b = x[j-i], a = x[j-2m+1+i]) and goes
// to out(j, fir, center), fir for row 2j, the center x[j-m+1] for 2j+1.
template <class In, class Out>
__device__ __forceinline__ void int_stage(int a, int b, int m,
                                          const float* tp, In in, Out out) {
  for_rows(a, b, BlockTeam{}, [&](int j, auto ilp) {
    constexpr int N = decltype(ilp)::n;
    const int lo = j - 2 * m + 1;
    float acc[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      acc[r] = __fmul_rn(__fadd_rn(in(j + r), in(lo + r)), tp[0]);
    for (int i = 1; i < m; ++i) {
      const float w = tp[i];
#pragma unroll
      for (int r = 0; r < N; ++r)
        acc[r] = __fadd_rn(
            acc[r], __fmul_rn(__fadd_rn(in(j + r - i), in(lo + r + i)), w));
    }
#pragma unroll
    for (int r = 0; r < N; ++r) out(j + r, acc[r], in(lo + m + r));
  });
}

// int_stage's row pairs in the band order of K23 "highest"
// (filters/hbf_mxu.py `_sum_band`, `int_band_row`): pair j's FIR is the
// sum over its band row's nonzero entries in ascending input row, u0 =
// j-2m+1: tap[0] * x[u0] the sum's start, tap[i] * x[u0+i] for i
// ascending, then tap[m-1-i] * x[u0+m+i] for i ascending; the center
// x[j-m+1] as int_stage's.
template <class In, class Out>
__device__ __forceinline__ void int_band_stage(int a, int b, int m,
                                               const float* tp, In in,
                                               Out out) {
  for_rows(a, b, BlockTeam{}, [&](int j, auto ilp) {
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
    for (int r = 0; r < N; ++r) out(j + r, acc[r], in(u0 + m + r));
  });
}

// Rows [shift, shift + carry) of the column col move to [0, carry), for
// carry <= kMaxCarry, the team's warps taking rows round robin.  Every
// thread loads its rows into registers, then stores them.  Where the two
// ranges overlap (shift < carry), or where the caller asks for it (sync,
// the same in every thread: it will overwrite source rows next), the
// team's barrier between the loads and the stores keeps a row from being
// overwritten before every thread has read it.
constexpr int kMaxCarry = 4 * kMaxTaps - 3;
template <class Team = BlockTeam>
__device__ __forceinline__ void move_front(float* col, int carry, int shift,
                                           bool sync,
                                           const Team& team = Team{}) {
  constexpr int kRows = (kMaxCarry + Team::kMin - 1) / Team::kMin;
  float v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = team.id() + k * team.n();
    if (r < carry) v[k] = col[(r + shift) * kLanes];
  }
  if (sync || shift < carry) team.sync();
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = team.id() + k * team.n();
    if (r < carry) col[r * kLanes] = v[k];
  }
}

// The decimating stages' carried rows (K7's layout): stage d keeps its
// last 4m-3 input rows, contiguous in shared memory; across device memory
// they travel packed (3m-2, c) a stage (filters/ddc_cuda.py
// `hbf1_tail_init`), 2m-1 odd rows then m-1 even rows.  Carried row r
// (input row r - (4m-3)) in from the packed tail at row toff: the odd rows
// (even r), the even rows from 2m-2 (odd r from 2m-1), the others unused
// (0).
__device__ __forceinline__ float dec_tail(const float* tails, int toff,
                                          int m, int c, int lane, int r) {
  if (!(r & 1)) return tails[static_cast<size_t>(toff + r / 2) * c + lane];
  if (r >= 2 * m - 1)
    return tails[static_cast<size_t>(toff + 2 * m - 1 + (r - 2 * m + 1) / 2) *
                     c + lane];
  return 0.f;
}

// ... and out: packed row r of 3m-2 is the carried row dec_packed(m, r).
__host__ __device__ __forceinline__ int dec_packed(int m, int r) {
  return r < 2 * m - 1 ? 2 * r : 2 * r - 2 * m + 1;
}

// Rows [r0, r1) of xs (row stride c) to col's rows 0 .. r1-r0-1 through
// cp.async, the warps taking rows round robin; one commit group.  A dead
// lane (live false) copies nothing.
__device__ __forceinline__ void fetch_rows(float* col, const float* xs,
                                           int c, int lane, bool live,
                                           int r0, int r1) {
  if (live)
    for (int r = r0 + threadIdx.y; r < r1; r += kWarps)
      __pipeline_memcpy_async(col + (r - r0) * kLanes,
                              xs + static_cast<size_t>(r) * c + lane,
                              sizeof(float));
  __pipeline_commit();
}

}  // namespace tile
}  // namespace idsp
