// The half-band decimation cascade over one chunk of a lane, in shared
// memory: the FIR-stage loop shared by K2/K3 (ddc_cascade.cu, behind the
// DF1) and K7 (hbf_cascade.cu, straight from the input).
//
// Replaces the stage loop of idsp_tpu/filters/ddc_pallas.py
// `_run_fused_cascade` (:519; stages :620-644, `_fir_even` :506) and of
// idsp_tpu/filters/hbf_pallas.py `_hbf_dec_cascade_impl` (:88; stages
// :136-152): the same parity-plane layout and carried-tail choreography.
//
// Layout: one thread per lane, kHbfLanes lanes per block; row r of a
// thread's column is smem[r * kHbfLanes + tid], so a warp's accesses are
// conflict-free and no barrier is needed.  Stage d of a chunk of tc rows
// has an odd buffer (2m-1 carried rows + n new rows) then an even buffer
// (m-1 carried rows + n new rows), n = tc >> (d+1).  Carried tails cross
// device memory packed (3m-2, c) per stage, 2m-1 odd rows then m-1 even
// rows (hbf_pallas.py:71-82), stages one after the other.
//
// Numerics: every f32 operation is one __f*_rn intrinsic in the plain
// PyTorch version's order, acc = (b + a) * tap[0], acc += (b + a) *
// tap[i] for i ascending, then + even, so nvcc cannot contract them into
// FMAs and the kernels equal the eager plain versions bit for bit.
#pragma once

#include <cstddef>

namespace idsp {

constexpr int kHbfLanes = 32;    // lanes (threads) per block
constexpr int kHbfMaxDepth = 4;  // half-band stages
constexpr int kHbfMaxTaps = 32;  // one-sided taps per stage

// Per-stage one-sided taps in stage order (a kernel parameter).
struct HbfTaps {
  int depth;
  int m[kHbfMaxDepth];
  float taps[kHbfMaxDepth][kHbfMaxTaps];
};

// Host side: fill p from ms (depth,) and the concatenated taps; false
// if a size is out of range.
inline bool hbf_taps_from_host(HbfTaps& p, int depth, const int* ms,
                               const float* taps) {
  if (depth < 1 || depth > kHbfMaxDepth) return false;
  p.depth = depth;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    const int m = ms[d];
    if (m < 1 || m > kHbfMaxTaps) return false;
    p.m[d] = m;
    for (int i = 0; i < m; ++i) p.taps[d][i] = taps[off + i];
    off += m;
  }
  return true;
}

// Host side: shared-memory rows per lane of the decimation cascade for
// chunks of tc rows.
inline size_t hbf_dec_rows(const HbfTaps& p, int tc) {
  size_t rows = 0;
  for (int d = 0; d < p.depth; ++d)
    rows += 2 * static_cast<size_t>(tc >> (d + 1)) + 3 * p.m[d] - 2;
  return rows;
}

// Offsets of each stage's odd and even buffers in a lane's column.
__device__ __forceinline__ void hbf_dec_offsets(const HbfTaps& p, int tc,
                                                int* odd_off, int* even_off) {
  int off = 0;
  for (int d = 0; d < p.depth; ++d) {
    const int m = p.m[d], n = tc >> (d + 1);
    odd_off[d] = off;
    off += n + 2 * m - 1;
    even_off[d] = off;
    off += n + m - 1;
  }
}

// Carried tails in (Load: tails -> column) or out (column -> tails):
// (3m-2, c) per stage, packed one after another; col is the lane's
// column, lane its index in c.
template <bool Load, class F>
__device__ __forceinline__ void hbf_dec_tails(const HbfTaps& p, float* col,
                                              const int* odd_off,
                                              const int* even_off, F* tails,
                                              int c, int lane) {
  int trow = 0;
  for (int d = 0; d < p.depth; ++d) {
    const int ln = 2 * p.m[d] - 1, me = p.m[d] - 1;
    for (int r = 0; r < ln + me; ++r) {
      float* s = col + ((r < ln ? odd_off[d] + r : even_off[d] + r - ln) *
                        kHbfLanes);
      F* g = tails + static_cast<size_t>(trow + r) * c + lane;
      if constexpr (Load) {
        *s = *g;
      } else {
        *g = *s;
      }
    }
    trow += ln + me;
  }
}

// Every stage over a chunk of tc rows whose stage-0 rows are in place
// (odd rows at odd_off[0] + 2m-1, even rows at even_off[0] + m-1): each
// stage's output rows split by parity into the next stage's buffers,
// even rows to even, odd rows to odd (ddc_pallas.py:632-638), or, for
// the last stage, go to put(j, y) for j = 0 .. (tc >> depth) - 1; then
// the tails move to the front of their buffers (:641-644).
//
// The taps are read straight from the kernel parameter p: a pointer to
// it kept in a struct made nvcc copy the whole parameter to local memory
// (a 616-byte stack frame) and cost K2 36 %.
template <class Put>
__device__ __forceinline__ void hbf_dec_stages(const HbfTaps& p, float* col,
                                               const int* odd_off,
                                               const int* even_off, int tc,
                                               Put put) {
  const int depth = p.depth;
  for (int d = 0; d < depth; ++d) {
    const int m = p.m[d], ln = 2 * m - 1, me = m - 1, n = tc >> (d + 1);
    const float* tp = p.taps[d];
    float* odd = col + odd_off[d] * kHbfLanes;
    float* even = col + even_off[d] * kHbfLanes;
    const bool last = d + 1 == depth;
    float* nodd = nullptr;
    float* neven = nullptr;
    if (!last) {
      nodd = col + (odd_off[d + 1] + 2 * p.m[d + 1] - 1) * kHbfLanes;
      neven = col + (even_off[d + 1] + p.m[d + 1] - 1) * kHbfLanes;
    }
    for (int j = 0; j < n; ++j) {
      float acc = __fmul_rn(
          __fadd_rn(odd[(ln + j) * kHbfLanes], odd[j * kHbfLanes]), tp[0]);
      for (int i = 1; i < m; ++i)
        acc = __fadd_rn(
            acc, __fmul_rn(__fadd_rn(odd[(ln - i + j) * kHbfLanes],
                                     odd[(i + j) * kHbfLanes]),
                           tp[i]));
      const float yv = __fadd_rn(acc, even[j * kHbfLanes]);
      if (last) {
        put(j, yv);
      } else if (j & 1) {
        nodd[(j >> 1) * kHbfLanes] = yv;
      } else {
        neven[(j >> 1) * kHbfLanes] = yv;
      }
    }
    // carry: the last ln odd / me even rows move to the front
    // (ascending copy; the source always lies after the destination)
    for (int r = 0; r < ln; ++r) odd[r * kHbfLanes] = odd[(n + r) * kHbfLanes];
    for (int r = 0; r < me; ++r) even[r * kHbfLanes] = even[(n + r) * kHbfLanes];
  }
}

}  // namespace idsp
