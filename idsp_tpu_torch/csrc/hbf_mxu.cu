// K22 and K23: the half-band rate-change cascades in their banded-matrix
// form, decimate and interpolate by 2^depth, each in one kernel a
// precision ("highest" in hbf_cascade.cu, the others here).
//
// Replaces the Pallas kernels of idsp_tpu/filters/hbf_pallas.py
// `hbf_dec_cascade_mxu` (:409, `_hbf_dec_mxu_impl` :465, pallas_call :567;
// K22) and `hbf_int_cascade_mxu` (:612, `_hbf_int_mxu_impl` :657,
// pallas_call :749; K23).  On the TPU every stage was one product of a
// fixed banded Toeplitz operator with a window of [carry | block] rows on
// the MXU, at one of three precisions (:426-434), and the grid walked time
// blocks in order with the carries in VMEM.
//
// "split3" and "default" (hbf_dec_mma_kernel, hbf_int_mma_kernel) keep the
// TPU's arithmetic: bf16 operands, hi = bf16(v) and lo = bf16(v - hi)
// (hbf_mma.cuh), products on the tensor cores with f32 accumulation,
// `mma.sync` m16n8k16; "split3" adds Wh.Xh + (Wh.Xl + Wl.Xh), "default"
// takes Wh.Xh alone.  K23's odd rows (the M-delayed center copies, band
// weight 1) are written as hi + lo (or hi) straight from the input's
// planes, no tensor-core work.  The walk is K7's (hbf_cascade.cu):
//
// * Grid: lane tiles of 32 (blockIdx.x) x time ranges (blockIdx.y, the
//   host's count, each range a multiple of 16 last-stage rows).  A block
//   walks its range in chunks of tc stage-0 input rows from the exact
//   halo its outputs need, each stage's first needed 16-row tile
//   recomputed, never more.
// * A tile is 16 consecutive output rows (K22) or row pairs (K23) of a
//   stage x the 32 lanes, four n8 MMAs a k-step sharing one A fragment;
//   its window is K input rows (4m+29 or 2m+15 padded to 16 in front:
//   K = 48 / 64 / 80 / 128 for m = 4 / 5 / 10 / 23).  The band is
//   Toeplitz, so one (16 x K) A tile a stage serves every tile: built once
//   a block in shared memory from the host's bf16 hi/lo band (Band), read
//   with `ldmatrix`.
// * Every stage's input rows live in a shared-memory ring (carry + chunk
//   rows) as bf16 hi/lo planes [row][lane], converted once a row: stage
//   0's from xs with 16-byte loads, the others' in the previous stage's
//   epilogue straight from the accumulators.  B fragments come from the
//   ring with `ldmatrix.trans`; the last stage writes y.  A barrier
//   separates the stages.
// * Alignment: every stage's tiles start at multiples of 16 rows counted
//   from row 0 of the call, ranges and chunks too, so a tile's window and
//   its k-steps are the same whatever the range count, the chunk, `sub`
//   (tiles a warp takes at a time) or the lane tile: the outputs are the
//   same bits for every tiling, and two half blocks equal one block bit
//   for bit wherever each stage's per-call row count is a multiple of 16
//   (t = 32768 and its halves).  Elsewhere a call boundary moves the
//   tiles, and streaming holds within the tolerance of the plain version.
// * The last range writes the new tails: stage 0's from xs, the others'
//   from the epilogues (4m-2 packed, K22; 2m-1, K23).
//
// "highest" sums the band's nonzero entries in f32 on the CUDA cores,
// each multiply and add one __f*_rn intrinsic in ascending band column
// order, so it equals the plain version of filters/hbf_mxu.py bit for bit:
// K22's on K7's walk and K23's on K8's (hbf_cascade.cu
// `hbf_dec_band_kernel`, `hbf_int_band_kernel`: lane tiles x time ranges
// from exact halos, the band order being their only change).
//
// Numerics of "split3" and "default": a product of bf16 parts is exact;
// the tensor cores sum a k-step's 16 products in their own order, so the
// outputs are not the plain version's bits.  A last-bit difference in a
// stage output can move the next stage's split, so the two agree within a
// tolerance that grows with the depth (filters/hbf_mxu.py).
//
// What bounds them on the H100: device-memory bytes by the roofline (xs
// read once, y written once: about 21 us at c = 512, t = 32768); the
// tensor-core work (3 passes over K-wide bands, about 6 GFLOP at c = 512)
// is a few microseconds.  What holds them above it: the halo recomputed a
// range (half again the stage-0 work at the default ranges), the chunk's
// serial stages (the late stages have one or two tiles a chunk, the other
// warps wait at the barrier), the loads of xs not overlapped with the
// sums of the same block, and the epilogue's conversions and stores (most
// of K23's time: 16 output rows a row in).  Shared memory is the A tiles
// and the rings: 108 KB for K22 "split3" at chunk 256 (two blocks an SM),
// 150 KB for K23 at chunk 64.  A launch above 227 KB is refused, leaving
// no CUDA error pending.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include <cuda_pipeline.h>

#include "hbf_mma.cuh"
#include "hbf_tile.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr int kD = idsp::tile::kMaxDepth;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int floor_div2(int v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

// --- "split3" and "default": the band product on the tensor cores ----------

constexpr int kTileLanes = 32;  // lanes of a block's tile (4 n8 MMA tiles)
constexpr int kMmaWarps = 8;    // warps of a block
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxBand = 4 * idsp::tile::kMaxTaps;  // >= 4m-1 band entries

// Each stage's band in stage order as bf16 bits, its hi and lo parts (a
// kernel parameter, split on the host): K22's row is 4m-1 entries (the m
// taps on even entries, the unit center at 2m-1, the mirrored taps), K23's
// FIR row 2m.
struct Band {
  int m[kD];
  uint16_t hi[kD][kMaxBand];
  uint16_t lo[kD][kMaxBand];
};

__host__ __device__ inline int ceil16(int v) { return (v + 15) & ~15; }

// A stage's geometry and the block's shared memory.  A tile is 16 output
// rows (K22) or row pairs (K23) of a stage, tile k the rows [16k, 16k+16)
// counted from row 0 of the call; its window is the K input rows [W(k),
// W(k) + K), W(k) = (k+1)*kIn - K, kIn = 32 (K22) or 16 (K23) input rows a
// tile, K the span (4m+29 or 2m+15 rows) rounded up to 16 with the pad in
// front, so that A[r][kk] = band[kk - step*r - pad] (step 2 or 1) is one
// (16 x K) Toeplitz tile for every tile of the stage.  Shared memory holds
// each stage's A tile (hi, then lo for NP = 3; rows K+8 bf16 apart, which
// keeps ldmatrix's eight 16-byte rows on distinct banks) and each stage's
// input rows in a ring of carry + chunk rows, a row the tile's 32 lanes of
// hi then of lo bf16 (64 or 128 bytes), its 16-byte chunks swizzled by the
// row (ring_at) for the same reason.  Stage 0's rows are 128 bytes at
// either precision: a row of 32 f32 lanes lands there from xs (cp.async)
// and is split in place.
template <int D, int NP>
struct MmaLayout {
  static constexpr int kRow = NP == 3 ? 64 : 32;  // bf16 elements a ring row
  int K[D], pad[D], carry[D], rows[D], a_off[D], b_off[D];
  int elems;  // bf16 elements in all

  // bf16 elements a row of stage d's ring
  __host__ __device__ static constexpr int width(int d) {
    return d == 0 ? 64 : kRow;
  }

  __host__ __device__ MmaLayout(const int* m, int tc, bool dec) : elems(0) {
    for (int d = 0; d < D; ++d) {
      const int span = dec ? 4 * m[d] + 29 : 2 * m[d] + 15;
      K[d] = ceil16(span);
      pad[d] = K[d] - span;
      carry[d] = K[d] - (dec ? 32 : 16);
      rows[d] = carry[d] + (dec ? tc >> d : tc << d);
      a_off[d] = elems;
      elems += (NP == 3 ? 2 : 1) * 16 * (K[d] + 8);
    }
    for (int d = 0; d < D; ++d) {
      b_off[d] = elems;
      elems += rows[d] * width(d);
    }
  }
};

// The element of ring row r, column col (lanes 0-31 hi, 32-63 lo) in rows
// of w bf16: the row's 16-byte chunk col/8 moves to chunk ^ (r mod 8) in a
// 128-byte row, or, in a 64-byte row (two a bank line), to chunk ^ (r/2
// mod 4), so that eight consecutive rows of one column chunk fall on
// distinct banks.
__device__ __forceinline__ int ring_at(int r, int col, int w) {
  const int sw = w == 64 ? r & 7 : (r >> 1) & 3;
  return r * w + (((col >> 3) ^ sw) << 3) + (col & 7);
}

// The carried input row u < 0 of stage d (packed tails at row toff): K22's
// window row w = 4m-2+u holds the odd rows and the even rows from 2m
// (K7's packing, hbf_cascade.cu), K23's the last 2m-1 rows; rows before the
// state are 0.
template <bool Dec>
__device__ __forceinline__ float carried(const float* tails, int toff, int m,
                                         int c, int lane, int u) {
  if (Dec) {
    const int w = 4 * m - 2 + u;
    if (w < 0) return 0.f;
    if (w & 1) return tails[static_cast<size_t>(toff + (w >> 1)) * c + lane];
    if (w >= 2 * m)
      return tails[static_cast<size_t>(toff + 2 * m - 1 + ((w - 2 * m) >> 1)) *
                       c + lane];
    return 0.f;
  }
  const int w = 2 * m - 1 + u;
  return w < 0 ? 0.f : tails[static_cast<size_t>(toff + w) * c + lane];
}

// The packed tail row of stage input row u (n rows this call), or -1 if u
// is not kept.
template <bool Dec>
__device__ __forceinline__ int tail_row(int m, int n, int u) {
  if (Dec) {
    const int w = u - (n - (4 * m - 2));
    if (w < 0 || w >= 4 * m - 2) return -1;
    if (w & 1) return w >> 1;
    return w >= 2 * m ? 2 * m - 1 + ((w - 2 * m) >> 1) : -1;
  }
  const int w = u - (n - (2 * m - 1));
  return w < 0 || w >= 2 * m - 1 ? -1 : w;
}

// Calls f(k) for this warp's tiles of [ta, tb): runs of up to ceil(sub/16)
// consecutive tiles, cut to the warp's share, dealt round robin.
template <class F>
__device__ __forceinline__ void for_tiles(int ta, int tb, int sub, F f) {
  const int n = tb - ta;
  if (n <= 0) return;
  const int warp = threadIdx.x >> 5;
  const int share = (n + kMmaWarps - 1) / kMmaWarps;
  const int per = imax(1, imin((sub + 15) / 16, share));
  for (int k0 = ta + warp * per; k0 < tb; k0 += kMmaWarps * per) {
    const int k1 = imin(k0 + per, tb);
    for (int k = k0; k < k1; ++k) f(k);
  }
}

template <int D, int NP, bool Dec>
__device__ __forceinline__ void mma_body(const float* __restrict__ xs,
                                         const float* __restrict__ tails_in,
                                         float* __restrict__ tails_out,
                                         float* __restrict__ y, int t, int c,
                                         int tc, int sub, int seg,
                                         const Band& band) {
  namespace mm = idsp::mma;
  extern __shared__ __align__(16) uint16_t msm[];
  using Lay = MmaLayout<D, NP>;
  constexpr int kRow = Lay::kRow;
  constexpr int kIn = Dec ? 32 : 16;  // input rows a tile
  constexpr int kStep = Dec ? 2 : 1;  // band shift a tile row
  const Lay L(band.m, tc, Dec);
  const int tid = threadIdx.x, ln = tid & 31;
  const int lane0 = blockIdx.x * kTileLanes;
  const bool last_range = blockIdx.y + 1 == gridDim.y;
  const bool even_c = (c & 1) == 0;

  int toff[D], n_in[D];  // packed tail offsets; input rows of each stage
  {
    int r = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      toff[d] = r;
      r += Dec ? 3 * band.m[d] - 2 : 2 * band.m[d] - 1;
      n_in[d] = Dec ? t >> d : t << d;
    }
  }
  // stage 0's input row u at lane (0 past the block of time or c)
  auto x0 = [&](int u, int lane) -> float {
    if (lane >= c) return 0.f;
    if (u < 0) return carried<Dec>(tails_in, 0, band.m[0], c, lane, u);
    return u < t ? __ldg(xs + static_cast<size_t>(u) * c + lane) : 0.f;
  };

  // the range and each stage's first output row (pair) it needs, a
  // multiple of 16: what the next stage's first tile reads with a nonzero
  // weight; the walk starts at the chunk boundary p0 (stage-0 input rows)
  // at or before all of them
  const int n_rows = Dec ? t >> D : t;
  const int s = blockIdx.y * seg, e = imin(s + seg, n_rows);
  int a[D];
  a[D - 1] = Dec ? s : s << (D - 1);
#pragma unroll
  for (int d = D - 2; d >= 0; --d) {
    const int m = band.m[d + 1];
    const int first =
        Dec ? 2 * a[d + 1] - 4 * m + 3 : floor_div2(a[d + 1] - 2 * m + 1);
    a[d] = first <= 0 ? 0 : first & ~15;
  }
  int p0 = Dec ? a[0] << 1 : a[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    p0 = imin(p0, Dec ? a[d] << (d + 1) : a[d] >> d);
  p0 &= Dec ? ~((16 << D) - 1) : ~15;
  const int end = Dec ? e << D : e;
  // ring row of stage d's input row u: (u - ubase[d]) mod rows[d]
  int ubase[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    ubase[d] = (Dec ? p0 >> d : p0 << d) - L.carry[d];

  // shared memory to zeros (rows no stage wrote are read with weight 0),
  // then the A tiles
  for (int i = tid; i < L.elems / 8; i += kMmaThreads)
    reinterpret_cast<uint4*>(msm)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m = band.m[d], K = L.K[d], as = K + 8;
    const int len = Dec ? 4 * m - 1 : 2 * m;
    uint16_t* A = msm + L.a_off[d];
    for (int i = tid; i < 16 * K; i += kMmaThreads) {
      const int r = i / K, kk = i - r * K, v = kk - kStep * r - L.pad[d];
      if (v < 0 || v >= len) continue;
      A[r * as + kk] = band.hi[d][v];
      if (NP == 3) A[16 * as + r * as + kk] = band.lo[d][v];
    }
  }
  // ring row of stage d's input row u
  auto ring_row = [&](int d, int u) { return (u - ubase[d]) % L.rows[d]; };
  // stage d's input row u, lane col of the tile, split into ring row rr
  auto put_row = [&](int d, int rr, int col, float v) {
    uint16_t h, l;
    mm::split(v, h, l);
    uint16_t* buf = msm + L.b_off[d];
    buf[ring_at(rr, col, Lay::width(d))] = h;
    if (NP == 3) buf[ring_at(rr, 32 + col, Lay::width(d))] = l;
  };
  // stage 0's input rows [r0, r1) into its ring, split on the way
  auto fill = [&](int r0, int r1) {
    for (int i = tid; i < (r1 - r0) * kTileLanes; i += kMmaThreads) {
      const int u = r0 + (i >> 5), col = i & 31;
      put_row(0, ring_row(0, u), col, x0(u, lane0 + col));
    }
  };
  // whole 16-byte lane groups of xs rows inside the block of time: the
  // chunks' rows come in by cp.async, raw f32 in their 128-byte ring rows,
  // and are split in place (prefetch, then split_rows)
  const bool vec = (c & 3) == 0 && lane0 + kTileLanes <= c;
  uint16_t* ring0 = msm + L.b_off[0];
  auto prefetch = [&](int r0, int r1) {
    for (int i = tid; i < (r1 - r0) * 8; i += kMmaThreads) {
      const int u = r0 + (i >> 3), j = i & 7;
      __pipeline_memcpy_async(
          ring0 + ring_row(0, u) * 64 + 8 * j,
          xs + static_cast<size_t>(u) * c + lane0 + 4 * j, 16);
    }
    __pipeline_commit();
  };
  // a warp splits 4 rows at a time: its lanes read the raw rows, then,
  // after the warp's sync, write them back as hi and lo planes
  auto split_rows = [&](int r0, int r1) {
    const int warp = tid >> 5;
    for (int u0 = r0 + 4 * warp; u0 < r1; u0 += 4 * kMmaWarps) {
      const int u = u0 + (ln >> 3), j = ln & 7;
      const int rr = u < r1 ? ring_row(0, u) : 0;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < r1) v = *reinterpret_cast<const float4*>(ring0 + rr * 64 + 8 * j);
      __syncwarp();
      if (u < r1) {
        uint2 h, l;
        mm::split2(v.x, v.y, h.x, l.x);
        mm::split2(v.z, v.w, h.y, l.y);
        *reinterpret_cast<uint2*>(ring0 + ring_at(rr, 4 * j, 64)) = h;
        if (NP == 3)
          *reinterpret_cast<uint2*>(ring0 + ring_at(rr, 32 + 4 * j, 64)) = l;
      }
      __syncwarp();
    }
  };
  // the rows before the walk's first chunk: stage 0's from xs or the
  // carried rows; the others' only from row 0 (carried), else rows the
  // range reads with weight 0
  fill(p0 - L.carry[0], p0);
  if (p0 == 0) {
#pragma unroll
    for (int d = 1; d < D; ++d)
      for (int i = tid; i < L.carry[d] * kTileLanes; i += kMmaThreads) {
        const int r = i >> 5, col = i & 31, lane = lane0 + col;
        put_row(d, r, col,
                lane < c ? carried<Dec>(tails_in, toff[d], band.m[d], c, lane,
                                        r - L.carry[d])
                         : 0.f);
      }
  }
  // the last range writes the new tails: stage 0's rows (copies of xs or
  // of the carried rows) and the carried rows still kept of the others;
  // the epilogues write the rest
  if (last_range) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int m = band.m[d], kept = Dec ? 4 * m - 2 : 2 * m - 1;
      for (int i = tid; i < kept * kTileLanes; i += kMmaThreads) {
        const int lane = lane0 + (i & 31), u = n_in[d] - kept + (i >> 5);
        const int r = tail_row<Dec>(m, n_in[d], u);
        if (lane >= c || r < 0 || (d > 0 && u >= 0)) continue;
        tails_out[static_cast<size_t>(toff[d] + r) * c + lane] =
            d == 0 ? x0(u, lane)
                   : carried<Dec>(tails_in, toff[d], m, c, lane, u);
      }
    }
  }

  int ar, ak, bk, bt;  // this lane's ldmatrix rows
  mm::a_ldm_row(ln, ar, ak);
  mm::b_ldm_row(ln, bk, bt);

  if (vec) prefetch(p0, imin(p0 + tc, end));
  for (int cs = p0; cs < end; cs += tc) {
    const int ce = imin(cs + tc, end);
    if (vec) {
      __pipeline_wait_prior(0);
      __syncthreads();
      split_rows(cs, ce);
    } else {
      fill(cs, ce);
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int K = L.K[d], nk = K >> 4, R = L.rows[d];
      const int lo = imax(Dec ? cs >> (d + 1) : cs << d, a[d]);
      const int hi = Dec ? ce >> (d + 1) : ce << d;
      const uint16_t* a_row = msm + L.a_off[d] + ar * (K + 8) + ak;
      const uint16_t* buf = msm + L.b_off[d];
      const int w = Lay::width(d);  // bf16 elements a row of this ring
      for_tiles(lo >> 4, (hi + 15) >> 4, sub, [&](int k) {
        const int w0 = (k + 1) * kIn - K;  // the window's first input row
        const int pb = ring_row(d, w0 + bk);
        // hh, and for "split3" hl + lh in one more accumulator
        float acc[NP == 3 ? 2 : 1][4][4];
#pragma unroll
        for (int p = 0; p < (NP == 3 ? 2 : 1); ++p)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
          uint32_t ah[4], al[4], bh[4][2], bl[4][2], r4[4];
          mm::ldmatrix_x4(ah, a_row + 16 * ks);
          if (NP == 3) mm::ldmatrix_x4(al, a_row + 16 * (K + 8) + 16 * ks);
          int pr = pb + 16 * ks;
          if (pr >= R) pr -= R;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            mm::ldmatrix_x4_trans(r4, buf + ring_at(pr, 16 * half + 8 * bt, w));
            bh[2 * half][0] = r4[0];
            bh[2 * half][1] = r4[1];
            bh[2 * half + 1][0] = r4[2];
            bh[2 * half + 1][1] = r4[3];
            if (NP == 3) {
              mm::ldmatrix_x4_trans(
                  r4, buf + ring_at(pr, 32 + 16 * half + 8 * bt, w));
              bl[2 * half][0] = r4[0];
              bl[2 * half][1] = r4[1];
              bl[2 * half + 1][0] = r4[2];
              bl[2 * half + 1][1] = r4[3];
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mm::mma_bf16(acc[0][nt], ah, bh[nt][0], bh[nt][1]);
            if (NP == 3) {
              mm::mma_bf16(acc[NP == 3 ? 1 : 0][nt], ah, bl[nt][0],
                           bl[nt][1]);
              mm::mma_bf16(acc[NP == 3 ? 1 : 0][nt], al, bh[nt][0],
                           bh[nt][1]);
            }
          }
        }

        // epilogue: this lane's rows g and g+8, lanes 2q and 2q+1 of each
        // n8 tile, hh + (hl + lh)
        const bool last = d + 1 == D;
        const int dn = last ? d : d + 1;  // the next stage
        const int nm = band.m[dn];
        // ring row of the next stage's input row of this tile's row 0
        const int np0 = ring_row(dn, Dec ? 16 * k : 32 * k);
        auto ring = [&](int off) {
          const int p = np0 + off;
          return p >= L.rows[dn] ? p - L.rows[dn] : p;
        };
        auto put = [&](int u, int prow, int col, float v0, float v1) {
          uint32_t h, l;
          mm::split2(v0, v1, h, l);
          uint16_t* nbuf = msm + L.b_off[dn];
          *reinterpret_cast<uint32_t*>(nbuf + ring_at(prow, col, kRow)) = h;
          if (NP == 3)
            *reinterpret_cast<uint32_t*>(nbuf + ring_at(prow, 32 + col, kRow)) =
                l;
          if (!last_range) return;
          const int r = tail_row<Dec>(nm, n_in[dn], u);
          if (r < 0) return;
          const int lane = lane0 + col;
          float* tl = tails_out + static_cast<size_t>(toff[dn] + r) * c;
          if (lane < c) tl[lane] = v0;
          if (lane + 1 < c) tl[lane + 1] = v1;
        };
        auto store_y = [&](int row, int col, float v0, float v1) {
          const int lane = lane0 + col;
          float* dst = y + static_cast<size_t>(row) * c + lane;
          if (even_c && lane + 1 < c) {  // lane is even: 8-byte aligned
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (lane < c) dst[0] = v0;
            if (lane + 1 < c) dst[1] = v1;
          }
        };
        // K23: the center rows come from this stage's input row j-m+1
        const int m = band.m[d];
        const int cp0 = Dec ? 0 : ring_row(d, 16 * k - m + 1);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float v[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              v[i] = NP == 3 ? __fadd_rn(acc[0][nt][2 * hf + i],
                                         acc[NP == 3 ? 1 : 0][nt][2 * hf + i])
                             : acc[0][nt][2 * hf + i];
            int r, col;  // lanes col, col+1 of the tile's row r
            mm::c_index(ln, 2 * hf, r, col);
            col += nt * 8;
            const int j = 16 * k + r;  // the tile's output row (pair)
            if (Dec) {
              if (last) {
                if (j < (t >> D)) store_y(j, col, v[0], v[1]);
              } else {
                put(j, ring(r), col, v[0], v[1]);
              }
              continue;
            }
            int p = cp0 + r;
            if (p >= R) p -= R;
            const uint32_t hw =
                *reinterpret_cast<const uint32_t*>(buf + ring_at(p, col, w));
            const uint32_t lw =
                NP == 3 ? *reinterpret_cast<const uint32_t*>(
                              buf + ring_at(p, 32 + col, w))
                        : 0u;
            float cen[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float h = __uint_as_float(i ? hw & 0xffff0000u : hw << 16);
              cen[i] = NP == 3 ? __fadd_rn(h, __uint_as_float(
                                                  i ? lw & 0xffff0000u
                                                    : lw << 16))
                               : h;
            }
            if (last) {
              if (j < (t << (D - 1))) {
                store_y(2 * j, col, v[0], v[1]);
                store_y(2 * j + 1, col, cen[0], cen[1]);
              }
            } else {
              put(2 * j, ring(2 * r), col, v[0], v[1]);
              put(2 * j + 1, ring(2 * r + 1), col, cen[0], cen[1]);
            }
          }
        }
      });
      __syncthreads();
      // the next chunk's xs rows come in behind the later stages: they
      // overwrite ring rows that stage 0 has finished with
      if (d == 0 && vec && ce < end) prefetch(ce, imin(ce + tc, end));
    }
  }
}

template <int D, int NP>
__global__ void __launch_bounds__(kMmaThreads, 2) hbf_dec_mma_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int sub, int seg, Band band) {
  mma_body<D, NP, true>(xs, tails_in, tails_out, y, t, c, tc, sub, seg, band);
}

template <int D, int NP>
__global__ void __launch_bounds__(kMmaThreads, 2) hbf_int_mma_kernel(
    const float* __restrict__ xs, const float* __restrict__ tails_in,
    float* __restrict__ tails_out, float* __restrict__ y, int t, int c,
    int tc, int sub, int seg, Band band) {
  mma_body<D, NP, false>(xs, tails_in, tails_out, y, t, c, tc, sub, seg, band);
}

// bf16 bits of a finite f32, rounded to nearest even (host side)
inline uint16_t bf16_bits(float v) {
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

inline float bf16_value(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
  float v;
  memcpy(&v, &u, sizeof v);
  return v;
}

// Each stage's band from its one-sided taps, split into bf16 hi and lo.
bool band_from_host(Band& b, int depth, const int* ms, const float* taps,
                    bool dec) {
  if (depth < 1 || depth > kD) return false;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    const int m = ms[d];
    if (m < 1 || m > idsp::tile::kMaxTaps) return false;
    b.m[d] = m;
    const float* tv = taps + off;
    const int len = dec ? 4 * m - 1 : 2 * m;
    for (int v = 0; v < len; ++v) {
      float w;
      if (dec)
        w = v == 2 * m - 1 ? 1.f
            : v & 1        ? 0.f
            : v < 2 * m    ? tv[v / 2]
                           : tv[2 * m - 1 - v / 2];
      else
        w = v < m ? tv[v] : tv[2 * m - 1 - v];
      b.hi[d][v] = bf16_bits(w);
      b.lo[d][v] = bf16_bits(w - bf16_value(b.hi[d][v]));
    }
    off += m;
  }
  return true;
}

template <int D, int NP>
int launch_mma(bool dec, const void* xs, const void* tails_in,
               void* tails_out, void* y, int t, int c, int tc, int sub,
               int seg, const Band& band, void* stream) {
  using Fn = void (*)(const float*, const float*, float*, float*, int, int,
                      int, int, int, Band);
  const Fn kernel = dec ? hbf_dec_mma_kernel<D, NP> : hbf_int_mma_kernel<D, NP>;
  const int rows = dec ? t >> D : t;  // the rows the ranges cut
  const int ranges = (rows + seg - 1) / seg;
  if (ranges > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(MmaLayout<D, NP>(band.m, tc, dec)
                                              .elems) * sizeof(uint16_t);
  // a refused size leaves no CUDA error pending
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kTileLanes - 1) / kTileLanes, ranges);
  kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(tails_in),
      static_cast<float*>(tails_out), static_cast<float*>(y), t, c, tc, sub,
      seg, band);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the MMA kernel that fit an SM at chunk tc, or an error < 0.
template <int D, int NP>
int mma_occupancy(bool dec, const int* m, int tc) {
  using Fn = void (*)(const float*, const float*, float*, float*, int, int,
                      int, int, int, Band);
  const Fn kernel = dec ? hbf_dec_mma_kernel<D, NP> : hbf_int_mma_kernel<D, NP>;
  const size_t smem =
      static_cast<size_t>(MmaLayout<D, NP>(m, tc, dec).elems) *
      sizeof(uint16_t);
  if (smem > static_cast<size_t>(kMaxSmem)) return 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kMmaThreads, smem) !=
      cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  return blocks;
}

template <int NP>
int launch_mma(bool dec, int depth, const void* xs, const void* tails_in,
               void* tails_out, void* y, int t, int c, int tc, int sub,
               int seg, const Band& band, void* stream) {
  switch (depth) {
    case 1:
      return launch_mma<1, NP>(dec, xs, tails_in, tails_out, y, t, c, tc,
                               sub, seg, band, stream);
    case 2:
      return launch_mma<2, NP>(dec, xs, tails_in, tails_out, y, t, c, tc,
                               sub, seg, band, stream);
    case 3:
      return launch_mma<3, NP>(dec, xs, tails_in, tails_out, y, t, c, tc,
                               sub, seg, band, stream);
    default:
      return launch_mma<4, NP>(dec, xs, tails_in, tails_out, y, t, c, tc,
                               sub, seg, band, stream);
  }
}

int launch_mma(bool dec, const void* xs, const void* tails_in,
               void* tails_out, void* y, int t, int c, int tc, int sub,
               int seg, int passes, int depth, const int* ms,
               const float* taps, void* stream) {
  Band band{};
  if (!band_from_host(band, depth, ms, taps, dec) || t <= 0 || c < 1 ||
      sub < 1 || seg < 16 || seg % 16 != 0 || (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = dec ? 16 << depth : 16;  // the chunk's alignment
  if (tc < q || tc % q != 0 || (dec && t % (1 << depth) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return passes == 3 ? launch_mma<3>(dec, depth, xs, tails_in, tails_out, y,
                                     t, c, tc, sub, seg, band, stream)
                     : launch_mma<1>(dec, depth, xs, tails_in, tails_out, y,
                                     t, c, tc, sub, seg, band, stream);
}

}  // namespace

// Blocks of K22's (dec 1) or K23's MMA kernel that fit an SM at chunk tc
// (as idsp_hbf_dec_mma / idsp_hbf_int_mma take it), 0 if a block does not
// fit, or minus a CUDA error.
extern "C" int idsp_hbf_mma_occupancy(int dec, int depth, const int* ms,
                                      int tc, int passes) {
  if (depth < 1 || depth > kD || tc < 1 || (passes != 1 && passes != 3))
    return -static_cast<int>(cudaErrorInvalidValue);
  int m[kD] = {};
  for (int d = 0; d < depth; ++d) {
    if (ms[d] < 1 || ms[d] > idsp::tile::kMaxTaps)
      return -static_cast<int>(cudaErrorInvalidValue);
    m[d] = ms[d];
  }
  switch (depth * 4 + passes) {
    case 5: return mma_occupancy<1, 1>(dec, m, tc);
    case 7: return mma_occupancy<1, 3>(dec, m, tc);
    case 9: return mma_occupancy<2, 1>(dec, m, tc);
    case 11: return mma_occupancy<2, 3>(dec, m, tc);
    case 13: return mma_occupancy<3, 1>(dec, m, tc);
    case 15: return mma_occupancy<3, 3>(dec, m, tc);
    case 17: return mma_occupancy<4, 1>(dec, m, tc);
    default: return mma_occupancy<4, 3>(dec, m, tc);
  }
}

// K22 "split3" (passes 3) and "default" (passes 1): xs (t, c) f32 -> y
// (t >> depth, c) f32, tails as idsp_hbf_dec_cascade (hbf_cascade.cu).
// tc full-rate rows a chunk, a positive multiple of 16 << depth; seg
// last-stage output rows a range, a positive multiple of 16.
extern "C" int idsp_hbf_dec_mma(const void* xs, const void* tails_in,
                                void* tails_out, void* y, int t, int c,
                                int tc, int sub, int seg, int passes,
                                int depth, const int* ms, const float* taps,
                                void* stream) {
  return launch_mma(true, xs, tails_in, tails_out, y, t, c, tc, sub, seg,
                    passes, depth, ms, taps, stream);
}

// K23 "split3" and "default": xs (t, c) f32 -> y (t << depth, c) f32,
// tails as idsp_hbf_int_cascade (hbf_cascade.cu).  tc and seg low-rate input rows, positive
// multiples of 16.
extern "C" int idsp_hbf_int_mma(const void* xs, const void* tails_in,
                                void* tails_out, void* y, int t, int c,
                                int tc, int sub, int seg, int passes,
                                int depth, const int* ms, const float* taps,
                                void* stream) {
  return launch_mma(false, xs, tails_in, tails_out, y, t, c, tc, sub, seg,
                    passes, depth, ms, taps, stream);
}
