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
// for its `clamp=`).  On the TPU the grid walked time chunks in order and
// kept the state and tails in VMEM scratch between steps; here a block
// owns a tile of lanes for the whole block of time.
//
// What bounds them on the H100: the DF1 recurrence, serial in time in
// each lane.  Its loop-carried chain is one 64-bit multiply-add and the
// shift (df1.cuh `output_y1_last`; with Clamp an add, a max and a min
// more), the rest of a row's products off the chain; as compiled, the
// add is a carry pair and the warp takes ~40 cycles a row (K20, K21).
// The device memory traffic is small (K2 reads 4 B per full-rate sample
// and lane and writes 4 B per 2^depth; K3 reads x (t,) and the factor
// tables), and the FIR stages (three f32 operations a tap and output
// row) are parallel across rows, but with a barrier a stage their warps
// set K2's pace at the chain's taps (PERF.md §6).
//
// What the design does (the host's plan: filters/ddc_cuda.py
// `launch_plan`, which the entry point checks):
//
// * A block is one tile of kLanes lanes and warps with roles (a tile of
//   16 lanes, each warp's upper half idle, measured no faster: PERF.md
//   §6).  Warp 0 runs the DF1 of every lane of the tile over the whole
//   block of time, its state in registers, reading its input rows from
//   shared memory only and touching device memory only for the state at
//   each end (df1_ring.cuh's DF1 warp, which K14 and K15 run too; its
//   output ring here is stage 0's buffer).  The other warps on its
//   scheduler (warp % 4 == 0) exit at once, so that no warp competes with
//   its issue.  Of the rest, in order, `producers` warps feed it (K2:
//   cp.async of the xs rows; K3: the fast-LO mix and its rounding,
//   fastlo.cuh) and the others are the FIR warps.
// * Chunks of `chunk` rows pass through two rings of `depth` slots, each
//   slot with a full and an empty mbarrier (chunk q uses slot q % depth
//   at parity (q / depth) & 1, hopper.cuh `Cursor`): the producers' int32
//   input ring, and stage 0's f32 buffer, whose slots lie one after
//   another behind stage 0's 4m-3 carried rows, so that a chunk's stage-0
//   input is contiguous with the rows before it: the previous slot's or,
//   at slot 0, the carried rows, which the FIR warps move there from the
//   last slot.  The FIR warps release a slot after stage 0 of the next
//   chunk, which reads the slot's last rows.
// * The FIR warps take each chunk through the stages with hbf_tile.cuh's
//   `dec_stage` (K7's stage code), output rows dealt round robin in
//   groups, a named barrier between stages (the DF1 and producer warps
//   never wait on it); stages d >= 1 in K7's layout (4m-3 carried rows in
//   front of the chunk's rows, moved to the front after each chunk); the
//   last stage writes y rows straight from registers, a 128-byte row a
//   warp.
//
// Numerics: the DF1 is df1.cuh's exact int64 recurrence, the mix
// fastlo.cuh's, the stages hbf_tile.cuh's single-rounding f32 sums in the
// plain version's order: the kernel equals the plain versions bit for
// bit, and neither its chunk nor its ring depth nor its lane tile changes
// a value.  K3's fine table has the caller's length tc: row r mixes with
// coarse[r / tc] and fine[r % tc], whatever the kernel's chunk.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"
#include "fastlo.cuh"
#include "hbf_tile.cuh"
#include "hopper.cuh"

namespace {

using idsp::sm90::bar_sync;
using idsp::sm90::cp_async16;
using idsp::sm90::cp_async4;
using idsp::sm90::cp_async_arrive;
using idsp::sm90::cp_async_wait_all;
using idsp::sm90::Cursor;
using idsp::sm90::mbar_arrive;
using idsp::sm90::mbar_wait;
using idsp::sm90::smem_addr;
using idsp::ring::Rings;
using idsp::tile::kLanes;
using idsp::tile::Taps;
static_assert(kLanes == idsp::ring::kLanes, "the DF1 warp's lane tile");

constexpr int kMaxSmem = 232448;  // bytes a block may have
constexpr int kMaxWarps = idsp::ring::kMaxWarps;  // warps of a block
constexpr int kMinFir = 4;        // FIR warps of a block, at least
constexpr int kMaxProducers = 4;
constexpr uint32_t kFirBarrier = 1;  // the FIR warps' named barrier

// A launch's arguments (a kernel parameter).
struct Args {
  const int32_t* xs;  // K2: (t, c2) DF1 input
  const int32_t* x;   // K3: (t,) wideband input
  const float2 *coarse, *fine;  // K3: (ca, sa) (t/tc, c), (cb, sb) (tc, c)
  const int32_t *sx, *sy;
  int32_t *sx_out, *sy_out;
  const float* tails_in;
  float* tails_out;
  float* y;
  int t, c2, tc, warps, producers, chunk, ring, vec;
  idsp::Df1Coefs k;
  idsp::Df1Clamp cl;
};

// FIR warps of a block: every warp not on the DF1 warp's scheduler
// (warp % 4 != 0), less the producers.
__host__ __device__ inline int fir_warps(int warps, int producers) {
  return warps - warps / 4 - producers;
}

// The FIR buffers in shared memory, in rows of kLanes floats: stage 0 its
// 4m-3 carried rows then `depth` slots of `chunk` rows; stage d >= 1 its
// 4m-3 carried rows then chunk >> d rows.  The depth is a template
// argument, so that these per-stage numbers live in registers.
template <int D>
struct Layout {
  int off[D], carry[D];
  int rows;

  __host__ __device__ Layout(const Taps& p, int chunk, int depth) : rows(0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      carry[d] = 4 * p.m[d] - 3;
      off[d] = rows;
      rows += carry[d] + (d == 0 ? depth * chunk : chunk >> d);
    }
  }
};

// Dynamic shared memory: the rings' mbarriers (32 bytes a slot), the
// input ring (depth slots of chunk rows of kLanes int32), the FIR buffers
// (`rows` rows of kLanes floats).
__host__ __device__ inline size_t smem_bytes(int rows, int chunk,
                                             int depth) {
  return 32 * static_cast<size_t>(depth) +
         (static_cast<size_t>(depth) * chunk + rows) * kLanes * 4;
}

// The FIR warps as a hbf_tile.cuh team: rank of count, a named barrier.
struct FirTeam {
  static constexpr int kMin = kMinFir;
  int rank, count;
  __device__ __forceinline__ int id() const { return rank; }
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ void sync() const {
    bar_sync(kFirBarrier, count * kLanes);
  }
};

// K2's producer: the chunk's xs rows into the input ring through cp.async,
// each lane's copies arriving on the slot's full barrier when they land:
// 16 bytes a thread (8 threads a row, 4 rows a warp) where a.vec, else 4
// bytes (its lane, every row).
__device__ __forceinline__ void load(const Args& a, const Rings& R, int lid,
                                     int lane, bool live) {
  const size_t c = static_cast<size_t>(a.c2);
  const int l4 = 4 * (lid % 8), lane4 = lane - lid + l4;
  Cursor u;
  for (int r0 = 0; r0 < a.t; r0 += a.chunk, u.next(a.ring)) {
    const int rows = min(a.chunk, a.t - r0);
    mbar_wait(R.empty_in(u.k), u.ph ^ 1);
    const uint32_t slot = smem_addr(R.in_slot(u.k));
    const int32_t* src = a.xs + static_cast<size_t>(r0) * c;
    if (a.vec) {
      if (lane4 < a.c2)
        for (int r = lid / 8; r < rows; r += 4)
          cp_async16(slot + 4 * (r * kLanes + l4), src + r * c + lane4);
    } else if (live) {
      for (int r = 0; r < rows; ++r)
        cp_async4(slot + 4 * (r * kLanes + lid), src + r * c + lane);
    }
    cp_async_arrive(R.full_in(u.k));
  }
  cp_async_wait_all();
}

// The FIR warps: carried rows in, every chunk through the stages (y out
// from the last), carried rows out.  col is this lane's column of the FIR
// buffers.
template <int D>
__device__ __forceinline__ void fir(const Args& a, const Taps& p,
                                    const Rings& R, float* col,
                                    const FirTeam& team, int lane,
                                    bool live) {
  const Layout<D> L(p, a.chunk, a.ring);
  const int K = a.chunk;
  const size_t c = static_cast<size_t>(a.c2);
  int toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m = p.m[d];
    for (int r = team.id(); r < L.carry[d]; r += team.n())
      col[(L.off[d] + r) * kLanes] =
          live ? idsp::tile::dec_tail(a.tails_in, toff, m, a.c2, lane, r)
               : 0.f;
    toff += 3 * m - 2;
  }

  // stage d's input row v sits at row sd(d, k, cs) + v of the column:
  // stage 0 in slot k, stages d >= 1 behind their carried rows
  auto sd = [&](int d, int k, int cs) {
    return d == 0 ? L.off[0] + L.carry[0] + k * K - cs
                  : L.off[d] + L.carry[d] - (cs >> d);
  };
  Cursor u;
  int k_last = 0, cs_last = 0;
  for (int cs = 0; cs < a.t; cs += K, u.next(a.ring)) {
    const int ce = min(cs + K, a.t);
    const bool more = ce < a.t;
    mbar_wait(R.full_out(u.k), u.ph);
    team.sync();  // the last chunk's moves (and the carried rows) landed
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int si = sd(d, u.k, cs);
      auto in = [&](int v) { return col[(si + v) * kLanes]; };
      const int lo = cs >> (d + 1), hi = ce >> (d + 1);
      if (d + 1 < D) {
        const int so = sd(d + 1, u.k, cs);
        idsp::tile::dec_stage(
            lo, hi, p.m[d], p.taps[d], in,
            [&](int j, float v) { col[(so + j) * kLanes] = v; }, team);
      } else {
        idsp::tile::dec_stage(
            lo, hi, p.m[d], p.taps[d], in,
            [&](int j, float v) {
              if (live) a.y[static_cast<size_t>(j) * c + lane] = v;
            },
            team);
      }
      team.sync();
      if (d == 0) {
        // stage 0 of this chunk read the previous slot's last rows
        if (u.k > 0) mbar_arrive(R.empty_out(u.k - 1));
        if (more && u.k == a.ring - 1) {
          idsp::tile::move_front(col + L.off[0] * kLanes, L.carry[0],
                                 a.ring * K, false, team);
          mbar_arrive(R.empty_out(u.k));
        }
      } else if (more) {
        idsp::tile::move_front(col + L.off[d] * kLanes, L.carry[d],
                               (ce - cs) >> d, false, team);
      }
    }
    k_last = u.k;
    cs_last = cs;
  }

  // new tails: the last 4m-3 input rows of each stage, packed
  team.sync();
  if (!live) return;
  toff = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m = p.m[d];
    const int sl = sd(d, k_last, cs_last) + (a.t >> d) - L.carry[d];
    for (int r = team.id(); r < 3 * m - 2; r += team.n())
      a.tails_out[static_cast<size_t>(toff + r) * c + lane] =
          col[(sl + idsp::tile::dec_packed(m, r)) * kLanes];
    toff += 3 * m - 2;
  }
}

template <int D, bool FastLo, bool Clamp>
__global__ void __launch_bounds__(kLanes* kMaxWarps)
    ddc_cascade_kernel(const __grid_constant__ Args a,
                       const __grid_constant__ Taps p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kLanes, lid = threadIdx.x % kLanes;
  const int lane = blockIdx.x * kLanes + lid;
  const bool live = lane < a.c2;  // dead lanes still reach every barrier
  const int nfir = fir_warps(a.warps, a.producers);
  const Rings R{smem_addr(smem),
                reinterpret_cast<int32_t*>(smem + 32 * a.ring), a.chunk};
  float* col = reinterpret_cast<float*>(R.in_slot(a.ring)) + lid;
  idsp::ring::init_rings(R, a.ring, a.producers, nfir);
  __syncthreads();
  if (warp == 0) {
    const idsp::ring::Df1Ring d{a.t,      a.chunk,  a.ring, a.sx, a.sy,
                                a.sx_out, a.sy_out, a.k,    a.cl};
    idsp::ring::df1_warp<Clamp>(d, R, col + (4 * p.m[0] - 3) * kLanes, lid,
                                lane, live);
    return;
  }
  if (warp % 4 == 0) return;  // the DF1 warp's scheduler stays quiet
  const int v = warp - warp / 4 - 1;  // index among the other warps
  if (v < a.producers) {
    if constexpr (FastLo) {
      // K3's producer: the fast-LO mix of its rows (I lanes [0, c), Q
      // lanes [c, 2c))
      const int c = a.c2 / 2;
      const bool is_q = lane >= c;
      idsp::fastlo_mix_rows({a.x, a.coarse, a.fine, c, a.tc}, a.t, a.chunk,
                            a.ring, R, a.producers, v, lid,
                            is_q ? lane - c : lane, is_q, live);
    } else {
      load(a, R, lid, lane, live);
    }
    return;
  }
  fir<D>(a, p, R, col, FirTeam{v - a.producers, nfir}, lane, live);
}

using Kernel = void (*)(Args, Taps);

template <int D>
Kernel pick(bool fastlo, bool clamp) {
  return fastlo ? (clamp ? ddc_cascade_kernel<D, true, true>
                         : ddc_cascade_kernel<D, true, false>)
                : (clamp ? ddc_cascade_kernel<D, false, true>
                         : ddc_cascade_kernel<D, false, false>);
}

template <int D>
size_t fir_rows(const Taps& p, int chunk, int depth) {
  return static_cast<size_t>(Layout<D>(p, chunk, depth).rows);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// K2 (K20, K21 at depth 1, 2) when x is null (xs (t, c2) i32 is the DF1
// input); K3 when x (t,) i32 and the factor tables are given: coarse, the
// (ca, sa) pairs (t/tc, c2/2), and fine, the (cb, sb) pairs (tc, c2/2),
// float2 each.  clamp != 0 runs the anti-windup DF1 with
// offset u and bounds lo, hi (K19, and K3's clamp form).  ms (depth,) and
// taps (sum ms,) are host arrays, highest-rate stage first.  y is
// (t >> depth, c2) f32; tails are packed (3m-2) rows per stage.  warps,
// producers, chunk, ring (slots a ring) and smem are the host
// plan's (filters/ddc_cuda.py `launch_plan`); a plan this entry would not
// make (smem not its own sum, or more than a block may have) is refused.
// A refused call launches nothing and leaves no CUDA error pending.
extern "C" int idsp_ddc_cascade(
    const void* xs, const void* x, const void* coarse, const void* fine,
    const void* sx, const void* sy,
    void* sx_out, void* sy_out, const void* tails_in, void* tails_out,
    void* y, int t, int c2, int tc, int f, int b0, int b1, int b2, int a1,
    int a2, int depth, int clamp, int u, int lo, int hi, const int* ms,
    const float* taps, int warps, int producers, int chunk,
    int ring, int smem, void* stream) {
  Taps p{};
  const bool fastlo = x != nullptr;
  if (!idsp::tile::taps_from_host(p, depth, ms, taps) || t < 0 || c2 < 1 ||
      t % (1 << depth) != 0 || f <= 0 || f >= 64 ||
      warps % 4 != 0 || warps < 8 ||
      warps > kMaxWarps || producers < 1 || producers > kMaxProducers ||
      fir_warps(warps, producers) < kMinFir || chunk < 1 ||
      chunk % (1 << depth) != 0 || chunk % producers != 0 ||
      chunk < 4 * p.m[0] - 3 || ring < 2 ||
      (fastlo && (c2 % 2 != 0 || tc < producers || tc % producers != 0 ||
                  t % tc != 0 ||
                  !idsp::fastlo_offsets_ok(t, tc, c2 / 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = depth == 1   ? fir_rows<1>(p, chunk, ring)
                      : depth == 2 ? fir_rows<2>(p, chunk, ring)
                      : depth == 3 ? fir_rows<3>(p, chunk, ring)
                                   : fir_rows<4>(p, chunk, ring);
  const size_t want = smem_bytes(static_cast<int>(rows), chunk, ring);
  if (static_cast<size_t>(smem) != want ||
      want > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = depth == 1   ? pick<1>(fastlo, clamp != 0)
                        : depth == 2 ? pick<2>(fastlo, clamp != 0)
                        : depth == 3 ? pick<3>(fastlo, clamp != 0)
                                     : pick<4>(fastlo, clamp != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // a refused size is also the runtime's last error: take it, or the
  // next launch of any kernel in this library would report it
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.xs = static_cast<const int32_t*>(xs);
  a.x = static_cast<const int32_t*>(x);
  a.coarse = static_cast<const float2*>(coarse);
  a.fine = static_cast<const float2*>(fine);
  a.sx = static_cast<const int32_t*>(sx);
  a.sy = static_cast<const int32_t*>(sy);
  a.sx_out = static_cast<int32_t*>(sx_out);
  a.sy_out = static_cast<int32_t*>(sy_out);
  a.tails_in = static_cast<const float*>(tails_in);
  a.tails_out = static_cast<float*>(tails_out);
  a.y = static_cast<float*>(y);
  a.t = t;
  a.c2 = c2;
  a.tc = tc;
  a.warps = warps;
  a.producers = producers;
  a.chunk = chunk;
  a.ring = ring;
  a.vec = !fastlo && c2 % 4 == 0 && aligned16(xs);
  a.k = idsp::Df1Coefs{b0, b1, b2, a1, a2, f};
  a.cl = idsp::Df1Clamp{u, lo, hi};
  const dim3 grid((c2 + kLanes - 1) / kLanes);
  kernel<<<grid, warps * kLanes, want, static_cast<cudaStream_t>(stream)>>>(
      a, p);
  return static_cast<int>(cudaGetLastError());
}
