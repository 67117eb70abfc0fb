// K24 and K25: the compat surface's two banks.  K24 runs an N-stage
// fixed-point SOS cascade (every stage a Q32<f> DF1, 0 < f < 64), K25 the
// wide-state DF1 (int64 feedback words, 0 < f <= 32), optionally clamped.
// K32 is K25 with runtime coefficients: each lane's five words from (5, c)
// int32 planes.
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `sos_bank_q` (:147, `_sos_bank_q_impl` :174), `df1_wide_bank` (:796,
// body `_wide_body` :763) and `df1_wide_bank_coef` (:1053), all
// `_seq_bank_kernel` (:471) run by `_bank_call` (:395, pallas_call :453).
// The TPU kernels emulated every 64-bit product, add and shift in 16-bit
// limbs (`_mac5_q`, `_mul_u32_coef`, `_shl_i64`); Hopper has native 64-bit
// multiply-adds.
//
// What bounds them on the H100: the recurrence.  y0 of a row feeds the
// next row's products, so a lane is a serial chain; the bytes (4 B in and
// 4 B out a sample) are small next to it.  K24 chains N stages a row,
// stage n's output the input of stage n + 1 in the same row, so one lane's
// serial work is N DF1 steps a row; K25's chain holds two split-word
// products of its int64 feedback words, a shift and (clamped) the
// high-word splice.  When one thread a lane issued the loads, every
// product and the store (the sequential-bank template), a row took ~235
// cycles (K24, 4 stages) and ~105 (K25) on the H100 (PERF.md §6).
//
// What the design does: all three run on df1_ring.cuh's depth-0 pipeline,
// a block a 32-lane tile.  K25/K32 is K1's block (df1_bank.cu) with a wide
// serial functor: producer warps form W = b0 x0 + b1 x1 + b2 x2 mod 2^64 by
// spans (`w_feed`; K32's read b0-b2 from the lane's planes), the serial
// warp alone on its scheduler (`Df1WideSerial`) holds y1 and y2 as int64
// words, forms V = W + split_mul(y2, a2) a row ahead and runs split_mul(y1,
// a1) onto V, the shift left by 32 - f (two funnel shifts) and the clamp on
// the chain; a store warp writes the rows.  K24's stages are spread over a
// chain of depth-0 blocks on a thread-block cluster (`run_chain`): chain
// rank j of a tile runs stages [j g, (j + 1) g), one rank a CTA or two
// (their serial warps on schedulers 0 and 2).  Rank 0's producers form
// stage 0's W from xs, every later rank's from its x ring, which the rank
// before's store warp fills with its last stage's rows (`peer_store`:
// through distributed shared memory from another CTA, `x_feed`); each
// rank's serial warp runs its first stage from W and its later stages from
// the stage before's y0 in registers; the last rank's store warp writes
// ys.  A rank of 2+ stages is bound by its serial warp's 64-bit
// multiply-adds, five a later stage and row on one scheduler, so a stage
// a serial warp is fastest, where the card holds the tiles' clusters at
// once.  The shape comes from the host plan (filters/pipe_plan.py
// `sos_plan`: one stage a CTA, two one-stage ranks a CTA, then g = 2, 3,
// ... stages a CTA, the first whose CTAs fit the card one an SM and whose
// clusters it holds at once; g = N, one CTA a tile, otherwise).  The sums
// wrap mod 2^64, so any order of a stage's
// five terms gives the plain versions' bits; a cascade of more than
// kSosMaxStages stages runs as successive launches over groups of
// stages, which the stage-major composition leaves bit-identical.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"

namespace {

using idsp::mad_wide;
using idsp::mul_wide;
using idsp::ring::Batch;
using idsp::ring::kLanes;
using idsp::ring::kWRows;
using idsp::ring::Pipe;
using idsp::ring::Rings;
using idsp::ring::TapRows;
using idsp::ring::WideArgs;
using idsp::ring::ChainPos;

constexpr int kSosMaxStages = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size

// A K24 launch: p the plan (p.cluster CTAs a tile), xs (t, c), the
// stages' state x, y (n, c, 2) in and out, their coefficients, g stages a
// rank (ceil(n / g) ranks), f.
struct SosArgs {
  Pipe p;
  const int32_t* xs;
  const int32_t *sx, *sy;
  int32_t *sx_out, *sy_out;
  int32_t ba[kSosMaxStages][5];
  int n, g, f;
};

// The low word of acc >> f: bits [f, f + 32) of acc (one funnel shift)
// for f <= 32, the high word shifted right by f - 32, sign-filled, for 32 <
// f < 64 (Hi), as df1_ring.cuh `Df1WSerial`.
template <bool Hi>
__device__ __forceinline__ int32_t shift_q(int64_t acc, int f) {
  const uint32_t lo = static_cast<uint32_t>(acc);
  const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(acc) >> 32);
  if constexpr (Hi) {
    return static_cast<int32_t>(hi) >> (f - 32);
  } else {
    return static_cast<int32_t>(__funnelshift_rc(lo, hi, f));
  }
}

// The serial warp of a rank of S stages from s0: each row's W from the
// input ring; stage s0: V = W + a2 y2, then a1 y1 + V (a1 y1 last, the
// only term on the chain) and the shift; every later stage forms b1 x1 +
// b2 x2 + a2 y2 from the row before's words, then b0 x0 (x0 the stage
// before's y0 of this row) and a1 y1.  The last stage's y0 goes into the
// output ring.  A later stage costs five 64-bit multiply-adds a row, and
// those set the pace of a rank of 2+ stages: ~8 cycles each on the
// serial warp's scheduler of the H100 (PERF.md §6; issuing stage s of row
// r beside stage s + 1 of row r - 1, skewed by hand, ran 7 % slower).
// After the last row it writes every stage's y state and the x state of
// its stages past s0 (stage s0's is its producers').
template <int S, bool Hi>
__device__ __forceinline__ void sos_stages(const SosArgs& a, const Rings& R,
                                           uint32_t* out, int lid, int lane,
                                           bool live, int s0) {
  const size_t plane = 2 * static_cast<size_t>(a.p.c2);
  const int f = a.f;
  int32_t b0[S], b1[S], b2[S], a1[S], a2[S], x1[S], x2[S], y1[S], y2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int32_t* k = a.ba[s0 + s];
    b0[s] = k[0];
    b1[s] = k[1];
    b2[s] = k[2];
    a1[s] = k[3];
    a2[s] = k[4];
    x1[s] = x2[s] = y1[s] = y2[s] = 0;
    if (live) {
      const size_t at = (s0 + s) * plane + 2 * lane;
      x1[s] = a.sx[at];
      x2[s] = a.sx[at + 1];
      y1[s] = a.sy[at];
      y2[s] = a.sy[at + 1];
    }
  }
  idsp::ring::serial_chunks(
      a.p.d.t, a.p.d.chunk, a.p.d.depth, R, [&](int slot, int rows) {
        const uint2* in =
            reinterpret_cast<const uint2*>(R.in_slot<2>(slot)) + lid;
        int32_t* o = reinterpret_cast<int32_t*>(out) +
                     static_cast<size_t>(slot) * a.p.d.chunk * kLanes + lid;
        idsp::ring::group_rows(
            rows, [&](int r) { return in[r * kLanes]; },
            [&](int r, uint2 w) {
              const int64_t v = mad_wide(  // off the chain
                  a2[0], y2[0],
                  static_cast<int64_t>(uint64_t{w.y} << 32 | w.x));
              int32_t y = shift_q<Hi>(mad_wide(a1[0], y1[0], v), f);
              y2[0] = y1[0];
              y1[0] = y;
#pragma unroll
              for (int s = 1; s < S; ++s) {
                const int64_t pre = mad_wide(
                    b2[s], x2[s],
                    mad_wide(b1[s], x1[s], mul_wide(a2[s], y2[s])));
                const int32_t ys = shift_q<Hi>(
                    mad_wide(a1[s], y1[s], mad_wide(b0[s], y, pre)), f);
                x2[s] = x1[s];
                x1[s] = y;
                y2[s] = y1[s];
                y1[s] = ys;
                y = ys;
              }
              o[r * kLanes] = y;
            });
      });
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t at = (s0 + s) * plane + 2 * lane;
      a.sy_out[at] = y1[s];
      a.sy_out[at + 1] = y2[s];
      if (s > 0) {
        a.sx_out[at] = x1[s];
        a.sx_out[at + 1] = x2[s];
      }
    }
  }
}

// The serial warp of chain rank `rank`: its min(g, n - rank g) stages, a
// template instance each count (one stage with two ranks a CTA, whose
// threads may hold fewer registers).
template <bool Hi, int Halves>
struct SosSerial {
  const SosArgs* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             int rank) const {
    const int s0 = rank * a->g;
    if constexpr (Halves == 2) {
      sos_stages<1, Hi>(*a, R, out, lid, lane, live, s0);
    } else {
      switch (min(a->g, a->n - s0)) {
        case 1: sos_stages<1, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 2: sos_stages<2, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 3: sos_stages<3, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 4: sos_stages<4, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 5: sos_stages<5, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 6: sos_stages<6, Hi>(*a, R, out, lid, lane, live, s0); break;
        case 7: sos_stages<7, Hi>(*a, R, out, lid, lane, live, s0); break;
        default: sos_stages<8, Hi>(*a, R, out, lid, lane, live, s0); break;
      }
    }
  }
};

// K24 (Hi for 32 < f < 64): a tile a chain of ceil(n / g) ranks over a
// cluster of p.cluster CTAs, Halves ranks a CTA.
template <bool Hi, int Halves>
__global__ void __launch_bounds__(
    kLanes*(Halves == 1 ? idsp::ring::kChainWarps : idsp::ring::kChainWarps2),
    1) sos_chain_kernel(const __grid_constant__ SosArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = 2 * static_cast<size_t>(a.p.c2);
  const int ranks = (a.n + a.g - 1) / a.g;
  idsp::ring::run_chain<Halves>(
      a.p, ranks, smem, SosSerial<Hi, Halves>{&a},
      [&](const Rings& R, const ChainPos& pos, int pw, int lid, int lane,
          bool live) {
        const int s0 = pos.rank * a.g;
        const int32_t* k = a.ba[s0];
        if (pos.rank == 0) {
          idsp::ring::tap_feed<kWRows>(
              a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
              [&](const Batch& b, const TapRows<int32_t, kWRows>& xv,
                  int slot) {
                idsp::ring::put_w(R, slot, lid, b, xv, k[0], k[1], k[2]);
              });
        } else {
          idsp::ring::x_feed<kWRows>(a.p, R, pos, pw, lid, lane, live, k[0],
                                     k[1], k[2], a.sx + s0 * plane,
                                     a.sx_out + s0 * plane);
        }
      },
      [&](const Rings& R, const ChainPos& pos, const uint32_t* out, int lid,
          int col0) {
        if (pos.rank + 1 < ranks) {
          // the next rank's first stage's x state: its x slot's rows 1, 0
          const int lane = col0 + lid, ch = lane < a.p.c2 ? lane : 0;
          const int32_t* sx = a.sx + (pos.rank + 1) * a.g * plane + 2 * ch;
          idsp::ring::peer_store(a.p, R, pos, out, lid, sx[0], sx[1]);
        } else {
          idsp::ring::store_warp<1, idsp::ring::Layout::kWide>(a.p, R, out,
                                                               lid, col0);
        }
      });
}

// The CTAs of a K24 tile: ceil(n / g) ranks, `halves` a CTA.
int sos_cluster(int n, int g, int halves) {
  return ((n + g - 1) / g + halves - 1) / halves;
}

// The plan checks of K24's entry (filters/pipe_plan.py `sos_plan`'s own):
// false for a plan the kernel cannot run.  Two ranks a CTA run one stage
// each, their roles on the warps of schedulers 1 and 3.
bool sos_plan_ok(int t, int c, int n, int g, int halves, int warps,
                 int producers, int chunk, int ring, int smem) {
  if (n < 1 || n > kSosMaxStages || g < 1 || g > n ||
      (halves != 1 && !(halves == 2 && g == 1)))
    return false;
  const int cluster = sos_cluster(n, g, halves);
  const bool roles =
      halves == 1 ? warps <= idsp::ring::kChainWarps &&
                        producers + 1 <= warps - warps / 4
                  : warps <= idsp::ring::kChainWarps2 &&
                        2 * (producers + 1) <= warps / 2;
  return t >= 0 && c >= 1 && cluster <= kMaxCluster && warps % 4 == 0 &&
         warps >= 4 && producers >= 1 && roles && chunk >= 1 && ring >= 2 &&
         static_cast<size_t>(smem) ==
             idsp::ring::chain_smem(chunk, ring, cluster, halves) &&
         smem <= idsp::ring::kMaxPipeSmem;
}

template <bool Clamp, bool Planes>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_wide_pipe_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<2, 1, idsp::ring::Layout::kWide>(
      a.w.p, smem, idsp::ring::Df1WideSerial<Clamp, Planes>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::w_feed<Planes>(a.w, R, pw, lid, lane, live);
      });
}

// K25 (planes null) or K32: checks the call and the plan, then launches
// the instance of the clamp and the coefficients' source.  A refused call
// launches nothing and leaves no CUDA error pending.
int launch_wide_pipe(const void* xs, void* ys, const void* sx, const void* sy,
                     void* sx_out, void* sy_out, const void* planes, int t,
                     int c, const idsp::Df1Coefs& k, int clamp,
                     const idsp::Df1Clamp& cl, int warps, int producers,
                     int chunk, int ring, int smem, void* stream) {
  if (k.f <= 0 || k.f > 32 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                2, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs a{};
  Pipe& p = a.w.p;
  p.d.t = t;
  p.d.chunk = chunk;
  p.d.depth = ring;
  p.y[0] = ys;
  p.c2 = c;
  p.warps = warps;
  p.producers = producers;
  p.cluster = 1;
  p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.w.xs = static_cast<const int32_t*>(xs);
  a.w.sx = static_cast<const int32_t*>(sx);
  a.w.sx_out = static_cast<int32_t*>(sx_out);
  a.w.planes = static_cast<const int32_t*>(planes);
  a.w.k = k;
  a.w.cl = cl;
  a.sy = static_cast<const int64_t*>(sy);
  a.sy_out = static_cast<int64_t*>(sy_out);
  using idsp::ring::launch_pipe;
  if (planes)
    return clamp ? launch_pipe(df1_wide_pipe_kernel<true, true>, a, p, smem,
                               stream)
                 : launch_pipe(df1_wide_pipe_kernel<false, true>, a, p, smem,
                               stream);
  return clamp ? launch_pipe(df1_wide_pipe_kernel<true, false>, a, p, smem,
                             stream)
               : launch_pipe(df1_wide_pipe_kernel<false, false>, a, p, smem,
                             stream);
}

}  // namespace

// K24: xs (t, c) i32 -> ys (t, c) i32 through n stages (1 <= n <= 8), g a
// rank, `halves` ranks a CTA (a tile a cluster of ceil(ceil(n / g) /
// halves) CTAs); state x, y (n, c, 2) i32 each, in and out; ba n x 5 i32
// (host memory); 0 < f < 64.  warps, producers (a rank's), chunk, ring
// (slots a ring) and smem are the host plan's (filters/pipe_plan.py
// `sos_plan`); a plan the kernel cannot run is refused, launching nothing
// and leaving no CUDA error pending.
extern "C" int idsp_sos_bank_q(const void* xs, void* ys, const void* sx,
                               const void* sy, void* sx_out, void* sy_out,
                               int t, int c, int f, int n, const int32_t* ba,
                               int g, int halves, int warps, int producers,
                               int chunk, int ring, int smem, void* stream) {
  if (f <= 0 || f >= 64 ||
      !sos_plan_ok(t, c, n, g, halves, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  SosArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = sos_cluster(n, g, halves);
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const int32_t*>(xs);
  a.sx = static_cast<const int32_t*>(sx);
  a.sy = static_cast<const int32_t*>(sy);
  a.sx_out = static_cast<int32_t*>(sx_out);
  a.sy_out = static_cast<int32_t*>(sy_out);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 5; ++j) a.ba[i][j] = ba[5 * i + j];
  a.n = n;
  a.g = g;
  a.f = f;
  using idsp::ring::launch_pipe;
  if (halves == 2)
    return f > 32 ? launch_pipe(sos_chain_kernel<true, 2>, a, a.p, smem,
                                stream)
                  : launch_pipe(sos_chain_kernel<false, 2>, a, a.p, smem,
                                stream);
  return f > 32 ? launch_pipe(sos_chain_kernel<true, 1>, a, a.p, smem, stream)
                : launch_pipe(sos_chain_kernel<false, 1>, a, a.p, smem, stream);
}

// K24's clusters of `cluster` CTAs of `halves` ranks, `warps` warps and
// smem bytes of shared memory that the card holds at once
// (cudaOccupancyMaxActiveClusters of the kernel); a negative CUDA error
// where it cannot say.
extern "C" int idsp_sos_max_clusters(int cluster, int halves, int warps,
                                     int smem) {
  if (cluster < 1 || cluster > kMaxCluster || (halves != 1 && halves != 2) ||
      warps < 4 ||
      warps > (halves == 1 ? idsp::ring::kChainWarps
                           : idsp::ring::kChainWarps2) ||
      smem < 0 || smem > idsp::ring::kMaxPipeSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  auto kernel =
      halves == 1 ? sos_chain_kernel<false, 1> : sos_chain_kernel<false, 2>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(warps * kLanes);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  return n;
}

// K25: xs (t, c) i32 -> ys (t, c) i32; state x (c, 2) i32 and y (c, 2) i64,
// in and out; 0 < f <= 32; clamp != 0 runs the clamped step (u, lo, hi).
// warps, producers, chunk, ring (slots a ring) and smem are the host
// plan's (filters/biquad_cuda.py `wide_plan`) here and below; a plan the
// kernel cannot run is refused.
extern "C" int idsp_df1_wide_bank(const void* xs, void* ys, const void* sx,
                                  const void* sy, void* sx_out, void* sy_out,
                                  int t, int c, int f, int b0, int b1, int b2,
                                  int a1, int a2, int clamp, int u, int lo,
                                  int hi, int warps, int producers, int chunk,
                                  int ring, int smem, void* stream) {
  return launch_wide_pipe(xs, ys, sx, sy, sx_out, sy_out, nullptr, t, c,
                          idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, clamp,
                          idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk,
                          ring, smem, stream);
}

// K32: K25 with each lane's coefficients from (5, c) i32 planes (not
// null).
extern "C" int idsp_df1_wide_bank_coef(const void* xs, void* ys,
                                       const void* sx, const void* sy,
                                       void* sx_out, void* sy_out,
                                       const void* planes, int t, int c,
                                       int f, int clamp, int u, int lo,
                                       int hi, int warps, int producers,
                                       int chunk, int ring, int smem,
                                       void* stream) {
  if (!planes) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide_pipe(xs, ys, sx, sy, sx_out, sy_out, planes, t, c,
                          idsp::Df1Coefs{0, 0, 0, 0, 0, f}, clamp,
                          idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk,
                          ring, smem, stream);
}
