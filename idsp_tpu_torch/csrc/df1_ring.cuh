// The depth-0 pipeline of a serial recurrence over a 32-lane tile, and the
// DF1 warp that runs in it.  A serial warp alone on its scheduler turns
// each slot of an input ring into a slot of an output ring (`serial_chunks`);
// producer warps fill the input ring, a store warp writes the output ring
// to device memory (`run_pipe`).  Fifteen kernels run it: K14
// (ddc_mix_df1.cu) and K15 (fm_disc.cu) with the DF1 warp as the serial
// warp (`Df1Serial`), K12/K13 (ddc_bank.cu) with the DF1 warp over paired
// I|Q channels and a back-end warp in the store warp's place (`run_roles`),
// K37 and K34 (structures_bank.cu, the RPLL and the SVF), K29
// (biquad_precision.cu, the Q64) and K16 (ddc_lockin.cu, the f32 DF1 after
// the lock-in mix) with their own, and K1, K11, K18, K26, K27 (df1_bank.cu)
// and K31/K33 (biquad_precision.cu, the error-feedback DF1) with one
// serial warp over the producers' feed-forward sums (`Df1WSerial`).  The
// DF1 warp also serves K2, K3 and K19-K21 (ddc_cascade.cu: its output ring
// is stage 0's FIR buffer).
// Where the producers' work is more than one SM's other three schedulers
// issue in the serial warp's time (K15's exact angle), a tile is a cluster
// of 2 CTAs: every warp of the partner CTA is a producer too, storing its
// rows into the home CTA's input slots (`st.async`, counted on the slot's
// full barrier), and the serial warp releases each slot to the partner as
// well as to its own producers.
//
// Why a warp alone: a recurrence's loop-carried chain sets the pace of a
// tile (the DF1's 64-bit multiply-add and shift, df1.cuh `output_y1_last`:
// ~42 cycles a row on the H100, PERF.md §6).  Anything else that warp
// issues -- the producers' work, a global store of its own row (78 cycles
// a row against 11 without, the WDF kernel's measurement, PERF.md §6) --
// adds to that chain's time.  So the serial warp reads its rows from
// shared memory only, touches device memory for its state at each end
// only, and is alone on its scheduler: the other warps with warp % 4 == 0
// exit at once.
//
// The rings: chunk q of `chunk` rows uses slot q % depth of each ring at
// phase parity (q / depth) & 1 (hopper.cuh `Cursor`); slot k has four
// mbarriers, the input ring's full and empty and the output ring's full
// and empty.  An input slot holds `chunk` rows of kLanes x `Win` 32-bit
// words, word w of row r and lane l at (r * kLanes + l) * Win + w, an
// output slot the same with `Wout` words (K12/K13, K14, K15, K16, K34: 1
// and 1; K1, K11, K18, K26, K27, K31/K33: 2 and 1; K37: 2 and 2; K29: 4
// and 2), so a warp reads or writes a row as one 4-, 8- or 16-byte word a
// lane, contiguous across the lanes.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "df1.cuh"
#include "hopper.cuh"
#include "seq_bank.cuh"

namespace idsp {
namespace ring {

constexpr int kLanes = 32;   // lanes of a tile (threadIdx.x % 32)
constexpr int kGroup = 8;    // serial rows whose inputs are read a group ahead
constexpr int kMaxWarps = 16;

// Slot k's barriers, and the input ring's slots (rows of kLanes x W
// 32-bit words).
struct Rings {
  uint32_t bars;
  int32_t* in;
  int chunk;

  __device__ uint32_t full_in(int k) const { return bars + 32 * k; }
  __device__ uint32_t empty_in(int k) const { return bars + 32 * k + 8; }
  __device__ uint32_t full_out(int k) const { return bars + 32 * k + 16; }
  __device__ uint32_t empty_out(int k) const { return bars + 32 * k + 24; }
  template <int W = 1>
  __device__ int32_t* in_slot(int k) const {
    return in + static_cast<size_t>(k) * chunk * kLanes * W;
  }
};

// Thread 0 initialises `depth` slots' barriers: `producers` and
// `consumers` warps arrive on the input ring's full and the output ring's
// empty barriers, each thread, and `peers` more arrivals on the full one
// (a partner CTA's warps, one each); the DF1 warp on the other two.  The
// caller then synchronises the block (the cluster, with a partner).
__device__ __forceinline__ void init_rings(const Rings& R, int depth,
                                           int producers, int consumers,
                                           int peers = 0) {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < depth; ++k) {
    sm90::mbar_init(R.full_in(k), kLanes * producers + peers);
    sm90::mbar_init(R.empty_in(k), kLanes);
    sm90::mbar_init(R.full_out(k), kLanes);
    sm90::mbar_init(R.empty_out(k), kLanes * consumers);
  }
  sm90::fence_barrier_init();
}

// The DF1 warp's launch-wide arguments: rows, the ring, the state in and
// out ((lanes, 2) int32 each), the coefficients and the clamp.
struct Df1Ring {
  int t, chunk, depth;
  const int32_t *sx, *sy;
  int32_t *sx_out, *sy_out;
  Df1Coefs k;
  Df1Clamp cl;
};

// step(r, load(r)) for the rows r = 0 .. rows-1 of a slot in order, in
// groups of kGroup rows, each group's inputs read before the group before
// computes, so the loads stay off the chain (K16, K29, K31/K33, K34, K37; a
// read past the slot's rows takes its last row, unused).
template <class Load, class Step>
__device__ __forceinline__ void group_rows(int rows, Load load, Step step) {
  using In = decltype(load(0));
  int r = 0;
  if (rows >= kGroup) {
    In cur[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup; ++v) cur[v] = load(v);
    for (; r + kGroup <= rows; r += kGroup) {
      In nxt[kGroup];
#pragma unroll
      for (int v = 0; v < kGroup; ++v)
        nxt[v] = load(min(r + kGroup + v, rows - 1));
#pragma unroll
      for (int v = 0; v < kGroup; ++v) step(r + v, cur[v]);
#pragma unroll
      for (int v = 0; v < kGroup; ++v) cur[v] = nxt[v];
    }
  }
#pragma unroll 1
  for (; r < rows; ++r) step(r, load(r));
}

// The serial warp's walk over the chunks (K16, K29, K31/K33, K34, K37; one
// CTA a tile): chunk q's input slot full and its output slot empty, rows(k,
// n) on slot k's n rows, then both released.
template <class Rows>
__device__ __forceinline__ void serial_chunks(int t, int chunk, int depth,
                                              const Rings& R, Rows rows) {
  sm90::Cursor u;
  for (int r0 = 0; r0 < t; r0 += chunk, u.next(depth)) {
    const int n = min(chunk, t - r0);
    sm90::mbar_wait(R.full_in(u.k), u.ph);
    sm90::mbar_wait(R.empty_out(u.k), u.ph ^ 1);
    rows(u.k, n);
    sm90::mbar_arrive(R.full_out(u.k));
    sm90::mbar_arrive(R.empty_in(u.k));
  }
}

// The DF1 warp's rows of one chunk, input slot x -> output slot y (this
// lane's column), the output as Out (int32, or float for the FIR stages
// and K14's f32 output): in groups of kGroup rows, each group's inputs
// read before the group before computes, so the loads stay off the chain
// (`group_rows`' loop ran K14 and K15's exact angle 1-2 % slower and K2 2 %
// faster on the H100, PERF.md §6: this one is kept).
template <bool Clamp, class Out>
__device__ __forceinline__ void df1_rows(Df1Lane& s, const Df1Coefs& k,
                                         const Df1Clamp& cl, const int32_t* x,
                                         Out* y, int rows) {
  auto step = [&](int32_t x0) {
    int32_t y0 = s.output_y1_last(k, x0);
    if constexpr (Clamp) y0 = cl(y0);
    return static_cast<Out>(s.push(x0, y0));
  };
  int r = 0;
  if (rows >= kGroup) {
    int32_t cur[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup; ++v) cur[v] = x[v * kLanes];
    for (; r + kGroup <= rows; r += kGroup) {
      const bool more = r + 2 * kGroup <= rows;
      int32_t nxt[kGroup];
#pragma unroll
      for (int v = 0; v < kGroup; ++v)
        nxt[v] = more ? x[(r + kGroup + v) * kLanes] : 0;
#pragma unroll
      for (int v = 0; v < kGroup; ++v) y[(r + v) * kLanes] = step(cur[v]);
#pragma unroll
      for (int v = 0; v < kGroup; ++v) cur[v] = nxt[v];
    }
  }
#pragma unroll 1
  for (; r < rows; ++r) y[r * kLanes] = step(x[r * kLanes]);
}

// The DF1 warp: state in, every chunk from its input slot into its output
// slot, state out, on `serial_chunks`' protocol (written out: through that
// function's callback the DF1 warp ran K14 and K15 3 % slower on the H100,
// PERF.md §6).  out is the output ring's slot 0 in this lane's column;
// slot k lies chunk * kLanes words further per slot.  peer: 0, or the
// partner CTA's input-ring empty barrier of slot 0 (`map_rank`ed): the
// partner stores into the input slots too, so the DF1 warp acquires them
// at cluster scope and releases each slot to the partner as well, for the
// chunks the partner has still to fill (after its last, the partner may
// have exited).
template <bool Clamp, class Out>
__device__ __forceinline__ void df1_warp(const Df1Ring& a, const Rings& R,
                                         Out* out, int lid, int lane,
                                         bool live, uint32_t peer = 0) {
  Df1Lane s{};
  if (live) s.load(a.sx, a.sy, lane);
  const Df1Coefs k = a.k;
  const Df1Clamp cl = a.cl;
  sm90::Cursor u;
  for (int r0 = 0; r0 < a.t; r0 += a.chunk, u.next(a.depth)) {
    const int rows = min(a.chunk, a.t - r0);
    if (peer) {
      sm90::mbar_wait_cluster(R.full_in(u.k), u.ph);
    } else {
      sm90::mbar_wait(R.full_in(u.k), u.ph);
    }
    sm90::mbar_wait(R.empty_out(u.k), u.ph ^ 1);
    df1_rows<Clamp>(s, k, cl, R.in_slot(u.k) + lid,
                    out + static_cast<size_t>(u.k) * a.chunk * kLanes, rows);
    sm90::mbar_arrive(R.full_out(u.k));
    sm90::mbar_arrive(R.empty_in(u.k));
    if (peer && r0 + a.depth * a.chunk < a.t)
      sm90::mbar_arrive_remote(peer + 32 * u.k);
  }
  if (live) s.store(a.sx_out, a.sy_out, lane);
}

// ---- depth 0: producers -> serial warp -> store warp -----------------------

// How the store warp lays a row's wout words a lane out in device memory:
// kWide, one (t, c2) plane of wout-word elements (K14, K15: int32 or f32;
// K31/K33: int32; K34: f32; K29: int64); kPlanes, wout (t, c2) planes of
// 32-bit words, word w to plane w (K37: phase and frequency).
enum class Layout { kWide, kPlanes };

// A depth-0 launch: d, the serial warp's rows (t), chunk and ring depth
// (with the DF1 warp, its state and coefficients too); y, the output
// planes (y[0] alone for kWide); the plan (filters/pipe_plan.py
// `pipe_plan`): `warps` warps a block, `producers` of them producers and
// the next one the store warp, the rest idle; cluster: 1, or 2 (a partner
// CTA a tile, all `warps` of it producers); vec: y's rows take 16-byte
// stores (each plane 16-byte aligned, its rows too).
struct Pipe {
  Df1Ring d;
  void* y[2];
  int c2, warps, producers, cluster, vec;
};

// Shared memory: 32 bytes of mbarriers a slot, the input ring and the
// output ring (depth slots of chunk rows of kLanes x win and x wout words).
__host__ __device__ inline size_t pipe_smem(int chunk, int depth,
                                            int win = 1, int wout = 1) {
  return 32 * static_cast<size_t>(depth) +
         static_cast<size_t>(depth) * chunk * kLanes * 4 * (win + wout);
}

// Dynamic shared memory a depth-0 block may have: the 227 KB of an SM's
// block less 1 KB for the kernels' static lookup tables.
constexpr int kMaxPipeSmem = 232448 - 1024;

// The plan checks of a depth-0 entry point (the host plan's own): false
// for a plan the kernel cannot run.
inline bool pipe_plan_ok(int t, int c2, int warps, int producers,
                         int chunk, int depth, int smem, int cluster = 1,
                         int win = 1, int wout = 1) {
  return t >= 0 && c2 >= 1 && (cluster == 1 || cluster == 2) &&
         warps % 4 == 0 && warps >= 4 && warps <= kMaxWarps &&
         producers >= 1 && producers + 1 <= warps - warps / 4 && chunk >= 1 &&
         depth >= 2 &&
         static_cast<size_t>(smem) == pipe_smem(chunk, depth, win, wout) &&
         smem <= kMaxPipeSmem;
}

// The store warp: each chunk's output slot (`out`: slot 0) to the planes'
// rows, this tile's columns [col0, col0 + kLanes).  With vec, 16 bytes a
// thread (kWide: 4 x wout lanes a row and 4 / wout rows a warp
// instruction; kPlanes: 8 threads a row of 4 lanes each, 4 rows an
// instruction a plane), else each lane its own column.
template <int Wout, Layout L>
__device__ __forceinline__ void store_warp(const Pipe& p, const Rings& R,
                                           const uint32_t* out, int lid,
                                           int col0) {
  constexpr int kRow = kLanes * Wout;  // words of a slot's row
  constexpr int kT = L == Layout::kWide ? kRow / 4 : kLanes / 4;
  const int chunk = p.d.chunk;
  const size_t c2 = static_cast<size_t>(p.c2);
  const int w4 = 4 * (lid % kT);  // kWide: word; kPlanes: lane of the row
  sm90::Cursor u;
  for (int r0 = 0; r0 < p.d.t; r0 += chunk, u.next(p.d.depth)) {
    const int rows = min(chunk, p.d.t - r0);
    sm90::mbar_wait(R.full_out(u.k), u.ph);
    const uint32_t* s = out + static_cast<size_t>(u.k) * chunk * kRow;
    if constexpr (L == Layout::kWide) {
      uint32_t* yr = static_cast<uint32_t*>(p.y[0]) +
                     (static_cast<size_t>(r0) * c2 + col0) * Wout;
      if (p.vec) {
        if (col0 * Wout + w4 < p.c2 * Wout)
          for (int r = lid / kT; r < rows; r += kLanes / kT)
            *reinterpret_cast<uint4*>(yr + r * c2 * Wout + w4) =
                *reinterpret_cast<const uint4*>(s + r * kRow + w4);
      } else if (col0 + lid < p.c2) {
        for (int r = 0; r < rows; ++r)
#pragma unroll
          for (int w = 0; w < Wout; ++w)
            yr[(r * c2 + lid) * Wout + w] = s[r * kRow + lid * Wout + w];
      }
    } else {
      const size_t at = static_cast<size_t>(r0) * c2 + col0;
      if (p.vec) {
        if (col0 + w4 < p.c2)
          for (int r = lid / kT; r < rows; r += kLanes / kT) {
            const uint32_t* v = s + r * kRow + w4 * Wout;
#pragma unroll
            for (int w = 0; w < Wout; ++w)
              *reinterpret_cast<uint4*>(static_cast<uint32_t*>(p.y[w]) + at +
                                        r * c2 + w4) =
                  make_uint4(v[w], v[Wout + w], v[2 * Wout + w],
                             v[3 * Wout + w]);
          }
      } else if (col0 + lid < p.c2) {
        for (int r = 0; r < rows; ++r)
#pragma unroll
          for (int w = 0; w < Wout; ++w)
            static_cast<uint32_t*>(p.y[w])[at + r * c2 + lid] =
                s[r * kRow + lid * Wout + w];
      }
    }
    sm90::mbar_arrive(R.empty_out(u.k));
  }
}

// Rows [r, min(r + B, hi)) of the chunk at r0: a producer's batch.
struct Batch {
  int r0, r, hi;
};

// Producer pw of P's walk over its span of every chunk, rows [pw * span,
// (pw + 1) * span) (span = ceil(chunk / P)), in batches of B rows (K3,
// K12/K13, K16, K29, K31/K33, K34, K37): for each chunk its input slot
// empty, then for each of its batches load(next, rows, cur_rows, same) --
// the next batch, the next chunk's first too, loaded while this one is
// formed -- and form(batch, rows, slot k), then one arrival on the slot's
// full barrier.  same: the next batch continues this one's span, so it may
// take rows from cur_rows.
// load sees a batch at r0 >= t past the last and loads nothing.
template <int B, class Rows, class Load, class Form>
__device__ __forceinline__ void span_batches(int t, int chunk, int depth,
                                             int P, int pw, const Rings& R,
                                             Load load, Form form) {
  const int span = (chunk + P - 1) / P;
  auto first = [&](int r0) {  // this producer's first non-empty batch
    for (;; r0 += chunk) {
      const int rows = min(chunk, t - r0);
      const int lo = min(pw * span, rows);
      if (r0 >= t || lo < min(lo + span, rows))
        return Batch{r0, lo, min(lo + span, rows)};
    }
  };
  auto next = [&](const Batch& b) {
    return b.r + B < b.hi ? Batch{b.r0, b.r + B, b.hi} : first(b.r0 + chunk);
  };
  Batch cur = first(0);
  Rows a;
  load(cur, a, a, false);
  sm90::Cursor u;
  for (int r0 = 0; r0 < t; r0 += chunk, u.next(depth)) {
    sm90::mbar_wait(R.empty_in(u.k), u.ph ^ 1);
    for (; cur.r0 == r0;) {
      const Batch nb = next(cur);
      Rows n;
      load(nb, n, a, nb.r0 == cur.r0);
      form(cur, a, u.k);
      cur = nb;
      a = n;
    }
    sm90::mbar_arrive(R.full_in(u.k));
  }
}

// The DF1 warp as `run_pipe`'s serial warp, its output as Out (K14, K15).
template <class Out>
struct Df1Serial {
  const Df1Ring* d;
  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t peer) const {
    df1_warp<false>(*d, R, reinterpret_cast<Out*>(out) + lid, lid, lane,
                    live, peer);
  }
};

// A depth-0 block: the rings in `smem` (Win words a row and lane in), the
// serial warp (warp 0) calling serial(R, out, lid, lane, live, peer) with
// out the output ring's slot 0, the warps of its scheduler idle, then
// `producers` warps calling produce(R, pw, lid, lane, live, false) (pw
// their index) and the next one store(R, out, lid, col0), the warp that
// empties the output ring; warps past those exit.  With a cluster of 2,
// CTA rank 0 is that block and every warp w of rank 1 calls produce(R,
// producers + w, lid, lane, live, true): it stores into rank 0's input
// slots and arrives on their full barriers, one arrival a warp.  The
// caller has set up anything the warps read from shared memory, and the
// block (or cluster) barrier here publishes it.  A tile whose lanes are
// not kLanes consecutive lanes (K12/K13's paired I|Q channels) maps lid
// to its own lanes in its functors.
template <int Win, class Serial, class Produce, class Store>
__device__ __forceinline__ void run_roles(const Pipe& p, unsigned char* smem,
                                          Serial serial, Produce produce,
                                          Store store) {
  const int warp = threadIdx.x / kLanes, lid = threadIdx.x % kLanes;
  const int col0 = blockIdx.x / p.cluster * kLanes, lane = col0 + lid;
  const bool live = lane < p.c2;  // dead lanes still reach every barrier
  const Rings R{sm90::smem_addr(smem),
                reinterpret_cast<int32_t*>(smem + 32 * p.d.depth),
                p.d.chunk};
  uint32_t* out = reinterpret_cast<uint32_t*>(R.in_slot<Win>(p.d.depth));
  const bool paired = p.cluster > 1;
  init_rings(R, p.d.depth, p.producers, 1, paired ? p.warps : 0);
  if (paired) {
    sm90::cluster_sync();  // both CTAs' barriers initialised
    if (sm90::cluster_rank() != 0) {
      produce(R, p.producers + warp, lid, lane, live, true);
      return;
    }
  } else {
    __syncthreads();
  }
  if (warp == 0) {
    serial(R, out, lid, lane, live,
           paired ? sm90::map_rank(R.empty_in(0), 1) : 0u);
    return;
  }
  if (warp % 4 == 0) return;  // the serial warp's scheduler stays quiet
  const int v = warp - warp / 4 - 1;  // index among the other warps
  if (v < p.producers) {
    produce(R, v, lid, lane, live, false);
  } else if (v == p.producers) {
    store(R, out, lid, col0);
  }
}

// `run_roles` with the store warp writing the output ring (Wout words a
// row and lane) to device memory in layout L (`store_warp`).
template <int Win, int Wout, Layout L, class Serial, class Produce>
__device__ __forceinline__ void run_pipe(const Pipe& p, unsigned char* smem,
                                         Serial serial, Produce produce) {
  run_roles<Win>(p, smem, serial, produce,
                 [&](const Rings& R, const uint32_t* out, int lid, int col0) {
                   store_warp<Wout, L>(p, R, out, lid, col0);
                 });
}

// Launches a depth-0 kernel over c2 / kLanes tiles of p.cluster CTAs each
// (its plan checked by the caller); a refused shared-memory size launches
// nothing and leaves no CUDA error pending.  A cluster launch gives every
// CTA the same dynamic shared memory, so a partner CTA holds `smem` bytes
// of which it uses its slots' barriers only (PERF.md §7).
template <class Kernel, class A>
int launch_pipe(Kernel kernel, const A& args, const Pipe& p, int smem,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.c2 + kLanes - 1) / kLanes * p.cluster);
  cfg.blockDim = dim3(p.warps * kLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, args);
  return static_cast<int>(cudaGetLastError());
}

// ---- the Q32<f> DF1 at depth 0: W by the producers, the chain alone --------

// A DF1 producer's rows (K1, K11, K18, K26, K27, K29, K31/K33): x[0], x[1]
// the two rows before a batch of B rows, x[v + 2] row v.
template <class T, int B>
struct TapRows {
  T x[B + 2];
};

// Producer pw of P's walk for a DF1's feed-forward sum: its span of each
// chunk (`span_batches`) in batches of B rows of xs (t, c), form(batch,
// rows, slot) writing each row's sum into the input ring.  A batch takes
// its two rows before from the batch before where that was of the same
// span, else loads them, rows -1 and -2 of the block from the state sx
// ((c, 2): x1, x2), so spans are independent.  Producer 0 also writes the
// last two rows out as the state's x.
template <int B, class T, class Form>
__device__ __forceinline__ void tap_feed(const Pipe& p, const Rings& R,
                                         int pw, int lane, bool live,
                                         const T* xs, const T* sx,
                                         T* sx_out, Form form) {
  const int t = p.d.t;
  const size_t c = static_cast<size_t>(p.c2);
  const int ch = live ? lane : 0;  // dead lanes read lane 0's words
  const T* xp = xs + ch;
  const T x1 = sx[2 * ch], x2 = sx[2 * ch + 1];
  auto row = [&](int g) {  // x of block row g >= -2
    return g >= 0 ? idsp::ldg(xp + static_cast<size_t>(g) * c)
                  : g == -1 ? x1 : x2;
  };
  span_batches<B, TapRows<T, B>>(
      t, p.d.chunk, p.d.depth, p.producers, pw, R,
      [&](const Batch& b, TapRows<T, B>& n, const TapRows<T, B>& cur,
          bool same) {
        if (b.r0 >= t) return;
        const int g = b.r0 + b.r;
        n.x[0] = same ? cur.x[B] : row(g - 2);
        n.x[1] = same ? cur.x[B + 1] : row(g - 1);
#pragma unroll
        for (int v = 0; v < B; ++v)
          n.x[v + 2] = row(b.r0 + min(b.r + v, b.hi - 1));
      },
      form);
  if (pw == 0 && live) {
    sx_out[2 * lane] = row(t - 1);
    sx_out[2 * lane + 1] = row(t - 2);
  }
}

// A launch of the int32 DF1 whose producers form W (K1, K11, K18, K26,
// K27 in df1_bank.cu; K31/K33 in biquad_precision.cu): p.d holds the
// rows, chunk and ring depth (no DF1 warp), p.y the output.  With planes
// (K26, K27, K33) each lane's coefficients come from (5, c) planes, else
// k's; f and the clamp are k's and cl's either way.  K31/K33 carry the
// error word e (se, se_out; emask, the sum's low f bits); K11 keeps the
// rows 0, dec, 2 dec, ... of its block.
struct Df1WArgs {
  Pipe p;
  const int32_t* xs;
  const int32_t *sx, *sy;
  const int64_t* se;
  int32_t *sx_out, *sy_out;
  int64_t* se_out;
  const int32_t* planes;
  Df1Coefs k;
  Df1Clamp cl;
  uint32_t emask;
  int dec;
};

// The producers: `tap_feed` in batches of kWRows rows, each row's sum W =
// b0 x0 + b1 x1 + b2 x2 mod 2^64 into the input ring as two 32-bit words;
// with Planes they take the lane's b0-b2 from the planes once.
constexpr int kWRows = 16;

template <bool Planes>
__device__ __forceinline__ void w_feed(const Df1WArgs& a, const Rings& R,
                                       int pw, int lid, int lane, bool live) {
  int32_t b0 = a.k.b0, b1 = a.k.b1, b2 = a.k.b2;
  if constexpr (Planes) {
    const size_t c = static_cast<size_t>(a.p.c2);
    const int ch = live ? lane : 0;
    b0 = __ldg(a.planes + ch);
    b1 = __ldg(a.planes + c + ch);
    b2 = __ldg(a.planes + 2 * c + ch);
  }
  tap_feed<kWRows>(
      a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
      [&](const Batch& b, const TapRows<int32_t, kWRows>& xv, int slot) {
        uint2* s = reinterpret_cast<uint2*>(R.in_slot<2>(slot)) + lid;
#pragma unroll
        for (int v = 0; v < kWRows; ++v) {
          const uint64_t w = static_cast<uint64_t>(
              mad_wide(b0, xv.x[v + 2],
                       mad_wide(b1, xv.x[v + 1], mul_wide(b2, xv.x[v]))));
          if (b.r + v < b.hi)
            s[(b.r + v) * kLanes] = make_uint2(static_cast<uint32_t>(w),
                                               static_cast<uint32_t>(w >> 32));
        }
      });
}

// The serial warp: y1, y2 (and with Dither e) of its lane in registers;
// each row's W from the input ring, y0 into the output ring.  V = W + a2
// y2 waits on no step of the row before (y2 is the row before's y1), so
// it is formed a row ahead, off the chain; on the chain are a1 y1's
// multiply-add onto V (K31/K33: onto V + e, e ready beside y1: a1 y1 + (V
// + e) ran 2.6 % faster than (a1 y1 + V) + e unclamped, 3.9 % clamped, on
// the H100, PERF.md §6), one shift and the clamp if any.  The shift keeps
// the low word of acc >> f: for f <= 32 bits [f, f + 32) of acc, one
// funnel shift (`__funnelshift_rc` takes the high word at f = 32); for 32
// < f < 64 (Hi) the high word shifted right by f - 32, sign-filled.  With
// Dither (0 < f <= 32) the next e is acc's low f bits, the dither step's
// (u32)(acc << (32 - f)) >> (32 - f).  The clamped form feeds the clamped
// y0 back and drops the unclamped one (df1.cuh `Df1Clamp`); e keeps
// the unclamped fraction.  acc wraps mod 2^64, so any order of its terms
// gives the plain version's bits.
template <bool Dither, bool Clamp, bool Planes, bool Hi = false>
struct Df1WSerial {
  const Df1WArgs* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const size_t c = static_cast<size_t>(p.c2);
    const int ch = live ? lane : 0;
    int32_t a1 = a->k.a1, a2 = a->k.a2;
    if constexpr (Planes) {
      a1 = __ldg(a->planes + 3 * c + ch);
      a2 = __ldg(a->planes + 4 * c + ch);
    }
    const Df1Clamp cl = a->cl;
    const int f = a->k.f;
    const int sh = f - 32;
    const uint32_t emask = a->emask;
    int32_t y1 = 0, y2 = 0;
    uint32_t e = 0;
    if (live) {
      y1 = a->sy[2 * lane];
      y2 = a->sy[2 * lane + 1];
      if constexpr (Dither) e = static_cast<uint32_t>(a->se[lane]);
    }
    serial_chunks(p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
      const uint2* in =
          reinterpret_cast<const uint2*>(R.in_slot<2>(slot)) + lid;
      int32_t* o = reinterpret_cast<int32_t*>(out) +
                   static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
      group_rows(
          rows, [&](int r) { return in[r * kLanes]; },
          [&](int r, uint2 w) {
            const int64_t v = mad_wide(  // off the chain
                a2, y2, static_cast<int64_t>(uint64_t{w.y} << 32 | w.x));
            int64_t sum = v;
            if constexpr (Dither)
              sum = static_cast<int64_t>(static_cast<uint64_t>(v) + e);
            const uint64_t acc =
                static_cast<uint64_t>(mad_wide(a1, y1, sum));
            const uint32_t lo = static_cast<uint32_t>(acc);
            const uint32_t hi = static_cast<uint32_t>(acc >> 32);
            int32_t y0;
            if constexpr (Hi) {
              y0 = static_cast<int32_t>(hi) >> sh;
            } else {
              y0 = static_cast<int32_t>(__funnelshift_rc(lo, hi, f));
            }
            if constexpr (Dither) e = lo & emask;
            if constexpr (Clamp) y0 = cl(y0);
            y2 = y1;
            y1 = y0;
            o[r * kLanes] = y0;
          });
    });
    if (live) {
      a->sy_out[2 * lane] = y1;
      a->sy_out[2 * lane + 1] = y2;
      if constexpr (Dither) a->se_out[lane] = static_cast<int64_t>(e);
    }
  }
};

}  // namespace ring
}  // namespace idsp
