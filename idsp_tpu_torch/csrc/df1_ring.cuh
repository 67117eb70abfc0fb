// The depth-0 pipeline of a serial recurrence over a 32-lane tile, and the
// DF1 warp that runs in it.  A serial warp alone on its scheduler turns
// each slot of an input ring into a slot of an output ring (`serial_chunks`);
// producer warps fill the input ring, a store warp writes the output ring
// to device memory (`run_pipe`).  These kernels run it: K14
// (ddc_mix_df1.cu) and K15 (fm_disc.cu) with the DF1 warp as the serial
// warp (`Df1Serial`), K12/K13 (ddc_bank.cu) with the DF1 warp over paired
// I|Q channels and a back-end warp in the store warp's place (`run_roles`),
// K6 (the same kernel) and K4 (lowpass_bank.cu: producers that copy x,
// `copy_feed`, and a store warp that keeps rows, `keep_store`) with the
// Lowpass serial warp (lowpass.cuh `LpSerial`), K37 and K34
// (structures_bank.cu, the RPLL and the SVF), K35 and K36 (the same file,
// the normal form: K1's producers `tap_feed` / `put_w` and a serial warp
// over the 2x2 rotation, `NormalQSerial`; K36's producers form the f32
// feed-forward sum, `f32_feed`, `NormalF32Serial`), K29 and K28
// (biquad_precision.cu, the Q64 and the Q16, whose store warp writes int16
// rows, `Layout::kHalf`) with their own, K16 (ddc_lockin.cu, the f32 DF1
// after the lock-in mix) and K30 (biquad_precision.cu, K36's producers)
// with one f32 DF1 serial warp (`Df1F32Serial`), K1, K11, K18, K26, K27
// (df1_bank.cu)
// and K31/K33 (biquad_precision.cu, the error-feedback DF1) with one
// serial warp over the producers' feed-forward sums (`Df1WSerial`), and
// K25/K32 (biquad_bank.cu, the wide DF1) with the same producers and a
// serial warp over int64 feedback words (`Df1WideSerial`).  K24
// (biquad_bank.cu, the SOS cascade) runs a chain of such blocks over a
// thread-block cluster, one or two a CTA, its stages spread over them
// (`run_chain`).  The
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
// The rings: chunk q of `chunk` rows uses slot q % depth of each ring at phase
// parity (q / depth) & 1 (hopper.cuh `Cursor`); slot k has four mbarriers, the
// input ring's full and empty and the output ring's full and empty.  An input
// slot holds `chunk` rows of kLanes x `Win` 32-bit words, word w of row r and
// lane l at (r * kLanes + l) * Win + w, an output slot the same with `Wout`
// words (K4, K6, K12/K13, K14, K15, K16, K28, K30, K34, K36: 1 and 1; K1,
// K11, K18,
// K24, K25, K26, K27, K31/K33, K32, K35: 2 and 1; K37: 2 and 2; K29: 4 and
// 2), so a warp
// reads or writes a row as one 4-, 8- or 16-byte word a lane, contiguous
// across the lanes.
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
// computes, so the loads stay off the chain (K4, K6, K16, K29, K31/K33,
// K34-K37; a read past the slot's rows takes its last row, unused).
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

// The serial warp's walk over the chunks (K4, K6, K16, K29, K31/K33, K34-K37;
// one CTA a tile): chunk q's input slot full and its output slot empty,
// rows(k, n) on slot k's n rows, then both released.
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
// 32-bit words, word w to plane w (K37: phase and frequency); kHalf (wout
// 1), one (t, c2) plane of each word's low 16 bits (K28: int16).
enum class Layout { kWide, kPlanes, kHalf };

// A depth-0 launch: d, the serial warp's rows (t), chunk and ring depth
// (with the DF1 warp, its state and coefficients too); y, the output
// planes (y[0] alone for kWide); the plan (filters/pipe_plan.py
// `pipe_plan`): `warps` warps a block, `producers` of them producers and
// the next one the store warp, the rest idle; cluster: 1, or 2 (a partner
// CTA a tile, all `warps` of it producers); vec: y's rows take 16-byte
// stores (each plane 16-byte aligned, its rows too; kHalf: c2 % 8 == 0).
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
// instruction a plane; kHalf: 4 threads a row of 8 lanes each, two lanes'
// low halves a word (`__byte_perm`), 8 rows an instruction), else each
// lane its own column (kHalf: a 2-byte store).
template <int Wout, Layout L>
__device__ __forceinline__ void store_warp(const Pipe& p, const Rings& R,
                                           const uint32_t* out, int lid,
                                           int col0) {
  constexpr int kRow = kLanes * Wout;  // words of a slot's row
  constexpr int kT = L == Layout::kWide    ? kRow / 4
                     : L == Layout::kPlanes ? kLanes / 4
                                            : kLanes / 8;
  const int chunk = p.d.chunk;
  const size_t c2 = static_cast<size_t>(p.c2);
  // kWide: word; kPlanes: lane of the row; kHalf: its lane / 2
  const int w4 = 4 * (lid % kT);
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
    } else if constexpr (L == Layout::kHalf) {
      static_assert(Wout == 1, "kHalf narrows one word a lane");
      uint16_t* yr = static_cast<uint16_t*>(p.y[0]) +
                     static_cast<size_t>(r0) * c2 + col0;
      const int l8 = 2 * w4;  // the first of this thread's 8 lanes
      if (p.vec) {
        if (col0 + l8 < p.c2)
          for (int r = lid / kT; r < rows; r += kLanes / kT) {
            const uint4 a = *reinterpret_cast<const uint4*>(s + r * kRow + l8);
            const uint4 b =
                *reinterpret_cast<const uint4*>(s + r * kRow + l8 + 4);
            *reinterpret_cast<uint4*>(yr + r * c2 + l8) = make_uint4(
                __byte_perm(a.x, a.y, 0x5410), __byte_perm(a.z, a.w, 0x5410),
                __byte_perm(b.x, b.y, 0x5410), __byte_perm(b.z, b.w, 0x5410));
          }
      } else if (col0 + lid < p.c2) {
        for (int r = 0; r < rows; ++r)
          yr[r * c2 + lid] = static_cast<uint16_t>(s[r * kRow + lid]);
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

// An output row's word: y's int32 bits, or (F32) y rounded to the nearest
// f32 (K1's plain version's cast), as bits.
template <bool F32>
__device__ __forceinline__ uint32_t out_word(uint32_t y) {
  if constexpr (F32) {
    return __float_as_uint(__int2float_rn(static_cast<int>(y)));
  } else {
    return y;
  }
}

// The store warp that keeps rows (K1, K11, K18, K26, K27 in df1_bank.cu;
// K4 in lowpass_bank.cu): each chunk's output slot (`out`: slot 0) to
// p.y[0]'s kept rows (every row when dec is 1), this tile's columns [col0,
// col0 + kLanes), as `out_word`s.  The kept rows of the chunk at r0 are
// its rows r with (r0 + r) % dec == 0, output row (r0 + r) / dec, so a
// chunk need not be a multiple of dec.  With p.vec, 16 bytes a thread: 8
// threads a row of 4 lanes each, 4 rows a warp instruction; else each lane
// its own column.
template <bool F32>
__device__ __forceinline__ void keep_store(const Pipe& p, int dec,
                                           const Rings& R,
                                           const uint32_t* out, int lid,
                                           int col0) {
  const int chunk = p.d.chunk;
  const size_t c2 = static_cast<size_t>(p.c2);
  const int w4 = 4 * (lid % 8);
  sm90::Cursor u;
  for (int r0 = 0; r0 < p.d.t; r0 += chunk, u.next(p.d.depth)) {
    const int rows = min(chunk, p.d.t - r0);
    sm90::mbar_wait(R.full_out(u.k), u.ph);
    const uint32_t* s = out + static_cast<size_t>(u.k) * chunk * kLanes;
    const int first = (dec - r0 % dec) % dec;  // the chunk's first kept row
    const int kept = first < rows ? (rows - 1 - first) / dec + 1 : 0;
    uint32_t* yr = static_cast<uint32_t*>(p.y[0]) +
                   static_cast<size_t>((r0 + first) / dec) * c2 + col0;
    if (p.vec) {
      if (col0 + w4 < p.c2)
        for (int j = lid / 8; j < kept; j += kLanes / 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              s + (first + j * dec) * kLanes + w4);
          *reinterpret_cast<uint4*>(yr + j * c2 + w4) =
              make_uint4(out_word<F32>(v.x), out_word<F32>(v.y),
                         out_word<F32>(v.z), out_word<F32>(v.w));
        }
    } else if (col0 + lid < p.c2) {
      for (int j = 0; j < kept; ++j)
        yr[j * c2 + lid] = out_word<F32>(s[(first + j * dec) * kLanes + lid]);
    }
    sm90::mbar_arrive(R.empty_out(u.k));
  }
}

// Rows [r, min(r + B, hi)) of the chunk at r0: a producer's batch.
struct Batch {
  int r0, r, hi;
};

// Producer pw of P's walk over its span of every chunk, rows [pw * span,
// (pw + 1) * span) (span = ceil(chunk / P)), in batches of B rows (K3, K4,
// K6, K12/K13, K16, K29, K31/K33, K34-K37): for each chunk its input slot
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

// Producers that copy x (K4: int32 in lowpass_bank.cu; K34: f32 in
// structures_bank.cu): producer pw of P's span of each chunk
// (`span_batches`), in batches of kCopyRows rows of xs (t, c2) loaded a
// batch ahead, each row's word into the input ring (this lane's column).
// A dead lane reads lane 0's words.
constexpr int kCopyRows = 16;
template <class T>
struct CopyRows {
  T x[kCopyRows];
};

template <class T>
__device__ __forceinline__ void copy_feed(const Pipe& p, const Rings& R,
                                          int pw, int lid, int lane,
                                          bool live, const T* xs) {
  const size_t c = static_cast<size_t>(p.c2);
  const T* xp = xs + (live ? lane : 0);
  span_batches<kCopyRows, CopyRows<T>>(
      p.d.t, p.d.chunk, p.d.depth, p.producers, pw, R,
      [&](const Batch& b, CopyRows<T>& n, const CopyRows<T>&, bool) {
        if (b.r0 >= p.d.t) return;
#pragma unroll
        for (int u = 0; u < kCopyRows; ++u)
          n.x[u] = __ldg(xp + static_cast<size_t>(
                                  b.r0 + min(b.r + u, b.hi - 1)) * c);
      },
      [&](const Batch& b, const CopyRows<T>& in, int slot) {
        T* s = reinterpret_cast<T*>(R.in_slot<1>(slot)) + lid;
#pragma unroll
        for (int u = 0; u < kCopyRows; ++u)
          if (b.r + u < b.hi) s[(b.r + u) * kLanes] = in.x[u];
      });
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

// A DF1 producer's rows (K1, K11, K18, K26, K27, K29, K31/K33, K35, K36):
// x[0], x[1] the two rows before a batch of B rows, x[v + 2] row v.
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
// b0 x0 + b1 x1 + b2 x2 mod 2^64 into the input ring as two 32-bit words
// (`put_w`); with Planes they take the lane's b0-b2 from the planes once.
constexpr int kWRows = 16;

// Batch b's rows' W into input slot `slot` (this lane's column), xv.x[v +
// 2] row v of the batch and xv.x[0], xv.x[1] the two rows before it.
template <int B>
__device__ __forceinline__ void put_w(const Rings& R, int slot, int lid,
                                      const Batch& b,
                                      const TapRows<int32_t, B>& xv,
                                      int32_t b0, int32_t b1, int32_t b2) {
  uint2* s = reinterpret_cast<uint2*>(R.in_slot<2>(slot)) + lid;
#pragma unroll
  for (int v = 0; v < B; ++v) {
    const uint64_t w = static_cast<uint64_t>(
        mad_wide(b0, xv.x[v + 2],
                 mad_wide(b1, xv.x[v + 1], mul_wide(b2, xv.x[v]))));
    if (b.r + v < b.hi)
      s[(b.r + v) * kLanes] = make_uint2(static_cast<uint32_t>(w),
                                         static_cast<uint32_t>(w >> 32));
  }
}

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
        put_w(R, slot, lid, b, xv, b0, b1, b2);
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

// ---- the f32 DF1 at depth 0 (K16, K30; K36's producers) -------------------

// The f32 producers of K30 and K36 (Args: p, xs, sx, sx_out as f32 rows):
// `tap_feed` in batches of kF32Rows rows, each row's (b0 x0 + b1 x1) + b2
// x2, each product and sum rounded on its own in the plain version's
// order (`__f*_rn`: no contraction), into the input ring (one f32 word a
// row and lane).  At kWRows (16) a batch, their loads set K36's pace
// (PERF.md §6).
constexpr int kF32Rows = 32;

template <class Args>
__device__ __forceinline__ void f32_feed(const Args& a, const Rings& R,
                                         int pw, int lid, int lane,
                                         bool live, float b0, float b1,
                                         float b2) {
  tap_feed<kF32Rows>(
      a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
      [&](const Batch& b, const TapRows<float, kF32Rows>& xv, int slot) {
        float* s = reinterpret_cast<float*>(R.in_slot<1>(slot)) + lid;
#pragma unroll
        for (int v = 0; v < kF32Rows; ++v) {
          const float w = __fadd_rn(__fadd_rn(__fmul_rn(b0, xv.x[v + 2]),
                                              __fmul_rn(b1, xv.x[v + 1])),
                                    __fmul_rn(b2, xv.x[v]));
          if (b.r + v < b.hi) s[(b.r + v) * kLanes] = w;
        }
      });
}

// The f32 DF1 serial warp of K16 and K30 (Args: p, sy, sy_out (lanes, 2)
// f32 and k, `Df1CoefsF32`): y1, y2 of its lane in registers; each row's W
// = (b0 x0 + b1 x1) + b2 x2 from the input ring, y0 = (W + a1 y1) + a2 y2
// into the output ring, a2 y2 formed a row ahead (y2 is the row before's
// y1), so that a1 y1's multiply and the two adds alone are on the chain:
// the plain `df1_process`'s roundings in its order, left to right.
template <class Args>
struct Df1F32Serial {
  const Args* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const float a1 = a->k.a1, a2 = a->k.a2;
    float y1 = 0.f, y2 = 0.f;
    if (live) {
      y1 = a->sy[2 * lane];
      y2 = a->sy[2 * lane + 1];
    }
    float v = __fmul_rn(a2, y2);  // the next row's a2 y2
    serial_chunks(p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
      const float* in = reinterpret_cast<const float*>(R.in_slot(slot)) + lid;
      float* o = reinterpret_cast<float*>(out) +
                 static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
      group_rows(
          rows, [&](int r) { return in[r * kLanes]; },
          [&](int r, float w) {
            const float y0 = __fadd_rn(__fadd_rn(w, __fmul_rn(a1, y1)), v);
            v = __fmul_rn(a2, y1);  // off the chain
            y2 = y1;
            y1 = y0;
            o[r * kLanes] = y0;
          });
    });
    if (live) {
      a->sy_out[2 * lane] = y1;
      a->sy_out[2 * lane + 1] = y2;
    }
  }
};

// ---- the wide DF1 at depth 0: int64 feedback words (K25, K32) -----------

// A launch of the wide DF1 (biquad_bank.cu): w's producers (`w_feed`), its
// plan, coefficients and clamp; the state's y as full int64 words (w.sy
// and w.sy_out unused).
struct WideArgs {
  Df1WArgs w;
  const int64_t* sy;
  int64_t* sy_out;
};

// add + split_mul(y, a), split_mul(y, a) = ((y_lo as u64 * a) >> 32) +
// y_hi * a (the wide DF1's product of a feedback word, biquad.rs:456-472),
// y_lo the unsigned low word, y_hi the signed high word, mod 2^64.  With A the unsigned reading of a, y_lo a =
// y_lo A - 2^32 y_lo [a < 0], so (y_lo a) >> 32 = umulhi(y_lo, A) - y_lo
// [a < 0]: one unsigned high multiply and a multiply-add of y_lo by neg
// (0, or -1 where a < 0, set once a launch).  It lies in int32, so 32-bit
// words hold it; it is sign-extended and added last, beside y_hi a's
// multiply-add onto add.
__device__ __forceinline__ uint64_t split_mul(uint64_t y, int32_t a,
                                              uint32_t neg, uint64_t add) {
  const uint32_t lo = static_cast<uint32_t>(y);
  const int32_t low = static_cast<int32_t>(
      __umulhi(lo, static_cast<uint32_t>(a)) + lo * neg);
  return static_cast<uint64_t>(mad_wide(static_cast<int32_t>(y >> 32), a,
                                        static_cast<int64_t>(add))) +
         static_cast<uint64_t>(static_cast<int64_t>(low));
}

// The wide serial warp (K25; K32 with Planes, a1 and a2 from the lane's
// planes): y1 and y2 of its lane as int64 feedback words in registers; each
// row's W from the input ring, y0 into the output ring.  V = W +
// split_mul(y2, a2) waits on no step of the row before (y2 is the row
// before's y1), so it is formed a row ahead, off the chain; on the chain
// are split_mul(y1, a1) onto V, the shift left by s = 32 - f (two funnel
// shifts: the new high word from (lo, hi), the new low word lo << s), y0
// the high word; clamped, clip(y0 + u, lo, hi) (df1.cuh `Df1Clamp`) is the
// output and replaces the high word of the fed-back word, its low word
// kept.  The sums wrap mod 2^64, so any order of the five terms gives the
// plain version's bits.  After the last row the serial warp writes y (c,
// 2) int64.
template <bool Clamp, bool Planes>
struct Df1WideSerial {
  const WideArgs* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->w.p;
    const size_t c = static_cast<size_t>(p.c2);
    const int ch = live ? lane : 0;
    int32_t a1 = a->w.k.a1, a2 = a->w.k.a2;
    if constexpr (Planes) {
      a1 = __ldg(a->w.planes + 3 * c + ch);
      a2 = __ldg(a->w.planes + 4 * c + ch);
    }
    const uint32_t n1 = a1 < 0 ? ~0u : 0u, n2 = a2 < 0 ? ~0u : 0u;
    const int sh = 32 - a->w.k.f;
    const Df1Clamp cl = a->w.cl;
    uint64_t y1 = 0, y2 = 0;
    if (live) {
      y1 = static_cast<uint64_t>(a->sy[2 * lane]);
      y2 = static_cast<uint64_t>(a->sy[2 * lane + 1]);
    }
    serial_chunks(p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
      const uint2* in =
          reinterpret_cast<const uint2*>(R.in_slot<2>(slot)) + lid;
      int32_t* o = reinterpret_cast<int32_t*>(out) +
                   static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
      group_rows(
          rows, [&](int r) { return in[r * kLanes]; },
          [&](int r, uint2 w) {
            const uint64_t v =  // off the chain
                split_mul(y2, a2, n2, uint64_t{w.y} << 32 | w.x);
            const uint64_t acc = split_mul(y1, a1, n1, v);
            const uint32_t lo = static_cast<uint32_t>(acc);
            uint32_t hi =
                __funnelshift_l(lo, static_cast<uint32_t>(acc >> 32), sh);
            if constexpr (Clamp)
              hi = static_cast<uint32_t>(cl(static_cast<int32_t>(hi)));
            y2 = y1;
            y1 = uint64_t{hi} << 32 | (lo << sh);
            o[r * kLanes] = static_cast<int32_t>(hi);
          });
    });
    if (live) {
      a->sy_out[2 * lane] = static_cast<int64_t>(y1);
      a->sy_out[2 * lane + 1] = static_cast<int64_t>(y2);
    }
  }
};

// ---- a chain of depth-0 blocks over a thread-block cluster (K24) ----------
//
// A tile is a chain of ranks over a cluster of `p.cluster` CTAs, each rank a
// depth-0 block of its own (`run_chain`): a CTA holds one rank, or two
// (`Halves` 2: their serial warps on schedulers 0 and 2, each with its own
// rings, producers and store warp).  Rank 0's producers read the tile's
// rows from device memory, every later rank's producers read its x ring,
// which the rank before's store warp fills with its serial warp's output
// rows (`peer_store`: `st.async` into a rank of another CTA, counted on the
// x slot's full barrier; plain shared stores into the other half of its
// own CTA); the last rank's store warp writes the rows to device memory.
// An x slot holds its chunk's rows behind two rows ahead, the chunk
// before's last two (the stage state's x2, x1 at chunk 0), so a producer's
// span needs no row of another slot (`x_feed`).  The rank before
// overwrites an x slot only after the rank's producers released it (an
// arrival of each of their threads on the rank before's x empty barrier),
// and only for the chunks it has still to fill, so no arrival reaches a
// CTA that has exited; a rank exits only after its producers saw its last
// x slot full, so no store reaches one either.

// The x ring of a chain rank: after the input and output rings, 16 bytes
// of mbarriers a slot (full: one arrival with the slot's bytes; empty: the
// next rank's producers' threads), then `depth` slots of chunk + 2 rows of
// kLanes int32 words.
struct XRing {
  uint32_t bars;
  int32_t* x;
  int chunk;

  __device__ uint32_t full(int k) const { return bars + 16 * k; }
  __device__ uint32_t empty(int k) const { return bars + 16 * k + 8; }
  __device__ int32_t* slot(int k) const {
    return x + static_cast<size_t>(k) * (chunk + 2) * kLanes;
  }
};

// Shared memory of a chain CTA: `halves` ranks of `pipe_smem` with two
// words a row and lane in and one out and, in a cluster of 2+ CTAs or a
// CTA of two ranks, the x ring.
__host__ __device__ inline size_t chain_smem(int chunk, int depth,
                                             int cluster, int halves = 1) {
  const size_t x =
      cluster > 1 || halves > 1
          ? static_cast<size_t>(depth) *
                (16 + static_cast<size_t>(chunk + 2) * kLanes * 4)
          : 0;
  return static_cast<size_t>(halves) * (pipe_smem(chunk, depth, 2, 1) + x);
}

// The warps of a chain CTA: at most 12 with one rank, so that a thread may
// hold 168 registers (a rank's stages' coefficients and state); at most 20
// with two ranks of one stage each (102 registers).
constexpr int kChainWarps = 12;
constexpr int kChainWarps2 = 20;

// Where a rank sits in the chain: its rank, its x ring, and the x rings of
// the rank before (whose empty barriers its producers arrive on) and of the
// next rank (which its store warp fills), each by the addresses of its own
// CTA (`*_cta`: that CTA's rank; `*_here`: this CTA).
struct ChainPos {
  int rank;
  XRing x, prev, next;
  uint32_t prev_cta, next_cta;
  bool prev_here, next_here;
};

// A chain CTA of `Halves` ranks of a chain of `ranks` (rank h of the CTA
// is chain rank cluster_rank * Halves + h): each rank's rings in its share
// of `smem`; its serial warp (warp 0, and warp 2 for the second) calling
// serial(R, out, lid, lane, live, rank), the other warps of those
// schedulers idle; of the rest, for each rank in turn, `producers` warps
// calling produce(R, pos, pw, lid, lane, live) and the next one store(R,
// pos, out, lid, col0); warps past those, and a rank past the chain's
// last, exit.  Every CTA initialises its barriers, and the cluster barrier
// publishes them before any rank stores into or arrives on another's.
template <int Halves, class Serial, class Produce, class Store>
__device__ __forceinline__ void run_chain(const Pipe& p, int ranks,
                                          unsigned char* smem, Serial serial,
                                          Produce produce, Store store) {
  const int warp = threadIdx.x / kLanes, lid = threadIdx.x % kLanes;
  const int col0 = blockIdx.x / p.cluster * kLanes, lane = col0 + lid;
  const bool live = lane < p.c2;  // dead lanes still reach every barrier
  const int depth = p.d.depth, chunk = p.d.chunk;
  const size_t share = chain_smem(chunk, depth, p.cluster, Halves) / Halves;
  auto rings = [&](int h) {
    unsigned char* b = smem + h * share;
    return Rings{sm90::smem_addr(b),
                 reinterpret_cast<int32_t*>(b + 32 * depth), chunk};
  };
  auto xring = [&](int h) {
    unsigned char* b = smem + h * share + pipe_smem(chunk, depth, 2, 1);
    return XRing{sm90::smem_addr(b),
                 reinterpret_cast<int32_t*>(b + 16 * depth), chunk};
  };
  const bool linked = p.cluster > 1 || Halves > 1;
  if (threadIdx.x == 0) {
    for (int h = 0; h < Halves; ++h) {
      init_rings(rings(h), depth, p.producers, 1);
      if (linked) {
        const XRing X = xring(h);
        for (int k = 0; k < depth; ++k) {
          sm90::mbar_init(X.full(k), 1);
          sm90::mbar_init(X.empty(k), kLanes * p.producers);
        }
      }
    }
    sm90::fence_barrier_init();
  }
  if (p.cluster > 1) {
    sm90::cluster_sync();  // every rank's barriers initialised
  } else {
    __syncthreads();
  }
  // this warp's rank of the CTA and its role: -1 serial, 0 .. producers - 1
  // a producer, producers the store warp
  int h, role;
  if constexpr (Halves == 1) {
    if (warp % 4 == 0 && warp > 0) return;  // the serial warp's scheduler
    h = 0;
    role = warp == 0 ? -1 : warp - warp / 4 - 1;
  } else {
    if (warp % 2 == 0 && warp > 2) return;  // the serial warps' schedulers
    if (warp == 0 || warp == 2) {
      h = warp / 2;
      role = -1;
    } else {
      const int w = warp / 4 * 2 + warp % 4 / 2;  // among the other warps
      h = w / (p.producers + 1);
      role = w % (p.producers + 1);
    }
  }
  if (h >= Halves || role > p.producers) return;
  const int cta = p.cluster > 1 ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int rank = cta * Halves + h;
  if (rank >= ranks) return;
  const Rings R = rings(h);
  uint32_t* out = reinterpret_cast<uint32_t*>(R.in_slot<2>(depth));
  if (role < 0) {
    serial(R, out, lid, lane, live, rank);
    return;
  }
  const int prev = rank - 1, next = rank + 1;
  const ChainPos pos{rank,
                     xring(h),
                     xring((prev + Halves) % Halves),
                     xring(next % Halves),
                     static_cast<uint32_t>(prev / Halves),
                     static_cast<uint32_t>(next / Halves),
                     prev / Halves == cta,
                     next / Halves == cta};
  if (role < p.producers) {
    produce(R, pos, role, lid, lane, live);
  } else {
    store(R, pos, out, lid, col0);
  }
}

// Producer pw of P's walk of a chain rank past 0: for each chunk its input
// slot empty and its x slot full, its span's rows r of the chunk -- x0, x1,
// x2 the slot's rows r + 2, r + 1, r -- in batches of B rows into W (`put_w`),
// one arrival on the input slot's full barrier, then one of each thread on
// the rank before's x empty barrier (`mbar_arrive_remote` into another CTA)
// for a chunk that rank has still to fill.  Producer 0 writes the rank's
// first stage's x state: block rows t - 1 and t - 2 (the last slot's rows
// n + 1 and n), or sx at t = 0.
template <int B>
__device__ __forceinline__ void x_feed(const Pipe& p, const Rings& R,
                                       const ChainPos& pos, int pw, int lid,
                                       int lane, bool live, int32_t b0,
                                       int32_t b1, int32_t b2,
                                       const int32_t* sx, int32_t* sx_out) {
  const int t = p.d.t, chunk = p.d.chunk, depth = p.d.depth;
  const int span = (chunk + p.producers - 1) / p.producers;
  const XRing& X = pos.x;
  const uint32_t up_empty = pos.prev_here
                                ? pos.prev.empty(0)
                                : sm90::map_rank(pos.prev.empty(0),
                                                 pos.prev_cta);
  int32_t x1 = 0, x2 = 0;
  if (live) {
    x1 = sx[2 * lane];
    x2 = sx[2 * lane + 1];
  }
  sm90::Cursor u;
  for (int r0 = 0; r0 < t; r0 += chunk, u.next(depth)) {
    const int rows = min(chunk, t - r0);
    const int lo = min(pw * span, rows), hi = min(lo + span, rows);
    sm90::mbar_wait(R.empty_in(u.k), u.ph ^ 1);
    sm90::mbar_wait_cluster(X.full(u.k), u.ph);
    const int32_t* xs = X.slot(u.k) + lid;
    for (int r = lo; r < hi; r += B) {
      TapRows<int32_t, B> xv;
#pragma unroll
      for (int v = 0; v < B + 2; ++v) xv.x[v] = xs[min(r + v, hi + 1) * kLanes];
      put_w(R, u.k, lid, Batch{r0, r, hi}, xv, b0, b1, b2);
    }
    if (r0 + rows >= t) {
      x1 = xs[(rows + 1) * kLanes];
      x2 = xs[rows * kLanes];
    }
    sm90::mbar_arrive(R.full_in(u.k));
    if (r0 + depth * chunk < t) {
      if (pos.prev_here) {
        sm90::mbar_arrive(up_empty + 16 * u.k);
      } else {
        sm90::mbar_arrive_remote(up_empty + 16 * u.k);
      }
    }
  }
  if (pw == 0 && live) {
    sx_out[2 * lane] = x1;
    sx_out[2 * lane + 1] = x2;
  }
}

// The store warp of a chain rank before the last: each chunk's output slot
// (`out`: slot 0) into the next rank's x slot once that is empty: rows 0
// and 1 the two rows before the chunk (x2, x1: the next rank's first
// stage's x state at chunk 0, then the chunk before's last two rows, a
// 4-byte store each a lane), rows 2 .. n + 1 the chunk's n rows, 16 bytes a
// thread (8 threads a row of 4 lanes each, 4 rows a warp instruction: the
// 4-byte form, a row an instruction, set the pace of a one-stage rank),
// then one arrival on the next rank's x full barrier (lane 0's, after every
// lane's stores were issued).  Into another CTA the stores are `st.async`s,
// counted on that barrier, whose arrival expects the slot's bytes; into
// this CTA's other rank, shared stores the arrival releases.
__device__ __forceinline__ void peer_store(const Pipe& p, const Rings& R,
                                           const ChainPos& pos,
                                           const uint32_t* out, int lid,
                                           int32_t x1, int32_t x2) {
  const int t = p.d.t, chunk = p.d.chunk, depth = p.d.depth;
  const bool here = pos.next_here;
  const uint32_t slot0 =
      here ? 0u
           : sm90::map_rank(sm90::smem_addr(pos.next.slot(0)), pos.next_cta);
  const uint32_t full0 =
      here ? pos.next.full(0) : sm90::map_rank(pos.next.full(0), pos.next_cta);
  const int w4 = 4 * (lid % 8);  // the first of this thread's 4 lanes
  sm90::Cursor u;
  for (int r0 = 0; r0 < t; r0 += chunk, u.next(depth)) {
    const int rows = min(chunk, t - r0);
    sm90::mbar_wait(R.full_out(u.k), u.ph);
    sm90::mbar_wait_cluster(pos.x.empty(u.k), u.ph ^ 1);
    const uint32_t full = full0 + 16 * u.k;
    const uint32_t* s = out + static_cast<size_t>(u.k) * chunk * kLanes;
    if (here) {
      int32_t* d = pos.next.slot(u.k);
      d[lid] = x2;
      d[kLanes + lid] = x1;
      for (int r = lid / 8; r < rows; r += kLanes / 8)
        *reinterpret_cast<uint4*>(d + (r + 2) * kLanes + w4) =
            *reinterpret_cast<const uint4*>(s + r * kLanes + w4);
    } else {
      const uint32_t dst = slot0 + 4 * u.k * (chunk + 2) * kLanes;
      sm90::store_to_peer32(dst + 4 * lid, static_cast<uint32_t>(x2), full);
      sm90::store_to_peer32(dst + 4 * (kLanes + lid),
                            static_cast<uint32_t>(x1), full);
      for (int r = lid / 8; r < rows; r += kLanes / 8)
        sm90::store_to_peer(
            dst + 4 * ((r + 2) * kLanes + w4),
            *reinterpret_cast<const uint4*>(s + r * kLanes + w4), full);
    }
    x2 = rows >= 2 ? static_cast<int32_t>(s[(rows - 2) * kLanes + lid]) : x1;
    x1 = static_cast<int32_t>(s[(rows - 1) * kLanes + lid]);
    sm90::mbar_arrive(R.empty_out(u.k));
    __syncwarp();
    if (lid == 0) {
      if (here) {
        sm90::mbar_arrive(full);
      } else {
        sm90::mbar_arrive_tx_remote(full, 4 * (rows + 2) * kLanes);
      }
    }
  }
}

}  // namespace ring
}  // namespace idsp
