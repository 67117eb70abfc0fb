// K15: the whole fixed-point FM receiver over a channel bank in one
// kernel: discriminator (late-quantized conjugate product, atan2, carrier
// subtract) and the Q<f> DF1 deemphasis biquad.
//
// Replaces the Pallas kernel of idsp_tpu/filters/fm_pallas.py
// `fm_disc_bank` (:93; `_fm_disc_bank_impl` :167, pallas_call :274) with
// its row helpers `_disc_rows` (:43, exact angle: `atan2_i32`,
// ddc_pallas.py:375) and `_disc_rows_fast` (:60, `atan2_f32_word`,
// ddc_pallas.py:412).  On the TPU each time chunk first ran the
// discriminator vectorized, in sub-chunks of 8 rows (the limb-emulated
// i64 products and atan2 spilled VMEM otherwise), into a VMEM scratch that
// a sequential DF1 loop then consumed.
//
// Per channel ch and row i (x = re + j im, b = the previous sample, from
// the carried state for row 0):
//
//   nim  = 0 - b.im                      (wraps in int32 BEFORE widening)
//   z.re = (a.re*b.re - a.im*nim) >> 32  (i64 products, wrapping sum,
//   z.im = (a.re*nim + a.im*b.re) >> 32   the high word)
//   dphi = atan2(z.im, z.re) - carrier   (wrapping), 0 on row 0 until the
//                                         stream's first sample has passed
//   y    = DF1(dphi)                     (df1.cuh, Q<f>)
//
// The sums a.re*b.re - a.im*nim reach 2^63 when every input is -2^31, so
// they are formed in uint64, where wrapping is defined, and the high word
// is read off the bits.  angle="fast" forms the product in f32
// (`__fmul_rn`, `__fadd_rn`, `__fsub_rn` in the plain version's order) and
// takes `atan2_f32_word`; the DF1 stays exact.
//
// What bounds it on the H100: the DF1 recurrence, serial in time in each
// channel: ~42 cycles a row for the DF1 warp of df1_ring.cuh (K20's pace,
// PERF.md §6); and the discriminator, ~100 integer instructions a row and
// channel for the exact angle (four 32 x 32 -> 64 products, the reciprocal
// and the polynomial of atan2), which a DF1 warp's pace leaves to the
// three other schedulers.  Memory: 8 B in and 4 B out per sample.
//
// What the design does about it: K3's pipeline at depth 0 (df1_ring.cuh
// `run_pipe`).  A block is one 32-channel tile; `producers` warps compute
// dphi into the input ring, each a contiguous span of every chunk's rows,
// so it loads each row once and keeps its previous one in registers (the
// row before its span too: one row more a span), kDisc rows' loads issued
// before their angles, the atan2 seed LUT in shared memory; the DF1 warp
// alone on its scheduler turns each slot into y's rows in the output ring;
// a store warp writes them out, 128 bytes a row.  The dphi plane
// never reaches device memory.  The plan (warps, roles, chunk, ring depth,
// shared memory) is the host's (filters/fm_cuda.py `disc_plan`), which the
// entry point checks.
//
// (Earlier versions, at c = 512, t = 32768 on the H100: one thread per
// channel with the discriminator as the `load` of seq_bank.cuh's
// `seq_rows`, 20.5 ms; the same thread computing 16 rows of
// discriminator, then 16 DF1 steps, 5.41 ms exact, 3.63 ms fast; a block
// of warp 0 the DF1 and three discriminator warps in lockstep, a
// `__syncthreads` a 96-row chunk, the DF1 warp storing its own rows, 2.833
// ms exact, 2.188 fast.)
#include <cuda_runtime.h>

#include <cstdint>

#include "atan2.cuh"
#include "atan2_f32.cuh"
#include "df1.cuh"
#include "df1_ring.cuh"
#include "seq_bank.cuh"  // wadd32

namespace {

using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;
using idsp::sm90::Cursor;
using idsp::sm90::map_rank;
using idsp::sm90::mbar_arrive;
using idsp::sm90::mbar_arrive_tx_remote;
using idsp::sm90::mbar_wait;
using idsp::sm90::mbar_wait_cluster;
using idsp::sm90::smem_addr;
using idsp::sm90::store_to_peer32;

// the high word of a wrapping 64-bit sum of two exact i32 x i32 products
__device__ __forceinline__ int32_t hi_word(uint64_t sum) {
  return static_cast<int32_t>(static_cast<uint32_t>(sum >> 32));
}

// dphi of one row: z = a * conj(b), arg(z) - carrier
template <bool Fast>
__device__ __forceinline__ int32_t disc(int32_t a_re, int32_t a_im,
                                        int32_t b_re, int32_t b_im,
                                        int32_t carrier,
                                        const idsp::atan2_detail::SharedLut&
                                            lut) {
  int32_t angle;
  if constexpr (Fast) {
    const float ar = static_cast<float>(a_re);
    const float ai = static_cast<float>(a_im);
    const float br = static_cast<float>(b_re);
    const float bi = static_cast<float>(b_im);
    const float z_re = __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
    const float z_im = __fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bi));
    angle = idsp::atan2_f32_word(z_im, z_re);
  } else {
    const int32_t nim =
        static_cast<int32_t>(0u - static_cast<uint32_t>(b_im));
    const int32_t z_re =
        hi_word(static_cast<uint64_t>(idsp::mul_wide(a_re, b_re)) -
                static_cast<uint64_t>(idsp::mul_wide(a_im, nim)));
    const int32_t z_im = hi_word(static_cast<uint64_t>(
        idsp::mad_wide(a_re, nim, idsp::mul_wide(a_im, b_re))));
    angle = idsp::atan2_i32(z_im, z_re, lut);
  }
  return idsp::wadd32(angle, static_cast<int32_t>(
                                 0u - static_cast<uint32_t>(carrier)));
}

struct DiscArgs {
  Pipe p;
  const int32_t *re, *im, *prev_re, *prev_im;
  const uint8_t* prev_valid;
  int32_t *prev_re_out, *prev_im_out;
  uint8_t* valid_out;
  int32_t carrier;
};

// Producer pw of P (the home CTA's producers, then with a cluster of 2 the
// partner CTA's warps): rows [pw * span, (pw + 1) * span) of each chunk
// (span = ceil(chunk / P)) into the input ring, in batches of kDisc rows, the
// next batch's rows -- the next chunk's first batch too -- loaded while a
// batch computes, so the loads' latency stays off the producer's time.
// Each batch loads its rows (a row past the span re-reads the span's
// last) and takes the row before it from the batch before, in registers;
// a span's first batch loads that row too, row 0 of the stream pairing
// with the carried sample and masked to 0 until a first sample has
// passed.  Every row of a batch is computed, so its angles are
// straight-line code that schedules together (row by row was slower for
// both angles on the H100, PERF.md §6).  A partner's warp (remote) waits
// for its own copy of the slot's empty barrier, which the home DF1 warp
// arrives on, stores its rows into the home slot with `st.async` counted
// on the home full barrier, and arrives there once with their bytes.
// Producer 0 also writes the carried sample out.
constexpr int kDisc = 8;
template <bool Fast>
__device__ __forceinline__ void discriminate(
    const DiscArgs& a, const Rings& R,
    const idsp::atan2_detail::SharedLut& lut, int pw, int lid, int lane,
    bool live, bool remote) {
  const Pipe& p = a.p;
  const int t = p.d.t, chunk = p.d.chunk;
  const int P = p.producers + (p.cluster > 1 ? p.warps : 0);
  const int span = (chunk + P - 1) / P;
  const size_t c = static_cast<size_t>(p.c2);
  const int ch = live ? lane : 0;  // dead lanes read channel 0's words
  const int32_t* rp = a.re + ch;
  const int32_t* ip = a.im + ch;
  auto row = [&](int i) {
    const size_t o = static_cast<size_t>(i) * c;
    return make_int2(__ldg(rp + o), __ldg(ip + o));
  };
  const int2 prev0 = make_int2(a.prev_re[ch], a.prev_im[ch]);
  const bool valid = a.prev_valid[ch] != 0;
  // a batch: rows [r, min(r + kDisc, hi)) of the chunk at r0
  struct Batch {
    int r0, r, hi;
  };
  auto first = [&](int r0) {  // this producer's first non-empty batch
    for (;; r0 += chunk) {
      const int rows = min(chunk, t - r0);
      const int lo = min(pw * span, rows);
      if (r0 >= t || lo < min(lo + span, rows))
        return Batch{r0, lo, min(lo + span, rows)};
    }
  };
  auto next = [&](const Batch& b) {
    return b.r + kDisc < b.hi ? Batch{b.r0, b.r + kDisc, b.hi}
                              : first(b.r0 + chunk);
  };
  // av[0] the row before batch b (`before` where the batch before was of
  // the same span), av[v + 1] its row v
  auto load = [&](const Batch& b, int2 (&av)[kDisc + 1], bool same,
                  int2 before) {
    if (b.r0 >= t) return;
    const int g = b.r0 + b.r;
    av[0] = same ? before : g == 0 ? prev0 : row(g - 1);
#pragma unroll
    for (int v = 0; v < kDisc; ++v)
      av[v + 1] = row(b.r0 + min(b.r + v, b.hi - 1));
  };
  Batch cur = first(0);
  int2 av[kDisc + 1];
  load(cur, av, false, int2{});
  Cursor u;
  for (int r0 = 0; r0 < t; r0 += chunk, u.next(p.d.depth)) {
    int32_t* s = R.in_slot(u.k) + lid;
    uint32_t home_s = 0, home_full = 0, bytes = 0;
    if (remote) {
      mbar_wait_cluster(R.empty_in(u.k), u.ph ^ 1);
      home_s = map_rank(smem_addr(s), 0);
      home_full = map_rank(R.full_in(u.k), 0);
    } else {
      mbar_wait(R.empty_in(u.k), u.ph ^ 1);
    }
    for (; cur.r0 == r0; ) {
      const Batch nb = next(cur);
      int2 nv[kDisc + 1];
      load(nb, nv, nb.r0 == cur.r0, av[kDisc]);
      auto put = [&](int v, int32_t d) {
        const int32_t w = r0 + cur.r + v == 0 && !valid ? 0 : d;
        if (remote) {
          store_to_peer32(home_s + 4 * (cur.r + v) * kLanes,
                          static_cast<uint32_t>(w), home_full);
          bytes += 4 * kLanes;
        } else {
          s[(cur.r + v) * kLanes] = w;
        }
      };
      int32_t d[kDisc];
#pragma unroll
      for (int v = 0; v < kDisc; ++v)
        d[v] = disc<Fast>(av[v + 1].x, av[v + 1].y, av[v].x, av[v].y,
                          a.carrier, lut);
#pragma unroll
      for (int v = 0; v < kDisc; ++v)
        if (cur.r + v < cur.hi) put(v, d[v]);
      cur = nb;
#pragma unroll
      for (int v = 0; v <= kDisc; ++v) av[v] = nv[v];
    }
    if (!remote) {
      mbar_arrive(R.full_in(u.k));
    } else {
      // one arrival a warp, with its 32 lanes' bytes: every lane has
      // passed this chunk's wait first, so none can lag a phase behind
      // (a span may be empty, and then nothing else holds a lane back)
      __syncwarp();
      if (lid == 0) mbar_arrive_tx_remote(home_full, bytes);
    }
  }
  if (pw == 0 && live) {
    const int2 last = row(t - 1);
    a.prev_re_out[ch] = last.x;
    a.prev_im_out[ch] = last.y;
    a.valid_out[ch] = 1;
  }
}

template <bool Fast>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    fm_disc_kernel(const __grid_constant__ DiscArgs a) {
  __shared__ uint32_t lut_base[16];
  __shared__ int32_t lut_slope[16];
  extern __shared__ __align__(16) unsigned char smem[];
  // published by run_pipe's barrier
  const auto lut = idsp::load_atan2_lut(lut_base, lut_slope);
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::ring::Df1Serial<int32_t>{&a.p.d},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool remote) {
        discriminate<Fast>(a, R, lut, pw, lid, lane, live, remote);
      });
}

}  // namespace

// re, im (t, c) i32 -> ys (t, c) i32; state: prev_re, prev_im (c,) i32,
// prev_valid (c,) bool (one byte), DF1 x/y (c, 2) i32, each in and out.
// angle_fast: 0 the exact atan2, 1 the f32 angle.  t >= 1.  warps,
// producers, cluster (CTAs a tile: 1, or 2 with a partner CTA of
// producers), chunk, ring (slots a ring) and smem are the host plan's
// (filters/fm_cuda.py `disc_plan`); a plan the kernel cannot run
// (smem not its own sum, or more than a block may have) is refused.  A
// refused call launches nothing and leaves no CUDA error pending.
extern "C" int idsp_fm_disc_bank(const void* re, const void* im,
                                 const void* prev_re, const void* prev_im,
                                 const void* prev_valid, const void* sx,
                                 const void* sy, void* prev_re_out,
                                 void* prev_im_out, void* valid_out,
                                 void* sx_out, void* sy_out, void* ys, int t,
                                 int c, int carrier, int angle_fast, int f,
                                 int b0, int b1, int b2, int a1, int a2,
                                 int warps, int producers, int cluster,
                                 int chunk, int ring, int smem,
                                 void* stream) {
  if (t < 1 || f <= 0 || f >= 64 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem,
                                cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  DiscArgs a{};
  a.p.d = idsp::ring::Df1Ring{t,
                              chunk,
                              ring,
                              static_cast<const int32_t*>(sx),
                              static_cast<const int32_t*>(sy),
                              static_cast<int32_t*>(sx_out),
                              static_cast<int32_t*>(sy_out),
                              idsp::Df1Coefs{b0, b1, b2, a1, a2, f},
                              idsp::Df1Clamp{}};
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = cluster;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.re = static_cast<const int32_t*>(re);
  a.im = static_cast<const int32_t*>(im);
  a.prev_re = static_cast<const int32_t*>(prev_re);
  a.prev_im = static_cast<const int32_t*>(prev_im);
  a.prev_valid = static_cast<const uint8_t*>(prev_valid);
  a.prev_re_out = static_cast<int32_t*>(prev_re_out);
  a.prev_im_out = static_cast<int32_t*>(prev_im_out);
  a.valid_out = static_cast<uint8_t*>(valid_out);
  a.carrier = carrier;
  return angle_fast ? idsp::ring::launch_pipe(fm_disc_kernel<true>, a, a.p,
                                              smem, stream)
                    : idsp::ring::launch_pipe(fm_disc_kernel<false>, a, a.p,
                                              smem, stream);
}
