// K28-K31 and K33: the rest of the reference's DF1 precision ladder over
// a bank of lanes.  K28 runs Q16 (int16 storage, 32-bit sums), K29 Q64
// (int64 storage, 128-bit sums), K30 the f32 DF1, K31 the error-feedback
// (dither) DF1, optionally clamped, and K33 is K31 with runtime
// coefficients ((5, c) planes: a shared (5,) set broadcast, or one set a
// lane, as K26/K27).  K32, K25 with runtime coefficients, is in
// biquad_bank.cu beside K25.
//
// Replaces the Pallas kernels of idsp_tpu/filters/biquad_pallas.py
// `df1_bank_q16` (:1352, body :1393-1402), `df1_bank_q64` (:1250),
// `df1_bank_f32` (:98), `df1_dither_bank` (:872, body `_dither_body`
// :856) and `df1_dither_bank_coef` (:1104), all `_seq_bank_kernel` (:471)
// run by `_bank_call` (:395, pallas_call :453).  The TPU had no 64-bit
// integers: Q64 kept each int64 as two 32-bit limbs and the 128-bit sum
// as four, built from 16-bit limb products (:1166-1248), and the dither
// step emulated its 64-bit sum in 16-bit limbs too.  Here Q64's products
// are 32 x 32 -> 64 multiplies of 32-bit limbs (`df1.cuh` `mac_q64`), the
// dither sum native int64, and Q16 runs on 32-bit integers as the
// reference's accumulator does.
//
// What bounds them on the H100: the recurrence, as K1 (df1_bank.cu): y0
// of a step feeds the next step's products, one lane a serial chain.  Per
// sample the bytes are 2 B in and out (K28), 8 B (K29), 4 B (K30, K31,
// K33).  K29's chain is the longest: a 64 x 64 -> 128-bit product, its
// column sums and the funnel shift sit on it.  K30 rounds every product
// and sum on its own (`__fmul_rn`, `__fadd_rn`, in the plain version's
// order), so nvcc cannot contract them into FMAs: bit-identical to the
// plain `df1_process`.
//
// What the design does: all five run on df1_ring.cuh's depth-0 pipeline, a
// block a 32-lane tile: producer warps, each a span of
// every chunk, form each row's feed-forward sum W = b0 x0 + b1 x1 + b2 x2
// (rows 0 and 1 of a block take x1, x2 from the state, every other row its
// predecessors from xs, so spans are independent) into the input ring; the
// serial warp, alone on its scheduler, holds the feedback state, adds a2
// y2 a row ahead (off the chain) and runs the chain from shared memory
// into the output ring; the store warp writes the rows.  K29: W mod 2^128
// as four 32-bit limbs (`df1.cuh` `mac_q64`), the chain a1 y1 and two
// funnel shifts, int64 rows, 16 bytes a thread where c is even.  K31/K33:
// W mod 2^64 as two words (K33's producers read the lane's b0-b2 planes
// once, its serial warp a1 and a2); on the chain V + e, the multiply-add
// of a1 y1 onto it, one funnel shift (y, bits [f, f + 32) of the sum) and
// the clamp if any, e the sum's low f bits beside it; int32 rows, 16 bytes a
// thread where c % 4 == 0.  K28: W mod 2^32 as one int32 word, each
// product the int32 coefficient times the sign-extended int16 row
// (`tap_feed` over int16 rows); the serial warp holds y1, y2 sign-extended,
// adds a2 y2 a row ahead and on the chain runs a1 y1's multiply-add and one
// arithmetic shift (`q16_y0`): the entry scales every coefficient by 2^s,
// s = max(16 - f, 0), so the shift by f + s leaves bits [f, f + 16) of the
// sum sign-extended from bit f + 15, the plain step's wrap to int16, with
// no narrowing op on the chain (for f >= 16, sum >> f lies in int16
// already).  The output ring stays in 32-bit words (`pipe_smem` and the
// plans count words, and the serial warp holds each y0 as one) and the
// store warp writes their low halves (`Layout::kHalf`: two lanes a word,
// 16 bytes a thread where c % 8 == 0), so ys keeps 2 bytes a sample.  K30:
// K36's producers (`f32_feed`) and K16's serial warp (`Df1F32Serial`),
// each product and sum rounded on its own in the plain version's order;
// 16 bytes a thread where c % 4 == 0.  The producers' walk (`tap_feed`),
// K31/K33's W (`w_feed`) and serial warp (`Df1WSerial` with its dither
// flag) are df1_ring.cuh's, shared with K1, K11, K18, K26 and K27
// (df1_bank.cu), which are the same DF1 without e.  The integer sums wrap
// (mod 2^128, 2^64, 2^32), so the splits are bit-identical to the plain
// `df1_process_q64`, `df1_dither_process` and `df1_process_q` at int16.
// The plans (warps, producers, chunk, ring depth, shared memory) are the
// host's (filters/biquad_cuda.py `q16_plan`, `q64_plan`, `f32_plan`,
// `dither_plan`), which the entry points check.
#include <cuda_runtime.h>

#include <cstdint>

#include "df1.cuh"
#include "df1_ring.cuh"

namespace {

using idsp::Q64Coef;
using idsp::mac_q64;
using idsp::ring::Batch;
using idsp::ring::Df1WArgs;
using idsp::ring::kLanes;
using idsp::ring::Pipe;
using idsp::ring::Rings;
using idsp::ring::TapRows;

// K28: a launch; p.d holds the rows, chunk and ring depth (no DF1), p.y
// the (t, c) int16 output.  b0-a2 are the coefficients times 2^s mod 2^32,
// sh = f + s (s = max(16 - f, 0)).
struct Q16Args {
  Pipe p;
  const int16_t* xs;
  const int16_t *sx, *sy;
  int16_t *sx_out, *sy_out;
  uint32_t b0, b1, b2, a1, a2;
  int sh;
};

// K28's producers: `tap_feed` over int16 rows in batches of kQ16Rows, each
// row's W = b0 x0 + b1 x1 + b2 x2 mod 2^32 into the input ring (one word a
// row and lane).
constexpr int kQ16Rows = 32;

__device__ __forceinline__ uint32_t q16_mul(uint32_t b, int16_t x) {
  return b * static_cast<uint32_t>(static_cast<int32_t>(x));
}

__device__ __forceinline__ void q16_feed(const Q16Args& a, const Rings& R,
                                         int pw, int lid, int lane,
                                         bool live) {
  idsp::ring::tap_feed<kQ16Rows>(
      a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
      [&](const Batch& b, const TapRows<int16_t, kQ16Rows>& xv, int slot) {
        uint32_t* s = reinterpret_cast<uint32_t*>(R.in_slot<1>(slot)) + lid;
#pragma unroll
        for (int v = 0; v < kQ16Rows; ++v) {
          const uint32_t w = q16_mul(a.b0, xv.x[v + 2]) +
                             q16_mul(a.b1, xv.x[v + 1]) +
                             q16_mul(a.b2, xv.x[v]);
          if (b.r + v < b.hi) s[(b.r + v) * kLanes] = w;
        }
      });
}

// a * b + c mod 2^32, one `mad.lo.u32` the compiler's front end cannot
// regroup: written as C++, V = W + a2 y2 and V + a1 y1 came out as (a1 y1
// + a2 y2) + W, an IMAD, an add of W and the shift on the chain (PERF.md
// §6).
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// y0 of the sum acc (times 2^s, mod 2^32): the arithmetic shift by sh = f
// + s, bits [f, f + 16) of the unscaled sum sign-extended, the plain
// step's int16 wrap of (int32)sum >> f, held sign-extended.
__device__ __forceinline__ int32_t q16_y0(uint32_t acc, int sh) {
  return static_cast<int32_t>(acc) >> sh;
}

// The serial warp: y1, y2 of its lane sign-extended in registers; each
// row's W from the input ring, V = W + a2 y2 formed a row ahead (y2 is the
// row before's y1), off the chain; on the chain V + a1 y1's multiply-add
// and the shift (`q16_y0`); y0's word into the output ring.
struct Q16Serial {
  const Q16Args* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const uint32_t a1 = a->a1, a2 = a->a2;
    const int sh = a->sh;
    int32_t y1 = 0, y2 = 0;
    if (live) {
      y1 = a->sy[2 * lane];
      y2 = a->sy[2 * lane + 1];
    }
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const uint32_t* in =
              reinterpret_cast<const uint32_t*>(R.in_slot<1>(slot)) + lid;
          int32_t* o = reinterpret_cast<int32_t*>(out) +
                       static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, uint32_t w) {
                const uint32_t v =  // off the chain
                    mad_lo(a2, static_cast<uint32_t>(y2), w);
                const int32_t y0 =
                    q16_y0(mad_lo(a1, static_cast<uint32_t>(y1), v), sh);
                y2 = y1;
                y1 = y0;
                o[r * kLanes] = y0;
              });
        });
    if (live) {
      a->sy_out[2 * lane] = static_cast<int16_t>(y1);
      a->sy_out[2 * lane + 1] = static_cast<int16_t>(y2);
    }
  }
};

__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_q16_kernel(const __grid_constant__ Q16Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kHalf>(
      a.p, smem, Q16Serial{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        q16_feed(a, R, pw, lid, lane, live);  // one CTA a tile
      });
}

// K30: a launch; p.d holds the rows, chunk and ring depth (no DF1), p.y
// the (t, c) f32 output.
struct F32Args {
  Pipe p;
  const float* xs;
  const float *sx, *sy;
  float *sx_out, *sy_out;
  idsp::Df1CoefsF32 k;
};

__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_f32_kernel(const __grid_constant__ F32Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<1, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::ring::Df1F32Serial<F32Args>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile; producer 0 writes x = [x1, x2] out
        idsp::ring::f32_feed(a, R, pw, lid, lane, live, a.k.b0, a.k.b1,
                             a.k.b2);
      });
}

// The launch fields K28-K30 share (the pipeline's, the rows and the
// state), vec: 16-byte rows where c % vec_lanes == 0.
template <class Args, class T>
Args typed_args(const void* xs, void* ys, const void* sx, const void* sy,
                void* sx_out, void* sy_out, int t, int c, int warps,
                int producers, int chunk, int ring, int vec_lanes) {
  Args a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % vec_lanes == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const T*>(xs);
  a.sx = static_cast<const T*>(sx);
  a.sy = static_cast<const T*>(sy);
  a.sx_out = static_cast<T*>(sx_out);
  a.sy_out = static_cast<T*>(sy_out);
  return a;
}

// K29: a launch; p.d holds the rows, chunk and ring depth (no DF1), p.y
// the (t, c) int64 output.
struct Q64Args {
  Pipe p;
  const int64_t* xs;
  const int64_t *sx, *sy;
  int64_t *sx_out, *sy_out;
  Q64Coef b0, b1, b2, a1, a2;
  int f;
};

// K29's producers: `tap_feed` in batches of kQ64 rows, each row's sum b0
// x0 + b1 x1 + b2 x2 mod 2^128 into the input ring as four 32-bit limbs.
constexpr int kQ64 = 8;

__device__ __forceinline__ void q64_feed(const Q64Args& a, const Rings& R,
                                         int pw, int lid, int lane,
                                         bool live) {
  idsp::ring::tap_feed<kQ64>(
      a.p, R, pw, lane, live, a.xs, a.sx, a.sx_out,
      [&](const Batch& b, const TapRows<int64_t, kQ64>& xv, int slot) {
        uint4* s = reinterpret_cast<uint4*>(R.in_slot<4>(slot)) + lid;
        uint4 w[kQ64];
#pragma unroll
        for (int v = 0; v < kQ64; ++v) {
          uint64_t lo = 0, hi = 0;
          mac_q64(lo, hi, a.b0, static_cast<uint64_t>(xv.x[v + 2]));
          mac_q64(lo, hi, a.b1, static_cast<uint64_t>(xv.x[v + 1]));
          mac_q64(lo, hi, a.b2, static_cast<uint64_t>(xv.x[v]));
          w[v] = make_uint4(static_cast<uint32_t>(lo),
                            static_cast<uint32_t>(lo >> 32),
                            static_cast<uint32_t>(hi),
                            static_cast<uint32_t>(hi >> 32));
        }
#pragma unroll
        for (int v = 0; v < kQ64; ++v)
          if (b.r + v < b.hi) s[(b.r + v) * kLanes] = w[v];
      });
}

// The chain's step: the low 64 bits of ((hi:lo) + c y) >> (32 + sh), 0 <
// sh < 32 -- `mac_q64`'s sums, ordered for the chain: y's words pass the
// four products (lo's words and hi their addends), then the middle column
// m and, beside it, the high columns less the correction, then their sum
// with m's carry, then two funnel shifts (y0 is bits 32 + sh .. 95 + sh of
// the sum; the low word only carries into it).
__device__ __forceinline__ uint64_t q64_y0(uint64_t lo, uint64_t hi,
                                           const Q64Coef& c, uint64_t y,
                                           int sh) {
  const uint32_t yl = static_cast<uint32_t>(y);
  const uint32_t yh = static_cast<uint32_t>(y >> 32);
  const uint32_t cl = static_cast<uint32_t>(c.bits);
  const uint32_t ch = static_cast<uint32_t>(c.bits >> 32);
  const uint64_t p00 = idsp::mad_wide_u32(yl, cl, static_cast<uint32_t>(lo));
  const uint64_t p01 = idsp::mad_wide_u32(yl, ch, lo >> 32);
  const uint64_t p10 = idsp::mul_wide_u32(yh, cl);
  const uint64_t p11 = idsp::mad_wide_u32(yh, ch, hi);
  const uint64_t sign = static_cast<uint64_t>(static_cast<int64_t>(y) >> 63);
  const uint64_t corr = (c.bits & sign) + (y & c.neg);
  const uint64_t m = (p00 >> 32) + static_cast<uint32_t>(p01) +
                     static_cast<uint32_t>(p10);
  const uint64_t x = p11 + (p01 >> 32) + (p10 >> 32) - corr;
  const uint64_t h = x + (m >> 32);
  const uint32_t l = __funnelshift_r(static_cast<uint32_t>(m),
                                     static_cast<uint32_t>(h), sh);
  const uint32_t u = __funnelshift_r(static_cast<uint32_t>(h),
                                     static_cast<uint32_t>(h >> 32), sh);
  return uint64_t{u} << 32 | l;
}

// The serial warp: y1, y2 of its lane in registers; each row's sum W from
// the input ring, y0 = the low 64 bits of (W + a2 y2 + a1 y1) >> f into
// the output ring.  W + a2 y2 waits on no step of the row before, so the
// chain holds a1 y1's limb products, its column sums and the two funnel
// shifts (`q64_y0`, 32 < f < 64).
struct Q64Serial {
  const Q64Args* a;

  __device__ __forceinline__ void operator()(const Rings& R, uint32_t* out,
                                             int lid, int lane, bool live,
                                             uint32_t) const {
    const Pipe& p = a->p;
    const Q64Coef a1 = a->a1, a2 = a->a2;
    const int sh = a->f - 32;
    uint64_t y1 = 0, y2 = 0;
    if (live) {
      y1 = static_cast<uint64_t>(a->sy[2 * lane]);
      y2 = static_cast<uint64_t>(a->sy[2 * lane + 1]);
    }
    idsp::ring::serial_chunks(
        p.d.t, p.d.chunk, p.d.depth, R, [&](int slot, int rows) {
          const uint4* in =
              reinterpret_cast<const uint4*>(R.in_slot<4>(slot)) + lid;
          uint2* o = reinterpret_cast<uint2*>(out) +
                     static_cast<size_t>(slot) * p.d.chunk * kLanes + lid;
          idsp::ring::group_rows(
              rows, [&](int r) { return in[r * kLanes]; },
              [&](int r, uint4 w) {
                uint64_t lo = uint64_t{w.y} << 32 | w.x;
                uint64_t hi = uint64_t{w.w} << 32 | w.z;
                mac_q64(lo, hi, a2, y2);  // off the chain
                y2 = y1;
                y1 = q64_y0(lo, hi, a1, y1, sh);
                o[r * kLanes] = make_uint2(static_cast<uint32_t>(y1),
                                           static_cast<uint32_t>(y1 >> 32));
              });
        });
    if (live) {
      a->sy_out[2 * lane] = static_cast<int64_t>(y1);
      a->sy_out[2 * lane + 1] = static_cast<int64_t>(y2);
    }
  }
};

__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_q64_kernel(const __grid_constant__ Q64Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<4, 2, idsp::ring::Layout::kWide>(
      a.p, smem, Q64Serial{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        q64_feed(a, R, pw, lid, lane, live);  // one CTA a tile
      });
}

template <bool Clamp, bool Planes>
__global__ void __launch_bounds__(kLanes* idsp::ring::kMaxWarps)
    df1_dither_kernel(const __grid_constant__ Df1WArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  idsp::ring::run_pipe<2, 1, idsp::ring::Layout::kWide>(
      a.p, smem, idsp::ring::Df1WSerial<true, Clamp, Planes>{&a},
      [&](const Rings& R, int pw, int lid, int lane, bool live, bool) {
        // one CTA a tile
        idsp::ring::w_feed<Planes>(a, R, pw, lid, lane, live);
      });
}

// K31 (planes null) or K33: checks the plan, then launches the instance
// of the clamp and the coefficients' source.
int launch_dither(const void* xs, void* ys, const void* sx, const void* sy,
                  const void* se, void* sx_out, void* sy_out, void* se_out,
                  const void* planes, int t, int c, const idsp::Df1Coefs& k,
                  int clamp, const idsp::Df1Clamp& cl, int warps,
                  int producers, int chunk, int ring, int smem,
                  void* stream) {
  if (k.f <= 0 || k.f > 32 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                2, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Df1WArgs a{};
  a.p.d.t = t;
  a.p.d.chunk = chunk;
  a.p.d.depth = ring;
  a.p.y[0] = ys;
  a.p.c2 = c;
  a.p.warps = warps;
  a.p.producers = producers;
  a.p.cluster = 1;
  a.p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  a.xs = static_cast<const int32_t*>(xs);
  a.sx = static_cast<const int32_t*>(sx);
  a.sy = static_cast<const int32_t*>(sy);
  a.se = static_cast<const int64_t*>(se);
  a.sx_out = static_cast<int32_t*>(sx_out);
  a.sy_out = static_cast<int32_t*>(sy_out);
  a.se_out = static_cast<int64_t*>(se_out);
  a.planes = static_cast<const int32_t*>(planes);
  a.k = k;
  a.cl = cl;
  a.emask = k.f == 32 ? 0xFFFFFFFFu : (1u << k.f) - 1;
  using idsp::ring::launch_pipe;
  if (planes) {
    return clamp ? launch_pipe(df1_dither_kernel<true, true>, a, a.p, smem,
                               stream)
                 : launch_pipe(df1_dither_kernel<false, true>, a, a.p, smem,
                               stream);
  }
  return clamp ? launch_pipe(df1_dither_kernel<true, false>, a, a.p, smem,
                             stream)
               : launch_pipe(df1_dither_kernel<false, false>, a, a.p, smem,
                             stream);
}


}  // namespace

// K28: xs (t, c) i16 -> ys (t, c) i16; state (c, 2) i16 x2 in and out;
// 0 < f < 32; the coefficients int16 values in int words (any int word
// gives the plain version's sum mod 2^32).  warps, producers, chunk, ring
// (slots a ring) and smem are the host plan's (filters/biquad_cuda.py
// `q16_plan`: one word a row and lane each way); a plan the kernel cannot
// run is refused.  A refused call launches nothing and leaves no CUDA
// error pending.
extern "C" int idsp_df1_bank_q16(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, int f, int b0, int b1, int b2,
                                 int a1, int a2, int warps, int producers,
                                 int chunk, int ring, int smem,
                                 void* stream) {
  if (f <= 0 || f >= 32 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  Q16Args a = typed_args<Q16Args, int16_t>(xs, ys, sx, sy, sx_out, sy_out, t,
                                           c, warps, producers, chunk, ring,
                                           8);
  const int s = f < 16 ? 16 - f : 0;
  a.b0 = static_cast<uint32_t>(b0) << s;
  a.b1 = static_cast<uint32_t>(b1) << s;
  a.b2 = static_cast<uint32_t>(b2) << s;
  a.a1 = static_cast<uint32_t>(a1) << s;
  a.a2 = static_cast<uint32_t>(a2) << s;
  a.sh = f + s;
  return idsp::ring::launch_pipe(df1_q16_kernel, a, a.p, smem, stream);
}

// K29: xs (t, c) i64 -> ys (t, c) i64; state (c, 2) i64 x2 in and out;
// 32 < f < 64 (the JAX kernel's domain).  warps, producers, chunk, ring
// (slots a ring) and smem are the host plan's (filters/biquad_cuda.py
// `q64_plan`); a plan the kernel cannot run is refused.  A refused call
// launches nothing and leaves no CUDA error pending.
extern "C" int idsp_df1_bank_q64(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, int f, long long b0,
                                 long long b1, long long b2, long long a1,
                                 long long a2, int warps, int producers,
                                 int chunk, int ring, int smem,
                                 void* stream) {
  if (f <= 32 || f >= 64 ||
      !idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem, 1,
                                4, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Q64Args a = typed_args<Q64Args, int64_t>(xs, ys, sx, sy, sx_out, sy_out, t,
                                           c, warps, producers, chunk, ring,
                                           2);
  a.b0 = Q64Coef::of(b0);
  a.b1 = Q64Coef::of(b1);
  a.b2 = Q64Coef::of(b2);
  a.a1 = Q64Coef::of(a1);
  a.a2 = Q64Coef::of(a2);
  a.f = f;
  return idsp::ring::launch_pipe(df1_q64_kernel, a, a.p, smem, stream);
}

// K30: xs (t, c) f32 -> ys (t, c) f32; state (c, 2) f32 x2 in and out;
// the plan as K28's (`f32_plan`).
extern "C" int idsp_df1_bank_f32(const void* xs, void* ys, const void* sx,
                                 const void* sy, void* sx_out, void* sy_out,
                                 int t, int c, float b0, float b1, float b2,
                                 float a1, float a2, int warps,
                                 int producers, int chunk, int ring, int smem,
                                 void* stream) {
  if (!idsp::ring::pipe_plan_ok(t, c, warps, producers, chunk, ring, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a = typed_args<F32Args, float>(xs, ys, sx, sy, sx_out, sy_out, t,
                                         c, warps, producers, chunk, ring, 4);
  a.k = idsp::Df1CoefsF32{b0, b1, b2, a1, a2};
  return idsp::ring::launch_pipe(df1_f32_kernel, a, a.p, smem, stream);
}

// K31: xs (t, c) i32 -> ys (t, c) i32; state xy (c, 2) i32 x2 and e (c,)
// i64 in [0, 2^32), in and out; 0 < f <= 32; clamp != 0 runs the clamped
// step (u, lo, hi).  warps, producers, chunk, ring (slots a ring) and smem
// are the host plan's (filters/biquad_cuda.py `dither_plan`); a plan the
// kernel cannot run is refused.  A refused call launches nothing and
// leaves no CUDA error pending.
extern "C" int idsp_df1_dither_bank(const void* xs, void* ys, const void* sx,
                                    const void* sy, const void* se,
                                    void* sx_out, void* sy_out, void* se_out,
                                    int t, int c, int f, int b0, int b1,
                                    int b2, int a1, int a2, int clamp, int u,
                                    int lo, int hi, int warps, int producers,
                                    int chunk, int ring, int smem,
                                    void* stream) {
  return launch_dither(xs, ys, sx, sy, se, sx_out, sy_out, se_out, nullptr,
                       t, c, idsp::Df1Coefs{b0, b1, b2, a1, a2, f}, clamp,
                       idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk,
                       ring, smem, stream);
}

// K33: K31 with each lane's coefficients from (5, c) i32 planes (not
// null).
extern "C" int idsp_df1_dither_bank_coef(
    const void* xs, void* ys, const void* sx, const void* sy, const void* se,
    void* sx_out, void* sy_out, void* se_out, const void* planes, int t,
    int c, int f, int clamp, int u, int lo, int hi, int warps, int producers,
    int chunk, int ring, int smem, void* stream) {
  if (!planes) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dither(xs, ys, sx, sy, se, sx_out, sy_out, se_out, planes, t,
                       c, idsp::Df1Coefs{0, 0, 0, 0, 0, f}, clamp,
                       idsp::Df1Clamp{u, lo, hi}, warps, producers, chunk,
                       ring, smem, stream);
}
