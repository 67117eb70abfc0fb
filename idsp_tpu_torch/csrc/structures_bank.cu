// K34-K37: the alternative filter structures over a bank of lanes.  K34
// is the Chamberlin state-variable filter (f32), K35 and K36 the
// normal-form (Rader-Gold) section in Q<f> int32 and f32, K37 the
// reciprocal PLL over masked timestamps.
//
// Replaces the Pallas kernels of idsp_tpu/filters/svf_pallas.py
// `svf_bank` (:28), normal_pallas.py `normal_bank_q` (:35) and
// `normal_bank_f32` (:105), and rpll_pallas.py `rpll_bank` (:35), all
// `_seq_bank_kernel` bodies run by biquad_pallas.py `_bank_call`
// (pallas_call :453).  The TPU had no 64-bit integers: the normal form's
// i64 MACs were 16-bit limb products, and the RPLL's u32 x u32 -> u64
// product one too, its `>> sf` split into sf < 32, = 32, > 32 (:96-101)
// and its masks packed beside the timestamps on the sublanes (:120-139).
// Here the MACs are native 64-bit multiply-adds, the RPLL's words native
// uint32_t/uint64_t, and the valid mask a byte plane of its own.
//
// What bounds them on the H100: the recurrence, as K1 (df1_bank.cu): a
// lane is one serial chain.  Per sample the bytes are 4 B in and 4 B out
// (K34-K36), 4 B and a mask byte in and 8 B out (K37).  K34 and K36 round
// every product and sum on its own (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`)
// in the plain version's order, so nvcc cannot contract them into FMAs:
// bit-identical to the plain scans.
//
// What the design does: one thread per lane with the state in registers,
// on the sequential-bank template of seq_bank.cuh (the next 16 rows
// prefetched, rows coalesced along lanes).  Simple first: speed is later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

// K34: svf.rs:47-60.  Out selects lp (0), hp (1), bp (2) or br = hp + lp.
struct SvfLane {
  float lp, hp, bp;

  template <int Out>
  __device__ __forceinline__ float step(float f, float qi, float x) {
    lp = __fadd_rn(__fmul_rn(bp, f), lp);
    hp = __fsub_rn(__fsub_rn(x, lp), __fmul_rn(bp, qi));
    bp = __fadd_rn(__fmul_rn(hp, f), bp);
    if constexpr (Out == 0) return lp;
    if constexpr (Out == 1) return hp;
    if constexpr (Out == 2) return bp;
    return __fadd_rn(hp, lp);
  }
};

template <int Out>
__global__ void __launch_bounds__(kBankLanes)
    svf_kernel(const float* __restrict__ xs, float* __restrict__ ys,
               const float* __restrict__ lp, const float* __restrict__ hp,
               const float* __restrict__ bp, float* __restrict__ lp_out,
               float* __restrict__ hp_out, float* __restrict__ bp_out, int t,
               int c, float f, float qi) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  SvfLane s{lp[lane], hp[lane], bp[lane]};
  idsp::seq_bank<false>(
      xs, t, c, lane, 1, [&](float x) { return s.template step<Out>(f, qi, x); },
      [&](size_t i, float y) { ys[i] = y; });
  lp_out[lane] = s.lp;
  hp_out[lane] = s.hp;
  bp_out[lane] = s.bp;
}

// K35: normal.rs:38-58 in Q<f>: the sums of i32 x i32 products wrap mod
// 2^64 (formed unsigned, `wadd64`), one truncating `>> f` each, then the
// low 32 bits.  -p_im is folded into the y1 sum's fifth coefficient (the
// wrapper refuses p_im == INT32_MIN, as the JAX kernel does).
struct NormalCoefsQ {
  int32_t b0, b1, b2, p_re, p_im;
  int f;
};

struct NormalLaneQ {
  int32_t x1, x2, y0, y1;

  __device__ __forceinline__ int32_t step(const NormalCoefsQ& k,
                                          int32_t x0) {
    using idsp::wadd64;
    const int64_t acc1 = wadd64(
        wadd64(wadd64(wadd64(static_cast<int64_t>(k.b0) * x0,
                             static_cast<int64_t>(k.b1) * x1),
                      static_cast<int64_t>(k.b2) * x2),
               static_cast<int64_t>(k.p_re) * y1),
        -static_cast<int64_t>(k.p_im) * y0);
    const int64_t acc0 = wadd64(static_cast<int64_t>(k.p_im) * y1,
                                static_cast<int64_t>(k.p_re) * y0);
    x2 = x1;
    x1 = x0;
    y1 = static_cast<int32_t>(acc1 >> k.f);
    y0 = static_cast<int32_t>(acc0 >> k.f);
    return y0;
  }
};

// K36: the same update in f32, each product and sum rounded on its own,
// left to right as normal.step: y1' = (((b0 x0 + b1 x1) + b2 x2) + p_re
// y1) - p_im y0, then y0' = p_im y1 + p_re y0.
struct NormalCoefsF32 {
  float b0, b1, b2, p_re, p_im;
};

struct NormalLaneF32 {
  float x1, x2, y0, y1;

  __device__ __forceinline__ float step(const NormalCoefsF32& k, float x0) {
    const float s = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(k.b0, x0), __fmul_rn(k.b1, x1)),
                  __fmul_rn(k.b2, x2)),
        __fmul_rn(k.p_re, y1));
    const float y1n = __fsub_rn(s, __fmul_rn(k.p_im, y0));
    y0 = __fadd_rn(__fmul_rn(k.p_im, y1), __fmul_rn(k.p_re, y0));
    y1 = y1n;
    x2 = x1;
    x1 = x0;
    return y0;
  }
};

// K35 and K36: x = [x1, x2], y = [y0, y1] of each lane, (c, 2) each.
template <class Lane, class T, class Coefs>
__global__ void __launch_bounds__(kBankLanes)
    normal_kernel(const T* __restrict__ xs, T* __restrict__ ys,
                  const T* __restrict__ sx, const T* __restrict__ sy,
                  T* __restrict__ sx_out, T* __restrict__ sy_out, int t, int c,
                  Coefs k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  Lane s{sx[2 * lane], sx[2 * lane + 1], sy[2 * lane], sy[2 * lane + 1]};
  idsp::seq_bank<false>(
      xs, t, c, lane, 1, [&](T x) { return s.step(k, x); },
      [&](size_t i, T y) { ys[i] = y; });
  sx_out[2 * lane] = s.x1;
  sx_out[2 * lane + 1] = s.x2;
  sy_out[2 * lane] = s.y0;
  sy_out[2 * lane + 1] = s.y1;
}

// K37: rpll.rs:47-77 on native unsigned words.  bias = 1 << (sf - 1),
// p_ref = (1 << (32 + dt2 - sf)) mod 2^32.
struct RpllParams {
  int dt2, sf, sp;
  uint64_t bias;
  uint32_t p_ref, dt_mask;
};

struct RpllIn {
  int32_t x;
  uint8_t valid;
};

struct RpllOut {
  int32_t phase, freq;
};

struct RpllLane {
  int32_t x_prev, y;
  uint32_t ff, f;

  __device__ __forceinline__ RpllOut step(const RpllParams& k, RpllIn in) {
    // advance phase: y += f, wrapping i32
    y = static_cast<int32_t>(static_cast<uint32_t>(y) + f);
    // frequency lock: the reference phase over dx at the current estimate,
    // rounded half up, against the ideal 2^(32 + dt2)
    const uint32_t dx =
        static_cast<uint32_t>(in.x) - static_cast<uint32_t>(x_prev);
    const uint64_t p64 = static_cast<uint64_t>(ff) * dx + k.bias;
    const uint32_t p_sig = static_cast<uint32_t>(p64 >> k.sf);
    const uint32_t ff2 = ff + (k.p_ref - p_sig);
    // phase lock: the predicted reference phase "now" (f from before this
    // update) against the estimate; dy an arithmetic i32 shift
    const uint32_t dt = (0u - static_cast<uint32_t>(in.x)) & k.dt_mask;
    const int32_t y_ref = static_cast<int32_t>((f >> k.dt2) * dt);
    const int32_t dy =
        static_cast<int32_t>(static_cast<uint32_t>(y_ref) -
                             static_cast<uint32_t>(y)) >>
        (k.sp - k.dt2);
    const uint32_t f2 = ff2 + static_cast<uint32_t>(dy);
    if (in.valid) {
      x_prev = in.x;
      ff = ff2;
      f = f2;
    }
    return RpllOut{y, static_cast<int32_t>(f)};
  }
};

__global__ void __launch_bounds__(kBankLanes)
    rpll_kernel(const int32_t* __restrict__ xs,
                const uint8_t* __restrict__ valids,
                int32_t* __restrict__ phase, int32_t* __restrict__ freq,
                const int32_t* __restrict__ sx, const int32_t* __restrict__ sff,
                const int32_t* __restrict__ sf, const int32_t* __restrict__ sy,
                int32_t* __restrict__ sx_out, int32_t* __restrict__ sff_out,
                int32_t* __restrict__ sf_out, int32_t* __restrict__ sy_out,
                int t, int c, RpllParams k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  RpllLane s{sx[lane], sy[lane], static_cast<uint32_t>(sff[lane]),
             static_cast<uint32_t>(sf[lane])};
  const int32_t* xp = xs + lane;
  const uint8_t* vp = valids + lane;
  idsp::seq_rows(
      t,
      [&](int i) {
        const size_t o = static_cast<size_t>(i) * c;
        return RpllIn{__ldg(xp + o), __ldg(vp + o)};
      },
      [&](int i, RpllIn in) {
        const RpllOut o = s.step(k, in);
        const size_t at = static_cast<size_t>(i) * c + lane;
        phase[at] = o.phase;
        freq[at] = o.freq;
      });
  sx_out[lane] = s.x_prev;
  sff_out[lane] = static_cast<int32_t>(s.ff);
  sf_out[lane] = static_cast<int32_t>(s.f);
  sy_out[lane] = s.y;
}

dim3 grid_of(int c) { return dim3((c + kBankLanes - 1) / kBankLanes); }

template <int Out>
void launch_svf(const void* xs, void* ys, const void* const* st_in,
                void* const* st_out, int t, int c, float f, float qi,
                cudaStream_t stream) {
  svf_kernel<Out><<<grid_of(c), kBankLanes, 0, stream>>>(
      static_cast<const float*>(xs), static_cast<float*>(ys),
      static_cast<const float*>(st_in[0]), static_cast<const float*>(st_in[1]),
      static_cast<const float*>(st_in[2]), static_cast<float*>(st_out[0]),
      static_cast<float*>(st_out[1]), static_cast<float*>(st_out[2]), t, c, f,
      qi);
}

template <class Lane, class T, class Coefs>
int launch_normal(const void* xs, void* ys, const void* sx, const void* sy,
                  void* sx_out, void* sy_out, int t, int c, const Coefs& k,
                  void* stream) {
  normal_kernel<Lane, T, Coefs>
      <<<grid_of(c), kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xs), static_cast<T*>(ys),
          static_cast<const T*>(sx), static_cast<const T*>(sy),
          static_cast<T*>(sx_out), static_cast<T*>(sy_out), t, c, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K34: xs (t, c) f32 -> ys (t, c) f32; state lp, hp, bp (c,) f32 each, in
// and out; output 0 lp, 1 hp, 2 bp, 3 br.
extern "C" int idsp_svf_bank(const void* xs, void* ys, const void* lp,
                             const void* hp, const void* bp, void* lp_out,
                             void* hp_out, void* bp_out, int t, int c,
                             int output, float f, float qi, void* stream) {
  const void* st_in[3] = {lp, hp, bp};
  void* st_out[3] = {lp_out, hp_out, bp_out};
  auto st = static_cast<cudaStream_t>(stream);
  switch (output) {
    case 0:
      launch_svf<0>(xs, ys, st_in, st_out, t, c, f, qi, st);
      break;
    case 1:
      launch_svf<1>(xs, ys, st_in, st_out, t, c, f, qi, st);
      break;
    case 2:
      launch_svf<2>(xs, ys, st_in, st_out, t, c, f, qi, st);
      break;
    case 3:
      launch_svf<3>(xs, ys, st_in, st_out, t, c, f, qi, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K35: xs (t, c) i32 -> ys (t, c) i32; state x, y (c, 2) i32 each, in and
// out; 0 < f < 64.
extern "C" int idsp_normal_bank_q(const void* xs, void* ys, const void* sx,
                                  const void* sy, void* sx_out, void* sy_out,
                                  int t, int c, int f, int b0, int b1, int b2,
                                  int p_re, int p_im, void* stream) {
  if (f <= 0 || f >= 64 || p_im == INT32_MIN)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_normal<NormalLaneQ, int32_t>(
      xs, ys, sx, sy, sx_out, sy_out, t, c,
      NormalCoefsQ{b0, b1, b2, p_re, p_im, f}, stream);
}

// K36: xs (t, c) f32 -> ys (t, c) f32; state x, y (c, 2) f32 each.
extern "C" int idsp_normal_bank_f32(const void* xs, void* ys, const void* sx,
                                    const void* sy, void* sx_out,
                                    void* sy_out, int t, int c, float b0,
                                    float b1, float b2, float p_re,
                                    float p_im, void* stream) {
  return launch_normal<NormalLaneF32, float>(
      xs, ys, sx, sy, sx_out, sy_out, t, c,
      NormalCoefsF32{b0, b1, b2, p_re, p_im}, stream);
}

// K37: xs (t, c) i32 timestamps and valids (t, c) bytes (0 or 1) ->
// phase, freq (t, c) i32; state x, ff, f, y (c,) i32 each (ff, f the u32
// bit patterns), in and out; 0 <= dt2 < 32, 0 < sf < 64, sf <= 32 + dt2,
// 0 <= sp - dt2 < 32.
extern "C" int idsp_rpll_bank(const void* xs, const void* valids, void* phase,
                              void* freq, const void* x, const void* ff,
                              const void* f, const void* y, void* x_out,
                              void* ff_out, void* f_out, void* y_out, int t,
                              int c, int dt2, int sf, int sp, void* stream) {
  if (dt2 < 0 || dt2 >= 32 || sf <= 0 || sf >= 64 || sf > 32 + dt2 ||
      sp < dt2 || sp - dt2 >= 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const RpllParams k{
      dt2,
      sf,
      sp,
      uint64_t{1} << (sf - 1),
      static_cast<uint32_t>((uint64_t{1} << (32 + dt2 - sf)) & 0xFFFFFFFFu),
      static_cast<uint32_t>((uint64_t{1} << dt2) - 1)};
  rpll_kernel<<<grid_of(c), kBankLanes, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const uint8_t*>(valids),
      static_cast<int32_t*>(phase), static_cast<int32_t*>(freq),
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(ff),
      static_cast<const int32_t*>(f), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(x_out), static_cast<int32_t*>(ff_out),
      static_cast<int32_t*>(f_out), static_cast<int32_t*>(y_out), t, c, k);
  return static_cast<int>(cudaGetLastError());
}
