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
// What bounds it on the H100: the DF1 recurrence, one serial chain of
// 64-bit multiply-adds per channel and row, as in K1 (1.7 ms for t =
// 32768); and the discriminator, ~100 integer instructions per row for
// the exact angle, which one warp per 32 channels cannot issue in that
// time.  Memory: 8 B in and 4 B out per sample.
//
// What the design does about it: a block of 32 channels and four warps.
// Warp 0 holds the DF1 state in registers and runs the recurrence; warps
// 1-3 compute the discriminator of the next chunk of kChunk rows into a
// double-buffered shared-memory plane (one row in three each, loading the
// row and the one before it, 16 independent rows at a time), while warp
// 0 steps through the current chunk: one barrier per chunk.  The atan2
// seed LUT is read from shared memory.  The dphi plane never reaches
// device memory.
//
// (Earlier versions, at c = 512, t = 32768 on the H100: one thread per
// channel with the discriminator as the `load` of seq_bank.cuh's
// `seq_rows`, row i-1 re-read behind an `i == 0` test and the LUT in
// __constant__ memory, 20.5 ms; the same thread computing 16 rows of
// discriminator, then 16 DF1 steps, 5.41 ms exact, 3.63 ms fast.)
#include <cuda_runtime.h>

#include <cstdint>

#include "atan2.cuh"
#include "atan2_f32.cuh"
#include "df1.cuh"
#include "seq_bank.cuh"  // kBankLanes, kBankGroup, wadd32

namespace {

using idsp::kBankLanes;

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
        hi_word(static_cast<uint64_t>(int64_t{a_re} * b_re) -
                static_cast<uint64_t>(int64_t{a_im} * nim));
    const int32_t z_im =
        hi_word(static_cast<uint64_t>(int64_t{a_re} * nim) +
                static_cast<uint64_t>(int64_t{a_im} * b_re));
    angle = idsp::atan2_i32(z_im, z_re, lut);
  }
  return idsp::wadd32(angle, static_cast<int32_t>(
                                 0u - static_cast<uint32_t>(carrier)));
}

constexpr int kProducers = 3;  // warps computing dphi; warp 0 runs the DF1
constexpr int kFmThreads = (kProducers + 1) * kBankLanes;
constexpr int kChunk = kProducers * 32;  // rows per chunk, 32 per producer

template <bool Fast>
__global__ void __launch_bounds__(kFmThreads) fm_disc_kernel(
    const int32_t* __restrict__ re, const int32_t* __restrict__ im,
    const int32_t* __restrict__ prev_re, const int32_t* __restrict__ prev_im,
    const uint8_t* __restrict__ prev_valid, const int32_t* __restrict__ sx,
    const int32_t* __restrict__ sy, int32_t* __restrict__ prev_re_out,
    int32_t* __restrict__ prev_im_out, uint8_t* __restrict__ valid_out,
    int32_t* __restrict__ sx_out, int32_t* __restrict__ sy_out,
    int32_t* __restrict__ ys, int t, int c, int32_t carrier,
    idsp::Df1Coefs k) {
  constexpr int G = idsp::kBankGroup;
  __shared__ uint32_t lut_base[16];
  __shared__ int32_t lut_slope[16];
  __shared__ int32_t dphi[2][kChunk][kBankLanes];  // double-buffered chunk
  const auto lut = idsp::load_atan2_lut(lut_base, lut_slope);
  const int warp = threadIdx.x / kBankLanes;
  const int ch = blockIdx.x * kBankLanes + threadIdx.x % kBankLanes;
  const bool active = ch < c;  // every thread reaches the barriers
  const int32_t* rp = re + ch;
  const int32_t* ip = im + ch;
  const int2 prev0 = active ? make_int2(prev_re[ch], prev_im[ch]) : int2{};
  const bool valid = active && prev_valid[ch] != 0;
  auto row = [&](int i) {
    if (i < 0) return prev0;
    const size_t o = static_cast<size_t>(i) * c;
    return make_int2(__ldg(rp + o), __ldg(ip + o));
  };
  // producer warp p: the rows q*kChunk + (p-1) + kProducers*j of chunk q
  auto produce = [&](int q) {
    int32_t(*out)[kBankLanes] = dphi[q & 1];
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += G) {
      int2 a[G], b[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = q * kChunk + warp - 1 + kProducers * (j0 + u);
        const bool in = active && i < t;
        a[u] = in ? row(i) : int2{};
        b[u] = in ? row(i - 1) : int2{};
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = q * kChunk + warp - 1 + kProducers * (j0 + u);
        const int32_t d = disc<Fast>(a[u].x, a[u].y, b[u].x, b[u].y, carrier,
                                     lut);
        out[warp - 1 + kProducers * (j0 + u)][threadIdx.x % kBankLanes] =
            i == 0 && !valid ? 0 : d;
      }
    }
  };
  const int chunks = (t + kChunk - 1) / kChunk;
  __syncthreads();  // the LUT
  if (warp > 0) produce(0);
  __syncthreads();
  idsp::Df1Lane s;
  if (warp == 0 && active) s.load(sx, sy, ch);
  int32_t* yp = ys + ch;
  for (int q = 0; q < chunks; ++q) {
    if (warp == 0) {
      if (active) {
        const int rows = min(kChunk, t - q * kChunk);
        const int32_t(*in)[kBankLanes] = dphi[q & 1];
        int32_t* yq = yp + static_cast<size_t>(q) * kChunk * c;
#pragma unroll 16
        for (int r = 0; r < rows; ++r)
          yq[static_cast<size_t>(r) * c] = s.step(k, in[r][threadIdx.x]);
      }
    } else if (q + 1 < chunks) {
      produce(q + 1);
    }
    __syncthreads();  // chunk q read, chunk q+1 written
  }
  if (warp == 0 && active) {
    s.store(sx_out, sy_out, ch);
    const size_t last = static_cast<size_t>(t - 1) * c;
    prev_re_out[ch] = rp[last];
    prev_im_out[ch] = ip[last];
    valid_out[ch] = 1;
  }
}

}  // namespace

// re, im (t, c) i32 -> ys (t, c) i32; state: prev_re, prev_im (c,) i32,
// prev_valid (c,) bool (one byte), DF1 x/y (c, 2) i32, each in and out.
// angle_fast: 0 the exact atan2, 1 the f32 angle.  t >= 1.
extern "C" int idsp_fm_disc_bank(const void* re, const void* im,
                                 const void* prev_re, const void* prev_im,
                                 const void* prev_valid, const void* sx,
                                 const void* sy, void* prev_re_out,
                                 void* prev_im_out, void* valid_out,
                                 void* sx_out, void* sy_out, void* ys, int t,
                                 int c, int carrier, int angle_fast, int f,
                                 int b0, int b1, int b2, int a1, int a2,
                                 void* stream) {
  if (t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const idsp::Df1Coefs k{b0, b1, b2, a1, a2, f};
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto kernel = angle_fast ? fm_disc_kernel<true> : fm_disc_kernel<false>;
  kernel<<<grid, kFmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(re), static_cast<const int32_t*>(im),
      static_cast<const int32_t*>(prev_re),
      static_cast<const int32_t*>(prev_im),
      static_cast<const uint8_t*>(prev_valid),
      static_cast<const int32_t*>(sx), static_cast<const int32_t*>(sy),
      static_cast<int32_t*>(prev_re_out), static_cast<int32_t*>(prev_im_out),
      static_cast<uint8_t*>(valid_out), static_cast<int32_t*>(sx_out),
      static_cast<int32_t*>(sy_out), static_cast<int32_t*>(ys), t, c,
      carrier, k);
  return static_cast<int>(cudaGetLastError());
}
