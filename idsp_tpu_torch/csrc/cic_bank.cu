// K9 and K10: the CIC integrator cascade over a bank of lanes.
//
// Replaces the Pallas kernels of idsp_tpu/filters/cic_pallas.py
// `cic_dec_bank` (:83) and `cic_int_bank` (:131), both the body
// `_integ_body(n)` (:28) on `_seq_bank_kernel` / `_bank_call`
// (biquad_pallas.py:471, :453).  Here they run on the sequential-bank
// template of seq_bank.cuh: one thread per lane, the N integrators in
// registers, rows prefetched one group ahead.  The combs run at the slow
// rate outside the kernel, as in the JAX package (cic_pallas.py:72, :113).
//
// * K9 (decimate by R): per row cur = x; int_i += cur; cur = int_i for
//   i = 1..N; the rows 0, R, 2R, ... of cur are kept (cic.py:154,
//   integ[::r]), so only t/R rows reach device memory.
// * K10 (interpolate by R): reads the slow-rate comb output and repeats
//   each row R times itself (the JAX kernel reads a materialised
//   jnp.repeat, cic_pallas.py:114), then the same integrators over the
//   t*R fast rows.  Same words, and the R-times array is never written.
//
// Every sum wraps in int32 and is formed in uint32 (`wadd32`): signed
// overflow is undefined in C++, and the decimator's integrators overflow
// by design (cic.rs:175-199).
//
// What bounds them on the H100: device-memory bytes at the roofline
// (K9 reads 4 B per fast sample, K10 writes 4 B per fast sample; N adds
// each).  As written, one warp per 32 lanes walks all of time, so at
// c = 512 only 16 warps run and each waits on its own loads (K9) or
// stores (K10).  What the design does: the integrators never leave
// registers and the intermediate stages never reach memory; a parallel
// scan over time (wrapping int32 sums are associative) is the way to
// more warps.
#include <cuda_runtime.h>

#include <cstdint>

#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

template <int N>
struct Integrators {
  int32_t v[N];

  __device__ __forceinline__ void load(const int32_t* s, int lane) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = s[static_cast<size_t>(lane) * N + i];
  }
  __device__ __forceinline__ void store(int32_t* s, int lane) const {
#pragma unroll
    for (int i = 0; i < N; ++i) s[static_cast<size_t>(lane) * N + i] = v[i];
  }
  __device__ __forceinline__ int32_t step(int32_t x) {
    int32_t cur = x;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = idsp::wadd32(v[i], cur);
      cur = v[i];
    }
    return cur;
  }
};

template <int N>
__global__ void __launch_bounds__(kBankLanes)
    cic_dec_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys,
                   const int32_t* __restrict__ s_in,
                   int32_t* __restrict__ s_out, int t, int c, int r) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  Integrators<N> s;
  s.load(s_in, lane);
  idsp::seq_bank<true>(
      xs, t, c, lane, r, [&](int32_t x) { return s.step(x); },
      [&](size_t i, int32_t y) { ys[i] = y; });
  s.store(s_out, lane);
}

template <int N>
__global__ void __launch_bounds__(kBankLanes)
    cic_int_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys,
                   const int32_t* __restrict__ s_in,
                   int32_t* __restrict__ s_out, int t, int c, int r) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  Integrators<N> s;
  s.load(s_in, lane);
  const int32_t* xp = xs + lane;
  int32_t* yp = ys + lane;
  idsp::seq_rows(
      t, [&](int i) { return __ldg(xp + static_cast<size_t>(i) * c); },
      [&](int i, int32_t x) {
        int32_t* out = yp + static_cast<size_t>(i) * r * c;
        for (int k = 0; k < r; ++k) out[static_cast<size_t>(k) * c] = s.step(x);
      });
  s.store(s_out, lane);
}

using KernelFn = void (*)(const int32_t*, int32_t*, const int32_t*, int32_t*,
                          int, int, int);

// the kernel of order n (1 <= n <= 8), or null
template <bool Dec>
KernelFn pick(int n) {
#define IDSP_CIC_CASE(N) \
  case N:                \
    return Dec ? cic_dec_kernel<N> : cic_int_kernel<N>;
  switch (n) {
    IDSP_CIC_CASE(1)
    IDSP_CIC_CASE(2)
    IDSP_CIC_CASE(3)
    IDSP_CIC_CASE(4)
    IDSP_CIC_CASE(5)
    IDSP_CIC_CASE(6)
    IDSP_CIC_CASE(7)
    IDSP_CIC_CASE(8)
    default:
      return nullptr;
  }
#undef IDSP_CIC_CASE
}

int launch(KernelFn kernel, const void* xs, void* ys, const void* s_in,
           void* s_out, int t, int c, int r, void* stream) {
  if (kernel == nullptr || r < 1 || t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  kernel<<<grid, kBankLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(ys),
      static_cast<const int32_t*>(s_in), static_cast<int32_t*>(s_out), t, c,
      r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9: xs (t, c) i32 -> ys (t/r, c) i32, the integrator output at rows 0,
// r, 2r, ...; integrators s (c, n) i32 in and out; 1 <= n <= 8,
// t % r == 0.
extern "C" int idsp_cic_dec_bank(const void* xs, void* ys, const void* s_in,
                                 void* s_out, int t, int c, int n, int r,
                                 void* stream) {
  if (r < 1 || t % r != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick<true>(n), xs, ys, s_in, s_out, t, c, r, stream);
}

// K10: xs (t, c) i32 slow-rate comb output -> ys (t*r, c) i32, each row
// held r times through the integrators; s (c, n) i32 in and out; 1 <= n <= 8.
extern "C" int idsp_cic_int_bank(const void* xs, void* ys, const void* s_in,
                                 void* s_out, int t, int c, int n, int r,
                                 void* stream) {
  return launch(pick<false>(n), xs, ys, s_in, s_out, t, c, r, stream);
}
