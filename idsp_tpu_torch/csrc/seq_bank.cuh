// The sequential walk of a recurrence and the helpers its kernels share:
// one thread walks a lane's block of time with its state in registers.
//
// Replaces the scaffold of the TPU bank kernels,
// idsp_tpu/filters/biquad_pallas.py `_seq_bank_kernel` (:471) run by
// `_bank_call` (:453).  On the TPU a grid walked time chunks in order
// with the state in VMEM scratch and lanes tiled (c/128, 128); here a
// lane is a thread and a loop inside it takes the place of the grid.
//
// `seq_rows` loads the next kBankGroup rows while the current group
// computes, so global-load latency stays off the serial chain of the
// recurrence (K9/K10's range passes, cic_bank.cu, with `Keep` for the
// kept rows); `ldg` is the read-only row load of cic_bank.cu and
// df1_ring.cuh's producers, `wadd32` / `wadd64` the wrapping sums of
// fm_disc.cu, atan2.cuh and pll.cuh.  The serial banks (K1, K4, K5 and
// the rest) run on df1_ring.cuh's depth-0 pipeline instead.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace idsp {

constexpr int kBankGroup = 16;  // rows per prefetch group

// step(i, load(i)) for rows i = 0 .. t-1 in order; load(i) runs one
// group of kBankGroup rows ahead of step.
template <class Load, class Step>
__device__ __forceinline__ void seq_rows(int t, Load load, Step step) {
  using In = decltype(load(0));
  const int full = t / kBankGroup * kBankGroup;
  In cur[kBankGroup];
#pragma unroll
  for (int u = 0; u < kBankGroup; ++u) cur[u] = full > 0 ? load(u) : In{};
  for (int i0 = 0; i0 < full; i0 += kBankGroup) {
    const bool more = i0 + kBankGroup < full;
    In nxt[kBankGroup];
#pragma unroll
    for (int u = 0; u < kBankGroup; ++u)
      nxt[u] = more ? load(i0 + kBankGroup + u) : In{};
#pragma unroll
    for (int u = 0; u < kBankGroup; ++u) step(i0 + u, cur[u]);
#pragma unroll
    for (int u = 0; u < kBankGroup; ++u) cur[u] = nxt[u];
  }
  for (int i = full; i < t; ++i) step(i, load(i));
}

// Keep-1-in-dec over a walk of rows: next() is true for the rows
// 0, dec, 2*dec, ... (== ys[::dec]).
struct Keep {
  int dec;
  int left = 0;
  __device__ explicit Keep(int d) : dec(d) {}
  __device__ __forceinline__ bool next() {
    const bool kept = left == 0;
    left = kept ? dec - 1 : left - 1;
    return kept;
  }
};

// One read-only global load of a row element: int16, int32, float and,
// through long long, the 64-bit integers.
template <class T>
__device__ __forceinline__ T ldg(const T* p) {
  if constexpr (std::is_integral_v<T> && sizeof(T) == 8) {
    return static_cast<T>(__ldg(reinterpret_cast<const long long*>(p)));
  } else {
    return __ldg(p);
  }
}

// Wrapping two's-complement adds: signed overflow is undefined in C++,
// so the sums are formed in the unsigned types, where it is defined.
__device__ __forceinline__ int64_t wadd64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}

__device__ __forceinline__ int32_t wadd32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

}  // namespace idsp
