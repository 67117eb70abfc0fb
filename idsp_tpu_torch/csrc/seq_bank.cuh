// The sequential-bank template: one thread per lane walks the whole
// block of time with its recurrence state in registers.
//
// Replaces the scaffold of the TPU bank kernels,
// idsp_tpu/filters/biquad_pallas.py `_seq_bank_kernel` (:471) run by
// `_bank_call` (:453).  On the TPU a grid walked time chunks in order
// with the state in VMEM scratch and lanes tiled (c/128, 128); here a
// lane is a thread and a loop inside it takes the place of the grid.
//
// `seq_rows` loads the next kBankGroup rows while the current group
// computes, so global-load latency stays off the serial chain of the
// recurrence.  `seq_bank` applies it to a time-major (t, c) input of
// int16, int32, int64 or float rows (the row type a template argument),
// with an optional keep-1-in-dec output (rows 0, dec, 2*dec, ...; the
// state still carries the full-rate recurrence), as the TPU kernel's
// `dec` epilogue did.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace idsp {

constexpr int kBankLanes = 32;  // lanes (threads) per block
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

// One lane of a bank over xs (t, c) of T (int16, int32, int64 or float),
// time-major: y = step(x) for every row; put(k, y) stores the k-th
// output row's value (flat index k * c + lane), for every row, or with
// Decimate for rows 0, dec, ...
template <bool Decimate, class T, class Step, class Put>
__device__ __forceinline__ void seq_bank(const T* __restrict__ xs, int t,
                                         int c, int lane, int dec, Step step,
                                         Put put) {
  const T* xp = xs + lane;
  auto load = [&](int i) { return ldg(xp + static_cast<size_t>(i) * c); };
  if constexpr (Decimate) {
    Keep keep(dec);
    size_t out = lane;
    seq_rows(t, load, [&](int, T x) {
      const auto y = step(x);
      if (keep.next()) {
        put(out, y);
        out += c;
      }
    });
  } else {
    seq_rows(t, load, [&](int i, T x) {
      put(static_cast<size_t>(i) * c + lane, step(x));
    });
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
