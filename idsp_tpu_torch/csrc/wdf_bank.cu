// K38-K40: wave-digital allpass chains over a bank of lanes.  K38 is one
// adapter chain, K39 serial chains, K40 the complementary pair: both
// branches of serial chains and the butterfly (y0 + y1, y0 - y1), in one
// launch.  One kernel serves the three.
//
// Replaces the Pallas kernels of idsp_tpu/filters/wdf_pallas.py
// `wdf_bank` (:109, its own pallas_call :150), `wdf_chain_bank` (:220,
// biquad_pallas.py `_bank_call` :453) and `wdf_pair_bank` (:280, two
// chain kernels and the butterfly in one jit).  On the TPU the adapter
// types and coefficients were trace-time constants and the `c * a`
// Q32<32> apply the high word of a limb-emulated 64-bit product.  Here
// they travel by value in `WdfChain` (type nibbles, Q32 coefficients,
// stage boundaries; at most kWdfMax adapters in all, which the wrapper
// and the entry point check), and the apply is `__mulhi`, the exact high
// word of the signed 64-bit product.  Every sum wraps mod 2^32 (formed in
// uint32: signed overflow is undefined in C++).
//
// What bounds them on the H100: the recurrence.  A sample walks every
// adapter of a branch in order (each reads its stage's old z), so the
// chain is ~4 dependent operations an adapter; the bytes are 4 B in and
// 4 B out a sample (8 B out for K40).
//
// What the design does: one thread per lane, on the rolled walk of
// seq_bank.cuh (`seq_rows_rolled`: the next 16 rows prefetched, the step's
// code emitted once, not 16 times).  The eight adapter types are one
// branch-free
// form: c = sc * (x1 - x0), m = mulhi(a, c), w = m + wx0 x0 + wx1 x1,
// next = m + nx0 x0 + nx1 x1, with sc = +-1 and small integer weights
// that the entry point derives from the type (B and B1 are one function,
// C and C1 another; X and Z take a = 0).  Every product of x0 or x1 is a
// ring operation mod 2^32 and c is the wrapped x1 - x0 or x0 - x1 of the
// reference, so the result is bit for bit the reference's.  The loop over
// adapters (both branches of a pair in one pass) is unrolled over N, the
// adapter count rounded up to one of kSizes, with `if (j < n)` guards, so
// each z stays in a register (a runtime index would send the array to
// local memory) and a short chain does not pay for kWdfMax adapters.
// Simple first: speed is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

constexpr int kWdfMax = 24;  // adapters of one launch, both branches
constexpr int kFirst = 1, kLast = 2;  // an adapter opens / closes its stage

struct WdfChain {
  int n0, n;  // adapters of branch 0; of both branches (n0 for one branch)
  int32_t a[kWdfMax];  // Q32<32> coefficient (0 for X and Z)
  int32_t sc[kWdfMax];  // c = sc * (x1 - x0)
  int32_t wx0[kWdfMax], wx1[kWdfMax];  // w = m + wx0 x0 + wx1 x1
  int32_t nx0[kWdfMax], nx1[kWdfMax];  // next = m + nx0 x0 + nx1 x1
  int flag[kWdfMax];
};

// (sc, wx0, wx1, nx0, nx1, uses a) of each type (wdf.rs:65-101), e.g. A:
// c = x1 - x0, y = m + x1, w = y + c = m - x0 + 2 x1, next = y.
struct Form {
  int type, sc, wx0, wx1, nx0, nx1, uses_a;
};
constexpr Form kForms[] = {
    {0xA, 1, -1, 2, 0, 1, 1},   // A
    {0xB, -1, 0, 1, 1, 0, 1},   // B:  w = m + x1, next = m + x0
    {0xE, -1, 0, 1, 1, 0, 1},   // B1: the same function
    {0x1, 1, 0, 1, 1, 0, 0},    // X:  w = x1, next = x0
    {0xC, 1, 0, -1, -1, 0, 1},  // C:  w = m - x1, next = m - x0
    {0xF, 1, 0, -1, -1, 0, 1},  // C1: the same function
    {0xD, -1, 1, -2, 0, -1, 1}, // D:  w = m + x0 - 2 x1, next = m - x1
    {0x0, 1, 1, 0, 0, 1, 0},    // Z:  w = x0, next = x1
};

__device__ __forceinline__ uint32_t u(int32_t v) {
  return static_cast<uint32_t>(v);
}

// One lane's adapter words z[j] of every stage of both branches, N of
// them at most.
template <int N>
struct WdfLane {
  int32_t z[N];

  // One sample through every adapter in order: each reads its stage's old
  // z and writes the one before it; a stage's w_0 feeds the next stage; at
  // n0 branch 1 starts over from x.  y0: branch 0's output (of a pair),
  // y1: the last branch's.
  __device__ __forceinline__ void step(const WdfChain& k, int32_t x,
                                       int32_t& y0, int32_t& y1) {
    int32_t cur = x, out = 0;
    y0 = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < k.n) {
        if (j == k.n0) {
          y0 = cur;
          cur = x;
        }
        const int32_t x0 = cur, x1 = z[j];
        const int32_t c = static_cast<int32_t>((u(x1) - u(x0)) * u(k.sc[j]));
        const uint32_t m = u(__mulhi(k.a[j], c));
        const int32_t w =
            static_cast<int32_t>(m + u(k.wx0[j]) * u(x0) + u(k.wx1[j]) * u(x1));
        cur = static_cast<int32_t>(m + u(k.nx0[j]) * u(x0) +
                                   u(k.nx1[j]) * u(x1));
        if (k.flag[j] & kFirst) {
          out = w;
        } else if (j > 0) {  // always: adapter 0 opens its stage
          z[j - 1] = w;
        }
        if (k.flag[j] & kLast) {
          z[j] = cur;
          cur = out;
        }
      }
    }
    y1 = cur;
  }
};

template <int N, bool Pair>
__global__ void __launch_bounds__(kBankLanes)
    wdf_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ ys0,
               int32_t* __restrict__ ys1, const int32_t* __restrict__ z_in,
               int32_t* __restrict__ z_out, int t, int c, WdfChain k) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  const size_t cs = static_cast<size_t>(c);
  WdfLane<N> s;
#pragma unroll
  for (int j = 0; j < N; ++j) s.z[j] = j < k.n ? z_in[j * cs + lane] : 0;
  const int32_t* xp = xs + lane;
  idsp::seq_rows_rolled(
      t, [&](int i) { return idsp::ldg(xp + static_cast<size_t>(i) * cs); },
      [&](int i, int32_t x) {
        int32_t y0, y1;
        s.step(k, x, y0, y1);
        const size_t at = static_cast<size_t>(i) * cs + lane;
        if constexpr (Pair) {
          ys0[at] = static_cast<int32_t>(u(y0) + u(y1));
          ys1[at] = static_cast<int32_t>(u(y0) - u(y1));
        } else {
          ys0[at] = y1;
        }
      });
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < k.n) z_out[j * cs + lane] = s.z[j];
}

// The unrolled lengths: a chain of n adapters runs the first N >= n.
constexpr int kSizes[] = {2, 4, 8, 12, 16, 20, kWdfMax};

template <int I = 0>
void launch(int n, dim3 grid, cudaStream_t st, const int32_t* x, int32_t* y0,
            int32_t* y1, const int32_t* zi, int32_t* zo, int t, int c,
            const WdfChain& k, bool pair) {
  constexpr int N = kSizes[I];
  if constexpr (I + 1 < sizeof(kSizes) / sizeof(kSizes[0])) {
    if (n > N) {
      launch<I + 1>(n, grid, st, x, y0, y1, zi, zo, t, c, k, pair);
      return;
    }
  }
  if (pair) {
    wdf_kernel<N, true><<<grid, kBankLanes, 0, st>>>(x, y0, y1, zi, zo, t, c,
                                                     k);
  } else {
    wdf_kernel<N, false><<<grid, kBankLanes, 0, st>>>(x, y0, y1, zi, zo, t,
                                                      c, k);
  }
}

}  // namespace

// K38-K40: xs (t, c) i32 -> ys0 (t, c) i32 (the chain's output, or the
// pair's sum) and, with n1 > 0, ys1 (the pair's difference); z_in, z_out
// (n0 + n1, c) i32 planes, stage after stage, branch 0 first; types,
// coefs and flags host arrays of n0 + n1 ints (flag 1: the adapter opens
// its stage, 2: closes it); n0 >= 1, n0 + n1 <= kWdfMax.  A refused call
// launches nothing.
extern "C" int idsp_wdf_bank(const void* xs, void* ys0, void* ys1,
                             const void* z_in, void* z_out, const int* types,
                             const int* coefs, const int* flags, int t, int c,
                             int n0, int n1, void* stream) {
  if (n0 < 1 || n1 < 0 || n0 + n1 > kWdfMax || (n1 > 0 && ys1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WdfChain k{};
  k.n0 = n0;
  k.n = n0 + n1;
  for (int j = 0; j < k.n; ++j) {
    const Form* f = nullptr;
    for (const Form& g : kForms)
      if (g.type == types[j]) f = &g;
    if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    k.a[j] = f->uses_a ? coefs[j] : 0;
    k.sc[j] = f->sc;
    k.wx0[j] = f->wx0;
    k.wx1[j] = f->wx1;
    k.nx0[j] = f->nx0;
    k.nx1[j] = f->nx1;
    k.flag[j] = flags[j];
  }
  // a stage opens at the first adapter of each branch and closes at the last
  if (!(k.flag[0] & kFirst) || !(k.flag[n0 - 1] & kLast) ||
      (n1 > 0 && (!(k.flag[n0] & kFirst) || !(k.flag[k.n - 1] & kLast))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(xs);
  auto y0 = static_cast<int32_t*>(ys0);
  auto y1 = static_cast<int32_t*>(ys1);
  auto zi = static_cast<const int32_t*>(z_in);
  auto zo = static_cast<int32_t*>(z_out);
  launch(k.n, grid, st, x, y0, y1, zi, zo, t, c, k, n1 > 0);
  return static_cast<int>(cudaGetLastError());
}
