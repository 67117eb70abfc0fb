// K4: the integer Lowpass<N> over a bank of lanes, with an optional
// keep-1-in-dec output.
//
// Replaces the Pallas kernel of idsp_tpu/filters/lowpass_pallas.py
// `lowpass_bank` (:69, body `_lp_body` :42, run by `_seq_bank_kernel`
// / `_bank_call` of biquad_pallas.py).  That kernel emulated the int64
// state as (hi i32, lo u32) plane pairs on (c/128, 128) tiles; here the
// state is two native int64 registers of one thread per lane.
//
// What bounds it on the H100: the recurrence, as for K1.  Each sample's
// update (saturating subtract, two i32 x i32 -> i64 products, four
// 64-bit adds, in that dependency order) waits on the previous one; the
// 2c lanes are 2c/32 warps, a few per SM.  Traffic is 4 B in per sample
// and 4/dec B out.
//
// What the design does about it: the sequential-bank template
// (seq_bank.cuh), as K1 runs on: state in registers, inputs prefetched
// one group ahead, the kept rows written straight from the loop so only
// t/dec rows reach device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "lowpass.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

template <int N, bool Decimate>
__global__ void __launch_bounds__(kBankLanes)
    lowpass_bank_kernel(const int32_t* __restrict__ xs,
                        int32_t* __restrict__ ys,
                        const int64_t* __restrict__ p_in,
                        int64_t* __restrict__ p_out, int t, int c, int dec,
                        idsp::LpGains g) {
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c) return;
  idsp::LowpassLane<N> s;
  s.load(p_in, lane);
  idsp::seq_bank<Decimate>(
      xs, t, c, lane, dec, [&](int32_t x) { return s.step(g, x); },
      [&](size_t i, int32_t y) { ys[i] = y; });
  s.store(p_out, lane);
}

template <int N>
void launch(const int32_t* xs, int32_t* ys, const int64_t* p_in,
            int64_t* p_out, int t, int c, int dec, idsp::LpGains g,
            cudaStream_t st) {
  const dim3 grid((c + kBankLanes - 1) / kBankLanes);
  if (dec > 1) {
    lowpass_bank_kernel<N, true><<<grid, kBankLanes, 0, st>>>(
        xs, ys, p_in, p_out, t, c, dec, g);
  } else {
    lowpass_bank_kernel<N, false><<<grid, kBankLanes, 0, st>>>(
        xs, ys, p_in, p_out, t, c, 1, g);
  }
}

}  // namespace

// xs (t, c) i32 -> ys (t/dec, c) i32; state p (c, n) i64 in and out;
// n = 1 or 2, gains k0 (and k1 for n = 2).
extern "C" int idsp_lowpass_bank(const void* xs, void* ys, const void* p_in,
                                 void* p_out, int t, int c, int n, int dec,
                                 int k0, int k1, void* stream) {
  if ((n != 1 && n != 2) || dec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const idsp::LpGains g{k0, k1};
  auto x = static_cast<const int32_t*>(xs);
  auto y = static_cast<int32_t*>(ys);
  auto pi = static_cast<const int64_t*>(p_in);
  auto po = static_cast<int64_t*>(p_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    launch<1>(x, y, pi, po, t, c, dec, g, st);
  } else {
    launch<2>(x, y, pi, po, t, c, dec, g, st);
  }
  return static_cast<int>(cudaGetLastError());
}
