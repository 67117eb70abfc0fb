// K14: the exact-LO conjugate mix fused into the Q<f> DF1 biquad bank.
//
// Replaces the Pallas kernel of idsp_tpu/filters/ddc_pallas.py
// `ddc_mix_df1_bank` (:47; `_ddc_mix_df1_bank_impl` :80, pallas_call
// :175).  On the TPU each time chunk first mixed its rows vectorized
// into VMEM scratch (the LO from `trig.cossin`, its 128-entry lookup a
// compare/select chain of 128 steps per sample, in sub-chunks to bound
// the temporaries), then ran the sequential DF1 over the scratch.
//
// Lane `lane` of the 2c I|Q lanes (I in [0, c), Q in [c, 2c)) belongs to
// channel ch = lane mod c; row i (0-based) of the block mixes with the
// LO at phase phase0[ch] + steps[ch] * (i + 1), wrapping (the `accu.ramp_t`
// convention):
//
//   I lanes  (cos * x[i]) >> 32,   Q lanes  (-sin * x[i]) >> 32
//
// the high word of the exact i64 product (`__mulhi`), which equals
// `fxp.q_apply(., x, 32)`; then the df1.cuh step, out as i32 or as f32.
//
// What bounds it on the H100: the DF1 recurrence, as in K1: one thread
// per lane, a serial chain of 64-bit multiply-adds per row, 2c/32 warps
// on as many SMs.  The mix adds ~30 integer operations per row (the
// cossin, the multiply), none of them on that chain.  The device memory
// traffic is x (t,) in and 4 B per lane and row out: the (t, 2c) mixed
// stream of the split path never reaches device memory.
//
// What the design does about it: the mix is the `load` of the
// sequential-bank template (seq_bank.cuh `seq_rows`), so each thread
// computes its lane's LO and mixed sample for the next group of rows
// while the DF1 steps through the current one, off the serial chain.
// The LUT is read from shared memory (cossin.cuh), x[i] is one word for
// the whole warp.
#include <cuda_runtime.h>

#include <cstdint>

#include "cossin.cuh"
#include "df1.cuh"
#include "seq_bank.cuh"

namespace {

using idsp::kBankLanes;

template <bool F32Out>
__global__ void __launch_bounds__(kBankLanes) ddc_mix_df1_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ phase0,
    const int32_t* __restrict__ steps, const int32_t* __restrict__ sx,
    const int32_t* __restrict__ sy, int32_t* __restrict__ sx_out,
    int32_t* __restrict__ sy_out, void* __restrict__ ys, int t, int c,
    idsp::Df1Coefs k) {
  __shared__ uint32_t lut[idsp::kCosSinLutSize];
  idsp::load_cossin_lut(lut);  // before the early return: a block barrier
  const int c2 = 2 * c;
  const int lane = blockIdx.x * kBankLanes + threadIdx.x;
  if (lane >= c2) return;
  const bool is_q = lane >= c;
  const int ch = is_q ? lane - c : lane;
  const uint32_t p0 = static_cast<uint32_t>(phase0[ch]);
  const uint32_t step = static_cast<uint32_t>(steps[ch]);
  idsp::Df1Lane s;
  s.load(sx, sy, lane);
  idsp::seq_rows(
      t,
      [&](int i) {
        // the mixed sample of row i, one prefetch group ahead
        const idsp::CosSin lo =
            idsp::cossin(lut, p0 + step * static_cast<uint32_t>(i + 1));
        const int32_t g = is_q ? static_cast<int32_t>(
                                     0u - static_cast<uint32_t>(lo.sin))
                               : lo.cos;
        return __mulhi(g, __ldg(x + i));
      },
      [&](int i, int32_t m) {
        const int32_t y = s.step(k, m);
        const size_t o = static_cast<size_t>(i) * c2 + lane;
        if constexpr (F32Out) {
          static_cast<float*>(ys)[o] = static_cast<float>(y);
        } else {
          static_cast<int32_t*>(ys)[o] = y;
        }
      });
  s.store(sx_out, sy_out, lane);
}

}  // namespace

// x (t,) i32, phase0/steps (c,) i32 -> ys (t, 2c) i32 or f32 (f32_out);
// DF1 state (2c, 2) i32 x2 in and out.
extern "C" int idsp_ddc_mix_df1(const void* x, const void* phase0,
                                const void* steps, const void* sx,
                                const void* sy, void* sx_out, void* sy_out,
                                void* ys, int t, int c, int f, int f32_out,
                                int b0, int b1, int b2, int a1, int a2,
                                void* stream) {
  const idsp::Df1Coefs k{b0, b1, b2, a1, a2, f};
  const dim3 grid((2 * c + kBankLanes - 1) / kBankLanes);
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = f32_out ? ddc_mix_df1_kernel<true> : ddc_mix_df1_kernel<false>;
  kernel<<<grid, kBankLanes, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(phase0),
      static_cast<const int32_t*>(steps), static_cast<const int32_t*>(sx),
      static_cast<const int32_t*>(sy), static_cast<int32_t*>(sx_out),
      static_cast<int32_t*>(sy_out), ys, t, c, k);
  return static_cast<int>(cudaGetLastError());
}
