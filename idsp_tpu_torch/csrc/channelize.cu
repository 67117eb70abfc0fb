// K17: the polyphase analysis channelizer in one kernel: the 8-tap
// polyphase FIR over frames, the cast to the twiddle type, and the DFT
// across the m branches as matrix products.
//
// Replaces the Pallas kernel of idsp_tpu/pipelines/channelizer_pallas.py
// `channelize_fused` (:54; `_channelize_fused_impl` :91, pallas_call
// :175).  On the TPU a sequential grid walked frame blocks with the FIR
// history in VMEM scratch, ran the FIR into VMEM, cast it, and fed four
// (bn, m) x (m, m) MXU dots against the resident twiddles.
//
// Per frame f and branch k (ext = the taps-1 history rows, then z):
//
//   a[f, k] = sum_tap coeff[tap, k] * ext[f - tap, k]   (tap 0 newest,
//             each product and sum a single-rounding intrinsic, in tap
//             order: the plain version's words exactly), cast to TW;
//   yr = ar wr - ai wi,  yi = ar wi + ai wr             (f32 sums)
//
// with w = exp(-2 pi j k m / M) rounded to TW.  Only the order of the
// sums differs from the plain version's four products.
//
// What bounds it on the H100: the DFT, 8m flops per complex sample
// (about 137 Gflop at n = 16384, m = 1024): with bf16 operands on the
// tensor cores, and with f32 operands on the CUDA cores.  Memory: 16 B
// per sample (both planes in, both out).
//
// What the design does about it: no sequential grid: a block owns a tile
// of frames x output columns, and the FIR of its frames needs only the
// taps-1 rows before them, read from the history for the first tile.
// Per K-chunk of branches the block stages the input rows its FIR needs
// (and the coefficients) in shared memory with coalesced loads, runs the
// FIR from there into the operand tile (it never reaches device memory;
// taps outermost, so each thread's outputs are independent work) and
// loads the twiddle tile, then multiplies: bf16 with WMMA (mma.sync
// 16x16x16, f32 accumulators; ai wi enters yr's accumulator through a
// negated wi fragment, exact in bf16), f32 with a 4x4 register tile per
// thread and FMA.  Each block repeats the FIR of its frames for its
// column tile (m / 128 times for bf16, m / 64 for f32): ~6 % of the
// DFT's flops.  Block (0, 0) copies the new history, the last taps-1 rows
// of ext.
//
// (A first version read the FIR's inputs from device memory per output,
// in a loop over a run-time tap count: 8.53 ms (bf16) and 10.72 ms (f32)
// at n = 16384, m = 1024 on the H100.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxTaps = 16;

struct Fir {
  const float* zr;
  const float* zi;
  const float* hr;  // (taps-1, m) history, oldest first
  const float* hi;
  const float* co;  // (taps, m) coefficients, row tap
  int n, m, taps;

  // Stage the rows a tile of BM frames from r0 needs, frames r0-taps+1 ..
  // r0+BM-1 (history before frame 0, zeros past frame n-1), branches
  // k0 .. k0+BK-1 of both planes, and the coefficients of those branches.
  template <int BM, int BK>
  __device__ __forceinline__ void stage(float (*zt_r)[BK], float (*zt_i)[BK],
                                        float (*co_t)[BK], int r0,
                                        int k0) const {
    const int h = taps - 1;
    for (int e = threadIdx.x; e < (BM + h) * BK; e += kThreads) {
      const int f = r0 - h + e / BK;
      const int k = k0 + e % BK;
      float vr = 0.0f, vi = 0.0f;
      if (f >= 0 && f < n) {
        vr = __ldg(zr + static_cast<size_t>(f) * m + k);
        vi = __ldg(zi + static_cast<size_t>(f) * m + k);
      } else if (f < 0) {
        vr = __ldg(hr + static_cast<size_t>(h + f) * m + k);
        vi = __ldg(hi + static_cast<size_t>(h + f) * m + k);
      }
      zt_r[e / BK][e % BK] = vr;
      zt_i[e / BK][e % BK] = vi;
    }
    for (int e = threadIdx.x; e < taps * BK; e += kThreads)
      co_t[e / BK][e % BK] = __ldg(co + static_cast<size_t>(e / BK) * m +
                                   k0 + e % BK);
  }

  // The FIR of the staged tile at the PER elements e = threadIdx.x + q *
  // kThreads (frame e / BK, branch e % BK): taps outermost, so the PER
  // elements of both planes are independent work within each tap; each
  // product and sum a single rounding, tap 0 (the newest frame) first.
  template <int BK, int PER>
  __device__ __forceinline__ void run(float (*zt_r)[BK], float (*zt_i)[BK],
                                      float (*co_t)[BK], float* acc_r,
                                      float* acc_i) const {
    for (int tap = 0; tap < taps; ++tap) {
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const int kk = e % BK;
        const int j = e / BK + taps - 1 - tap;  // staged row of frame - tap
        const float c = co_t[tap][kk];
        const float pr = __fmul_rn(zt_r[j][kk], c);
        const float pi = __fmul_rn(zt_i[j][kk], c);
        acc_r[q] = tap ? __fadd_rn(acc_r[q], pr) : pr;
        acc_i[q] = tap ? __fadd_rn(acc_i[q], pi) : pi;
      }
    }
  }

  // new history: rows n .. n+taps-2 of ext, copied by block (0, 0)
  __device__ void copy_history(float* hr_out, float* hi_out) const {
    if (blockIdx.x != 0 || blockIdx.y != 0) return;
    const int h = taps - 1;
    for (int e = threadIdx.x; e < h * m; e += blockDim.x) {
      const int row = n + e / m;  // row of ext
      const int k = e % m;
      const size_t src = row < h ? static_cast<size_t>(row) * m + k
                                 : static_cast<size_t>(row - h) * m + k;
      hr_out[e] = row < h ? hr[src] : zr[src];
      hi_out[e] = row < h ? hi[src] : zi[src];
    }
  }
};

// ---- bf16 operands, tensor cores (WMMA) ----------------------------------
constexpr int kBM = 64, kBN = 128, kBK = 32;  // frames, columns, branches
constexpr int kWarps = kThreads / 32;         // 4 (rows) x 2 (columns)
constexpr int kBPer = kBM * kBK / kThreads;   // FIR outputs per thread

// two blocks per SM: ptxas then holds 128 registers a thread (a few
// spill); 3.3-3.5 ms against 5.4-5.6 ms with one block per SM at n =
// 16384, m = 1024 on the H100
__global__ void __launch_bounds__(kThreads, 2)
    channelize_bf16_kernel(Fir fir, const bf16* __restrict__ wr,
                           const bf16* __restrict__ wi, float* __restrict__ yr,
                           float* __restrict__ yi, float* __restrict__ hr_out,
                           float* __restrict__ hi_out) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 as_r[kBM * kBK];
  __shared__ __align__(32) bf16 as_i[kBM * kBK];
  __shared__ __align__(32) bf16 ws[2][kBK * kBN];  // wr, wi; then staging
  __shared__ float zt_r[kBM + kMaxTaps - 1][kBK];
  __shared__ float zt_i[kBM + kMaxTaps - 1][kBK];
  __shared__ float co_t[kMaxTaps][kBK];
  const int m = fir.m;
  const int j0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp / 2;  // 16 frames
  const int wcol = warp % 2;  // 64 columns: 4 fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_r[4], acc_i[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc_r[j], 0.0f);
    wmma::fill_fragment(acc_i[j], 0.0f);
  }
  for (int k0 = 0; k0 < m; k0 += kBK) {
    fir.stage<kBM, kBK>(zt_r, zt_i, co_t, r0, k0);
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const size_t src = static_cast<size_t>(k0 + e / kBN) * m + j0 + e % kBN;
      ws[0][e] = wr[src];
      ws[1][e] = wi[src];
    }
    __syncthreads();
    float fr[kBPer], fi[kBPer];
    fir.run<kBK, kBPer>(zt_r, zt_i, co_t, fr, fi);
#pragma unroll
    for (int q = 0; q < kBPer; ++q) {
      as_r[threadIdx.x + q * kThreads] = __float2bfloat16_rn(fr[q]);
      as_i[threadIdx.x + q * kThreads] = __float2bfloat16_rn(fi[q]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_r,
          a_i;
      wmma::load_matrix_sync(a_r, as_r + wrow * 16 * kBK + kk, kBK);
      wmma::load_matrix_sync(a_i, as_i + wrow * 16 * kBK + kk, kBK);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b_r,
            b_i;
        const int col = wcol * 64 + j * 16;
        wmma::load_matrix_sync(b_r, ws[0] + kk * kBN + col, kBN);
        wmma::load_matrix_sync(b_i, ws[1] + kk * kBN + col, kBN);
        wmma::mma_sync(acc_r[j], a_r, b_r, acc_r[j]);
        wmma::mma_sync(acc_i[j], a_r, b_i, acc_i[j]);
        wmma::mma_sync(acc_i[j], a_i, b_r, acc_i[j]);
        for (int e = 0; e < b_i.num_elements; ++e) b_i.x[e] = __hneg(b_i.x[e]);
        wmma::mma_sync(acc_r[j], a_i, b_i, acc_r[j]);
      }
    }
    __syncthreads();
  }
  // out through a per-warp staging tile in the twiddles' shared memory
  // (free after the last barrier): the frame edge is masked
  float* st = reinterpret_cast<float*>(&ws[0][0]) + warp * 256;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      wmma::store_matrix_sync(st, p ? acc_i[j] : acc_r[j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      float* y = p ? yi : yr;
      for (int e = lane; e < 256; e += 32) {
        const int f = r0 + wrow * 16 + e / 16;
        if (f < fir.n)
          y[static_cast<size_t>(f) * m + j0 + wcol * 64 + j * 16 + e % 16] =
              st[e];
      }
      __syncwarp();
    }
  }
  fir.copy_history(hr_out, hi_out);
}

// ---- f32 operands, CUDA cores --------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;  // frames, columns, branches
constexpr int kFPer = kFM * kFK / kThreads;  // FIR outputs per thread

__global__ void __launch_bounds__(kThreads)
    channelize_f32_kernel(Fir fir, const float* __restrict__ wr,
                          const float* __restrict__ wi, float* __restrict__ yr,
                          float* __restrict__ yi, float* __restrict__ hr_out,
                          float* __restrict__ hi_out) {
  // branch-major (a row of frames per branch), padded so that the FIR's
  // stores, 16 branches of one frame, fall in distinct banks
  __shared__ float as_r[kFK][kFM + 1];
  __shared__ float as_i[kFK][kFM + 1];
  __shared__ float ws_r[kFK][kFN];
  __shared__ float ws_i[kFK][kFN];
  __shared__ float zt_r[kFM + kMaxTaps - 1][kFK];
  __shared__ float zt_i[kFM + kMaxTaps - 1][kFK];
  __shared__ float co_t[kMaxTaps][kFK];
  const int m = fir.m;
  const int j0 = blockIdx.x * kFN;
  const int r0 = blockIdx.y * kFM;
  const int tx = threadIdx.x % 16;  // columns tx + 16 j
  const int ty = threadIdx.x / 16;  // frames ty + 16 i
  float accr[4][4] = {};
  float acci[4][4] = {};
  for (int k0 = 0; k0 < m; k0 += kFK) {
    fir.stage<kFM, kFK>(zt_r, zt_i, co_t, r0, k0);
    for (int e = threadIdx.x; e < kFK * kFN; e += kThreads) {
      const int kk = e / kFN;
      const int jj = e % kFN;
      const size_t src = static_cast<size_t>(k0 + kk) * m + j0 + jj;
      ws_r[kk][jj] = wr[src];
      ws_i[kk][jj] = wi[src];
    }
    __syncthreads();
    float fr[kFPer], fi[kFPer];
    fir.run<kFK, kFPer>(zt_r, zt_i, co_t, fr, fi);
#pragma unroll
    for (int q = 0; q < kFPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      as_r[e % kFK][e / kFK] = fr[q];
      as_i[e % kFK][e / kFK] = fi[q];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a_r[4], a_i[4], b_r[4], b_i[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_r[i] = as_r[kk][ty + 16 * i];
        a_i[i] = as_i[kk][ty + 16 * i];
        b_r[i] = ws_r[kk][tx + 16 * i];
        b_i[i] = ws_i[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][j] = fmaf(a_r[i], b_r[j], accr[i][j]);
          accr[i][j] = fmaf(-a_i[i], b_i[j], accr[i][j]);
          acci[i][j] = fmaf(a_r[i], b_i[j], acci[i][j]);
          acci[i][j] = fmaf(a_i[i], b_r[j], acci[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = r0 + ty + 16 * i;
    if (f >= fir.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = static_cast<size_t>(f) * m + j0 + tx + 16 * j;
      yr[o] = accr[i][j];
      yi[o] = acci[i][j];
    }
  }
  fir.copy_history(hr_out, hi_out);
}

}  // namespace

// zr, zi (n, m) f32; hist_r, hist_i (taps-1, m) f32; coeff (taps, m) f32;
// wr, wi (m, m) bf16 (tw_bf16) or f32 -> yr, yi (n, m) f32 and the new
// history (taps-1, m) f32 x2.  m % 128 == 0, n >= 1, 2 <= taps <= 16.
extern "C" int idsp_channelize(const void* zr, const void* zi,
                               const void* hist_r, const void* hist_i,
                               const void* coeff, const void* wr,
                               const void* wi, void* yr, void* yi,
                               void* hist_r_out, void* hist_i_out, int n,
                               int m, int taps, int tw_bf16, void* stream) {
  if (n < 1 || taps < 2 || taps > kMaxTaps || m < kBN || m % kBN ||
      (n + kFM - 1) / kFM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Fir fir{static_cast<const float*>(zr),
                static_cast<const float*>(zi),
                static_cast<const float*>(hist_r),
                static_cast<const float*>(hist_i),
                static_cast<const float*>(coeff),
                n,
                m,
                taps};
  auto st = static_cast<cudaStream_t>(stream);
  auto y_r = static_cast<float*>(yr);
  auto y_i = static_cast<float*>(yi);
  auto h_r = static_cast<float*>(hist_r_out);
  auto h_i = static_cast<float*>(hist_i_out);
  if (tw_bf16) {
    const dim3 grid(m / kBN, (n + kBM - 1) / kBM);
    channelize_bf16_kernel<<<grid, kThreads, 0, st>>>(
        fir, static_cast<const bf16*>(wr), static_cast<const bf16*>(wi), y_r,
        y_i, h_r, h_i);
  } else {
    const dim3 grid(m / kFN, (n + kFM - 1) / kFM);
    channelize_f32_kernel<<<grid, kThreads, 0, st>>>(
        fir, static_cast<const float*>(wr), static_cast<const float*>(wi), y_r,
        y_i, h_r, h_i);
  }
  return static_cast<int>(cudaGetLastError());
}
