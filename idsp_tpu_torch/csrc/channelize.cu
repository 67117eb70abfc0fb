// K17: the polyphase analysis channelizer in one kernel: the polyphase
// FIR over frames, the cast to the twiddle type, and the DFT across the m
// branches as matrix products.
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
// sums differs from the plain version's four products.  Every output sums
// the same sequence of steps whatever the tiling, cluster size or n
// (bf16: per k16 step of branches, in branch order, ar wr then -(ai wi)
// into yr, ar wi then ai wr into yi; f32: the same four FMAs a branch):
// one block equals its halves and one plan another, bit for bit.
//
// What bounds it on the H100: the DFT, 8m flops per complex sample
// (about 137 Gflop at n = 16384, m = 1024): with bf16 operands on the
// tensor cores (0.139 ms at 989 Tflop/s), with f32 operands FMAs on the
// CUDA cores (2.05 ms at 67 Tflop/s).  Memory: 16 B a sample (both planes
// in, both out).
//
// The design.  A CTA owns a tile of BM frames (64 per consumer warpgroup)
// x 128 output columns and walks the m branches in chunks of BK.  The
// CTAs of one frame tile that sit in a thread-block cluster (C of them,
// the largest divisor of m / 128 up to 8) share the FIR: for every chunk
// each computes 1/C of its frames (whole groups of 8) from input rows it
// staged itself and stores each 16-byte result into the A stage of all C
// CTAs (`st.async` through distributed shared memory, counted on each
// one's full barrier), so the FIR runs once a sample for every C column
// tiles.  Per CTA, three roles and three rings in dynamic shared memory:
//   * the FIR warpgroup (4 warps): thread 0 keeps the input rows of the
//     next chunks in flight (a box of a 2-D tensor map a plane: the
//     share's frames and taps-1 before them, rows past n - 1 and before 0
//     as zeros; the history rows, in the first frame tile only; the
//     chunk's coefficients) and the chunk's twiddle tile (one bulk copy of
//     the tile the wrapper pre-tiled for this chunk and column tile); all
//     128 threads run the FIR of the CTA's share (bf16 by RNE or f32; a
//     stage holds each group of 8 frames' two planes side by side);
//   * the consumer warpgroups: bf16 issue four `wgmma` m64n128k16 a k16
//     step with A and B straight from shared memory (the -ai wi product
//     through the instruction's negated B); f32 FMAs with an 8 x 8 tile a
//     thread, A and B read with 16-byte loads.  Accumulators stay in
//     registers; the epilogue writes 16 bytes a thread (bf16: the quad's
//     pairs swapped by a shuffle) and masks the ragged frame edge;
//   * mbarriers: full[s] (the local FIR's one arrival, then the bytes of
//     the twiddle tile and of every CTA's share), empty[s] (every consumer
//     of the cluster has read stage s: the FIRs of all C CTAs wait on it
//     before the stage is written again), in_full / in_empty (a chunk's
//     input rows have landed / the four FIR warps have read them).
// Block (0, 0) copies the new history, the last taps-1 rows of ext.
//
// A chunk's inputs come in a few large requests (a box a plane, one twiddle
// tile) and the shares by `st.async`: with many small bulk copies the
// TMA's request rate, not its bytes, set the pace.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace idsp::sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxTaps = 16;
constexpr int kBN = 128;          // columns a CTA
constexpr int kMaxCluster = 8;    // portable cluster sizes only
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 256;    // 4 x kMaxStages mbarriers
constexpr int kBStage = 16384;    // a chunk's twiddle tile, both planes
constexpr int kGroupBytes = 1024;  // 8 frames x a chunk, both planes
constexpr int kPlaneBytes = 512;   // one plane of a group

template <bool kBf16>
struct Cfg {
  static constexpr int BK = kBf16 ? 32 : 16;  // branches a chunk
  static constexpr int kElem = kBf16 ? 2 : 4;
};

struct Args {
  CUtensorMap mz[2];  // zr, zi (n, m): boxes of BK x (share_max + taps-1)
  CUtensorMap mh[2];  // hist_r, hist_i (taps-1, m): boxes of BK x (taps-1)
  CUtensorMap mc;     // coeff (taps, m): boxes of BK x taps
  const float* zr;
  const float* zi;
  const float* hr;  // (taps-1, m) history, oldest first
  const float* hi;
  const unsigned char* tw;  // pre-tiled twiddles, kBStage a (tile, chunk)
  float* yr;
  float* yi;
  float* hr_out;
  float* hi_out;
  int n, m, taps, cluster, stages, share_max;
};

__host__ __device__ constexpr int round128(int b) {
  return (b + 127) / 128 * 128;
}

// An input stage: the two planes' boxes of share_max + taps-1 rows, the
// coefficients (taps rows), the two planes' history (taps-1 rows), each
// region 128-byte aligned; rows of BK f32.
struct InLayout {
  int box, coef, hist, bytes;
  __host__ __device__ InLayout(int bk, int share_max, int taps)
      : box(round128((share_max + taps - 1) * bk * 4)),
        coef(round128(taps * bk * 4)),
        hist(round128((taps - 1) * bk * 4)),
        bytes(2 * box + coef + 2 * hist) {}
};

// Dynamic shared memory of a plan: the barriers and `stages` stages of
// the A, B and input rings; channelizer_cuda.smem_bytes computes the
// same sum.
template <bool kBf16>
__host__ __device__ constexpr int a_stage(int frames) {
  return 2 * frames * Cfg<kBf16>::BK * Cfg<kBf16>::kElem;
}
template <bool kBf16>
int smem_bytes(int frames, int stages, int share_max, int taps) {
  return kBarBytes + stages * (a_stage<kBf16>(frames) + kBStage +
                               InLayout(Cfg<kBf16>::BK, share_max, taps).bytes);
}

// ---- the FIR warpgroup -----------------------------------------------------
template <bool kBf16, int kWG>
__device__ void fir_role(const Args& a, unsigned char* smem) {
  constexpr int BK = Cfg<kBf16>::BK;
  constexpr int BM = 64 * kWG;
  constexpr int kAStage = a_stage<kBf16>(BM);
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kMaxStages;
  const uint32_t in_full0 = base + 16 * kMaxStages;
  const uint32_t in_empty0 = base + 24 * kMaxStages;
  const int S = a.stages, h = a.taps - 1, C = a.cluster;
  const int nk = a.m / BK;
  const int ft = threadIdx.x - 128 * kWG, lane = ft % 32;
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = rank * (BM / 8) / C, g1 = (rank + 1) * (BM / 8) / C;
  const int f_lo = 8 * g0, nf = 8 * (g1 - g0);  // the share, tile frames
  const int r0 = blockIdx.y * BM;
  const InLayout L(BK, a.share_max, a.taps);
  const int box_rows = a.share_max + h;
  unsigned char* ring_a = smem + kBarBytes;
  unsigned char* ring_in = ring_a + S * (kAStage + kBStage);
  // box row i is frame base_frame + i (zeros before 0 and past n - 1);
  // frames before 0 are read from the history rows instead
  const int base_frame = r0 + f_lo - h;
  const bool with_hist = base_frame < 0;
  const uint32_t in_bytes_tx =
      (2 * box_rows + a.taps + (with_hist ? 2 * h : 0)) * BK * 4;

  auto prefetch = [&](int kc) {  // thread 0: the inputs of chunk kc
    const int si = kc % S;
    const uint32_t bar = in_full0 + 8 * si;
    const uint32_t dst = smem_addr(ring_in + si * L.bytes);
    const int k0 = kc * BK;
    mbar_arrive_tx(bar, in_bytes_tx);
    tensor_load_2d(dst, &a.mz[0], k0, base_frame, bar);
    tensor_load_2d(dst + L.box, &a.mz[1], k0, base_frame, bar);
    tensor_load_2d(dst + 2 * L.box, &a.mc, k0, 0, bar);
    if (with_hist) {
      tensor_load_2d(dst + 2 * L.box + L.coef, &a.mh[0], k0, 0, bar);
      tensor_load_2d(dst + 2 * L.box + L.coef + L.hist, &a.mh[1], k0, 0, bar);
    }
  };

  // the FIR output of one unit: 16 bytes into every cluster CTA's stage s
  const uint32_t a0 = smem_addr(ring_a);
  auto send = [&](int s, uint32_t offset, uint4 v) {
    for (int q = 0; q < C; ++q)
      store_to_peer(map_rank(a0 + s * kAStage + offset, q), v,
                    map_rank(full0 + 8 * s, q));
  };

  if (ft == 0)
    for (int kc = 0; kc < min(S, nk); ++kc) prefetch(kc);
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % S;
    const uint32_t full = full0 + 8 * s;
    // every consumer of the cluster has read this stage's last round
    if (kc >= S) mbar_wait(empty0 + 8 * s, ((kc / S) & 1) ^ 1);
    if (ft == 0) {
      // the stage's one arrival: the twiddle tile and every CTA's share
      mbar_arrive_tx(full, kBStage + kAStage);
      bulk_load(smem_addr(ring_a + S * kAStage + s * kBStage),
                a.tw + (static_cast<size_t>(blockIdx.x) * nk + kc) * kBStage,
                kBStage, full);
    }
    mbar_wait(in_full0 + 8 * s, (kc / S) & 1);
    const unsigned char* in = ring_in + s * L.bytes;
    const float* co = reinterpret_cast<const float*>(in + 2 * L.box);
    // the row of plane p that frame f of ext is in
    auto row = [&](int p, int f) {
      return f < 0 ? reinterpret_cast<const float*>(
                         in + 2 * L.box + L.coef + p * L.hist) + (h + f) * BK
                   : reinterpret_cast<const float*>(in + p * L.box) +
                         (f - base_frame) * BK;
    };
    if constexpr (kBf16) {
      // unit: (plane, frame, 8 branches): one 16-byte row of a core matrix
      const int units = 2 * nf * (BK / 8);
      for (int u = ft; u < units; u += 128) {
        const int kg = u % (BK / 8), fr = u / (BK / 8) % nf;
        const int p = u / (BK / 8) / nf;
        const int fl = f_lo + fr;
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
        if (r0 + fl < a.n) {
#pragma unroll 4
          for (int tap = 0; tap < a.taps; ++tap) {
            const float4* x =
                reinterpret_cast<const float4*>(row(p, r0 + fl - tap) + 8 * kg);
            const float4* c =
                reinterpret_cast<const float4*>(co + tap * BK + 8 * kg);
            const float4 x0 = x[0], x1 = x[1], c0 = c[0], c1 = c[1];
            const float xv[8] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
            const float cv[8] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float pr = __fmul_rn(xv[e], cv[e]);
              acc[e] = tap ? __fadd_rn(acc[e], pr) : pr;
            }
          }
        }
        uint4 packed;
        uint32_t* w = &packed.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
          w[e] = *reinterpret_cast<const uint32_t*>(&v);
        }
        send(s, (fl / 8) * kGroupBytes + p * kPlaneBytes + kg * 128 +
                    (fl % 8) * 16, packed);
      }
    } else {
      // unit: (plane, 4 frames, branch): 16 bytes of a [k][8 frames] row
      const int units = 2 * (nf / 4) * BK;
      for (int u = ft; u < units; u += 128) {
        const int k = u % BK, q = u / BK % (nf / 4), p = u / BK / (nf / 4);
        const int fl = f_lo + 4 * q;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int tap = 0; tap < a.taps; ++tap) {
          const float c = co[tap * BK + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pr = __fmul_rn(row(p, r0 + fl + j - tap)[k], c);
            acc[j] = tap ? __fadd_rn(acc[j], pr) : pr;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r0 + fl + j >= a.n) acc[j] = 0.0f;
        send(s, (fl / 8) * kGroupBytes + p * kPlaneBytes + (k * 8 + fl % 8) * 4,
             make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                        __float_as_uint(acc[2]), __float_as_uint(acc[3])));
      }
    }
    // this warp is done with the input stage; thread 0 refills the stage
    // of the chunk before, which all four warps are done with by now
    __syncwarp();
    if (lane == 0) mbar_arrive(in_empty0 + 8 * s);
    if (ft == 0 && kc >= 1 && kc - 1 + S < nk) {
      mbar_wait(in_empty0 + 8 * ((kc - 1) % S), ((kc - 1) / S) & 1);
      prefetch(kc - 1 + S);
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    // new history: rows n .. n+taps-2 of ext
    for (int e = ft; e < h * a.m; e += 128) {
      const int r = a.n + e / a.m;  // row of ext
      const int k = e % a.m;
      const size_t src = r < h ? static_cast<size_t>(r) * a.m + k
                               : static_cast<size_t>(r - h) * a.m + k;
      a.hr_out[e] = r < h ? a.hr[src] : a.zr[src];
      a.hi_out[e] = r < h ? a.hi[src] : a.zi[src];
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still store into it
}
// ---- the consumer warpgroups ------------------------------------------------
// releases stage s of chunk kc to the FIR of every cluster CTA
__device__ __forceinline__ void release(uint32_t empty_bar, int lane, int C) {
  if (lane < C) mbar_arrive_cluster(map_rank(empty_bar, lane));
}

template <int kWG>
__device__ void mma_role(const Args& a, unsigned char* smem) {
  constexpr int BK = Cfg<true>::BK;
  constexpr int kAStage = a_stage<true>(64 * kWG);
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kMaxStages;
  const int S = a.stages, nk = a.m / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const uint32_t ring_a = base + kBarBytes, ring_b = ring_a + S * kAStage;
  float yr[64], yi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) yr[i] = yi[i] = 0.0f;
  fence_regs(yr);
  fence_regs(yi);
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % S;
    mbar_wait_cluster(full0 + 8 * s, (kc / S) & 1);
    fence_proxy_async();  // the shares arrived through generic stores
    // this warpgroup's 64 rows: groups 8 wg .. 8 wg + 7, two planes each
    const uint32_t ar = ring_a + s * kAStage + wg * 8 * kGroupBytes;
    const uint32_t ai = ar + kPlaneBytes;
    const uint32_t wr = ring_b + s * kBStage, wi = wr + kBStage / 2;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t o = ks * 256;  // two core matrices along k
      const uint64_t dar = desc(ar + o, 128, kGroupBytes);
      const uint64_t dai = desc(ai + o, 128, kGroupBytes);
      const uint64_t dwr = desc(wr + o, 128, 512);
      const uint64_t dwi = desc(wi + o, 128, 512);
      wgmma_m64n128k16<1>(yr, dar, dwr);
      wgmma_m64n128k16<-1>(yr, dai, dwi);
      wgmma_m64n128k16<1>(yi, dar, dwi);
      wgmma_m64n128k16<1>(yi, dai, dwr);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of chunk kc - 1 are done
    fence_regs(yr);
    fence_regs(yi);
    if (kc > 0 && warp == 0)
      release(empty0 + 8 * ((kc - 1) % S), lane, a.cluster);
  }
  wgmma_wait<0>();
  fence_regs(yr);
  fence_regs(yi);
  // epilogue: lanes 2q and 2q+1 of a quad swap halves so that each holds
  // four neighbouring columns of one row: 16-byte stores
  const int r0 = blockIdx.y * 64 * kWG + wg * 64;
  const int j0 = blockIdx.x * kBN;
  const bool even = (lane & 1) == 0;
  const int row = 16 * warp + lane / 4 + (even ? 0 : 8);
  const int col = 4 * ((lane % 4) / 2);
  const bool live = r0 + row < a.n;
  const size_t o = static_cast<size_t>(r0 + row) * a.m + j0 + col;
  auto store = [&](float d0, float d1, float d2, float d3, float* out) {
    const float s0 = __shfl_xor_sync(0xffffffffu, even ? d2 : d0, 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, even ? d3 : d1, 1);
    if (live)
      *reinterpret_cast<float4*>(out) = even ? make_float4(d0, d1, s0, s1)
                                             : make_float4(s0, s1, d2, d3);
  };
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    store(yr[4 * b], yr[4 * b + 1], yr[4 * b + 2], yr[4 * b + 3],
          a.yr + o + 8 * b);
    store(yi[4 * b], yi[4 * b + 1], yi[4 * b + 2], yi[4 * b + 3],
          a.yi + o + 8 * b);
  }
  cluster_sync();
}

template <int kWG>
__device__ void fma_role(const Args& a, unsigned char* smem) {
  constexpr int BK = Cfg<false>::BK;
  constexpr int BM = 64 * kWG;
  constexpr int kAStage = a_stage<false>(BM);
  const uint32_t full0 = smem_addr(smem);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const int S = a.stages, nk = a.m / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int ty = t / 16, tx = t % 16;  // frames 4ty (+32), columns 4tx (+64)
  const unsigned char* ring_a = smem + kBarBytes;
  const unsigned char* ring_b = ring_a + S * kAStage;
  float accr[8][8], acci[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) accr[i][j] = acci[i][j] = 0.0f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % S;
    mbar_wait_cluster(full0 + 8 * s, (kc / S) & 1);
    // A: [group][plane][k][8 frames]; B: [plane][k][128 columns]
    const float* a_r = reinterpret_cast<const float*>(ring_a + s * kAStage) +
                       (8 * wg + ty / 2) * (kGroupBytes / 4) + 4 * (ty % 2);
    const float* a_i = a_r + kPlaneBytes / 4;
    const float* b_r =
        reinterpret_cast<const float*>(ring_b + s * kBStage) + 4 * tx;
    const float* b_i = b_r + BK * kBN;
#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      float xr[8], xi[8], wr[8], wi[8];
      *reinterpret_cast<float4*>(&xr[0]) =
          *reinterpret_cast<const float4*>(a_r + k * 8);
      *reinterpret_cast<float4*>(&xr[4]) =
          *reinterpret_cast<const float4*>(a_r + 4 * (kGroupBytes / 4) + k * 8);
      *reinterpret_cast<float4*>(&xi[0]) =
          *reinterpret_cast<const float4*>(a_i + k * 8);
      *reinterpret_cast<float4*>(&xi[4]) =
          *reinterpret_cast<const float4*>(a_i + 4 * (kGroupBytes / 4) + k * 8);
      *reinterpret_cast<float4*>(&wr[0]) =
          *reinterpret_cast<const float4*>(b_r + k * kBN);
      *reinterpret_cast<float4*>(&wr[4]) =
          *reinterpret_cast<const float4*>(b_r + k * kBN + 64);
      *reinterpret_cast<float4*>(&wi[0]) =
          *reinterpret_cast<const float4*>(b_i + k * kBN);
      *reinterpret_cast<float4*>(&wi[4]) =
          *reinterpret_cast<const float4*>(b_i + k * kBN + 64);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          accr[i][j] = fmaf(xr[i], wr[j], accr[i][j]);
          accr[i][j] = fmaf(-xi[i], wi[j], accr[i][j]);
          acci[i][j] = fmaf(xr[i], wi[j], acci[i][j]);
          acci[i][j] = fmaf(xi[i], wr[j], acci[i][j]);
        }
      }
    }
    __syncwarp();  // this warp's reads of stage s are done
    release(empty0 + 8 * s, lane, a.cluster);
  }
  const int r0 = blockIdx.y * BM + wg * 64;
  const int j0 = blockIdx.x * kBN + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = r0 + 4 * ty + (i % 4) + 32 * (i / 4);
    if (f >= a.n) continue;
    const size_t o = static_cast<size_t>(f) * a.m + j0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(a.yr + o + 64 * h) =
          make_float4(accr[i][4 * h], accr[i][4 * h + 1], accr[i][4 * h + 2],
                      accr[i][4 * h + 3]);
      *reinterpret_cast<float4*>(a.yi + o + 64 * h) =
          make_float4(acci[i][4 * h], acci[i][4 * h + 1], acci[i][4 * h + 2],
                      acci[i][4 * h + 3]);
    }
  }
  cluster_sync();
}

template <bool kBf16, int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    channelize_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (threadIdx.x == 0) {
    // full: the local FIR's one arrival, then the bytes of the twiddle tile
    // and of every cluster CTA's share; empty: one arrival from each
    // consumer warpgroup (bf16) or warp (f32) of the cluster; in_full: the
    // input boxes; in_empty: the FIR's four warps have read them
    const int releasers = (kBf16 ? 1 : 4) * kWG * a.cluster;
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(base + 8 * s, 1);
      mbar_init(base + 8 * (kMaxStages + s), releasers);
      mbar_init(base + 8 * (2 * kMaxStages + s), 1);
      mbar_init(base + 8 * (3 * kMaxStages + s), 4);
    }
    fence_barrier_init();
  }
  cluster_sync();  // every CTA's barriers exist before a peer uses them
  // 384 threads start at 168 registers (the launch bound); the consumers
  // may only take what the FIR warpgroup gives back:
  // 2 x (200 - 168) = 168 - 104
  if (threadIdx.x >= 128 * kWG) {
    if constexpr (kWG == 2) regs_dec<104>();
    fir_role<kBf16, kWG>(a, smem);
  } else {
    if constexpr (kWG == 2) regs_inc<200>();
    if constexpr (kBf16)
      mma_role<kWG>(a, smem);
    else
      fma_role<kWG>(a, smem);
  }
}

template <bool kBf16, int kWG>
cudaError_t launch(const Args& a, int smem, cudaStream_t st) {
  auto kernel = channelize_kernel<kBf16, kWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.m / kBN, (a.n + 64 * kWG - 1) / (64 * kWG));
  cfg.blockDim = dim3(128 * (kWG + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library does not link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) f32 row-major map read in boxes of box_rows x box_cols
bool map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// zr, zi (n, m) f32; hist_r, hist_i (taps-1, m) f32; coeff (taps, m) f32;
// tw: the twiddles pre-tiled by channelizer_cuda.tiled_twiddles (bf16 if
// tw_bf16, else f32), every pointer 16-byte aligned -> yr, yi (n, m) f32
// and the new history (taps-1, m) f32 x2.  m % 128 == 0, n >= 1,
// 2 <= taps <= 16.  The plan (channelizer_cuda.launch_plan): frames a CTA
// (64 or 128), the cluster size (dividing m / 128, at most 8), the
// stages of every ring and the dynamic shared memory, which must equal
// this file's sum for the plan.
extern "C" int idsp_channelize(const void* zr, const void* zi,
                               const void* hist_r, const void* hist_i,
                               const void* coeff, const void* tw, void* yr,
                               void* yi, void* hist_r_out, void* hist_i_out,
                               int n, int m, int taps, int tw_bf16,
                               int frames, int cluster, int stages,
                               int smem, void* stream) {
  if (n < 1 || taps < 2 || taps > kMaxTaps || m < kBN || m % kBN ||
      (frames != 64 && frames != 128) || cluster < 1 ||
      cluster > kMaxCluster || (m / kBN) % cluster || stages < 2 ||
      stages > kMaxStages ||
      (n + frames - 1) / frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = frames / 8;
  const int share_max = 8 * ((groups + cluster - 1) / cluster);
  const int want =
      tw_bf16 ? smem_bytes<true>(frames, stages, share_max, taps)
              : smem_bytes<false>(frames, stages, share_max, taps);
  if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  const int bk = tw_bf16 ? Cfg<true>::BK : Cfg<false>::BK;
  const int h = taps - 1;
  if (!map_2d(&a.mz[0], zr, n, m, share_max + h, bk) ||
      !map_2d(&a.mz[1], zi, n, m, share_max + h, bk) ||
      !map_2d(&a.mh[0], hist_r, h, m, h, bk) ||
      !map_2d(&a.mh[1], hist_i, h, m, h, bk) ||
      !map_2d(&a.mc, coeff, taps, m, taps, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  a.zr = static_cast<const float*>(zr);
  a.zi = static_cast<const float*>(zi);
  a.hr = static_cast<const float*>(hist_r);
  a.hi = static_cast<const float*>(hist_i);
  a.tw = static_cast<const unsigned char*>(tw);
  a.yr = static_cast<float*>(yr);
  a.yi = static_cast<float*>(yi);
  a.hr_out = static_cast<float*>(hist_r_out);
  a.hi_out = static_cast<float*>(hist_i_out);
  a.n = n;
  a.m = m;
  a.taps = taps;
  a.cluster = cluster;
  a.stages = stages;
  a.share_max = share_max;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tw_bf16)
    err = frames == 64 ? launch<true, 1>(a, smem, st)
                       : launch<true, 2>(a, smem, st);
  else
    err = frames == 64 ? launch<false, 1>(a, smem, st)
                       : launch<false, 2>(a, smem, st);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}
