// K9 and K10: the CIC integrator cascade over a bank of lanes, as lane
// tiles x time ranges.
//
// Replaces the Pallas kernels of idsp_tpu/filters/cic_pallas.py
// `cic_dec_bank` (:83) and `cic_int_bank` (:131), both the body
// `_integ_body(n)` (:28) on `_seq_bank_kernel` / `_bank_call`
// (biquad_pallas.py:471, :453), where one grid walked all of time in
// order.  The combs run at the slow rate outside the kernel, as in the
// JAX package (cic_pallas.py:72, :113).
//
// * K9 (decimate by R): per row cur = x; int_i += cur; cur = int_i for
//   i = 1..N; the rows 0, R, 2R, ... of cur are kept (cic.py:154,
//   integ[::r]), so only t/R rows reach device memory.
// * K10 (interpolate by R): reads the slow-rate comb output and holds each
//   row R times itself (the JAX kernel reads a materialised jnp.repeat,
//   cic_pallas.py:114), then the same integrators over the t*R fast rows.
//
// Every sum wraps in int32 and is formed in uint32: signed overflow is
// undefined in C++, and the decimator's integrators overflow by design
// (cic.rs:175-199).
//
// What bounds them on the H100: device-memory bytes (K9 reads 4 B a fast
// sample, K10 writes 4 B a fast sample; N adds each).  A walk of all of
// time by one warp a lane tile keeps 16 warps busy at c = 512, each
// waiting on its own loads or stores.  What the design does: the cascade
// is linear over Z/2^32, so time splits into ranges that run at once.  A
// range of L fast rows started from integrators s ends with T^L s + a,
// where a is its end from zero and T^L is lower triangular, T^L[i][j] =
// C(L-1+i-j, i-j) mod 2^32 (diagonal 1); its output row k (stage N-1
// after row k) gains (T^(k+1) s)[N-1], the zero-input response.  The host
// computes T^L and T^(L warps) exactly (filters/cic_cuda.py `carry_map`).
//
// A lane tile of 32 lanes (a warp reads a 128-byte row segment) is a
// thread-block cluster of `cluster` CTAs of `warps` warps (plan:
// filters/cic_cuda.py `cic_plan`); warp w of cluster rank q takes range
// g = q * warps + w of `length` input rows (K9: fast rows, a multiple of
// R, so every kept row lies in one range; K10: slow rows), the last one
// shorter and any past the block empty.
//  1. The local pass from zero: K9 writes its kept rows' local values to
//     ys; both keep the range's end, a, in shared memory.
//  2. The fold: warp 0 of a CTA folds its warps' a with T^L into the CTA's
//     aggregate; the cluster barrier publishes it; each CTA folds its
//     predecessors' aggregates (distributed shared memory) with T^(L warps)
//     onto the carried state, and each warp its own CTA's earlier warps' a
//     with T^L: the range's carry-in S.  No flag is spun on, and a map is
//     only applied to whole ranges and whole CTAs.
//  3. The second pass: K9 adds S's zero-input response (N adds a fast row,
//     no loads) to its kept rows, read back from ys; K10 runs its range
//     again from S, each slow row read again (1/R of its bytes), and
//     writes the fast rows.  The range that ends the block writes s_out.
// With IDSP_CIC_STAMPS defined, lane 0 of each warp of tile 0 stamps
// clock64 at the start, after the local pass, the fold and the second pass
// (idsp_tpu_torch/probe_cascade.py --only cic).
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "seq_bank.cuh"

namespace {

namespace sm90 = idsp::sm90;

constexpr int kLanes = 32;      // lanes of a tile (filters/cic_cuda.py LANES)
constexpr int kMaxOrder = 8;    // integrator stages (MAX_ORDER)
constexpr int kMaxWarps = 32;   // warps of a CTA, one range each (MAX_WARPS)
constexpr int kMaxCluster = 8;  // CTAs of a tile (MAX_CLUSTER)
constexpr int kMapWords = kMaxOrder * (kMaxOrder + 1) / 2;
constexpr int kKeptGroup = 8;  // K9's kept rows read back at once

// Lower-triangular carry maps, rows packed: m[i (i + 1) / 2 + j], j <= i.
struct CicMaps {
  uint32_t range[kMapWords];  // T^length (K10: T^(length R))
  uint32_t cta[kMapWords];    // T^(length warps) (K10: ... R)
};

struct CicArgs {
  const int32_t* xs;
  int32_t* ys;
  const int32_t* s_in;  // (c, n)
  int32_t* s_out;
  int t;  // input rows: K9 fast, K10 slow
  int c, r, length, warps, cluster;
};

#ifdef IDSP_CIC_STAMPS
__device__ long long g_cic_stamps[kMaxCluster * kMaxWarps][4];
#define IDSP_CIC_STAMP(k)                                  \
  if (blockIdx.x < p.cluster && lid == 0)                  \
    g_cic_stamps[g][k] = clock64();
#else
#define IDSP_CIC_STAMP(k)
#endif

template <int N>
struct Integ {
  uint32_t v[N];

  // one fast row of input x; returns stage N-1
  __device__ __forceinline__ uint32_t step(uint32_t x) {
    uint32_t cur = x;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] += cur;
      cur = v[i];
    }
    return cur;
  }
  // v = M v + a(i), M packed lower triangular
  template <class A>
  __device__ __forceinline__ void fold(const uint32_t* m, A a) {
    uint32_t out[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t acc = a(i);
#pragma unroll
      for (int j = 0; j <= i; ++j) acc += m[i * (i + 1) / 2 + j] * v[j];
      out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = out[i];
  }
};

// ld.shared::cluster of a word of another CTA (a `map_rank` address)
__device__ __forceinline__ uint32_t ld_peer(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

template <int N, bool Dec>
__global__ void __launch_bounds__(kMaxWarps* kLanes)
    cic_range_kernel(const CicArgs p, const CicMaps m) {
  extern __shared__ uint32_t smem[];  // agg[warps][N][kLanes], cta[N][kLanes]
  uint32_t* const agg = smem;
  uint32_t* const cta = smem + p.warps * N * kLanes;
  const int lid = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int q = p.cluster > 1 ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int lane = blockIdx.x / p.cluster * kLanes + lid;
  const bool live = lane < p.c;
  const size_t c = p.c;
  const int g = q * p.warps + w;
  const long long from = static_cast<long long>(g) * p.length;
  const int start = from < p.t ? static_cast<int>(from) : p.t;
  const int n = min(p.t - start, p.length);  // rows of this range, >= 0
  const bool work = live && n > 0;
  const int32_t* const xp = p.xs + start * c + lane;
  IDSP_CIC_STAMP(0)

  // 1. the local pass from zero
  Integ<N> s = {};
  if (work) {
    auto load = [&](int i) { return idsp::ldg(xp + i * c); };
    if constexpr (Dec) {
      int32_t* yp = p.ys + start / p.r * c + lane;
      idsp::Keep keep(p.r);
      idsp::seq_rows(n, load, [&](int, int32_t x) {
        const uint32_t y = s.step(static_cast<uint32_t>(x));
        if (keep.next()) {
          *yp = static_cast<int32_t>(y);
          yp += c;
        }
      });
    } else {
      idsp::seq_rows(n, load, [&](int, int32_t x) {
        for (int k = 0; k < p.r; ++k) s.step(static_cast<uint32_t>(x));
      });
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) agg[(w * N + i) * kLanes + lid] = s.v[i];
  __syncthreads();
  IDSP_CIC_STAMP(1)

  // 2. the fold: the range's carry-in
  Integ<N> carry;
#pragma unroll
  for (int i = 0; i < N; ++i)
    carry.v[i] = live ? static_cast<uint32_t>(p.s_in[lane * N + i]) : 0u;
  if (p.cluster > 1) {
    if (w == 0) {
      Integ<N> a = {};
      for (int k = 0; k < p.warps; ++k)
        a.fold(m.range, [&](int i) { return agg[(k * N + i) * kLanes + lid]; });
#pragma unroll
      for (int i = 0; i < N; ++i) cta[i * kLanes + lid] = a.v[i];
    }
    sm90::cluster_sync();  // every CTA's aggregate written
    for (int k = 0; k < q; ++k)
      carry.fold(m.cta, [&](int i) {
        return ld_peer(sm90::map_rank(sm90::smem_addr(cta + i * kLanes + lid),
                                      k));
      });
    sm90::cluster_sync();  // no CTA leaves while a peer reads it
  }
  for (int k = 0; k < w; ++k)
    carry.fold(m.range, [&](int i) { return agg[(k * N + i) * kLanes + lid]; });
  IDSP_CIC_STAMP(2)

  // 3. the second pass from the carry-in
  if (work) {
    Integ<N> z = carry;
    if constexpr (Dec) {
      int32_t* const yp = p.ys + start / p.r * c + lane;
      const int kept = n / p.r;
      for (int j0 = 0; j0 < kept; j0 += kKeptGroup) {
        uint32_t y[kKeptGroup];
#pragma unroll
        for (int u = 0; u < kKeptGroup; ++u)
          if (j0 + u < kept) y[u] = static_cast<uint32_t>(yp[(j0 + u) * c]);
#pragma unroll
        for (int u = 0; u < kKeptGroup; ++u) {
          if (j0 + u < kept) {
            y[u] += z.step(0u);
            for (int k = 1; k < p.r; ++k) z.step(0u);
          }
        }
#pragma unroll
        for (int u = 0; u < kKeptGroup; ++u)
          if (j0 + u < kept) yp[(j0 + u) * c] = static_cast<int32_t>(y[u]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) z.v[i] += s.v[i];  // T^n S + a
    } else {
      int32_t* const yp = p.ys + static_cast<size_t>(start) * p.r * c + lane;
      idsp::seq_rows(
          n, [&](int i) { return idsp::ldg(xp + i * c); },
          [&](int i, int32_t x) {
            int32_t* out = yp + static_cast<size_t>(i) * p.r * c;
            for (int k = 0; k < p.r; ++k)
              out[k * c] = static_cast<int32_t>(
                  z.step(static_cast<uint32_t>(x)));
          });
    }
    if (start + n == p.t) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        p.s_out[lane * N + i] = static_cast<int32_t>(z.v[i]);
    }
  }
  IDSP_CIC_STAMP(3)
}

using KernelFn = void (*)(CicArgs, CicMaps);

// the kernel of order n (1 <= n <= 8), or null
template <bool Dec>
KernelFn pick(int n) {
#define IDSP_CIC_CASE(N) \
  case N:                \
    return cic_range_kernel<N, Dec>;
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

// The plan `cic_plan` makes: shared memory 4 bytes a lane of each warp's
// aggregate and of the CTA's; every range a warp; kept rows in one range.
bool plan_ok(bool dec, int t, int c, int n, int r, int cluster, int warps,
             int length, int smem) {
  if (t < 1 || c < 1 || n < 1 || n > kMaxOrder || r < 1 || cluster < 1 ||
      cluster > kMaxCluster || warps < 1 || warps > kMaxWarps || length < 1)
    return false;
  if (dec && (t % r != 0 || length % r != 0)) return false;
  if (!dec && static_cast<long long>(t) * r > 0x7fffffffLL) return false;
  const long long ranges = (static_cast<long long>(t) + length - 1) / length;
  return ranges <= static_cast<long long>(cluster) * warps &&
         smem == 4 * kLanes * n * (warps + 1);
}

template <bool Dec>
int launch(const void* xs, void* ys, const void* s_in, void* s_out,
           const void* maps, int t, int c, int n, int r, int cluster,
           int warps, int length, int smem, void* stream) {
  if (!plan_ok(Dec, t, c, n, r, cluster, warps, length, smem) ||
      maps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const CicArgs args{static_cast<const int32_t*>(xs),
                     static_cast<int32_t*>(ys),
                     static_cast<const int32_t*>(s_in),
                     static_cast<int32_t*>(s_out), t, c, r, length, warps,
                     cluster};
  CicMaps m = {};
  const uint32_t* words = static_cast<const uint32_t*>(maps);
  for (int k = 0; k < kMapWords; ++k) {
    m.range[k] = words[k];
    m.cta[k] = words[kMapWords + k];
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + kLanes - 1) / kLanes * cluster);
  cfg.blockDim = dim3(warps * kLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, pick<Dec>(n), args, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9: xs (t, c) i32 -> ys (t/r, c) i32, the integrator output at rows 0,
// r, 2r, ...; integrators s (c, n) i32 in and out; 1 <= n <= 8,
// t % r == 0.  maps: 2 x 36 host words, T^length then T^(length warps)
// packed as `CicMaps`; cluster, warps, length and smem are the host plan's
// (filters/cic_cuda.py `cic_plan`); a plan the kernel cannot run is
// refused.
extern "C" int idsp_cic_dec_bank(const void* xs, void* ys, const void* s_in,
                                 void* s_out, const void* maps, int t, int c,
                                 int n, int r, int cluster, int warps,
                                 int length, int smem, void* stream) {
  return launch<true>(xs, ys, s_in, s_out, maps, t, c, n, r, cluster, warps,
                      length, smem, stream);
}

// K10: xs (t, c) i32 slow-rate comb output -> ys (t*r, c) i32, each row
// held r times through the integrators; s (c, n) i32 in and out; 1 <= n
// <= 8; length in slow rows, the maps of length * r fast rows.
extern "C" int idsp_cic_int_bank(const void* xs, void* ys, const void* s_in,
                                 void* s_out, const void* maps, int t, int c,
                                 int n, int r, int cluster, int warps,
                                 int length, int smem, void* stream) {
  return launch<false>(xs, ys, s_in, s_out, maps, t, c, n, r, cluster, warps,
                       length, smem, stream);
}

#ifdef IDSP_CIC_STAMPS
extern "C" int probe_cic_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_cic_stamps,
                                               sizeof(g_cic_stamps)));
}
#endif
