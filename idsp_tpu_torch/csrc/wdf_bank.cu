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
// the apply is `__mulhi`, the exact high word of the signed 64-bit
// product, and every sum wraps mod 2^32 (formed in uint32: signed
// overflow is undefined in C++), so any schedule of the same operations
// gives the reference's words.
//
// What bounds them on the H100: the recurrence.  A sample walks the
// adapters of a stage (one `Wdf<N, M>` of the reference) in order, each
// reading its stage's old z, so a stage is a few dependent operations an
// adapter (a signed high-word product ~9 cycles, an add ~4); a stage's
// input is the stage before's output of the same sample, so stages
// pipeline across samples.  The bytes are 4 B in and 4 B out a sample
// (8 B out for K40).
//
// What the design does (the host's plan: filters/wdf_cuda.py
// `launch_plan`, which the entry point checks):
//
// * A block is a tile of 32 lanes (lane = channel) and one warp per
//   serial stage, branch 0's stages then branch 1's, a loader warp and a
//   store warp.  Warp s runs stage s over the whole block of time in
//   chunks of rows, its stage's z words in registers throughout, so a row
//   costs the slowest stage's time and not the sum over the stages.
// * A stage's output chunk goes to the next warp through a ring of `depth`
//   slots in shared memory, a slot [row][lane] (every access one
//   conflict-free 128-byte row), each slot with a full and an empty
//   mbarrier (chunk q uses slot q % depth at parity (q / depth) & 1).  The
//   loader fills the input ring with cp.async, each lane's copies
//   completing on the slot's full barrier; both branches' first stages
//   read it, and its empty barrier counts both.  Each branch's last stage
//   writes a ring that the store warp reads, forming a pair's butterfly.
//   The loader and the store warp move 16 bytes a thread (four lanes of a
//   row, a warp four rows an instruction) where c % 4 == 0 and the rows
//   are 16-byte aligned, else 4: a stage warp storing its own row of y to
//   device memory spent more issue time on the store than on its chain.
// * Each warp picks its loop with one switch on its stage's kind before
//   the time loop: a stage (N, M) of kSpecs has its own instance, every
//   adapter compiled to its own form (wdf.rs:65-101; X and Z register
//   renames) with the coefficient in a register, the chunk's inputs read
//   a group of rows ahead; any other stage runs the generic loop.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using idsp::sm90::cp_async16;
using idsp::sm90::Cursor;
using idsp::sm90::cp_async4;
using idsp::sm90::cp_async_arrive;
using idsp::sm90::cp_async_wait_all;
using idsp::sm90::mbar_arrive;
using idsp::sm90::mbar_init;
using idsp::sm90::mbar_wait;
using idsp::sm90::smem_addr;

constexpr int kLanes = 32;   // lanes of a tile (one warp)
constexpr int kWdfMax = 24;  // adapters (and so stages) of one launch
constexpr int kMaxSmem = 232448;  // bytes a block may have

// The (N, M) stages with a loop of their own, kind k + 1 for kSpecs[k]
// (filters/wdf_cuda.py SPECIALISED): M holds adapter j's type in nibble j
// (wdf.rs:104-113).
struct Spec {
  int n;
  uint32_t m;
};
constexpr Spec kSpecs[] = {{1, 0x1}, {1, 0xA}, {2, 0xAD}, {2, 0x1C},
                           {2, 0x1D}};

// The launch's adapters as rows of the generic form (GenericStage).
struct FormTable {
  int32_t a[kWdfMax], sc[kWdfMax], wx0[kWdfMax], wx1[kWdfMax],
      nx0[kWdfMax], nx1[kWdfMax];
};

// The launch's stages, by value: branch 0's stages, then branch 1's.
struct WdfParams {
  int stages, s0;        // stages of both branches; of branch 0
  int first[kWdfMax];    // a stage's first adapter
  int len[kWdfMax];      // its adapters
  int kind[kWdfMax];     // 0: the generic loop, k + 1: kSpecs[k]'s
  int32_t a[kWdfMax];    // per adapter, the Q32<32> coefficient
  FormTable forms;       // per adapter, its generic form
};

// Rings of a launch: the input's, one before every stage but each
// branch's first, and one after each branch's last stage.
__host__ __device__ inline int ring_count(const WdfParams& p) {
  return p.stages + 1;
}

// Dynamic shared memory of `rings` rings of `depth` slots: two 8-byte
// barriers and chunk rows of kLanes words a slot.
__host__ __device__ inline size_t smem_bytes(int rings, int chunk,
                                             int depth) {
  return static_cast<size_t>(rings) * depth *
         (16 + static_cast<size_t>(chunk) * kLanes * sizeof(uint32_t));
}

__device__ __forceinline__ uint32_t mul(int32_t a, uint32_t c) {
  return static_cast<uint32_t>(__mulhi(a, static_cast<int32_t>(c)));
}

// One two-port adapter of type T (wdf.rs:65-101, filters/wdf.py `_adapt`)
// on words mod 2^32: (x0, x1) -> (w, next).
template <int T>
__device__ __forceinline__ void adapt(uint32_t x0, uint32_t x1, int32_t a,
                                      uint32_t& w, uint32_t& nx) {
  if constexpr (T == 0xA) {  // A
    const uint32_t c = x1 - x0, y = mul(a, c) + x1;
    w = y + c;
    nx = y;
  } else if constexpr (T == 0xB) {  // B
    const uint32_t c = x0 - x1, y = mul(a, c) + x1;
    w = y;
    nx = y + c;
  } else if constexpr (T == 0xE) {  // B1
    const uint32_t y = mul(a, x0 - x1);
    w = y + x1;
    nx = y + x0;
  } else if constexpr (T == 0x1) {  // X
    w = x1;
    nx = x0;
  } else if constexpr (T == 0xC) {  // C
    const uint32_t c = x1 - x0, y = mul(a, c) - x1;
    w = y;
    nx = y + c;
  } else if constexpr (T == 0xF) {  // C1
    const uint32_t y = mul(a, x1 - x0);
    w = y - x1;
    nx = y - x0;
  } else if constexpr (T == 0xD) {  // D
    const uint32_t c = x0 - x1, y = mul(a, c) - x1;
    w = y + c;
    nx = y;
  } else {  // Z: terminate
    w = x0;
    nx = x1;
  }
}

// A stage (N, M) of kSpecs: one sample through its N adapters in order
// (wdf.rs:155-171): each reads its stage's old z and writes the one
// before it, w_0 is the output and the last next lands in z[N-1].
template <int N, uint32_t M>
struct SpecStage {
  static constexpr int kN = N;
  static constexpr bool kRolled = false;
  uint32_t z[N];
  int32_t a[N];

  __device__ SpecStage(const WdfParams& p, int s) {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = p.a[p.first[s] + i];
  }

  template <int I>
  __device__ __forceinline__ void through(uint32_t& cur, uint32_t& y) {
    if constexpr (I < N) {
      uint32_t w, nx;
      adapt<(M >> (4 * I)) & 0xF>(cur, z[I], a[I], w, nx);
      if constexpr (I == 0) {
        y = w;
      } else {
        z[I - 1] = w;
      }
      cur = nx;
      through<I + 1>(cur, y);
    }
  }

  __device__ __forceinline__ uint32_t step(uint32_t x) {
    uint32_t cur = x, y = 0;
    through<0>(cur, y);
    z[N - 1] = cur;
    return y;
  }
};

// Any other stage: the branch-free form of every type, c = sc (x1 - x0),
// m = mulhi(a, c), w = m + wx0 x0 + wx1 x1, next = m + nx0 x0 + nx1 x1,
// with sc = +-1 and small integer weights (kForms; B and B1 are one
// function, C and C1 another; X and Z take a = 0): every product of x0 or
// x1 is a ring operation mod 2^32 and c is the reference's wrapped x1 - x0
// or x0 - x1, so the words are the reference's.  The adapters' forms are
// a table in the kernel's parameters (FormTable, filled on the host) and
// the loop over them is rolled, z in local memory (a runtime index): slow
// (wdf-ca-19 on it: ~8 ms), and off the suite's path.
struct Form {
  int type, sc, wx0, wx1, nx0, nx1, uses_a;
};
constexpr Form kForms[] = {
    {0xA, 1, -1, 2, 0, 1, 1},    // A:  w = m - x0 + 2 x1, next = m + x1
    {0xB, -1, 0, 1, 1, 0, 1},    // B:  w = m + x1, next = m + x0
    {0xE, -1, 0, 1, 1, 0, 1},    // B1: the same function
    {0x1, 1, 0, 1, 1, 0, 0},     // X:  w = x1, next = x0
    {0xC, 1, 0, -1, -1, 0, 1},   // C:  w = m - x1, next = m - x0
    {0xF, 1, 0, -1, -1, 0, 1},   // C1: the same function
    {0xD, -1, 1, -2, 0, -1, 1},  // D:  w = m + x0 - 2 x1, next = m - x1
    {0x0, 1, 1, 0, 0, 1, 0},     // Z:  w = x0, next = x1
};

struct GenericStage {
  static constexpr int kN = kWdfMax;
  static constexpr bool kRolled = true;
  uint32_t z[kWdfMax];
  int n, j0;
  const FormTable* f;

  __device__ GenericStage(const WdfParams& p, int s, const FormTable* t)
      : n(p.len[s]), j0(p.first[s]), f(t) {}

  __device__ __forceinline__ uint32_t step(uint32_t x) {
    uint32_t cur = x, y = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int j = j0 + i;
      const uint32_t x0 = cur, x1 = z[i];
      const uint32_t m = mul(f->a[j], (x1 - x0) * f->sc[j]);
      const uint32_t w = m + f->wx0[j] * x0 + f->wx1[j] * x1;
      cur = m + f->nx0[j] * x0 + f->nx1[j] * x1;
      if (i == 0) {
        y = w;
      } else {
        z[i - 1] = w;
      }
    }
    z[n - 1] = cur;
    return y;
  }
};

// The rings in dynamic shared memory: every barrier first (ring r, slot
// k: full at 16 (r * depth + k), empty 8 bytes after), then the slots,
// chunk rows of kLanes words each (16-byte aligned).
struct Rings {
  uint32_t bars;   // shared address of the barriers
  uint32_t* buf;   // the slots
  int depth, chunk;

  __device__ uint32_t full(int r, int k) const {
    return bars + 16 * (r * depth + k);
  }
  __device__ uint32_t empty(int r, int k) const { return full(r, k) + 8; }
  __device__ uint32_t* slot(int r, int k) const {
    return buf + static_cast<size_t>(r * depth + k) * chunk * kLanes;
  }
};

// A thread's place: rows t, lanes c; its lane, its index in the warp;
// live: lane < c (dead lanes still reach every barrier); vec: c % 4 == 0
// and xs, ys 16-byte aligned, so that the loader and the store warp move
// 16 bytes a thread (4 lanes of a row, a warp 4 rows an instruction).
struct Lane {
  int t, c, lane, lid;
  bool live, vec;
};

// One chunk of rows through the stage, from slot x to slot y: the
// specialised stages in groups of kGroup rows, each group's inputs read
// before the group before computes (the compiler would not move a load
// above the stores to y, which it cannot tell apart from x), so that the
// loads stay off the stage's serial chain; the generic stage a row at a
// time (its code is long).
constexpr int kGroup = 8;
template <class Stage>
__device__ __forceinline__ void chunk_rows(Stage& st, const uint32_t* x,
                                           uint32_t* y, int rows) {
  int r = 0;
  if constexpr (!Stage::kRolled) {
    if (rows >= kGroup) {
      uint32_t cur[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) cur[u] = x[u * kLanes];
      for (; r + kGroup <= rows; r += kGroup) {
        const bool more = r + 2 * kGroup <= rows;
        uint32_t nxt[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          nxt[u] = more ? x[(r + kGroup + u) * kLanes] : 0u;
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          y[(r + u) * kLanes] = st.step(cur[u]);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) cur[u] = nxt[u];
      }
    }
  }
#pragma unroll 1
  for (; r < rows; ++r) y[r * kLanes] = st.step(x[r * kLanes]);
}

// Stage s's warp: its z words in from z_in, every chunk from ring `in`
// through the stage into ring `out`, the z words out.
template <class Stage>
__device__ __forceinline__ void run(Stage st, const WdfParams& p, int s,
                                    const Rings& R, int in, int out,
                                    const int32_t* __restrict__ z_in,
                                    int32_t* __restrict__ z_out,
                                    const Lane& L) {
  const int n = p.len[s], j0 = p.first[s];
  const size_t c = static_cast<size_t>(L.c);
#pragma unroll
  for (int i = 0; i < Stage::kN; ++i)
    st.z[i] = i < n && L.live ? static_cast<uint32_t>(
                                    z_in[(j0 + i) * c + L.lane])
                              : 0u;
  Cursor u;
  for (int r0 = 0; r0 < L.t; r0 += R.chunk, u.next(R.depth)) {
    mbar_wait(R.full(in, u.k), u.ph);
    mbar_wait(R.empty(out, u.k), u.ph ^ 1);  // a fresh barrier passes
    chunk_rows(st, R.slot(in, u.k) + L.lid, R.slot(out, u.k) + L.lid,
               min(R.chunk, L.t - r0));
    mbar_arrive(R.full(out, u.k));
    mbar_arrive(R.empty(in, u.k));
  }
  if (L.live)
#pragma unroll
    for (int i = 0; i < Stage::kN; ++i)
      if (i < n) z_out[(j0 + i) * c + L.lane] = static_cast<int32_t>(st.z[i]);
}

// The stage's loop: one switch on its kind, before the time loop.
__device__ __forceinline__ void dispatch(const WdfParams& p, int s,
                                         const Rings& R, int in, int out,
                                         const FormTable* forms,
                                         const int32_t* z_in, int32_t* z_out,
                                         const Lane& L) {
  switch (p.kind[s]) {
    case 1:
      run(SpecStage<kSpecs[0].n, kSpecs[0].m>(p, s), p, s, R, in, out, z_in,
          z_out, L);
      break;
    case 2:
      run(SpecStage<kSpecs[1].n, kSpecs[1].m>(p, s), p, s, R, in, out, z_in,
          z_out, L);
      break;
    case 3:
      run(SpecStage<kSpecs[2].n, kSpecs[2].m>(p, s), p, s, R, in, out, z_in,
          z_out, L);
      break;
    case 4:
      run(SpecStage<kSpecs[3].n, kSpecs[3].m>(p, s), p, s, R, in, out, z_in,
          z_out, L);
      break;
    case 5:
      run(SpecStage<kSpecs[4].n, kSpecs[4].m>(p, s), p, s, R, in, out, z_in,
          z_out, L);
      break;
    default:
      run(GenericStage(p, s, forms), p, s, R, in, out, z_in, z_out, L);
      break;
  }
}

// The loader warp: xs rows into ring 0's slots through cp.async, each
// lane's copies arriving on the slot's full barrier when they land (the
// barrier counts the warp's 32 lanes): 16 bytes a thread (row lid / 8 + 4j,
// lanes 4 (lid % 8) .. +3) where L.vec, else 4 bytes (its lane, every row).
__device__ __forceinline__ void load(const int32_t* __restrict__ xs,
                                     const Rings& R, const Lane& L) {
  const size_t c = static_cast<size_t>(L.c);
  const int l4 = 4 * (L.lid % 8), lane4 = L.lane - L.lid + l4;
  Cursor u;
  for (int r0 = 0; r0 < L.t; r0 += R.chunk, u.next(R.depth)) {
    const int rows = min(R.chunk, L.t - r0);
    mbar_wait(R.empty(0, u.k), u.ph ^ 1);
    const uint32_t slot = smem_addr(R.slot(0, u.k));
    const int32_t* src = xs + static_cast<size_t>(r0) * c;
    if (L.vec) {
      if (lane4 < L.c)
        for (int r = L.lid / 8; r < rows; r += 4)
          cp_async16(slot + 4 * (r * kLanes + l4), src + r * c + lane4);
    } else if (L.live) {
      for (int r = 0; r < rows; ++r)
        cp_async4(slot + 4 * (r * kLanes + L.lid), src + r * c + L.lane);
    }
    cp_async_arrive(R.full(0, u.k));
  }
  cp_async_wait_all();
}

// The store warp: each chunk of the last stage's output ring y0 (and, for
// a pair, branch 1's y1, with the butterfly y0 + y1, y0 - y1 wrapping)
// into ys0 (and ys1); 16 bytes a thread where L.vec, else 4.
__device__ __forceinline__ void store(int32_t* __restrict__ ys0,
                                      int32_t* __restrict__ ys1,
                                      const Rings& R, int y0, int y1,
                                      bool pair, const Lane& L) {
  const size_t c = static_cast<size_t>(L.c);
  const int l4 = 4 * (L.lid % 8), lane4 = L.lane - L.lid + l4;
  Cursor u;
  for (int r0 = 0; r0 < L.t; r0 += R.chunk, u.next(R.depth)) {
    const int rows = min(R.chunk, L.t - r0);
    const size_t row0 = static_cast<size_t>(r0);
    mbar_wait(R.full(y0, u.k), u.ph);
    if (pair) mbar_wait(R.full(y1, u.k), u.ph);
    const uint32_t* a = R.slot(y0, u.k);
    const uint32_t* b = R.slot(y1, u.k);
    if (L.vec) {
      if (lane4 < L.c)
        for (int r = L.lid / 8; r < rows; r += 4) {
          const uint4 v0 =
              *reinterpret_cast<const uint4*>(a + r * kLanes + l4);
          int32_t* o0 = ys0 + (row0 + r) * c + lane4;
          if (pair) {
            const uint4 v1 =
                *reinterpret_cast<const uint4*>(b + r * kLanes + l4);
            *reinterpret_cast<uint4*>(o0) = make_uint4(
                v0.x + v1.x, v0.y + v1.y, v0.z + v1.z, v0.w + v1.w);
            *reinterpret_cast<uint4*>(ys1 + (row0 + r) * c + lane4) =
                make_uint4(v0.x - v1.x, v0.y - v1.y, v0.z - v1.z,
                           v0.w - v1.w);
          } else {
            *reinterpret_cast<uint4*>(o0) = v0;
          }
        }
    } else if (L.live) {
      for (int r = 0; r < rows; ++r) {
        const uint32_t v0 = a[r * kLanes + L.lid];
        const size_t at = (row0 + r) * c + L.lane;
        if (pair) {
          const uint32_t v1 = b[r * kLanes + L.lid];
          ys0[at] = static_cast<int32_t>(v0 + v1);
          ys1[at] = static_cast<int32_t>(v0 - v1);
        } else {
          ys0[at] = static_cast<int32_t>(v0);
        }
      }
    }
    mbar_arrive(R.empty(y0, u.k));
    if (pair) mbar_arrive(R.empty(y1, u.k));
  }
}

__global__ void __launch_bounds__(kLanes*(kWdfMax + 2))
    wdf_pipeline_kernel(const int32_t* __restrict__ xs,
                        int32_t* __restrict__ ys0, int32_t* __restrict__ ys1,
                        const int32_t* __restrict__ z_in,
                        int32_t* __restrict__ z_out, int t, int c, int chunk,
                        int depth, int vec,
                        const __grid_constant__ WdfParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kLanes, lid = threadIdx.x % kLanes;
  const int stages = p.stages, lane = blockIdx.x * kLanes + lid;
  const bool pair = stages > p.s0;
  const int branches = pair ? 2 : 1;
  const Lane L{t, c, lane, lid, lane < c, vec != 0};
  const Rings R{smem_addr(smem),
                reinterpret_cast<uint32_t*>(smem + 16 * ring_count(p) * depth),
                depth, chunk};
  if (threadIdx.x == 0) {
    for (int r = 0; r < ring_count(p); ++r)
      for (int k = 0; k < depth; ++k) {
        mbar_init(R.full(r, k), kLanes);
        mbar_init(R.empty(r, k), kLanes * (r == 0 ? branches : 1));
      }
    idsp::sm90::fence_barrier_init();
  }
  __syncthreads();
  // rings: 0 the input; stage s > its branch's first reads ring s (branch
  // 0) or s - 1 (branch 1); branch b's last stage writes ring
  // stages - branches + 1 + b, which the store warp reads
  const int y0 = stages - branches + 1;
  if (warp == stages) {
    load(xs, R, L);
  } else if (warp == stages + 1) {
    store(ys0, ys1, R, y0, y0 + 1, pair, L);
  } else {
    const int s = warp;
    const bool b1 = s >= p.s0;
    const int last = b1 ? stages - 1 : p.s0 - 1;
    const int in = s == (b1 ? p.s0 : 0) ? 0 : b1 ? s - 1 : s;
    const int out = s != last ? (b1 ? s : s + 1) : y0 + (b1 ? 1 : 0);
    dispatch(p, s, R, in, out, &p.forms, z_in, z_out, L);
  }
}

// The kind of a stage of n adapters with type nibbles m: its kSpecs
// index + 1, or 0.
int spec_kind(int n, uint32_t m) {
  for (int k = 0; k < static_cast<int>(sizeof(kSpecs) / sizeof(Spec)); ++k)
    if (kSpecs[k].n == n && kSpecs[k].m == m) return k + 1;
  return 0;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// K38-K40: xs (t, c) i32 -> ys0 (t, c) i32 (the chain's output, or the
// pair's sum) and, with s1 > 0, ys1 (the pair's difference); z_in, z_out
// (n, c) i32 planes, stage after stage, branch 0 first.  types and coefs
// are host arrays of the n adapters, lens and kinds of the s0 + s1 stages
// (a kind 0 for the generic loop, or the stage's own kSpecs kind); chunk,
// depth and smem the host plan's (smem must be the kernel's own sum, at
// most a block's).  A refused call launches nothing and leaves no CUDA
// error pending.
extern "C" int idsp_wdf_bank(const void* xs, void* ys0, void* ys1,
                             const void* z_in, void* z_out, const int* types,
                             const int* coefs, const int* lens,
                             const int* kinds, int t, int c, int s0, int s1,
                             int chunk, int depth, int smem, void* stream) {
  // (an empty block of rows has no outputs: its pointers may be null)
  if (t < 0 || c < 1 || s0 < 1 || s1 < 0 || s0 + s1 > kWdfMax ||
      (t > 0 && (ys0 == nullptr || (s1 > 0 && ys1 == nullptr))) ||
      chunk < 1 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WdfParams p{};
  p.stages = s0 + s1;
  p.s0 = s0;
  int n = 0;
  for (int s = 0; s < p.stages; ++s) {
    if (lens[s] < 1 || n + lens[s] > kWdfMax)
      return static_cast<int>(cudaErrorInvalidValue);
    uint32_t m = 0;
    for (int i = 0; i < lens[s]; ++i) {
      const int ty = types[n + i];
      const Form* f = nullptr;
      for (const Form& g : kForms)
        if (g.type == ty) f = &g;
      if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const int j = n + i;
      p.a[j] = coefs[j];
      p.forms.a[j] = f->uses_a ? coefs[j] : 0;
      p.forms.sc[j] = f->sc;
      p.forms.wx0[j] = f->wx0;
      p.forms.wx1[j] = f->wx1;
      p.forms.nx0[j] = f->nx0;
      p.forms.nx1[j] = f->nx1;
      if (i < 8) m |= static_cast<uint32_t>(ty) << (4 * i);
    }
    const int own = lens[s] <= 8 ? spec_kind(lens[s], m) : 0;
    if (kinds[s] != 0 && kinds[s] != own)
      return static_cast<int>(cudaErrorInvalidValue);
    p.first[s] = n;
    p.len[s] = lens[s];
    p.kind[s] = kinds[s];
    n += lens[s];
  }
  const size_t want = smem_bytes(ring_count(p), chunk, depth);
  if (static_cast<size_t>(smem) != want ||
      want > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wdf_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int vec = c % 4 == 0 && aligned16(xs) && aligned16(ys0) &&
                  (s1 == 0 || aligned16(ys1));
  const dim3 grid((c + kLanes - 1) / kLanes);
  wdf_pipeline_kernel<<<grid, kLanes * (p.stages + 2), want,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(ys0),
      static_cast<int32_t*>(ys1), static_cast<const int32_t*>(z_in),
      static_cast<int32_t*>(z_out), t, c, chunk, depth, vec, p);
  return static_cast<int>(cudaGetLastError());
}
