// Hopper (sm_90a) building blocks as inline PTX, for K17's kernels
// (channelize.cu), K38-K40's (wdf_bank.cu) and the DF1 warp's rings of
// K2/K3/K19-K21, K14 and K15 (df1_ring.cuh): mbarriers and the ring
// cursor over them, named barriers, cp.async arriving on them,
// asynchronous copies of the TMA (1-D bulk copies, boxes of 2-D tensor
// maps), the thread-block cluster's ranks, mapped addresses, arrivals on
// and asynchronous stores into peer CTAs and barrier, warpgroup register
// rebalancing, and `wgmma` with shared-memory operand descriptors.
//
// Operand layout of the descriptors made here (no swizzle, both operands
// K-major): a "core matrix" is 8 rows x 16 bytes (8 bf16 along k), its
// rows 16 bytes apart, 128 contiguous bytes.  LBO is the byte distance
// between the two core matrices of a k16 step (along k), SBO the distance
// between core matrices 8 rows apart (along m or n).  The accumulator of
// m64nNk16 (f32): warp w of the warpgroup holds rows 16w .. 16w+15;
// register i of lane l is row 16w + l/4 + 8 ((i/2) % 2), column
// 8 (i/4) + 2 (l % 4) + i % 2.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace idsp {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (addresses in this CTA's shared memory) -------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the cluster (then sync it)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the same, acquiring at cluster scope what other CTAs released into it
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// 4 bytes device memory -> this CTA's shared memory (the non-bulk cp.async)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// 16 bytes device memory -> this CTA's shared memory, both 16-byte aligned
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// one arrival on the mbarrier once this thread's cp.asyncs so far have
// landed (noinc: it counts against the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Chunk q's slot k = q % depth of a ring of mbarrier-guarded slots and its
// phase parity ph = (q / depth) & 1, stepped chunk by chunk: a consumer
// waits full(k) at ph, a producer empty(k) at ph ^ 1 (a fresh barrier
// passes).
struct Cursor {
  int k = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int depth) {
    if (++k == depth) {
      k = 0;
      ph ^= 1;
    }
  }
};

// the named barrier `id` (1-15; 0 is __syncthreads') of `threads` threads,
// whole warps
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- the cluster ----------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared-memory word in cluster CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// arrive on an mbarrier of a cluster CTA (a `map_rank` address)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the same, releasing at cluster scope what this thread did before (its
// reads of a slot the peer then overwrites)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}
// one arrival on a cluster CTA's mbarrier that also expects `bytes` more
// of asynchronous stores (`store_to_peer32`) into its phase
__device__ __forceinline__ void mbar_arrive_tx_remote(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, "
      "[%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---- asynchronous copies and stores (complete on an mbarrier's tx count) --
// device memory -> this CTA's shared memory; 16-byte aligned, bytes % 16 == 0
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// a box of a 2-D tensor map (c0 the inner, column coordinate; rows out of
// the tensor, negative ones too, arrive as zeros) -> this CTA's shared
// memory, 128-byte aligned; the map lives in kernel parameter space
__device__ __forceinline__ void tensor_load_2d(uint32_t dst, const void* map,
                                               int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// 16 bytes into a cluster CTA's shared memory, counted on its mbarrier
// (dst and bar `map_rank`ed; the complete_tx releases at cluster scope)
__device__ __forceinline__ void store_to_peer(uint32_t dst, uint4 v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// 4 bytes into a cluster CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void store_to_peer32(uint32_t dst, uint32_t v,
                                                uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(v), "r"(bar)
      : "memory");
}
// orders the generic-proxy shared-memory writes this thread has seen (its
// own, or acquired through a barrier) before its later async-proxy reads
// of them (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroup register rebalancing ----------------------------------------
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma ------------------------------------------------------------------
// descriptor of a K-major, unswizzled operand at shared address `addr`
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32) += A (64 x 16 bf16) * (kScaleB * B) (16 x 128 bf16);
// kScaleB is +1 or -1 (the product negated exactly by the tensor core)
template <int kScaleB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, %67, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kScaleB));
}

}  // namespace sm90
}  // namespace idsp
