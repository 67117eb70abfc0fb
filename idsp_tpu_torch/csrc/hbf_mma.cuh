// The bf16 tensor-core pieces of K22/K23's "split3" and "default" kernels
// (hbf_mxu.cu): the m16n8k16 fragment maps, `ldmatrix` and `mma.sync` as
// inline PTX, and the bf16 split of an f32 value.
//
// Fragment maps (PTX ISA, "Matrix Fragments for mma.m16n8k16" with .bf16),
// lane = 4 * g + q (g the group, q the thread in the group), each 32-bit
// register two bf16 values, the lower index in the low half:
//
//   A (16 x 16, row-major)  reg 0: A[g][2q, 2q+1]    reg 1: A[g+8][2q, 2q+1]
//                          reg 2: A[g][2q+8, 2q+9]  reg 3: A[g+8][2q+8, 2q+9]
//   B (16 x 8, k x n)       reg 0: B[2q, 2q+1][g]    reg 1: B[2q+8, 2q+9][g]
//   C, D (16 x 8, f32)      c0, c1: C[g][2q, 2q+1]   c2, c3: C[g+8][2q, 2q+1]
//
// `ldmatrix.x4` loads four 8 x 8 bf16 matrices whose eight rows (16 bytes
// each) come from the addresses of lanes 8i .. 8i+7 for matrix i; lane
// 4g+q gets M_i[g][2q, 2q+1], or with `.trans` M_i[2q, 2q+1][g].  So a
// row-major A tile comes from matrices (rows 0-7, k 0-7), (rows 8-15,
// k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15), and a B tile stored
// [k][n] (k-major rows of lanes) with `.trans` from (k 0-7, n), (k 8-15,
// n) for two n8 tiles at a time.  The maps are __host__ __device__ so that
// a scalar emulation can be held against them off the card.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace idsp {
namespace mma {

// (row, n) of accumulator i (0-3) held by lane.
__host__ __device__ inline void c_index(int lane, int i, int& row, int& n) {
  row = (lane >> 2) + 8 * (i >> 1);
  n = 2 * (lane & 3) + (i & 1);
}

// The row of matrix (lane >> 3) whose address lane gives to ldmatrix.x4:
// for an A tile, A row and k offset; for a B tile (.trans), k offset and
// which of the two n8 tiles.
__host__ __device__ inline void a_ldm_row(int lane, int& row, int& k) {
  row = (lane & 7) + 8 * ((lane >> 3) & 1);
  k = 8 * (lane >> 4);
}
__host__ __device__ inline void b_ldm_row(int lane, int& k, int& tile) {
  k = (lane & 7) + 8 * ((lane >> 3) & 1);
  tile = lane >> 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory (row address p of this
// lane's row, see a_ldm_row / b_ldm_row).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A * B, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 bits of v rounded to nearest even, and of the exact remainder
// v - hi rounded the same way (the TPU's split: hi + lo carries about 16
// significant bits of v).
__device__ __forceinline__ void split(float v, uint16_t& hi, uint16_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const __nv_bfloat16 l =
      __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(l);
}

// split of two values at once: hi and lo as bf16x2 words, a in the low
// half (one cvt.rn.bf16x2.f32 a part)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(a, __low2float(h)), __fsub_rn(b, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace mma
}  // namespace idsp
