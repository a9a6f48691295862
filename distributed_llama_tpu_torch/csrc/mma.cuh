// Warp-level bf16 tensor-core helpers shared by the bf16 kernels (K3b,
// K4b): ldmatrix fragment loads from shared memory and the m16n8k16 MMA
// with f32 accumulation (sm_80+, so sm_90a too).
//
// Fragment layout of mma.m16n8k16.row.col (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 = (row g, k 2c..2c+1), a1 = (g+8, 2c..),
//       a2 = (g, 2c+8..), a3 = (g+8, 2c+8..);
//   B (16 x 8, "col": stored n-major, k contiguous): b0 = (k 2c..2c+1,
//       n g), b1 = (k 2c+8.., n g);
//   C (16 x 8, f32): c0, c1 = (row g, n 2c, 2c+1), c2, c3 = (g+8, ...).
// A register of two bf16 holds the lower k (or n) in its low half
// (common.cuh pack_bf16).
#pragma once

#include <stdint.h>

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l supplies the row address of matrix l / 8
// and receives (row l / 4, columns 2 (l % 4), +1) of each.
static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                                   const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane l receives (rows 2 (l % 4), +1,
// column l / 4), i.e. B fragments from a row-major k x n tile.
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                         const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: bf16 products, f32 accumulation.
static __device__ __forceinline__ void mma_bf16(float (&c)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
