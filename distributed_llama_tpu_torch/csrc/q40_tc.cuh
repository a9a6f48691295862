// Building blocks of the Q40 products that run f32 arithmetic on the bf16
// tensor cores with exact products (K1 and K1m, q40_matvec.cu):
//
//   * an f32 x splits exactly into three bf16 pieces, x = p0 + p1 / 2^8 +
//     p2 / 2^16 (split3): p0 is x with its low 16 bits cleared, p1 the
//     remainder scaled by 2^8 and cut the same way, p2 what is left, scaled
//     by 2^8 again, which has at most 8 significant bits. The scalings keep
//     every piece of a subnormal or tiny x at or above bf16's least step
//     (2^-133), and never overflow: a remainder is below 2^-7 of |x|;
//   * a Q40 code minus 8 is an exact bf16 (codes_bf16): a byte permute puts
//     the code c in the mantissa of bf16 128 (0x4300 | c = 128 + c), one
//     bf16x2 fused multiply-add takes 136 away;
//   * so each product code x piece is exact, and an MMA's f32 sum of them
//     rounds only in the adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The three bf16 pieces of x as f32 bit patterns whose low 16 bits are
// zero: x = p[0] + p[1] * 2^-8 + p[2] * 2^-16 exactly, for every finite x.
static __device__ __forceinline__ void split3(float x, uint32_t (&p)[3]) {
  const uint32_t h = __float_as_uint(x) & 0xFFFF0000u;
  const float r1 = __fmul_rn(__fsub_rn(x, __uint_as_float(h)), 256.f);
  const uint32_t m = __float_as_uint(r1) & 0xFFFF0000u;
  p[0] = h;
  p[1] = m;
  p[2] = __float_as_uint(__fmul_rn(__fsub_rn(r1, __uint_as_float(m)), 256.f));
}

// Two f32 bit patterns with zero low halves -> one bf16x2 register, `a`
// in the low half (the lower k).
static __device__ __forceinline__ uint32_t pack_hi16(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// bf16 pair (128 + c0, 128 + c1) -> (c0 - 8, c1 - 8), exact: v * 1 - 136.
static __device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Four codes c, one a byte (0..15), as (c - 8) in two bf16 pairs: (v0, v1)
// and (v2, v3).
static __device__ __forceinline__ void nibbles_bf16(uint32_t n,
                                                    uint32_t (&v)[2]) {
  v[0] = minus136(__byte_perm(n, 0x43u, 0x4140));
  v[1] = minus136(__byte_perm(n, 0x43u, 0x4342));
}

// One 32-bit word of a row's Q40 block (bytes 4c..4c+3: values 4c..4c+3
// in the low nibbles, 16+4c.. in the high ones) as code - 8 in bf16 pairs:
// lo[0] = (v0, v1), lo[1] = (v2, v3) of the low nibbles, hi likewise.
static __device__ __forceinline__ void codes_bf16(uint32_t w,
                                                  uint32_t (&lo)[2],
                                                  uint32_t (&hi)[2]) {
  nibbles_bf16(w & 0x0F0F0F0Fu, lo);
  nibbles_bf16((w >> 4) & 0x0F0F0F0Fu, hi);
}

// K1's and K1m's codes (the codec's unsigned nibbles), as the skeleton
// (q40_matvec.cuh matvec_body) widens a code word.
struct UnsignedCodes {
  static __device__ __forceinline__ void widen(uint32_t w, uint32_t (&lo)[2],
                                               uint32_t (&hi)[2]) {
    codes_bf16(w, lo, hi);
  }
};

// c = a . b on the tensor cores (m16n8k16, bf16 operands, f32 sums) from a
// zero accumulator, and c += a . b. Not volatile, so the compiler may
// interleave independent MMAs.
static __device__ __forceinline__ void mma_bf16_zero(float (&c)[4],
                                                     const uint32_t (&a)[4],
                                                     uint32_t b0,
                                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

static __device__ __forceinline__ void mma_bf16_add(float (&c)[4],
                                                    const uint32_t (&a)[4],
                                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
