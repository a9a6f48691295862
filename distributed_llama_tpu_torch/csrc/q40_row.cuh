// The classic T = 1 row body (K1's before its tensor-core redesign, kept
// as the Q40 layout probe's P0, nb_probe.cu), shared with the fused
// decode-layer kernels (fused_layer.cu): the dot of one Q40 weight row with
// a vector staged in shared memory, one warp per row, so a fused matvec row
// gives P0's bits on the same input.
//
// The staged vector pads each 32-value block to kBlockPad = 36 floats, so
// that the lanes' float4 reads of 8 different blocks fall on distinct
// banks. Lanes stride over the row's blocks, one 16-byte code load and one
// f16 scale per block, kUnroll blocks in flight per lane; codes become
// floats with a byte permute (code_minus8); f32 accumulation and a
// butterfly (xor) shuffle reduction, which leaves the sum in every lane.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

constexpr int kBlockPad = 36;  // floats per staged 32-value block of x
constexpr int kUnroll = 4;     // code blocks in flight per lane

// sum_j (code_j - 8) * x_j over one block; xb = the staged block (36 floats).
static __device__ __forceinline__ float block_dot(uint4 q, const float* xb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t lo = words[w] & 0x0F0F0F0Fu;         // values 4w..4w+3
    const uint32_t hi = (words[w] >> 4) & 0x0F0F0F0Fu;  // values 16+4w..
    const float4 xl = x4[w];
    const float4 xh = x4[4 + w];
    s = fmaf(code_minus8(lo, 0x7440u), xl.x, s);
    s = fmaf(code_minus8(lo, 0x7441u), xl.y, s);
    s = fmaf(code_minus8(lo, 0x7442u), xl.z, s);
    s = fmaf(code_minus8(lo, 0x7443u), xl.w, s);
    s = fmaf(code_minus8(hi, 0x7440u), xh.x, s);
    s = fmaf(code_minus8(hi, 0x7441u), xh.y, s);
    s = fmaf(code_minus8(hi, 0x7442u), xh.z, s);
    s = fmaf(code_minus8(hi, 0x7443u), xh.w, s);
  }
  return s;
}

// sum_b d16[b] * block_dot(qrow[b], xs + b * kBlockPad) over the row's nb
// blocks, called by all 32 lanes of a warp; every lane gets the sum.
static __device__ __forceinline__ float q40_row_dot(
    const uint4* __restrict__ qrow, const __half* __restrict__ drow,
    const float* xs, int nb, int lane) {
  float acc = 0.f;
  int b = lane;
  for (; b + 32 * (kUnroll - 1) < nb; b += 32 * kUnroll) {
    uint4 q[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      q[u] = __ldg(qrow + b + 32 * u);
      s[u] = __half2float(drow[b + 32 * u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = fmaf(s[u], block_dot(q[u], xs + (b + 32 * u) * kBlockPad), acc);
    }
  }
  for (; b < nb; b += 32) {
    acc = fmaf(__half2float(drow[b]), block_dot(__ldg(qrow + b),
                                                xs + b * kBlockPad), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}
