// Q40 matrix-vector product for Hopper (sm_90a), T = 1.
//
//   out[r] = sum_b d16[r,b] * sum_{j<32} (code[r,b,j] - 8) * x[32b + j]   (f32)
//
// Replaces the T=1 matvec of the JAX package's ops/pallas_q40.py
// (q40_matmul -> _q40_matmul_2d / _q40_matmul_stacked with _kernel_matvec,
// and the nb-major and int4-plane tilings of the same computation).
//
// Layout (the codec layout, chosen at load time): qs uint8 (d, nb, 16),
// byte j of a block holds value j in its low nibble and value j+16 in its
// high nibble; d16 f16 (d, nb); x f32 (nb*32); out f32 (d). A layer of a
// stacked weight is a pointer offset, so no per-layer copy exists.
//
// Bound: the packed weight bytes (18 per 32 values) read once from device
// memory. Design, simple first:
//   * one warp per output row, kWarps rows per block;
//   * lanes stride over the row's blocks, each block one 16-byte code load
//     and one f16 scale, kUnroll blocks in flight per lane;
//   * x staged once per block in shared memory, each 32-value block padded
//     to 36 floats so that the lanes' float4 reads of 8 different blocks
//     fall on distinct banks;
//   * codes become floats with a byte permute into 2^23 + code (exact), so
//     no integer-to-float conversion is issued;
//   * f32 accumulation throughout, warp-shuffle reduction.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;      // output rows per thread block
constexpr int kBlockPad = 36;  // floats per staged 32-value block of x
constexpr int kUnroll = 4;     // code blocks in flight per lane

// 2^23 + byte k of `bytes` as a float (k = sel & 3), minus 2^23 + 8.
__device__ __forceinline__ float code_minus8(uint32_t bytes, uint32_t sel) {
  return __int_as_float(__byte_perm(bytes, 0x4B000000u, sel)) - 8388616.0f;
}

// sum_j (code_j - 8) * x_j over one block; xb = the staged block (36 floats).
__device__ __forceinline__ float block_dot(uint4 q, const float* xb) {
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

__global__ void __launch_bounds__(kWarps * 32)
q40_matvec_kernel(const uint4* __restrict__ qs, const __half* __restrict__ d16,
                  const float* __restrict__ x, float* __restrict__ out,
                  int d, int nb) {
  extern __shared__ float xs[];  // nb * kBlockPad floats
  const int n = nb * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] = x[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= d) return;
  const uint4* qrow = qs + static_cast<size_t>(row) * nb;
  const __half* drow = d16 + static_cast<size_t>(row) * nb;

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
  if (lane == 0) out[row] = acc;
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_matvec(const void* qs, const void* d16, const void* x,
                          void* out, int d, int nb, void* stream) {
  const size_t smem = static_cast<size_t>(nb) * kBlockPad * sizeof(float);
  // the opt-in above 48 KB is per device, so it is made on every such launch
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        q40_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((d + kWarps - 1) / kWarps);
  q40_matvec_kernel<<<grid, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}
