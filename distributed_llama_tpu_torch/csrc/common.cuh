// Shared by the port's CUDA sources: the error-string entry point that the
// ctypes binding (ops/_build.py) reads when a launch returns non-zero, the
// once-per-device opt-in to more than 48 KB of dynamic shared memory, the
// Q40 code decode of the matmul kernels, and bf16 packing and the f32 /
// bf16 KV-cache loads of the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int kMaxDevices = 64;

// Let `kernel` launch with `bytes` of dynamic shared memory. Above 48 KB
// that takes cudaFuncSetAttribute, which holds per device; `granted` is
// the calling launch path's own per-device high-water mark, so the call is
// made on the first such launch on a device and never again for that size
// or a smaller one. A launch captured into a CUDA graph after an eager
// launch of the same size therefore makes no call during the capture.
template <typename Kernel>
static cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                               size_t (&granted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return e;
}

// A Q40 code minus 8, exact, with no integer-to-float conversion: byte
// k = sel & 3 of `bytes` (a nibble, 0..15) permuted into the float
// 2^23 + code, minus 2^23 + 8.
static __device__ __forceinline__ float code_minus8(uint32_t bytes,
                                                    uint32_t sel) {
  return __int_as_float(__byte_perm(bytes, 0x4B000000u, sel)) - 8388616.0f;
}

// Two f32 -> one register of two bf16, round to nearest even; `lo` lands
// in the low half (the lower address in memory).
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of a register as f32 (exact).
static __device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

static __device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// Four consecutive cache values as f32: one 16-byte load of an f32 cache,
// one 8-byte load of a bf16 cache, widened exactly.
static __device__ __forceinline__ float4 load_f4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

static __device__ __forceinline__ float4 load_f4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// Eight consecutive values as bf16 (one 16-byte register quad): f32 is
// rounded to nearest even, bf16 is loaded as it is.
static __device__ __forceinline__ uint4 load_bf16x8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

static __device__ __forceinline__ uint4 load_bf16x8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
