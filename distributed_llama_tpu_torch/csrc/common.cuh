// Shared by the port's CUDA sources: the error-string entry point that the
// ctypes binding (ops/_build.py) reads when a launch returns non-zero, and
// the Q40 code decode of the matmul kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A Q40 code minus 8, exact, with no integer-to-float conversion: byte
// k = sel & 3 of `bytes` (a nibble, 0..15) permuted into the float
// 2^23 + code, minus 2^23 + 8.
static __device__ __forceinline__ float code_minus8(uint32_t bytes,
                                                    uint32_t sel) {
  return __int_as_float(__byte_perm(bytes, 0x4B000000u, sel)) - 8388616.0f;
}
