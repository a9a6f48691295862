// Shared by the port's CUDA sources: the error-string entry point that the
// ctypes binding (ops/_build.py) reads when a launch returns non-zero.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
