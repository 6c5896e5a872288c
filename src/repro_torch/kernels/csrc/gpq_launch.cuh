// What every GPQ kernel library shares besides the tensor-core kernel
// (plane_mma.cuh): the launch checks and the error string.

#pragma once

#include <cuda_runtime.h>

namespace gpq {

// Arguments every launch entry point validates the same way.
inline bool bad_shape(int M, int K, int N, int rows, int weight_bits) {
  return M <= 0 || N <= 0 || K <= 0 || rows <= 0 || weight_bits < 1 ||
         weight_bits > 8;
}

}  // namespace gpq

extern "C" {

// Each kernel library carries its own copy; ctypes resolves it per library.
const char* gpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
