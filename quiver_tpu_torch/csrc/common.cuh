// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define QT_EXPORT extern "C" __attribute__((visibility("default")))

// Every source exports the error text of a CUDA error code for its wrapper.
#define QT_DEFINE_ERROR_STRING                                   \
  QT_EXPORT const char* qt_error_string(int code) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }

// Return the launch error (cudaSuccess = 0) of the launch just made.
static inline int qt_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

static inline unsigned qt_blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename T>
__device__ __forceinline__ T qt_clamp(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
