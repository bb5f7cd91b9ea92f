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

// The host-side count of kernel launches: every <<<...>>> site of the port's
// sources calls qt_count_launch() just before it. The counter is one 64-bit
// integer of the process, owned by quiver_tpu_torch/_kernels.py, which hands
// its address to each library as it loads it; a library not yet bound
// counts nothing. Unlike a profiler's trace, it sees every launch the host
// makes, whether or not the device has run it.
static unsigned long long* qt_launch_counter = nullptr;

static inline void qt_count_launch() {
  if (qt_launch_counter != nullptr) __atomic_fetch_add(qt_launch_counter, 1ull, __ATOMIC_RELAXED);
}

QT_EXPORT void qt_bind_launch_counter(unsigned long long* counter) {
  qt_launch_counter = counter;
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

// Element types of the kernels that take float32 or bfloat16 rows. A
// bfloat16 is held as its 16 bits: widening to float32 is exact, and
// narrowing rounds to nearest even (NaN to 0x7FC0), as torch's float ->
// bfloat16 conversion does. Sums run in float32 either way and are rounded
// once, when stored.
__device__ __forceinline__ float qt_bf16_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t qt_float_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

struct QtF32 {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return *p; }
  static __device__ __forceinline__ void store(T* p, float v) { *p = v; }
  // four consecutive elements (16 bytes, so p must be 16-byte aligned)
  static __device__ __forceinline__ float4 load4(const T* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(T* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

struct QtBF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float load(const T* p) { return qt_bf16_to_float(*p); }
  static __device__ __forceinline__ void store(T* p, float v) {
    *p = static_cast<T>(qt_float_to_bf16(v));
  }
  // four consecutive elements (8 bytes, so p must be 8-byte aligned); the
  // lower address holds the lower 16 bits
  static __device__ __forceinline__ float4 load4(const T* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(qt_bf16_to_float(v.x & 0xffffu), qt_bf16_to_float(v.x >> 16),
                       qt_bf16_to_float(v.y & 0xffffu), qt_bf16_to_float(v.y >> 16));
  }
  static __device__ __forceinline__ void store4(T* p, float4 v) {
    uint2 o;
    o.x = qt_float_to_bf16(v.x) | (qt_float_to_bf16(v.y) << 16);
    o.y = qt_float_to_bf16(v.z) | (qt_float_to_bf16(v.w) << 16);
    *reinterpret_cast<uint2*>(p) = o;
  }
};
