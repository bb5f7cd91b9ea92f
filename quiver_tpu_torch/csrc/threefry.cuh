// Threefry-2x32 uniforms in-kernel, bit-equal to jax.random.uniform with
// jax_threefry_partitionable=True (jax/_src/prng.py, jax/_src/random.py):
// the float32 uniform at flat index i of a shape is
//   bits = b1 ^ b2 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//   u    = bitcast<float>(bits >> 9 | 0x3F800000) - 1
// The host derives the two key words (quiver_tpu_torch/random.py).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t qt_rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void qt_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = qt_rotl32(x1, rot[s & 1][q]) ^ x0;
    }
    x0 += ks[(s + 1) % 3];
    x1 += ks[(s + 2) % 3] + static_cast<uint32_t>(s + 1);
  }
}

__device__ __forceinline__ float qt_uniform(uint32_t k0, uint32_t k1, uint64_t idx) {
  uint32_t x0 = static_cast<uint32_t>(idx >> 32);
  uint32_t x1 = static_cast<uint32_t>(idx & 0xFFFFFFFFu);
  qt_threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}
