// Device code of the Gumbel top-k draws (K7, K8, K8w): the uniform with
// a floor, the float32 logarithm and exponential rounded once from
// float64, a lane's score, and the order key of the warp's top-k select.
//
// The JAX package draws a weighted k-subset as the top k of
// log(w) + Gumbel over a [B, W] window (quiver_tpu/ops/sample.py:
// gumbel_topk_positions): u = uniform(key, (B, W), minval=1e-20),
// g = -log(-log(u)), score = log(max(w, 1e-30)) + g where lane j < deg
// and w > 0, else -inf. Here each log and exp takes its float32 argument
// to float64 and rounds the float64 result once to float32, at the same
// points as the float32 chain; the plain torch versions do the same with
// float64 tensors, so kernel and plain version agree bit for bit. Never
// __logf/__expf, never --use_fast_math.
#pragma once

#include <cstdint>

#include "threefry.cuh"

#define QT_GUMBEL_MINVAL 1e-20f

// jax.random.uniform(key, shape, minval=1e-20, maxval=1.0) at flat index
// idx: max(minval, f * f32(1 - minval) + minval), the multiply-add rounded
// once as XLA contracts it (exact here: it lifts only f == 0).
__device__ __forceinline__ float qt_gumbel_uniform(uint32_t k0, uint32_t k1, uint64_t idx) {
  const float f = qt_uniform(k0, k1, idx);
  const float span = __fsub_rn(1.0f, QT_GUMBEL_MINVAL);
  return fmaxf(QT_GUMBEL_MINVAL, __fmaf_rn(f, span, QT_GUMBEL_MINVAL));
}

__device__ __forceinline__ float qt_log32(float x) {
  return static_cast<float>(log(static_cast<double>(x)));
}

// The recency weight of one timestamp: exactly 1 at recency 0, else
// f32(exp(f64(f32(recency * ts)))). K8 and K8w both call this.
__device__ __forceinline__ float qt_recency_weight(float ts, float recency) {
  if (recency == 0.0f) return 1.0f;
  return static_cast<float>(exp(static_cast<double>(__fmul_rn(recency, ts))));
}

// A lane's score: log(max(w, 1e-30)) + (-log(-log(u))), a float32 add.
__device__ __forceinline__ float qt_gumbel_score(float w, float u) {
  const float a = qt_log32(u);
  const float g = -qt_log32(-a);
  return __fadd_rn(qt_log32(fmaxf(w, 1e-30f)), g);
}

// Order key of a score: unsigned compare of keys is float compare of
// scores (-0 folded into +0, so equal scores have equal keys). -inf maps
// to QT_KEY_NEG_INF; 0 is below every score and marks a taken lane.
__device__ __forceinline__ uint32_t qt_score_key(float s) {
  const uint32_t bits = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

#define QT_KEY_NEG_INF 0x007FFFFFu  // qt_score_key(-inf)
#define QT_KEY_TAKEN 0u
