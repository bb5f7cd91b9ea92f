// K10: full_mean — the exact mean over every CSR neighbor of every node.
//
// Replaces quiver_tpu/inference.py:full_mean_aggregate (the layer-wise
// full-neighbor aggregation of sage_full_inference): out[u] = mean over
// e in [indptr[u], indptr[u+1]) of h[clip(indices[e], 0, n_h - 1)], zero
// for degree 0. The neighbors are summed in CSR order, the order of the
// reference's edge-chunked scatter-add, and divided by max(deg, 1).
// Deterministic: no atomics. indptr/indices are int32, or int64 when the
// edge count needs it (idx64).
//
// Bound on the card: bytes — counted once, the inputs are indptr,
// indices and h and the output is out; the kernel itself reads one h row
// per edge (E rows, 123.7M at products scale, against N distinct rows),
// so its traffic is E * D * 4 bytes through L2 and it runs well above the
// bound. Design: one warp per (node, chunk of 128 columns) walks the
// node's edges in order; the warp loads 32 edge ids at a time and
// broadcasts them by shuffle, and the lanes read their columns of each
// neighbor row with 16-byte loads where the width allows (D % 4 == 0), so
// every row read is whole lines; each lane issues the loads of 16 rows
// before adding them (in edge order), so a warp keeps 16 rows in flight.
// A power-law hub still holds its warps for its whole degree and sets the
// kernel's time; splitting hub rows across warps is later work.

#include "common.cuh"

// neighbor rows a lane has in flight at once (32 % kRowsInFlight == 0)
constexpr int kRowsInFlight = 16;

template <typename I>
__global__ void full_mean_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                                 long long n, const float* __restrict__ h, long long n_h, int D,
                                 bool vec4, int n_chunks, float* __restrict__ out) {
  const long long w = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n * n_chunks) return;  // warp-uniform
  const long long u = w / n_chunks;
  const long long lo = static_cast<long long>(indptr[u]);
  const long long hi = static_cast<long long>(indptr[u + 1]);
  const long long deg = hi - lo;
  const float denom = static_cast<float>(deg > 1 ? deg : 1);
  float* dst = out + u * D;
  const int c = static_cast<int>(w % n_chunks) * (vec4 ? 128 : 32) + (vec4 ? 4 * lane : lane);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long e0 = lo; e0 < hi; e0 += 32) {
    const long long e = e0 + lane;
    const long long v =
        e < hi ? qt_clamp<long long>(static_cast<long long>(indices[e]), 0, n_h - 1) : 0;
    const int m = hi - e0 < 32 ? static_cast<int>(hi - e0) : 32;
    for (int t = 0; t < m; t += kRowsInFlight) {  // warp-uniform
      float4 x[kRowsInFlight];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {  // all loads first ...
        const long long src = __shfl_sync(0xFFFFFFFFu, v, t + q);
        x[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t + q < m && c < D) {
          if (vec4) {
            x[q] = *reinterpret_cast<const float4*>(h + src * D + c);
          } else {
            x[q].x = h[src * D + c];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {  // ... then the adds, in edge order
        if (t + q < m) {
          acc.x = __fadd_rn(acc.x, x[q].x);
          acc.y = __fadd_rn(acc.y, x[q].y);
          acc.z = __fadd_rn(acc.z, x[q].z);
          acc.w = __fadd_rn(acc.w, x[q].w);
        }
      }
    }
  }
  if (c < D) {
    if (vec4) {
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(__fdiv_rn(acc.x, denom), __fdiv_rn(acc.y, denom),
                      __fdiv_rn(acc.z, denom), __fdiv_rn(acc.w, denom));
    } else {
      dst[c] = __fdiv_rn(acc.x, denom);
    }
  }
}

QT_EXPORT int qt_full_mean(const void* indptr, const void* indices, int idx64, long long n,
                           const void* h, long long n_h, int D, void* out, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;  // 8 warps a block
  const int n_chunks = (D + (vec4 ? 127 : 31)) / (vec4 ? 128 : 32);
  const unsigned blocks = qt_blocks(n * n_chunks * 32, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) {
    full_mean_kernel<long long><<<blocks, threads, 0, st>>>(
        static_cast<const long long*>(indptr), static_cast<const long long*>(indices), n,
        static_cast<const float*>(h), n_h, D, vec4, n_chunks, static_cast<float*>(out));
  } else {
    full_mean_kernel<int32_t><<<blocks, threads, 0, st>>>(
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices), n,
        static_cast<const float*>(h), n_h, D, vec4, n_chunks, static_cast<float*>(out));
  }
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
