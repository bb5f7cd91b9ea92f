// K11: neighbor_prob — one hop of sampling-probability propagation.
//
// Replaces quiver_tpu/ops/sample.py:neighbor_prob (and the hops of
// sample_prob): next[v] = sum over edges u -> v of w[u], with
// w[u] = prob[u] * min(k / max(deg(u), 1), 1) in float32, in the
// reference's steps (deg cast to float, an IEEE division, min, then a
// multiply; no FMA). The reference scatter-adds w[src] over the edge list
// in edge order; this kernel pulls instead, over the transposed CSR (the
// sources of each v in stable edge order, built once per graph on the
// host), so it needs no float atomics and reruns are bit-equal.
//
// Bound on the card: bytes — per hop the transposed source ids (4 B an
// edge), one 4-byte w read an edge and N writes (about 1.0 GB at products
// scale). Design: the edges of v are cut into tiles of `tile` edges (the
// tile table is built with the transposed CSR), one warp a tile; lane l
// adds the tile's edges l, l + 32, ... in order and the warp then adds its
// 32 lanes in a fixed butterfly, so a power-law hub's 1.2M-edge segment
// is spread over ~1,200 warps instead of holding one warp for all of it.
// A segment of one tile writes next[v] at once; a longer one writes its
// tile partials, which a second pass adds in tile order, one thread a
// long node. The weights w are a first, elementwise pass. The order
// differs from the reference's sequential sum, so the result agrees with
// it within float rounding, not bit for bit; it is the same on every run.

#include "common.cuh"

__global__ void prob_weights_kernel(const float* __restrict__ prob,
                                    const int32_t* __restrict__ deg, long long n, float k,
                                    float* __restrict__ w) {
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (u >= n) return;
  const float d = fmaxf(static_cast<float>(deg[u]), 1.0f);
  w[u] = __fmul_rn(prob[u], fminf(__fdiv_rn(k, d), 1.0f));
}

__global__ void prob_pull_kernel(const long long* __restrict__ tindptr,
                                 const int32_t* __restrict__ tsrc,
                                 const int32_t* __restrict__ tile_node,
                                 const long long* __restrict__ tile_ptr, long long n_tiles,
                                 int tile, const float* __restrict__ w,
                                 float* __restrict__ partial, float* __restrict__ out) {
  const long long m = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (m >= n_tiles) return;  // warp-uniform
  const long long v = tile_node[m];
  const long long t0 = tile_ptr[v];
  const long long lo = tindptr[v] + (m - t0) * tile;
  const long long end = tindptr[v + 1];
  const long long hi = lo + tile < end ? lo + tile : end;
  float acc = 0.0f;
  for (long long j = lo + lane; j < hi; j += 32) acc = __fadd_rn(acc, __ldg(w + tsrc[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xFFFFFFFFu, acc, off));
  if (lane != 0) return;
  if (tile_ptr[v + 1] - t0 == 1) {
    out[v] = acc;
  } else {
    partial[m] = acc;
  }
}

__global__ void prob_combine_kernel(const int32_t* __restrict__ long_nodes, long long n_long,
                                    const long long* __restrict__ tile_ptr,
                                    const float* __restrict__ partial, float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_long) return;
  const long long v = long_nodes[i];
  float acc = 0.0f;
  for (long long t = tile_ptr[v]; t < tile_ptr[v + 1]; ++t) acc = __fadd_rn(acc, partial[t]);
  out[v] = acc;
}

// One hop: weights, the tiled pull, then the long nodes' tile sums, in
// stream order. `w` ([n]) and `partial` ([n_tiles]) are scratch.
QT_EXPORT int qt_neighbor_prob(const void* prob, const void* deg, long long n, float k,
                               const void* tindptr, const void* tsrc, const void* tile_node,
                               const void* tile_ptr, long long n_tiles, int tile,
                               const void* long_nodes, long long n_long, void* w,
                               void* partial, void* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  qt_count_launch();
  prob_weights_kernel<<<qt_blocks(n, threads), threads, 0, s>>>(
      static_cast<const float*>(prob), static_cast<const int32_t*>(deg), n, k,
      static_cast<float*>(w));
  int rc = qt_launch_status();
  if (rc != 0) return rc;
  qt_count_launch();
  prob_pull_kernel<<<qt_blocks(n_tiles * 32, threads), threads, 0, s>>>(
      static_cast<const long long*>(tindptr), static_cast<const int32_t*>(tsrc),
      static_cast<const int32_t*>(tile_node), static_cast<const long long*>(tile_ptr), n_tiles,
      tile, static_cast<const float*>(w), static_cast<float*>(partial),
      static_cast<float*>(out));
  rc = qt_launch_status();
  if (rc != 0 || n_long <= 0) return rc;
  qt_count_launch();
  prob_combine_kernel<<<qt_blocks(n_long, threads), threads, 0, s>>>(
      static_cast<const int32_t*>(long_nodes), n_long, static_cast<const long long*>(tile_ptr),
      static_cast<const float*>(partial), static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
