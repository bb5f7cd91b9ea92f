// K4: masked_mean — forward of the GraphSAGE neighbor mean.
//
// Replaces quiver_tpu/models/sage.py:masked_mean_aggregate together with
// quiver_tpu/pyg/sage_sampler.py:DenseAdj.gather_src (forward only; the
// backward comes with training). For target row i it sums x[src(i, j)]
// over the valid j in ascending j order and divides by max(count_i, 1),
// where src = clip(cols[i, j], 0, W_src - 1) in the cols layout and
// W + j*W + i in the structural layout (cols == nullptr, W = W_dst). The
// sum order differs from XLA's, so it matches the JAX package within a
// float tolerance, and the plain torch version within the same.
//
// Bound on the card: bytes — the valid neighbor rows of x are read once
// each (D float32 per valid lane), the output written once; the adds are
// one per byte-pair read. Design: one warp per target row; lane j holds
// lane j's (mask, src) so the row's valid set is one ballot, the columns
// run across the lanes (coalesced reads of each neighbor row), and the
// k-step sum of each column stays in a register. Needs k <= 32.

#include "common.cuh"

__global__ void masked_mean_kernel(const float* __restrict__ x, long long w_src, int D,
                                   const bool* __restrict__ mask,
                                   const int32_t* __restrict__ cols, int32_t w_dst, int k,
                                   float* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_dst) return;  // warp-uniform
  bool m = false;
  long long src = 0;
  if (lane < k) {
    const long long q = row * k + lane;
    m = mask[q];
    src = cols != nullptr
              ? qt_clamp<long long>(cols[q], 0, w_src - 1)
              : static_cast<long long>(w_dst) + static_cast<long long>(lane) * w_dst + row;
  }
  const unsigned valid = __ballot_sync(0xFFFFFFFFu, m);
  const int cnt = __popc(valid);
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  for (int d0 = 0; d0 < D; d0 += 32) {  // warp-uniform trip count
    const int d = d0 + lane;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const long long sj = __shfl_sync(0xFFFFFFFFu, src, j);
      if (((valid >> j) & 1u) && d < D) acc = __fadd_rn(acc, x[sj * D + d]);
    }
    if (d < D) out[row * D + d] = __fdiv_rn(acc, denom);
  }
}

QT_EXPORT int qt_masked_mean(const void* x, long long w_src, int D, const void* mask,
                             const void* cols, int w_dst, int k, void* out, void* stream) {
  if (w_dst <= 0 || D <= 0) return 0;
  if (k > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;  // 8 target rows a block
  masked_mean_kernel<<<qt_blocks(static_cast<long long>(w_dst) * 32, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), w_src, D, static_cast<const bool*>(mask),
      static_cast<const int32_t*>(cols), w_dst, k, static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
