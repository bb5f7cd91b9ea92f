// The block-wide exclusive scan of the count-scan-fill kernels
// (aggregate.cu's K4b/K14b segments, full_mean.cu's K10 segments); K13d's
// compaction (collective.cu) takes its tile of kScanTile lanes.
#pragma once

#include <cstdint>

constexpr int kScanTile = 1024;  // = the block size of the scan kernels

// exclusive scan of one value per thread across a block of kScanTile
// threads; returns the thread's prefix and leaves the total in *total
__device__ __forceinline__ int32_t qt_block_exclusive_scan(int32_t v, int32_t* total) {
  __shared__ int32_t warp_sums[kScanTile / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int32_t before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kScanTile / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before;
}

// one block of kScanTile threads: tile_sums[t] becomes the exclusive prefix
// of tile t; the sum of all tiles lands in *total when total is not null
__global__ void qt_tile_offsets_kernel(int32_t* __restrict__ tile_sums, long long n_tiles,
                                       int32_t* __restrict__ total) {
  int32_t carry = 0;
  for (long long t0 = 0; t0 < n_tiles; t0 += kScanTile) {
    const long long t = t0 + threadIdx.x;
    int32_t part;
    const int32_t before = qt_block_exclusive_scan(t < n_tiles ? tile_sums[t] : 0, &part);
    if (t < n_tiles) tile_sums[t] = carry + before;
    carry += part;
  }
  if (total != nullptr && threadIdx.x == 0) *total = carry;
}
