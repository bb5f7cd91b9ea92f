// K12: build the [M, 128] tile table of the tiled layout on the card.
//
// Replaces quiver_tpu/ops/sample.py:build_tiled_device (with the host row
// map of :tiled_rowmap_host). Tile row r holds the flat words
// src[row_start[r] .. row_start[r] + row_width[r]) in its first
// row_width[r] lanes and 0 in the rest; the flat position is clipped to
// [0, n_src - 1] as jnp.take's index is. It is a bit copy of 4-byte
// words, so one launch builds int32 id tiles and float32 weight or
// timestamp tiles alike (a zero lane is the same bits in both). Row
// starts are int64: edge offsets pass 2^31 on papers100M-sized graphs.
//
// Bound on the card: bytes. Each flat word is read once, the row map
// (12 bytes a row) once and each tile word written once; there is no
// arithmetic to speak of. Design: one warp a tile row. Lane 0 reads the
// row's (start, width) and hands it to the warp; lane l then copies lanes
// l, l + 32, l + 64 and l + 96, so each of the four reads and writes is
// one coalesced 128-byte run. Rows shorter than 128 words read nothing
// past their width.

#include "common.cuh"

__global__ void build_tiles_kernel(const uint32_t* __restrict__ src, long long n_src,
                                   const long long* __restrict__ row_start,
                                   const int32_t* __restrict__ row_width, long long m_rows,
                                   uint32_t* __restrict__ out) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= m_rows) return;  // whole warps leave together: m_rows counts warps
  long long start = 0;
  int32_t width = 0;
  if (lane == 0) {
    start = row_start[r];
    width = row_width[r];
  }
  start = __shfl_sync(0xFFFFFFFFu, start, 0);
  width = __shfl_sync(0xFFFFFFFFu, width, 0);
  uint32_t* dst = out + r * 128;
#pragma unroll
  for (int j = lane; j < 128; j += 32) {
    uint32_t v = 0;
    if (j < width && n_src > 0) {
      const long long g = qt_clamp<long long>(start + j, 0, n_src - 1);
      v = src[g];
    }
    dst[j] = v;
  }
}

QT_EXPORT int qt_build_tiles(const void* src, long long n_src, const void* row_start,
                             const void* row_width, long long m_rows, void* out,
                             void* stream) {
  if (m_rows <= 0) return 0;
  const int threads = 256;  // 8 tile rows a block
  qt_count_launch();
  build_tiles_kernel<<<qt_blocks(m_rows * 32, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), n_src, static_cast<const long long*>(row_start),
      static_cast<const int32_t*>(row_width), m_rows, static_cast<uint32_t*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
