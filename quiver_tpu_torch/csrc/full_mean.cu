// K10: full_mean — the exact mean over every CSR neighbor of every node.
//
// Replaces quiver_tpu/inference.py:full_mean_aggregate (the layer-wise
// full-neighbor aggregation of sage_full_inference): out[u] = mean over
// e in [indptr[u], indptr[u+1]) of h[clip(indices[e], 0, n_h - 1)], zero
// for degree 0, divided by max(deg, 1) in float32. Deterministic: no
// atomics, a fixed order, so two runs are bit-equal. indptr/indices are
// int32, or int64 when the edge count needs it (idx64).
//
// Bound on the card: bytes — counted once, the inputs are indptr,
// indices and h and the output is out; the kernel itself reads one h row
// per edge (E rows, 123.7M at products scale, against N distinct rows),
// so its traffic is E * D * 4 bytes through L2 and it runs well above the
// bound.
//
// Design: no warp walks more than kSegEdges edges. A row of degree at
// most kSegEdges (light) is summed by one warp per (row, 128 columns), in
// CSR order, and divided. A heavier row (a power-law hub: 1,248,957 edges
// at products scale) is cut into ceil(deg / kSegEdges) segments of
// kSegEdges edges in CSR order; one warp per (segment, 128 columns) sums
// its segment in CSR order into a float32 partial row of scratch, and a
// second kernel adds each heavy row's partials in segment order and
// divides. The sum order changes only inside heavy rows. The segment
// table (each segment's row and index in it) is built on the card by a
// count and scan of the segments a row (scan.cuh's block scan) and a
// fill; the heavy segments come first in the main kernel's grid, so the
// tail of the grid is light rows. A warp loads 32 edge ids at a time and
// broadcasts them by shuffle; the lanes read their columns of each
// neighbor row with 16-byte loads where the width allows (D % 4 == 0), so
// every row read is whole lines, and each lane issues the loads of
// kRowsInFlight rows before adding them in edge order. At D = 100 seven
// lanes of the 16-byte layout idle (25 float4 a row): filling them would
// move columns from lane to lane from row to row and cost a shuffle a
// column each row, while the idle lanes load nothing, so they cost issue
// slots only, and the kernel is bounded by bytes in flight.

#include "common.cuh"
#include "scan.cuh"

// edges of a segment, and the largest degree one warp sums alone
constexpr int kSegEdges = 1024;
// neighbor rows a lane has in flight at once (32 % kRowsInFlight == 0)
constexpr int kRowsInFlight = 16;

template <typename I>
__device__ __forceinline__ long long row_degree(const I* __restrict__ indptr, long long u) {
  return static_cast<long long>(indptr[u + 1]) - static_cast<long long>(indptr[u]);
}

// segments of a row of degree deg: 0 for a light row
__device__ __forceinline__ int32_t row_segments(long long deg) {
  return deg > kSegEdges ? static_cast<int32_t>((deg + kSegEdges - 1) / kSegEdges) : 0;
}

// the sum over edges [lo, hi), in CSR order, of the lane's columns c .. c+3
// (vec4) or c of the neighbor rows
template <typename I>
__device__ __forceinline__ float4 edge_sum(const I* __restrict__ indices, long long lo,
                                           long long hi, const float* __restrict__ h,
                                           long long n_h, int D, bool vec4, int c, int lane) {
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
  return acc;
}

__device__ __forceinline__ void store_cols(float* dst, float4 v, bool vec4, int c, int D) {
  if (c >= D) return;
  if (vec4) {
    *reinterpret_cast<float4*>(dst + c) = v;
  } else {
    dst[c] = v.x;
  }
}

__device__ __forceinline__ float4 div4(float4 v, float d) {
  return make_float4(__fdiv_rn(v.x, d), __fdiv_rn(v.y, d), __fdiv_rn(v.z, d), __fdiv_rn(v.w, d));
}

// 1. the segments of each tile of kScanTile rows
template <typename I>
__global__ void heavy_tile_sums_kernel(const I* __restrict__ indptr, long long n,
                                       int32_t* __restrict__ tile_sums) {
  const long long u = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  int32_t total;
  qt_block_exclusive_scan(u < n ? row_segments(row_degree(indptr, u)) : 0, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// 3. given each tile's first segment (2: qt_tile_offsets_kernel), each
//    heavy row writes its segments' (row, index) in CSR order
template <typename I>
__global__ void heavy_fill_kernel(const I* __restrict__ indptr, long long n,
                                  const int32_t* __restrict__ tile_offsets, long long max_segs,
                                  long long* __restrict__ seg_row, int32_t* __restrict__ seg_j) {
  const long long u = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  const int32_t segs = u < n ? row_segments(row_degree(indptr, u)) : 0;
  int32_t total;
  const int32_t at = tile_offsets[blockIdx.x] + qt_block_exclusive_scan(segs, &total);
  for (int32_t j = 0; j < segs && at + j < max_segs; ++j) {
    seg_row[at + j] = u;
    seg_j[at + j] = j;
  }
}

// 4. warps [0, heavy_warps) sum a (segment, column chunk) each into its
//    partial row; the rest take a light row's column chunk each
template <typename I>
__global__ void full_mean_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                                 long long n, const float* __restrict__ h, long long n_h, int D,
                                 bool vec4, int n_chunks, long long heavy_warps,
                                 const int32_t* __restrict__ n_segs,
                                 const long long* __restrict__ seg_row,
                                 const int32_t* __restrict__ seg_j, float* __restrict__ partials,
                                 float* __restrict__ out) {
  const long long w = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int c = static_cast<int>(w % n_chunks) * (vec4 ? 128 : 32) + (vec4 ? 4 * lane : lane);
  if (w < heavy_warps) {  // warp-uniform
    const long long s = w / n_chunks;
    if (s >= *n_segs) return;
    const long long u = seg_row[s];
    const long long lo = static_cast<long long>(indptr[u]) +
                         static_cast<long long>(seg_j[s]) * kSegEdges;
    const long long end = static_cast<long long>(indptr[u + 1]);
    const long long hi = lo + kSegEdges < end ? lo + kSegEdges : end;
    store_cols(partials + s * D, edge_sum(indices, lo, hi, h, n_h, D, vec4, c, lane), vec4, c,
               D);
    return;
  }
  const long long u = (w - heavy_warps) / n_chunks;
  if (u >= n) return;  // warp-uniform
  const long long lo = static_cast<long long>(indptr[u]);
  const long long hi = static_cast<long long>(indptr[u + 1]);
  const long long deg = hi - lo;
  if (deg > kSegEdges) return;  // a heavy row: its segments' warps and 5. write it
  const float denom = static_cast<float>(deg > 1 ? deg : 1);
  store_cols(out + u * D, div4(edge_sum(indices, lo, hi, h, n_h, D, vec4, c, lane), denom),
             vec4, c, D);
}

// 5. a warp per (heavy row's first segment, column chunk): the row's
//    partials added in segment order, then divided
template <typename I>
__global__ void heavy_combine_kernel(const I* __restrict__ indptr, int D, bool vec4,
                                     int n_chunks, long long max_segs,
                                     const int32_t* __restrict__ n_segs,
                                     const long long* __restrict__ seg_row,
                                     const int32_t* __restrict__ seg_j,
                                     const float* __restrict__ partials,
                                     float* __restrict__ out) {
  const long long w = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = w / n_chunks;
  if (s >= max_segs || s >= *n_segs || seg_j[s] != 0) return;  // warp-uniform
  const int c = static_cast<int>(w % n_chunks) * (vec4 ? 128 : 32) + (vec4 ? 4 * lane : lane);
  if (c >= D) return;
  const long long u = seg_row[s];
  const long long deg = row_degree(indptr, u);
  const int32_t segs = row_segments(deg);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int32_t t = 0; t < segs; ++t) {
    const float* p = partials + (s + t) * D + c;
    if (vec4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    } else {
      acc.x = __fadd_rn(acc.x, *p);
    }
  }
  store_cols(out + u * D, div4(acc, static_cast<float>(deg)), vec4, c, D);
}

// The scratch: the scan's tile sums, the segment count, the segment table
// and the partial rows, carved from one buffer of the caller's in
// 256-byte-aligned parts. Sized for the most segments E edges can make:
// a heavy row of d > kSegEdges edges makes ceil(d / S) <= 2d / (S + 1)
// segments, so at most 2E / (kSegEdges + 1) in all.
struct FullMeanScratch {
  int32_t *tile_sums, *n_segs, *seg_j;
  long long* seg_row;
  float* partials;
  long long max_segs, bytes;
};

static FullMeanScratch full_mean_scratch(char* base, long long n, long long n_edges, int D) {
  FullMeanScratch s{};
  long long at = 0;
  auto take = [&](long long count, size_t elem) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (count * static_cast<long long>(elem) + 255) / 256 * 256;
    return p;
  };
  s.max_segs = 2 * n_edges / (kSegEdges + 1);
  s.tile_sums = reinterpret_cast<int32_t*>(take((n + kScanTile - 1) / kScanTile,
                                                sizeof(int32_t)));
  s.n_segs = reinterpret_cast<int32_t*>(take(1, sizeof(int32_t)));
  s.seg_row = reinterpret_cast<long long*>(take(s.max_segs, sizeof(long long)));
  s.seg_j = reinterpret_cast<int32_t*>(take(s.max_segs, sizeof(int32_t)));
  s.partials = reinterpret_cast<float*>(take(s.max_segs * D, sizeof(float)));
  s.bytes = at;
  return s;
}

// bytes of scratch qt_full_mean needs for n rows, n_edges edges, width D
QT_EXPORT int qt_full_mean_scratch(long long n, long long n_edges, int D, long long* bytes) {
  *bytes = full_mean_scratch(nullptr, n, n_edges, D).bytes;
  return 0;
}

// the segment length kSegEdges: rows of more edges are split
QT_EXPORT int qt_full_mean_segment_edges(int* out) {
  *out = kSegEdges;
  return 0;
}

template <typename I>
static int full_mean_any(const I* indptr, const I* indices, long long n, long long n_edges,
                         const float* h, long long n_h, int D, float* out, void* scratch,
                         long long scratch_bytes, cudaStream_t st) {
  const FullMeanScratch sc = full_mean_scratch(static_cast<char*>(scratch), n, n_edges, D);
  if (scratch == nullptr || scratch_bytes < sc.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n_chunks = (D + (vec4 ? 127 : 31)) / (vec4 ? 128 : 32);
  const long long n_tiles = (n + kScanTile - 1) / kScanTile;
  qt_count_launch();
  heavy_tile_sums_kernel<I><<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(
      indptr, n, sc.tile_sums);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  qt_tile_offsets_kernel<<<1, kScanTile, 0, st>>>(sc.tile_sums, n_tiles, sc.n_segs);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  heavy_fill_kernel<I><<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(
      indptr, n, sc.tile_sums, sc.max_segs, sc.seg_row, sc.seg_j);
  if (int e = qt_launch_status()) return e;
  const int threads = 256;  // 8 warps a block
  const long long heavy_warps = sc.max_segs * n_chunks;
  qt_count_launch();
  full_mean_kernel<I><<<qt_blocks((heavy_warps + n * n_chunks) * 32, threads), threads, 0, st>>>(
      indptr, indices, n, h, n_h, D, vec4, n_chunks, heavy_warps, sc.n_segs, sc.seg_row,
      sc.seg_j, sc.partials, out);
  if (int e = qt_launch_status()) return e;
  if (heavy_warps > 0) {
    qt_count_launch();
    heavy_combine_kernel<I><<<qt_blocks(heavy_warps * 32, threads), threads, 0, st>>>(
        indptr, D, vec4, n_chunks, sc.max_segs, sc.n_segs, sc.seg_row, sc.seg_j, sc.partials,
        out);
    if (int e = qt_launch_status()) return e;
  }
  return 0;
}

// n rows, n_edges = len(indices); scratch as qt_full_mean_scratch gives
QT_EXPORT int qt_full_mean(const void* indptr, const void* indices, int idx64, long long n,
                           long long n_edges, const void* h, long long n_h, int D, void* out,
                           void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) {
    return full_mean_any(static_cast<const long long*>(indptr),
                         static_cast<const long long*>(indices), n, n_edges,
                         static_cast<const float*>(h), n_h, D, static_cast<float*>(out), scratch,
                         scratch_bytes, st);
  }
  return full_mean_any(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                       n, n_edges, static_cast<const float*>(h), n_h, D,
                       static_cast<float*>(out), scratch, scratch_bytes, st);
}

QT_DEFINE_ERROR_STRING
