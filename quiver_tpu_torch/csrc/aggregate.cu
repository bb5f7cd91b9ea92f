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

// K4b: masked_mean_backward — the gradient of masked_mean with respect to
// x_src: d x_src [W_src, D] from d out [W, D].
//
// Replaces the autodiff of quiver_tpu/models/sage.py:masked_mean_aggregate
// through quiver_tpu/pyg/sage_sampler.py:DenseAdj.gather_src. Lane (i, j)
// contributes mask[i, j] * g[i] / max(cnt_i, 1) (float32 division, as the
// reference's vjp of the divide) to source row src(i, j); rows no valid
// lane names get zero. The target prefix's lin_r gradient is not part of
// this function (autograd adds it).
//
// Structural layout (cols == nullptr): src(i, j) = W + j*W + i, so each
// source row receives at most one term: one warp per source row writes it
// (or zeros), no reduction at all.
//
// Cols layout: many targets can name one source row, so this is a
// scatter-add. It is deterministic — no float atomics, and the sum of
// each source row runs over its lanes in ascending flat index q = i*k + j
// on every run, so two runs give bit-equal gradients:
//   1. count: one warp per target row; its valid lanes add one to their
//      source row's lane count (an integer atomic, whose result does not
//      depend on the order) and lane 0 stores max(cnt_i, 1) as a float;
//   2. scan: three coalesced passes turn the counts into segment offsets
//      (exclusive);
//   3. fill: one thread per valid lane drops q into its source row's
//      segment through an atomic cursor — positions in arrival order;
//   4. sum: one warp per source row ranks its segment's q values (each
//      value's rank is the number of smaller ones; the q are distinct),
//      writes them in ascending order, then sums g[i] / cnt_i in that
//      order with each lane owning columns.
// Clipped columns are clipped as the forward clips them, and lanes the
// mask drops (invalid, or past a cap) add nothing.
//
// Bound on the card: bytes — g and the mask and cols read once, d x_src
// written once. Design: the count, scan and fill move 4-byte integers
// only; the sum reads each contributing g row once per lane that names it
// (a row shared by targets is read once per target, from L2 mostly). The
// rank step is quadratic in a segment's length, which stays small except
// at hub sources (about a thousand lanes at batch 1024 on a power-law
// graph); one warp walks a hub's whole segment, so the hub sets the
// kernel's time (splitting it across warps is later work).

// 1. lane counts per source row and the float count per target row
__global__ void mean_bwd_count_kernel(const bool* __restrict__ mask,
                                      const int32_t* __restrict__ cols, int32_t w_dst, int k,
                                      long long w_src, int32_t* __restrict__ deg,
                                      float* __restrict__ cntf) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_dst) return;  // warp-uniform
  bool m = false;
  long long src = 0;
  if (lane < k) {
    const long long q = row * k + lane;
    m = mask[q];
    src = qt_clamp<long long>(cols[q], 0, w_src - 1);
  }
  const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, m));
  if (lane == 0) cntf[row] = static_cast<float>(cnt > 1 ? cnt : 1);
  if (m) atomicAdd(deg + src, 1);
}

// 2. exclusive scan of deg[n] into offsets[n + 1] (and a copy of the
//    first n into cursor), in three coalesced passes over tiles of
//    kScanTile: the tile totals, their scan in one block, then each tile's
//    own scan plus its offset
constexpr int kScanTile = 1024;  // = the block size of the scan kernels

// exclusive scan of one value per thread across a block of kScanTile
// threads; returns the thread's prefix and leaves the total in *total
__device__ int32_t qt_block_exclusive_scan(int32_t v, int32_t* total) {
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

__global__ void mean_bwd_tile_sums_kernel(const int32_t* __restrict__ deg, long long n,
                                          int32_t* __restrict__ tile_sums) {
  const long long i = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  int32_t total;
  qt_block_exclusive_scan(i < n ? deg[i] : 0, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: tile_sums[t] becomes the exclusive prefix of tile t
__global__ void mean_bwd_tile_offsets_kernel(int32_t* __restrict__ tile_sums,
                                             long long n_tiles) {
  int32_t carry = 0;
  for (long long t0 = 0; t0 < n_tiles; t0 += kScanTile) {
    const long long t = t0 + threadIdx.x;
    int32_t total;
    const int32_t before = qt_block_exclusive_scan(t < n_tiles ? tile_sums[t] : 0, &total);
    if (t < n_tiles) tile_sums[t] = carry + before;
    carry += total;
  }
}

__global__ void mean_bwd_tile_scan_kernel(const int32_t* __restrict__ deg, long long n,
                                          const int32_t* __restrict__ tile_offsets,
                                          int32_t* __restrict__ offsets,
                                          int32_t* __restrict__ cursor) {
  const long long i = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  const int32_t v = i < n ? deg[i] : 0;
  int32_t total;
  const int32_t at = tile_offsets[blockIdx.x] + qt_block_exclusive_scan(v, &total);
  if (i < n) {
    offsets[i] = at;
    cursor[i] = at;
  }
  if (i == n - 1) offsets[n] = at + v;
}

// 3. each valid lane's flat index into its source row's segment
__global__ void mean_bwd_fill_kernel(const bool* __restrict__ mask,
                                     const int32_t* __restrict__ cols, long long n_lanes,
                                     long long w_src, int32_t* __restrict__ cursor,
                                     int32_t* __restrict__ lanes) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_lanes || !mask[q]) return;
  const long long src = qt_clamp<long long>(cols[q], 0, w_src - 1);
  lanes[atomicAdd(cursor + src, 1)] = static_cast<int32_t>(q);
}

// 4. per source row: order the segment, then sum in that order. One walk
//    of the segment serves up to kChunks column chunks a lane (256 columns
//    with 16-byte loads), and the loads of kLanesInFlight lanes are issued
//    before their adds, so a hub's long segment is walked once with 8
//    gradient rows in flight
constexpr int kLanesInFlight = 8;
constexpr int kChunks = 2;

__global__ void mean_bwd_sum_kernel(const float* __restrict__ g, int D,
                                    const float* __restrict__ cntf, int k, long long w_src,
                                    const int32_t* __restrict__ offsets,
                                    const int32_t* __restrict__ lanes,
                                    int32_t* sorted, bool vec4,
                                    float* __restrict__ gx) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_src) return;  // warp-uniform
  const int32_t base = offsets[row];
  const int32_t n = offsets[row + 1] - base;
  for (int32_t t0 = 0; t0 < n; t0 += 32) {  // warp-uniform trip counts
    const int32_t mine = t0 + lane < n ? lanes[base + t0 + lane] : INT32_MAX;
    int32_t rank = 0;
    for (int32_t c0 = 0; c0 < n; c0 += 32) {
      const int32_t v = c0 + lane < n ? lanes[base + c0 + lane] : INT32_MAX;
      for (int u = 0; u < 32; ++u) rank += __shfl_sync(0xFFFFFFFFu, v, u) < mine;
    }
    if (t0 + lane < n) sorted[base + rank] = mine;
  }
  __syncwarp();  // the ordered segment is visible to the whole warp
  float* out = gx + row * D;
  const int width = vec4 ? 4 : 1;       // columns a lane loads at once
  const int stride = 32 * width;        // columns a warp covers per chunk
  for (int c0 = 0; c0 < D; c0 += kChunks * stride) {  // warp-uniform
    float4 acc[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) acc[ch] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int32_t t = 0; t < n; t += kLanesInFlight) {
      float4 v[kLanesInFlight][kChunks];
      float cnt[kLanesInFlight];
#pragma unroll
      for (int u = 0; u < kLanesInFlight; ++u) {  // all loads first ...
        cnt[u] = 1.0f;
        const float* gi = g;
        if (t + u < n) {
          const int32_t i = sorted[base + t + u] / k;
          cnt[u] = cntf[i];
          gi = g + static_cast<long long>(i) * D;
        }
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int c = c0 + ch * stride + lane * width;
          v[u][ch] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (t + u < n && c < D) {
            if (vec4) {
              v[u][ch] = *reinterpret_cast<const float4*>(gi + c);
            } else {
              v[u][ch].x = gi[c];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLanesInFlight; ++u) {  // ... then the adds, in lane order
        if (t + u < n) {
#pragma unroll
          for (int ch = 0; ch < kChunks; ++ch) {
            acc[ch].x = __fadd_rn(acc[ch].x, __fdiv_rn(v[u][ch].x, cnt[u]));
            acc[ch].y = __fadd_rn(acc[ch].y, __fdiv_rn(v[u][ch].y, cnt[u]));
            acc[ch].z = __fadd_rn(acc[ch].z, __fdiv_rn(v[u][ch].z, cnt[u]));
            acc[ch].w = __fadd_rn(acc[ch].w, __fdiv_rn(v[u][ch].w, cnt[u]));
          }
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = c0 + ch * stride + lane * width;
      if (c < D) {
        if (vec4) {
          *reinterpret_cast<float4*>(out + c) = acc[ch];
        } else {
          out[c] = acc[ch].x;
        }
      }
    }
  }
}

// structural layout: source row r = W + j*W + i takes lane (i, j) alone
__global__ void mean_bwd_structural_kernel(const float* __restrict__ g, int D,
                                           const bool* __restrict__ mask, int32_t w_dst,
                                           int k, long long w_src, float* __restrict__ gx) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_src) return;  // warp-uniform
  const long long rel = row - w_dst;
  const bool inside = rel >= 0 && rel < static_cast<long long>(w_dst) * k;
  const long long i = inside ? rel % w_dst : 0;
  const int j = inside ? static_cast<int>(rel / w_dst) : 0;
  bool m = false;
  if (inside && lane < k) m = mask[i * k + lane];
  const unsigned valid = __ballot_sync(0xFFFFFFFFu, m);
  const int cnt = __popc(valid);
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  const bool take = inside && ((valid >> j) & 1u);
  for (int c = lane; c < D; c += 32)
    gx[row * D + c] = take ? __fdiv_rn(g[i * D + c], denom) : 0.0f;
}

// The cols layout's scratch: lane counts, offsets, cursors, the lanes in
// arrival and in flat-index order, the float counts and the scan's tile
// sums, carved from one buffer of the caller's in 256-byte-aligned parts.
// Only this file knows the layout; the wrapper asks for its size.
struct MeanBwdScratch {
  int32_t *deg, *offsets, *cursor, *lanes, *sorted, *tile_sums;
  float* cntf;
  long long bytes;
};

static MeanBwdScratch mean_bwd_scratch(char* base, long long w_src, int w_dst, int k) {
  MeanBwdScratch s{};
  long long at = 0;
  auto take = [&](long long n, size_t elem) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (n * static_cast<long long>(elem) + 255) / 256 * 256;
    return p;
  };
  const long long n_lanes = static_cast<long long>(w_dst) * k;
  s.deg = reinterpret_cast<int32_t*>(take(w_src, sizeof(int32_t)));
  s.offsets = reinterpret_cast<int32_t*>(take(w_src + 1, sizeof(int32_t)));
  s.cursor = reinterpret_cast<int32_t*>(take(w_src, sizeof(int32_t)));
  s.lanes = reinterpret_cast<int32_t*>(take(n_lanes, sizeof(int32_t)));
  s.sorted = reinterpret_cast<int32_t*>(take(n_lanes, sizeof(int32_t)));
  s.cntf = reinterpret_cast<float*>(take(w_dst, sizeof(float)));
  s.tile_sums = reinterpret_cast<int32_t*>(take((w_src + kScanTile - 1) / kScanTile,
                                                sizeof(int32_t)));
  s.bytes = at;
  return s;
}

// bytes of scratch the cols layout needs (the structural layout needs none)
QT_EXPORT int qt_masked_mean_backward_scratch(long long w_src, int w_dst, int k,
                                              long long* bytes) {
  *bytes = mean_bwd_scratch(nullptr, w_src, w_dst, k).bytes;
  return 0;
}

QT_EXPORT int qt_masked_mean_backward(const void* g, int D, const void* mask, const void* cols,
                                      int w_dst, int k, long long w_src, void* gx, void* scratch,
                                      long long scratch_bytes, void* stream) {
  if (w_src <= 0 || D <= 0) return 0;
  if (k > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const float* gf = static_cast<const float*>(g);
  const bool* m = static_cast<const bool*>(mask);
  float* out = static_cast<float*>(gx);
  if (cols == nullptr) {
    mean_bwd_structural_kernel<<<qt_blocks(w_src * 32, threads), threads, 0, st>>>(
        gf, D, m, w_dst, k, w_src, out);
    return qt_launch_status();
  }
  const MeanBwdScratch sc = mean_bwd_scratch(static_cast<char*>(scratch), w_src, w_dst, k);
  if (scratch == nullptr || scratch_bytes < sc.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* c = static_cast<const int32_t*>(cols);
  int32_t* dg = sc.deg;
  int32_t* off = sc.offsets;
  int32_t* cur = sc.cursor;
  float* cf = sc.cntf;
  cudaError_t err = cudaMemsetAsync(dg, 0, sizeof(int32_t) * w_src, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w_dst > 0 && k > 0) {
    mean_bwd_count_kernel<<<qt_blocks(static_cast<long long>(w_dst) * 32, threads), threads, 0,
                            st>>>(m, c, w_dst, k, w_src, dg, cf);
    if (int e = qt_launch_status()) return e;
  }
  const long long n_tiles = (w_src + kScanTile - 1) / kScanTile;
  int32_t* ts = sc.tile_sums;
  mean_bwd_tile_sums_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(dg, w_src, ts);
  if (int e = qt_launch_status()) return e;
  mean_bwd_tile_offsets_kernel<<<1, kScanTile, 0, st>>>(ts, n_tiles);
  if (int e = qt_launch_status()) return e;
  mean_bwd_tile_scan_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(dg, w_src, ts,
                                                                                  off, cur);
  if (int e = qt_launch_status()) return e;
  const long long n_lanes = static_cast<long long>(w_dst) * k;
  if (n_lanes > 0) {
    mean_bwd_fill_kernel<<<qt_blocks(n_lanes, threads), threads, 0, st>>>(
        m, c, n_lanes, w_src, cur, sc.lanes);
    if (int e = qt_launch_status()) return e;
  }
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(gx) % 16 == 0;
  mean_bwd_sum_kernel<<<qt_blocks(w_src * 32, threads), threads, 0, st>>>(
      gf, D, cf, k, w_src, off, sc.lanes, sc.sorted, vec4, out);
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
