// K4: masked_mean — forward of the GraphSAGE neighbor mean.
//
// Replaces quiver_tpu/models/sage.py:masked_mean_aggregate together with
// quiver_tpu/pyg/sage_sampler.py:DenseAdj.gather_src (forward only; the
// backward comes with training). For target row i it sums x[src(i, j)]
// over the valid j and divides by max(count_i, 1) in float32, where src =
// clip(cols[i, j], 0, W_src - 1) in the cols layout and W + j*W + i in the
// structural layout (cols == nullptr, W = W_dst). The sum order differs
// from XLA's, so it matches the JAX package within a float tolerance, and
// the plain torch version within the same. Rows are float32 or bfloat16;
// a bfloat16 row is summed and divided in float32 and rounded once (the
// plain version computes in float32 and rounds too). Any k.
//
// Bound on the card: bytes — the valid neighbor rows of x are read once
// each (D elements per valid lane), the output written once; the adds are
// one per element read. What held the first design back was not bytes but
// loads in flight and warps: a warp a target, 4-byte loads, and a k-step
// chain of shuffle, load and add per 32 columns, so at 1,024 targets the
// card held 8 warps an SM, each waiting on one load at a time.
//
// Design: a team of T = col_warps x split warps a target, 8 / T targets a
// block (the host picks the team with `mean_launch_plan` in
// models/sage.py). The team reads the target's (mask, clipped src) of all
// k lanes once, coalesced, into shared memory (1,024 lanes at a time: a
// longer row is walked in chunks) and counts the valid ones; nothing of
// the lane list is read again for another column slice. A warp covers
// 32 x V columns with V-element loads, 16 bytes where the row stride and
// the pointers allow (4 float32 or 8 bfloat16), else 8, 4 or 2. Warp
// (c, s) of a team takes column slice c and the s-th contiguous part of
// each chunk's lanes, issues the row loads of several lanes (64 bytes a
// thread, kept packed so that few registers hold them and many warps fit
// an SM) before adding them in ascending j, and the parts are added in
// the order s = 0, 1, ... through shared memory: the split gives a target
// with few columns and many lanes more warps when the targets are too few
// to fill the card. No float atomics: two runs are bit-equal.

#include "common.cuh"
#include "scan.cuh"

constexpr int kMeanBlockWarps = 8;      // warps a block: its teams' T warps each
constexpr int kMeanListLanes = 1024;    // lanes of a target's list in shared memory at once
constexpr int kMeanInFlightBytes = 64;  // row bytes a thread loads before its adds

// the number of valid lanes of target row `row` (k lanes, 32 a chunk)
__device__ __forceinline__ int mean_row_count(const bool* __restrict__ mask, int k,
                                              long long row, int lane) {
  int cnt = 0;
  for (int c0 = 0; c0 < k; c0 += 32) {  // warp-uniform
    const bool m = c0 + lane < k && mask[row * k + c0 + lane];
    cnt += __popc(__ballot_sync(0xFFFFFFFFu, m));
  }
  return cnt;
}

// V consecutive elements of type T (float32, or bfloat16 bits) as they
// sit in memory, in 32-bit words (a bfloat16 pair a word, lower address in
// the low half), loaded with one access of V * sizeof(T) bytes; p is
// aligned to it. Kept packed until each element is added, so the loads
// in flight take few registers.
template <typename T, int V>
struct MeanRow {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (kBytes == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }

  // element t as float32 (t a constant after unrolling)
  __device__ __forceinline__ float get(int t) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[t]);
    } else {
      return qt_bf16_to_float((t & 1) ? (w[t >> 1] >> 16) : (w[t >> 1] & 0xffffu));
    }
  }
};

template <int V>
__device__ __forceinline__ void mean_store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void mean_store(uint16_t* p, const float (&v)[V]) {
  uint32_t w[(V + 1) / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    w[i] = qt_float_to_bf16(v[2 * i]) | (qt_float_to_bf16(v[2 * i + 1]) << 16);
  }
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *p = static_cast<uint16_t>(qt_float_to_bf16(v[0]));
  }
}

// blockDim.x = 32 * T * teams, T = col_warps * split; dynamic shared
// memory: teams lists of min(k, kMeanListLanes) int32, then (split > 1)
// one 32 x V float32 part a warp. At most 48 registers a thread, so five
// blocks (40 warps) fit an SM: the kernel waits on memory, and more warps
// keep more loads in flight.
template <typename T, int V>
__global__ void __launch_bounds__(kMeanBlockWarps * 32, 5)
    masked_mean_kernel(const T* __restrict__ x, long long w_src, int D,
                       const bool* __restrict__ mask, const int32_t* __restrict__ cols,
                       int32_t w_dst, int k, int col_warps, int split, T* __restrict__ out) {
  // lanes whose rows a thread loads before adding them: 4 at 16 bytes a row
  constexpr int kInFlight = kMeanInFlightBytes / MeanRow<T, V>::kBytes < 16
                                ? kMeanInFlightBytes / MeanRow<T, V>::kBytes
                                : 16;
  extern __shared__ int32_t mean_smem[];
  __shared__ int team_count[kMeanBlockWarps];
  const int team_warps = col_warps * split;
  const int team_threads = 32 * team_warps;
  const int teams = blockDim.x / team_threads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / team_warps, tw = warp % team_warps;
  const int tt = threadIdx.x - team * team_threads;
  const int c_local = tw % col_warps, s = tw / col_warps;
  const int list_len = k < kMeanListLanes ? k : kMeanListLanes;
  int32_t* list = mean_smem + team * list_len;
  float* part = reinterpret_cast<float*>(mean_smem + teams * list_len);
  const long long row = static_cast<long long>(blockIdx.x) * teams + team;
  const bool live = row < w_dst;  // uniform within a team
  const int slice = 32 * V;       // columns a warp covers
  const int n_slices = (D + slice - 1) / slice;
  const int slice_iters = (n_slices + col_warps - 1) / col_warps;
  const int n_chunks = k > 0 ? (k + list_len - 1) / list_len : 0;
  if (threadIdx.x < teams) team_count[threadIdx.x] = 0;
  __syncthreads();
  for (int it = 0; it < slice_iters; ++it) {  // block-uniform
    const int c = c_local + it * col_warps;
    const int d = c * slice + lane * V;
    const bool active = live && c < n_slices && d < D;  // D % V == 0
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {  // block-uniform
      const int j0 = ch * list_len;
      const int n = k - j0 < list_len ? k - j0 : list_len;
      if (it == 0 || n_chunks > 1) {  // the lane list, read once when it fits
        __syncthreads();              // the list's last readers are done
        unsigned mine = 0;
        if (live) {
          for (int j = tt; j < n; j += team_threads) {
            const long long q = row * k + j0 + j;
            // mask and cols loaded side by side: one round trip, not two
            const bool m = mask[q];
            const long long col = cols != nullptr ? cols[q] : 0;
            int32_t e = -1;
            if (m) {
              e = cols != nullptr ? static_cast<int32_t>(qt_clamp<long long>(col, 0, w_src - 1))
                                  : j0 + j;
            }
            list[j] = e;
            mine += m;
          }
        }
        if (it == 0) {
          mine = __reduce_add_sync(0xFFFFFFFFu, mine);
          if (lane == 0 && mine) atomicAdd(&team_count[team], static_cast<int>(mine));
        }
        __syncthreads();
      }
      // this warp's part of the chunk: lanes [a, b), ascending
      const int a = static_cast<int>(static_cast<long long>(n) * s / split);
      const int b = static_cast<int>(static_cast<long long>(n) * (s + 1) / split);
      if (active) {
        for (int j = a; j < b; j += kInFlight) {
          MeanRow<T, V> r[kInFlight];
          int32_t e[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            e[u] = j + u < b ? list[j + u] : -1;
            if (e[u] >= 0) {
              const long long src = cols != nullptr
                                        ? static_cast<long long>(e[u])
                                        : static_cast<long long>(w_dst) * (1 + e[u]) + row;
              r[u].load(x + src * D + d);
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (e[u] >= 0) {
#pragma unroll
              for (int t = 0; t < V; ++t) acc[t] = __fadd_rn(acc[t], r[u].get(t));
            }
          }
        }
      }
    }
    if (split > 1) {  // then slice_iters == 1: the parts meet in shared memory
      float* mine = part + warp * slice + lane * V;
      if (s > 0) {
#pragma unroll
        for (int t = 0; t < V; ++t) mine[t] = acc[t];
      }
      __syncthreads();
      if (s == 0 && active) {
        for (int p = 1; p < split; ++p) {
          const float* other = part + (warp + p * col_warps) * slice + lane * V;
#pragma unroll
          for (int t = 0; t < V; ++t) acc[t] = __fadd_rn(acc[t], other[t]);
        }
      }
      __syncthreads();  // the parts are read before a next slice writes them
    }
    if (s == 0 && active) {
      const int cnt = team_count[team];
      const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = __fdiv_rn(acc[t], denom);
      mean_store<V>(out + row * D + d, acc);
    }
  }
}

template <typename T, int V>
static void launch_masked_mean(const void* x, long long w_src, int D, const void* mask,
                               const void* cols, int w_dst, int k, int col_warps, int split,
                               void* out, cudaStream_t st) {
  const int team_warps = col_warps * split;
  const int teams = team_warps < kMeanBlockWarps ? kMeanBlockWarps / team_warps : 1;
  const int list_len = k < kMeanListLanes ? k : kMeanListLanes;
  const size_t lists = static_cast<size_t>(teams) * list_len * sizeof(int32_t);
  const size_t parts = split > 1 ? static_cast<size_t>(teams) * team_warps * 32 * V * sizeof(float)
                                 : 0;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(w_dst) + teams - 1) / teams);
  qt_count_launch();
  masked_mean_kernel<T, V><<<blocks, 32 * team_warps * teams, lists + parts, st>>>(
      static_cast<const T*>(x), w_src, D, static_cast<const bool*>(mask),
      static_cast<const int32_t*>(cols), w_dst, k, col_warps, split, static_cast<T*>(out));
}

// bf16: 0 for float32 rows, 1 for bfloat16 rows (x and out alike); vec:
// elements a thread loads (float32 1, 2, 4; bfloat16 1, 2, 4, 8), D and
// both pointers aligned to it; col_warps x split <= 8 warps a target, or
// split = 1 and col_warps = 8 (a warp then walks several column slices)
QT_EXPORT int qt_masked_mean(const void* x, long long w_src, int D, const void* mask,
                             const void* cols, int w_dst, int k, void* out, int bf16, int vec,
                             int col_warps, int split, void* stream) {
  if (w_dst <= 0 || D <= 0) return 0;
  const size_t vb = static_cast<size_t>(vec) * (bf16 ? 2 : 4);
  const bool team_ok = col_warps >= 1 && split >= 1 && col_warps * split <= kMeanBlockWarps;
  if (k < 0 || !team_ok || D % vec != 0 || reinterpret_cast<uintptr_t>(x) % vb != 0 ||
      reinterpret_cast<uintptr_t>(out) % vb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*launch)(const void*, long long, int, const void*, const void*, int, int, int, int,
                 void*, cudaStream_t) = nullptr;
  switch (bf16 ? vec : -vec) {
    case -4: launch = launch_masked_mean<float, 4>; break;
    case -2: launch = launch_masked_mean<float, 2>; break;
    case -1: launch = launch_masked_mean<float, 1>; break;
    case 8: launch = launch_masked_mean<uint16_t, 8>; break;
    case 4: launch = launch_masked_mean<uint16_t, 4>; break;
    case 2: launch = launch_masked_mean<uint16_t, 2>; break;
    case 1: launch = launch_masked_mean<uint16_t, 1>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(x, w_src, D, mask, cols, w_dst, k, col_warps, split, out, st);
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
// this function (autograd adds it). Any k.
//
// Structural layout (cols == nullptr): src(i, j) = W + j*W + i, so each
// source row receives at most one term: one warp per source row writes it
// (or zeros), no reduction at all; the warp counts its target's valid
// lanes 32 at a time.
//
// Cols layout: many targets can name one source row, so this is a
// scatter-add. It is deterministic — no float atomics, and the sum of
// each source row runs over its lanes in ascending flat index q = i*k + j
// on every run, so two runs give bit-equal gradients. A warp per target
// row first counts its valid lanes and writes g[i] / max(cnt_i, 1) (a
// float32 division, as the reference's vjp of the divide) to a float32
// scratch row; then K14b's pipeline (below) runs on the lanes: the valid
// lanes' counts a source row (a thread a lane, integer atomics), the scan
// into segment offsets, the fill, the rank of each slot in its segment (a
// thread a slot, which stores the lane's target row i), and a warp per
// (source row, 128 columns) adds the ordered segment's scaled rows.
// Clipped columns are clipped as the forward clips them, and lanes the
// mask drops (invalid, or past a cap) add nothing. A bfloat16 gradient is
// divided and summed in float32 and rounded once, when stored.
//
// Bound on the card: bytes — g and the mask and cols read once, d x_src
// written once. Design: the scaled rows cost one float32 pass over g (W x
// D), so the sum's critical path, a hub source's segment (about 1,500
// lanes at batch 1024 on the products graph) walked by one warp a 128
// columns with 8 rows in flight, holds loads and adds only; the count,
// scan, fill and rank move 4-byte integers, the rank of a hub's n lanes in
// time n by n threads.

// each target row's gradient divided by its count max(cnt_i, 1), in
// float32: a warp a row
template <typename E>
__global__ void mean_scale_kernel(const typename E::T* __restrict__ g, int D,
                                  const bool* __restrict__ mask, int32_t w_dst, int k,
                                  float* __restrict__ scaled) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_dst) return;  // warp-uniform
  const int cnt = mean_row_count(mask, k, row, lane);
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  for (int c = lane; c < D; c += 32)
    scaled[row * D + c] = __fdiv_rn(E::load(g + row * D + c), denom);
}

// scan of the lane counts deg[n] into offsets[n + 1] (and a copy of the
// first n into cursor), in three coalesced passes over tiles of
// kScanTile: the tile totals, their scan in one block, then each tile's
// own scan plus its offset
// (kScanTile and the block scan: scan.cuh)
__global__ void mean_bwd_tile_sums_kernel(const int32_t* __restrict__ deg, long long n,
                                          int32_t* __restrict__ tile_sums) {
  const long long i = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  int32_t total;
  qt_block_exclusive_scan(i < n ? deg[i] : 0, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: tile_sums[t] becomes the exclusive prefix of tile t
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

// each valid lane's flat index into its source row's segment
__global__ void mean_bwd_fill_kernel(const bool* __restrict__ mask,
                                     const int32_t* __restrict__ cols, long long n_lanes,
                                     long long w_src, int32_t* __restrict__ cursor,
                                     int32_t* __restrict__ lanes) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_lanes || !mask[q]) return;
  const long long src = qt_clamp<long long>(cols[q], 0, w_src - 1);
  lanes[atomicAdd(cursor + src, 1)] = static_cast<int32_t>(q);
}

// rows the ordered sum (5, below) has in flight a warp
constexpr int kLanesInFlight = 8;

// structural layout: source row r = W + j*W + i takes lane (i, j) alone
template <typename E>
__global__ void mean_bwd_structural_kernel(const typename E::T* __restrict__ g, int D,
                                           const bool* __restrict__ mask, int32_t w_dst,
                                           int k, long long w_src,
                                           typename E::T* __restrict__ gx) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= w_src) return;  // warp-uniform
  const long long rel = row - w_dst;
  const bool inside = rel >= 0 && rel < static_cast<long long>(w_dst) * k;  // warp-uniform
  const long long i = inside ? rel % w_dst : 0;
  const int j = inside ? static_cast<int>(rel / w_dst) : 0;
  const int cnt = inside ? mean_row_count(mask, k, i, lane) : 0;
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  const bool take = inside && mask[i * k + j];
  for (int c = lane; c < D; c += 32)
    E::store(gx + row * D + c, take ? __fdiv_rn(E::load(g + i * D + c), denom) : 0.0f);
}

// The cols layout's scratch (K4b's and K14b's): lane counts, offsets,
// cursors, the lanes in arrival and in flat-index order, the scan's tile
// sums and (K4b only, D > 0) the scaled gradient rows, carved from one
// buffer of the caller's in 256-byte-aligned parts. Only this file knows
// the layout; the wrapper asks for its size.
struct MeanBwdScratch {
  int32_t *deg, *offsets, *cursor, *lanes, *sorted, *tile_sums;
  float* scaled;
  long long bytes;
};

static MeanBwdScratch mean_bwd_scratch(char* base, long long w_src, int w_dst, int k, int D) {
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
  s.tile_sums = reinterpret_cast<int32_t*>(take((w_src + kScanTile - 1) / kScanTile,
                                                sizeof(int32_t)));
  s.scaled = reinterpret_cast<float*>(take(static_cast<long long>(w_dst) * D, sizeof(float)));
  s.bytes = at;
  return s;
}

// bytes of scratch the cols layout needs at row width D (K4b), or D = 0
// (K14b); the structural layout needs none
QT_EXPORT int qt_masked_mean_backward_scratch(long long w_src, int w_dst, int k, int D,
                                              long long* bytes) {
  *bytes = mean_bwd_scratch(nullptr, w_src, w_dst, k, D).bytes;
  return 0;
}

// K14b: gather_src_backward — the gradient of the hop-source gather
// (K14, csrc/gather.cu) with respect to x_src: d x_src [W_src, F] from
// d out [W_dst, k, F].
//
// Replaces the autodiff of quiver_tpu/pyg/sage_sampler.py:
// DenseAdj.gather_src in the cols layout (the transpose of jnp.take: a
// scatter-add of every lane's cotangent row onto its clipped source row),
// as GCN (quiver_tpu/models/gcn.py:49) and GAT (models/gat.py:52) reach
// it. Only valid lanes are summed: every caller gives a masked lane a
// cotangent of +-0 (GCN and SAGE multiply by the mask, GAT's masked
// scores are -1e9 before a float32 softmax, whose exp is exactly 0), and
// adding +-0 to a sum that starts at +0 changes no bit, so the sum equals
// the scatter over every lane, while the masked lanes — which the sampler
// points at one real source row — never form a segment. Lane (i, j) adds
// g[i, j, :] to row clip(cols[i, j], 0, W_src - 1), in ascending flat
// lane index q = i*k + j: deterministic, no float atomics, so two runs
// give bit-equal gradients. Rows no valid lane names get zero. A bfloat16
// gradient is summed in float32 and rounded once.
//
// Bound on the card: bytes — the valid lanes' cotangent rows, the mask and
// cols read once, d x_src written once (3.7 GB of float32 cotangent at
// GAT's widest hop, 180,224 x 5 lanes of 1,024). Design, shared with K4b's
// cols layout: a CSR of sources (count with integer atomics, three-pass
// scan, fill of the valid lanes); then a thread per filled slot ranks its
// lane within its segment (the number of smaller lane indices), so a hub's
// segment of n lanes is ordered in time n by n threads; then a warp per
// (source row, 128 columns) walks the ordered segment, each lane summing 4
// columns with kLanesInFlight rows in flight, so a row of 1,024 columns is
// spread over 8 warps.

// 1 (K4b, K14b and K14c). a thread per lane: each valid lane adds one to
// its source row — clipped to [0, W_src) (drop = 0), or, as JAX's
// .at[cols].add(mode="drop") indexes, a negative col counted from the end
// and a col still outside [0, W_src) dropped (drop = 1)
__global__ void lane_count_kernel(const bool* __restrict__ mask,
                                  const int32_t* __restrict__ cols, long long n_lanes,
                                  long long w_src, int drop, int32_t* __restrict__ deg) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_lanes || !mask[q]) return;
  long long c = cols[q];
  if (drop) {
    if (c < 0) c += w_src;
    if (c < 0 || c >= w_src) return;
  } else {
    c = qt_clamp<long long>(c, 0, w_src - 1);
  }
  atomicAdd(deg + c, 1);
}

// 4. a thread per filled slot p: its lane q, its segment [base, base + n),
//    and its rank there; sorted[base + rank] = q / div, the lane's row of
//    the summed rows (div = k: its target row; div = 1: the lane). Slots
//    past the total (offsets[w_src]: the valid lanes) do nothing.
__global__ void src_rank_kernel(const int32_t* __restrict__ cols, long long n_lanes,
                                long long w_src, int div, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ lanes,
                                int32_t* __restrict__ sorted) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= n_lanes || p >= offsets[w_src]) return;
  const int32_t q = lanes[p];
  const long long src = qt_clamp<long long>(cols[q], 0, w_src - 1);
  const int32_t base = offsets[src];
  const int32_t n = offsets[src + 1] - base;
  int32_t rank = 0;
  for (int32_t t = 0; t < n; ++t) rank += lanes[base + t] < q;
  sorted[base + rank] = div == 1 ? q : q / div;
}

// 1-4 of the cols layout (K4b and K14b): each source row's segment of
// valid lanes, in ascending flat lane index, in sc.offsets and sc.sorted
static int src_segments(const bool* m, const int32_t* c, long long n_lanes, long long w_src,
                        int div, const MeanBwdScratch& sc, cudaStream_t st) {
  const int threads = 256;
  cudaError_t err = cudaMemsetAsync(sc.deg, 0, sizeof(int32_t) * w_src, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    qt_count_launch();
    lane_count_kernel<<<qt_blocks(n_lanes, threads), threads, 0, st>>>(m, c, n_lanes, w_src, 0,
                                                                       sc.deg);
    if (int e = qt_launch_status()) return e;
  }
  // 2. the scan into segment offsets
  const long long n_tiles = (w_src + kScanTile - 1) / kScanTile;
  qt_count_launch();
  mean_bwd_tile_sums_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(
      sc.deg, w_src, sc.tile_sums);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  qt_tile_offsets_kernel<<<1, kScanTile, 0, st>>>(sc.tile_sums, n_tiles, nullptr);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  mean_bwd_tile_scan_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, st>>>(
      sc.deg, w_src, sc.tile_sums, sc.offsets, sc.cursor);
  if (int e = qt_launch_status()) return e;
  if (n_lanes > 0) {
    // 3. the fill, then 4. the rank
    qt_count_launch();
    mean_bwd_fill_kernel<<<qt_blocks(n_lanes, threads), threads, 0, st>>>(
        m, c, n_lanes, w_src, sc.cursor, sc.lanes);
    if (int e = qt_launch_status()) return e;
    qt_count_launch();
    src_rank_kernel<<<qt_blocks(n_lanes, threads), threads, 0, st>>>(c, n_lanes, w_src, div,
                                                                     sc.offsets, sc.lanes,
                                                                     sc.sorted);
    if (int e = qt_launch_status()) return e;
  }
  return 0;
}

// 5. a warp per (source row, kSrcCols columns): lane l sums columns
//    c0 + 4l .. c0 + 4l + 3 (vec4: one 4-element load a row) or c0 + l +
//    32u, u < 4, over the rows x[r] its ordered segment names (K14b: the
//    lanes' cotangent rows; K4b: the targets' scaled rows)
constexpr int kSrcCols = 128;

template <typename In, typename Out>
__global__ void src_sum_kernel(const typename In::T* __restrict__ x, int F, long long w_src,
                               const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ sorted, bool vec4,
                               typename Out::T* __restrict__ gx) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (F + kSrcCols - 1) / kSrcCols;
  const long long row = warp / chunks;
  if (row >= w_src) return;  // warp-uniform
  const int c0 = static_cast<int>(warp - row * chunks) * kSrcCols;
  const int32_t base = offsets[row];
  const int32_t n = offsets[row + 1] - base;
  int col[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) col[u] = vec4 ? c0 + 4 * lane + u : c0 + lane + 32 * u;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int32_t t = 0; t < n; t += kLanesInFlight) {  // warp-uniform
    float4 v[kLanesInFlight];
#pragma unroll
    for (int u = 0; u < kLanesInFlight; ++u) {  // all loads first ...
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t + u < n) {
        const typename In::T* xr = x + static_cast<long long>(sorted[base + t + u]) * F;
        if (vec4) {
          if (col[0] < F) v[u] = In::load4(xr + col[0]);
        } else {
          if (col[0] < F) v[u].x = In::load(xr + col[0]);
          if (col[1] < F) v[u].y = In::load(xr + col[1]);
          if (col[2] < F) v[u].z = In::load(xr + col[2]);
          if (col[3] < F) v[u].w = In::load(xr + col[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLanesInFlight; ++u) {  // ... then the adds, in lane order
      if (t + u < n) {
        acc.x = __fadd_rn(acc.x, v[u].x);
        acc.y = __fadd_rn(acc.y, v[u].y);
        acc.z = __fadd_rn(acc.z, v[u].z);
        acc.w = __fadd_rn(acc.w, v[u].w);
      }
    }
  }
  typename Out::T* out = gx + row * F;
  if (vec4) {
    if (col[0] < F) Out::store4(out + col[0], acc);
  } else {
    if (col[0] < F) Out::store(out + col[0], acc.x);
    if (col[1] < F) Out::store(out + col[1], acc.y);
    if (col[2] < F) Out::store(out + col[2], acc.z);
    if (col[3] < F) Out::store(out + col[3], acc.w);
  }
}

// the segments of the cols layout, then the ordered sums (5) of the rows x
// (K14b: g itself, div = 1; K4b: the scaled rows of the targets, div = k)
template <typename In, typename Out>
static int src_backward(const typename In::T* x, int F, const bool* m, const int32_t* c,
                        long long n_lanes, long long w_src, int div, void* gx,
                        const MeanBwdScratch& sc, cudaStream_t st) {
  if (n_lanes > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (int e = src_segments(m, c, n_lanes, w_src, div, sc, st)) return e;
  const int threads = 256;
  const uintptr_t align = 4 * sizeof(typename Out::T);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(*x)) == 0 &&
                    reinterpret_cast<uintptr_t>(gx) % align == 0;
  const long long warps = w_src * ((F + kSrcCols - 1) / kSrcCols);
  qt_count_launch();
  src_sum_kernel<In, Out><<<qt_blocks(warps * 32, threads), threads, 0, st>>>(
      x, F, w_src, sc.offsets, sc.sorted, vec4, static_cast<typename Out::T*>(gx));
  return qt_launch_status();
}

template <typename E>
static int masked_mean_backward_any(const void* g, int D, const void* mask, const void* cols,
                                    int w_dst, int k, long long w_src, void* gx, void* scratch,
                                    long long scratch_bytes, cudaStream_t st) {
  const int threads = 256;
  const typename E::T* gt = static_cast<const typename E::T*>(g);
  const bool* m = static_cast<const bool*>(mask);
  if (cols == nullptr) {
    qt_count_launch();
    mean_bwd_structural_kernel<E><<<qt_blocks(w_src * 32, threads), threads, 0, st>>>(
        gt, D, m, w_dst, k, w_src, static_cast<typename E::T*>(gx));
    return qt_launch_status();
  }
  const MeanBwdScratch sc = mean_bwd_scratch(static_cast<char*>(scratch), w_src, w_dst, k, D);
  if (scratch == nullptr || scratch_bytes < sc.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_dst > 0) {
    qt_count_launch();
    mean_scale_kernel<E><<<qt_blocks(static_cast<long long>(w_dst) * 32, threads), threads, 0,
                           st>>>(gt, D, m, w_dst, k, sc.scaled);
    if (int e = qt_launch_status()) return e;
  }
  return src_backward<QtF32, E>(sc.scaled, D, m, static_cast<const int32_t*>(cols),
                                static_cast<long long>(w_dst) * k, w_src, k, gx, sc, st);
}

template <typename E>
static int gather_src_backward_any(const void* g, int F, const void* mask, const void* cols,
                                   int w_dst, int k, long long w_src, void* gx, void* scratch,
                                   long long scratch_bytes, cudaStream_t st) {
  const MeanBwdScratch sc = mean_bwd_scratch(static_cast<char*>(scratch), w_src, w_dst, k, 0);
  if (scratch == nullptr || scratch_bytes < sc.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return src_backward<E, E>(static_cast<const typename E::T*>(g), F,
                            static_cast<const bool*>(mask), static_cast<const int32_t*>(cols),
                            static_cast<long long>(w_dst) * k, w_src, 1, gx, sc, st);
}

// g is [w_dst, D], gx [w_src, D]; scratch (the cols layout) as
// qt_masked_mean_backward_scratch(w_src, w_dst, k, D) gives; bf16: 0 for a
// float32 gradient, 1 for a bfloat16 one (g and gx alike). Any k (w_dst * k
// < 2^31).
QT_EXPORT int qt_masked_mean_backward(const void* g, int D, const void* mask, const void* cols,
                                      int w_dst, int k, long long w_src, void* gx, void* scratch,
                                      long long scratch_bytes, int bf16, void* stream) {
  if (w_src <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? masked_mean_backward_any<QtBF16>(g, D, mask, cols, w_dst, k, w_src, gx, scratch,
                                                 scratch_bytes, st)
              : masked_mean_backward_any<QtF32>(g, D, mask, cols, w_dst, k, w_src, gx, scratch,
                                                scratch_bytes, st);
}

// g is [w_dst * k, F] (the flat lanes' cotangent rows), gx [w_src, F];
// scratch as qt_masked_mean_backward_scratch(w_src, w_dst, k, 0) gives;
// bf16: 0 for float32 rows, 1 for bfloat16 rows. Any k (w_dst * k < 2^31).
QT_EXPORT int qt_gather_src_backward(const void* g, int F, const void* mask, const void* cols,
                                     int w_dst, int k, long long w_src, void* gx, void* scratch,
                                     long long scratch_bytes, int bf16, void* stream) {
  if (w_src <= 0 || F <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? gather_src_backward_any<QtBF16>(g, F, mask, cols, w_dst, k, w_src, gx, scratch,
                                                scratch_bytes, st)
              : gather_src_backward_any<QtF32>(g, F, mask, cols, w_dst, k, w_src, gx, scratch,
                                               scratch_bytes, st);
}

// K14c: block_out_degree — GCN's within-block source out-degree.
//
// Replaces quiver_tpu/models/gcn.py:69-71, jnp.zeros(W_src).at[cols].add(
// mask, mode="drop") in float32: deg_out[s] is the number of valid lanes
// whose col names s, a negative col counting from the end (-1 is W_src - 1)
// as JAX's indexing does, and a col outside [-W_src, W_src) dropped — not
// clipped, as the gather clips. The count is exact and does not depend on
// the order, so the result is bit-equal to the plain version's.
//
// Bound on the card: bytes — the mask and cols read once, W_src float32
// written once (and the [W_src] int32 counts zeroed, counted and read).
// Design: K14b's count kernel (drop = 1) with integer atomics, then one
// conversion a row.
__global__ void count_to_float_kernel(const int32_t* __restrict__ deg, long long n,
                                      float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(deg[i]);
}

// deg: [w_src] int32 scratch; out: [w_src] float32
QT_EXPORT int qt_block_out_degree(const void* mask, const void* cols, long long n_lanes,
                                  long long w_src, void* deg, void* out, void* stream) {
  if (w_src <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int32_t* d = static_cast<int32_t*>(deg);
  cudaError_t err = cudaMemsetAsync(d, 0, sizeof(int32_t) * w_src, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    qt_count_launch();
    lane_count_kernel<<<qt_blocks(n_lanes, threads), threads, 0, st>>>(
        static_cast<const bool*>(mask), static_cast<const int32_t*>(cols), n_lanes, w_src, 1, d);
    if (int e = qt_launch_status()) return e;
  }
  qt_count_launch();
  count_to_float_kernel<<<qt_blocks(w_src, threads), threads, 0, st>>>(d, w_src,
                                                                      static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
