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

#include <cooperative_groups.h>

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
// scatter-add. It runs K14b's one launch (below) over the targets' rows
// divided by their count: its first phase writes g[i] / max(cnt_i, 1) (a
// float32 division) to a float32 scratch row a target, and its segments
// store each lane's target row i. Deterministic: no float atomics, and
// each source row's sum runs over its lanes in ascending flat index q =
// i*k + j on every run. A bfloat16 gradient is divided and summed in
// float32 and rounded once, when stored.
//
// Bound on the card: bytes — g and the mask and cols read once, d x_src
// written once; the scaled rows cost one float32 pass over g (W x D).

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
// cols read once, d x_src written once (2.5 GB of float32 cotangent at
// GAT's widest hop, 607,475 valid lanes of 1,024). What held the first
// design back at the small layers: a chain of eight device operations a
// call (a memset and seven kernels: count, three scan passes, fill, rank,
// sum), each moving a few KB to a few MB, so the chain's launches were the
// call's time; and a rank pass that walked a source's whole segment for
// each of its n lanes (n^2 loads at a hub).
//
// Design: one launch a call, a grid of blocks of 1,024 threads (one an SM
// at most, as many as the call's rows need), 224 KB of shared memory each.
// A call of at most kSrcSmallLanes lanes takes the small path, src_small
// below, with no grid barrier (K14b launches it plainly; K4b cooperatively,
// for one barrier after its scaling). Otherwise a cooperative launch of
// co-resident blocks runs these phases, apart by grid-wide barriers:
//  0. the counts and the count tiles' sums zeroed (K4b first writes the
//     targets' rows divided by their counts, a warp a target);
//  1. count: a thread a lane, integer atomics on the clipped source, and a
//     warp's lanes of one 1,024-source tile added to that tile's sum at
//     once (a match of the warp's tiles);
//  2. scan: a block a tile of counts, its offset the sum of the tile sums
//     before it, then a block scan into segment offsets (and cursors in
//     place of the counts); segments of more than kSrcWarpSortMax lanes are
//     listed for step 4, and of more than kSrcLongRow lanes for step 5;
//  3. fill: each valid lane at its cursor (integer atomics: any order);
//  4. order: a block takes each segment of more than kSrcWarpSortMax lanes
//     and orders it through a bitmap of its lane indices in shared memory
//     (up to 1,835,008 lanes a window, each a block scan of the set bits'
//     counts); a warp takes 32 sources at a time: when their segments are
//     at most 32 lanes each and 1,024 together, it reads them at once,
//     sorts each in registers (a bitonic network of shuffles) and writes
//     them at once; else it sorts each segment of 2 to kSrcWarpSortMax
//     lanes in registers or in its 4 KB of shared memory (a bitonic
//     network). No slot walks its segment;
//  5. sum: a block takes each 128-column chunk of a source of more than
//     kSrcLongRow lanes: its warps stage batches of the lanes' rows in
//     shared memory and one warp adds them in order. Then a warp takes up
//     to 32 consecutive source rows and 128 columns, reads their offsets
//     at once and walks the lanes of the short rows among them as one
//     list, 32 indices a load and kLanesInFlight rows in flight a lane
//     (16-byte loads where F and the pointers allow, kept as loaded until
//     added), adding in lane order and storing each row as its list ends.

constexpr int kSrcThreads = kScanTile;      // threads a block of the one launch
constexpr int kSrcWarps = kSrcThreads / 32;
constexpr int kSrcWarpSortMax = 1024;       // longest segment a warp sorts (in shared memory)
constexpr int kSrcSmemBytes = 224 * 1024;   // a block's dynamic shared memory
constexpr int kSrcLongRow = 64;             // rows of more lanes are summed by a whole block
constexpr int kSrcBlockWork = 1024;         // row-chunks a block of the grid takes at least
constexpr int kSrcSmallLanes = 16384;       // the small path's most lanes ...
constexpr int kSrcSmallRows = 2048;         // ... rows a block ...
constexpr int kSrcSmallGroup = 256;         // ... lanes of 32 rows a warp orders at once
constexpr int kSrcSmallWork = 256;          // its row-chunks a block
constexpr int kSrcSmallLongRow = 16;        // its rows of more lanes are summed by the block
constexpr int kSrcSmallPerThread = 16;      // lanes a thread holds: kSrcSmallLanes / kSrcThreads
constexpr int kSrcCols = 128;               // columns a warp of the sum covers
constexpr int kLanesInFlight = 8;           // rows the sum has in flight a warp
static_assert(4 * kSrcWarps * kSrcWarpSortMax <= kSrcSmemBytes, "the warps' sorts must fit");
static_assert(kSrcSmallPerThread * kSrcThreads == kSrcSmallLanes, "a thread holds its lanes");
static_assert(4 * (2 * kSrcSmallRows + 1 + kSrcSmallLanes + kSrcSmallLanes / 32 +
                   kSrcWarps * kSrcSmallGroup + 4) + 16 * 32 * 64 <= kSrcSmemBytes,
              "the small path and a 64-row batch of one chunk must fit");

// The cols layout's scratch (K4b's and K14b's): counts (then cursors),
// offsets, the lanes in arrival and in flat-index order, the count tiles'
// sums, the lists of long segments and their lengths and (K4b only, D >
// 0) the scaled gradient rows, carved from one buffer of the caller's in
// 256-byte-aligned parts. Only this file knows the layout; the wrapper
// asks for its size.
struct MeanBwdScratch {
  int32_t *deg, *offsets, *lanes, *sorted, *tile_sums, *order_long, *sum_long, *n_long;
  float* scaled;
  long long n_tiles, bytes;
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
  s.n_tiles = (w_src + kScanTile - 1) / kScanTile;
  s.deg = reinterpret_cast<int32_t*>(take(w_src, sizeof(int32_t)));
  s.offsets = reinterpret_cast<int32_t*>(take(w_src + 1, sizeof(int32_t)));
  s.lanes = reinterpret_cast<int32_t*>(take(n_lanes, sizeof(int32_t)));
  s.sorted = reinterpret_cast<int32_t*>(take(n_lanes, sizeof(int32_t)));
  s.tile_sums = reinterpret_cast<int32_t*>(take(s.n_tiles, sizeof(int32_t)));
  const long long longs = n_lanes / (kSrcLongRow + 1) + 1;  // segments above kSrcLongRow
  s.order_long = reinterpret_cast<int32_t*>(take(longs, sizeof(int32_t)));
  s.sum_long = reinterpret_cast<int32_t*>(take(longs, sizeof(int32_t)));
  s.n_long = reinterpret_cast<int32_t*>(take(2, sizeof(int32_t)));
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

// the one launch's arguments: the rows summed are x (K14b: g itself, div
// = 1, a lane's row is q) or, with g_scale (K4b), the scaled rows phase 0
// writes from it (div = k, a lane's row is its target q / k)
struct SrcArgs {
  const void* x;
  const void* g_scale;
  const bool* mask;
  const int32_t* cols;
  long long n_lanes, w_src;
  int w_dst, k, F, div, rows_per_item;
  bool vec4, small;
  void* gx;
  MeanBwdScratch sc;
};

// ascending sort of one value a lane across the warp (bitonic network)
__device__ __forceinline__ int32_t warp_sort32(int32_t x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int32_t other = __shfl_xor_sync(0xFFFFFFFFu, x, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      x = (low == up) ? min(x, other) : max(x, other);
    }
  }
  return x;
}

// ascending sort of buf[0, P) in shared memory by one warp (bitonic
// network; P a power of two)
__device__ __forceinline__ void warp_sort_smem(int32_t* buf, int P, int lane) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < P / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const int32_t x = buf[lo], y = buf[hi];
        if ((x > y) == ((lo & size) == 0)) {
          buf[lo] = y;
          buf[hi] = x;
        }
      }
      __syncwarp();
    }
  }
}

// 4, a block: the segment [base, base + n) of lanes[] in ascending order
// into sorted[] (lanes and sorted may be one array when one window covers
// the segment), as lane index / div, through bitmap windows of `words`
// words of shared memory at bits
__device__ void src_order_long(const int32_t* lanes, int32_t* sorted, int32_t base, int32_t n,
                               int div, uint32_t* bits, int words) {
  __shared__ int32_t red[2][kSrcWarps];
  int32_t lo = INT32_MAX, hi = -1;
  for (int32_t p = threadIdx.x; p < n; p += kSrcThreads) {
    const int32_t q = lanes[base + p];
    lo = min(lo, q);
    hi = max(hi, q);
  }
  lo = __reduce_min_sync(0xFFFFFFFFu, lo);
  hi = __reduce_max_sync(0xFFFFFFFFu, hi);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = lo;
    red[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  lo = __reduce_min_sync(0xFFFFFFFFu, red[0][threadIdx.x & 31]);
  hi = __reduce_max_sync(0xFFFFFFFFu, red[1][threadIdx.x & 31]);
  const int per = (words + kSrcThreads - 1) / kSrcThreads;  // words a thread owns
  int32_t written = 0;
  for (long long w0 = lo & ~31; w0 <= hi; w0 += 32LL * words) {  // block-uniform
    for (int i = threadIdx.x; i < words; i += kSrcThreads) bits[i] = 0;
    __syncthreads();
    for (int32_t p = threadIdx.x; p < n; p += kSrcThreads) {
      const long long rel = lanes[base + p] - w0;
      if (rel >= 0 && rel < 32LL * words) atomicOr(bits + (rel >> 5), 1u << (rel & 31));
    }
    __syncthreads();
    const int first = threadIdx.x * per, last = first + per < words ? first + per : words;
    int32_t cnt = 0;
    for (int i = first; i < last; ++i) cnt += __popc(bits[i]);
    int32_t total;
    int32_t at = base + written + qt_block_exclusive_scan(cnt, &total);
    for (int i = first; i < last; ++i) {
      for (uint32_t m = bits[i]; m; m &= m - 1) {
        const long long q = w0 + 32LL * i + __ffs(m) - 1;
        sorted[at++] = static_cast<int32_t>(div == 1 ? q : q / div);
      }
    }
    written += total;
    __syncthreads();  // the window is read before the next one clears it
  }
}

// 4, the warps: the segments of sources [0, n_src) of at most sort_max
// lanes (a longer one is left to src_order_long), lanes[off[s], off[s + 1])
// in ascending order into sorted[] (lanes and sorted may be one array), as
// lane index / div; warp `warp` of n_warps takes 32 sources at a time,
// with buf_len words of shared memory at buf (at least sort_max). When the
// 32 sources' segments are at most 32 lanes each and buf_len together, it
// reads them at once, sorts each in registers and writes them at once;
// else it sorts each segment of 2 to sort_max lanes in registers or in buf.
__device__ void src_order_short(const int32_t* off, const int32_t* lanes, int32_t* sorted,
                                long long n_src, int div, long long warp, long long n_warps,
                                int32_t* buf, int buf_len, int sort_max) {
  const int lane = threadIdx.x & 31;
  for (long long s0 = warp * 32; s0 < n_src; s0 += n_warps * 32) {  // warp-uniform
    const long long s = s0 + lane;
    const int32_t base = s < n_src ? off[s] : 0;
    const int32_t n = s < n_src ? off[s + 1] - base : 0;
    const int32_t g0 = __shfl_sync(0xFFFFFFFFu, base, 0);
    const int32_t g_end =
        static_cast<int32_t>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(base + n)));
    if (g_end - g0 <= buf_len && __all_sync(0xFFFFFFFFu, n <= 32)) {  // the group at once
      for (int i = lane; i < g_end - g0; i += 32) buf[i] = lanes[g0 + i];
      __syncwarp();
      for (unsigned many = __ballot_sync(0xFFFFFFFFu, n > 1); many; many &= many - 1) {
        const int who = __ffs(many) - 1;
        const int32_t b = __shfl_sync(0xFFFFFFFFu, base, who) - g0;
        const int32_t m = __shfl_sync(0xFFFFFFFFu, n, who);
        const int32_t q = warp_sort32(lane < m ? buf[b + lane] : INT32_MAX, lane);
        if (lane < m) buf[b + lane] = q;
        __syncwarp();
      }
      for (int i = lane; i < g_end - g0; i += 32) sorted[g0 + i] = div == 1 ? buf[i] : buf[i] / div;
      __syncwarp();
      continue;
    }
    if (n == 1) {
      const int32_t q = lanes[base];
      sorted[base] = div == 1 ? q : q / div;
    }
    for (unsigned many = __ballot_sync(0xFFFFFFFFu, n > 1 && n <= sort_max); many;
         many &= many - 1) {
      const int who = __ffs(many) - 1;
      const int32_t b = __shfl_sync(0xFFFFFFFFu, base, who);
      const int32_t m = __shfl_sync(0xFFFFFFFFu, n, who);
      if (m <= 32) {  // in registers
        const int32_t q = warp_sort32(lane < m ? lanes[b + lane] : INT32_MAX, lane);
        if (lane < m) sorted[b + lane] = div == 1 ? q : q / div;
      } else {  // in buf, padded to a power of two
        int P = 64;
        while (P < m) P <<= 1;
        for (int i = lane; i < P; i += 32) buf[i] = i < m ? lanes[b + i] : INT32_MAX;
        __syncwarp();
        warp_sort_smem(buf, P, lane);
        for (int i = lane; i < m; i += 32) sorted[b + i] = div == 1 ? buf[i] : buf[i] / div;
        __syncwarp();
      }
    }
  }
}

// Four columns of one row as loaded — float32 in 4 words, bfloat16 in 2 —
// widened to float32 only when added, so the rows in flight take few
// registers. Columns at or past F read as +0.
template <typename T>
struct SrcCols;

template <>
struct SrcCols<float> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const float* xr, const int (&col)[4], int F, bool vec4) {
    if (vec4) {
      const uint4 t = col[0] < F ? *reinterpret_cast<const uint4*>(xr + col[0])
                                 : make_uint4(0u, 0u, 0u, 0u);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = col[u] < F ? __float_as_uint(xr[col[u]]) : 0u;
    }
  }
  __device__ __forceinline__ float get(int u) const { return __uint_as_float(w[u]); }
};

template <>
struct SrcCols<uint16_t> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const uint16_t* xr, const int (&col)[4], int F,
                                       bool vec4) {
    if (vec4) {
      const uint2 t =
          col[0] < F ? *reinterpret_cast<const uint2*>(xr + col[0]) : make_uint2(0u, 0u);
      w[0] = t.x, w[1] = t.y;
    } else {
      uint32_t h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) h[u] = col[u] < F ? xr[col[u]] : 0u;
      w[0] = h[0] | (h[1] << 16), w[1] = h[2] | (h[3] << 16);
    }
  }
  __device__ __forceinline__ float get(int u) const {
    return qt_bf16_to_float((u & 1) ? (w[u >> 1] >> 16) : (w[u >> 1] & 0xffffu));
  }
};

// the columns a lane of a warp covers in a 128-column chunk at c0: 4 in a
// row (vec4) or 32 apart
__device__ __forceinline__ void src_cols(int c0, int lane, bool vec4, int (&col)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) col[u] = vec4 ? c0 + 4 * lane + u : c0 + lane + 32 * u;
}

template <typename Out>
__device__ __forceinline__ void src_store(typename Out::T* o, const int (&col)[4], int F,
                                          bool vec4, const float4& v) {
  if (vec4) {
    if (col[0] < F) Out::store4(o + col[0], v);
  } else {
    if (col[0] < F) Out::store(o + col[0], v.x);
    if (col[1] < F) Out::store(o + col[1], v.y);
    if (col[2] < F) Out::store(o + col[2], v.z);
    if (col[3] < F) Out::store(o + col[3], v.w);
  }
}

// 5, a warp: rows row0 .. row0 + nr - 1 of gx at columns [c0, c0 +
// kSrcCols); row i's lanes are list[off[i], off[i + 1])
template <typename In, typename Out>
__device__ void src_sum_rows(const SrcArgs& a, const int32_t* off, const int32_t* list,
                             long long row0, int nr, int c0, int lane) {
  const typename In::T* x = static_cast<const typename In::T*>(a.x);
  typename Out::T* gx = static_cast<typename Out::T*>(a.gx);
  const int F = a.F;
  const int32_t end_l = lane < nr ? off[lane + 1] : 0;  // row lane's list end
  const int32_t p_end = __shfl_sync(0xFFFFFFFFu, end_l, nr - 1);
  int col[4];
  src_cols(c0, lane, a.vec4, col);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int row = 0;  // warp-uniform from here on
  int32_t row_end = __shfl_sync(0xFFFFFFFFu, end_l, 0);
  for (int32_t p = off[0]; p < p_end; p += 32) {
    const int m = p_end - p < 32 ? p_end - p : 32;
    const int32_t idx = lane < m ? list[p + lane] : 0;  // 32 entries' rows at once
    for (int t = 0; t < m; t += kLanesInFlight) {
      SrcCols<typename In::T> v[kLanesInFlight];
#pragma unroll
      for (int u = 0; u < kLanesInFlight; ++u) {  // all loads first ...
        const int32_t r = __shfl_sync(0xFFFFFFFFu, idx, (t + u) & 31);
        if (t + u < m) v[u].load(x + static_cast<long long>(r) * F, col, F, a.vec4);
      }
#pragma unroll
      for (int u = 0; u < kLanesInFlight; ++u) {  // ... then the adds, in lane order
        if (t + u < m) {
          while (p + t + u >= row_end) {  // the rows before this entry's are complete
            src_store<Out>(gx + (row0 + row) * F, col, F, a.vec4, acc);
            acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            ++row;
            row_end = __shfl_sync(0xFFFFFFFFu, end_l, row);
          }
          acc.x = __fadd_rn(acc.x, v[u].get(0));
          acc.y = __fadd_rn(acc.y, v[u].get(1));
          acc.z = __fadd_rn(acc.z, v[u].get(2));
          acc.w = __fadd_rn(acc.w, v[u].get(3));
        }
      }
    }
  }
  for (; row < nr; ++row) {
    src_store<Out>(gx + (row0 + row) * F, col, F, a.vec4, acc);
    acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// 5, the warps: rows [0, n_rows) of off (row i's lanes list[off[i], off[i
// + 1]), row i of gx row0 + i), rows_per_item rows and kSrcCols columns an
// item, warp `warp` of n_warps; each run of rows of at most long_row
// lanes between longer ones (summed by src_sum_long_row)
template <typename In, typename Out>
__device__ void src_sum_short(const SrcArgs& a, const int32_t* off, const int32_t* list,
                              long long row0, long long n_rows, long long warp, long long n_warps,
                              int long_row) {
  const int lane = threadIdx.x & 31;
  const int chunks = (a.F + kSrcCols - 1) / kSrcCols;
  const int rpi = a.rows_per_item;
  const long long n_items = (n_rows + rpi - 1) / rpi * chunks;
  for (long long item = warp; item < n_items; item += n_warps) {  // warp-uniform
    const long long i0 = item / chunks * rpi;
    const int nr = static_cast<int>(n_rows - i0 < rpi ? n_rows - i0 : rpi);
    const int c0 = static_cast<int>(item % chunks) * kSrcCols;
    const int32_t n_l = lane < nr ? off[i0 + lane + 1] - off[i0 + lane] : 0;
    unsigned runs = __ballot_sync(0xFFFFFFFFu, lane < nr && n_l <= long_row);
    while (runs) {
      const int r_a = __ffs(runs) - 1;
      const unsigned above = ~runs & (0xFFFFFFFFu << r_a);  // rows from r_a not in the run
      const int r_b = above ? __ffs(above) - 1 : 32;
      src_sum_rows<In, Out>(a, off + i0 + r_a, list, row0 + i0 + r_a, (r_b < nr ? r_b : nr) - r_a,
                            c0, lane);
      runs &= r_b < 32 ? ~((1u << r_b) - 1) : 0u;
    }
  }
}

// 5, a block: gx row `row` at column chunks [cg, cg + cn), its lanes
// list[start, end); batches of the lanes' rows staged in stage (stage_f4
// float4), warp w adding chunk cg + w (cn <= kSrcWarps)
template <typename In, typename Out>
__device__ void src_sum_long_row(const SrcArgs& a, const int32_t* list, long long row,
                                 int32_t start, int32_t end, int cg, int cn, float4* stage,
                                 int stage_f4) {
  const typename In::T* x = static_cast<const typename In::T*>(a.x);
  const int F = a.F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = cn * 32;  // staged float4 a row
  const int batch = stage_f4 / width;
  int col[4];
  src_cols((cg + warp) * kSrcCols, lane, a.vec4, col);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr int kPer = 8;  // staged slots a thread loads at once
  for (int32_t e0 = start; e0 < end; e0 += batch) {  // block-uniform
    const int nb = end - e0 < batch ? end - e0 : batch;
    for (int i0 = 0; i0 < nb * width; i0 += kPer * kSrcThreads) {
      SrcCols<typename In::T> v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // all loads first ...
        const int i = i0 + u * kSrcThreads + threadIdx.x;
        if (i < nb * width) {
          const int kr = i / width, slot = i - kr * width;
          int c[4];
          src_cols((cg + slot / 32) * kSrcCols, slot & 31, a.vec4, c);
          v[u].load(x + static_cast<long long>(list[e0 + kr]) * F, c, F, a.vec4);
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // ... then the stores
        const int i = i0 + u * kSrcThreads + threadIdx.x;
        if (i < nb * width)
          stage[i] = make_float4(v[u].get(0), v[u].get(1), v[u].get(2), v[u].get(3));
      }
    }
    __syncthreads();
    if (warp < cn) {
#pragma unroll 4
      for (int kr = 0; kr < nb; ++kr) {
        const float4 v = stage[kr * width + warp * 32 + lane];
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
    }
    __syncthreads();  // the batch is read before the next one is staged
  }
  if (warp < cn)
    src_store<Out>(static_cast<typename Out::T*>(a.gx) + row * F, col, F, a.vec4, acc);
}

// this thread's lanes q = u * kSrcThreads + threadIdx.x (every lane of a
// small call: kSrcSmallPerThread * kSrcThreads = kSrcSmallLanes), each its
// source row's index in [lo, hi) less lo, or -1 (invalid, or another
// block's row); the mask and cols of all of them read at once
__device__ __forceinline__ void src_small_read(const SrcArgs& a, long long lo, long long hi,
                                               int (&loc)[kSrcSmallPerThread]) {
  bool m[kSrcSmallPerThread];
  int32_t c[kSrcSmallPerThread];
#pragma unroll
  for (int u = 0; u < kSrcSmallPerThread; ++u) {
    const long long q = u * kSrcThreads + threadIdx.x;
    m[u] = q < a.n_lanes && a.mask[q];
    c[u] = q < a.n_lanes ? a.cols[q] : 0;
  }
#pragma unroll
  for (int u = 0; u < kSrcSmallPerThread; ++u) {
    const long long s = qt_clamp<long long>(c[u], 0, a.w_src - 1);
    loc[u] = m[u] && s >= lo && s < hi ? static_cast<int>(s - lo) : -1;
  }
}

// A call small enough (kSrcSmallLanes lanes, kSrcSmallRows rows a block)
// takes no grid barrier (K4b: one, after the scaling): block b reads every
// lane, keeps those of its own rows [b R, b R + R) and counts, orders and
// sums them in its shared memory. Its segments of more than 32 lanes are
// ordered through a bitmap of every lane index (one window), the others by
// its warps; its rows of more than kSrcSmallLongRow lanes are summed by the
// block, the others by its warps.
template <typename In, typename Out>
__device__ void src_small(const SrcArgs& a, int32_t* smem) {
  const int warp = threadIdx.x >> 5;
  const long long R = (a.w_src + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * R, hi = lo + R < a.w_src ? lo + R : a.w_src;
  const int n_rows = lo < hi ? static_cast<int>(hi - lo) : 0;
  const int words = a.n_lanes > 32 ? static_cast<int>((a.n_lanes + 31) / 32) : 1;
  int32_t* base = smem;                                  // [kSrcSmallRows + 1]
  int32_t* lanes = base + kSrcSmallRows + 1;             // [kSrcSmallLanes]
  int32_t* longs = lanes + kSrcSmallLanes;               // [kSrcSmallRows]
  uint32_t* bits = reinterpret_cast<uint32_t*>(longs + kSrcSmallRows);  // [kSrcSmallLanes / 32]
  int32_t* bufs = reinterpret_cast<int32_t*>(bits + kSrcSmallLanes / 32);  // a warp's groups
  float4* stage = reinterpret_cast<float4*>(bufs + kSrcWarps * kSrcSmallGroup + 3);
  stage = reinterpret_cast<float4*>((reinterpret_cast<uintptr_t>(stage) + 15) & ~uintptr_t{15});
  const int stage_f4 = static_cast<int>(
      (reinterpret_cast<char*>(smem) + kSrcSmemBytes - reinterpret_cast<char*>(stage)) /
      static_cast<long long>(sizeof(float4)));
  __shared__ int32_t n_longs;
  // counts of the own rows, base[i + 1] for row lo + i
  for (int i = threadIdx.x; i <= n_rows; i += kSrcThreads) base[i] = 0;
  if (threadIdx.x == 0) n_longs = 0;
  __syncthreads();
  int loc[kSrcSmallPerThread];  // this thread's lanes, read once for the count and the fill
  src_small_read(a, lo, hi, loc);
#pragma unroll
  for (int u = 0; u < kSrcSmallPerThread; ++u) {
    if (loc[u] >= 0) atomicAdd(base + loc[u] + 1, 1);
  }
  __syncthreads();
  // their starts (a block scan), and the rows of more than 32 lanes
  int32_t carry = 0;
  for (int c0 = 0; c0 < n_rows; c0 += kSrcThreads) {  // block-uniform
    const int i = c0 + threadIdx.x;
    const int32_t v = i < n_rows ? base[i + 1] : 0;
    int32_t total;
    const int32_t ex = qt_block_exclusive_scan(v, &total);
    if (i < n_rows) {
      base[i + 1] = carry + ex;
      if (v > min(32, kSrcSmallLongRow)) longs[atomicAdd(&n_longs, 1)] = i;
    }
    carry += total;
  }
  __syncthreads();
  // the fill: base[i + 1] ends as row lo + i's end
#pragma unroll
  for (int u = 0; u < kSrcSmallPerThread; ++u) {
    if (loc[u] >= 0) lanes[atomicAdd(base + loc[u] + 1, 1)] = u * kSrcThreads + threadIdx.x;
  }
  __syncthreads();
  // the order, in place: the segments of more than 32 lanes by the block,
  // then the others by the warps
  const int n_long = n_longs;
  for (int j = 0; j < n_long; ++j) {  // block-uniform
    const int i = longs[j];
    if (base[i + 1] - base[i] > 32)
      src_order_long(lanes, lanes, base[i], base[i + 1] - base[i], a.div, bits, words);
  }
  src_order_short(base, lanes, lanes, n_rows, a.div, warp, kSrcWarps,
                  bufs + warp * kSrcSmallGroup, kSrcSmallGroup, 32);
  __syncthreads();
  // the sums: the long rows by the block, every chunk at once, then the others
  const int chunks = (a.F + kSrcCols - 1) / kSrcCols;
  for (int j = 0; j < n_long; ++j) {  // block-uniform
    const int i = longs[j];
    if (base[i + 1] - base[i] <= kSrcSmallLongRow) continue;
    for (int cg = 0; cg < chunks; cg += kSrcWarps)
      src_sum_long_row<In, Out>(a, lanes, lo + i, base[i], base[i + 1], cg,
                                chunks - cg < kSrcWarps ? chunks - cg : kSrcWarps, stage,
                                stage_f4);
  }
  src_sum_short<In, Out>(a, base, lanes, lo, n_rows, warp, kSrcWarps, kSrcSmallLongRow);
}

template <typename In, typename Out, bool kScale>
__global__ void __launch_bounds__(kSrcThreads, 1) src_backward_kernel(const SrcArgs a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 src_smem[];  // kSrcSmemBytes: steps 4 and 5, or the small path
  const MeanBwdScratch& sc = a.sc;
  const long long tid = blockIdx.x * static_cast<long long>(kSrcThreads) + threadIdx.x;
  const long long n_threads = static_cast<long long>(gridDim.x) * kSrcThreads;
  const int lane = threadIdx.x & 31;
  const long long warp = tid >> 5, n_warps = n_threads >> 5;
  const long long w_src = a.w_src;

  // K4b: the targets' rows scaled
  if constexpr (kScale) {
    const typename Out::T* g = static_cast<const typename Out::T*>(a.g_scale);
    for (long long row = warp; row < a.w_dst; row += n_warps) {  // warp-uniform
      const int cnt = mean_row_count(a.mask, a.k, row, lane);
      const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
      for (int c = lane; c < a.F; c += 32)
        sc.scaled[row * a.F + c] = __fdiv_rn(Out::load(g + row * a.F + c), denom);
    }
  }
  if (a.small) {
    if constexpr (kScale) grid.sync();
    src_small<In, Out>(a, reinterpret_cast<int32_t*>(src_smem));
    return;
  }

  // 0. counts, tile sums and list lengths zeroed
  for (long long i = tid; i < w_src; i += n_threads) sc.deg[i] = 0;
  for (long long i = tid; i < sc.n_tiles; i += n_threads) sc.tile_sums[i] = 0;
  if (tid < 2) sc.n_long[tid] = 0;
  grid.sync();

  // 1. count, and each count tile's sum: a warp adds its lanes of a tile at once
  for (long long q0 = warp * 32; q0 < a.n_lanes; q0 += n_warps * 32) {  // warp-uniform
    const long long q = q0 + lane;
    long long tile = -1;
    if (q < a.n_lanes && a.mask[q]) {
      const long long s = qt_clamp<long long>(a.cols[q], 0, w_src - 1);
      atomicAdd(sc.deg + s, 1);
      tile = s / kScanTile;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, tile);
    if (tile >= 0 && lane == __ffs(peers) - 1) atomicAdd(sc.tile_sums + tile, __popc(peers));
  }
  grid.sync();

  // 2. scan: a block a tile of counts, after the sum of the tiles before it
  for (long long t = blockIdx.x; t < sc.n_tiles; t += gridDim.x) {  // block-uniform
    int32_t part = 0;
    for (long long u = threadIdx.x; u < t; u += kSrcThreads) part += sc.tile_sums[u];
    int32_t before;
    qt_block_exclusive_scan(part, &before);
    const long long i = t * kScanTile + threadIdx.x;
    const int32_t v = i < w_src ? sc.deg[i] : 0;
    int32_t total;
    const int32_t at = before + qt_block_exclusive_scan(v, &total);
    if (i < w_src) {
      sc.offsets[i] = at;
      sc.deg[i] = at;  // the fill's cursor
      if (v > kSrcWarpSortMax) sc.order_long[atomicAdd(sc.n_long, 1)] = static_cast<int32_t>(i);
      if (v > kSrcLongRow) sc.sum_long[atomicAdd(sc.n_long + 1, 1)] = static_cast<int32_t>(i);
    }
    if (i == w_src - 1) sc.offsets[w_src] = at + v;
  }
  grid.sync();

  // 3. fill, in any order within a segment
  for (long long q = tid; q < a.n_lanes; q += n_threads) {
    if (a.mask[q]) {
      const long long s = qt_clamp<long long>(a.cols[q], 0, w_src - 1);
      sc.lanes[atomicAdd(sc.deg + s, 1)] = static_cast<int32_t>(q);
    }
  }
  grid.sync();

  // 4. order: the longest segments a block each, then the others a warp 32
  //    sources at a time
  const int32_t n_order_long = sc.n_long[0];
  for (int32_t b = blockIdx.x; b < n_order_long; b += gridDim.x) {  // block-uniform
    const int32_t s = sc.order_long[b];
    const int32_t base = sc.offsets[s];
    src_order_long(sc.lanes, sc.sorted, base, sc.offsets[s + 1] - base, a.div,
                   reinterpret_cast<uint32_t*>(src_smem), kSrcSmemBytes / 4);
  }
  src_order_short(sc.offsets, sc.lanes, sc.sorted, w_src, a.div, warp, n_warps,
                  reinterpret_cast<int32_t*>(src_smem) + (threadIdx.x >> 5) * kSrcWarpSortMax,
                  kSrcWarpSortMax, kSrcWarpSortMax);
  grid.sync();

  // 5. the ordered sums: a long row's column chunk a block, then the short
  //    rows a warp
  const int chunks = (a.F + kSrcCols - 1) / kSrcCols;
  const long long n_long_items = static_cast<long long>(sc.n_long[1]) * chunks;
  for (long long it = blockIdx.x; it < n_long_items; it += gridDim.x) {  // block-uniform
    const int32_t s = sc.sum_long[it / chunks];
    src_sum_long_row<In, Out>(a, sc.sorted, s, sc.offsets[s], sc.offsets[s + 1],
                              static_cast<int>(it % chunks), 1, src_smem,
                              kSrcSmemBytes / sizeof(float4));
  }
  src_sum_short<In, Out>(a, sc.offsets, sc.sorted, 0, w_src, warp, n_warps, kSrcLongRow);
}

// the one launch of the cols layout (K4b: kScale, In = float32 over the
// scaled rows; K14b: In = Out, the lanes' own rows)
template <typename In, typename Out, bool kScale>
static int src_backward(SrcArgs a, cudaStream_t st) {
  if (a.n_lanes > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const SrcArgs) = src_backward_kernel<In, Out, kScale>;
  static int blocks_per_sm[64] = {};  // per device, from the occupancy API
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSrcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSrcThreads,
                                                        kSrcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    blocks_per_sm[dev] = per_sm;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the rows' chunks need (kSrcSmallWork, or kSrcBlockWork,
  // a block), at most the co-resident grid; the small path when every lane
  // and a block's rows fit its shared memory
  const long long chunks = (a.F + kSrcCols - 1) / kSrcCols;
  const long long most = static_cast<long long>(blocks_per_sm[dev]) * sms;
  auto grid_for = [&](long long work) {
    const long long need = (a.w_src * chunks + work - 1) / work;
    return need < most ? (need > 0 ? need : 1) : most;
  };
  long long blocks = grid_for(kSrcSmallWork);
  a.small = a.n_lanes <= kSrcSmallLanes && (a.w_src + blocks - 1) / blocks <= kSrcSmallRows;
  if (!a.small) blocks = grid_for(kSrcBlockWork);
  // rows a warp of the sum takes: enough items for every warp, at most 32
  const long long rows = a.small ? (a.w_src + blocks - 1) / blocks : a.w_src;
  const long long per_warp = rows * chunks / ((a.small ? 1 : blocks) * kSrcWarps);
  a.rows_per_item = 1;
  while (a.rows_per_item < 32 && 2 * a.rows_per_item <= per_warp) a.rows_per_item <<= 1;
  const uintptr_t in_align = 4 * sizeof(typename In::T), out_align = 4 * sizeof(typename Out::T);
  const void* x = kScale ? static_cast<const void*>(a.sc.scaled) : a.x;
  a.x = x;
  a.vec4 = a.F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % in_align == 0 &&
           reinterpret_cast<uintptr_t>(a.gx) % out_align == 0;
  qt_count_launch();
  if (a.small && !kScale) {  // no grid barrier: a plain launch
    kernel<<<static_cast<unsigned>(blocks), kSrcThreads, kSrcSmemBytes, st>>>(a);
    return qt_launch_status();
  }
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kSrcThreads),
                                    params, kSrcSmemBytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  SrcArgs a{};
  a.g_scale = g;
  a.mask = m;
  a.cols = static_cast<const int32_t*>(cols);
  a.n_lanes = static_cast<long long>(w_dst) * k;
  a.w_src = w_src;
  a.w_dst = w_dst;
  a.k = k;
  a.F = D;
  a.div = k;
  a.gx = gx;
  a.sc = sc;
  return src_backward<QtF32, E, true>(a, st);
}

template <typename E>
static int gather_src_backward_any(const void* g, int F, const void* mask, const void* cols,
                                   int w_dst, int k, long long w_src, void* gx, void* scratch,
                                   long long scratch_bytes, cudaStream_t st) {
  const MeanBwdScratch sc = mean_bwd_scratch(static_cast<char*>(scratch), w_src, w_dst, k, 0);
  if (scratch == nullptr || scratch_bytes < sc.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  SrcArgs a{};
  a.x = g;
  a.mask = static_cast<const bool*>(mask);
  a.cols = static_cast<const int32_t*>(cols);
  a.n_lanes = static_cast<long long>(w_dst) * k;
  a.w_src = w_src;
  a.w_dst = w_dst;
  a.k = k;
  a.F = F;
  a.div = 1;
  a.gx = gx;
  a.sc = sc;
  return src_backward<E, E, false>(a, st);
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
// written once: 0.04-2.6 us at GCN's hops (15,360 to 901,120 lanes, 16,384
// to 1,081,344 sources), under one launch's 5 us. So a call is its
// launches, the dependent round trips each makes and, on the sampled hops,
// the hub sources: at GCN's layer 0 one source is named by 6,045 lanes,
// and atomics on one address serialize in its L2 slice. Tensor cores,
// wgmma and TMA do nothing for an integer count: the work is one launch,
// atomics and one pass over the lanes.
//
// Design: one cooperative launch of the co-resident grid a call (a block
// for each kCountBlockWork lanes or sources, up to the resident count); no
// memset, no scratch. Each thread loads its first four lanes and zeroes its
// part of the output while they arrive; one grid barrier; then it adds
// 1.0f for each of its valid lanes to their source with a float atomic. A
// block of at least kCountHashMinLanes lanes first merges its lanes'
// sources in an open-addressing table in shared memory (kCountHashProbes
// slots tried, a lane past them adds to the output at once), then adds
// each entry with one atomic, so a hub costs one atomic a block. Every
// partial and every sum is an integer of at most the lane count, exact in
// float32 up to 2^24 lanes, so the result is bit-equal to the plain
// version; above 2^24 lanes the atomics add integers into the output's own
// words and a second barrier converts them in place. Measured on the H100
// and dropped (scripts/torch_count_probe.py): the counts kept in a
// thread-block cluster's shared memory, each count in one block with its
// peers adding through distributed shared memory (GCN's layer 1: 0.068 ms,
// the remote atomics 0.058 of it), or a copy of all counts in each block
// summed through distributed shared memory (layer 2: 0.0110 ms against the
// grid's 0.0100). A launch that is refused (a grid that cannot be
// resident) returns its error; nothing falls back to another launch.

constexpr int kCountThreads = 1024;
constexpr int kCountBlockWork = 256;      // lanes or sources a block, at least, sizing the grid
constexpr int kCountHashSlots = 16384;    // a block's table, most: 128 KB of keys and counts
constexpr int kCountHashProbes = 1;       // slots a lane tries before it adds to the output
constexpr int kCountHashMinLanes = 4096;  // lanes a block needs before it takes a table
constexpr long long kCountFloatLanes = 1LL << 24;  // float atomics stay exact up to here

// the source a lane's col names, or -1 where it drops
__device__ __forceinline__ long long count_source(int32_t col, long long w_src) {
  const long long c = col < 0 ? col + w_src : col;
  return c >= 0 && c < w_src ? c : -1;
}

// a thread's unit of lanes: 4 (a 16-byte load of cols, a 4-byte load of the
// mask) when vec, else 1; an empty unit past the last
struct LaneUnit {
  int32_t c[4];
  uint32_t m;
};

__device__ __forceinline__ LaneUnit load_unit(const bool* __restrict__ mask,
                                              const int32_t* __restrict__ cols, bool vec,
                                              long long n_units, long long g) {
  LaneUnit u{{0, 0, 0, 0}, 0u};
  if (g >= n_units) return u;
  if (vec) {
    const int4 v = reinterpret_cast<const int4*>(cols)[g];
    u.c[0] = v.x, u.c[1] = v.y, u.c[2] = v.z, u.c[3] = v.w;
    u.m = reinterpret_cast<const uint32_t*>(mask)[g];
  } else {
    u.c[0] = cols[g];
    u.m = mask[g];
  }
  return u;
}

// add(s) for each valid lane of the unit whose col names source s
template <typename Add>
__device__ __forceinline__ void add_unit(const LaneUnit& u, long long w_src, Add add) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (((u.m >> (8 * j)) & 0xFFu) == 0) continue;
    const long long s = count_source(u.c[j], w_src);
    if (s >= 0) add(s);
  }
}

// the co-resident grid (cooperative launch): float atomics into the zeroed
// output, or, above kCountFloatLanes lanes, integers converted in place;
// hash_bits: log2 of a block's table slots (its keys, then its counts, in
// dynamic shared memory), 0 for no table. Thread t takes units t, t + n_t,
// ...; thread 0 also the < 4 lanes past the last whole unit.
__global__ void __launch_bounds__(kCountThreads)
    out_degree_kernel(const bool* __restrict__ mask, const int32_t* __restrict__ cols,
                      long long n_lanes, long long w_src, int vec, int hash_bits,
                      float* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ int32_t count_smem[];
  cg::grid_group grid = cg::this_grid();
  const int slots = hash_bits > 0 ? 1 << hash_bits : 0;
  int32_t* keys = count_smem;
  int32_t* vals = count_smem + slots;
  const long long tid = blockIdx.x * static_cast<long long>(kCountThreads) + threadIdx.x;
  const long long n_threads = static_cast<long long>(gridDim.x) * kCountThreads;
  const long long n_units = vec ? n_lanes / 4 : n_lanes;
  const bool as_float = n_lanes <= kCountFloatLanes;
  int32_t* words = reinterpret_cast<int32_t*>(out);
  // 1. zero the output (0.0f and integer 0 share their bits) and the table,
  //    this thread's first unit of lanes in flight meanwhile
  const LaneUnit first = load_unit(mask, cols, vec != 0, n_units, tid);
  for (long long i = tid; i < w_src; i += n_threads) out[i] = 0.0f;
  for (int i = threadIdx.x; i < slots; i += kCountThreads) keys[i] = -1, vals[i] = 0;
  grid.sync();
  // 2. the lanes, merged by source in the table where the block has one
  auto to_out = [&](long long s, int32_t v) {
    if (as_float)
      atomicAdd(out + s, static_cast<float>(v));
    else
      atomicAdd(words + s, v);
  };
  auto add = [&](long long s) {
    if (slots == 0) {  // no table
      to_out(s, 1);
      return;
    }
    const int32_t key = static_cast<int32_t>(s);
    unsigned h = (static_cast<unsigned>(key) * 0x9E3779B1u) >> (32 - hash_bits);
    for (int p = 0; p < kCountHashProbes; ++p, h = (h + 1) & (slots - 1)) {
      int32_t k = static_cast<volatile int32_t*>(keys)[h];
      if (k == -1) k = atomicCAS(keys + h, -1, key);
      if (k == -1 || k == key) {
        atomicAdd(vals + h, 1);
        return;
      }
    }
    to_out(s, 1);  // the table is crowded here: straight to the output
  };
  add_unit(first, w_src, add);
  for (long long g = tid + n_threads; g < n_units; g += n_threads)
    add_unit(load_unit(mask, cols, vec != 0, n_units, g), w_src, add);
  if (tid == 0) {
    for (long long q = vec ? n_units * 4 : n_lanes; q < n_lanes; ++q) {
      const long long s = count_source(cols[q], w_src);
      if (mask[q] && s >= 0) add(s);
    }
  }
  __syncthreads();
  // 3. the table's entries to the output, one atomic each
  for (int i = threadIdx.x; i < slots; i += kCountThreads)
    if (keys[i] >= 0) to_out(keys[i], vals[i]);
  if (as_float) return;
  grid.sync();
  // 4. the integer counts to float32, in place
  for (long long i = tid; i < w_src; i += n_threads)
    words[i] = __float_as_int(static_cast<float>(words[i]));
}

// the launch plan of one call: blocks of the grid and log2 of a block's
// table slots (0: no table); the grid's size needs the device
static int out_degree_plan(long long n_lanes, long long w_src, long long* blocks,
                           int* hash_bits) {
  static int per_sm_of[64] = {};  // per device, from the occupancy API
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm_of[dev] == 0) {
    const int most_smem = 2 * kCountHashSlots * static_cast<int>(sizeof(int32_t));
    err = cudaFuncSetAttribute(out_degree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, out_degree_kernel,
                                                        kCountThreads, most_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    per_sm_of[dev] = per_sm;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(per_sm_of[dev]) * sms;
  const long long work = n_lanes > w_src ? n_lanes : w_src;
  const long long need = (work + kCountBlockWork - 1) / kCountBlockWork;
  *blocks = need < most ? need : most;
  // from kCountHashMinLanes lanes a block, a table of twice a block's
  // lanes, in powers of two from 32 up to kCountHashSlots
  const long long block_lanes = (n_lanes + *blocks - 1) / *blocks;
  int bits = 0;
  if (block_lanes >= kCountHashMinLanes)
    while (bits < 5 || ((1LL << bits) < kCountHashSlots && (1LL << bits) < 2 * block_lanes))
      ++bits;
  *hash_bits = bits;
  return 0;
}

// the grid's blocks and a block's table slots (0: none) of one call at
// (n_lanes, w_src) on the current device
QT_EXPORT int qt_block_out_degree_plan(long long n_lanes, long long w_src, long long* blocks,
                                       int* table_slots) {
  int bits = 0;
  const int err = out_degree_plan(n_lanes, w_src > 0 ? w_src : 1, blocks, &bits);
  *table_slots = bits > 0 ? 1 << bits : 0;
  return err;
}

// out: [w_src] float32 (w_src < 2^31); one kernel launch
QT_EXPORT int qt_block_out_degree(const void* mask, const void* cols, long long n_lanes,
                                  long long w_src, void* out, void* stream) {
  if (w_src <= 0) return 0;
  if (n_lanes < 0 || w_src > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0;
  int hash_bits = 0;
  if (int e = out_degree_plan(n_lanes, w_src, &blocks, &hash_bits)) return e;
  const auto* m = static_cast<const bool*>(mask);
  const auto* c = static_cast<const int32_t*>(cols);
  float* o = static_cast<float*>(out);
  int vec = reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const size_t smem = hash_bits > 0 ? sizeof(int32_t) << (hash_bits + 1) : 0;
  void* params[] = {&m, &c, &n_lanes, &w_src, &vec, &hash_bits, &o};
  qt_count_launch();
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(out_degree_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kCountThreads), params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
