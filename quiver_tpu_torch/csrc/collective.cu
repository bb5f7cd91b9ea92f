// The host axis's kernels: K13c (the grouped unpack) and K13d (the
// hot/cold gather's compaction and merge); and the serve exchange's owner
// gather, K13f.
//
// They replace the device work of quiver_tpu/parallel/collectives.py:65
// sharded_gather_grouped (and :117 sharded_gather_a2a, which delegates to
// it), :150 sharded_gather_hot_cold and parallel/topology.py:432/:461 (the
// grouped samplers, through :304 _grouped_collective_sample, whose int32
// neighbor and valid slabs K13c's unpack sums). The exchange itself
// (all_gather, all_to_all, all-reduce) is torch.distributed's, out of the
// kernels; the pack of a grouped gather is K13a (gather.cu) at the gathered
// width and the grouped draw is K13b (sample.cu). K13f replaces the owner
// gather between the two all_to_alls of quiver_tpu/comm.py:183
// _exchange_jit (whose :213 and :234 halves are collectives alone).
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "scan.cuh"

// -- K13c: the grouped unpack ----------------------------------------------------
//
// After the all-to-all of a grouped gather's [G, W, D] partial (or a grouped
// draw's [G, W, k] slabs), rank j holds the G slabs the group's ranks built
// for it; XLA's psum_scatter (tiled = False) gives it their sum. out[e] =
// slabs[0][e] + ... + slabs[G-1][e], in group order: floats in float32
// (QtF32 / QtBF16 of common.cuh: bfloat16 widened, rounded once to nearest
// even), int8 and int32 in 32-bit two's complement narrowed to the type. On
// the grouped gather every element has at most one nonzero contributor, so
// the sum is exact and a -0.0 owner plus the others' +0.0 gives +0.0.
//
// Bound on the card: bytes — G * W * D elements read, W * D written. Design:
// elementwise; floats four elements a thread through load4/store4, integers
// 16 bytes a thread (4 int32, 16 int8), when the element count and both
// pointers allow it, one element a thread otherwise.

// float32 or bfloat16 (E = QtF32 or QtBF16), four elements a thread
template <typename E>
__global__ void grouped_unpack_float4_kernel(const typename E::T* __restrict__ slabs, int G,
                                             long long n, typename E::T* __restrict__ out) {
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = E::load4(slabs + i);
  for (int g = 1; g < G; ++g) {
    const float4 x = E::load4(slabs + g * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  E::store4(out + i, acc);
}

// float32 or bfloat16, one element a thread
template <typename E>
__global__ void grouped_unpack_float_kernel(const typename E::T* __restrict__ slabs, int G,
                                            long long n, typename E::T* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float acc = E::load(slabs + i);
  for (int g = 1; g < G; ++g) acc += E::load(slabs + g * n + i);
  E::store(out + i, acc);
}

// N int8 or int32 elements a thread, summed with 32-bit wraparound
template <typename T, int N>
struct alignas(sizeof(T) * N) IntPack {
  T v[N];
};

template <typename T, int N>
__global__ void grouped_unpack_int_kernel(const T* __restrict__ slabs, int G, long long n,
                                          T* __restrict__ out) {
  using P = IntPack<T, N>;
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) * N;
  if (i >= n) return;
  uint32_t acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0u;
  for (int g = 0; g < G; ++g) {
    const P x = *reinterpret_cast<const P*>(slabs + g * n + i);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += static_cast<uint32_t>(static_cast<int32_t>(x.v[k]));
  }
  P o;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = static_cast<T>(static_cast<std::make_unsigned_t<T>>(acc[k]));
  *reinterpret_cast<P*>(out + i) = o;
}

static bool qt_aligned(const void* a, const void* b, int bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes == 0 && reinterpret_cast<uintptr_t>(b) % bytes == 0;
}

template <typename E>
static void launch_unpack_float(const void* slabs, int G, long long n, void* out,
                                cudaStream_t s) {
  using T = typename E::T;
  const int threads = 256;
  const auto* in = static_cast<const T*>(slabs);
  auto* o = static_cast<T*>(out);
  if (n % 4 == 0 && qt_aligned(slabs, out, 4 * sizeof(T))) {
    qt_count_launch();
    grouped_unpack_float4_kernel<E><<<qt_blocks(n / 4, threads), threads, 0, s>>>(in, G, n, o);
  } else {
    qt_count_launch();
    grouped_unpack_float_kernel<E><<<qt_blocks(n, threads), threads, 0, s>>>(in, G, n, o);
  }
}

template <typename T>
static void launch_unpack_int(const void* slabs, int G, long long n, void* out, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int threads = 256;
  const auto* in = static_cast<const T*>(slabs);
  auto* o = static_cast<T*>(out);
  if (n % kVec == 0 && qt_aligned(slabs, out, 16)) {
    qt_count_launch();
    grouped_unpack_int_kernel<T, kVec><<<qt_blocks(n / kVec, threads), threads, 0, s>>>(
        in, G, n, o);
  } else {
    qt_count_launch();
    grouped_unpack_int_kernel<T, 1><<<qt_blocks(n, threads), threads, 0, s>>>(in, G, n, o);
  }
}

// slabs: [G, n] elements of type code (0 float32, 1 bfloat16, 2 int8, 3
// int32); out: [n]
QT_EXPORT int qt_grouped_unpack(const void* slabs, int G, long long n, int code, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: launch_unpack_float<QtF32>(slabs, G, n, out, s); break;
    case 1: launch_unpack_float<QtBF16>(slabs, G, n, out, s); break;
    case 2: launch_unpack_int<int8_t>(slabs, G, n, out, s); break;
    case 3: launch_unpack_int<int32_t>(slabs, G, n, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return qt_launch_status();
}

// -- K13d: the hot/cold compaction ----------------------------------------------------
//
// collectives.py:150 takes the stable argsort of the cold flag (ids in
// [lo, hi)) and keeps its first `budget` lanes: sel lists the cold lanes in
// lane order, then the other lanes in lane order; cold_local[j] is
// ids[sel[j]] - lo on the first n_cold lanes and -1 after them. A lane's
// place in that order is its count of cold lanes before it (a cold lane)
// or n_cold plus its count of other lanes before it (the rest). Writes
// sel, cold_local and counts = (n_cold, max(n_cold - budget, 0)).
//
// Bound on the card: bytes — W ids read, budget lanes of sel and
// cold_local written (0.5-2.6 us at the hot/cold leg's widths), under the
// cost of a launch. Where the budget passes n_cold, as it does on that leg,
// the other lanes are written too, and their places need the global n_cold
// before any can be placed: a single-pass decoupled look-back (CUB's
// select) places only the cold ones, so the design takes a grid barrier.
//
// Design: one cooperative launch of the co-resident grid (blocks of
// kScanTile threads, the grid sized by the occupancy API). Each block takes
// a contiguous run of lanes, keeps its first kCompactSmemLanes ids in shared
// memory as it reads them, counts its cold lanes (warp sums) and publishes
// the count; one grid barrier; each block then reads every block's count
// (a few hundred ints, from L2; warp sums) for its own prefix and n_cold,
// and fills its lanes in lane order from shared memory, a thread a lane of
// each 1,024-lane tile (coalesced writes) and one scan of warp ballots a
// pass of up to eight tiles, so the ids cross HBM once. A run longer than kCompactSmemLanes
// (W past one pass of the resident grid) reads the rest again from device
// memory. Rank threads that share a card launch it on their own streams at
// once: a cooperative launch starts only when all of its blocks can be
// resident, each sizes its grid alone and none waits on another's blocks,
// so overlapping calls queue and do not deadlock (held by a card test
// that runs it from four threads, and by the hot/cold leg's rank threads).

constexpr int kCompactSmemLanes = 8192;  // ids a block keeps in shared memory (32 KB)
constexpr int kCompactUnroll = 8;        // loads a thread issues at once; tiles a fill pass, most

__device__ __forceinline__ int qt_is_cold(int32_t id, long long lo, long long hi) {
  const long long v = id;
  return v >= lo && v < hi;
}

__global__ void __launch_bounds__(kScanTile)
    cold_compact_kernel(const int32_t* __restrict__ ids, long long W, long long lo,
                        long long hi, long long budget, long long run,
                        int32_t* __restrict__ block_counts, int32_t* __restrict__ counts,
                        int32_t* __restrict__ sel, int32_t* __restrict__ cold_local) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) int32_t s_ids[kCompactSmemLanes];
  __shared__ int32_t s_sum[3];  // this run's cold lanes; those of the runs before; all
  cg::grid_group grid = cg::this_grid();
  const long long begin = blockIdx.x * run < W ? blockIdx.x * run : W;
  const long long end = begin + run < W ? begin + run : W;
  // 1. read the run once, keep its head in shared memory, count its cold lanes
  if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
  __syncthreads();
  int cold = 0;
  for (long long q0 = begin + threadIdx.x; q0 < end; q0 += kCompactUnroll * kScanTile) {
    int32_t id[kCompactUnroll];
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      const long long q = q0 + u * kScanTile;
      id[u] = q < end ? ids[q] : 0;
    }
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      const long long q = q0 + u * kScanTile;
      if (q >= end) break;
      if (q - begin < kCompactSmemLanes) s_ids[q - begin] = id[u];
      cold += qt_is_cold(id[u], lo, hi);
    }
  }
  cold = __reduce_add_sync(0xFFFFFFFFu, cold);
  if ((threadIdx.x & 31) == 0 && cold) atomicAdd(s_sum, cold);
  __syncthreads();
  if (threadIdx.x == 0) block_counts[blockIdx.x] = s_sum[0];
  grid.sync();
  // 2. the cold lanes of the runs before this one, and n_cold
  int before = 0, all = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kScanTile) {
    const int32_t v = block_counts[b];
    all += v;
    if (b < blockIdx.x) before += v;
  }
  before = __reduce_add_sync(0xFFFFFFFFu, before);
  all = __reduce_add_sync(0xFFFFFFFFu, all);
  if ((threadIdx.x & 31) == 0) {
    if (before) atomicAdd(s_sum + 1, before);
    if (all) atomicAdd(s_sum + 2, all);
  }
  __syncthreads();
  int32_t carry = s_sum[1];
  const long long n_cold = s_sum[2];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = static_cast<int32_t>(n_cold);
    counts[1] = static_cast<int32_t>(n_cold > budget ? n_cold - budget : 0);
  }
  // 3. fill in lane order, a pass of `tiles` tiles of kScanTile lanes at a
  //    time (the run's, up to kCompactUnroll), a thread a lane of each tile
  //    (coalesced writes): a lane's place among the pass's cold lanes from
  //    its warp's ballot and the exclusive scan of the (tile, warp) counts,
  //    which warp 0 takes
  __shared__ int32_t s_warp[kCompactUnroll * 32 + 1];  // then the pass's total
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long run_tiles = (end - begin + kScanTile - 1) / kScanTile;
  const int tiles = run_tiles < kCompactUnroll ? static_cast<int>(run_tiles) : kCompactUnroll;
  for (long long t = begin; t < end; t += tiles * kScanTile) {  // block-uniform
    int32_t id[kCompactUnroll];
    unsigned bits[kCompactUnroll];
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      if (u >= tiles) break;
      const long long q = t + u * kScanTile + threadIdx.x;
      id[u] = 0;
      if (q < end) id[u] = q - begin < kCompactSmemLanes ? s_ids[q - begin] : ids[q];
      bits[u] = __ballot_sync(0xFFFFFFFFu, q < end && qt_is_cold(id[u], lo, hi));
      if (lane == 0) s_warp[u * 32 + warp] = __popc(bits[u]);
    }
    __syncthreads();
    if (warp == 0) {
      int32_t v[kCompactUnroll], mine = 0;
#pragma unroll
      for (int u = 0; u < kCompactUnroll; ++u) {
        if (u >= tiles) break;
        mine += v[u] = s_warp[lane * tiles + u];
      }
      int32_t x = mine;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
      }
      int32_t at = x - mine;
#pragma unroll
      for (int u = 0; u < kCompactUnroll; ++u) {
        if (u >= tiles) break;
        s_warp[lane * tiles + u] = at;
        at += v[u];
      }
      if (lane == 31) s_warp[kCompactUnroll * 32] = x;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      const long long q = t + u * kScanTile + threadIdx.x;
      if (u >= tiles || q >= end) break;
      const bool c = (bits[u] >> lane) & 1u;
      const long long cold_before =
          carry + s_warp[u * 32 + warp] + __popc(bits[u] & ((1u << lane) - 1u));
      const long long pos = c ? cold_before : n_cold + (q - cold_before);
      if (pos < budget) {
        sel[pos] = static_cast<int32_t>(q);
        cold_local[pos] = c ? static_cast<int32_t>(id[u] - lo) : -1;
      }
    }
    carry += s_warp[kCompactUnroll * 32];
    __syncthreads();  // s_warp is the next pass's
  }
}

// int32 elements of scratch qt_cold_compact takes at W lanes: one count a
// block, at most one block a tile
QT_EXPORT int qt_cold_compact_scratch(long long W, long long* n_ints) {
  *n_ints = W > 0 ? (W + kScanTile - 1) / kScanTile : 0;
  return 0;
}

// ids: [W] int32; sel, cold_local: [budget] int32; counts: [2] int32;
// scratch: qt_cold_compact_scratch(W) int32; one kernel launch
QT_EXPORT int qt_cold_compact(const void* ids, long long W, long long lo, long long hi,
                              long long budget, void* sel, void* cold_local, void* counts,
                              void* scratch, void* stream) {
  if (W <= 0) return 0;
  if (budget < 0 || budget > W || W > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int blocks_per_sm[64] = {};  // per device, from the occupancy API
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks_per_sm[dev] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cold_compact_kernel, kScanTile,
                                                        0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    blocks_per_sm[dev] = per_sm;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (W + kScanTile - 1) / kScanTile;
  const long long most = static_cast<long long>(blocks_per_sm[dev]) * sms;
  const long long blocks = n_tiles < most ? n_tiles : most;
  long long run = (W + blocks - 1) / blocks;
  const auto* id = static_cast<const int32_t*>(ids);
  auto* tiles = static_cast<int32_t*>(scratch);
  auto* cnt = static_cast<int32_t*>(counts);
  auto* s = static_cast<int32_t*>(sel);
  auto* cl = static_cast<int32_t*>(cold_local);
  void* params[] = {&id, &W, &lo, &hi, &budget, &run, &tiles, &cnt, &s, &cl};
  qt_count_launch();
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cold_compact_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kScanTile), params,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return qt_launch_status();
}

// -- K13d: the merge ------------------------------------------------------------------
//
// collectives.py:221 out = hot.at[sel].add(where(lane_ok, cold, 0)): for each
// budget lane j, row sel[j] of the hot rows gains cold row j when j <
// n_cold and a zero row otherwise (the add happens either way: a -0.0 hot
// element becomes +0.0, as in the reference). sel holds distinct lanes, so
// rows never collide and no atomics are needed. In place on hot; float32,
// or bfloat16 added in float32 and rounded once.
//
// Bound on the card: bytes — budget lanes of sel, the cold rows read, the
// selected hot rows read and written. Design: a warp a budget lane, its
// lanes striding the row.
template <typename E>
__global__ void cold_merge_kernel(typename E::T* __restrict__ hot, int D,
                                  const int32_t* __restrict__ sel,
                                  const typename E::T* __restrict__ cold,
                                  const int32_t* __restrict__ counts, long long budget) {
  const long long j = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= budget) return;
  const bool ok = j < counts[0];
  typename E::T* dst = hot + static_cast<long long>(sel[j]) * D;
  const typename E::T* src = cold + j * D;
  for (int c = lane; c < D; c += 32)
    E::store(dst + c, E::load(dst + c) + (ok ? E::load(src + c) : 0.0f));
}

// hot: [W, D] (in place); sel: [budget] int32 distinct lanes; cold: [budget,
// D]; counts[0] = n_cold; bf16 != 0 for bfloat16 rows
QT_EXPORT int qt_cold_merge(void* hot, int D, const void* sel, const void* cold,
                            const void* counts, long long budget, int bf16, void* stream) {
  if (budget <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 budget lanes a block
  const auto* sl = static_cast<const int32_t*>(sel);
  const auto* cn = static_cast<const int32_t*>(counts);
  if (bf16) {
    qt_count_launch();
    cold_merge_kernel<QtBF16><<<qt_blocks(budget * 32, threads), threads, 0, s>>>(
        static_cast<uint16_t*>(hot), D, sl, static_cast<const uint16_t*>(cold), cn, budget);
  } else {
    qt_count_launch();
    cold_merge_kernel<QtF32><<<qt_blocks(budget * 32, threads), threads, 0, s>>>(
        static_cast<float*>(hot), D, sl, static_cast<const float*>(cold), cn, budget);
  }
  return qt_launch_status();
}

// -- K13f: the serve exchange's owner gather --------------------------------------
//
// After the id all_to_all, an owner holds the [H, L] owner-local row ids its
// H requesters asked of it (-1 pads). out[r] = table[min(ids[r], R - 1)] where
// ids[r] >= 0, else a zero row: _exchange_jit's where(id >= 0, take(table,
// clip(id, 0, R - 1)), 0). Unlike K13a (sharded_rows), an id past the block
// CLAMPS to its last row (the stacked blocks are zero-padded to the largest,
// so an id past a smaller host's rows reads a zero pad row or its last row,
// as JAX does); only negative ids give zeros. The clamp is in the kernel.
//
// Bound on the card: bytes — the ids read, each valid lane's row read and
// the [n, D] rows written once. Design: a warp a lane (K3's shape), 16 bytes
// a thread where D % 4 == 0 and both pointers are 16-byte aligned, else one
// float a thread; a negative lane writes its zero row without reading the
// table. Rows are copied as 32-bit words, so the copy is bit-equal.
template <typename T>
__global__ void exchange_rows_kernel(const T* __restrict__ table, long long R, long long n_vec,
                                     const int32_t* __restrict__ ids, long long n_ids,
                                     T* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_ids) return;
  const long long id = ids[row];
  const T* src = id >= 0 && R > 0 ? table + (id < R ? id : R - 1) * n_vec : nullptr;
  T* dst = out + row * n_vec;
  for (long long c = lane; c < n_vec; c += 32) dst[c] = src != nullptr ? src[c] : T{};
}

// table: [R, D] float32 (one owner's block); ids: [n_ids] int32 (-1 pads);
// out: [n_ids, D] float32
QT_EXPORT int qt_exchange_rows(const void* table, long long R, int D, const void* ids,
                               long long n_ids, void* out, void* stream) {
  if (n_ids <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 lanes a block
  const unsigned blocks = qt_blocks(n_ids * 32, threads);
  const auto* id = static_cast<const int32_t*>(ids);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    qt_count_launch();
    exchange_rows_kernel<uint4><<<blocks, threads, 0, s>>>(
        static_cast<const uint4*>(table), R, D / 4, id, n_ids, static_cast<uint4*>(out));
  } else {
    qt_count_launch();
    exchange_rows_kernel<uint32_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(table), R, D, id, n_ids, static_cast<uint32_t*>(out));
  }
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
