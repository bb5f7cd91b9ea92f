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
// ids[sel[j]] - lo on the first n_cold lanes and -1 after them. Here: one
// count, scan and fill over the W lanes (aggregate.cu's K14b shape). A
// lane's place in that order is its count of cold lanes before it (cold
// lanes) or n_cold plus its count of other lanes before it (the rest).
// Writes sel, cold_local and counts = (n_cold, max(n_cold - budget, 0)).
//
// Bound on the card: bytes — W ids read, budget lanes of sel and cold_local
// written. Design: a block of kScanTile lanes counts its cold lanes, one
// block scans the tile counts, then each block scans its flags again and
// writes the lanes that land inside the budget.

__device__ __forceinline__ int qt_is_cold(int32_t id, long long lo, long long hi) {
  const long long v = id;
  return v >= lo && v < hi;
}

__global__ void cold_count_kernel(const int32_t* __restrict__ ids, long long W, long long lo,
                                  long long hi, int32_t* __restrict__ tile_counts) {
  const long long lane = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  const int cold = lane < W ? qt_is_cold(ids[lane], lo, hi) : 0;
  const int n = __syncthreads_count(cold);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = n;
}

__global__ void cold_fill_kernel(const int32_t* __restrict__ ids, long long W, long long lo,
                                 long long hi, long long budget,
                                 const int32_t* __restrict__ tile_offsets,
                                 int32_t* __restrict__ counts, int32_t* __restrict__ sel,
                                 int32_t* __restrict__ cold_local) {
  const long long lane = blockIdx.x * static_cast<long long>(kScanTile) + threadIdx.x;
  const int cold = lane < W ? qt_is_cold(ids[lane], lo, hi) : 0;
  int32_t tile_total;
  const long long before = tile_offsets[blockIdx.x] + qt_block_exclusive_scan(cold, &tile_total);
  const long long n_cold = counts[0];
  if (lane == 0) counts[1] = static_cast<int32_t>(n_cold > budget ? n_cold - budget : 0);
  if (lane >= W) return;
  const long long pos = cold ? before : n_cold + (lane - before);
  if (pos < budget) {
    sel[pos] = static_cast<int32_t>(lane);
    cold_local[pos] = cold ? static_cast<int32_t>(ids[lane] - lo) : -1;
  }
}

// int32 elements of scratch qt_cold_compact takes at W lanes: one count a tile
QT_EXPORT int qt_cold_compact_scratch(long long W, long long* n_ints) {
  *n_ints = W > 0 ? (W + kScanTile - 1) / kScanTile : 0;
  return 0;
}

// ids: [W] int32; sel, cold_local: [budget] int32; counts: [2] int32;
// scratch: qt_cold_compact_scratch(W) int32
QT_EXPORT int qt_cold_compact(const void* ids, long long W, long long lo, long long hi,
                              long long budget, void* sel, void* cold_local, void* counts,
                              void* scratch, void* stream) {
  if (W <= 0) return 0;
  if (budget < 0 || budget > W) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (W + kScanTile - 1) / kScanTile;
  const auto* id = static_cast<const int32_t*>(ids);
  auto* tiles = static_cast<int32_t*>(scratch);
  auto* cnt = static_cast<int32_t*>(counts);
  qt_count_launch();
  cold_count_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, s>>>(id, W, lo, hi, tiles);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  qt_tile_offsets_kernel<<<1, kScanTile, 0, s>>>(tiles, n_tiles, cnt);
  if (int e = qt_launch_status()) return e;
  qt_count_launch();
  cold_fill_kernel<<<static_cast<unsigned>(n_tiles), kScanTile, 0, s>>>(
      id, W, lo, hi, budget, tiles, cnt, static_cast<int32_t*>(sel),
      static_cast<int32_t*>(cold_local));
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
