// K1 / K1b: one-hop uniform neighbor sampling without replacement.
//
// Replaces quiver_tpu/ops/sample.py:tiled_sample_layer (with
// _tiled_bd_lookup, _tiled_resolve, fisher_yates_positions and the
// jax.random.uniform draw) and its draw-identical flat twin sample_layer
// (with row_windows). One source, two fetch paths: TiledFetch reads
// tiles[clip(base + (pos >> 7)), pos & 127], FlatFetch reads
// indices[clip(ptr + pos)].
//
// Per row b and step i the kernel computes the threefry uniform of the
// [k, W] draw at flat counter i*W + b (so W must be the padded width the
// JAX pipeline uses), then runs the same partial Fisher-Yates step as the
// JAX scan: span = max(deg - i, 1); j = i + trunc(u * span) (one rounded
// float multiply, no contraction); j = min(j, max(deg - 1, 0)); swap
// through a k-entry head table and a k-entry tail override table (the
// first matching tail slot wins). Rows with deg <= k copy positions
// 0..k-1; valid = i < min(deg, k). Invalid seeds have deg 0. Outputs are
// bit-equal to the plain torch version and to the JAX package.
//
// Bound on the card: bytes. Each row reads its (base, deg) pair and k
// neighbor ids scattered over the graph, and writes k ids and k flags;
// the threefry arithmetic (about 100 integer operations per uniform) is
// far below the bytes' time. Design: one thread per row keeps its three
// k-entry tables (head, tail positions, tail values) to itself, so the
// draw needs no synchronisation and the random reads of different rows
// are in flight at once across the warps of the card. For k <= 32 the
// tables are arrays in local memory (L1); for 32 < k <= 512 they live in
// dynamic shared memory, entry t of a thread's table q at
// [(q * k + t) * blockDim + thread] so a warp's 32 lookups of one entry
// fall in 32 banks, with as many threads a block (32 to 128) as fit in
// 48 KB, or 32 threads and the shared memory opted in above that.
//
// K13b: the owner-masked draw of a row-sharded graph. Replaces
// quiver_tpu/parallel/topology.py:_sample_layer_partial and
// _tiled_sample_layer_partial, the per-shard halves of sharded_sample_layer
// (:339) and tiled_sharded_sample_layer (:411): the shard holds the CSR
// block of global rows [start, end) (a local indptr or (base, deg) table and
// its edges or tiles). A frontier row it owns (valid and start <= id < end)
// draws through local row id - start; every other row reads degree 0. The
// draw is K1's, unchanged (same counters, same key), so the owner's lanes
// equal the unsharded draw bit for bit. Invalid lanes write neighbor 0 and
// valid is written as int32: the caller sums the shards' partials, and with
// one owner a row the sum is the whole draw. Same bound and design as K1.

#include "common.cuh"
#include "fetch.cuh"
#include "threefry.cuh"

#define QT_KMAX 32          // the local-memory tables
#define QT_SAMPLE_KMAX 512  // the shared-memory tables: 32 threads x 3 x 512 x 4 B = 192 KB
#define QT_SMEM_DEFAULT (48 * 1024)

struct LocalTables {
  int32_t h[QT_KMAX], tj[QT_KMAX], tv[QT_KMAX];
  __device__ __forceinline__ int32_t& head(int t) { return h[t]; }
  __device__ __forceinline__ int32_t& tail_j(int t) { return tj[t]; }
  __device__ __forceinline__ int32_t& tail_v(int t) { return tv[t]; }
};

struct SharedTables {
  int32_t* base;  // this thread's column of the block's tables
  int32_t stride;
  int32_t k;
  __device__ __forceinline__ int32_t& head(int t) { return base[t * stride]; }
  __device__ __forceinline__ int32_t& tail_j(int t) { return base[(k + t) * stride]; }
  __device__ __forceinline__ int32_t& tail_v(int t) { return base[(2 * k + t) * stride]; }
};

// The rows a launch may draw: every row (K1, K1b: node id clipped into the
// graph) or, for K13b, the block of global rows [start, end) of one shard.
struct AllRows {
  using Valid = bool;
  static constexpr bool kZeroInvalid = false;
  __device__ __forceinline__ int32_t local(int32_t id, bool valid, int32_t n_rows,
                                           bool& mine) const {
    mine = valid;
    return qt_clamp<int32_t>(id, 0, n_rows - 1);
  }
};

struct OwnedRows {
  using Valid = int32_t;
  static constexpr bool kZeroInvalid = true;  // neighbor 0 where invalid: partials sum
  long long start, end;
  __device__ __forceinline__ int32_t local(int32_t id, bool valid, int32_t n_rows,
                                           bool& mine) const {
    mine = valid && id >= start && id < end;
    return static_cast<int32_t>(qt_clamp<long long>(id - start, 0, n_rows - 1));
  }
};

template <class Fetch, class Tables, class Rows>
__device__ __forceinline__ void sample_row(const Fetch& g, Tables& tab, const Rows& rows,
                                           int32_t n_nodes, const int32_t* __restrict__ seeds,
                                           const bool* __restrict__ seed_valid, int32_t W,
                                           int32_t k, uint32_t key0, uint32_t key1,
                                           int32_t* __restrict__ out,
                                           typename Rows::Valid* __restrict__ out_valid,
                                           int32_t b) {
  bool mine;
  const int32_t s = rows.local(seeds[b], seed_valid[b], n_nodes, mine);
  int32_t base, deg;
  g.row(s, base, deg);
  if (!mine) deg = 0;

  for (int t = 0; t < k; ++t) {
    tab.head(t) = t;
    tab.tail_j(t) = -1;
    tab.tail_v(t) = 0;
  }
  int32_t cnt = 0;
  const int32_t lim = deg - 1 > 0 ? deg - 1 : 0;
  const int32_t n_valid = deg < k ? deg : k;
  const long long row_out = static_cast<long long>(b) * k;
  for (int32_t i = 0; i < k; ++i) {
    const float u = qt_uniform(key0, key1, static_cast<uint64_t>(i) * W + b);
    const int32_t span = deg - i > 1 ? deg - i : 1;
    int32_t j = i + __float2int_rz(__fmul_rn(u, __int2float_rn(span)));
    j = j < lim ? j : lim;
    const bool in_head = j < k;
    int32_t slot = -1;
    for (int t = 0; t < k; ++t) {
      if (slot < 0 && tab.tail_j(t) == j) slot = t;
    }
    const int32_t val_j = in_head ? tab.head(j) : (slot >= 0 ? tab.tail_v(slot) : j);
    const int32_t val_i = tab.head(i);
    if (in_head) tab.head(j) = val_i;
    tab.head(i) = val_j;
    if (!in_head) {
      const int32_t w = slot >= 0 ? slot : cnt;
      tab.tail_j(w) = j;
      tab.tail_v(w) = val_i;
      if (slot < 0) ++cnt;
    }
    const int32_t pos = deg <= k ? i : val_j;
    const bool v = i < n_valid;
    out[row_out + i] = Rows::kZeroInvalid && !v ? 0 : g.fetch(base, pos);
    out_valid[row_out + i] = v;
  }
}

template <class Fetch, class Rows>
__global__ void sample_kernel(Fetch g, Rows rows, int32_t n_nodes,
                              const int32_t* __restrict__ seeds,
                              const bool* __restrict__ seed_valid, int32_t W, int32_t k,
                              uint32_t key0, uint32_t key1, int32_t* __restrict__ out,
                              typename Rows::Valid* __restrict__ out_valid) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= W) return;
  LocalTables tab;
  sample_row(g, tab, rows, n_nodes, seeds, seed_valid, W, k, key0, key1, out, out_valid, b);
}

template <class Fetch, class Rows>
__global__ void sample_kernel_wide(Fetch g, Rows rows, int32_t n_nodes,
                                   const int32_t* __restrict__ seeds,
                                   const bool* __restrict__ seed_valid, int32_t W, int32_t k,
                                   uint32_t key0, uint32_t key1, int32_t* __restrict__ out,
                                   typename Rows::Valid* __restrict__ out_valid) {
  extern __shared__ int32_t qt_tables[];
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= W) return;  // no barrier below: each thread owns its column
  SharedTables tab{qt_tables + threadIdx.x, static_cast<int32_t>(blockDim.x), k};
  sample_row(g, tab, rows, n_nodes, seeds, seed_valid, W, k, key0, key1, out, out_valid, b);
}

template <class Fetch, class Rows>
static int launch_sample(Fetch g, Rows rows, int n_nodes, const void* seeds,
                         const void* seed_valid, int W, int k, unsigned key0, unsigned key1,
                         void* out, void* out_valid, void* stream) {
  if (W <= 0 || k <= 0) return 0;
  if (k > QT_SAMPLE_KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sd = static_cast<const int32_t*>(seeds);
  const auto sv = static_cast<const bool*>(seed_valid);
  const auto o = static_cast<int32_t*>(out);
  const auto ov = static_cast<typename Rows::Valid*>(out_valid);
  if (k <= QT_KMAX) {
    const int threads = 128;
    sample_kernel<Fetch, Rows><<<qt_blocks(W, threads), threads, 0, s>>>(
        g, rows, n_nodes, sd, sv, W, k, key0, key1, o, ov);
    return qt_launch_status();
  }
  const int per_thread = 3 * k * static_cast<int>(sizeof(int32_t));
  int threads = (QT_SMEM_DEFAULT / per_thread) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 128 ? 128 : threads);
  const int smem = threads * per_thread;
  if (smem > QT_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_kernel_wide<Fetch, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sample_kernel_wide<Fetch, Rows><<<qt_blocks(W, threads), threads, smem, s>>>(
      g, rows, n_nodes, sd, sv, W, k, key0, key1, o, ov);
  return qt_launch_status();
}

QT_EXPORT int qt_sample_tiled(const void* bd, const void* tiles, long long m_rows,
                              int n_nodes, const void* seeds, const void* seed_valid,
                              int W, int k, unsigned key0, unsigned key1, void* out,
                              void* out_valid, void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, key0, key1, out,
                       out_valid, stream);
}

QT_EXPORT int qt_sample_flat(const void* indptr, const void* indices, long long n_edges,
                             int n_nodes, const void* seeds, const void* seed_valid,
                             int W, int k, unsigned key0, unsigned key1, void* out,
                             void* out_valid, void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, key0, key1, out,
                       out_valid, stream);
}

// K13b over the tile layout: bd [n_rows, 2], tiles [m_rows, 128] of one
// shard's block of global rows [start, end); out_valid is int32.
QT_EXPORT int qt_sharded_sample_tiled(const void* bd, const void* tiles, long long m_rows,
                                      int n_rows, long long start, long long end,
                                      const void* seeds, const void* seed_valid, int W, int k,
                                      unsigned key0, unsigned key1, void* out, void* out_valid,
                                      void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample(g, OwnedRows{start, end}, n_rows, seeds, seed_valid, W, k, key0, key1,
                       out, out_valid, stream);
}

// K13b over the flat block: indptr [n_rows + 1] local offsets, indices
// [n_edges] of one shard's block of global rows [start, end).
QT_EXPORT int qt_sharded_sample_flat(const void* indptr, const void* indices, long long n_edges,
                                     int n_rows, long long start, long long end,
                                     const void* seeds, const void* seed_valid, int W, int k,
                                     unsigned key0, unsigned key1, void* out, void* out_valid,
                                     void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample(g, OwnedRows{start, end}, n_rows, seeds, seed_valid, W, k, key0, key1,
                       out, out_valid, stream);
}

QT_DEFINE_ERROR_STRING
