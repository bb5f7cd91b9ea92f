// K1 / K1b: one-hop uniform neighbor sampling without replacement.
//
// Replaces quiver_tpu/ops/sample.py:tiled_sample_layer (with
// _tiled_bd_lookup, _tiled_resolve, fisher_yates_positions and the
// jax.random.uniform draw) and its draw-identical flat twin sample_layer
// (with row_windows). One source, two fetch paths: TiledFetch reads
// tiles[clip(base + (pos >> 7)), pos & 127], FlatFetch reads
// indices[clip(ptr + pos)].
//
// The draw. For row b and step i < k the JAX scan takes the threefry uniform
// u_i of the [k, W] draw at flat counter i*W + b (so W must be the padded
// width the JAX pipeline uses) and
//   j_i = min(i + trunc(u_i * max(deg - i, 1)), max(deg - 1, 0))
// (one rounded float multiply, no contraction), then swaps entries i and j_i
// of the row's position array A (A[p] = p at first; the JAX package keeps it
// as a k-entry head and a k-entry tail override table, the first matching
// tail slot winning) and emits pos_i = A[j_i], read before the swap. Rows
// with deg <= k copy positions 0..k-1; valid = i < min(deg, k). Invalid
// seeds have deg 0. Outputs are bit-equal to the plain torch version and to
// the JAX package. K1 and K1b also read the two key words from device
// memory (the _dk entry points, a template flag on the one body), so that a
// captured serve step replays with each flush's keys; the draw is the same.
// K1's device-graph form (qt_sample_tiled_dg, a second flag) reads the bd
// and tiles addresses from two words in device memory as well: a serve step
// captured once replays against whichever committed epoch of a streaming
// graph its flush sealed, the words staged beside the keys.
//
// Bound on the card: bytes at the batch widths (each row reads its (base,
// deg) pair and k neighbor ids scattered over the graph, and writes k ids
// and k flags), the threefry arithmetic (about 75 integer operations a
// uniform) below them. At a serving flush's widths (64 to 11,264 rows) the
// card is nearly empty and a call costs one row's latency.
//
// Design. j_i depends on i, u_i and deg alone, not on the tables, and A
// after steps 0..i-1 is the composition of their swaps, so
//   pos_i = tau_0(tau_1(... tau_{i-1}(j_i))),  tau_s = the swap of s and j_s.
// A team of lanes draws a row: kt = min(k, 32) lanes, 32 / kt rows a warp
// (k <= 32), or one warp a row holding ceil(k / 32) steps a lane (k > 32).
// Lane t takes the uniforms and j of its steps i = q * kt + t at once, so a
// row pays one threefry latency (k / 32 of them above 32), not k. Then
// every lane walks the earlier steps backward, newest first, each j_s read
// from the lane that drew it by a warp shuffle, and applies tau_s to its
// own entries: k - 1 shuffles a row and no tables, in place of the JAX
// scan's k dependent steps with a k-slot tail lookup each (O(k^2) for one
// thread). Every lane then fetches its own neighbors, all of a row's reads
// in flight at once, and a warp's consecutive rows write consecutive words.
// One launch a call for every k up to QT_SAMPLE_KMAX.
//
// K13b: the owner-masked draw of a row-sharded graph. Replaces
// quiver_tpu/parallel/topology.py:_sample_layer_partial and
// _tiled_sample_layer_partial, the per-shard halves of sharded_sample_layer
// (:339) and tiled_sharded_sample_layer (:411), and the draw of the grouped
// hop (K13e, :304 _grouped_collective_sample): the shard holds the CSR block
// of global rows [start, end) (a local indptr or (base, deg) table and its
// edges or tiles). A frontier row it owns (valid and start <= id < end)
// draws through local row id - start; every other row reads degree 0. The
// draw is K1's, unchanged (same counters, same key), so the owner's lanes
// equal the unsharded draw bit for bit. Invalid lanes write neighbor 0 and
// valid is written as int32: the caller sums the shards' partials, and with
// one owner a row the sum is the whole draw. Rows are written in groups of
// group_w: row b to out + (b / group_w) * group_stride + (b % group_w) * k
// (and its flags likewise from out_valid), so the grouped hop writes the
// stacked [G, 2, w, k] slab its one collective sum takes (out_valid = out +
// w * k, group_stride = 2 * w * k); K1 writes [W, k] and [W, k].

#include "common.cuh"
#include "fetch.cuh"
#include "threefry.cuh"

#define QT_SAMPLE_KMAX 512    // steps a lane: QT_SAMPLE_KMAX / 32 registers of j and pos
#define QT_SAMPLE_THREADS 128

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

// Q: steps a lane (1 for k <= 32; a power of two >= k / 32 above).
// kDevKey: the hop's key words are read from key_words[0..1] in device
// memory (the form a captured CUDA graph replays with new keys), else they
// are key0 and key1, passed by value. kDevGraph: the fetch's table
// addresses are read from graph_words (TiledFetch::bind).
template <int Q, bool kDevKey, bool kDevGraph, class Fetch, class Rows>
__global__ void __launch_bounds__(QT_SAMPLE_THREADS)
    sample_kernel(Fetch g, Rows rows, int32_t n_nodes, const int32_t* __restrict__ seeds,
                  const bool* __restrict__ seed_valid, int32_t W, int32_t k, uint32_t key0,
                  uint32_t key1, const uint32_t* __restrict__ key_words,
                  const unsigned long long* __restrict__ graph_words, int32_t group_w,
                  long long group_stride, int32_t* __restrict__ out,
                  typename Rows::Valid* __restrict__ out_valid) {
  if (kDevKey) {
    key0 = key_words[0];
    key1 = key_words[1];
  }
  if constexpr (kDevGraph) g.bind(graph_words);
  const int lane = threadIdx.x & 31;
  const int kt = k < 32 ? k : 32;  // lanes a row
  const int per_warp = 32 / kt;    // rows a warp
  const int r = lane / kt;         // this lane's row in its warp
  const int t = lane - r * kt;     // its lane in the row's team
  const long long row =
      ((blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5) * per_warp + r;
  const bool live = r < per_warp && row < W;
  const int32_t b = live ? static_cast<int32_t>(row) : 0;
  const int team0 = (r < per_warp ? r : 0) * kt;  // the warp lane of the team's lane 0

  int32_t base = 0, deg = 0;
  if (live) {
    bool mine;
    g.row(rows.local(seeds[b], seed_valid[b], n_nodes, mine), base, deg);
    if (!mine) deg = 0;
  }
  const bool draws = deg > k;
  const int32_t lim = deg - 1 > 0 ? deg - 1 : 0;

  // j of this lane's steps (j = i where the row does not draw: tau_i is then
  // the identity), and their positions, traced back from j
  int32_t jr[Q], pos[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int32_t i = q * kt + t;
    int32_t j = i;
    if (draws && i < k) {
      const float u = qt_uniform(key0, key1, static_cast<uint64_t>(i) * W + b);
      const int32_t span = deg - i > 1 ? deg - i : 1;
      j = i + __float2int_rz(__fmul_rn(u, __int2float_rn(span)));
      j = j < lim ? j : lim;
    }
    jr[q] = j;
    pos[q] = j;
  }
  // steps s = c * kt + m, newest first; step s moves the entries i > s. Every
  // bound here is the same across the warp, so all its lanes shuffle together.
#pragma unroll
  for (int c = Q - 1; c >= 0; --c) {
    if (c * kt > k - 2) continue;  // no step of this chunk comes before an entry
    const int m_top = k - 2 - c * kt < kt - 1 ? k - 2 - c * kt : kt - 1;
#pragma unroll 4
    for (int m = m_top; m >= 0; --m) {
      const int32_t s = c * kt + m;
      const int32_t js = __shfl_sync(0xffffffffu, jr[c], team0 + m);
#pragma unroll
      for (int q = c; q < Q; ++q) {
        if (s < q * kt + t) pos[q] = pos[q] == s ? js : (pos[q] == js ? s : pos[q]);
      }
    }
  }
  if (!live) return;  // after the last shuffle

  const int32_t n_valid = deg < k ? deg : k;
  const long long row_out = static_cast<long long>(b / group_w) * group_stride +
                            static_cast<long long>(b % group_w) * k;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int32_t i = q * kt + t;
    if (i < k) {
      const bool v = i < n_valid;
      out[row_out + i] = Rows::kZeroInvalid && !v ? 0 : g.fetch(base, draws ? pos[q] : i);
      out_valid[row_out + i] = v;
    }
  }
}

template <int Q, bool kDevKey, bool kDevGraph, class Fetch, class Rows>
static int launch_q(Fetch g, Rows rows, int n_nodes, const int32_t* seeds, const bool* seed_valid,
                    int W, int k, unsigned key0, unsigned key1, const uint32_t* key_words,
                    const unsigned long long* graph_words, int group_w, long long group_stride,
                    int32_t* out, typename Rows::Valid* out_valid, cudaStream_t s) {
  const int kt = k < 32 ? k : 32;
  const long long warps = (W + 32 / kt - 1) / (32 / kt);
  qt_count_launch();
  sample_kernel<Q, kDevKey, kDevGraph, Fetch, Rows>
      <<<qt_blocks(warps * 32, QT_SAMPLE_THREADS), QT_SAMPLE_THREADS, 0, s>>>(
          g, rows, n_nodes, seeds, seed_valid, W, k, key0, key1, key_words, graph_words,
          group_w, group_stride, out, out_valid);
  return qt_launch_status();
}

template <bool kDevKey, bool kDevGraph = false, class Fetch, class Rows>
static int launch_sample(Fetch g, Rows rows, int n_nodes, const void* seeds,
                         const void* seed_valid, int W, int k, unsigned key0, unsigned key1,
                         const void* key_words, int group_w, long long group_stride, void* out,
                         void* out_valid, void* stream, const void* graph_words = nullptr) {
  if (W <= 0 || k <= 0) return 0;
  if (k > QT_SAMPLE_KMAX || group_w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto sd = static_cast<const int32_t*>(seeds);
  const auto sv = static_cast<const bool*>(seed_valid);
  const auto o = static_cast<int32_t*>(out);
  const auto ov = static_cast<typename Rows::Valid*>(out_valid);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto kw = static_cast<const uint32_t*>(key_words);
  const auto gw = static_cast<const unsigned long long*>(graph_words);
  if (kDevKey && kw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (kDevGraph && gw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int q = (k + 31) / 32;
#define QT_SAMPLE_LAUNCH(Q)                                                                  \
  launch_q<Q, kDevKey, kDevGraph>(g, rows, n_nodes, sd, sv, W, k, key0, key1, kw, gw, group_w, \
                                  group_stride, o, ov, s)
  if (q <= 1) return QT_SAMPLE_LAUNCH(1);
  if (q <= 2) return QT_SAMPLE_LAUNCH(2);
  if (q <= 4) return QT_SAMPLE_LAUNCH(4);
  if (q <= 8) return QT_SAMPLE_LAUNCH(8);
  return QT_SAMPLE_LAUNCH(QT_SAMPLE_KMAX / 32);
#undef QT_SAMPLE_LAUNCH
}

QT_EXPORT int qt_sample_tiled(const void* bd, const void* tiles, long long m_rows,
                              int n_nodes, const void* seeds, const void* seed_valid,
                              int W, int k, unsigned key0, unsigned key1, void* out,
                              void* out_valid, void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample<false>(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, key0, key1,
                              nullptr, W, 0, out, out_valid, stream);
}

QT_EXPORT int qt_sample_flat(const void* indptr, const void* indices, long long n_edges,
                             int n_nodes, const void* seeds, const void* seed_valid,
                             int W, int k, unsigned key0, unsigned key1, void* out,
                             void* out_valid, void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample<false>(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, key0, key1,
                              nullptr, W, 0, out, out_valid, stream);
}

// K1 and K1b with the hop's two key words read from device memory
// (key_words: uint32[2]) in place of key0 and key1: the same draw, the
// form a captured serve step replays.
QT_EXPORT int qt_sample_tiled_dk(const void* bd, const void* tiles, long long m_rows,
                                 int n_nodes, const void* seeds, const void* seed_valid,
                                 int W, int k, const void* key_words, void* out,
                                 void* out_valid, void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample<true>(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, 0, 0, key_words,
                             W, 0, out, out_valid, stream);
}

QT_EXPORT int qt_sample_flat_dk(const void* indptr, const void* indices, long long n_edges,
                                int n_nodes, const void* seeds, const void* seed_valid,
                                int W, int k, const void* key_words, void* out,
                                void* out_valid, void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample<true>(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, 0, 0, key_words,
                             W, 0, out, out_valid, stream);
}

// K1's device-graph form: graph_words (uint64[2] in device memory) hold the
// addresses of bd [n_nodes, 2] and tiles [m_rows, 128]; the key words as in
// the _dk form. The shapes are launch arguments: a same-shaped commit of a
// streaming graph changes only the addresses.
QT_EXPORT int qt_sample_tiled_dg(const void* graph_words, long long m_rows, int n_nodes,
                                 const void* seeds, const void* seed_valid, int W, int k,
                                 const void* key_words, void* out, void* out_valid,
                                 void* stream) {
  TiledFetch g{nullptr, nullptr, m_rows};
  return launch_sample<true, true>(g, AllRows{}, n_nodes, seeds, seed_valid, W, k, 0, 0,
                                   key_words, W, 0, out, out_valid, stream, graph_words);
}

// K13b over the tile layout: bd [n_rows, 2], tiles [m_rows, 128] of one
// shard's block of global rows [start, end); out_valid is int32; rows in
// groups of group_w, group_stride elements apart.
QT_EXPORT int qt_sharded_sample_tiled(const void* bd, const void* tiles, long long m_rows,
                                      int n_rows, long long start, long long end,
                                      const void* seeds, const void* seed_valid, int W, int k,
                                      unsigned key0, unsigned key1, int group_w,
                                      long long group_stride, void* out, void* out_valid,
                                      void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample<false>(g, OwnedRows{start, end}, n_rows, seeds, seed_valid, W, k, key0,
                              key1, nullptr, group_w, group_stride, out, out_valid, stream);
}

// K13b over the flat block: indptr [n_rows + 1] local offsets, indices
// [n_edges] of one shard's block of global rows [start, end).
QT_EXPORT int qt_sharded_sample_flat(const void* indptr, const void* indices, long long n_edges,
                                     int n_rows, long long start, long long end,
                                     const void* seeds, const void* seed_valid, int W, int k,
                                     unsigned key0, unsigned key1, int group_w,
                                     long long group_stride, void* out, void* out_valid,
                                     void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample<false>(g, OwnedRows{start, end}, n_rows, seeds, seed_valid, W, k, key0,
                              key1, nullptr, group_w, group_stride, out, out_valid, stream);
}

QT_DEFINE_ERROR_STRING
