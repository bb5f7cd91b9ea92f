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
// k-entry tables in local memory (L1), so the draw needs no
// synchronisation and the random reads of different rows are in flight
// at once across the warps of the card.

#include "common.cuh"
#include "fetch.cuh"
#include "threefry.cuh"

#define QT_KMAX 32

template <class Fetch>
__global__ void sample_kernel(Fetch g, int32_t n_nodes, const int32_t* __restrict__ seeds,
                              const bool* __restrict__ seed_valid, int32_t W, int32_t k,
                              uint32_t key0, uint32_t key1, int32_t* __restrict__ out,
                              bool* __restrict__ out_valid) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= W) return;
  const int32_t s = qt_clamp<int32_t>(seeds[b], 0, n_nodes - 1);
  int32_t base, deg;
  g.row(s, base, deg);
  if (!seed_valid[b]) deg = 0;

  int32_t head[QT_KMAX], tail_j[QT_KMAX], tail_v[QT_KMAX];
  for (int t = 0; t < k; ++t) {
    head[t] = t;
    tail_j[t] = -1;
    tail_v[t] = 0;
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
      if (slot < 0 && tail_j[t] == j) slot = t;
    }
    const int32_t val_j = in_head ? head[j] : (slot >= 0 ? tail_v[slot] : j);
    const int32_t val_i = head[i];
    if (in_head) head[j] = val_i;
    head[i] = val_j;
    if (!in_head) {
      const int32_t w = slot >= 0 ? slot : cnt;
      tail_j[w] = j;
      tail_v[w] = val_i;
      if (slot < 0) ++cnt;
    }
    const int32_t pos = deg <= k ? i : val_j;
    out[row_out + i] = g.fetch(base, pos);
    out_valid[row_out + i] = i < n_valid;
  }
}

template <class Fetch>
static int launch_sample(Fetch g, int n_nodes, const void* seeds, const void* seed_valid,
                         int W, int k, unsigned key0, unsigned key1, void* out,
                         void* out_valid, void* stream) {
  if (W <= 0 || k <= 0) return 0;
  if (k > QT_KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  sample_kernel<Fetch><<<qt_blocks(W, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, n_nodes, static_cast<const int32_t*>(seeds), static_cast<const bool*>(seed_valid),
      W, k, key0, key1, static_cast<int32_t*>(out), static_cast<bool*>(out_valid));
  return qt_launch_status();
}

QT_EXPORT int qt_sample_tiled(const void* bd, const void* tiles, long long m_rows,
                              int n_nodes, const void* seeds, const void* seed_valid,
                              int W, int k, unsigned key0, unsigned key1, void* out,
                              void* out_valid, void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  return launch_sample(g, n_nodes, seeds, seed_valid, W, k, key0, key1, out, out_valid,
                       stream);
}

QT_EXPORT int qt_sample_flat(const void* indptr, const void* indices, long long n_edges,
                             int n_nodes, const void* seeds, const void* seed_valid,
                             int W, int k, unsigned key0, unsigned key1, void* out,
                             void* out_valid, void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  return launch_sample(g, n_nodes, seeds, seed_valid, W, k, key0, key1, out, out_valid,
                       stream);
}

QT_DEFINE_ERROR_STRING
