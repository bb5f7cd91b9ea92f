// K7 / K8 / K8w: weighted and temporal one-hop sampling without
// replacement by Gumbel top-k, and the recency weights.
//
// Replaces quiver_tpu/ops/sample.py:gumbel_topk_positions with
// weighted_sample_layer (flat window), tiled_weighted_sample_layer and
// _tiled_payload_window (K7), tiled_temporal_sample_layer with
// temporal_weight_rows and temporal_edge_weights (K8), and
// quiver_tpu/workloads/temporal.py:_recency_wtiles_jit (K8w).
//
// One body for K7 and K8, a template over a Fetch (fetch.cuh: a drawn
// position resolves through the tile layout or the flat CSR) and a
// Window (a lane's weight: flat weights at clip(ptr + j), weight tiles at
// clip(base + j/128), or timestamp tiles masked by ts <= t[row] (and
// ts > cutoff) and weighted by qt_recency_weight). Per row b, with
// deg = min(deg, max_deg) (0 for an invalid seed) and a Wwin-lane window
// (max_deg flat, ceil(max_deg/128)*128 tiled):
//   u_j = the threefry uniform at flat counter b * Wwin + j, minval 1e-20
//   score_j = log(max(w_j, 1e-30)) + -log(-log(u_j))   if j < deg, w_j > 0
//           = -inf                                      otherwise
// then the top k of (score desc, lane asc) -- lax.top_k's order, -inf
// lanes included -- and valid = r < min(deg, k) && score > -inf. Every
// log and exp is float64 rounded once to float32 (gumbel.cuh), so the
// outputs are bit-equal to the plain torch versions.
//
// Design: one warp a row. The warp writes each lane's order key to
// shared memory (1 to 4 rows a block, Wwin <= 4096), then runs k rounds
// of a warp arg-max over the keys, each lane scanning a 32-strided slice
// and a 5-step shuffle butterfly deciding ties by the lower lane; the
// winner's key becomes QT_KEY_TAKEN, and lane 0 writes the round's
// position and validity to the warp's k-entry array in shared memory, next
// to the keys. The k ids are then fetched 32 at a time. Lanes past max(deg,
// k) are never scanned: they are -inf and above every lane a round could
// still pick. Lanes past deg take no uniform and no logarithm. Any k <=
// Wwin.
//
// Bound on the card: bytes, on the data of a run -- each row's (base,
// degree) pair, its min(deg, max_deg) window weights or timestamps, the
// k ids read and the [W, k] ids and flags written -- against the float64
// logarithms (three a live lane) at the card's FP64 rate. A warp per row
// keeps a hub row's 512 lanes on 32 threads; a thread per row would
// serialise them.

#include "common.cuh"
#include "fetch.cuh"
#include "gumbel.cuh"

#define QT_MAX_WINDOW 4096

struct FlatWeights {
  const float* w;  // [E]
  long long n_edges;
  struct Row {
    const float* w;
    long long ptr, last;
    __device__ __forceinline__ float operator()(int32_t j) const {
      return w[qt_clamp<long long>(ptr + j, 0, last)];
    }
  };
  __device__ __forceinline__ Row row(int32_t b, int32_t ptr) const {
    return Row{w, ptr, n_edges - 1};
  }
};

struct TiledWeights {
  const float* wtiles;  // [M, 128], the tile map of the edge tiles
  long long m_rows;
  struct Row {
    const float* p;
    long long base, last;
    __device__ __forceinline__ float operator()(int32_t j) const {
      const long long r = qt_clamp<long long>(base + (j >> 7), 0, last);
      return p[r * 128 + (j & 127)];
    }
  };
  __device__ __forceinline__ Row row(int32_t b, int32_t base) const {
    return Row{wtiles, base, m_rows - 1};
  }
};

struct TemporalWeights {
  TiledWeights ts;  // timestamp tiles
  const float* t;   // [W] per-row query time
  float recency;
  int has_cutoff;
  float cutoff;
  struct Row {
    TiledWeights::Row ts;
    float t, recency, cutoff;
    int has_cutoff;
    __device__ __forceinline__ float operator()(int32_t j) const {
      const float x = ts(j);
      const bool keep = x <= t && (!has_cutoff || x > cutoff);
      return keep ? qt_recency_weight(x, recency) : 0.0f;
    }
  };
  __device__ __forceinline__ Row row(int32_t b, int32_t base) const {
    return Row{ts.row(b, base), t[b], recency, cutoff, has_cutoff};
  }
};

template <class Fetch, class Window>
__global__ void gumbel_sample_kernel(Fetch g, Window win, int32_t n_nodes,
                                     const int32_t* __restrict__ seeds,
                                     const bool* __restrict__ seed_valid, int32_t W, int32_t k,
                                     int32_t max_deg, int32_t wwin, uint32_t key0, uint32_t key1,
                                     int32_t* __restrict__ out, bool* __restrict__ out_valid) {
  extern __shared__ uint32_t qt_keys[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= W) return;  // the whole warp leaves together
  uint32_t* keys = qt_keys + static_cast<long long>(warp) * wwin;

  const int32_t s = qt_clamp<int32_t>(seeds[b], 0, n_nodes - 1);
  int32_t base, deg;
  g.row(s, base, deg);
  if (!seed_valid[b]) deg = 0;
  deg = deg < max_deg ? deg : max_deg;
  const int32_t span = deg > k ? (deg < wwin ? deg : wwin) : k;  // lanes a round scans
  const auto wrow = win.row(b, base);
  const uint64_t ctr0 = static_cast<uint64_t>(b) * static_cast<uint64_t>(wwin);
  for (int32_t j = lane; j < span; j += 32) {
    uint32_t key = QT_KEY_NEG_INF;
    if (j < deg) {
      const float w = fmaxf(wrow(j), 0.0f);
      if (w > 0.0f) {
        const float u = qt_gumbel_uniform(key0, key1, ctr0 + static_cast<uint64_t>(j));
        key = qt_score_key(qt_gumbel_score(w, u));
      }
    }
    keys[j] = key;
  }
  __syncwarp();

  // round r's winning position, or its complement where the lane is invalid
  int32_t* picks = reinterpret_cast<int32_t*>(qt_keys + (blockDim.x >> 5) * wwin) +
                   static_cast<long long>(warp) * k;
  const int32_t n_valid = deg < k ? deg : k;
  for (int32_t r = 0; r < k; ++r) {
    uint32_t best = QT_KEY_TAKEN;
    int32_t best_j = 0x7FFFFFFF;
    for (int32_t j = lane; j < span; j += 32) {
      const uint32_t v = keys[j];
      if (v > best) {  // j rises along a lane: the first of equal keys stays
        best = v;
        best_j = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t ov = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      const int32_t oj = __shfl_xor_sync(0xFFFFFFFFu, best_j, off);
      if (ov > best || (ov == best && oj < best_j)) {
        best = ov;
        best_j = oj;
      }
    }
    if (lane == 0) {
      keys[best_j] = QT_KEY_TAKEN;
      picks[r] = r < n_valid && best > QT_KEY_NEG_INF ? best_j : ~best_j;
    }
    __syncwarp();
  }
  for (int32_t r = lane; r < k; r += 32) {
    const int32_t p = picks[r];
    const long long o = static_cast<long long>(b) * k + r;
    out[o] = g.fetch(base, p >= 0 ? p : ~p);
    out_valid[o] = p >= 0;
  }
}

template <class Fetch, class Window>
static int launch_gumbel(Fetch g, Window win, int n_nodes, const void* seeds,
                         const void* seed_valid, int W, int k, int max_deg, int wwin,
                         unsigned key0, unsigned key1, void* out, void* out_valid, void* stream) {
  if (W <= 0 || k <= 0) return 0;
  if (k > wwin || max_deg < 1 || wwin > QT_MAX_WINDOW)
    return static_cast<int>(cudaErrorInvalidValue);
  // a row's Wwin keys and k picks; <= 48 KB a block (at most 32 KB for one)
  const int words = wwin + k;
  const int rows_per_block = words <= 3072 ? 4 : (words <= 6144 ? 2 : 1);
  const size_t smem = static_cast<size_t>(rows_per_block) * words * sizeof(uint32_t);
  gumbel_sample_kernel<Fetch, Window>
      <<<qt_blocks(W, rows_per_block), rows_per_block * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(
          g, win, n_nodes, static_cast<const int32_t*>(seeds),
          static_cast<const bool*>(seed_valid), W, k, max_deg, wwin, key0, key1,
          static_cast<int32_t*>(out), static_cast<bool*>(out_valid));
  return qt_launch_status();
}

static inline int qt_tiled_window(int max_deg) { return (max_deg + 127) / 128 * 128; }

QT_EXPORT int qt_weighted_sample_tiled(const void* bd, const void* tiles, const void* wtiles,
                                       long long m_rows, int n_nodes, const void* seeds,
                                       const void* seed_valid, int W, int k, int max_deg,
                                       unsigned key0, unsigned key1, void* out, void* out_valid,
                                       void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  TiledWeights win{static_cast<const float*>(wtiles), m_rows};
  return launch_gumbel(g, win, n_nodes, seeds, seed_valid, W, k, max_deg,
                       qt_tiled_window(max_deg), key0, key1, out, out_valid, stream);
}

QT_EXPORT int qt_weighted_sample_flat(const void* indptr, const void* indices,
                                      const void* weights, long long n_edges, int n_nodes,
                                      const void* seeds, const void* seed_valid, int W, int k,
                                      int max_deg, unsigned key0, unsigned key1, void* out,
                                      void* out_valid, void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  FlatWeights win{static_cast<const float*>(weights), n_edges};
  return launch_gumbel(g, win, n_nodes, seeds, seed_valid, W, k, max_deg, max_deg, key0, key1,
                       out, out_valid, stream);
}

QT_EXPORT int qt_temporal_sample_tiled(const void* bd, const void* tiles, const void* ttiles,
                                       long long m_rows, int n_nodes, const void* seeds,
                                       const void* seed_valid, const void* t, int W, int k,
                                       int max_deg, float recency, int has_cutoff, float cutoff,
                                       unsigned key0, unsigned key1, void* out, void* out_valid,
                                       void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  TemporalWeights win{TiledWeights{static_cast<const float*>(ttiles), m_rows},
                      static_cast<const float*>(t), recency, has_cutoff, cutoff};
  return launch_gumbel(g, win, n_nodes, seeds, seed_valid, W, k, max_deg,
                       qt_tiled_window(max_deg), key0, key1, out, out_valid, stream);
}

// K8w: out[i] = qt_recency_weight(ts[i], recency) over a flat array.
__global__ void recency_weights_kernel(const float* __restrict__ ts, long long n, float recency,
                                       float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    out[i] = qt_recency_weight(ts[i], recency);
  }
}

QT_EXPORT int qt_recency_weights(const void* ts, long long n, float recency, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  recency_weights_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), n, recency, static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
