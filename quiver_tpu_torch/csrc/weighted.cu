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
// outputs are bit-equal to the plain torch versions. K7, K7 flat and K8
// also read the two key words from device memory (the _dk entry points, a
// template flag on the one body) for a captured serve step's replays, and
// K8 its three table addresses too (qt_temporal_sample_tiled_dg, a second
// flag): a step captured once then draws from whichever committed epoch of
// a streaming temporal graph its flush sealed.
//
// Design. A block of 256 threads (8 blocks an SM at 32 registers) takes R
// consecutive rows, 1 to 32: the most that still leaves a wave of blocks
// on the 132 SMs. It works in passes, each over as many of its rows as
// fit 4,096 keys of shared memory (a whole window always fits). A row
// spans max(deg, k) lanes: the top k of a row of deg <= k reach past deg
// into -inf lanes.
// - Scoring: the block's threads walk the pass's lanes as one flat list,
//   so no thread idles past a short row's end. Each lane's row is first
//   written into its key slot; a thread's lanes lie 256 apart, and it
//   loads its next lane's weight (or timestamp) before its current
//   lane's chain. Lanes past deg or of weight <= 0 take no uniform and
//   no logarithm. Each key (qt_score_key, an unsigned order of the
//   scores) replaces the row in its slot.
// - Selection, a warp a row. A row of at most 32 lanes: each lane's rank
//   among the row's keys in one pass of 32 shuffles. Wider, up to
//   QT_ARGMAX_MAX_K draws: k rounds of a warp arg-max, each two warp
//   reductions (the largest key, then the lowest lane holding it;
//   __reduce_max/min_sync), and only the lane that owned the winner
//   rescans its 32-strided slice. Above it: the finite keys are counted;
//   where there are more than k, a radix select (four 8-bit digits,
//   histograms in the warp's shared scratch) finds the k-th largest key,
//   and every lane above it and the lowest lanes equal to it are taken;
//   the k picks are compacted in lane order and each pick's output slot
//   is its rank among them (k^2 compares over the warp, not k dependent
//   rounds). Above QT_RANK_CAP draws a row a pick's rank is counted over
//   the whole span instead. The -inf picks (deg or finite lanes < k)
//   follow the finite ones in lane order.
// - Output: where a pass's R x k picks fit QT_PICKS_CAP, they go to a
//   shared list and the whole block fetches and writes the ids (fetched
//   at the drawn position even where the draw is invalid) together, so
//   that the fetches' latencies overlap; else each warp writes its row's.
// QT_ARGMAX_MAX_K = 16, measured on an H100 (scripts/torch_gumbel_probe.py,
// PERF.md): on rows wider than 32 lanes the rounds are the faster at
// k = 5, 10 and 15, the radix select at 64 (by 45%); k between was not
// measured.
//
// Bound on the card: the float64 logarithms (three a live lane) at the
// card's FP64 rate, or bytes on small hops -- each row's (base, degree)
// pair, its min(deg, max_deg) window weights or timestamps, the k ids
// read and the [W, k] ids and flags written. That bound is out of reach:
// the scoring chain alone (the threefry uniform, bound by the integer
// pipe, and three float64 logarithms, with nothing else in a kernel and
// every warp on it) takes 0.20 ms for a hop 3's 15.1M live lanes against
// the 0.075 ms FP64 bound. The design keeps the card's warps on it.

#include "common.cuh"
#include "fetch.cuh"
#include "gumbel.cuh"

#define QT_MAX_WINDOW 4096

// A Window's lane weight in two steps, so that a lane's load can be issued
// ahead of the chain that uses it: raw(base, j) reads the lane's value,
// weight(x, p) makes its weight, p the row's param(b).
struct FlatWeights {
  const float* w;  // [E]
  long long n_edges;
  __device__ __forceinline__ float param(int32_t) const { return 0.0f; }
  __device__ __forceinline__ float raw(int32_t ptr, int32_t j) const {
    return w[qt_clamp<long long>(static_cast<long long>(ptr) + j, 0, n_edges - 1)];
  }
  __device__ __forceinline__ float weight(float x, float) const { return x; }
};

struct TiledWeights {
  const float* wtiles;  // [M, 128], the tile map of the edge tiles
  long long m_rows;
  __device__ __forceinline__ float param(int32_t) const { return 0.0f; }
  __device__ __forceinline__ float raw(int32_t base, int32_t j) const {
    const long long r = qt_clamp<long long>(static_cast<long long>(base) + (j >> 7), 0,
                                            m_rows - 1);
    return wtiles[r * 128 + (j & 127)];
  }
  __device__ __forceinline__ float weight(float x, float) const { return x; }
};

struct TemporalWeights {
  TiledWeights ts;  // timestamp tiles
  const float* t;   // [W] per-row query time
  float recency;
  int has_cutoff;
  float cutoff;
  __device__ __forceinline__ float param(int32_t b) const { return t[b]; }
  __device__ __forceinline__ float raw(int32_t base, int32_t j) const { return ts.raw(base, j); }
  // the device-graph form: the timestamp tiles' address is the third word
  __device__ __forceinline__ void bind(const unsigned long long* __restrict__ words) {
    ts.wtiles = reinterpret_cast<const float*>(words[2]);
  }
  __device__ __forceinline__ float weight(float x, float tq) const {
    const bool keep = x <= tq && (!has_cutoff || x > cutoff);
    return keep ? qt_recency_weight(x, recency) : 0.0f;
  }
};

#ifndef QT_ARGMAX_MAX_K
#define QT_ARGMAX_MAX_K 16
#endif
#define QT_GUMBEL_THREADS 256
#define QT_GUMBEL_BLOCKS_SM (2048 / QT_GUMBEL_THREADS)  // resident blocks an SM, by threads
#ifndef QT_GUMBEL_SCORE_ONLY
#define QT_GUMBEL_SCORE_ONLY 0  // 1: a timing build that scores and selects nothing
#endif
#define QT_GUMBEL_WARPS (QT_GUMBEL_THREADS / 32)
#define QT_GUMBEL_MAX_ROWS 32
#define QT_LANE_BUDGET 4096  // keys of one pass, >= QT_MAX_WINDOW
#define QT_RANK_CAP 128      // picks a warp compacts into its scratch
#define QT_PICKS_CAP 512     // a pass's picks kept in shared memory
static_assert(QT_ARGMAX_MAX_K <= 64, "the arg-max rounds keep two picks a lane");
static_assert(QT_LANE_BUDGET >= QT_MAX_WINDOW, "a whole window must fit one pass");

#define QT_FULL_MASK 0xFFFFFFFFu

// Where a row's picks go: straight to the output (the id fetched at the
// drawn position, valid or not), or into the block's shared pick list as
// the position or, where the draw is invalid, its complement; the block
// then fetches and writes every row's ids together, so that the fetches'
// latencies overlap.
template <class Fetch>
struct QtDirect {
  const Fetch& g;
  int32_t base;
  int32_t* out;
  bool* out_valid;
  long long o0;
  __device__ __forceinline__ void put(int32_t slot, int32_t j, bool ok) const {
    out[o0 + slot] = g.fetch(base, j);
    out_valid[o0 + slot] = ok;
  }
};

struct QtDeferred {
  int32_t* picks;  // the row's k entries
  __device__ __forceinline__ void put(int32_t slot, int32_t j, bool ok) const {
    picks[slot] = ok ? j : ~j;
  }
};

// Up to QT_ARGMAX_MAX_K draws: k rounds of a warp arg-max over the row's
// keys. A lane keeps the best (key, lowest lane) of its 32-strided slice;
// a round takes the largest key and the lowest lane holding it, marks it
// taken (key 0, below every other) and the owning lane rescans its slice.
// -inf lanes come after every finite key, in lane order; span >= k.
template <class Sink>
__device__ __forceinline__ void qt_argmax_rounds(const Sink& sink, uint32_t* rk, int32_t span,
                                                 int32_t deg, int32_t k, int lane) {
  uint32_t best = QT_KEY_TAKEN;
  uint32_t best_j = 0xFFFFFFFFu;
  for (int32_t j = lane; j < span; j += 32) {
    const uint32_t v = rk[j];
    if (v > best) {  // j rises along a lane: the first of equal keys stays
      best = v;
      best_j = static_cast<uint32_t>(j);
    }
  }
  const int32_t n_valid = deg < k ? deg : k;
  int32_t pick0 = 0, pick1 = 0;
  bool ok0 = false, ok1 = false;
  for (int32_t r = 0; r < k; ++r) {
    const uint32_t m = __reduce_max_sync(QT_FULL_MASK, best);
    const uint32_t j = __reduce_min_sync(QT_FULL_MASK, best == m ? best_j : 0xFFFFFFFFu);
    if (lane == (r & 31)) {
      const bool ok = r < n_valid && m > QT_KEY_NEG_INF;
      if (r < 32) {
        pick0 = static_cast<int32_t>(j);
        ok0 = ok;
      } else {
        pick1 = static_cast<int32_t>(j);
        ok1 = ok;
      }
    }
    if (lane == static_cast<int>(j & 31u)) {  // only this lane's slice changed
      rk[j] = QT_KEY_TAKEN;
      best = QT_KEY_TAKEN;
      best_j = 0xFFFFFFFFu;
      for (int32_t i = lane; i < span; i += 32) {
        const uint32_t v = rk[i];
        if (v > best) {
          best = v;
          best_j = static_cast<uint32_t>(i);
        }
      }
    }
  }
  if (lane < k) sink.put(lane, pick0, ok0);
  if (lane + 32 < k) sink.put(lane + 32, pick1, ok1);
}

// A row of at most 32 lanes, one key a lane: each lane's rank among the
// row's keys in one pass of 32 shuffles (no dependent rounds); lanes
// ranked below k are the picks. Lanes past the span hold key 0 (taken),
// below every key of the row.
template <class Sink>
__device__ __forceinline__ void qt_select_one_key_a_lane(const Sink& sink, const uint32_t* rk,
                                                         int32_t span, int32_t deg, int32_t k,
                                                         int lane) {
  const uint32_t v = lane < span ? rk[lane] : QT_KEY_TAKEN;
  int32_t rank = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t u = __shfl_sync(QT_FULL_MASK, v, i);
    rank += (u > v) || (u == v && i < lane);
  }
  const int32_t n_valid = deg < k ? deg : k;
  if (lane < span && rank < k) sink.put(rank, lane, rank < n_valid && v > QT_KEY_NEG_INF);
}

// The -inf picks: the first n_fill -inf lanes of the span in lane order,
// to output slots first, first + 1, ... (invalid draws).
template <class Sink>
__device__ __forceinline__ void qt_fill_neg_inf(const Sink& sink, const uint32_t* rk,
                                                int32_t span, int32_t first, int32_t n_fill,
                                                int lane) {
  const unsigned lt = (1u << lane) - 1u;
  int32_t seen = 0;
  for (int32_t j0 = 0; j0 < span && seen < n_fill; j0 += 32) {
    const int32_t j = j0 + lane;
    const bool neg = j < span && rk[j] <= QT_KEY_NEG_INF;
    const unsigned nb = __ballot_sync(QT_FULL_MASK, neg);
    const int32_t idx = seen + __popc(nb & lt);
    if (neg && idx < n_fill) sink.put(first + idx, j, false);
    seen += __popc(nb);
  }
}

// Above QT_ARGMAX_MAX_K draws: select the k picks by the k-th largest key
// (a radix select where more than k keys are finite), then write each
// pick at its rank among the picks. ws: the warp's 256-word scratch.
template <class Sink>
__device__ void qt_select_by_rank(const Sink& sink, const uint32_t* rk, uint32_t* ws,
                                  int32_t span, int32_t k, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  int32_t nf = 0;  // finite keys
  for (int32_t j0 = 0; j0 < span; j0 += 32) {
    const int32_t j = j0 + lane;
    nf += __popc(__ballot_sync(QT_FULL_MASK, j < span && rk[j] > QT_KEY_NEG_INF));
  }
  const int32_t m = nf < k ? nf : k;  // finite picks, slots [0, m)
  if (k > QT_RANK_CAP) {
    // a finite lane's rank among the span's finite lanes; the top k are the picks
    for (int32_t j = lane; j < span; j += 32) {
      const uint32_t v = rk[j];
      if (v <= QT_KEY_NEG_INF) continue;
      int32_t rank = 0;
      for (int32_t i = 0; i < span; ++i) {
        const uint32_t u = rk[i];
        rank += (u > v) || (u == v && i < j);
      }
      if (rank < k) sink.put(rank, j, true);
    }
  } else {
    // the k-th largest finite key, 8 bits a pass: keys matching `prefix`
    // under `pmask` are still candidates, `need` of them are picks
    uint32_t prefix = 0, pmask = 0, need = static_cast<uint32_t>(k);
    if (nf > k) {
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int t = lane; t < 256; t += 32) ws[t] = 0;
        __syncwarp();
        for (int32_t j = lane; j < span; j += 32) {
          const uint32_t v = rk[j];
          if (v > QT_KEY_NEG_INF && (v & pmask) == prefix) atomicAdd(&ws[(v >> shift) & 255u], 1u);
        }
        __syncwarp();
        // the digit holding the need-th largest: bins from 255 down, 32 a step
        uint32_t above = 0, d = 0, cnt = 0;
        for (int t = 0; t < 8; ++t) {
          const uint32_t c = ws[255 - 32 * t - lane];
          const uint32_t tot = __reduce_add_sync(QT_FULL_MASK, c);
          if (above + tot >= need) {
            uint32_t cum = c;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const uint32_t o = __shfl_up_sync(QT_FULL_MASK, cum, off);
              if (lane >= off) cum += o;
            }
            const int src = __ffs(__ballot_sync(QT_FULL_MASK, above + cum >= need)) - 1;
            above += __shfl_sync(QT_FULL_MASK, cum - c, src);
            cnt = __shfl_sync(QT_FULL_MASK, c, src);
            d = static_cast<uint32_t>(255 - 32 * t - src);
            break;
          }
          above += tot;
        }
        need -= above;
        prefix |= d << shift;
        pmask |= 0xFFu << shift;
        __syncwarp();  // the bins are read before the next pass clears them
        if (cnt == need) break;  // every key under the prefix is a pick
      }
    }
    // the picks, compacted in lane order: keys above the prefix, then the
    // lowest `need` lanes equal to it (every finite key when nf <= k)
    uint32_t* ck = ws;
    int32_t* cl = reinterpret_cast<int32_t*>(ws + QT_RANK_CAP);
    uint32_t n_pick = 0, n_eq = 0;
    for (int32_t j0 = 0; j0 < span; j0 += 32) {
      const int32_t j = j0 + lane;
      const uint32_t v = j < span ? rk[j] : QT_KEY_TAKEN;
      const bool fin = v > QT_KEY_NEG_INF;
      bool pick = fin;
      if (nf > k) {
        const uint32_t mv = v & pmask;
        const bool eq = fin && mv == prefix;
        const unsigned eb = __ballot_sync(QT_FULL_MASK, eq);
        pick = (fin && mv > prefix) || (eq && n_eq + __popc(eb & lt) < need);
        n_eq += __popc(eb);
      }
      const unsigned pb = __ballot_sync(QT_FULL_MASK, pick);
      if (pick) {
        const uint32_t c = n_pick + __popc(pb & lt);
        ck[c] = v;
        cl[c] = j;
      }
      n_pick += __popc(pb);
    }
    __syncwarp();
    for (int32_t c = lane; c < m; c += 32) {
      const uint32_t v = ck[c];
      int32_t rank = 0;
      for (int32_t i = 0; i < m; ++i) {
        const uint32_t u = ck[i];
        rank += (u > v) || (u == v && i < c);
      }
      sink.put(rank, cl[c], true);
    }
    __syncwarp();  // the scratch is read before the warp's next row
  }
  if (m < k) qt_fill_neg_inf(sink, rk, span, m, k - m, lane);
}

// One row's selection, by its span and k.
template <class Sink>
__device__ __forceinline__ void qt_select(const Sink& sink, uint32_t* rk, uint32_t* ws,
                                          int32_t span, int32_t deg, int32_t k, int lane) {
  if (span <= 32) qt_select_one_key_a_lane(sink, rk, span, deg, k, lane);
  else if (k <= QT_ARGMAX_MAX_K) qt_argmax_rounds(sink, rk, span, deg, k, lane);
  else qt_select_by_rank(sink, rk, ws, span, k, lane);
}

// every block an SM can hold by threads: at most 32 registers a thread.
// kDevKey: the hop's key words are read from key_words[0..1] in device
// memory (the form a captured CUDA graph replays with new keys), else they
// are key0 and key1, passed by value. kDevGraph: the tables' addresses are
// read from graph_words (the fetch's two, then the window's).
template <class Fetch, class Window, bool kDevKey, bool kDevGraph>
__global__ void __launch_bounds__(QT_GUMBEL_THREADS, QT_GUMBEL_BLOCKS_SM)
    gumbel_sample_kernel(Fetch g, Window win, int32_t n_nodes, const int32_t* __restrict__ seeds,
                         const bool* __restrict__ seed_valid, int32_t W, int32_t k,
                         int32_t max_deg, int32_t wwin, int32_t rows, uint32_t key0,
                         uint32_t key1, const uint32_t* __restrict__ key_words,
                         const unsigned long long* __restrict__ graph_words,
                         int32_t* __restrict__ out, bool* __restrict__ out_valid) {
  if (kDevKey) {
    key0 = key_words[0];
    key1 = key_words[1];
  }
  if constexpr (kDevGraph) {
    g.bind(graph_words);
    win.bind(graph_words);
  }
  __shared__ uint32_t keys[QT_LANE_BUDGET];
  __shared__ uint32_t scratch[QT_GUMBEL_WARPS][256];
  __shared__ int32_t picks[QT_PICKS_CAP];
  __shared__ int32_t row_base[QT_GUMBEL_MAX_ROWS], row_deg[QT_GUMBEL_MAX_ROWS];
  __shared__ float row_param[QT_GUMBEL_MAX_ROWS];
  __shared__ int32_t row_off[QT_GUMBEL_MAX_ROWS + 1];  // lane offsets, a prefix sum of the spans
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t row0 = blockIdx.x * rows;

  if (warp == 0) {
    const int32_t b = row0 + lane;
    int32_t base = 0, deg = 0, span = 0;
    float param = 0.0f;
    if (lane < rows && b < W) {
      const int32_t s = qt_clamp<int32_t>(seeds[b], 0, n_nodes - 1);
      param = win.param(b);
      g.row(s, base, deg);
      if (!seed_valid[b]) deg = 0;
      deg = deg < max_deg ? deg : max_deg;
      span = deg > k ? deg : k;  // deg <= max_deg <= wwin
    }
    int32_t cum = span;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(QT_FULL_MASK, cum, off);
      if (lane >= off) cum += o;
    }
    row_base[lane] = base;
    row_deg[lane] = deg;
    row_param[lane] = param;
    row_off[lane + 1] = cum;
    if (lane == 0) row_off[0] = 0;
  }
  __syncthreads();

  for (int p0 = 0; p0 < rows;) {
    int p1 = p0 + 1;  // rows [p0, p1) fit the pass's key budget
    while (p1 < rows && row_off[p1 + 1] - row_off[p0] <= QT_LANE_BUDGET) ++p1;
    const int32_t lane0 = row_off[p0];
    const int32_t total = row_off[p1] - lane0;

    // each lane's row, in its key slot until the lane's key replaces it
    for (int r = p0 + warp; r < p1; r += QT_GUMBEL_WARPS) {
      for (int32_t i = row_off[r] - lane0 + lane; i < row_off[r + 1] - lane0; i += 32) keys[i] = r;
    }
    __syncthreads();

    // scoring: the pass's lanes as one flat list, a thread's lanes
    // QT_GUMBEL_THREADS apart; the next lane's value is loaded before the
    // current lane's chain
    auto fetch = [&](int32_t i, int32_t& r, int32_t& j, float& x) {
      r = static_cast<int32_t>(keys[i]);
      j = lane0 + i - row_off[r];
      x = j < row_deg[r] ? win.raw(row_base[r], j) : 0.0f;
    };
    int32_t lr = 0, lj = 0;
    float lx = 0.0f;
    if (static_cast<int32_t>(threadIdx.x) < total) fetch(threadIdx.x, lr, lj, lx);
#pragma unroll 1
    for (int32_t i = threadIdx.x; i < total; i += QT_GUMBEL_THREADS) {
      int32_t rn = 0, jn = 0;
      float xn = 0.0f;
      if (i + QT_GUMBEL_THREADS < total) fetch(i + QT_GUMBEL_THREADS, rn, jn, xn);
      uint32_t key = QT_KEY_NEG_INF;
      if (lj < row_deg[lr]) {
        const float w = fmaxf(win.weight(lx, row_param[lr]), 0.0f);
        if (w > 0.0f) {
          const uint64_t ctr = static_cast<uint64_t>(row0 + lr) * static_cast<uint64_t>(wwin) +
                               static_cast<uint64_t>(lj);
          key = qt_score_key(qt_gumbel_score(w, qt_gumbel_uniform(key0, key1, ctr)));
        }
      }
      keys[i] = key;
      lr = rn;
      lj = jn;
      lx = xn;
    }
    __syncthreads();

    // selection: a warp a row, its picks into the pass's pick list where
    // the list holds them all
    const bool deferred = (p1 - p0) * k <= QT_PICKS_CAP && !QT_GUMBEL_SCORE_ONLY;
    for (int r = p0 + warp; r < p1 && !QT_GUMBEL_SCORE_ONLY; r += QT_GUMBEL_WARPS) {
      const int32_t span = row_off[r + 1] - row_off[r];
      if (span == 0) continue;  // past W
      uint32_t* rk = keys + (row_off[r] - lane0);
      if (deferred) {
        qt_select(QtDeferred{picks + (r - p0) * k}, rk, scratch[warp], span, row_deg[r], k,
                  lane);
      } else {
        qt_select(QtDirect<Fetch>{g, row_base[r], out, out_valid,
                                  static_cast<long long>(row0 + r) * k},
                  rk, scratch[warp], span, row_deg[r], k, lane);
      }
    }
    __syncthreads();
    if (deferred) {  // the pass's ids, fetched and written by the whole block
      for (int32_t t = threadIdx.x; t < (p1 - p0) * k; t += QT_GUMBEL_THREADS) {
        const int r = p0 + t / k;
        if (row_off[r + 1] == row_off[r]) continue;
        const int32_t p = picks[t];
        const long long o = static_cast<long long>(row0 + r) * k + (t - (r - p0) * k);
        out[o] = g.fetch(row_base[r], p >= 0 ? p : ~p);
        out_valid[o] = p >= 0;
      }
    }
    p0 = p1;
  }
}

// Rows a block: 1 to 32, the most that still leaves a wave of blocks on
// the 132 SMs (fewer rows a block at 4 waves, or 128 or 512 threads a
// block, measured slower; PERF.md).
static inline int qt_gumbel_rows(int W) {
  const int per = W / (132 * QT_GUMBEL_BLOCKS_SM);
  int rows = 1;
  while (rows < QT_GUMBEL_MAX_ROWS && 2 * rows <= per) rows *= 2;
  return rows;
}

template <bool kDevKey, bool kDevGraph = false, class Fetch, class Window>
static int launch_gumbel(Fetch g, Window win, int n_nodes, const void* seeds,
                         const void* seed_valid, int W, int k, int max_deg, int wwin,
                         unsigned key0, unsigned key1, const void* key_words, void* out,
                         void* out_valid, void* stream, const void* graph_words = nullptr) {
  if (W <= 0 || k <= 0) return 0;
  if (k > wwin || max_deg < 1 || wwin > QT_MAX_WINDOW || (kDevKey && key_words == nullptr) ||
      (kDevGraph && graph_words == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = qt_gumbel_rows(W);
  qt_count_launch();
  gumbel_sample_kernel<Fetch, Window, kDevKey, kDevGraph>
      <<<qt_blocks(W, rows), QT_GUMBEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          g, win, n_nodes, static_cast<const int32_t*>(seeds),
          static_cast<const bool*>(seed_valid), W, k, max_deg, wwin, rows, key0, key1,
          static_cast<const uint32_t*>(key_words),
          static_cast<const unsigned long long*>(graph_words), static_cast<int32_t*>(out),
          static_cast<bool*>(out_valid));
  return qt_launch_status();
}

static inline int qt_tiled_window(int max_deg) { return (max_deg + 127) / 128 * 128; }

// Each draw has two entry points: the hop's key words by value (key0,
// key1), and, with the _dk suffix, read from device memory (key_words:
// uint32[2]), the form a captured serve step replays. Both run one body.
template <bool kDevKey>
static int weighted_tiled(const void* bd, const void* tiles, const void* wtiles, long long m_rows,
                          int n_nodes, const void* seeds, const void* seed_valid, int W, int k,
                          int max_deg, unsigned key0, unsigned key1, const void* key_words,
                          void* out, void* out_valid, void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  TiledWeights win{static_cast<const float*>(wtiles), m_rows};
  return launch_gumbel<kDevKey>(g, win, n_nodes, seeds, seed_valid, W, k, max_deg,
                                qt_tiled_window(max_deg), key0, key1, key_words, out,
                                out_valid, stream);
}

template <bool kDevKey>
static int weighted_flat(const void* indptr, const void* indices, const void* weights,
                         long long n_edges, int n_nodes, const void* seeds,
                         const void* seed_valid, int W, int k, int max_deg, unsigned key0,
                         unsigned key1, const void* key_words, void* out, void* out_valid,
                         void* stream) {
  FlatFetch g{static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
              n_edges};
  FlatWeights win{static_cast<const float*>(weights), n_edges};
  return launch_gumbel<kDevKey>(g, win, n_nodes, seeds, seed_valid, W, k, max_deg, max_deg,
                                key0, key1, key_words, out, out_valid, stream);
}

template <bool kDevKey>
static int temporal_tiled(const void* bd, const void* tiles, const void* ttiles,
                          long long m_rows, int n_nodes, const void* seeds,
                          const void* seed_valid, const void* t, int W, int k, int max_deg,
                          float recency, int has_cutoff, float cutoff, unsigned key0,
                          unsigned key1, const void* key_words, void* out, void* out_valid,
                          void* stream) {
  TiledFetch g{static_cast<const int32_t*>(bd), static_cast<const int32_t*>(tiles), m_rows};
  TemporalWeights win{TiledWeights{static_cast<const float*>(ttiles), m_rows},
                      static_cast<const float*>(t), recency, has_cutoff, cutoff};
  return launch_gumbel<kDevKey>(g, win, n_nodes, seeds, seed_valid, W, k, max_deg,
                                qt_tiled_window(max_deg), key0, key1, key_words, out,
                                out_valid, stream);
}

QT_EXPORT int qt_weighted_sample_tiled(const void* bd, const void* tiles, const void* wtiles,
                                       long long m_rows, int n_nodes, const void* seeds,
                                       const void* seed_valid, int W, int k, int max_deg,
                                       unsigned key0, unsigned key1, void* out, void* out_valid,
                                       void* stream) {
  return weighted_tiled<false>(bd, tiles, wtiles, m_rows, n_nodes, seeds, seed_valid, W, k,
                               max_deg, key0, key1, nullptr, out, out_valid, stream);
}

QT_EXPORT int qt_weighted_sample_tiled_dk(const void* bd, const void* tiles, const void* wtiles,
                                          long long m_rows, int n_nodes, const void* seeds,
                                          const void* seed_valid, int W, int k, int max_deg,
                                          const void* key_words, void* out, void* out_valid,
                                          void* stream) {
  return weighted_tiled<true>(bd, tiles, wtiles, m_rows, n_nodes, seeds, seed_valid, W, k,
                              max_deg, 0, 0, key_words, out, out_valid, stream);
}

QT_EXPORT int qt_weighted_sample_flat(const void* indptr, const void* indices,
                                      const void* weights, long long n_edges, int n_nodes,
                                      const void* seeds, const void* seed_valid, int W, int k,
                                      int max_deg, unsigned key0, unsigned key1, void* out,
                                      void* out_valid, void* stream) {
  return weighted_flat<false>(indptr, indices, weights, n_edges, n_nodes, seeds, seed_valid, W,
                              k, max_deg, key0, key1, nullptr, out, out_valid, stream);
}

QT_EXPORT int qt_weighted_sample_flat_dk(const void* indptr, const void* indices,
                                         const void* weights, long long n_edges, int n_nodes,
                                         const void* seeds, const void* seed_valid, int W, int k,
                                         int max_deg, const void* key_words, void* out,
                                         void* out_valid, void* stream) {
  return weighted_flat<true>(indptr, indices, weights, n_edges, n_nodes, seeds, seed_valid, W,
                             k, max_deg, 0, 0, key_words, out, out_valid, stream);
}

QT_EXPORT int qt_temporal_sample_tiled(const void* bd, const void* tiles, const void* ttiles,
                                       long long m_rows, int n_nodes, const void* seeds,
                                       const void* seed_valid, const void* t, int W, int k,
                                       int max_deg, float recency, int has_cutoff, float cutoff,
                                       unsigned key0, unsigned key1, void* out, void* out_valid,
                                       void* stream) {
  return temporal_tiled<false>(bd, tiles, ttiles, m_rows, n_nodes, seeds, seed_valid, t, W, k,
                               max_deg, recency, has_cutoff, cutoff, key0, key1, nullptr, out,
                               out_valid, stream);
}

QT_EXPORT int qt_temporal_sample_tiled_dk(const void* bd, const void* tiles, const void* ttiles,
                                          long long m_rows, int n_nodes, const void* seeds,
                                          const void* seed_valid, const void* t, int W, int k,
                                          int max_deg, float recency, int has_cutoff,
                                          float cutoff, const void* key_words, void* out,
                                          void* out_valid, void* stream) {
  return temporal_tiled<true>(bd, tiles, ttiles, m_rows, n_nodes, seeds, seed_valid, t, W, k,
                              max_deg, recency, has_cutoff, cutoff, 0, 0, key_words, out,
                              out_valid, stream);
}

// K8's device-graph form: graph_words (uint64[3] in device memory) hold the
// addresses of bd [n_nodes, 2], tiles and ttiles [m_rows, 128]; the key
// words as in the _dk form.
QT_EXPORT int qt_temporal_sample_tiled_dg(const void* graph_words, long long m_rows,
                                          int n_nodes, const void* seeds,
                                          const void* seed_valid, const void* t, int W, int k,
                                          int max_deg, float recency, int has_cutoff,
                                          float cutoff, const void* key_words, void* out,
                                          void* out_valid, void* stream) {
  TiledFetch g{nullptr, nullptr, m_rows};
  TemporalWeights win{TiledWeights{nullptr, m_rows}, static_cast<const float*>(t), recency,
                      has_cutoff, cutoff};
  return launch_gumbel<true, true>(g, win, n_nodes, seeds, seed_valid, W, k, max_deg,
                                   qt_tiled_window(max_deg), 0, 0, key_words, out, out_valid,
                                   stream, graph_words);
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
  qt_count_launch();
  recency_weights_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), n, recency, static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
