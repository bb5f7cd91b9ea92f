// K11: neighbor_prob — one hop of sampling-probability propagation.
//
// Replaces quiver_tpu/ops/sample.py:neighbor_prob (and the hops of
// sample_prob): next[v] = sum over edges u -> v of w[u], with
// w[u] = prob[u] * min(k / max(deg(u), 1), 1) in float32, in the
// reference's steps (deg cast to float, an IEEE division, min, then a
// multiply; no FMA). The reference scatter-adds w[src] over the edge list
// in edge order; this kernel pulls instead, over the transposed CSR (the
// sources of each v in stable edge order, built once per graph on the
// host), so it needs no float atomics and reruns are bit-equal.
//
// Bound on the card: bytes — per hop the transposed source ids (4 B an
// edge), tindptr, deg, prob and the output once a node (about 0.56 GB at
// products scale, 0.168 ms); the [N] weights (9.8 MB) stay in the 50 MB
// L2, so their per-edge reads are L2 traffic, not device-memory bytes. In
// practice those reads bind: 123.7M scattered 4-byte reads a hop, each a
// 32-byte L2 sector, about 4 GB of L2 traffic, whatever order the edges
// are walked in (a warp a 1,024-edge tile, as the first design did, took
// as long).
//
// Design: balanced by merge items (Merrill and Garland's merge-path
// SpMV). The merge of the N node ends with the E edges, in the order the
// edges of node v, then v's end, then v + 1's edges, is cut into ranges of
// kProbWarpItems items (a node of no in-edge costs one item, its end); each
// range's start (v, e) comes with the transposed graph, found once per graph
// by a search of the node ends' merge positions v + tindptr[v + 1]. A first
// pass computes the weights. Then a warp a range: it loads the range's tsrc
// (evict-first, coalesced) and their weights (kProbLaneItems loads in
// flight a lane) into shared memory, with the range's node ends; each lane
// walks kProbLaneItems consecutive items, adding a node's edges in order;
// a node that starts and ends in one lane is written at once; a node that
// crosses lanes is combined by a segmented scan over the lanes (5 shuffle
// levels), and the lane where it ends writes it. A node that crosses
// ranges leaves the range's part of it in `head` (the range where it ends)
// or `tail` (every other range), and a third pass, a thread a range where
// such a node ends, adds its parts in range order: one by one up to
// kProbSeqSpan parts, else 32 lanes of strided sums and a butterfly (the
// products hub spans ~2,440 ranges). Every order is fixed, so the result is the same on every
// run; it differs from the reference's sequential sum within float
// rounding (`neighbor_prob_depth` in ops/sample.py bounds the additions a
// term passes through in this order).

#include "common.cuh"

constexpr int kProbLaneItems = 16;                   // merge items a lane walks
constexpr int kProbWarpItems = 32 * kProbLaneItems;  // items of one range (a warp)
constexpr int kProbSeqSpan = 8;  // ranges a crossing node's parts are added one by one up to
constexpr int kProbBlockWarps = 4;

struct ProbScratch {
  float* w;        // [n] the weights
  float* head;     // [n_ranges] the part of the node that ends in the range, begun before it
  float* tail;     // [n_ranges] the part of the node open at the range's end
  long long n_ranges, bytes;
};

static ProbScratch prob_scratch(char* base, long long n, long long n_edges) {
  ProbScratch s{};
  long long at = 0;
  auto take = [&](long long count, size_t elem) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (count * static_cast<long long>(elem) + 255) / 256 * 256;
    return p;
  };
  s.n_ranges = (n + n_edges + kProbWarpItems - 1) / kProbWarpItems;
  s.w = reinterpret_cast<float*>(take(n, sizeof(float)));
  s.head = reinterpret_cast<float*>(take(s.n_ranges, sizeof(float)));
  s.tail = reinterpret_cast<float*>(take(s.n_ranges, sizeof(float)));
  s.bytes = at;
  return s;
}

// 1. a thread a node: its weight
__global__ void prob_weights_kernel(const float* __restrict__ prob,
                                    const int32_t* __restrict__ deg, long long n, float k,
                                    float* __restrict__ w) {
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (u >= n) return;
  const float d = fmaxf(static_cast<float>(deg[u]), 1.0f);
  w[u] = __fmul_rn(prob[u], fminf(__fdiv_rn(k, d), 1.0f));
}

// 2. a warp a range of kProbWarpItems merge items
__global__ void __launch_bounds__(kProbBlockWarps * 32)
    prob_pull_kernel(const long long* __restrict__ tindptr, const int32_t* __restrict__ tsrc,
                     const float* __restrict__ w, long long n_ranges,
                     const int32_t* __restrict__ cv, const long long* __restrict__ ce,
                     float* __restrict__ head, float* __restrict__ tail,
                     float* __restrict__ out) {
  __shared__ float s_val[kProbBlockWarps][kProbWarpItems];
  __shared__ int32_t s_end[kProbBlockWarps][kProbWarpItems + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x * static_cast<long long>(kProbBlockWarps) + warp;
  if (r >= n_ranges) return;  // warp-uniform
  const long long v0 = cv[r];
  const long long e0 = ce[r];
  const int n_rows = static_cast<int>(cv[r + 1] - v0);  // node ends in the range
  const int n_e = static_cast<int>(ce[r + 1] - e0);     // edges in the range
  float* val = s_val[warp];
  int32_t* rend = s_end[warp];
  {  // the range's edge weights: every load of a lane in flight before the first store
    int32_t src[kProbLaneItems];
    float x[kProbLaneItems];
#pragma unroll
    for (int t = 0; t < kProbLaneItems; ++t) {
      const int j = lane + 32 * t;
      src[t] = j < n_e ? __ldcs(reinterpret_cast<const int*>(tsrc) + e0 + j) : 0;
    }
#pragma unroll
    for (int t = 0; t < kProbLaneItems; ++t) x[t] = lane + 32 * t < n_e ? __ldg(w + src[t]) : 0.0f;
#pragma unroll
    for (int t = 0; t < kProbLaneItems; ++t) {
      if (lane + 32 * t < n_e) val[lane + 32 * t] = x[t];
    }
  }
  // node v0 + i ends before edge e0 + rend[i]; the node open at the end never does
  for (int i = lane; i < n_rows; i += 32) rend[i] = static_cast<int32_t>(tindptr[v0 + 1 + i] - e0);
  if (lane == 0) rend[n_rows] = n_e;
  const bool v0_before = tindptr[v0] < e0;  // node v0 has edges in earlier ranges
  __syncwarp();

  // this lane's items [d, d + kProbLaneItems): its start (i, j) by a binary
  // search of the node ends' positions i + rend[i]
  const int total = n_rows + n_e;
  const int d = lane * kProbLaneItems;
  int lo = d - n_e > 0 ? d - n_e : 0, hi = d < n_rows ? d : n_rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mid + rend[mid] < d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int first = lo;  // the lane's first node, v0 + first
  int i = lo, j = d - lo;
  float acc = 0.0f, h = 0.0f;
  bool ends = false;  // the first node ends in this lane
#pragma unroll
  for (int t = 0; t < kProbLaneItems; ++t) {
    if (d + t < total) {
      if (j < rend[i]) {
        acc = __fadd_rn(acc, val[j]);
        ++j;
      } else {
        if (ends) {
          out[v0 + i] = acc;  // begun and ended in this lane
        } else {
          h = acc;
          ends = true;
        }
        acc = 0.0f;
        ++i;
      }
    }
  }
  if (!ends) h = acc;
  // inclusive segmented scan of (ends, part of the node open at the lane's
  // end): c becomes that node's sum over this range's lanes so far
  float c = acc;
  int f = ends;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oc = __shfl_up_sync(0xFFFFFFFFu, c, off);
    const int of = __shfl_up_sync(0xFFFFFFFFu, f, off);
    if (lane >= off) {
      if (!f) c = __fadd_rn(oc, c);
      f |= of;
    }
  }
  float before = __shfl_up_sync(0xFFFFFFFFu, c, 1);  // the first node's part in earlier lanes
  if (lane == 0) before = 0.0f;
  if (ends) {
    const float sum = __fadd_rn(before, h);
    if (first == 0 && v0_before) {
      head[r] = sum;
    } else {
      out[v0 + first] = sum;
    }
  }
  if (lane == 31) tail[r] = c;
}

// 3. a thread a range r whose first node v began in an earlier range and
//    ends in r: v's parts tail[ra], ..., tail[r - 1], head[r], in order
__global__ void prob_combine_kernel(const long long* __restrict__ tindptr, long long n_ranges,
                                    const int32_t* __restrict__ cv,
                                    const long long* __restrict__ ce,
                                    const float* __restrict__ head,
                                    const float* __restrict__ tail, float* __restrict__ out) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool mine = false;
  long long v = 0, ra = 0;
  if (r < n_ranges) {
    v = cv[r];
    const long long start = tindptr[v];
    mine = start < ce[r] && v < cv[r + 1];
    ra = (v + start) / kProbWarpItems;  // the range of v's first edge
  }
  if (mine && r - ra < kProbSeqSpan) {
    float acc = 0.0f;
    for (long long q = ra; q < r; ++q) acc = __fadd_rn(acc, tail[q]);
    out[v] = __fadd_rn(acc, head[r]);
  }
  unsigned wide = __ballot_sync(0xFFFFFFFFu, mine && r - ra >= kProbSeqSpan);
  while (wide) {  // warp-uniform: the warp sums each wide node's parts together
    const int src = __ffs(wide) - 1;
    wide &= wide - 1;
    const long long rr = __shfl_sync(0xFFFFFFFFu, r, src);
    const long long a = __shfl_sync(0xFFFFFFFFu, ra, src);
    const long long parts = rr - a + 1;
    float acc = 0.0f;
    for (long long p = lane; p < parts; p += 32)
      acc = __fadd_rn(acc, p < parts - 1 ? tail[a + p] : head[rr]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xFFFFFFFFu, acc, off));
    if (lane == src) out[v] = acc;
  }
}

// bytes of scratch a hop takes over n nodes and n_edges edges
QT_EXPORT int qt_neighbor_prob_scratch(long long n, long long n_edges, long long* bytes) {
  *bytes = prob_scratch(nullptr, n, n_edges).bytes;
  return 0;
}

// One hop: the weights, the pull, then the nodes that cross ranges, in
// stream order. range_node and range_edge ([n_ranges + 1]) are each range's
// start; lane_items and seq_span must be this build's kProbLaneItems and
// kProbSeqSpan (the ranges and the caller's depth bound assume them).
QT_EXPORT int qt_neighbor_prob(const void* prob, const void* deg, long long n, float k,
                               const void* tindptr, const void* tsrc, long long n_edges,
                               const void* range_node, const void* range_edge,
                               long long n_ranges, int lane_items, int seq_span, void* scratch,
                               long long scratch_bytes, void* out, void* stream) {
  if (n <= 0) return 0;
  const ProbScratch sc = prob_scratch(static_cast<char*>(scratch), n, n_edges);
  if (lane_items != kProbLaneItems || seq_span != kProbSeqSpan || n_ranges != sc.n_ranges ||
      scratch == nullptr || scratch_bytes < sc.bytes || n >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tp = static_cast<const long long*>(tindptr);
  const int32_t* cv = static_cast<const int32_t*>(range_node);
  const long long* ce = static_cast<const long long*>(range_edge);
  const int threads = 256;
  qt_count_launch();
  prob_weights_kernel<<<qt_blocks(n, threads), threads, 0, s>>>(
      static_cast<const float*>(prob), static_cast<const int32_t*>(deg), n, k, sc.w);
  if (int rc = qt_launch_status()) return rc;
  qt_count_launch();
  prob_pull_kernel<<<qt_blocks(n_ranges, kProbBlockWarps), kProbBlockWarps * 32, 0, s>>>(
      tp, static_cast<const int32_t*>(tsrc), sc.w, n_ranges, cv, ce, sc.head, sc.tail,
      static_cast<float*>(out));
  if (int rc = qt_launch_status()) return rc;
  qt_count_launch();
  prob_combine_kernel<<<qt_blocks(n_ranges, threads), threads, 0, s>>>(
      tp, n_ranges, cv, ce, sc.head, sc.tail, static_cast<float*>(out));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
