// K2: local_reindex — dedup of seeds and sampled neighbors plus the
// rewrite of every neighbor to its canonical local id.
//
// Replaces quiver_tpu/ops/reindex.py:local_reindex (blocked_cumsum,
// propagate_group_start and the _sort3/_sort2 passes). The contract
// (reindex.py:9-22): n_id holds the valid seeds verbatim in slot order
// (duplicates keep their own slots), then the neighbor values no valid
// seed holds, once each, ascending as signed int32; sentinel INT32_MAX
// pads the rest. count = valid seeds + new uniques, left on the card. A
// valid neighbor maps to the slot of the FIRST seed holding its value,
// else to n_seed + its rank among the new uniques. Invalid neighbor lanes
// are written 0 (nothing reads them).
//
// Bound on the card: launches, not bytes. The inputs are at most ~1M ids
// (a few MB), and the first design's bitonic sort over next_pow2(S*k)
// slots took one launch per merge stride above 2,048: 7 + s + s(s+1)/2
// launches a call, s = log2(P / 2,048), 27 at S*k = 56,320 and 61 at
// 901,120, most of them passes over padding.
//
// Design: one launch a call when its S*(1+k) slots fit one block's shared
// memory (kSmallSlots: a flush's first hop), else eight whatever S and k
// (seven when k = 0), and a sort of the live uniques only. The one-block
// path runs the steps below in one block of 1,024 threads, with the hash
// table and the list in shared memory and a bitonic sort of the list
// padded to the next power of two of its live count. Otherwise:
//  1. init: the hash table, the counters, the digit histograms and the
//     sort's tile status words cleared.
//  2. insert: an open-addressing hash table (atomicCAS on the key,
//     atomicMin on the first flat position, seeds at positions 0..S-1 so
//     a seed always beats a neighbor) decides membership; a block a
//     1,024-seed tile also counts its valid seeds.
//  3. mark: a neighbor lane that is its value's first position appends the
//     value to the list of new uniques (warp-aggregated atomics), and its
//     block adds the value's four radix digits to the histograms; each
//     seed tile adds the counts of the tiles before it to a block scan
//     and writes its seeds' slots and n_id.
//  4-7. four stable least-significant-digit passes of 8 bits (sign bit
//     flipped, so signed order holds) over the live list, one launch each
//     (onesweep): a block takes the next 1,024-element tile by an atomic
//     ticket, exits when the tile starts past the live count read on the
//     card, ranks its elements by digit (warp match, then a scan over the
//     warps), and finds the digit's offset from the histogram's prefix
//     and a decoupled look-back over the tiles before it. The last pass
//     writes each new unique's n_id slot and stores its rank in the hash
//     table in place of its first position.
//  8. rewrite: every neighbor lane reads its value's slot (a seed's slot,
//     or n_seed + rank); the sentinel tail of n_id and count.
// The hash decides membership only and the order comes from the sort of
// distinct values, so the result is the same from run to run.

#include "common.cuh"
#include "scan.cuh"

#define QT_SENTINEL 0x7FFFFFFF

constexpr int kReindexTile = kScanTile;  // seeds and list elements a block
constexpr int kRadixBins = 256;
constexpr int kRadixPasses = 4;
constexpr int kReindexCounters = 8;  // n_seed, n_new, a tile ticket a pass
constexpr uint32_t kAggregate = 1u << 30, kPrefix = 2u << 30, kValueMask = kAggregate - 1;
constexpr int kSmallSlots = 2048;             // S*(1+k) the one-block path takes
constexpr int kSmallTable = 2 * kSmallSlots;  // its hash table's entries

struct ReindexScratch {
  int32_t* table;  // [2H]: key, first position (or, after the sort, -1 - rank)
  int32_t* lists[2];
  int32_t* seed_tiles;
  int32_t* counters;
  int32_t* hist;     // [kRadixPasses][kRadixBins]
  uint32_t* status;  // [kRadixPasses][n_tiles][kRadixBins]
  long long H, n_tiles;
};

// the layout of the scratch at `base` (null: sizes only) and its int32
// words (0 on the one-block path); the hash table has a power of two >= 2W
// entries (load <= 1/2)
static ReindexScratch reindex_layout(void* base, int S, int k, long long* words) {
  const long long W = static_cast<long long>(S) * (1 + k);
  if (W <= kSmallSlots) {
    *words = 0;
    return ReindexScratch{};
  }
  const long long n_nbr = static_cast<long long>(S) * k;
  ReindexScratch sc = {};
  sc.H = 2;
  while (sc.H < 2 * W) sc.H <<= 1;
  sc.n_tiles = (n_nbr + kReindexTile - 1) / kReindexTile;
  const long long seed_tiles = (static_cast<long long>(S) + kReindexTile - 1) / kReindexTile;
  const long long at_lists = 2 * sc.H, at_seed_tiles = at_lists + 2 * n_nbr;
  const long long at_counters = at_seed_tiles + seed_tiles;
  const long long at_hist = at_counters + kReindexCounters;
  const long long at_status = at_hist + kRadixPasses * kRadixBins;
  *words = at_status + kRadixPasses * sc.n_tiles * kRadixBins;
  if (base != nullptr) {
    int32_t* p = static_cast<int32_t*>(base);
    sc.table = p;
    sc.lists[0] = p + at_lists;
    sc.lists[1] = p + at_lists + n_nbr;
    sc.seed_tiles = p + at_seed_tiles;
    sc.counters = p + at_counters;
    sc.hist = p + at_hist;
    sc.status = reinterpret_cast<uint32_t*>(p + at_status);
  }
  return sc;
}

__device__ __forceinline__ uint32_t qt_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// slot of v in the table (v must have been inserted)
__device__ __forceinline__ long long qt_find(const int32_t* table, long long mask, int32_t v) {
  long long h = qt_hash(static_cast<uint32_t>(v)) & mask;
  while (table[2 * h] != v) h = (h + 1) & mask;
  return h;
}

__device__ __forceinline__ uint32_t radix_digit(int32_t v, int pass) {
  return ((static_cast<uint32_t>(v) ^ 0x80000000u) >> (8 * pass)) & (kRadixBins - 1);
}

__device__ __forceinline__ void qt_cmp_swap(int32_t* a, int i, int p, bool asc) {
  const int32_t x = a[i], y = a[p];
  if ((x > y) == asc) {
    a[i] = y;
    a[p] = x;
  }
}

// the whole call in one block of kReindexTile threads (W <= kSmallSlots)
__global__ void reindex_small_kernel(const int32_t* seeds, const bool* seed_valid,
                                     const int32_t* nbrs, const bool* nbr_valid, int32_t S,
                                     int32_t n_nbr, int32_t* n_id, int32_t* count_out,
                                     int32_t* local_seeds, int32_t* local_nbrs) {
  __shared__ int32_t table[2 * kSmallTable];  // key, first position (then -1 - rank)
  __shared__ int32_t list[kSmallSlots];
  __shared__ int32_t n_new_s;
  const int W = S + n_nbr;
  int H = 2;
  while (H < 2 * W) H <<= 1;
  const long long mask = H - 1;
  for (int t = threadIdx.x; t < 2 * H; t += blockDim.x) table[t] = QT_SENTINEL;
  if (threadIdx.x == 0) n_new_s = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    const bool seed = e < S;
    if (!(seed ? seed_valid[e] : nbr_valid[e - S])) continue;
    const int32_t v = seed ? seeds[e] : nbrs[e - S];
    long long h = qt_hash(static_cast<uint32_t>(v)) & mask;
    while (true) {
      const int32_t prev = atomicCAS(&table[2 * h], QT_SENTINEL, v);
      if (prev == QT_SENTINEL || prev == v) {
        atomicMin(&table[2 * h + 1], e);
        break;
      }
      h = (h + 1) & mask;
    }
  }
  __syncthreads();
  int32_t n_seed = 0;  // the seeds' slots, 1,024 at a time
  for (int base = 0; base < S; base += kReindexTile) {
    const int e = base + threadIdx.x;
    const int32_t flag = e < S && seed_valid[e] ? 1 : 0;
    int32_t total;
    const int32_t slot = n_seed + qt_block_exclusive_scan(flag, &total);
    if (e < S) {
      local_seeds[e] = flag ? slot : -1;
      if (flag) n_id[slot] = seeds[e];
    }
    n_seed += total;
  }
  for (int q = threadIdx.x; q < n_nbr; q += blockDim.x) {
    if (!nbr_valid[q]) continue;
    const int32_t v = nbrs[q];
    if (table[2 * qt_find(table, mask, v) + 1] == S + q) list[atomicAdd(&n_new_s, 1)] = v;
  }
  __syncthreads();
  const int n_new = n_new_s;
  int P = 1;
  while (P < n_new) P <<= 1;
  for (int t = n_new + threadIdx.x; t < P; t += blockDim.x) list[t] = QT_SENTINEL;
  __syncthreads();
  for (int kk = 2; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        qt_cmp_swap(list, i, i + j, (i & kk) == 0);
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < n_new; r += blockDim.x) {
    const int32_t v = list[r];
    table[2 * qt_find(table, mask, v) + 1] = -1 - r;
    n_id[n_seed + r] = v;
  }
  __syncthreads();  // the ranks, and the seeds' slots in local_seeds, are in place
  const int count = n_seed + n_new;
  if (threadIdx.x == 0) *count_out = count;
  for (int t = count + threadIdx.x; t < W; t += blockDim.x) n_id[t] = QT_SENTINEL;
  for (int q = threadIdx.x; q < n_nbr; q += blockDim.x) {
    if (!nbr_valid[q]) {
      local_nbrs[q] = 0;
      continue;
    }
    const int32_t fp = table[2 * qt_find(table, mask, nbrs[q]) + 1];
    local_nbrs[q] = fp < 0 ? n_seed + (-1 - fp) : local_seeds[fp];
  }
}

__global__ void init_kernel(ReindexScratch sc) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t < 2 * sc.H) sc.table[t] = QT_SENTINEL;
  if (t < kRadixPasses * sc.n_tiles * kRadixBins) sc.status[t] = 0;
  if (t < kRadixPasses * kRadixBins) sc.hist[t] = 0;
  if (t < kReindexCounters) sc.counters[t] = 0;
}

// a thread a slot of the S seeds and S*k neighbors; block b < seed tiles
// also counts the valid seeds of tile b
__global__ void insert_kernel(ReindexScratch sc, const int32_t* seeds, const bool* seed_valid,
                              const int32_t* nbrs, const bool* nbr_valid, int32_t S,
                              long long W) {
  const long long e = blockIdx.x * static_cast<long long>(kReindexTile) + threadIdx.x;
  const bool seed = e < S && seed_valid[e];
  if (blockIdx.x * static_cast<long long>(kReindexTile) < S) {  // block-uniform
    const int n = __syncthreads_count(seed);
    if (threadIdx.x == 0) sc.seed_tiles[blockIdx.x] = n;
  }
  if (!seed && (e < S || e >= W || !nbr_valid[e - S])) return;
  const int32_t v = seed ? seeds[e] : nbrs[e - S];
  const long long mask = sc.H - 1;
  long long h = qt_hash(static_cast<uint32_t>(v)) & mask;
  while (true) {
    const int32_t prev = atomicCAS(&sc.table[2 * h], QT_SENTINEL, v);
    if (prev == QT_SENTINEL || prev == v) {
      atomicMin(&sc.table[2 * h + 1], static_cast<int32_t>(e));
      return;
    }
    h = (h + 1) & mask;
  }
}

// seed tile b: slots by the tiles' counts and a block scan; neighbor lanes
// of block b: the new uniques appended, their digits counted
__global__ void mark_kernel(ReindexScratch sc, const int32_t* seeds, const bool* seed_valid,
                            const int32_t* nbrs, const bool* nbr_valid, int32_t S,
                            long long n_nbr, int32_t* local_seeds, int32_t* n_id) {
  __shared__ int32_t block_hist[kRadixPasses * kRadixBins];
  const int lane = threadIdx.x & 31;
  const long long base = blockIdx.x * static_cast<long long>(kReindexTile);
  for (int t = threadIdx.x; t < kRadixPasses * kRadixBins; t += blockDim.x) block_hist[t] = 0;
  __syncthreads();
  if (base < S) {  // block-uniform
    const long long n_tiles = (static_cast<long long>(S) + kReindexTile - 1) / kReindexTile;
    int32_t part = 0;
    for (long long t = threadIdx.x; t < blockIdx.x; t += blockDim.x) part += sc.seed_tiles[t];
    int32_t prefix;
    qt_block_exclusive_scan(part, &prefix);
    const long long e = base + threadIdx.x;
    const int32_t flag = e < S && seed_valid[e] ? 1 : 0;
    int32_t tile_total;
    const int32_t slot = prefix + qt_block_exclusive_scan(flag, &tile_total);
    if (e < S) {
      local_seeds[e] = flag ? slot : -1;
      if (flag) n_id[slot] = seeds[e];
    }
    if (blockIdx.x == n_tiles - 1 && threadIdx.x == 0) sc.counters[0] = prefix + tile_total;
  }
  const long long q = base + threadIdx.x;
  bool fresh = false;
  int32_t v = 0;
  if (q < n_nbr && nbr_valid[q]) {
    v = nbrs[q];
    fresh = sc.table[2 * qt_find(sc.table, sc.H - 1, v) + 1] == static_cast<int32_t>(S + q);
  }
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, fresh);
  if (ballot != 0) {  // warp-uniform
    int32_t at = 0;
    if (lane == __ffs(ballot) - 1) at = atomicAdd(&sc.counters[1], __popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, __ffs(ballot) - 1);
    if (fresh) sc.lists[0][at + __popc(ballot & ((1u << lane) - 1))] = v;
#pragma unroll
    for (int pass = 0; pass < kRadixPasses; ++pass) {
      const uint32_t d = radix_digit(v, pass);
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, fresh ? d : 0xFFFFFFFFu);
      if (fresh && lane == __ffs(peers) - 1) {
        atomicAdd(&block_hist[pass * kRadixBins + d], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kRadixPasses * kRadixBins; t += blockDim.x) {
    if (block_hist[t] != 0) atomicAdd(&sc.hist[t], block_hist[t]);
  }
}

// one stable 8-bit digit pass over the live list, lists[pass & 1] into the
// other; the last pass also places each unique in n_id and its rank in
// the table
__global__ void radix_pass_kernel(ReindexScratch sc, int pass, int32_t* n_id) {
  __shared__ int32_t warp_hist[kReindexTile / 32][kRadixBins];
  __shared__ int32_t digit_base[kRadixBins];
  __shared__ long long tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = atomicAdd(&sc.counters[2 + pass], 1);
  for (int t = threadIdx.x; t < (kReindexTile / 32) * kRadixBins; t += blockDim.x) {
    warp_hist[t / kRadixBins][t % kRadixBins] = 0;
  }
  __syncthreads();
  const long long tile = tile_s;
  const long long n = sc.counters[1];
  if (tile * kReindexTile >= n) return;  // block-uniform: past the live uniques
  const int32_t* in = sc.lists[pass & 1];
  int32_t* out = sc.lists[(pass + 1) & 1];
  const long long i = tile * kReindexTile + threadIdx.x;
  const bool live = i < n;
  const int32_t v = live ? in[i] : 0;
  const uint32_t d = radix_digit(v, pass);
  // rank within the warp among equal digits, in lane order
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, live ? d : 0xFFFFFFFFu);
  const int in_warp = __popc(peers & ((1u << lane) - 1));
  if (live && lane == __ffs(peers) - 1) warp_hist[warp][d] = __popc(peers);
  __syncthreads();
  // thread d: each warp's offset for digit d in the tile, the tile's count
  int32_t count = 0;
  uint32_t* status = sc.status + (static_cast<long long>(pass) * sc.n_tiles) * kRadixBins;
  if (threadIdx.x < kRadixBins) {
    for (int w = 0; w < kReindexTile / 32; ++w) {
      const int32_t c = warp_hist[w][threadIdx.x];
      warp_hist[w][threadIdx.x] = count;
      count += c;
    }
    volatile uint32_t* mine = status + tile * kRadixBins + threadIdx.x;
    *mine = (tile == 0 ? kPrefix : kAggregate) | static_cast<uint32_t>(count);
  }
  int32_t n_total;
  const int32_t global = qt_block_exclusive_scan(
      threadIdx.x < kRadixBins ? sc.hist[pass * kRadixBins + threadIdx.x] : 0, &n_total);
  if (threadIdx.x < kRadixBins) {
    uint32_t before = 0;  // digit d's elements in the tiles before this one
    for (long long j = tile - 1; j >= 0; --j) {
      volatile const uint32_t* theirs = status + j * kRadixBins + threadIdx.x;
      uint32_t s;
      do {
        s = *theirs;
      } while ((s & ~kValueMask) == 0);
      before += s & kValueMask;
      if (s & kPrefix) break;
    }
    if (tile > 0) {
      volatile uint32_t* mine = status + tile * kRadixBins + threadIdx.x;
      *mine = kPrefix | (before + static_cast<uint32_t>(count));
    }
    digit_base[threadIdx.x] = global + static_cast<int32_t>(before);
  }
  __syncthreads();
  if (!live) return;
  const int32_t pos = digit_base[d] + warp_hist[warp][d] + in_warp;
  out[pos] = v;
  if (pass == kRadixPasses - 1) {
    sc.table[2 * qt_find(sc.table, sc.H - 1, v) + 1] = -1 - pos;
    n_id[sc.counters[0] + pos] = v;
  }
}

__global__ void rewrite_kernel(ReindexScratch sc, const int32_t* nbrs, const bool* nbr_valid,
                               long long n_nbr, long long W, const int32_t* local_seeds,
                               int32_t* n_id, int32_t* count_out, int32_t* local_nbrs) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int32_t n_seed = sc.counters[0];
  const long long count = static_cast<long long>(n_seed) + sc.counters[1];
  if (t == 0) *count_out = static_cast<int32_t>(count);
  if (t >= count && t < W) n_id[t] = QT_SENTINEL;
  if (t >= n_nbr) return;
  if (!nbr_valid[t]) {
    local_nbrs[t] = 0;
    return;
  }
  const int32_t fp = sc.table[2 * qt_find(sc.table, sc.H - 1, nbrs[t]) + 1];
  local_nbrs[t] = fp < 0 ? n_seed + (-1 - fp) : local_seeds[fp];
}

// the int32 words of scratch qt_local_reindex takes at S seeds and k lanes
QT_EXPORT int qt_local_reindex_scratch(int S, int k, long long* words) {
  reindex_layout(nullptr, S, k, words);
  return 0;
}

QT_EXPORT int qt_local_reindex(const void* seeds, const void* seed_valid, const void* nbrs,
                               const void* nbr_valid, int S, int k, void* scratch,
                               long long scratch_words, void* n_id, void* count_out,
                               void* local_seeds, void* local_nbrs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  const long long n_nbr = static_cast<long long>(S) * k;
  const long long W = S + n_nbr;
  long long words;
  const ReindexScratch sc = reindex_layout(scratch, S, k, &words);
  if (k < 0 || W >= kAggregate || scratch_words < words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  const bool* sv = static_cast<const bool*>(seed_valid);
  const int32_t* nb = static_cast<const int32_t*>(nbrs);
  const bool* nv = static_cast<const bool*>(nbr_valid);
  int32_t* nid = static_cast<int32_t*>(n_id);
  int32_t* ls = static_cast<int32_t*>(local_seeds);
  if (W <= kSmallSlots) {
    qt_count_launch();
    reindex_small_kernel<<<1, kReindexTile, 0, st>>>(
        sd, sv, nb, nv, S, static_cast<int32_t>(n_nbr), nid, static_cast<int32_t*>(count_out),
        ls, static_cast<int32_t*>(local_nbrs));
    return qt_launch_status();
  }
  const int T = 256;
  int rc;

  long long n_init = 2 * sc.H;
  const long long n_status = kRadixPasses * sc.n_tiles * kRadixBins;
  n_init = n_init > n_status ? n_init : n_status;
  n_init = n_init > kRadixPasses * kRadixBins ? n_init : kRadixPasses * kRadixBins;
  qt_count_launch();
  init_kernel<<<qt_blocks(n_init, T), T, 0, st>>>(sc);
  if ((rc = qt_launch_status())) return rc;
  qt_count_launch();
  insert_kernel<<<qt_blocks(W, kReindexTile), kReindexTile, 0, st>>>(sc, sd, sv, nb, nv, S, W);
  if ((rc = qt_launch_status())) return rc;
  const long long n_mark = n_nbr > S ? n_nbr : S;
  qt_count_launch();
  mark_kernel<<<qt_blocks(n_mark, kReindexTile), kReindexTile, 0, st>>>(sc, sd, sv, nb, nv, S,
                                                                        n_nbr, ls, nid);
  if ((rc = qt_launch_status())) return rc;
  if (n_nbr > 0) {
    for (int pass = 0; pass < kRadixPasses; ++pass) {
      qt_count_launch();
      radix_pass_kernel<<<static_cast<unsigned>(sc.n_tiles), kReindexTile, 0, st>>>(sc, pass,
                                                                                    nid);
      if ((rc = qt_launch_status())) return rc;
    }
  }
  qt_count_launch();
  rewrite_kernel<<<qt_blocks(W, T), T, 0, st>>>(sc, nb, nv, n_nbr, W, ls, nid,
                                                 static_cast<int32_t*>(count_out),
                                                 static_cast<int32_t*>(local_nbrs));
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
