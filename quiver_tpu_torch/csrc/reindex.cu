// K2: local_reindex — dedup of seeds and sampled neighbors plus the
// rewrite of every neighbor to its canonical local id.
//
// Replaces quiver_tpu/ops/reindex.py:local_reindex (blocked_cumsum,
// propagate_group_start and the _sort3/_sort2 passes). The contract
// (reindex.py:9-22): n_id holds the valid seeds verbatim in slot order
// (duplicates keep their own slots), then the neighbor values no valid
// seed holds, once each, ascending; sentinel INT32_MAX pads the rest.
// count = valid seeds + new uniques. A valid neighbor maps to the slot of
// the FIRST seed holding its value, else to n_seed + its rank among the
// new uniques. Invalid neighbor lanes are written 0 (nothing reads them).
//
// Design (the host engine's qt_reindex route, not the JAX three-sort
// design): an open-addressing hash table in wrapper-allocated scratch
// (atomicCAS on the key, atomicMin on the first flat position, seeds at
// positions 0..S-1 so a seed always beats a neighbor) decides membership;
// a neighbor lane that is its value's first position and no seed holds
// the value appends the value to a list; only that list is sorted, by a
// bitonic sort written here; the sorted position is the rank. The hash
// decides membership only and the order comes from the sort, so the
// result is the same from run to run.
//
// Bound on the card: launches, not bytes. The inputs are at most ~70k
// ids (a few hundred KB), while the bitonic sort over the padded list
// (next power of two of S*k, at least 2048) takes one launch per merge
// stride above 2048 plus one shared-memory pass per stage: 21 sort
// launches at S*k = 56,320, about 27 launches per call. The design keeps
// every stride <= 1024 inside shared memory to hold the count down.

#include "common.cuh"

#define QT_SENTINEL 0x7FFFFFFF
#define QT_SORT_CHUNK 2048  // elements a block sorts in shared memory

__device__ __forceinline__ uint32_t qt_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// slot of v in the table (v must have been inserted)
__device__ __forceinline__ long long qt_find(const int32_t* keys, long long mask, int32_t v) {
  long long h = qt_hash(static_cast<uint32_t>(v)) & mask;
  while (keys[h] != v) h = (h + 1) & mask;
  return h;
}

__global__ void init_kernel(int32_t* keys, int32_t* first, long long H, int32_t* n_id,
                            long long W, int32_t* uniq, long long P, int32_t* counters) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t < H) {
    keys[t] = QT_SENTINEL;
    first[t] = QT_SENTINEL;
  }
  if (t < W) n_id[t] = QT_SENTINEL;
  if (t < P) uniq[t] = QT_SENTINEL;
  if (t < 2) counters[t] = 0;
}

// one block: seed slots by an exclusive scan over seed_valid, seeds into
// their n_id slots, counters[0] = n_seed
__global__ void seed_scan_kernel(const int32_t* seeds, const bool* seed_valid, int32_t S,
                                 int32_t* local_seeds, int32_t* n_id, int32_t* counters) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int32_t base = 0; base < S; base += blockDim.x) {
    const int32_t i = base + threadIdx.x;
    const int32_t v = (i < S && seed_valid[i]) ? 1 : 0;
    int32_t x = v;  // inclusive warp scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      int32_t w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < nw) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int32_t before = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < S) {
      local_seeds[i] = v ? before : -1;
      if (v) n_id[before] = seeds[i];
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) counters[0] = carry;
}

__global__ void insert_kernel(const int32_t* seeds, const bool* seed_valid, const int32_t* nbrs,
                              const bool* nbr_valid, int32_t S, long long n_all,
                              int32_t* keys, int32_t* first, long long mask) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= n_all) return;
  int32_t v;
  if (e < S) {
    if (!seed_valid[e]) return;
    v = seeds[e];
  } else {
    if (!nbr_valid[e - S]) return;
    v = nbrs[e - S];
  }
  long long h = qt_hash(static_cast<uint32_t>(v)) & mask;
  while (true) {
    const int32_t prev = atomicCAS(&keys[h], QT_SENTINEL, v);
    if (prev == QT_SENTINEL || prev == v) {
      atomicMin(&first[h], static_cast<int32_t>(e));
      return;
    }
    h = (h + 1) & mask;
  }
}

// a valid neighbor lane that is its value's first position (no seed holds
// the value, or the seed would own a smaller position) appends the value
__global__ void mark_new_kernel(const int32_t* nbrs, const bool* nbr_valid, int32_t S,
                                long long n_nbr, const int32_t* keys, const int32_t* first,
                                long long mask, int32_t* uniq, int32_t* counters) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_nbr || !nbr_valid[q]) return;
  const int32_t v = nbrs[q];
  const long long h = qt_find(keys, mask, v);
  if (first[h] == static_cast<int32_t>(S + q)) uniq[atomicAdd(&counters[1], 1)] = v;
}

__device__ __forceinline__ void qt_cmp_swap(int32_t* a, int i, int p, bool asc) {
  const int32_t x = a[i], y = a[p];
  if ((x > y) == asc) {
    a[i] = y;
    a[p] = x;
  }
}

// stages 2..chunk of the bitonic sort, in shared memory, one chunk a block
__global__ void bitonic_chunk_sort(int32_t* data, int chunk) {
  extern __shared__ int32_t s[];
  const long long off = static_cast<long long>(blockIdx.x) * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) s[t] = data[off + t];
  __syncthreads();
  for (int kk = 2; kk <= chunk; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        qt_cmp_swap(s, i, i + j, ((off + i) & kk) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) data[off + t] = s[t];
}

// strides chunk/2..1 of stage kk, in shared memory
__global__ void bitonic_chunk_merge(int32_t* data, int chunk, long long kk) {
  extern __shared__ int32_t s[];
  const long long off = static_cast<long long>(blockIdx.x) * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) s[t] = data[off + t];
  __syncthreads();
  for (int j = chunk >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
      const int i = 2 * j * (t / j) + (t % j);
      qt_cmp_swap(s, i, i + j, ((off + i) & kk) == 0);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) data[off + t] = s[t];
}

// one stride j >= chunk of stage kk, over the whole array
__global__ void bitonic_global_step(int32_t* data, long long half, long long j, long long kk) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= half) return;
  const long long i = 2 * j * (t / j) + (t % j);
  const long long p = i + j;
  const int32_t x = data[i], y = data[p];
  if ((x > y) == ((i & kk) == 0)) {
    data[i] = y;
    data[p] = x;
  }
}

// rank of each new unique = its sorted position; n_id tail; count
__global__ void assign_kernel(const int32_t* uniq, long long P, const int32_t* keys,
                              long long mask, int32_t* rank, int32_t* n_id,
                              const int32_t* counters, int32_t* count_out) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int32_t n_seed = counters[0], n_new = counters[1];
  if (r == 0) *count_out = n_seed + n_new;
  if (r >= P || r >= n_new) return;
  const int32_t v = uniq[r];
  rank[qt_find(keys, mask, v)] = static_cast<int32_t>(r);
  n_id[n_seed + r] = v;
}

__global__ void rewrite_kernel(const int32_t* nbrs, const bool* nbr_valid, int32_t S,
                               long long n_nbr, const int32_t* keys, const int32_t* first,
                               const int32_t* rank, long long mask, const int32_t* local_seeds,
                               const int32_t* counters, int32_t* local_nbrs) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_nbr) return;
  if (!nbr_valid[q]) {
    local_nbrs[q] = 0;
    return;
  }
  const long long h = qt_find(keys, mask, nbrs[q]);
  const int32_t fp = first[h];
  local_nbrs[q] = fp < S ? local_seeds[fp] : counters[0] + rank[h];
}

// scratch (int32): keys[H], first[H], rank[H], uniq[P], counters[2]
QT_EXPORT int qt_local_reindex(const void* seeds, const void* seed_valid, const void* nbrs,
                               const void* nbr_valid, int S, int k, void* scratch,
                               long long H, void* uniq_buf, long long P, void* n_id,
                               void* count_out, void* local_seeds, void* local_nbrs,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  if ((H & (H - 1)) != 0 || (P & (P - 1)) != 0 || P < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* keys = static_cast<int32_t*>(scratch);
  int32_t* first = keys + H;
  int32_t* rank = first + H;
  int32_t* counters = rank + H;
  int32_t* uniq = static_cast<int32_t*>(uniq_buf);
  const long long n_nbr = static_cast<long long>(S) * k;
  const long long W = S + n_nbr;
  const long long mask = H - 1;
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  const bool* sv = static_cast<const bool*>(seed_valid);
  const int32_t* nb = static_cast<const int32_t*>(nbrs);
  const bool* nv = static_cast<const bool*>(nbr_valid);
  int32_t* nid = static_cast<int32_t*>(n_id);
  int32_t* ls = static_cast<int32_t*>(local_seeds);
  const int T = 256;
  int rc;

  long long n_init = H > W ? H : W;
  n_init = n_init > P ? n_init : P;
  init_kernel<<<qt_blocks(n_init, T), T, 0, st>>>(keys, first, H, nid, W, uniq, P, counters);
  if ((rc = qt_launch_status())) return rc;
  seed_scan_kernel<<<1, 1024, 0, st>>>(sd, sv, S, ls, nid, counters);
  if ((rc = qt_launch_status())) return rc;
  insert_kernel<<<qt_blocks(W, T), T, 0, st>>>(sd, sv, nb, nv, S, W, keys, first, mask);
  if ((rc = qt_launch_status())) return rc;
  if (n_nbr > 0) {
    mark_new_kernel<<<qt_blocks(n_nbr, T), T, 0, st>>>(nb, nv, S, n_nbr, keys, first, mask,
                                                       uniq, counters);
    if ((rc = qt_launch_status())) return rc;
  }

  const int chunk = P < QT_SORT_CHUNK ? static_cast<int>(P) : QT_SORT_CHUNK;
  const unsigned n_chunks = static_cast<unsigned>(P / chunk);
  const int st_threads = chunk / 2 < 1024 ? chunk / 2 : 1024;
  const size_t smem = static_cast<size_t>(chunk) * sizeof(int32_t);
  bitonic_chunk_sort<<<n_chunks, st_threads, smem, st>>>(uniq, chunk);
  if ((rc = qt_launch_status())) return rc;
  for (long long kk = 2LL * chunk; kk <= P; kk <<= 1) {
    for (long long j = kk >> 1; j >= chunk; j >>= 1) {
      bitonic_global_step<<<qt_blocks(P / 2, T), T, 0, st>>>(uniq, P / 2, j, kk);
      if ((rc = qt_launch_status())) return rc;
    }
    bitonic_chunk_merge<<<n_chunks, st_threads, smem, st>>>(uniq, chunk, kk);
    if ((rc = qt_launch_status())) return rc;
  }

  assign_kernel<<<qt_blocks(P, T), T, 0, st>>>(uniq, P, keys, mask, rank, nid, counters,
                                               static_cast<int32_t*>(count_out));
  if ((rc = qt_launch_status())) return rc;
  if (n_nbr > 0) {
    rewrite_kernel<<<qt_blocks(n_nbr, T), T, 0, st>>>(nb, nv, S, n_nbr, keys, first, rank,
                                                      mask, ls, counters,
                                                      static_cast<int32_t*>(local_nbrs));
    if ((rc = qt_launch_status())) return rc;
  }
  return 0;
}

QT_DEFINE_ERROR_STRING
