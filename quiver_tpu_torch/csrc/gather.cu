// K3: gather_rows — feature row gather with clipped ids, optionally
// through an [N] index map.
//
// Replaces quiver_tpu/feature.py:_padded_gather and
// _padded_gather_ordered, the in-program gather of
// quiver_tpu/inference.py:make_serve_step (ids -> clip(0, n-1) ->
// [index_map -> clip(0, R-1)] -> table row) and
// quiver_tpu/shard_tensor.py:_gather_local, which shares the kernel. The
// rows are copied, so the result is bit-equal.
//
// Bound on the card: bytes — each output row is one table row read and
// written once (400 B at D = 100 float32) plus a 4-byte id. Design: one
// warp per row copies with 16-byte vector loads and stores where the
// row width and both base pointers allow it (D % 4 == 0), so a warp moves
// a 400-byte row in one coalesced sweep and many rows are in flight.

#include <cooperative_groups.h>
#include <initializer_list>

#include "common.cuh"

__global__ void gather_rows_kernel(const float* __restrict__ table, long long R, int D,
                                   const int32_t* __restrict__ ids, long long n_ids,
                                   long long n_clip, const int32_t* __restrict__ imap,
                                   bool vec4, float* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_ids) return;
  long long id = qt_clamp<long long>(ids[row], 0, n_clip - 1);
  if (imap != nullptr) id = qt_clamp<long long>(imap[id], 0, R - 1);
  const float* src = table + id * D;
  float* dst = out + row * D;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < D / 4; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < D; c += 32) dst[c] = __ldg(src + c);
  }
}

QT_EXPORT int qt_gather_rows(const void* table, long long R, int D, const void* ids,
                             long long n_ids, long long n_clip, const void* imap, void* out,
                             void* stream) {
  if (n_ids <= 0 || D <= 0) return 0;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;  // 8 rows a block
  qt_count_launch();
  gather_rows_kernel<<<qt_blocks(n_ids * 32, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), R, D, static_cast<const int32_t*>(ids), n_ids,
      n_clip, static_cast<const int32_t*>(imap), vec4, static_cast<float*>(out));
  return qt_launch_status();
}

// K3t: tiered_gather — feature row gather across the two tiers of a
// ShardTensor, in one launch.
//
// Replaces quiver_tpu/shard_tensor.py:ShardTensor.__getitem__ (the
// per-tier _gather_local, the host-side gather and the _scatter_rows
// merges) behind quiver_tpu/feature.py:Feature.__getitem__ and
// Feature.gather_stored. For output row r with id = ids[r]: ids outside
// [0, n_valid) give a zero row; else the stored row is s = order[id] (id
// itself without an order), read from the device shard when s < H and from
// the host tail when H <= s < H + n_host (any other s gives a zero row, as
// a row no shard owns does in the reference). Rows are copied as bytes, so
// one kernel serves every stored dtype (float32, and the int8 and bfloat16
// rows of a quantized store) and the result is bit-equal.
//
// Bound on the card: bytes — each output row is one stored row read and
// written once (400 B at D = 100 float32, 200 B bfloat16, 100 B int8); the
// host-tail rows cross PCIe, whose rate (tens of GB/s, not 3.35 TB/s) sets
// the time whenever a few percent of the rows are cold. Design: the host
// tail is pinned host memory read in-kernel through its mapped device
// pointer (UVA zero-copy, as the reference's shard_tensor.cu.hpp did), so
// there is no staging copy and no scatter; one warp per row copies with the
// widest access (16, 8, 4, 2 or 1 bytes) that divides the row's byte width
// and every base pointer, so a row is read in whole sectors and many rows
// are in flight to hide the link's latency. A disk tier's rows cannot be
// read in-kernel: the host reads them into a pinned staging buffer that
// is copied to the card, and the same call then scatters them into their
// output rows with K5's scatter (below), in stream order after the
// gather, which wrote zero rows there.

template <int V> struct Bytes;
template <> struct Bytes<16> { using T = uint4; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<4> { using T = uint32_t; };
template <> struct Bytes<2> { using T = uint16_t; };
template <> struct Bytes<1> { using T = uint8_t; };

// The widest access (16, 8, 4, 2 or 1 bytes) that divides the row's byte
// width and every base pointer given.
static int qt_vec_bytes(long long row_bytes, std::initializer_list<const void*> ptrs) {
  for (int v = 16; v > 1; v >>= 1) {
    bool ok = row_bytes % v == 0;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % v == 0;
    if (ok) return v;
  }
  return 1;
}

template <int V>
__global__ void tiered_gather_kernel(const char* __restrict__ dev_rows, long long H,
                                     const char* host_rows, long long n_host,
                                     long long row_bytes, const int32_t* __restrict__ ids,
                                     long long n_ids, long long n_valid,
                                     const int32_t* __restrict__ order, char* __restrict__ out) {
  using T = typename Bytes<V>::T;
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_ids) return;
  const long long id = ids[row];
  long long s = -1;
  if (id >= 0 && id < n_valid) s = order != nullptr ? static_cast<long long>(order[id]) : id;
  const T* src = nullptr;
  if (s >= 0 && s < H) {
    src = reinterpret_cast<const T*>(dev_rows + s * row_bytes);
  } else if (s >= H && s < H + n_host) {
    src = reinterpret_cast<const T*>(host_rows + (s - H) * row_bytes);  // over the link
  }
  T* dst = reinterpret_cast<T*>(out + row * row_bytes);
  const long long n_vec = row_bytes / V;
  for (long long c = lane; c < n_vec; c += 32) dst[c] = src != nullptr ? src[c] : T{};
}

template <int V>
static void launch_tiered_gather(const void* dev_rows, long long H, const void* host_rows,
                                 long long n_host, long long row_bytes, const void* ids,
                                 long long n_ids, long long n_valid, const void* order,
                                 void* out, cudaStream_t stream) {
  const int threads = 256;  // 8 rows a block
  qt_count_launch();
  tiered_gather_kernel<V><<<qt_blocks(n_ids * 32, threads), threads, 0, stream>>>(
      static_cast<const char*>(dev_rows), H, static_cast<const char*>(host_rows), n_host,
      row_bytes, static_cast<const int32_t*>(ids), n_ids, n_valid,
      static_cast<const int32_t*>(order), static_cast<char*>(out));
}

static void tiered_gather_any(const void* dev_rows, long long H, const void* host_rows,
                              long long n_host, long long row_bytes, const void* ids,
                              long long n_ids, long long n_valid, const void* order, void* out,
                              cudaStream_t stream) {
  switch (qt_vec_bytes(row_bytes, {dev_rows, host_rows, out})) {
    case 16: launch_tiered_gather<16>(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids,
                                      n_valid, order, out, stream); break;
    case 8: launch_tiered_gather<8>(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids,
                                    n_valid, order, out, stream); break;
    case 4: launch_tiered_gather<4>(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids,
                                    n_valid, order, out, stream); break;
    case 2: launch_tiered_gather<2>(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids,
                                    n_valid, order, out, stream); break;
    default: launch_tiered_gather<1>(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids,
                                     n_valid, order, out, stream); break;
  }
}

// `disk_rows` ([n_disk, row_bytes] on the card, or null) are staged disk
// rows; row i lands in output row disk_pos[i] (int32; n_ids pads) after
// the gather.
template <typename P>
static int scatter_rows_any(const void* rows, long long n_rows, long long row_bytes,
                            const void* pos, long long W, void* out, cudaStream_t s);

QT_EXPORT int qt_tiered_gather(const void* dev_rows, long long H, const void* host_rows,
                               long long n_host, int row_bytes, const void* ids, long long n_ids,
                               long long n_valid, const void* order, const void* disk_rows,
                               long long n_disk, const void* disk_pos, void* out,
                               void* stream) {
  if (n_ids <= 0 || row_bytes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiered_gather_any(dev_rows, H, host_rows, n_host, row_bytes, ids, n_ids, n_valid, order, out,
                    s);
  const int rc = qt_launch_status();
  if (rc != 0) return rc;
  return scatter_rows_any<int32_t>(disk_rows, n_disk, row_bytes, disk_pos, n_ids, out, s);
}

// K5: tiered_lookup — the staged pipeline's feature assembly.
//
// Replaces quiver_tpu/pipeline.py:tiered_lookup: out[r] is hot[mapped[r]]
// where 0 <= mapped[r] < H and zero elsewhere, then each staged cold row i
// lands in slot cold_pos[i] (positions outside [0, W) are the bucket's
// padding and are dropped; the pipeline's positions are unique). The
// reference computes the zero as hot[clip(mapped)] * 0, a signed zero (or
// NaN under a non-finite row); the kernel writes +0.0 without reading the
// row, equal as a value for every finite table.
//
// Bound on the card: bytes — W ids read, the hot lanes' rows read, W rows
// written, and the C_b cold rows and positions read and their rows written.
// Design: two launches in stream order, so a cold slot's zero fill can never
// race its cold write: the fill is K3t's copy kernel over the hot table
// alone (n_valid = H, no order, no host tail), then one warp a cold row
// copies it into its slot with the same widest access.

template <int V, typename P>
__global__ void scatter_rows_kernel(const char* __restrict__ rows, long long n_rows,
                                    long long row_bytes, const P* __restrict__ pos,
                                    long long W, char* __restrict__ out) {
  using T = typename Bytes<V>::T;
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_rows) return;
  const long long p = pos[i];
  if (p < 0 || p >= W) return;
  const T* src = reinterpret_cast<const T*>(rows + i * row_bytes);
  T* dst = reinterpret_cast<T*>(out + p * row_bytes);
  const long long n_vec = row_bytes / V;
  for (long long c = lane; c < n_vec; c += 32) dst[c] = src[c];
}

template <int V, typename P>
static void launch_scatter_rows(const void* rows, long long n_rows, long long row_bytes,
                                const void* pos, long long W, void* out, cudaStream_t stream) {
  const int threads = 256;
  qt_count_launch();
  scatter_rows_kernel<V, P><<<qt_blocks(n_rows * 32, threads), threads, 0, stream>>>(
      static_cast<const char*>(rows), n_rows, row_bytes, static_cast<const P*>(pos), W,
      static_cast<char*>(out));
}

// out[pos[i]] = rows[i] for the n_rows rows whose position lies in [0, W),
// with the widest access the row width and both base pointers allow.
template <typename P>
static int scatter_rows_any(const void* rows, long long n_rows, long long row_bytes,
                            const void* pos, long long W, void* out, cudaStream_t s) {
  if (n_rows <= 0) return 0;
  switch (qt_vec_bytes(row_bytes, {rows, out})) {
    case 16: launch_scatter_rows<16, P>(rows, n_rows, row_bytes, pos, W, out, s); break;
    case 8: launch_scatter_rows<8, P>(rows, n_rows, row_bytes, pos, W, out, s); break;
    case 4: launch_scatter_rows<4, P>(rows, n_rows, row_bytes, pos, W, out, s); break;
    case 2: launch_scatter_rows<2, P>(rows, n_rows, row_bytes, pos, W, out, s); break;
    default: launch_scatter_rows<1, P>(rows, n_rows, row_bytes, pos, W, out, s); break;
  }
  return qt_launch_status();
}

QT_EXPORT int qt_tiered_lookup(const void* hot, long long H, int row_bytes, const void* mapped,
                               long long W, const void* cold, long long C, const void* pos,
                               void* out, void* stream) {
  if (W <= 0 || row_bytes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiered_gather_any(hot, H, nullptr, 0, row_bytes, mapped, W, H, nullptr, out, s);
  const int rc = qt_launch_status();
  if (rc != 0) return rc;
  return scatter_rows_any<int32_t>(cold, C, row_bytes, pos, W, out, s);
}

// K6: set_rows — the bounded row scatter of a placement batch.
//
// Replaces quiver_tpu/tiers.py:_set_rows (table.at[slots].set(rows,
// mode="drop")), TierStore.apply's promotion of rows into HBM slots: row i
// lands in slot slots[i] (int64) of the [H, D] table; slots outside
// [0, H) are the bucket's padding and are dropped; a slot given twice takes
// the later i, as a sequential scatter does. Rows are copied as bytes
// (float32, bfloat16 or int8 stores), so the result is bit-equal.
// B1: the same body replaces quiver_tpu/shard_tensor.py:_scatter_rows on
// a streaming graph's commit (stream.py's _swap_rows): the int32 tile rows
// [m_cap, 128], the float32 timestamp tiles and the int32 (base, deg)
// rows [N, 2] (8-byte rows), each a new table, so a flush holding the old
// one keeps reading it.
// The reference returns a new array and leaves its input untouched, which
// an adaptive pipeline's pinned snapshot of the table relies on: this call
// writes a new table `out` and only reads `table`.
//
// Bound on the card: bytes — the table read and the new table written
// once, the b slots and promoted rows read (B1's node commit: 2 x 1.46 GB
// of tiles and 2 x 19.6 MB of (base, deg) rows; K6: 392 MB at the 20%
// products cache, D = 100 float32, which counts only the rows that keep
// their bytes as read). A commit touches 6-12 rows of 2.85M, so the call is
// a copy of the table: it goes at the card's copy rate or not at all.
// Design: two launches in stream order. (1) The table is copied to the new
// one as flat bytes, whatever the row width, in the widest words (16, 8,
// 4, 2 or 1 bytes) in which both base pointers agree, the unaligned head
// and tail a byte a thread: a block a chunk of kCopyThreads x kCopyUnroll
// words, each thread's loads issued before its stores. The blocks are
// issued in order, so the words in flight at a time lie in one window that
// moves down the table; on an H100 this copy runs at `clone`'s rate, where
// a persistent grid walking the table in strides, blocks over contiguous
// ranges and TMA bulk copies through shared memory were slower. The same
// launch sets the [H] int32 scratch map to -1 at the b slots alone (no
// entry outside them is written or read). (2) One cooperative launch
// patches the b rows: each valid row i takes atomicMax(map[slots[i]], i);
// one grid barrier; then each row whose map entry is its own i (no later i
// names its slot) is copied into its slot by a team of up to 32 threads,
// each with kPatchRows rows' words in flight, loaded before the check (a
// patch that fits one block, as a commit's does, takes a plain launch and
// the block's barrier). b = 0 makes the copy alone. The patch writes the b rows a second time:
// nothing for a commit's few rows, but 13% more bytes for K6's 65,536-row
// batch on its 196 MB table.

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 2;  // words a thread copies
constexpr int kPatchThreads = 512;
constexpr int kPatchRows = 4;  // rows a team has in flight

template <int V>
__global__ void __launch_bounds__(kCopyThreads)
    copy_table_kernel(const char* __restrict__ src, char* __restrict__ dst, long long head,
                      long long n_words, long long tail, const int64_t* __restrict__ slots,
                      long long b, long long H, int32_t* __restrict__ slot_row) {
  using T = typename Bytes<V>::T;
  const long long tid = blockIdx.x * static_cast<long long>(kCopyThreads) + threadIdx.x;
  if (tid < b) {
    const long long s = slots[tid];
    if (s >= 0 && s < H) slot_row[s] = -1;
  }
  if (tid < 16 && tid < head) dst[tid] = src[tid];
  if (tid >= 16 && tid < 16 + tail) {
    const long long at = head + n_words * V + (tid - 16);
    dst[at] = src[at];
  }
  const T* s = reinterpret_cast<const T*>(src + head);
  T* d = reinterpret_cast<T*>(dst + head);
  const long long c0 = blockIdx.x * static_cast<long long>(kCopyThreads) * kCopyUnroll +
                       threadIdx.x;
  T v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long c = c0 + static_cast<long long>(u) * kCopyThreads;
    if (c < n_words) v[u] = __ldg(s + c);
  }
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long c = c0 + static_cast<long long>(u) * kCopyThreads;
    if (c < n_words) d[c] = v[u];
  }
}

template <int V>
__global__ void __launch_bounds__(kPatchThreads)
    patch_rows_kernel(const int64_t* __restrict__ slots, long long b, long long H,
                      int32_t* __restrict__ slot_row, const char* __restrict__ rows,
                      long long row_words, int lanes, char* __restrict__ out) {
  namespace cg = cooperative_groups;
  using T = typename Bytes<V>::T;
  cg::grid_group grid = cg::this_grid();
  const long long tid = blockIdx.x * static_cast<long long>(kPatchThreads) + threadIdx.x;
  const long long nth = static_cast<long long>(gridDim.x) * kPatchThreads;
  // 1. the latest row each slot takes
  for (long long i = tid; i < b; i += nth) {
    const long long s = slots[i];
    if (s >= 0 && s < H) atomicMax(slot_row + s, static_cast<int32_t>(i));
  }
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    grid.sync();
  }
  // 2. each row that keeps its slot, a team of `lanes` threads a row; a
  // row's first words are loaded before its slot's entry is checked
  const long long team = tid / lanes, n_teams = nth / lanes;
  const int sub = static_cast<int>(tid % lanes);
  const T* r = reinterpret_cast<const T*>(rows);
  T* o = reinterpret_cast<T*>(out);
  for (long long i0 = team; i0 < b; i0 += n_teams * kPatchRows) {
    long long s[kPatchRows];
    T v[kPatchRows];
#pragma unroll
    for (int u = 0; u < kPatchRows; ++u) {
      const long long i = i0 + u * n_teams;
      s[u] = i < b ? __ldg(slots + i) : -1;
      if (i < b && sub < row_words) v[u] = __ldg(r + i * row_words + sub);
    }
#pragma unroll
    for (int u = 0; u < kPatchRows; ++u) {
      const long long i = i0 + u * n_teams;
      if (s[u] < 0 || s[u] >= H || __ldcg(slot_row + s[u]) != static_cast<int32_t>(i)) s[u] = -1;
      if (s[u] >= 0 && sub < row_words) o[s[u] * row_words + sub] = v[u];
    }
    for (long long c = sub + lanes; c < row_words; c += lanes) {
#pragma unroll
      for (int u = 0; u < kPatchRows; ++u)
        if (s[u] >= 0) v[u] = __ldg(r + (i0 + u * n_teams) * row_words + c);
#pragma unroll
      for (int u = 0; u < kPatchRows; ++u)
        if (s[u] >= 0) o[s[u] * row_words + c] = v[u];
    }
  }
}

template <int V>
static int launch_copy_table(const char* src, char* dst, long long n_bytes, const void* slots,
                             long long b, long long H, int32_t* slot_row, cudaStream_t stream) {
  long long head = (V - reinterpret_cast<uintptr_t>(dst) % V) % V;
  if (head > n_bytes) head = n_bytes;
  const long long n_words = (n_bytes - head) / V, tail = n_bytes - head - n_words * V;
  const long long chunks = (n_words + kCopyThreads * kCopyUnroll - 1) / (kCopyThreads * kCopyUnroll);
  const long long marks = (b + kCopyThreads - 1) / kCopyThreads;
  long long blocks = chunks > marks ? chunks : marks;
  if (blocks < 1) blocks = 1;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  qt_count_launch();
  copy_table_kernel<V><<<static_cast<unsigned>(blocks), kCopyThreads, 0, stream>>>(
      src, dst, head, n_words, tail, static_cast<const int64_t*>(slots), b, H, slot_row);
  return qt_launch_status();
}

template <int V>
static int launch_patch_rows(const void* slots, long long b, long long H, int32_t* slot_row,
                             const void* rows, long long row_bytes, void* out,
                             cudaStream_t stream) {
  static int blocks_per_sm[64] = {};  // per device, from the occupancy API
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks_per_sm[dev] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_rows_kernel<V>,
                                                        kPatchThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    blocks_per_sm[dev] = per_sm;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(blocks_per_sm[dev]) * sms;
  long long row_words = row_bytes / V;
  int lanes = 1;
  while (lanes < 32 && lanes < row_words) lanes <<= 1;
  const long long teams = (b + kPatchRows - 1) / kPatchRows;
  long long blocks = (teams * lanes + kPatchThreads - 1) / kPatchThreads;
  if (blocks > most) blocks = most;
  const auto* sl = static_cast<const int64_t*>(slots);
  const auto* r = static_cast<const char*>(rows);
  auto* o = static_cast<char*>(out);
  qt_count_launch();
  if (blocks == 1) {  // a block's barrier is the grid's: a plain launch
    patch_rows_kernel<V><<<1, kPatchThreads, 0, stream>>>(sl, b, H, slot_row, r, row_words,
                                                          lanes, o);
    return qt_launch_status();
  }
  void* params[] = {&sl, &b, &H, &slot_row, &r, &row_words, &lanes, &o};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(patch_rows_kernel<V>),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kPatchThreads),
                                    params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return qt_launch_status();
}

// The widest word (16, 8, 4, 2 or 1 bytes) at which two addresses agree:
// both are aligned to it after the same head of bytes.
static int qt_common_vec_bytes(const void* a, const void* b) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b);
  for (int v = 16; v > 1; v >>= 1)
    if (x % v == 0) return v;
  return 1;
}

// `slot_row` is [H] int32 scratch, of which only the entries at the b
// slots are written and read; b < 2^31. Two kernel launches (one when b is
// 0): the copy, then the patch (cooperative when it spans several blocks).
QT_EXPORT int qt_set_rows(const void* table, long long H, int row_bytes, const void* slots,
                          long long b, const void* rows, void* slot_row, void* out,
                          void* stream) {
  if (H <= 0 || row_bytes <= 0) return 0;
  if (b < 0 || b >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* src = static_cast<const char*>(table);
  char* dst = static_cast<char*>(out);
  const long long n_bytes = H * static_cast<long long>(row_bytes);
  int32_t* map = static_cast<int32_t*>(slot_row);
  int rc = 0;
  switch (qt_common_vec_bytes(table, out)) {
    case 16: rc = launch_copy_table<16>(src, dst, n_bytes, slots, b, H, map, s); break;
    case 8: rc = launch_copy_table<8>(src, dst, n_bytes, slots, b, H, map, s); break;
    case 4: rc = launch_copy_table<4>(src, dst, n_bytes, slots, b, H, map, s); break;
    case 2: rc = launch_copy_table<2>(src, dst, n_bytes, slots, b, H, map, s); break;
    default: rc = launch_copy_table<1>(src, dst, n_bytes, slots, b, H, map, s); break;
  }
  if (rc != 0 || b == 0) return rc;
  switch (qt_vec_bytes(row_bytes, {rows, out})) {
    case 16: return launch_patch_rows<16>(slots, b, H, map, rows, row_bytes, out, s);
    case 8: return launch_patch_rows<8>(slots, b, H, map, rows, row_bytes, out, s);
    case 4: return launch_patch_rows<4>(slots, b, H, map, rows, row_bytes, out, s);
    case 2: return launch_patch_rows<2>(slots, b, H, map, rows, row_bytes, out, s);
    default: return launch_patch_rows<1>(slots, b, H, map, rows, row_bytes, out, s);
  }
}

// The device pointer through which kernels read pinned host memory at
// ``host`` (its UVA mapping). Fails with cudaErrorInvalidHostPointer when
// ``host`` is not pinned, mapped host memory.
QT_EXPORT int qt_host_device_pointer(const void* host, void** dev) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidHostPointer);
  *dev = attr.devicePointer;
  return 0;
}

// Register ``bytes`` of host memory at ``host`` (a shared-memory mapping of
// another process's host tail) with the card, mapped and portable, so that
// kernels read it through its UVA mapping as they read pinned memory. Sets
// ``*registered`` to 1 when this call registered it, and to 0 when the
// memory is already page-locked (pinned, or registered before in this
// process), which leaves its registration to its owner.
QT_EXPORT int qt_host_register(void* host, long long bytes, int* registered) {
  *registered = 0;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.type == cudaMemoryTypeHost) return 0;
  err = cudaHostRegister(host, static_cast<size_t>(bytes),
                         cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registered = 1;
  return 0;
}

// Undo qt_host_register: the memory at ``host`` is pageable again.
QT_EXPORT int qt_host_unregister(void* host) {
  return static_cast<int>(cudaHostUnregister(host));
}

// K14: gather_src — the hop-source gather of the dense adjacency.
//
// Replaces quiver_tpu/pyg/sage_sampler.py:DenseAdj.gather_src in the cols
// layout (jnp.take(x_src, clip(cols, 0, W_src - 1), axis=0)), as GCN
// (quiver_tpu/models/gcn.py:49, :76) and GAT (models/gat.py:52) call it:
// out[q] = x_src[clip(cols[q], 0, W_src - 1)] for every lane q of the
// [W_dst, k] hop, each row F elements (F = D, H * D or 1) of float32 or
// bfloat16, copied as bytes, so the result is bit-equal. Its gradient is
// K14b (csrc/aggregate.cu).
//
// Bound on the card: bytes — the rows the lanes name read once each, the
// [W_dst * k, F] output written once (3.7 GB of float32 at GAT's widest
// hop). Design: K3's shape, with K3t's widest access (16, 8, 4, 2 or 1
// bytes that divide the row width and both base pointers): a warp copies
// a row of 32 elements or more in one coalesced sweep; a narrower row (GCN's
// F = 1 inverse degree) is copied by one thread, so a warp writes 32
// consecutive rows instead of leaving 31 lanes idle.
template <int V>
__global__ void gather_src_warp_kernel(const char* __restrict__ x, long long w_src,
                                       long long row_bytes, const int32_t* __restrict__ cols,
                                       long long n_lanes, char* __restrict__ out) {
  using T = typename Bytes<V>::T;
  const long long q = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n_lanes) return;
  const long long s = qt_clamp<long long>(cols[q], 0, w_src - 1);
  const T* src = reinterpret_cast<const T*>(x + s * row_bytes);
  T* dst = reinterpret_cast<T*>(out + q * row_bytes);
  const long long n_vec = row_bytes / V;
  for (long long c = lane; c < n_vec; c += 32) dst[c] = src[c];
}

template <int V>
__global__ void gather_src_thread_kernel(const char* __restrict__ x, long long w_src,
                                         long long row_bytes, const int32_t* __restrict__ cols,
                                         long long n_lanes, char* __restrict__ out) {
  using T = typename Bytes<V>::T;
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= n_lanes) return;
  const long long s = qt_clamp<long long>(cols[q], 0, w_src - 1);
  const T* src = reinterpret_cast<const T*>(x + s * row_bytes);
  T* dst = reinterpret_cast<T*>(out + q * row_bytes);
  const long long n_vec = row_bytes / V;
  for (long long c = 0; c < n_vec; ++c) dst[c] = src[c];
}

template <int V>
static void launch_gather_src(const void* x, long long w_src, long long row_bytes,
                              bool thread_a_row, const void* cols, long long n_lanes, void* out,
                              cudaStream_t stream) {
  const int threads = 256;
  const char* xs = static_cast<const char*>(x);
  const int32_t* c = static_cast<const int32_t*>(cols);
  char* o = static_cast<char*>(out);
  if (thread_a_row) {
    qt_count_launch();
    gather_src_thread_kernel<V><<<qt_blocks(n_lanes, threads), threads, 0, stream>>>(
        xs, w_src, row_bytes, c, n_lanes, o);
  } else {
    qt_count_launch();
    gather_src_warp_kernel<V><<<qt_blocks(n_lanes * 32, threads), threads, 0, stream>>>(
        xs, w_src, row_bytes, c, n_lanes, o);
  }
}

// x: [w_src, F] rows of elem_bytes-byte elements; cols: [n_lanes] int32;
// out: [n_lanes, F]
QT_EXPORT int qt_gather_src(const void* x, long long w_src, int F, int elem_bytes,
                            const void* cols, long long n_lanes, void* out, void* stream) {
  if (n_lanes <= 0 || F <= 0) return 0;
  if (w_src <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(F) * elem_bytes;
  const bool thread_a_row = F < 32;
  switch (qt_vec_bytes(row_bytes, {x, out})) {
    case 16: launch_gather_src<16>(x, w_src, row_bytes, thread_a_row, cols, n_lanes, out, s); break;
    case 8: launch_gather_src<8>(x, w_src, row_bytes, thread_a_row, cols, n_lanes, out, s); break;
    case 4: launch_gather_src<4>(x, w_src, row_bytes, thread_a_row, cols, n_lanes, out, s); break;
    case 2: launch_gather_src<2>(x, w_src, row_bytes, thread_a_row, cols, n_lanes, out, s); break;
    default: launch_gather_src<1>(x, w_src, row_bytes, thread_a_row, cols, n_lanes, out, s); break;
  }
  return qt_launch_status();
}

// K13a: sharded_rows — one shard's partial of a row gather by global id.
//
// Replaces quiver_tpu/parallel/collectives.py:_partial_rows, the per-shard
// half of sharded_gather (collectives.py:26), and through it the encoded
// pack of quant/lookup.py:sharded_dequant_gather (K9c): the shard holds
// rows [first, first + R) of the striped table as its [R, D] block; output
// row r is block[ids[r] - first] when that lies in [0, R), else a zero row.
// The caller sums the shards' partials (an all-reduce over the striping
// group): exactly one shard owns each in-range id, so the sum is the row.
// Rows are copied as bytes of elem_bytes-byte elements (4: float32, 2:
// bfloat16, 1: int8 codes), so one kernel serves the float tables and the
// encoded payloads, and the copy is bit-equal.
//
// Bound on the card: bytes — W ids read, the owned lanes' rows read, and
// the [W, D] partial written once (zero rows included). Rows of 100-200
// bytes (bfloat16 and int8 at D = 100) need many rows in flight a warp: a
// warp a row, its id loaded before the row, holds 100-200 bytes in flight
// and stays under half the bound on an H100. Design: a block takes a tile of
// kRowsTile consecutive output rows, whose output is one contiguous span:
// it loads the tile's ids once (a thread an id, coalesced) into shared
// memory as source offsets (-1 for a row the shard does not own), then
// walks the span as flat words of the widest access (16, 8, 4, 2 or 1
// bytes) dividing the row width and both base pointers, a thread every
// kRowsTile-th word with kRowsUnroll words in flight before its stores, so
// every lane of a warp loads and stores across row edges, the stores are
// contiguous, and an unowned row's words are zeros, never read. All three
// widths at D = 100 are 25 words a row (16, 8 and 4 bytes).

constexpr int kRowsTile = 256;   // output rows a block, an id a thread
constexpr int kRowsUnroll = 16;  // words a thread has in flight

// The tile's word indices are ints: rows of up to kRowsMaxWords words.
constexpr long long kRowsMaxWords = ((1LL << 31) - 1) / (kRowsTile * (kRowsUnroll + 1));

template <int V>
__global__ void __launch_bounds__(kRowsTile)
    sharded_rows_kernel(const char* __restrict__ block, long long R, int row_words,
                        const int32_t* __restrict__ ids, long long n_ids, long long first,
                        char* __restrict__ out) {
  using T = typename Bytes<V>::T;
  __shared__ long long s_src[kRowsTile];  // a row's first source word; -1: a zero row
  const long long r0 = blockIdx.x * static_cast<long long>(kRowsTile);
  const int rows = static_cast<int>(n_ids - r0 < kRowsTile ? n_ids - r0 : kRowsTile);
  if (static_cast<int>(threadIdx.x) < rows) {
    const long long local = static_cast<long long>(ids[r0 + threadIdx.x]) - first;
    s_src[threadIdx.x] = local >= 0 && local < R ? local * row_words : -1;
  }
  __syncthreads();
  const T* src = reinterpret_cast<const T*>(block);
  T* dst = reinterpret_cast<T*>(out) + r0 * row_words;
  const int n = rows * row_words;
  const int step_rows = kRowsTile / row_words, step_cols = kRowsTile % row_words;
  int row = threadIdx.x / row_words, col = threadIdx.x % row_words;
  for (int c0 = threadIdx.x; c0 < n; c0 += kRowsTile * kRowsUnroll) {
    T v[kRowsUnroll];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      v[u] = T{};
      if (c0 + u * kRowsTile < n) {
        const long long at = s_src[row];
        if (at >= 0) v[u] = __ldg(src + at + col);
      }
      row += step_rows;
      col += step_cols;
      if (col >= row_words) {
        col -= row_words;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u)
      if (c0 + u * kRowsTile < n) dst[c0 + u * kRowsTile] = v[u];
  }
}

template <int V>
static void launch_sharded_rows(const void* block, long long R, long long row_bytes,
                                const void* ids, long long n_ids, long long first, void* out,
                                cudaStream_t stream) {
  qt_count_launch();
  sharded_rows_kernel<V><<<qt_blocks(n_ids, kRowsTile), kRowsTile, 0, stream>>>(
      static_cast<const char*>(block), R, static_cast<int>(row_bytes / V),
      static_cast<const int32_t*>(ids), n_ids, first, static_cast<char*>(out));
}

// block: [R, D] elements of elem_bytes (4, 2 or 1) bytes, rows [first, first
// + R) of the global table; ids: [n_ids] int32 global ids; out: [n_ids, D]
QT_EXPORT int qt_sharded_rows(const void* block, long long R, int D, int elem_bytes,
                              const void* ids, long long n_ids, long long first, void* out,
                              void* stream) {
  if (n_ids <= 0 || D <= 0) return 0;
  if (elem_bytes != 4 && elem_bytes != 2 && elem_bytes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(D) * elem_bytes;
  const int vec = qt_vec_bytes(row_bytes, {block, out});
  if (row_bytes / vec > kRowsMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 16: launch_sharded_rows<16>(block, R, row_bytes, ids, n_ids, first, out, s); break;
    case 8: launch_sharded_rows<8>(block, R, row_bytes, ids, n_ids, first, out, s); break;
    case 4: launch_sharded_rows<4>(block, R, row_bytes, ids, n_ids, first, out, s); break;
    case 2: launch_sharded_rows<2>(block, R, row_bytes, ids, n_ids, first, out, s); break;
    default: launch_sharded_rows<1>(block, R, row_bytes, ids, n_ids, first, out, s); break;
  }
  return qt_launch_status();
}

QT_DEFINE_ERROR_STRING
