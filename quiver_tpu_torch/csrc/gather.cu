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
// merge) behind quiver_tpu/feature.py:Feature.__getitem__. For output row
// r with id = ids[r]: ids outside [0, n_valid) give a zero row; else the
// stored row is s = order[id] (id itself without an order), read from the
// device shard when s < H and from the host tail when H <= s < H + n_host
// (any other s gives a zero row, as a row no shard owns does in the
// reference). The rows are copied, so the result is bit-equal.
//
// Bound on the card: bytes — each output row is one stored row read and
// written once (400 B at D = 100 float32); the host-tail rows cross PCIe,
// whose rate (tens of GB/s, not 3.35 TB/s) sets the time whenever a few
// percent of the rows are cold. Design: the host tail is pinned host
// memory read in-kernel through its mapped device pointer (UVA zero-copy,
// as the reference's shard_tensor.cu.hpp did), so there is no staging
// copy and no scatter; one warp per row copies with 16-byte accesses
// where the width and every base pointer allow it, so a row is read as
// whole 128-byte lines (3.125 lines a 400-byte row) and many rows are in
// flight to hide the link's latency.

__global__ void tiered_gather_kernel(const float* __restrict__ dev_rows, long long H,
                                     const float* host_rows, long long n_host, int D,
                                     const int32_t* __restrict__ ids, long long n_ids,
                                     long long n_valid, const int32_t* __restrict__ order,
                                     bool vec4, float* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_ids) return;
  const long long id = ids[row];
  long long s = -1;
  if (id >= 0 && id < n_valid) s = order != nullptr ? static_cast<long long>(order[id]) : id;
  float* dst = out + row * D;
  const float* src = nullptr;
  if (s >= 0 && s < H) {
    src = dev_rows + s * D;
  } else if (s >= H && s < H + n_host) {
    src = host_rows + (s - H) * D;  // pinned host memory, read over the link
  }
  if (vec4) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int c = lane; c < D / 4; c += 32)
      d4[c] = src != nullptr ? s4[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int c = lane; c < D; c += 32) dst[c] = src != nullptr ? src[c] : 0.0f;
  }
}

QT_EXPORT int qt_tiered_gather(const void* dev_rows, long long H, const void* host_rows,
                               long long n_host, int D, const void* ids, long long n_ids,
                               long long n_valid, const void* order, void* out,
                               void* stream) {
  if (n_ids <= 0 || D <= 0) return 0;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(dev_rows) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(host_rows) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;  // 8 rows a block
  tiered_gather_kernel<<<qt_blocks(n_ids * 32, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dev_rows), H, static_cast<const float*>(host_rows), n_host, D,
      static_cast<const int32_t*>(ids), n_ids, n_valid, static_cast<const int32_t*>(order),
      vec4, static_cast<float*>(out));
  return qt_launch_status();
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

QT_DEFINE_ERROR_STRING
