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

QT_DEFINE_ERROR_STRING
