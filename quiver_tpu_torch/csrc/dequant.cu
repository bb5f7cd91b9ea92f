// K9a: gather_dequant and K9b: quantized_tiered_lookup — encoded-row
// gathers that decode to float32 in registers.
//
// Replace quiver_tpu/quant/lookup.py:gather_dequant (+ _side_lookup) and
// quantized_tiered_lookup, with the codec decodes of
// quiver_tpu/quant/codecs.py (Codec.dequant, Int8Codec.dequant) fused in.
// One body serves the three codecs, chosen at compile time: fp32 (identity),
// bf16 (the 16 high bits of a float32: exact) and int8 (per-row affine,
// (q - zero[row]) * scale[row]). The int8 decode is __fsub_rn then
// __fmul_rn, the reference's sub-then-mul order, which the compiler may not
// contract into an FMA: the result is bit-equal to the host numpy decode.
//
// K9a: out[r] = decode(payload[id], side[id]) with id = clip(ids[r], 0,
// n_clip - 1), then through the optional index map (the feature order) and
// clip(.., 0, N - 1).
// K9b: as K5 (pipeline.py:tiered_lookup) on encoded rows, then the decode:
// a slot takes hot[m] (m = mapped[r], 0 <= m < H) or a zero payload, cold
// row i takes slot cold_pos[i] (outside [0, W): dropped), the side entries
// come from clip(m, 0, n_side - 1), and the decoded row is multiplied by
// (m >= 0). The reference's quirks are kept: an int8 lane past the hot
// prefix that no cold row covers decodes to -zero * scale, not 0.
//
// Bound on the card: bytes — the gathered rows at the storage width (1, 2
// or 4 bytes an element), 8 side bytes a lane (int8), 4 id bytes a lane and
// 4 output bytes an element. Design: one warp per output row, each lane
// loading 4 elements at once (4, 8 or 16 bytes) where the width and the
// base pointers allow it and writing a float4; the side entries are one
// load a lane. K9b is two launches in stream order (fill-and-decode every
// slot, then decode each cold row into its slot), so a cold slot's fill
// never races its cold write.

#include "common.cuh"

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int C> struct Elem;
template <> struct Elem<kF32> { using T = float; using V4 = float4; };
template <> struct Elem<kBF16> { using T = uint16_t; using V4 = uint2; };
template <> struct Elem<kI8> { using T = int8_t; using V4 = char4; };

__device__ __forceinline__ float bf16_bits(uint32_t b) { return __uint_as_float(b << 16); }

template <int C>
__device__ __forceinline__ float raw1(const typename Elem<C>::T* p) {
  if constexpr (C == kBF16) return bf16_bits(*p);
  else return static_cast<float>(*p);
}

template <int C>
__device__ __forceinline__ float4 raw4(const typename Elem<C>::T* p) {
  const typename Elem<C>::V4 v = *reinterpret_cast<const typename Elem<C>::V4*>(p);
  if constexpr (C == kF32) {
    return v;
  } else if constexpr (C == kBF16) {
    return make_float4(bf16_bits(v.x & 0xffffu), bf16_bits(v.x >> 16), bf16_bits(v.y & 0xffffu),
                       bf16_bits(v.y >> 16));
  } else {
    return make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                       static_cast<float>(v.z), static_cast<float>(v.w));
  }
}

// decode then multiply by ``mult`` (1 for a valid lane, 0 otherwise)
template <int C>
__device__ __forceinline__ float dec(float raw, float s, float z, float mult) {
  if constexpr (C == kI8) raw = __fmul_rn(__fsub_rn(raw, z), s);
  return __fmul_rn(raw, mult);
}

// One warp writes one decoded row: ``src`` encoded row (nullptr: a zero
// payload), side entries ``s``/``z``.
template <int C, bool VEC>
__device__ __forceinline__ void decode_row(const typename Elem<C>::T* src, int D, int lane,
                                           float s, float z, float mult, float* dst) {
  if constexpr (VEC) {
    for (int c = lane; c < D / 4; c += 32) {
      const float4 r = src != nullptr ? raw4<C>(src + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(dst)[c] = make_float4(dec<C>(r.x, s, z, mult),
                                                      dec<C>(r.y, s, z, mult),
                                                      dec<C>(r.z, s, z, mult),
                                                      dec<C>(r.w, s, z, mult));
    }
  } else {
    for (int c = lane; c < D; c += 32)
      dst[c] = dec<C>(src != nullptr ? raw1<C>(src + c) : 0.0f, s, z, mult);
  }
}

// K9a (tiered = false) and K9b's fill (tiered = true), one row a warp.
template <int C, bool VEC>
__global__ void decode_rows_kernel(const typename Elem<C>::T* __restrict__ table, long long R,
                                   int D, const int32_t* __restrict__ ids, long long W,
                                   long long n_clip, const int32_t* __restrict__ imap,
                                   bool tiered, const float* __restrict__ scale,
                                   const float* __restrict__ zero, long long n_side,
                                   float* __restrict__ out) {
  const long long r = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= W) return;
  long long row, side;
  float mult = 1.0f;
  const typename Elem<C>::T* src;
  if (tiered) {
    row = ids[r];
    src = row >= 0 && row < R ? table + row * D : nullptr;
    side = qt_clamp<long long>(row, 0, n_side - 1);
    mult = row >= 0 ? 1.0f : 0.0f;
  } else {
    row = qt_clamp<long long>(ids[r], 0, n_clip - 1);
    if (imap != nullptr) row = qt_clamp<long long>(imap[row], 0, R - 1);
    src = table + row * D;
    side = row;
  }
  float s = 1.0f, z = 0.0f;
  if constexpr (C == kI8) {
    s = scale[side];
    z = zero[side];
  }
  decode_row<C, VEC>(src, D, lane, s, z, mult, out + r * D);
}

// K9b's second launch: cold row i decoded into slot pos[i].
template <int C, bool VEC>
__global__ void decode_scatter_kernel(const typename Elem<C>::T* __restrict__ cold,
                                      long long n_cold, int D, const int32_t* __restrict__ pos,
                                      const int32_t* __restrict__ mapped, long long W,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero, long long n_side,
                                      float* __restrict__ out) {
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_cold) return;
  const long long p = pos[i];
  if (p < 0 || p >= W) return;
  const long long m = mapped[p];
  float s = 1.0f, z = 0.0f;
  if constexpr (C == kI8) {
    const long long side = qt_clamp<long long>(m, 0, n_side - 1);
    s = scale[side];
    z = zero[side];
  }
  decode_row<C, VEC>(cold + i * D, D, lane, s, z, m >= 0 ? 1.0f : 0.0f, out + p * D);
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int C>
static void gather_dequant_t(const void* payload, long long N, int D, const void* ids, long long W,
                             long long n_clip, const void* imap, bool tiered, const void* scale,
                             const void* zero, long long n_side, void* out, cudaStream_t s) {
  using T = typename Elem<C>::T;
  const int threads = 256;  // 8 rows a block
  const bool vec = D % 4 == 0 && aligned(payload, 4 * sizeof(T)) && aligned(out, 16);
  auto args = [&](auto kernel) {
    qt_count_launch();
    kernel<<<qt_blocks(W * 32, threads), threads, 0, s>>>(
        static_cast<const T*>(payload), N, D, static_cast<const int32_t*>(ids), W, n_clip,
        static_cast<const int32_t*>(imap), tiered, static_cast<const float*>(scale),
        static_cast<const float*>(zero), n_side, static_cast<float*>(out));
  };
  if (vec) args(decode_rows_kernel<C, true>);
  else args(decode_rows_kernel<C, false>);
}

template <int C>
static int quantized_tiered_lookup_t(const void* hot, long long H, int D, const void* mapped,
                                     long long W, const void* cold, long long n_cold,
                                     const void* pos, const void* scale, const void* zero,
                                     long long n_side, void* out, cudaStream_t s) {
  using T = typename Elem<C>::T;
  gather_dequant_t<C>(hot, H, D, mapped, W, 0, nullptr, true, scale, zero, n_side, out, s);
  const int rc = qt_launch_status();
  if (rc != 0 || n_cold <= 0) return rc;
  const int threads = 256;
  const bool vec = D % 4 == 0 && aligned(cold, 4 * sizeof(T)) && aligned(out, 16);
  auto args = [&](auto kernel) {
    qt_count_launch();
    kernel<<<qt_blocks(n_cold * 32, threads), threads, 0, s>>>(
        static_cast<const T*>(cold), n_cold, D, static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(mapped), W, static_cast<const float*>(scale),
        static_cast<const float*>(zero), n_side, static_cast<float*>(out));
  };
  if (vec) args(decode_scatter_kernel<C, true>);
  else args(decode_scatter_kernel<C, false>);
  return qt_launch_status();
}

// K9c: sharded_dequant — the decode after the sum of a sharded encoded
// gather.
//
// Replaces the tail of quiver_tpu/quant/lookup.py:sharded_dequant_gather
// (:88): the shards' K13a partials of the striped encoded payload
// (csrc/gather.cu, qt_sharded_rows, one shard owning each id) have been
// summed into q [W, D] in storage width, and row r decodes with the
// replicated side entries of its global id: with side tables, s, z =
// scale/zero[clip(id, 0, N - 1)] and the decoded row times (0 <= id < N),
// as lookup.py:109-112 masks it; without them the plain decode (fp32, bf16).
// The decode is K9a's (decode_row), so for in-range ids the result is
// bit-equal to K9a on the unsharded payload.
//
// Bound on the card: bytes — q at the storage width, 4 id bytes and 8 side
// bytes a row, and the float32 rows written once. Design: K9a's, one warp
// a row, 4 elements a lane where width and pointers allow.
template <int C, bool VEC>
__global__ void sharded_decode_kernel(const typename Elem<C>::T* __restrict__ q, int D,
                                      const int32_t* __restrict__ ids, long long W,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero, long long n_side,
                                      float* __restrict__ out) {
  const long long r = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= W) return;
  float s = 1.0f, z = 0.0f, mult = 1.0f;
  if (scale != nullptr) {
    const long long id = ids[r];
    const long long side = qt_clamp<long long>(id, 0, n_side - 1);
    if constexpr (C == kI8) {
      s = scale[side];
      z = zero[side];
    }
    mult = id >= 0 && id < n_side ? 1.0f : 0.0f;
  }
  decode_row<C, VEC>(q + r * D, D, lane, s, z, mult, out + r * D);
}

template <int C>
static int sharded_decode_t(const void* q, long long W, int D, const void* ids, const void* scale,
                            const void* zero, long long n_side, void* out, cudaStream_t s) {
  using T = typename Elem<C>::T;
  const int threads = 256;  // 8 rows a block
  const bool vec = D % 4 == 0 && aligned(q, 4 * sizeof(T)) && aligned(out, 16);
  auto args = [&](auto kernel) {
    qt_count_launch();
    kernel<<<qt_blocks(W * 32, threads), threads, 0, s>>>(
        static_cast<const T*>(q), D, static_cast<const int32_t*>(ids), W,
        static_cast<const float*>(scale), static_cast<const float*>(zero), n_side,
        static_cast<float*>(out));
  };
  if (vec) args(sharded_decode_kernel<C, true>);
  else args(sharded_decode_kernel<C, false>);
  return qt_launch_status();
}

// codec: 0 fp32, 1 bf16, 2 int8; q: [W, D] summed payload; ids: [W] global
// ids; scale/zero: [n_side] float32 or null (int8 needs them)
QT_EXPORT int qt_sharded_dequant(int codec, const void* q, long long W, int D, const void* ids,
                                 const void* scale, const void* zero, long long n_side,
                                 void* out, void* stream) {
  if (W <= 0 || D <= 0) return 0;
  if (scale != nullptr && n_side <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kF32: return sharded_decode_t<kF32>(q, W, D, ids, scale, zero, n_side, out, s);
    case kBF16: return sharded_decode_t<kBF16>(q, W, D, ids, scale, zero, n_side, out, s);
    case kI8:
      if (scale == nullptr || zero == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return sharded_decode_t<kI8>(q, W, D, ids, scale, zero, n_side, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// codec: 0 fp32, 1 bf16, 2 int8 (scale and zero: [N] float32, int8 only)
QT_EXPORT int qt_gather_dequant(int codec, const void* payload, long long N, int D,
                                const void* ids, long long W, long long n_clip, const void* imap,
                                const void* scale, const void* zero, void* out, void* stream) {
  if (W <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kF32: gather_dequant_t<kF32>(payload, N, D, ids, W, n_clip, imap, false, scale, zero,
                                      N, out, s); break;
    case kBF16: gather_dequant_t<kBF16>(payload, N, D, ids, W, n_clip, imap, false, scale, zero,
                                        N, out, s); break;
    case kI8: gather_dequant_t<kI8>(payload, N, D, ids, W, n_clip, imap, false, scale, zero, N,
                                    out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return qt_launch_status();
}

QT_EXPORT int qt_quantized_tiered_lookup(int codec, const void* hot, long long H, int D,
                                         const void* mapped, long long W, const void* cold,
                                         long long n_cold, const void* pos, const void* scale,
                                         const void* zero, long long n_side, void* out,
                                         void* stream) {
  if (W <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kF32: return quantized_tiered_lookup_t<kF32>(hot, H, D, mapped, W, cold, n_cold, pos,
                                                      scale, zero, n_side, out, s);
    case kBF16: return quantized_tiered_lookup_t<kBF16>(hot, H, D, mapped, W, cold, n_cold, pos,
                                                        scale, zero, n_side, out, s);
    case kI8: return quantized_tiered_lookup_t<kI8>(hot, H, D, mapped, W, cold, n_cold, pos,
                                                    scale, zero, n_side, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

QT_DEFINE_ERROR_STRING
