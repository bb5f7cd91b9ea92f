// The two neighbor fetches of the sampling kernels (K1/K1b, K7, K8): a
// drawn position of a row resolves through the 128-lane tile layout
// (tiles[clip(base + (pos >> 7)), pos & 127], the JAX package's
// _tiled_resolve) or the flat CSR (indices[clip(ptr + pos)]). A tiled
// fetch can also take its two table addresses from device memory (bind),
// where a captured serve step reads the graph of its flush's epoch.
#pragma once

#include "common.cuh"

struct TiledFetch {
  const int32_t* bd;     // [N, 2] (tile base, degree)
  const int32_t* tiles;  // [M, 128]
  long long m_rows;
  // the device-graph form: the two addresses read from device memory
  __device__ __forceinline__ void bind(const unsigned long long* __restrict__ words) {
    bd = reinterpret_cast<const int32_t*>(words[0]);
    tiles = reinterpret_cast<const int32_t*>(words[1]);
  }
  __device__ __forceinline__ void row(int32_t s, int32_t& base, int32_t& deg) const {
    base = bd[2 * static_cast<long long>(s)];
    deg = bd[2 * static_cast<long long>(s) + 1];
  }
  __device__ __forceinline__ int32_t fetch(int32_t base, int32_t pos) const {
    long long r = static_cast<long long>(base) + (static_cast<uint32_t>(pos) >> 7);
    r = qt_clamp<long long>(r, 0, m_rows - 1);
    return tiles[r * 128 + (pos & 127)];
  }
};

struct FlatFetch {
  const int32_t* indptr;   // [N + 1]
  const int32_t* indices;  // [E]
  long long n_edges;
  __device__ __forceinline__ void row(int32_t s, int32_t& ptr, int32_t& deg) const {
    ptr = indptr[s];
    deg = indptr[s + 1] - ptr;
  }
  __device__ __forceinline__ int32_t fetch(int32_t ptr, int32_t pos) const {
    long long f = static_cast<long long>(ptr) + pos;
    f = qt_clamp<long long>(f, 0, n_edges - 1);
    return indices[f];
  }
};
