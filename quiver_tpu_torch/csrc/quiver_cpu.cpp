// The port's native host sampling and gather engine: a copy of the JAX
// package's quiver_tpu/csrc/quiver_cpu.cpp, kept so that the PyTorch port
// neither reads that file nor loads its library. The arithmetic, the
// thread split (one chunk of the batch a std::thread, hardware_concurrency()
// of them) and each thread's mt19937_64 seeding are unchanged, so one seed
// draws the same neighbors through either package on one machine. It is
// built with g++ at first use by quiver_tpu_torch/ops/cpu_kernels.py into
// quiver_tpu_torch/_build/ (not by nvcc: _kernels.py builds csrc/*.cu only).
//
// The original header follows.
//
// Native host sampling / gather engine.
//
// TPU-native counterpart of the reference's CPU engine
// (include/quiver/quiver.cpu.hpp: at::parallel_for degree pass + per-seed
// std::sample, quiver.cpu.hpp:57-102) and of the host-pointer branch of the
// feature gather kernel (include/quiver/shard_tensor.cu.hpp:44-55).
//
// Differences from the reference, by design:
//  - no torch/ATen dependency: raw std::thread parallelism over seed ranges,
//    per-thread SplitMix64-seeded mt19937 (reference uses thread_local mt19937,
//    quiver.cpu.hpp:14-27);
//  - fixed-k padded output (neighbors [B,k] + valid mask) instead of ragged
//    output + prefix sums — this matches the static shapes the XLA device
//    pipeline needs, so host batches stream straight into jit'd consumers;
//  - k-distinct draws use Floyd's algorithm (O(k) per seed, uniform k-subset)
//    instead of reservoir sampling; identical distribution over subsets.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <thread>
#include <utility>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Uniform k-subset of [0, deg) via Floyd's algorithm; writes k positions.
inline void floyd_sample(std::mt19937_64 &rng, int64_t deg, int64_t k,
                         int64_t *out) {
  // tiny linear-probe set sized to the next pow2 >= 2k
  int64_t cap = 4;
  while (cap < 2 * k) cap <<= 1;
  std::vector<int64_t> set(cap, -1);
  const int64_t mask = cap - 1;
  auto insert = [&](int64_t v) -> bool {  // returns false if already present
    int64_t h = static_cast<int64_t>(splitmix64(static_cast<uint64_t>(v))) & mask;
    while (set[h] != -1) {
      if (set[h] == v) return false;
      h = (h + 1) & mask;
    }
    set[h] = v;
    return true;
  };
  int64_t n_out = 0;
  for (int64_t j = deg - k; j < deg; ++j) {
    std::uniform_int_distribution<int64_t> dist(0, j);
    int64_t t = dist(rng);
    int64_t pick;
    if (insert(t)) {
      pick = t;
    } else {
      pick = j;
      insert(j);
    }
    out[n_out++] = pick;
  }
}

}  // namespace

extern "C" {

// One-hop sample: for each seed, min(deg, k) neighbors without replacement;
// copy-all in CSR order when deg <= k (reference cuda_random.cu.hpp:33-38).
void qt_sample_layer(const int64_t *indptr, const int64_t *indices,
                     int64_t num_nodes, const int64_t *seeds, int64_t batch,
                     int64_t k, uint64_t seed, int64_t *out_nbrs,
                     uint8_t *out_valid) {
  if (batch <= 0 || k <= 0) return;
  int64_t n_threads =
      std::max<int64_t>(1, std::min<int64_t>(
                               std::thread::hardware_concurrency(), batch));
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      std::mt19937_64 rng(splitmix64(seed ^ splitmix64(0xC0FFEEULL + t)));
      std::vector<int64_t> pos(static_cast<size_t>(k));
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = seeds[i];
        int64_t *row = out_nbrs + i * k;
        uint8_t *vrow = out_valid + i * k;
        if (s < 0 || s >= num_nodes) {
          std::memset(vrow, 0, static_cast<size_t>(k));
          std::memset(row, 0, static_cast<size_t>(k) * sizeof(int64_t));
          continue;
        }
        int64_t start = indptr[s];
        int64_t deg = indptr[s + 1] - start;
        if (deg <= k) {
          for (int64_t j = 0; j < deg; ++j) {
            row[j] = indices[start + j];
            vrow[j] = 1;
          }
          for (int64_t j = deg; j < k; ++j) {
            row[j] = 0;
            vrow[j] = 0;
          }
        } else {
          floyd_sample(rng, deg, k, pos.data());
          for (int64_t j = 0; j < k; ++j) {
            row[j] = indices[start + pos[j]];
            vrow[j] = 1;
          }
        }
      }
    });
  }
  for (auto &th : threads) th.join();
}

// Weighted one-hop sample: k DISTINCT neighbors drawn with probability
// proportional to per-edge weights (CSR order), via Efraimidis-Spirakis
// exponential keys — the same weighted-k-subset distribution as the device
// engine's Gumbel-top-k (ops/sample.py gumbel_topk_positions); the
// reference's weight_sample is CUDA-only (cuda_random.cu.hpp:177-221), so
// its CPU engine has no weighted story at all. Non-positive weights are
// NEVER drawn: a row with fewer than k positive-weight edges returns that
// many valid lanes and the rest invalid, matching the -inf-logit Gumbel
// behavior on device.
void qt_sample_layer_weighted(const int64_t *indptr, const int64_t *indices,
                              const float *weights, int64_t num_nodes,
                              const int64_t *seeds, int64_t batch, int64_t k,
                              uint64_t seed, int64_t *out_nbrs,
                              uint8_t *out_valid) {
  if (batch <= 0 || k <= 0) return;
  int64_t n_threads =
      std::max<int64_t>(1, std::min<int64_t>(
                               std::thread::hardware_concurrency(), batch));
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      std::mt19937_64 rng(splitmix64(seed ^ splitmix64(0xBEEFULL + t)));
      std::uniform_real_distribution<double> uni(
          std::numeric_limits<double>::min(), 1.0);
      std::vector<std::pair<double, int64_t>> keys;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = seeds[i];
        int64_t *row = out_nbrs + i * k;
        uint8_t *vrow = out_valid + i * k;
        std::memset(vrow, 0, static_cast<size_t>(k));
        std::memset(row, 0, static_cast<size_t>(k) * sizeof(int64_t));
        if (s < 0 || s >= num_nodes) continue;
        int64_t start = indptr[s];
        int64_t deg = indptr[s + 1] - start;
        // exponential key Exp(1)/w_j: the k smallest keys are a weighted
        // k-subset without replacement; w <= 0 -> +inf key (drawn last)
        keys.clear();
        keys.reserve(static_cast<size_t>(deg));
        int64_t positive = 0;
        for (int64_t j = 0; j < deg; ++j) {
          float w = weights[start + j];
          double key;
          if (w > 0.f) {
            key = -std::log(uni(rng)) / static_cast<double>(w);
            ++positive;
          } else {
            key = std::numeric_limits<double>::infinity();
          }
          keys.emplace_back(key, j);
        }
        int64_t take = std::min<int64_t>(k, positive);
        if (take <= 0) continue;
        if (take < deg)
          std::nth_element(keys.begin(), keys.begin() + take, keys.end());
        for (int64_t j = 0; j < take; ++j) {
          row[j] = indices[start + keys[static_cast<size_t>(j)].second];
          vrow[j] = 1;
        }
      }
    });
  }
  for (auto &th : threads) th.join();
}

// Hash-based local reindex — the host counterpart of the reference's GPU
// hash-table reindex (include/quiver/reindex.cu.hpp) and the bit-identical
// mirror of ops/reindex.local_reindex's contract:
//  - valid seeds keep slots 0..seed_count-1 VERBATIM (duplicates included;
//    lookups resolve to the FIRST slot holding a value);
//  - unique new neighbors follow in ascending-id order;
//  - masked-out lanes get local id 0.
// One open-addressing map + one sort of the (small) new-unique set replaces
// the numpy path's four full-width sort/searchsorted passes — this is where
// ~85% of the HostSampler's multi-hop time went.
// out_n_id must have room for seed_count + total entries (worst case).
void qt_reindex(const int64_t *head, int64_t seed_count, const int64_t *nbrs,
                const uint8_t *mask, int64_t total, int64_t *out_n_id,
                int64_t *out_count, int32_t *out_local) {
  const int64_t kEmpty = INT64_MIN;  // never a node id
  int64_t cap = 16;
  while (cap < 2 * (seed_count + total)) cap <<= 1;
  std::vector<int64_t> keys(static_cast<size_t>(cap), kEmpty);
  std::vector<int64_t> slots(static_cast<size_t>(cap), 0);
  const int64_t hmask = cap - 1;
  auto probe = [&](int64_t v) -> int64_t {  // index of v's cell (or empty)
    int64_t h = static_cast<int64_t>(splitmix64(static_cast<uint64_t>(v))) & hmask;
    while (keys[h] != kEmpty && keys[h] != v) h = (h + 1) & hmask;
    return h;
  };
  for (int64_t i = 0; i < seed_count; ++i) {
    int64_t h = probe(head[i]);
    if (keys[h] == kEmpty) {  // first slot wins (min-index contract)
      keys[h] = head[i];
      slots[h] = i;
    }
    out_n_id[i] = head[i];
  }
  std::vector<int64_t> new_vals;
  new_vals.reserve(static_cast<size_t>(total / 4 + 16));
  for (int64_t j = 0; j < total; ++j) {
    if (!mask[j]) continue;
    int64_t h = probe(nbrs[j]);
    if (keys[h] == kEmpty) {
      keys[h] = nbrs[j];
      new_vals.push_back(nbrs[j]);
    }
  }
  std::sort(new_vals.begin(), new_vals.end());
  for (size_t r = 0; r < new_vals.size(); ++r) {
    slots[probe(new_vals[r])] = seed_count + static_cast<int64_t>(r);
    out_n_id[seed_count + static_cast<int64_t>(r)] = new_vals[r];
  }
  *out_count = seed_count + static_cast<int64_t>(new_vals.size());
  for (int64_t j = 0; j < total; ++j)
    out_local[j] = mask[j] ? static_cast<int32_t>(slots[probe(nbrs[j])]) : 0;
}

// Parallel row gather by raw row size — dtype-agnostic (f32, bf16, f64,
// int rows all reduce to a strided memcpy; the reference's gather kernel is
// float32-only, quiver_feature.cu:65-69). Out-of-range ids zero their row.
void qt_gather_rows_bytes(const uint8_t *src, int64_t n, int64_t row_bytes,
                          const int64_t *ids, int64_t batch, uint8_t *out) {
  if (batch <= 0 || row_bytes <= 0) return;
  int64_t n_threads =
      std::max<int64_t>(1, std::min<int64_t>(
                               std::thread::hardware_concurrency(), batch));
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      const size_t rb = static_cast<size_t>(row_bytes);
      for (int64_t i = lo; i < hi; ++i) {
        int64_t id = ids[i];
        if (id < 0 || id >= n) {
          std::memset(out + i * row_bytes, 0, rb);
        } else {
          std::memcpy(out + i * row_bytes, src + id * row_bytes, rb);
        }
      }
    });
  }
  for (auto &th : threads) th.join();
}

// Parallel row gather out[i, :] = src[ids[i], :] — the host cold-tier path
// (float32 spelling, kept for ABI compatibility with round-3 callers).
void qt_gather_rows(const float *src, int64_t n, int64_t d, const int64_t *ids,
                    int64_t batch, float *out) {
  qt_gather_rows_bytes(reinterpret_cast<const uint8_t *>(src), n,
                       d * static_cast<int64_t>(sizeof(float)), ids, batch,
                       reinterpret_cast<uint8_t *>(out));
}

}  // extern "C"
