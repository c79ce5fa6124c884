// The ray store's sampler (the port's copy of native/raystore.cpp, built
// by hyperreel_tpu_torch/data/raystore.py with g++ into
// build/hyperreel_tpu_torch/).
//
// Dynamic scenes hold ~1e8 rays (the reference keeps them in RAM as torch
// tensors and samples with a Python RandomSampler, nlf/__init__.py:222-246).
// Here the store is a memory-mapped float32 matrix and a batch is gathered
// in C++ by worker threads, each with its own xorshift128+ generator: no
// Python in the sampling loop, no resident copy of the store. The rows of
// a batch depend on the seed and on the number of threads.
//
// A plain C ABI, bound with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// xorshift128+ per-thread generator
struct RngState {
  uint64_t s0, s1;
};

static inline uint64_t xorshift_next(RngState* st) {
  uint64_t x = st->s0;
  uint64_t const y = st->s1;
  st->s0 = y;
  x ^= x << 23;
  st->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return st->s1 + y;
}

// Gather `batch` random rows (with replacement) from `src` [n_rows, n_cols]
// into `dst` [batch, n_cols]. Deterministic given `seed`.
void raystore_sample(const float* src, int64_t n_rows, int64_t n_cols,
                     float* dst, int64_t batch, uint64_t seed,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t start = t * per;
    int64_t end = std::min(start + per, batch);
    if (start >= end) break;
    threads.emplace_back([=]() {
      RngState st{seed * 0x9E3779B97F4A7C15ULL + t * 0xBF58476D1CE4E5B9ULL + 1,
                  seed ^ (0x94D049BB133111EBULL + t)};
      // warm up
      for (int i = 0; i < 4; ++i) xorshift_next(&st);
      size_t row_bytes = static_cast<size_t>(n_cols) * sizeof(float);
      for (int64_t i = start; i < end; ++i) {
        uint64_t r = xorshift_next(&st) % static_cast<uint64_t>(n_rows);
        std::memcpy(dst + i * n_cols, src + r * n_cols, row_bytes);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Gather the rows at explicit indices.
void raystore_gather(const float* src, int64_t n_rows, int64_t n_cols,
                     const int64_t* indices, float* dst, int64_t batch,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t start = t * per;
    int64_t end = std::min(start + per, batch);
    if (start >= end) break;
    threads.emplace_back([=]() {
      size_t row_bytes = static_cast<size_t>(n_cols) * sizeof(float);
      for (int64_t i = start; i < end; ++i) {
        int64_t r = indices[i];
        if (r < 0 || r >= n_rows) r = 0;
        std::memcpy(dst + i * n_cols, src + r * n_cols, row_bytes);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
