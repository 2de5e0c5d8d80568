// Host-side batch assembly for the port's data loader.
//
// Multi-threaded gather of example rows into a contiguous batch buffer, so
// host-side batch assembly stays off the Python GIL and off the training
// loop's critical path. It feeds the prefetcher of
// dyffusion_tpu_torch/data/native_loader.py, which stages each batch into
// pinned memory and onto the GPU. A copy of dyffusion_tpu's
// data/_native/batch_gather.cpp: the port imports nothing of that package.
//
// Built on first use by native_loader.py into build/native/ with
//   g++ -O3 -shared -fPIC batch_gather.cpp -o <lib>.so -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather n_idx rows of `example_bytes` bytes each from `src` (row i at
// src + indices[i] * example_bytes) into the contiguous `dst` buffer.
// Spawns up to `n_threads` workers (0 => hardware concurrency).
void gather_rows(const uint8_t* src, const int64_t* indices, int64_t n_idx,
                 int64_t example_bytes, uint8_t* dst, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n_idx) n_threads = static_cast<int>(n_idx);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n_idx; ++i) {
      std::memcpy(dst + i * example_bytes, src + indices[i] * example_bytes,
                  static_cast<size_t>(example_bytes));
    }
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t per = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(lo + per, n_idx);
    if (lo >= hi) break;
    workers.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(dst + i * example_bytes, src + indices[i] * example_bytes,
                    static_cast<size_t>(example_bytes));
      }
    });
  }
  for (auto& w : workers) w.join();
}

// Fused gather + float32 cast from float64 sources (some xarray pipelines
// hand back f64; casting during the gather saves a second pass).
void gather_rows_f64_to_f32(const double* src, const int64_t* indices,
                            int64_t n_idx, int64_t example_elems, float* dst,
                            int n_threads) {
  if (n_idx <= 0) return;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n_idx) n_threads = static_cast<int>(n_idx);
  const int64_t per = (n_idx + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(lo + per, n_idx);
    if (lo >= hi) break;
    workers.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        const double* s = src + indices[i] * example_elems;
        float* d = dst + i * example_elems;
        for (int64_t j = 0; j < example_elems; ++j) d[j] = static_cast<float>(s[j]);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
