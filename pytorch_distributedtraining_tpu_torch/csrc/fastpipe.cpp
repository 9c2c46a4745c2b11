// fastpipe: host-side data-pipeline kernels of the port's input path.
//
// A copy of pytorch_distributedtraining_tpu/csrc/fastpipe.cpp (the same
// functions, the same arithmetic). What stays hot on the host before a
// batch is copied to the GPU is (a) collation, gathering N samples into one
// contiguous batch, and (b) u8 -> f32 normalisation with per-channel
// mean/std. Both are memory-bandwidth loops, run here over std::thread
// workers behind a plain C ABI that ctypes loads (no pybind11).
//
// Build (csrc/fastpipe.py does it at first use, into build/host/ at the
// repository root):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off fastpipe.cpp -o <lib>.so
// -ffp-contract=off keeps x*s + b two roundings, as numpy computes it.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// run fn(i) for i in [0, n) over up to n_threads workers
template <typename F>
void parallel_for(std::size_t n, int n_threads, F fn) {
  if (n == 0) return;
  int workers = std::max(1, std::min<int>(n_threads, (int)n));
  if (workers == 1) {
    for (std::size_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  std::size_t chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    std::size_t lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (std::size_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Stack n equally-sized samples into one contiguous batch buffer.
// srcs[i] -> dst + i * bytes_per. The memcpys are independent; parallelize
// across samples (each is typically 10s of KB to MBs).
void fp_stack(const void** srcs, std::int64_t n, std::int64_t bytes_per,
              void* dst, int n_threads) {
  char* out = static_cast<char*>(dst);
  parallel_for((std::size_t)n, n_threads, [=](std::size_t i) {
    std::memcpy(out + i * bytes_per, srcs[i], (std::size_t)bytes_per);
  });
}

// Fused u8 -> f32 normalize: dst[p*c + j] = (src[p*c + j]/255 - mean[j]) / std[j]
// over n_pixels pixels with c channels. Parallelized over pixel rows.
void fp_normalize_u8(const std::uint8_t* src, float* dst,
                     std::int64_t n_pixels, std::int64_t c,
                     const float* mean, const float* stddev, int n_threads) {
  // precompute per-channel scale/shift: y = x * s + b
  std::vector<float> s(c), b(c);
  for (std::int64_t j = 0; j < c; ++j) {
    s[j] = 1.0f / (255.0f * stddev[j]);
    b[j] = -mean[j] / stddev[j];
  }
  const std::size_t block = 4096;  // pixels per work item
  std::size_t n_blocks = (std::size_t)((n_pixels + block - 1) / block);
  parallel_for(n_blocks, n_threads, [=, &s, &b](std::size_t blk) {
    std::int64_t lo = (std::int64_t)(blk * block);
    std::int64_t hi = std::min<std::int64_t>(n_pixels, lo + (std::int64_t)block);
    for (std::int64_t p = lo; p < hi; ++p) {
      for (std::int64_t j = 0; j < c; ++j) {
        dst[p * c + j] = (float)src[p * c + j] * s[j] + b[j];
      }
    }
  });
}

// Strided gather-stack: like fp_stack but each source is copied through a
// row pitch (crop-from-decoded-image without an intermediate copy).
// For sample i: rows of row_bytes at src_pitch apart -> packed rows in dst.
void fp_stack_strided(const void** srcs, std::int64_t n, std::int64_t rows,
                      std::int64_t row_bytes, std::int64_t src_pitch,
                      void* dst, int n_threads) {
  char* out = static_cast<char*>(dst);
  std::int64_t sample_bytes = rows * row_bytes;
  parallel_for((std::size_t)n, n_threads, [=](std::size_t i) {
    const char* s = static_cast<const char*>(srcs[i]);
    char* d = out + (std::int64_t)i * sample_bytes;
    for (std::int64_t r = 0; r < rows; ++r) {
      std::memcpy(d + r * row_bytes, s + r * src_pitch,
                  (std::size_t)row_bytes);
    }
  });
}

int fp_version() { return 1; }

}  // extern "C"
