// Host-side data-path kernels for the input pipeline (the port's copy of
// the JAX package's runtime/host_ops.cpp), built by g++ at first use and
// bound by ctypes in runtime/native.py:
//
//   gather_scale_f32    : batched sample gather times 1/scale
//   gather_residual_f32 : fused gather of (hr - lms) residual batches
//   u16_to_f32_scale    : raw uint16 counts -> float32 times 1/scale
//
// Each output element is one float32 operation on its inputs, as numpy's
// (data/h5.py), so the results are the same bits. All functions take
// contiguous row-major arrays; `item` is the per-sample element count
// (C*H*W). Work is split over std::threads by sample (or 1 Mi chunk).

#include <cstdint>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::min<int64_t>(n, hw ? hw : 4);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([=] {
      for (int64_t i = t; i < n; i += n_threads) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void gather_scale_f32(const float* src, const int64_t* idx, int64_t n_idx,
                      int64_t item, float inv_scale, float* out) {
  parallel_for(n_idx, [=](int64_t i) {
    const float* s = src + idx[i] * item;
    float* d = out + i * item;
    for (int64_t j = 0; j < item; ++j) d[j] = s[j] * inv_scale;
  });
}

void gather_residual_f32(const float* hr, const float* lms, const int64_t* idx,
                         int64_t n_idx, int64_t item, float* out) {
  parallel_for(n_idx, [=](int64_t i) {
    const float* a = hr + idx[i] * item;
    const float* b = lms + idx[i] * item;
    float* d = out + i * item;
    for (int64_t j = 0; j < item; ++j) d[j] = a[j] - b[j];
  });
}

void u16_to_f32_scale(const uint16_t* src, int64_t n, float inv_scale,
                      float* out) {
  const int64_t chunk = 1 << 20;
  int64_t n_chunks = (n + chunk - 1) / chunk;
  parallel_for(n_chunks, [=](int64_t c) {
    int64_t lo = c * chunk;
    int64_t hi = std::min(n, lo + chunk);
    for (int64_t j = lo; j < hi; ++j) out[j] = float(src[j]) * inv_scale;
  });
}

}  // extern "C"
