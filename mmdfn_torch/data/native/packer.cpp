// Host-side batch packer of mmdfn_torch (data/_native.py loads it).
//
// A training batch is assembled from per-dialogue (len_i, D) float32
// feature arrays into statically padded (B, L, D) buffers, one a modality,
// and from per-dialogue labels into the (B, L) mask and labels.  numpy's
// path (data/batching.py:_pack) zero-fills the buffer and copies each
// dialogue over it; here each row of the batch is written once, its
// dialogue's rows copied and the rest of it zeroed, into a buffer the
// caller left uninitialised, split over a few threads when the batch is
// large.  The bytes equal numpy's.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -o libpacker.so packer.cpp

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// below this many bytes a batch is packed on the calling thread: starting
// threads costs more than they save
constexpr size_t kThreadedBytes = size_t(4) << 20;
constexpr int kMaxThreads = 4;

// fn(i) for i in [0, B), on up to kMaxThreads threads for a batch of
// ``bytes`` past kThreadedBytes
template <typename Fn>
void over_rows(int32_t B, size_t bytes, Fn fn) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = bytes >= kThreadedBytes && hw > 1 ? (hw < kMaxThreads ? hw : kMaxThreads) : 1;
  if (nt > B) nt = B > 0 ? B : 1;
  if (nt == 1) {
    for (int32_t i = 0; i < B; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      for (int32_t i = t; i < B; i += nt) fn(i);
    });
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// out (B, L, D) float32, every element written: row i < n holds
// srcs[i] ((lens[i], D), lens[i] <= L) then zeros, rows i >= n zeros.
void pack_f32(const float** srcs, const int32_t* lens, int32_t n, int32_t B,
              int32_t L, int32_t D, float* out) {
  const size_t row = static_cast<size_t>(L) * D;
  over_rows(B, sizeof(float) * row * B, [&](int32_t i) {
    float* dst = out + static_cast<size_t>(i) * row;
    size_t used = i < n ? static_cast<size_t>(lens[i]) * D : 0;
    if (used) std::memcpy(dst, srcs[i], sizeof(float) * used);
    std::memset(dst + used, 0, sizeof(float) * (row - used));
  });
}

// umask (B, L) float32: 1 on each dialogue's first lens[i] slots, else 0;
// label_out (B, L) int64: labels[i] there, else 0.
void pack_masks_labels(const int64_t** labels, const int32_t* lens,
                       int32_t n, int32_t B, int32_t L, float* umask,
                       int64_t* label_out) {
  for (int32_t i = 0; i < B; ++i) {
    const int32_t len = i < n ? lens[i] : 0;
    float* um = umask + static_cast<size_t>(i) * L;
    int64_t* lb = label_out + static_cast<size_t>(i) * L;
    for (int32_t t = 0; t < L; ++t) um[t] = t < len ? 1.0f : 0.0f;
    if (len) std::memcpy(lb, labels[i], sizeof(int64_t) * len);
    std::memset(lb + len, 0, sizeof(int64_t) * (L - len));
  }
}

}  // extern "C"
