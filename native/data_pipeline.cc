// gpvae_tpu native data pipeline.
//
// The reference's data layer is pure-numpy host code: per-batch gather +
// reshuffle (src/Models/DataHandler.py:22-51), /255 normalize + 0.498
// binarize (:68-78), and the ragged sentinel(-1) -> per-sequence slicing
// pipeline (:129-156).  At production batch sizes the host side must keep a
// device fed; this library implements those transforms as a multithreaded C++
// runtime with a C ABI (consumed from Python via ctypes — no pybind11
// dependency), plus a prefetching batch assembler that overlaps host-side
// gather/shuffle with device compute.
//
// Layout contracts match gpvae_tpu/data/*.py; every entry point has a
// numpy fallback in gpvae_tpu/data/native.py and a parity test in
// tests/test_native.py.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

// Simple parallel-for over [0, n) with hardware threads.
void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t workers = std::max<int64_t>(1, std::min<int64_t>(hw, n));
  if (workers == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    int64_t lo = w * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// uint8 video frames -> float32 in {0,1}: fused /255 normalize + binarize
// (reference DataHandler._normalize_data + make_discrete, :68-78).
void gpvae_binarize_u8(const uint8_t* in, float* out, int64_t n,
                       float threshold) {
  const float scale = 1.0f / 255.0f;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = (static_cast<float>(in[i]) * scale >= threshold) ? 1.0f : 0.0f;
    }
  });
}

// float32 frames already in [0,1] -> binarized in place semantics.
void gpvae_binarize_f32(const float* in, float* out, int64_t n,
                        float threshold) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = (in[i] >= threshold) ? 1.0f : 0.0f;
    }
  });
}

// Batch assembly: out[b] = data[idx[b]] for row-major items of item_size
// floats (the gather inside DataHandler.data_batch, :38).
void gpvae_gather_batch(const float* data, const int64_t* idx, float* out,
                        int64_t batch, int64_t item_size) {
  parallel_for(batch, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      std::memcpy(out + b * item_size, data + idx[b] * item_size,
                  sizeof(float) * item_size);
    }
  });
}

// Ragged sentinel pipeline (SyntheticDataHandler._prep_dataset, :129-156):
// x_sent [N, T, D] with -1.0 marking hidden timesteps ->
//   x_clean [N, T, D] (hidden rows zeroed),
//   mask    [N, T] uint8 (1 = observed),
//   lengths [N] int32 (observed count per sequence).
void gpvae_pack_ragged(const float* x_sent, float* x_clean, uint8_t* mask,
                       int32_t* lengths, int64_t n, int64_t t, int64_t d) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t count = 0;
      for (int64_t s = 0; s < t; ++s) {
        const float* row = x_sent + (i * t + s) * d;
        float* out_row = x_clean + (i * t + s) * d;
        bool observed = row[0] > -1.0f;
        mask[i * t + s] = observed ? 1 : 0;
        count += observed ? 1 : 0;
        if (observed) {
          std::memcpy(out_row, row, sizeof(float) * d);
        } else {
          std::memset(out_row, 0, sizeof(float) * d);
        }
      }
      lengths[i] = count;
    }
  });
}

// ---------------------------------------------------------------------------
// Prefetching batch assembler: a background thread shuffles indices and
// gathers batches ahead of consumption (the overlap the reference's
// synchronous feed_dict loop cannot do, SURVEY.md §3.1 process boundary).
// ---------------------------------------------------------------------------

struct Prefetcher {
  const float* data;      // [n, item_size] borrowed, caller keeps alive
  int64_t n, item_size, batch;
  uint64_t seed;
  bool shuffle;
  int depth;

  std::vector<int64_t> order;
  int64_t pos = 0;
  std::mt19937_64 rng;

  std::deque<std::vector<float>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::thread worker;

  void fill_one(std::vector<float>& out) {
    if (pos + batch > n) {
      if (shuffle) std::shuffle(order.begin(), order.end(), rng);
      pos = 0;
    }
    out.resize(batch * item_size);
    for (int64_t b = 0; b < batch; ++b) {
      std::memcpy(out.data() + b * item_size,
                  data + order[pos + b] * item_size,
                  sizeof(float) * item_size);
    }
    pos += batch;
  }

  void run() {
    while (!stop.load()) {
      std::vector<float> buf;
      fill_one(buf);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] {
        return stop.load() || static_cast<int>(queue.size()) < depth;
      });
      if (stop.load()) return;
      queue.push_back(std::move(buf));
      cv_pop.notify_one();
    }
  }
};

void* gpvae_prefetcher_create(const float* data, int64_t n, int64_t item_size,
                              int64_t batch, uint64_t seed, int shuffle,
                              int depth) {
  // fill_one reads order[pos .. pos+batch): batch > n would read out of
  // bounds and emit garbage batches
  if (data == nullptr || n <= 0 || item_size <= 0 || batch <= 0 ||
      batch > n) {
    return nullptr;
  }
  auto* p = new Prefetcher();
  p->data = data;
  p->n = n;
  p->item_size = item_size;
  p->batch = batch;
  p->seed = seed;
  p->shuffle = shuffle != 0;
  p->depth = depth > 0 ? depth : 2;
  p->order.resize(n);
  for (int64_t i = 0; i < n; ++i) p->order[i] = i;
  p->rng.seed(seed);
  if (p->shuffle) std::shuffle(p->order.begin(), p->order.end(), p->rng);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks until the next prefetched batch is ready; copies it into out
// [batch, item_size].  Returns 1 on success, 0 if the prefetcher was
// stopped (so a consumer racing destroy() unblocks instead of deadlocking
// on an empty queue).
int gpvae_prefetcher_next(void* handle, float* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::vector<float> buf;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] { return p->stop.load() || !p->queue.empty(); });
    if (p->queue.empty()) return 0;  // stopped with nothing buffered
    buf = std::move(p->queue.front());
    p->queue.pop_front();
    p->cv_push.notify_one();
  }
  std::memcpy(out, buf.data(), sizeof(float) * buf.size());
  return 1;
}

void gpvae_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
