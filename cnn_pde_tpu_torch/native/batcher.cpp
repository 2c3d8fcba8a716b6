// Native host-side input pipeline: shuffled batch gather with background
// prefetch (the counterpart of the reference's DataLoader worker processes),
// a copy of cnn_pde_tpu/native/batcher.cpp: the same shuffle, so the same
// batches for the same seed.
//
// A producer thread gathers shuffled (images, labels) batches into a ring of
// preallocated buffers while the device executes the previous step; the
// Python side pops completed batches via ctypes.  Shuffling uses xorshift64*
// Fisher-Yates so epochs are reproducible from a seed.
//
// Built at first use by cnn_pde_tpu_torch/native/binding.py:
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread batcher.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
};

struct Batcher {
  const float* images;   // (n, item_floats) borrowed; owner: Python
  const int32_t* labels; // (n,)
  int64_t n = 0;
  int64_t item_floats = 0;
  int64_t batch = 0;
  int64_t ring = 0;

  std::vector<float> img_ring;    // ring * batch * item_floats
  std::vector<int32_t> lab_ring;  // ring * batch
  std::vector<int64_t> order;

  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  int64_t produced = 0, consumed = 0;  // batch counters
  int64_t total_batches = 0;
  std::atomic<bool> stop{false};

  void produce_loop() {
    for (int64_t b = 0; b < total_batches && !stop.load(); ++b) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() || produced - consumed < ring;
        });
        if (stop.load()) return;
      }
      const int64_t slot = b % ring;
      float* img_dst = img_ring.data() + slot * batch * item_floats;
      int32_t* lab_dst = lab_ring.data() + slot * batch;
      const int64_t base = b * batch;
      for (int64_t i = 0; i < batch; ++i) {
        const int64_t src = order[base + i];
        std::memcpy(img_dst + i * item_floats, images + src * item_floats,
                    sizeof(float) * item_floats);
        lab_dst[i] = labels[src];
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ++produced;
      }
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* batcher_create(const float* images, const int32_t* labels, int64_t n,
                     int64_t item_floats, int64_t batch, int64_t ring,
                     uint64_t seed) {
  auto* b = new Batcher();
  b->images = images;
  b->labels = labels;
  b->n = n;
  b->item_floats = item_floats;
  b->batch = batch;
  b->ring = ring > 0 ? ring : 4;
  b->total_batches = n / batch;  // drop remainder (stable jit shapes)

  b->order.resize(n);
  for (int64_t i = 0; i < n; ++i) b->order[i] = i;
  XorShift rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(rng.next() % (uint64_t)(i + 1));
    std::swap(b->order[i], b->order[j]);
  }

  b->img_ring.resize(b->ring * batch * item_floats);
  b->lab_ring.resize(b->ring * batch);
  b->producer = std::thread(&Batcher::produce_loop, b);
  return b;
}

int64_t batcher_total_batches(void* handle) {
  return static_cast<Batcher*>(handle)->total_batches;
}

// Blocks until the next batch is ready; copies it into the caller's buffers.
// Returns 1 on success, 0 when the epoch is exhausted.
int batcher_next(void* handle, float* out_images, int32_t* out_labels) {
  auto* b = static_cast<Batcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(b->mu);
    if (b->consumed >= b->total_batches) return 0;
    b->cv_consume.wait(lk, [&] { return b->produced > b->consumed; });
  }
  const int64_t slot = b->consumed % b->ring;
  std::memcpy(out_images, b->img_ring.data() + slot * b->batch * b->item_floats,
              sizeof(float) * b->batch * b->item_floats);
  std::memcpy(out_labels, b->lab_ring.data() + slot * b->batch,
              sizeof(int32_t) * b->batch);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    ++b->consumed;
  }
  b->cv_produce.notify_one();
  return 1;
}

void batcher_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  b->stop.store(true);
  b->cv_produce.notify_all();
  b->cv_consume.notify_all();
  if (b->producer.joinable()) b->producer.join();
  delete b;
}

}  // extern "C"
