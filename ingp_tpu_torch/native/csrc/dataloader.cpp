// Native host-side ray-batch sampler with background prefetch.
//
// The port's copy of ingp_tpu/native/csrc/dataloader.cpp, the same
// source: one C++ thread gathers (img_idx, pix_idx) ray batches from the
// in-RAM dataset arrays into a ring of output slots while the device runs
// the previous step, overlapping host sampling with the step. Exposed
// through a plain C ABI consumed via ctypes (ingp_tpu_torch/native/
// loader.py).
//
// Determinism: xoshiro256** seeded per sampler; batch n is a pure
// function of (seed, n), independent of thread scheduling.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// xoshiro256** (public-domain algorithm)
struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline uint64_t bounded(uint64_t n) { return next() % n; }
};

struct Field {
  const float* data;    // (n_images, hw, width) float32
  int64_t width;
  float* out;           // per-slot outputs set at prefetch start
};

struct Sampler {
  // dataset geometry
  int64_t n_images = 0;
  int64_t hw = 0;
  // registered per-ray fields (rgb, normal, depth, ...)
  std::vector<Field> fields;
  const int64_t* labels = nullptr;  // optional (n_images, hw) int64

  uint64_t seed = 0;
  int strategy = 0;  // 0 = all_images, 1 = same_image
  int64_t batch = 0;
  std::atomic<uint64_t> batch_counter{0};

  // ring of prefetched slots
  struct Slot {
    std::vector<int32_t> img_idx, pix_idx;
    std::vector<std::vector<float>> field_data;
    std::vector<int64_t> label_data;
    uint64_t batch_id = 0;
    bool ready = false;
  };
  std::vector<Slot> ring;
  size_t head = 0, tail = 0;  // consumer reads head, producer fills tail
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread producer;
  std::atomic<bool> stop{false};

  void fill_slot(Slot& slot, uint64_t batch_id) {
    Xoshiro rng(seed ^ (batch_id * 0x9e3779b97f4a7c15ULL + 1));
    slot.batch_id = batch_id;
    const int64_t B = batch;
    slot.img_idx.resize(B);
    slot.pix_idx.resize(B);
    if (strategy == 1) {
      int32_t img = (int32_t)rng.bounded((uint64_t)n_images);
      for (int64_t i = 0; i < B; i++) slot.img_idx[i] = img;
    } else {
      for (int64_t i = 0; i < B; i++)
        slot.img_idx[i] = (int32_t)rng.bounded((uint64_t)n_images);
    }
    for (int64_t i = 0; i < B; i++)
      slot.pix_idx[i] = (int32_t)rng.bounded((uint64_t)hw);

    slot.field_data.resize(fields.size());
    for (size_t f = 0; f < fields.size(); f++) {
      const Field& fd = fields[f];
      auto& out = slot.field_data[f];
      out.resize(B * fd.width);
      for (int64_t i = 0; i < B; i++) {
        const float* src = fd.data +
            ((int64_t)slot.img_idx[i] * hw + slot.pix_idx[i]) * fd.width;
        std::memcpy(&out[i * fd.width], src,
                    sizeof(float) * (size_t)fd.width);
      }
    }
    if (labels) {
      slot.label_data.resize(B);
      for (int64_t i = 0; i < B; i++)
        slot.label_data[i] =
            labels[(int64_t)slot.img_idx[i] * hw + slot.pix_idx[i]];
    }
  }

  void producer_loop() {
    while (true) {
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] {
        return stop.load() || !ring[tail].ready;
      });
      if (stop.load()) return;
      size_t idx = tail;
      uint64_t bid = batch_counter.fetch_add(1);
      lk.unlock();

      fill_slot(ring[idx], bid);

      lk.lock();
      ring[idx].ready = true;
      tail = (tail + 1) % ring.size();
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* sampler_create(uint64_t seed, int64_t n_images, int64_t hw,
                     int64_t batch, int strategy) {
  auto* s = new Sampler();
  s->seed = seed;
  s->n_images = n_images;
  s->hw = hw;
  s->batch = batch;
  s->strategy = strategy;
  return s;
}

void sampler_add_field(void* handle, const float* data, int64_t width) {
  auto* s = static_cast<Sampler*>(handle);
  s->fields.push_back({data, width, nullptr});
}

void sampler_set_labels(void* handle, const int64_t* labels) {
  static_cast<Sampler*>(handle)->labels = labels;
}

void sampler_start(void* handle, int64_t n_slots) {
  auto* s = static_cast<Sampler*>(handle);
  s->ring.resize((size_t)n_slots);
  s->producer = std::thread([s] { s->producer_loop(); });
}

// Copy the next ready batch into caller buffers. field_outs: array of
// pointers, one per registered field; label_out nullable. Returns the
// batch id.
int64_t sampler_next(void* handle, int32_t* img_idx, int32_t* pix_idx,
                     float** field_outs, int64_t* label_out) {
  auto* s = static_cast<Sampler*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_ready.wait(lk, [&] { return s->ring[s->head].ready; });
  Sampler::Slot& slot = s->ring[s->head];
  lk.unlock();

  const int64_t B = s->batch;
  std::memcpy(img_idx, slot.img_idx.data(), sizeof(int32_t) * B);
  std::memcpy(pix_idx, slot.pix_idx.data(), sizeof(int32_t) * B);
  for (size_t f = 0; f < s->fields.size(); f++)
    std::memcpy(field_outs[f], slot.field_data[f].data(),
                sizeof(float) * slot.field_data[f].size());
  if (s->labels && label_out)
    std::memcpy(label_out, slot.label_data.data(), sizeof(int64_t) * B);
  int64_t bid = (int64_t)slot.batch_id;

  lk.lock();
  slot.ready = false;
  s->head = (s->head + 1) % s->ring.size();
  s->cv_free.notify_all();
  return bid;
}

void sampler_destroy(void* handle) {
  auto* s = static_cast<Sampler*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop.store(true);
  }
  s->cv_free.notify_all();
  if (s->producer.joinable()) s->producer.join();
  delete s;
}

}  // extern "C"
