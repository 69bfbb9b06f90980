// Threaded prefetching batch loader for host-side input pipelines (the
// port's copy of native/loader.cpp, built by g++ at first use by
// kfac_tpu_torch/utils/native_loader.py).
//
// The counterpart of the reference's torch DataLoader workers
// (examples/vision/datasets.py uses torch's C++-backed loader): a
// background thread gathers shuffled samples from a (possibly
// memory-mapped) source array into preallocated batch buffers while the
// card computes, so host batch assembly overlaps the step. Exposed as a
// plain C ABI for ctypes. The shuffle is of the whole dataset: each rank
// of a data-parallel world runs the same stream and keeps its rows.
//
// Model: the Python side owns the source arrays (data, labels) and a ring
// of batch output buffers. The loader owns the shuffle order and the worker
// threads; `loader_next` blocks until the next batch slot is filled and
// returns its ring index; the consumer calls `loader_release` when the
// buffer has been handed to the device.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  int64_t ring_index;
  int64_t epoch;
};

struct Loader {
  const float* data;         // (n, sample_elems)
  const int32_t* labels;     // (n,)
  int64_t n;
  int64_t sample_elems;
  int64_t batch_size;
  int64_t n_ring;
  float* batch_data;         // ring: (n_ring, batch_size, sample_elems)
  int32_t* batch_labels;     // ring: (n_ring, batch_size)
  uint64_t seed;
  bool drop_last;
  // image augmentation (HWC layout); aug_h == 0 disables
  int64_t aug_h = 0, aug_w = 0, aug_c = 0, aug_pad = 0;
  bool aug_flip = false;
  // resume support: fast-forward the shuffle stream to this epoch so a
  // resumed run sees the same batch order the uninterrupted run would
  int64_t start_epoch = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_free;
  std::queue<Batch> ready;
  std::vector<int64_t> free_slots;
  std::atomic<bool> stop{false};

  // producer state (single producer thread builds the order, many copy
  // threads could be added later; one thread suffices for memcpy-bound work)
  int64_t batches_per_epoch() const {
    return drop_last ? n / batch_size : (n + batch_size - 1) / batch_size;
  }
};

// Random pad-crop + horizontal flip of one HWC image (the reference's
// RandomCrop(32, padding=4) + RandomHorizontalFlip pipeline,
// examples/vision/datasets.py). dy/dx are crop offsets into the
// zero-padded image: out(y, x) = in(y + dy - pad, x' + dx - pad) with
// x' mirrored when flipping; out-of-bounds source pixels are zero.
void augment_sample(const Loader* L, const float* src, float* dst,
                    int64_t dy, int64_t dx, bool flip) {
  const int64_t H = L->aug_h, W = L->aug_w, C = L->aug_c, P = L->aug_pad;
  for (int64_t y = 0; y < H; ++y) {
    float* drow = dst + y * W * C;
    const int64_t sy = y + dy - P;
    if (sy < 0 || sy >= H) {
      std::memset(drow, 0, sizeof(float) * W * C);
      continue;
    }
    const float* srow = src + sy * W * C;
    if (!flip) {
      // contiguous run of in-bounds source columns
      for (int64_t x = 0; x < W; ++x) {
        const int64_t sx = x + dx - P;
        if (sx < 0 || sx >= W) {
          std::memset(drow + x * C, 0, sizeof(float) * C);
        } else {
          std::memcpy(drow + x * C, srow + sx * C, sizeof(float) * C);
        }
      }
    } else {
      for (int64_t x = 0; x < W; ++x) {
        const int64_t sx = x + dx - P;
        if (sx < 0 || sx >= W) {
          std::memset(drow + x * C, 0, sizeof(float) * C);
        } else {
          std::memcpy(drow + x * C, srow + (W - 1 - sx) * C,
                      sizeof(float) * C);
        }
      }
    }
  }
}

void producer_loop(Loader* L) {
  std::mt19937_64 rng(L->seed);
  std::vector<int64_t> order(L->n);
  for (int64_t i = 0; i < L->n; ++i) order[i] = i;
  if (L->batches_per_epoch() == 0) return;  // nothing to produce; don't spin
  // advance the shuffle (and augmentation) stream past completed epochs
  for (int64_t e = 0; e < L->start_epoch; ++e) {
    std::shuffle(order.begin(), order.end(), rng);
    if (L->aug_h > 0) {
      std::uniform_int_distribution<int64_t> off(0, 2 * L->aug_pad);
      std::uniform_int_distribution<int> coin(0, 1);
      const int64_t nb = L->batches_per_epoch();
      for (int64_t i = 0; i < nb * L->batch_size; ++i) {
        off(rng); off(rng);
        if (L->aug_flip) coin(rng);
      }
    }
  }
  int64_t epoch = L->start_epoch;
  while (!L->stop.load()) {
    std::shuffle(order.begin(), order.end(), rng);
    const int64_t nb = L->batches_per_epoch();
    for (int64_t b = 0; b < nb && !L->stop.load(); ++b) {
      int64_t slot;
      {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_free.wait(lk, [L] {
          return L->stop.load() || !L->free_slots.empty();
        });
        if (L->stop.load()) return;
        slot = L->free_slots.back();
        L->free_slots.pop_back();
      }
      float* out = L->batch_data + slot * L->batch_size * L->sample_elems;
      int32_t* lab = L->batch_labels + slot * L->batch_size;
      const bool aug = L->aug_h > 0;
      std::uniform_int_distribution<int64_t> off(0, 2 * L->aug_pad);
      std::uniform_int_distribution<int> coin(0, 1);
      for (int64_t j = 0; j < L->batch_size; ++j) {
        // wrap for the final ragged batch when drop_last is false
        int64_t idx = order[(b * L->batch_size + j) % L->n];
        const float* src = L->data + idx * L->sample_elems;
        float* dst = out + j * L->sample_elems;
        if (aug) {
          const int64_t dy = off(rng), dx = off(rng);
          const bool flip = L->aug_flip && coin(rng) == 1;
          augment_sample(L, src, dst, dy, dx, flip);
        } else {
          std::memcpy(dst, src, sizeof(float) * L->sample_elems);
        }
        lab[j] = L->labels[idx];
      }
      {
        std::lock_guard<std::mutex> lk(L->mu);
        L->ready.push(Batch{slot, epoch});
      }
      L->cv_ready.notify_one();
    }
    ++epoch;
  }
}

}  // namespace

extern "C" {

// Full-featured constructor: random pad-crop (+/- pad pixels) + optional
// horizontal flip per sample when h > 0 (HWC images; h*w*c == sample_elems),
// and shuffle-stream fast-forward to start_epoch for resumed runs.
void* loader_create_aug(const float* data, const int32_t* labels, int64_t n,
                        int64_t sample_elems, int64_t batch_size,
                        int64_t n_ring, float* batch_data,
                        int32_t* batch_labels, uint64_t seed, int drop_last,
                        int64_t h, int64_t w, int64_t c, int64_t pad,
                        int flip, int64_t start_epoch) {
  auto* L = new Loader();
  L->data = data;
  L->labels = labels;
  L->n = n;
  L->sample_elems = sample_elems;
  L->batch_size = batch_size;
  L->n_ring = n_ring;
  L->batch_data = batch_data;
  L->batch_labels = batch_labels;
  L->seed = seed;
  L->drop_last = drop_last != 0;
  L->aug_h = h;
  L->aug_w = w;
  L->aug_c = c;
  L->aug_pad = pad;
  L->aug_flip = flip != 0;
  L->start_epoch = start_epoch;
  for (int64_t s = 0; s < n_ring; ++s) L->free_slots.push_back(s);
  L->workers.emplace_back(producer_loop, L);
  return L;
}

void* loader_create(const float* data, const int32_t* labels, int64_t n,
                    int64_t sample_elems, int64_t batch_size, int64_t n_ring,
                    float* batch_data, int32_t* batch_labels, uint64_t seed,
                    int drop_last) {
  return loader_create_aug(data, labels, n, sample_elems, batch_size, n_ring,
                           batch_data, batch_labels, seed, drop_last,
                           /*h=*/0, /*w=*/0, /*c=*/0, /*pad=*/0, /*flip=*/0,
                           /*start_epoch=*/0);
}

// Blocks until a batch is ready; returns its ring index and writes the
// epoch it belongs to. Returns -1 if the loader is stopping.
int64_t loader_next(void* handle, int64_t* epoch_out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [L] { return L->stop.load() || !L->ready.empty(); });
  if (L->ready.empty()) return -1;
  Batch b = L->ready.front();
  L->ready.pop();
  if (epoch_out) *epoch_out = b.epoch;
  return b.ring_index;
}

// Marks a ring slot as consumable again.
void loader_release(void* handle, int64_t ring_index) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_slots.push_back(ring_index);
  }
  L->cv_free.notify_one();
}

int64_t loader_batches_per_epoch(void* handle) {
  return static_cast<Loader*>(handle)->batches_per_epoch();
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
