// sdl_bridge: native staging layer for the TPU infeed path.
//
// TPU-native replacement for the capability the reference gets from the
// TensorFrames JNI bridge (SURVEY.md 2.15): moving DataFrame batches from
// the host runtime into device-feedable buffers without Python-loop
// overhead. Two pieces:
//
//   1. A fixed-slot staging ring (producer/consumer, FIFO, blocking with
//      timeouts) whose slots are stable, aligned allocations — batches are
//      assembled into a slot, handed to the transfer thread, and the slot
//      is recycled only after the device copy completes. This is the
//      double-buffered infeed the BASELINE.json north-star names.
//   2. Multi-threaded row packing: scatter N variable-length rows into a
//      contiguous padded [bucket, row_stride] matrix (memcpy fan-out),
//      the hot row-assembly loop that a Python loop serializes.
//
// Concurrency design is deliberately boring - one mutex + two condvars per
// ring, state machine per slot - so it is ThreadSanitizer-clean (see
// Makefile `tsan` target).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

enum class SlotState : uint8_t { kFree, kWriting, kReady, kReading };

struct Slot {
  uint8_t* data = nullptr;
  uint64_t n_rows = 0;
  uint64_t used_bytes = 0;
  SlotState state = SlotState::kFree;
};

constexpr size_t kAlign = 64;  // cache line; also friendly to DMA engines

}  // namespace

struct SdlRing {
  uint64_t slot_bytes = 0;
  std::vector<Slot> slots;
  std::deque<uint32_t> free_q;   // FIFO of free slot indices
  std::deque<uint32_t> ready_q;  // FIFO of committed slot indices
  std::mutex mu;
  std::condition_variable cv_free;
  std::condition_variable cv_ready;
  bool closed = false;

  ~SdlRing() {
    for (auto& s : slots) ::free(s.data);
  }
};

extern "C" {

SdlRing* sdl_ring_create(uint64_t slot_bytes, uint32_t n_slots) {
  if (slot_bytes == 0 || n_slots == 0) return nullptr;
  auto* r = new (std::nothrow) SdlRing();
  if (!r) return nullptr;
  r->slot_bytes = slot_bytes;
  r->slots.resize(n_slots);
  for (uint32_t i = 0; i < n_slots; ++i) {
    void* p = nullptr;
    if (posix_memalign(&p, kAlign, slot_bytes) != 0) {
      delete r;
      return nullptr;
    }
    r->slots[i].data = static_cast<uint8_t*>(p);
    r->free_q.push_back(i);
  }
  return r;
}

void sdl_ring_destroy(SdlRing* r) { delete r; }

uint64_t sdl_ring_slot_bytes(SdlRing* r) { return r->slot_bytes; }
uint32_t sdl_ring_n_slots(SdlRing* r) {
  return static_cast<uint32_t>(r->slots.size());
}

uint8_t* sdl_ring_slot_ptr(SdlRing* r, uint32_t idx) {
  if (idx >= r->slots.size()) return nullptr;
  return r->slots[idx].data;
}

// Returns a slot index to write into, or -1 on timeout / closed ring.
int64_t sdl_ring_acquire_write(SdlRing* r, double timeout_s) {
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return !r->free_q.empty() || r->closed; };
  if (timeout_s < 0) {
    r->cv_free.wait(lk, pred);
  } else if (!r->cv_free.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), pred)) {
    return -1;
  }
  if (r->closed || r->free_q.empty()) return -1;
  uint32_t idx = r->free_q.front();
  r->free_q.pop_front();
  r->slots[idx].state = SlotState::kWriting;
  return idx;
}

void sdl_ring_commit_write(SdlRing* r, uint32_t idx, uint64_t n_rows,
                           uint64_t used_bytes) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    Slot& s = r->slots[idx];
    s.n_rows = n_rows;
    s.used_bytes = used_bytes;
    s.state = SlotState::kReady;
    r->ready_q.push_back(idx);
  }
  r->cv_ready.notify_one();
}

// Producer changed its mind (e.g. error while filling): return the slot.
void sdl_ring_abort_write(SdlRing* r, uint32_t idx) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->slots[idx].state = SlotState::kFree;
    r->free_q.push_back(idx);
  }
  r->cv_free.notify_one();
}

// Returns a committed slot index (FIFO), or -1 on timeout, or -2 when the
// ring is closed AND drained (end of stream).
int64_t sdl_ring_acquire_read(SdlRing* r, double timeout_s) {
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return !r->ready_q.empty() || r->closed; };
  if (timeout_s < 0) {
    r->cv_ready.wait(lk, pred);
  } else if (!r->cv_ready.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), pred)) {
    return -1;
  }
  if (r->ready_q.empty()) return r->closed ? -2 : -1;
  uint32_t idx = r->ready_q.front();
  r->ready_q.pop_front();
  r->slots[idx].state = SlotState::kReading;
  return idx;
}

uint64_t sdl_ring_slot_rows(SdlRing* r, uint32_t idx) {
  std::lock_guard<std::mutex> lk(r->mu);
  return r->slots[idx].n_rows;
}

uint64_t sdl_ring_slot_used(SdlRing* r, uint32_t idx) {
  std::lock_guard<std::mutex> lk(r->mu);
  return r->slots[idx].used_bytes;
}

void sdl_ring_release_read(SdlRing* r, uint32_t idx) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->slots[idx].state = SlotState::kFree;
    r->free_q.push_back(idx);
  }
  r->cv_free.notify_one();
}

// Producer signals end-of-stream; readers drain then get -2.
void sdl_ring_close(SdlRing* r) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->cv_free.notify_all();
  r->cv_ready.notify_all();
}

int sdl_ring_closed(SdlRing* r) {
  std::lock_guard<std::mutex> lk(r->mu);
  return r->closed ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Multi-threaded row packing
// ---------------------------------------------------------------------------

// Scatter n_rows variable-length rows into dst with fixed row_stride.
// Bytes past each row's length up to row_stride are zero-filled. Rows
// [n_rows, pad_rows) are filled with a copy of row `pad_src_row` (the
// bucketed-padding convention: repeats of a valid row are numerically
// harmless and keep shapes static for XLA).
void sdl_pack_rows(uint8_t* dst, const uint8_t* const* srcs,
                   const uint64_t* src_bytes, uint64_t n_rows,
                   uint64_t pad_rows, uint64_t pad_src_row,
                   uint64_t row_stride, uint32_t n_threads) {
  if (n_rows == 0 && pad_rows == 0) return;
  if (n_threads == 0) n_threads = 1;
  const uint64_t total = pad_rows > n_rows ? pad_rows : n_rows;
  n_threads = static_cast<uint32_t>(
      std::min<uint64_t>(n_threads, total));

  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      uint8_t* out = dst + i * row_stride;
      if (i < n_rows) {
        const uint64_t nb = src_bytes[i] < row_stride ? src_bytes[i] : row_stride;
        std::memcpy(out, srcs[i], nb);
        if (nb < row_stride) std::memset(out + nb, 0, row_stride - nb);
      } else {
        // padding row: replicate pad_src_row's packed form; with no source
        // rows at all (n_rows==0, pad-only call) pad with zeros — srcs is
        // empty, so there is nothing to replicate.
        if (n_rows == 0) {
          std::memset(out, 0, row_stride);
        } else {
          const uint64_t j = pad_src_row < n_rows ? pad_src_row : 0;
          const uint64_t nb = src_bytes[j] < row_stride ? src_bytes[j] : row_stride;
          std::memcpy(out, srcs[j], nb);
          if (nb < row_stride) std::memset(out + nb, 0, row_stride - nb);
        }
      }
    }
  };

  if (n_threads == 1) {
    work(0, total);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const uint64_t chunk = (total + n_threads - 1) / n_threads;
  for (uint32_t t = 0; t < n_threads; ++t) {
    const uint64_t lo = t * chunk;
    const uint64_t hi = std::min<uint64_t>(lo + chunk, total);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// uint8 -> float32 with affine transform (scale * x + bias), threaded.
// Host-side fallback for feeds that must arrive as float (device-side
// preprocessing is preferred; see ops/preprocess.py).
void sdl_u8_to_f32(float* dst, const uint8_t* src, uint64_t n, float scale,
                   float bias, uint32_t n_threads) {
  if (n == 0) return;
  if (n_threads == 0) n_threads = 1;
  n_threads = static_cast<uint32_t>(std::min<uint64_t>(n_threads, n));
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i)
      dst[i] = scale * static_cast<float>(src[i]) + bias;
  };
  if (n_threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  const uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (uint32_t t = 0; t < n_threads; ++t) {
    const uint64_t lo = t * chunk;
    const uint64_t hi = std::min<uint64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
