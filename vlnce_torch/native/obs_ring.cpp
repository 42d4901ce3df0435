// Shared-memory observation ring for the vectorized env pool.
//
// The reference moves observations from sim workers to the trainer by
// pickling them through multiprocessing pipes (habitat VectorEnv); at pano
// resolutions that is ~7 MB per env per step of serialize/copy/deserialize.
// This ring gives each worker a fixed slot in a POSIX shared-memory arena:
// workers memcpy raw sensor buffers in and bump a sequence counter; the
// parent-side gather assembles the [N, ...] batched arrays with one memcpy
// per sensor per slot — no pickling, no pipe traffic for bulk data.
//
// Layout: arena = n_slots * slot_bytes data + n_slots uint64 sequence
// counters (written release, read acquire). The Python side (ctypes, see
// vlnce_torch/envs/shm_transport.py) owns schema/offset bookkeeping.
//
// The creator reserves the arena's pages with posix_fallocate after
// ftruncate: a /dev/shm too small for the arena then fails the open (null
// handle) instead of raising SIGBUS inside a worker's memcpy later.
//
// Build: vlnce_torch/native/__init__.py compiles this file with g++ at its
// first use (g++ -O3 -std=c++17 -fPIC -shared -lrt).

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Ring {
  void* base = nullptr;
  size_t total_bytes = 0;
  int64_t n_slots = 0;
  int64_t slot_bytes = 0;

  uint8_t* slot(int64_t i) const {
    return static_cast<uint8_t*>(base) + i * slot_bytes;
  }
  std::atomic<uint64_t>* seq(int64_t i) const {
    auto* seq_base = reinterpret_cast<std::atomic<uint64_t>*>(
        static_cast<uint8_t*>(base) + n_slots * slot_bytes);
    return seq_base + i;
  }
};

size_t arena_bytes(int64_t n_slots, int64_t slot_bytes) {
  return static_cast<size_t>(n_slots) * slot_bytes + n_slots * sizeof(uint64_t);
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap Ring*), or null on failure.
// create=1: shm_unlink any stale segment, create + size it.
void* obs_ring_open(const char* name, int64_t n_slots, int64_t slot_bytes,
                    int create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  if (create) shm_unlink(name);
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = arena_bytes(n_slots, slot_bytes);
  if (create && (ftruncate(fd, bytes) != 0 ||
                 posix_fallocate(fd, 0, static_cast<off_t>(bytes)) != 0)) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Ring* ring = new Ring();
  ring->base = base;
  ring->total_bytes = bytes;
  ring->n_slots = n_slots;
  ring->slot_bytes = slot_bytes;
  if (create) {
    std::memset(base, 0, bytes);
  }
  return ring;
}

void obs_ring_close(void* handle, const char* name, int unlink) {
  Ring* ring = static_cast<Ring*>(handle);
  if (!ring) return;
  munmap(ring->base, ring->total_bytes);
  if (unlink) shm_unlink(name);
  delete ring;
}

// Worker side: copy `len` bytes into slot `i` at `offset`, then publish seq.
void obs_ring_write(void* handle, int64_t i, int64_t offset, const void* src,
                    int64_t len, uint64_t sequence) {
  Ring* ring = static_cast<Ring*>(handle);
  std::memcpy(ring->slot(i) + offset, src, len);
  ring->seq(i)->store(sequence, std::memory_order_release);
}

// Worker side without publishing (for multi-sensor writes; publish once).
void obs_ring_write_nopub(void* handle, int64_t i, int64_t offset,
                          const void* src, int64_t len) {
  Ring* ring = static_cast<Ring*>(handle);
  std::memcpy(ring->slot(i) + offset, src, len);
}

void obs_ring_publish(void* handle, int64_t i, uint64_t sequence) {
  Ring* ring = static_cast<Ring*>(handle);
  ring->seq(i)->store(sequence, std::memory_order_release);
}

uint64_t obs_ring_seq(void* handle, int64_t i) {
  Ring* ring = static_cast<Ring*>(handle);
  return ring->seq(i)->load(std::memory_order_acquire);
}

// Parent side: gather one sensor across slots into a batched dst buffer.
// slots: array of slot indices (n of them); src region [offset, offset+len)
// of each slot is copied to dst + k*len for k in 0..n-1.
void obs_ring_gather(void* handle, const int64_t* slots, int64_t n,
                     int64_t offset, int64_t len, void* dst) {
  Ring* ring = static_cast<Ring*>(handle);
  auto* out = static_cast<uint8_t*>(dst);
  for (int64_t k = 0; k < n; ++k) {
    std::memcpy(out + k * len, ring->slot(slots[k]) + offset, len);
  }
}

// Spin-wait (with pause) until every listed slot's seq >= target.
// Returns 0 on success, 1 on timeout (iteration bound).
int obs_ring_wait(void* handle, const int64_t* slots, int64_t n,
                  uint64_t target, int64_t max_spins) {
  Ring* ring = static_cast<Ring*>(handle);
  for (int64_t k = 0; k < n; ++k) {
    int64_t spins = 0;
    while (ring->seq(slots[k])->load(std::memory_order_acquire) < target) {
      if (++spins > max_spins) return 1;
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
    }
  }
  return 0;
}

}  // extern "C"
