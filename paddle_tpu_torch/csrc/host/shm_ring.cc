// Shared-memory ring buffer: the DataLoader's batch transport between its
// worker processes and the training process (the port's own copy of
// paddle_tpu/native/csrc/shm_ring.cc; io/dataloader.py drives it through
// native/shm_ring.py).
//
// One ring per worker, single producer (the worker) and single consumer (the
// trainer). A worker pickles a collated batch into the next free slot of a
// POSIX shared-memory segment; the trainer copies it out in the order the
// control messages on the worker's queue announce. Slot layout:
// [u64 payload_len][payload]; the header holds the head and tail indices and
// the slot geometry, synchronised with atomics and a spin/yield wait
// (batches are large, contention is low). A payload larger than a slot is
// refused (-2), and the caller sends it through its queue instead.
//
// Host code, built with the host C++ compiler at first use
// (paddle_tpu_torch/native/__init__.py) and bound with ctypes.

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct RingHeader {
  std::atomic<uint64_t> head;  // next slot to write
  std::atomic<uint64_t> tail;  // next slot to read
  uint64_t n_slots;
  uint64_t slot_bytes;
  std::atomic<int32_t> closed;
};

struct Ring {
  RingHeader* hdr = nullptr;
  char* slots = nullptr;
  size_t total = 0;
  std::string name;
  bool owner = false;
};

char* slot_ptr(Ring* r, uint64_t idx) {
  return r->slots + (idx % r->hdr->n_slots) * r->hdr->slot_bytes;
}

}  // namespace

extern "C" {

// Create (owner=1) or open (owner=0) a ring of n_slots x slot_bytes.
void* shm_ring_open(const char* name, int owner, uint64_t n_slots,
                    uint64_t slot_bytes) {
  size_t total = sizeof(RingHeader) + n_slots * slot_bytes;
  int fd;
  if (owner) {
    ::shm_unlink(name);
    fd = ::shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
      ::close(fd);
      return nullptr;
    }
  } else {
    fd = ::shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st {};
    ::fstat(fd, &st);
    total = static_cast<size_t>(st.st_size);
  }
  void* mem =
      ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* r = new Ring();
  r->hdr = static_cast<RingHeader*>(mem);
  r->slots = static_cast<char*>(mem) + sizeof(RingHeader);
  r->total = total;
  r->name = name;
  r->owner = owner != 0;
  if (owner) {
    r->hdr->head.store(0);
    r->hdr->tail.store(0);
    r->hdr->n_slots = n_slots;
    r->hdr->slot_bytes = slot_bytes;
    r->hdr->closed.store(0);
  }
  return r;
}

// Push payload (blocks while full unless ring closed). 0 ok, -1 closed,
// -2 too large.
int shm_ring_push(void* h, const char* data, uint64_t len) {
  auto* r = static_cast<Ring*>(h);
  if (len + 8 > r->hdr->slot_bytes) return -2;
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    if (r->hdr->closed.load()) return -1;
    if (head - tail < r->hdr->n_slots) {
      char* p = slot_ptr(r, head);
      std::memcpy(p, &len, 8);
      std::memcpy(p + 8, data, len);
      r->hdr->head.store(head + 1, std::memory_order_release);
      return 0;
    }
    ::sched_yield();
  }
}

// Pop into buf (cap bytes). Returns payload len, -1 if closed+empty,
// -2 if buf too small, -3 timeout. timeout_ms<0 → block forever.
long long shm_ring_pop(void* h, char* buf, uint64_t cap, int timeout_ms) {
  auto* r = static_cast<Ring*>(h);
  int waited_us = 0;
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (tail < head) {
      char* p = slot_ptr(r, tail);
      uint64_t len;
      std::memcpy(&len, p, 8);
      if (len > cap) return -2;
      std::memcpy(buf, p + 8, len);
      r->hdr->tail.store(tail + 1, std::memory_order_release);
      return static_cast<long long>(len);
    }
    if (r->hdr->closed.load()) return -1;
    if (timeout_ms >= 0 && waited_us > timeout_ms * 1000) return -3;
    ::usleep(200);
    waited_us += 200;
  }
}

uint64_t shm_ring_size(void* h) {
  auto* r = static_cast<Ring*>(h);
  return r->hdr->head.load() - r->hdr->tail.load();
}

void shm_ring_close(void* h) { static_cast<Ring*>(h)->hdr->closed.store(1); }

void shm_ring_free(void* h) {
  auto* r = static_cast<Ring*>(h);
  ::munmap(r->hdr, r->total);
  if (r->owner) ::shm_unlink(r->name.c_str());
  delete r;
}

}  // extern "C"
