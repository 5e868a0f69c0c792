// Mutable shared-memory ring channels for compiled-DAG actor pipelines.
//
// Counterpart of the reference's mutable-object channel machinery
// (reference: src/ray/core_worker/experimental_mutable_object_manager.h:44
// — WriteAcquire/WriteRelease + ReadAcquire/ReadRelease over a reusable
// plasma buffer; python/ray/experimental/channel/shared_memory_channel.py).
//
// One channel = one POSIX shm region holding a fixed header plus
// `num_slots` payload slots REUSED round-robin: no allocation, no
// object-store bookkeeping, no RPC on the per-message path. Single
// writer, fixed num_readers; each reader consumes every message exactly
// once, in order. Multiple slots let the producer run ahead, which
// amortizes context switches — decisive when producer and consumer
// share a core.
//
// Protocol (32-bit atomics in process-shared memory, futex-waitable):
//   writer (message s, slot = s % num_slots):
//     wait acks[slot] == num_readers   (slot s-num_slots fully consumed)
//     fill payload[slot], len[slot] = n
//     acks[slot] = 0, seq = s+1 (release), futex_wake(seq)
//   reader (cursor r, slot = r % num_slots):
//     wait (int32)(seq - r) > 0
//     use payload[slot] ... acks[slot] += 1 (release), futex_wake(acks[slot])
//
// Waiting spins briefly on multi-core (sub-microsecond handoff when the
// peer runs elsewhere), and parks on a futex immediately on single-core
// boxes (spinning would burn exactly the cycles the peer needs).
// close() wakes every word so teardown never deadlocks.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <linux/futex.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#define RTPU_PAUSE() _mm_pause()
#else
#define RTPU_PAUSE() ((void)0)
#endif

namespace {

constexpr uint64_t kMagic = 0x5254505543484134ULL;  // "RTPUCHA4"
constexpr size_t kHeaderSize = 512;
constexpr uint32_t kMaxSlots = 16;

int spin_budget() {
  static int budget = [] {
    long n = sysconf(_SC_NPROCESSORS_ONLN);
    return n > 1 ? 6000 : 1;
  }();
  return budget;
}

struct Header {
  uint64_t magic;
  uint64_t capacity;            // per-slot payload bytes
  uint32_t num_readers;
  uint32_t num_slots;
  std::atomic<uint32_t> seq;    // messages published (futex word)
  std::atomic<uint32_t> closed;
  std::atomic<uint32_t> attach; // live handles across all processes; the
                                // LAST detacher unlinks the shm name, so a
                                // creator GC'd early can't yank the region
                                // from readers still holding it
  std::atomic<uint32_t> acks[kMaxSlots];  // futex words
  std::atomic<uint64_t> len[kMaxSlots];
};
static_assert(sizeof(Header) <= kHeaderSize, "header grew past its slot");

struct Chan {
  Header* hdr = nullptr;
  uint8_t* payload = nullptr;   // num_slots * capacity
  size_t map_size = 0;
  std::string name;
  uint32_t cursor = 0;          // reader-side next message index
  int acquired_read_slot = -1;
  int acquired_write_slot = -1;
};

std::mutex g_lock;
std::vector<Chan*> g_chans;

int64_t put_handle(Chan* c) {
  std::lock_guard<std::mutex> g(g_lock);
  for (size_t i = 0; i < g_chans.size(); i++) {
    if (g_chans[i] == nullptr) {
      g_chans[i] = c;
      return static_cast<int64_t>(i);
    }
  }
  g_chans.push_back(c);
  return static_cast<int64_t>(g_chans.size() - 1);
}

Chan* get_handle(int64_t h) {
  std::lock_guard<std::mutex> g(g_lock);
  if (h < 0 || static_cast<size_t>(h) >= g_chans.size()) return nullptr;
  return g_chans[h];
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

int futex_wait(std::atomic<uint32_t>* word, uint32_t expected,
               double timeout_s) {
  struct timespec ts;
  ts.tv_sec = static_cast<time_t>(timeout_s);
  ts.tv_nsec = static_cast<long>((timeout_s - ts.tv_sec) * 1e9);
  return static_cast<int>(syscall(SYS_futex,
                                  reinterpret_cast<uint32_t*>(word),
                                  FUTEX_WAIT, expected, &ts, nullptr, 0));
}

void futex_wake_all(std::atomic<uint32_t>* word) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAKE, INT32_MAX,
          nullptr, nullptr, 0);
}

// Wait until pred(load()) or closed/timeout. The futex word must change
// whenever pred can flip. Sets *status: 0 ok, -1 timeout, -2 closed.
template <typename P>
uint32_t wait_word(std::atomic<uint32_t>* word, P pred,
                   const std::atomic<uint32_t>& closed, double timeout_s,
                   int* status) {
  int spins = spin_budget();
  for (int i = 0; i < spins; i++) {
    uint32_t v = word->load(std::memory_order_acquire);
    if (pred(v)) { *status = 0; return v; }
    if (closed.load(std::memory_order_relaxed)) { *status = -2; return v; }
    RTPU_PAUSE();
  }
  const double deadline = now_s() + timeout_s;
  while (true) {
    uint32_t v = word->load(std::memory_order_acquire);
    if (pred(v)) { *status = 0; return v; }
    if (closed.load(std::memory_order_relaxed)) { *status = -2; return v; }
    double left = deadline - now_s();
    if (left <= 0) { *status = -1; return v; }
    // Bounded slice so a missed wake (peer raced between load and wait)
    // still re-checks promptly.
    futex_wait(word, v, left < 0.2 ? left : 0.2);
  }
}

int64_t open_impl(const char* name, uint64_t capacity, uint32_t num_readers,
                  uint32_t num_slots, bool create) {
  if (create && (num_slots == 0 || num_slots > kMaxSlots)) return -EINVAL;
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return -errno;
  size_t map_size;
  if (create) {
    map_size = kHeaderSize + capacity * num_slots;
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
      int e = errno;
      close(fd);
      shm_unlink(name);
      return -e;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(kHeaderSize)) {
      close(fd);
      return -EINVAL;
    }
    map_size = static_cast<size_t>(st.st_size);
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;
  auto* hdr = reinterpret_cast<Header*>(mem);
  if (create) {
    hdr->capacity = capacity;
    hdr->num_readers = num_readers;
    hdr->num_slots = num_slots;
    hdr->seq.store(0, std::memory_order_relaxed);
    hdr->closed.store(0, std::memory_order_relaxed);
    hdr->attach.store(1, std::memory_order_relaxed);
    for (uint32_t i = 0; i < kMaxSlots; i++) {
      // Every slot starts fully acked: the first num_slots writes
      // proceed immediately.
      hdr->acks[i].store(num_readers, std::memory_order_relaxed);
      hdr->len[i].store(0, std::memory_order_relaxed);
    }
    hdr->magic = kMagic;  // last: openers validate it
  } else if (hdr->magic != kMagic) {
    munmap(mem, map_size);
    return -EINVAL;
  } else {
    hdr->attach.fetch_add(1, std::memory_order_acq_rel);
  }
  auto* c = new Chan();
  c->hdr = hdr;
  c->payload = reinterpret_cast<uint8_t*>(mem) + kHeaderSize;
  c->map_size = map_size;
  c->name = name;
  return put_handle(c);
}

}  // namespace

extern "C" {

int64_t rtpu_chan_create(const char* name, uint64_t capacity,
                         uint32_t num_readers, uint32_t num_slots) {
  return open_impl(name, capacity, num_readers, num_slots, true);
}

int64_t rtpu_chan_open(const char* name) {
  return open_impl(name, 0, 0, 1, false);
}

uint64_t rtpu_chan_capacity(int64_t h) {
  Chan* c = get_handle(h);
  return c ? c->hdr->capacity : 0;
}

// Wait until the next slot's previous occupant is fully consumed;
// returns the slot payload pointer for zero-copy serialization, or NULL
// (timeout/closed).
uint8_t* rtpu_chan_write_acquire(int64_t h, double timeout_s) {
  Chan* c = get_handle(h);
  if (!c || c->acquired_write_slot >= 0) return nullptr;
  Header* hd = c->hdr;
  uint32_t slot = hd->seq.load(std::memory_order_relaxed) % hd->num_slots;
  int status;
  uint32_t readers = hd->num_readers;
  wait_word(&hd->acks[slot], [readers](uint32_t v) { return v >= readers; },
            hd->closed, timeout_s, &status);
  if (status != 0) return nullptr;
  c->acquired_write_slot = static_cast<int>(slot);
  return c->payload + static_cast<size_t>(slot) * hd->capacity;
}

// Publish a message of `len` bytes written into the acquired slot.
int rtpu_chan_write_commit(int64_t h, uint64_t len) {
  Chan* c = get_handle(h);
  if (!c || c->acquired_write_slot < 0 || len > c->hdr->capacity) return -1;
  uint32_t slot = static_cast<uint32_t>(c->acquired_write_slot);
  c->acquired_write_slot = -1;
  c->hdr->len[slot].store(len, std::memory_order_relaxed);
  c->hdr->acks[slot].store(0, std::memory_order_relaxed);
  c->hdr->seq.fetch_add(1, std::memory_order_release);
  futex_wake_all(&c->hdr->seq);
  return 0;
}

// Abandon an acquired-but-uncommitted write slot (e.g. serialization into
// the mapped region raised mid-way). Nothing is published; the next
// write_acquire starts fresh on the same slot.
int rtpu_chan_write_abort(int64_t h) {
  Chan* c = get_handle(h);
  if (!c || c->acquired_write_slot < 0) return -1;
  c->acquired_write_slot = -1;
  return 0;
}

// Convenience: acquire + memcpy + commit.
int rtpu_chan_write(int64_t h, const uint8_t* buf, uint64_t len,
                    double timeout_s) {
  Chan* c = get_handle(h);
  if (!c || len > c->hdr->capacity) return -1;
  uint8_t* dst = rtpu_chan_write_acquire(h, timeout_s);
  if (!dst) return -2;
  memcpy(dst, buf, len);
  return rtpu_chan_write_commit(h, len);
}

// Wait for the next unseen message. On success returns its length and
// sets *out_ptr to the slot payload (valid until read_release). Returns
// -1 timeout, -2 closed, -3 bad handle / double acquire.
int64_t rtpu_chan_read_acquire(int64_t h, const uint8_t** out_ptr,
                               double timeout_s) {
  Chan* c = get_handle(h);
  if (!c || c->acquired_read_slot >= 0) return -3;
  Header* hd = c->hdr;
  uint32_t cur = c->cursor;
  int status;
  wait_word(&hd->seq,
            [cur](uint32_t v) {
              return static_cast<int32_t>(v - cur) > 0;  // wrap-safe
            },
            hd->closed, timeout_s, &status);
  if (status != 0) return status == -2 ? -2 : -1;
  uint32_t slot = cur % hd->num_slots;
  c->cursor = cur + 1;
  c->acquired_read_slot = static_cast<int>(slot);
  *out_ptr = c->payload + static_cast<size_t>(slot) * hd->capacity;
  return static_cast<int64_t>(hd->len[slot].load(std::memory_order_relaxed));
}

int rtpu_chan_read_release(int64_t h) {
  Chan* c = get_handle(h);
  if (!c || c->acquired_read_slot < 0) return -1;
  uint32_t slot = static_cast<uint32_t>(c->acquired_read_slot);
  c->acquired_read_slot = -1;
  c->hdr->acks[slot].fetch_add(1, std::memory_order_release);
  futex_wake_all(&c->hdr->acks[slot]);
  return 0;
}

// Mark closed (wakes all waiters with the closed error).
int rtpu_chan_close(int64_t h) {
  Chan* c = get_handle(h);
  if (!c) return -1;
  c->hdr->closed.store(1, std::memory_order_release);
  futex_wake_all(&c->hdr->seq);
  for (uint32_t i = 0; i < c->hdr->num_slots; i++) {
    futex_wake_all(&c->hdr->acks[i]);
  }
  return 0;
}

int rtpu_chan_is_closed(int64_t h) {
  Chan* c = get_handle(h);
  return (c && c->hdr->closed.load(std::memory_order_acquire)) ? 1 : 0;
}

// Detach this handle. The shm name is unlinked only when the LAST
// attached handle (across all processes) detaches — a creator handle
// GC'd while a reader still drains cannot yank the region (the old
// creator-unlinks rule did exactly that). `force_unlink` (=2) unlinks
// unconditionally.
int rtpu_chan_destroy(int64_t h, int force_unlink) {
  Chan* c = get_handle(h);
  if (!c) return -1;
  {
    std::lock_guard<std::mutex> g(g_lock);
    g_chans[h] = nullptr;
  }
  uint32_t prev = c->hdr->attach.fetch_sub(1, std::memory_order_acq_rel);
  bool last = (prev <= 1);
  munmap(reinterpret_cast<void*>(c->hdr), c->map_size);
  // A crashed peer never decrements its attach count; compiled-DAG
  // teardown force-unlinks every channel name it created
  // (rtpu_chan_force_unlink) so those regions are reclaimed once the
  // surviving mappings close. Ad-hoc channels whose holders all crash
  // leak the name until reboot — standard POSIX shm semantics.
  if (last || force_unlink == 2) shm_unlink(c->name.c_str());
  delete c;
  return 0;
}

// Remove the shm NAME regardless of attach count (existing mappings
// stay valid; the memory is reclaimed when they unmap or die). Used by
// compiled-DAG teardown, which knows every reader has been woken by
// close() and no new opens are coming.
int rtpu_chan_force_unlink(const char* name) {
  return shm_unlink(name) == 0 ? 0 : -errno;
}

}  // extern "C"
