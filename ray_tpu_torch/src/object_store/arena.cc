// TPU-native object store arena: a shared-memory allocator used by the node's
// object store. Counterpart of the reference's plasma store arena
// (reference: src/ray/object_manager/plasma/store.h:55, dlmalloc.cc), redesigned:
// allocation policy lives in the head/store-owner process (single allocator,
// no cross-process locks on the hot path); the shm segment itself holds only
// object payloads, which workers map read-only and read zero-copy.
//
// Exposed as a C API consumed from Python via ctypes (ray_tpu/_private/shm_store.py).
//
// Design:
//  - best-fit free list with boundary-tag coalescing, 64-byte alignment
//    (64B keeps payloads cache-line aligned for memcpy and friendly to
//    jax.numpy zero-copy views)
//  - offsets (not pointers) returned, valid across processes mapping the
//    same segment
//  - O(log n) best-fit via std::map<size, offsets>

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <set>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;

struct Block {
  uint64_t offset;
  uint64_t size;
};

class Arena {
 public:
  Arena(uint64_t capacity) : capacity_(capacity) {
    free_by_size_.insert({capacity, 0});
    free_by_offset_[0] = capacity;
  }

  // Returns offset, or UINT64_MAX on OOM.
  uint64_t Alloc(uint64_t size) {
    if (size == 0) size = kAlign;
    size = (size + kAlign - 1) & ~(kAlign - 1);
    auto it = free_by_size_.lower_bound({size, 0});
    if (it == free_by_size_.end()) return UINT64_MAX;
    uint64_t blk_size = it->first, blk_off = it->second;
    free_by_size_.erase(it);
    free_by_offset_.erase(blk_off);
    if (blk_size > size) {
      uint64_t rem_off = blk_off + size, rem_size = blk_size - size;
      free_by_size_.insert({rem_size, rem_off});
      free_by_offset_[rem_off] = rem_size;
    }
    allocated_[blk_off] = size;
    in_use_ += size;
    return blk_off;
  }

  // Returns freed payload size, 0 if unknown offset.
  uint64_t Free(uint64_t offset) {
    auto it = allocated_.find(offset);
    if (it == allocated_.end()) return 0;
    uint64_t size = it->second;
    allocated_.erase(it);
    in_use_ -= size;
    // Coalesce with next free block.
    auto next = free_by_offset_.find(offset + size);
    if (next != free_by_offset_.end()) {
      size += next->second;
      free_by_size_.erase({next->second, next->first});
      free_by_offset_.erase(next);
    }
    // Coalesce with previous free block.
    if (!free_by_offset_.empty()) {
      auto prev = free_by_offset_.lower_bound(offset);
      if (prev != free_by_offset_.begin()) {
        --prev;
        if (prev->first + prev->second == offset) {
          offset = prev->first;
          size += prev->second;
          free_by_size_.erase({prev->second, prev->first});
          free_by_offset_.erase(prev);
        }
      }
    }
    free_by_size_.insert({size, offset});
    free_by_offset_[offset] = size;
    return size;
  }

  uint64_t InUse() const { return in_use_; }
  uint64_t Capacity() const { return capacity_; }
  uint64_t NumAllocated() const { return allocated_.size(); }
  // Largest contiguous free block (for fragmentation stats / spill decisions).
  uint64_t LargestFree() const {
    if (free_by_size_.empty()) return 0;
    return free_by_size_.rbegin()->first;
  }

 private:
  uint64_t capacity_;
  uint64_t in_use_ = 0;
  // {size, offset} ordered set → best-fit = lower_bound({size, 0}).
  std::set<std::pair<uint64_t, uint64_t>> free_by_size_;
  std::map<uint64_t, uint64_t> free_by_offset_;  // offset -> size
  std::unordered_map<uint64_t, uint64_t> allocated_;  // offset -> size
};

struct Store {
  Arena arena;
  void* base = nullptr;
  uint64_t capacity = 0;
  int fd = -1;
  std::string shm_name;
  Store(uint64_t cap) : arena(cap), capacity(cap) {}
};

}  // namespace

extern "C" {

// Create (owner) a shm segment of `capacity` bytes named `name` and an arena
// managing it. Returns opaque handle or nullptr.
void* store_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)capacity) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Store* s = new Store(capacity);
  s->base = base;
  s->fd = fd;
  s->shm_name = name;
  return s;
}

// Map an existing segment (worker side). The arena in this handle is unused.
void* store_attach(const char* name, uint64_t capacity) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store(capacity);
  s->base = base;
  s->fd = fd;
  return s;
}

void store_destroy(void* handle, int unlink) {
  Store* s = (Store*)handle;
  if (!s) return;
  munmap(s->base, s->capacity);
  close(s->fd);
  if (unlink && !s->shm_name.empty()) shm_unlink(s->shm_name.c_str());
  delete s;
}

uint64_t store_alloc(void* handle, uint64_t size) {
  return ((Store*)handle)->arena.Alloc(size);
}

uint64_t store_free(void* handle, uint64_t offset) {
  return ((Store*)handle)->arena.Free(offset);
}

void* store_base(void* handle) { return ((Store*)handle)->base; }
uint64_t store_in_use(void* handle) { return ((Store*)handle)->arena.InUse(); }
uint64_t store_capacity(void* handle) { return ((Store*)handle)->capacity; }
uint64_t store_num_objects(void* handle) { return ((Store*)handle)->arena.NumAllocated(); }
uint64_t store_largest_free(void* handle) { return ((Store*)handle)->arena.LargestFree(); }

}  // extern "C"
