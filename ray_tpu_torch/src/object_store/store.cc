// Shared-memory object store: the node-local zero-copy data plane.
//
// TPU-native equivalent of the reference's Plasma store (reference:
// src/ray/object_manager/plasma/{store.cc,object_lifecycle_manager.h,
// plasma_allocator.cc,dlmalloc.cc,eviction_policy.h}).  Differences by
// design: instead of a store *server* process with a unix-socket protocol
// and fd-passing (plasma/fling.cc), every client maps one shared segment
// and operates on it directly under a process-shared robust mutex — on a
// TPU-VM host all workers are local, so the socket hop is pure overhead.
// Create/seal/get/release/delete + LRU eviction of unpinned sealed objects
// match plasma semantics, deferred delete included: deleting a sealed object
// that a reader still pins only marks it delete-pending, and the release
// that drops the last pin frees the block.  Every pin a get takes is kept
// in a table under its reader's pid, so that when a reader dies holding
// pins the runtime drops them all (store_release_process), as plasma drops
// a client's pins when its connection goes.  Sealed buffers are immutable
// and consumable zero-copy (numpy arrays and CPU tensors over the mapped
// pages).
//
// Layout of the segment:
//   [Header][Slot * nslots][FreeBlock * MAX_FREE][PinEntry * MAX_PINS][data region ...]
//
// Build: g++ -O2 -shared -fPIC -o libray_tpu_torch_store.so store.cc -lpthread

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7470755f73746f72ULL;  // "tpu_stor"
constexpr uint32_t kIdLen = 28;
constexpr uint64_t kMaxFree = 1 << 14;
constexpr uint64_t kMaxPins = 1 << 16;
constexpr uint64_t kAlign = 64;

enum SlotState : uint32_t {
  EMPTY = 0,
  ALLOCATED = 1,  // created, not yet sealed
  SEALED = 2,
  TOMBSTONE = 3,
  // deleted while pinned: invisible to get/contains/create like a
  // tombstone, but its block stays allocated (and counted in used and
  // num_objects) until the last pin is released, by its reader or, when
  // the reader dies, by store_release_process.
  DELETE_PENDING = 4,
};

struct Slot {
  uint8_t id[kIdLen];
  uint32_t state;
  int32_t refcount;  // pins from get(); evictable only at 0
  uint64_t offset;   // into data region
  uint64_t size;     // total payload bytes
  uint64_t lru_tick;
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
};

// The pins one reader process holds on one block: get adds one, release
// drops one, store_release_process drops them all.
struct PinEntry {
  uint64_t seg_off;  // the pinned block, as get returned it
  int32_t pid;
  int32_t count;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;   // data region bytes
  uint64_t nslots;
  uint64_t used;       // allocated bytes
  uint64_t lru_clock;
  uint64_t nfree;      // entries in free list
  uint64_t num_objects;
  uint64_t evictions;
  uint64_t npins;      // entries in the pin table
  pthread_mutex_t mutex;
};

struct Store {
  Header* hdr;
  Slot* slots;
  FreeBlock* freelist;
  PinEntry* pins;
  uint8_t* data;
  void* base;
  uint64_t mapped_size;
};

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 28-byte id
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

class Locker {
 public:
  explicit Locker(Header* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->mutex);
    if (rc == EOWNERDEAD) {
      // A worker died holding the lock; state is still consistent because
      // all mutations are single-field or ordered (same recovery stance as
      // plasma's store-restart).  Mark consistent and continue.
      pthread_mutex_consistent(&h_->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->mutex); }

 private:
  Header* h_;
};

// Find the live slot for id, or an insertion slot if insert==true.
// Delete-pending slots are skipped in both modes: their id is dead to every
// caller but the pin holders, who release through find_pinned.
Slot* find_slot(Store* s, const uint8_t* id, bool insert) {
  uint64_t n = s->hdr->nslots;
  uint64_t i = hash_id(id) % n;
  Slot* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < n; probe++, i = (i + 1) % n) {
    Slot* sl = &s->slots[i];
    if (sl->state == EMPTY) {
      if (insert) return first_tomb ? first_tomb : sl;
      return nullptr;
    }
    if (sl->state == TOMBSTONE) {
      if (insert && !first_tomb) first_tomb = sl;
      continue;
    }
    if (sl->state == DELETE_PENDING) continue;
    if (memcmp(sl->id, id, kIdLen) == 0) return sl;
  }
  return insert ? first_tomb : nullptr;
}

uint64_t segment_offset(Store* s, const Slot* sl) {
  return (uint64_t)(s->data - (uint8_t*)s->base) + sl->offset;
}

// The slot a pin was taken on: same id and same block.  A live object and a
// delete-pending one may share an id (the id was re-created after the
// delete), so the id alone cannot say which one a release belongs to; the
// block can, because a pending block is never handed out again.
Slot* find_pinned(Store* s, const uint8_t* id, uint64_t seg_off) {
  uint64_t n = s->hdr->nslots;
  uint64_t i = hash_id(id) % n;
  for (uint64_t probe = 0; probe < n; probe++, i = (i + 1) % n) {
    Slot* sl = &s->slots[i];
    if (sl->state == EMPTY) return nullptr;
    if (sl->state == TOMBSTONE) continue;
    if (memcmp(sl->id, id, kIdLen) == 0 && segment_offset(s, sl) == seg_off) return sl;
  }
  return nullptr;
}

// First-fit allocate from the free list; returns UINT64_MAX on failure.
uint64_t alloc_block(Store* s, uint64_t size) {
  Header* h = s->hdr;
  for (uint64_t i = 0; i < h->nfree; i++) {
    FreeBlock* fb = &s->freelist[i];
    if (fb->size >= size) {
      uint64_t off = fb->offset;
      fb->offset += size;
      fb->size -= size;
      if (fb->size == 0) {
        s->freelist[i] = s->freelist[h->nfree - 1];
        h->nfree--;
      }
      h->used += size;
      return off;
    }
  }
  return UINT64_MAX;
}

void free_block(Store* s, uint64_t offset, uint64_t size) {
  Header* h = s->hdr;
  h->used -= size;  // account before coalescing grows `size` with already-free bytes
  // insert and coalesce with neighbors
  uint64_t end = offset + size;
  for (uint64_t i = 0; i < h->nfree;) {
    FreeBlock* fb = &s->freelist[i];
    if (fb->offset + fb->size == offset) {  // fb | block
      offset = fb->offset;
      size += fb->size;
      end = offset + size;
      s->freelist[i] = s->freelist[h->nfree - 1];
      h->nfree--;
      continue;
    }
    if (end == fb->offset) {  // block | fb
      size += fb->size;
      s->freelist[i] = s->freelist[h->nfree - 1];
      h->nfree--;
      continue;
    }
    i++;
  }
  if (h->nfree < kMaxFree) {
    s->freelist[h->nfree++] = FreeBlock{offset, size};
  }
  // else: leak the block (bounded by kMaxFree fragmentation; extremely rare)
}

// The pin table's entry of (block, pid), or null.
PinEntry* find_pin(Store* s, uint64_t seg_off, int32_t pid) {
  for (uint64_t i = 0; i < s->hdr->npins; i++) {
    PinEntry* p = &s->pins[i];
    if (p->seg_off == seg_off && p->pid == pid) return p;
  }
  return nullptr;
}

// Records one more pin of `pid` on the block.  With the table full the pin
// has no owner on record: only its own release drops it.
void add_pin(Store* s, uint64_t seg_off, int32_t pid) {
  PinEntry* p = find_pin(s, seg_off, pid);
  if (p) {
    p->count++;
  } else if (s->hdr->npins < kMaxPins) {
    s->pins[s->hdr->npins++] = PinEntry{seg_off, pid, 1};
  }
}

void drop_pin(Store* s, uint64_t seg_off, int32_t pid) {
  PinEntry* p = find_pin(s, seg_off, pid);
  if (p && --p->count == 0) *p = s->pins[--s->hdr->npins];
}

// The live or delete-pending slot whose block starts at `seg_off`.
Slot* slot_of_block(Store* s, uint64_t seg_off) {
  for (uint64_t i = 0; i < s->hdr->nslots; i++) {
    Slot* sl = &s->slots[i];
    if (sl->state != EMPTY && sl->state != TOMBSTONE && segment_offset(s, sl) == seg_off) return sl;
  }
  return nullptr;
}

uint64_t meta_bytes(uint64_t nslots) {
  return align_up(sizeof(Header) + nslots * sizeof(Slot) + kMaxFree * sizeof(FreeBlock) + kMaxPins * sizeof(PinEntry));
}

void map_tables(Store* s, uint64_t nslots) {
  s->slots = (Slot*)((uint8_t*)s->base + sizeof(Header));
  s->freelist = (FreeBlock*)((uint8_t*)s->slots + nslots * sizeof(Slot));
  s->pins = (PinEntry*)((uint8_t*)s->freelist + kMaxFree * sizeof(FreeBlock));
  s->data = (uint8_t*)s->base + meta_bytes(nslots);
}

void free_slot(Store* s, Slot* sl) {
  free_block(s, sl->offset, align_up(sl->size));
  sl->state = TOMBSTONE;
  s->hdr->num_objects--;
}

// Evict the least-recently-used sealed, unpinned object.  Returns freed bytes.
uint64_t evict_one(Store* s) {
  Header* h = s->hdr;
  Slot* victim = nullptr;
  for (uint64_t i = 0; i < h->nslots; i++) {
    Slot* sl = &s->slots[i];
    if (sl->state == SEALED && sl->refcount == 0) {
      if (!victim || sl->lru_tick < victim->lru_tick) victim = sl;
    }
  }
  if (!victim) return 0;
  uint64_t sz = victim->size;
  free_block(s, victim->offset, align_up(victim->size));
  victim->state = TOMBSTONE;
  h->num_objects--;
  h->evictions++;
  return sz;
}

}  // namespace

extern "C" {

// Create a fresh store segment at `path` (tmpfs file, e.g. /dev/shm/...).
void* store_create(const char* path, uint64_t capacity, uint64_t nslots) {
  uint64_t total = meta_bytes(nslots) + capacity;
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Store* s = new Store;
  s->base = base;
  s->mapped_size = total;
  s->hdr = (Header*)base;
  map_tables(s, nslots);
  Header* h = s->hdr;
  memset(h, 0, sizeof(Header));
  memset(s->slots, 0, nslots * sizeof(Slot));
  h->capacity = capacity;
  h->nslots = nslots;
  h->nfree = 1;
  s->freelist[0] = FreeBlock{0, capacity};
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  h->magic = kMagic;
  return s;
}

// Attach to an existing segment.
void* store_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* h = (Header*)base;
  if (h->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    return nullptr;
  }
  Store* s = new Store;
  s->base = base;
  s->mapped_size = (size_t)st.st_size;
  s->hdr = h;
  map_tables(s, h->nslots);
  return s;
}

void store_detach(void* sp) {
  Store* s = (Store*)sp;
  munmap(s->base, s->mapped_size);
  delete s;
}

// Allocate an object; returns 0 ok (offset from segment base in *out_offset),
// -1 already exists, -2 out of memory, -3 table full.
// allow_evict=0 never drops other objects to make room (-2 instead): the
// spilling path uses this so in-scope data is spilled to disk by policy
// rather than silently deleted by LRU (reference analog: spilling runs
// BEFORE eviction of referenced objects, raylet/local_object_manager.h).
int store_alloc_opts(void* sp, const uint8_t* id, uint64_t size, int allow_evict,
                     uint64_t* out_offset) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* existing = find_slot(s, id, false);
  if (existing && existing->state != TOMBSTONE) return -1;
  uint64_t need = align_up(size);
  if (need > s->hdr->capacity) return -2;
  uint64_t off = alloc_block(s, need);
  while (off == UINT64_MAX) {
    if (!allow_evict) return -2;
    if (evict_one(s) == 0) return -2;
    off = alloc_block(s, need);
  }
  Slot* sl = find_slot(s, id, true);
  if (!sl) {
    free_block(s, off, need);
    return -3;
  }
  memcpy(sl->id, id, kIdLen);
  sl->state = ALLOCATED;
  sl->refcount = 1;  // creator holds a pin until seal
  sl->offset = off;
  sl->size = size;
  sl->lru_tick = ++s->hdr->lru_clock;
  s->hdr->num_objects++;
  *out_offset = segment_offset(s, sl);
  return 0;
}

int store_alloc(void* sp, const uint8_t* id, uint64_t size, uint64_t* out_offset) {
  return store_alloc_opts(sp, id, size, 1, out_offset);
}

// List up to max_n spill/eviction candidates (sealed, unpinned), least
// recently used first.  out_ids receives max_n*kIdLen bytes, out_sizes the
// payload sizes.  Returns the count written.
int store_evict_candidates(void* sp, uint64_t max_n, uint8_t* out_ids,
                           uint64_t* out_sizes) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  struct Cand {
    Slot* sl;
    uint64_t tick;
  };
  std::vector<Cand> cands;
  for (uint64_t i = 0; i < s->hdr->nslots; i++) {
    Slot* sl = &s->slots[i];
    if (sl->state == SEALED && sl->refcount == 0) {
      cands.push_back({sl, sl->lru_tick});
    }
  }
  std::sort(cands.begin(), cands.end(),
            [](const Cand& a, const Cand& b) { return a.tick < b.tick; });
  uint64_t n = cands.size() < max_n ? cands.size() : max_n;
  for (uint64_t i = 0; i < n; i++) {
    memcpy(out_ids + i * kIdLen, cands[i].sl->id, kIdLen);
    out_sizes[i] = cands[i].sl->size;
  }
  return (int)n;
}

// Seal and drop the creator's pin in one locked step, so that no delete can
// fall between the two and leave the creator a pin it cannot name.
int store_seal(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  if (!sl || sl->state != ALLOCATED) return -1;
  sl->state = SEALED;
  if (sl->refcount > 0) sl->refcount--;
  return 0;
}

// Pin + locate a sealed object, the pin recorded under the caller's pid.
// 0 ok, -1 missing, -3 not sealed yet.
int store_get(void* sp, const uint8_t* id, uint64_t* out_offset, uint64_t* out_size) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  if (!sl || sl->state == TOMBSTONE) return -1;
  if (sl->state != SEALED) return -3;
  sl->refcount++;
  sl->lru_tick = ++s->hdr->lru_clock;
  add_pin(s, segment_offset(s, sl), (int32_t)getpid());
  *out_offset = segment_offset(s, sl);
  *out_size = sl->size;
  return 0;
}

// Drop one pin taken by alloc or get; `seg_off` is the offset that call
// returned.  The release that drops the last pin of a delete-pending object
// frees it (plasma's deferred delete).  -1 missing.
int store_release(void* sp, const uint8_t* id, uint64_t seg_off) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_pinned(s, id, seg_off);
  if (!sl) return -1;
  if (sl->refcount > 0) sl->refcount--;
  drop_pin(s, seg_off, (int32_t)getpid());
  if (sl->state == DELETE_PENDING && sl->refcount == 0) free_slot(s, sl);
  return 0;
}

// Drop every pin that process `pid` holds (it died holding them), freeing
// each delete-pending block whose last pin goes; a block deleted later is
// freed at once, since nothing pins it any more.  Returns the pins dropped.
// The caller must know `pid` dead: a live process's views would lose their
// blocks.
int store_release_process(void* sp, int32_t pid) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  int dropped = 0;
  for (uint64_t i = 0; i < s->hdr->npins;) {
    PinEntry* p = &s->pins[i];
    if (p->pid != pid) {
      i++;
      continue;
    }
    Slot* sl = slot_of_block(s, p->seg_off);
    if (sl) {
      sl->refcount = sl->refcount > p->count ? sl->refcount - p->count : 0;
      if (sl->state == DELETE_PENDING && sl->refcount == 0) free_slot(s, sl);
    }
    dropped += p->count;
    *p = s->pins[--s->hdr->npins];
  }
  return dropped;
}


int store_contains(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  return (sl && sl->state == SEALED) ? 1 : 0;
}

// The owner-driven free (the head's and the raylets' deletes).  A sealed
// object that a reader still pins becomes delete-pending and is freed by its
// last release, so a zero-copy view never outlives its block.  -1 missing.
int store_delete(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  if (!sl || sl->state == TOMBSTONE) return -1;
  if (sl->state == SEALED && sl->refcount > 0) {
    sl->state = DELETE_PENDING;
    return 0;
  }
  free_slot(s, sl);
  return 0;
}

// Delete only if no reader currently pins the object (spill path: a pinned
// zero-copy view must never have its backing block freed under it).
// 0 deleted, -1 missing, -2 pinned.
int store_delete_if_unpinned(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  if (!sl || sl->state == TOMBSTONE) return -1;
  if (sl->refcount > 0) return -2;
  free_slot(s, sl);
  return 0;
}

// Abort an unsealed create (creator-side failure path).
int store_abort(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Locker lock(s->hdr);
  Slot* sl = find_slot(s, id, false);
  if (!sl || sl->state != ALLOCATED) return -1;
  free_slot(s, sl);
  return 0;
}

uint64_t store_capacity(void* sp) { return ((Store*)sp)->hdr->capacity; }
uint64_t store_used(void* sp) { return ((Store*)sp)->hdr->used; }
uint64_t store_num_objects(void* sp) { return ((Store*)sp)->hdr->num_objects; }
uint64_t store_evictions(void* sp) { return ((Store*)sp)->hdr->evictions; }

uint8_t* store_base(void* sp) { return (uint8_t*)((Store*)sp)->base; }
uint64_t store_mapped_size(void* sp) { return ((Store*)sp)->mapped_size; }

}  // extern "C"
