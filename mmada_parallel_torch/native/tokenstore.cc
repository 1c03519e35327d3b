// Native token-store: mmap'ed pre-tokenized sequence records with a
// C batch-gather API.
//
// The reference feeds training from per-item pickle files through torch
// DataLoader worker *processes* (MMaDA-Parallel-A/xllm/solvers/finetune/
// finetune.py:415-441, num_workers=16).  Here the hot path is one
// process instead: a single mmap'ed store and an O(bytes)
// memcpy batch gather that runs with the GIL released (ctypes), overlapped
// with device steps by a single Python prefetch thread.
//
// File layout (little-endian):
//   [0]  u64 magic = 0x544f4b53544f5245 ("TOKSTORE")
//   [8]  u64 version = 1
//   [16] u64 count              (number of records)
//   [24] u64 reserved
//   [32] u64 offsets[count+1]   (element offsets into the token area)
//   [..] i32 tokens[]           (concatenated records)
//
// Copy of mmada_parallel_tpu/native/tokenstore.cc; data/tokenstore.py builds
// it into mmada_parallel_torch/_build/:
//   g++ -O2 -shared -fPIC -o libtokenstore.so tokenstore.cc

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x544f4b53544f5245ULL;

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t count = 0;
  const uint64_t* offsets = nullptr;   // [count + 1]
  const int32_t* tokens = nullptr;
};

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or null on failure.
void* ts_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }

  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(mem);
  s->size = st.st_size;
  const uint64_t* hdr = reinterpret_cast<const uint64_t*>(s->base);
  if (hdr[0] != kMagic || hdr[1] != 1) {
    munmap(mem, st.st_size); ::close(fd); delete s; return nullptr;
  }
  s->count = hdr[2];
  // bounds-validate the header against the mapped size: a truncated or
  // corrupt store must fail at open, not SIGBUS inside ts_gather
  const uint64_t table_end = 32 + (s->count + 1) * sizeof(uint64_t);
  if (s->count > (static_cast<uint64_t>(st.st_size) / sizeof(uint64_t)) ||
      table_end > static_cast<uint64_t>(st.st_size)) {
    munmap(mem, st.st_size); ::close(fd); delete s; return nullptr;
  }
  s->offsets = reinterpret_cast<const uint64_t*>(s->base + 32);
  s->tokens = reinterpret_cast<const int32_t*>(s->base + table_end);
  const uint64_t token_bytes = st.st_size - table_end;
  if (s->offsets[0] != 0 ||
      s->offsets[s->count] * sizeof(int32_t) > token_bytes) {
    munmap(mem, st.st_size); ::close(fd); delete s; return nullptr;
  }
  for (uint64_t i = 0; i < s->count; ++i) {
    if (s->offsets[i] > s->offsets[i + 1]) {
      munmap(mem, st.st_size); ::close(fd); delete s; return nullptr;
    }
  }
  // advise the kernel we'll read records in random order
  madvise(mem, st.st_size, MADV_RANDOM);
  return s;
}

uint64_t ts_count(void* handle) {
  return handle ? static_cast<Store*>(handle)->count : 0;
}

int64_t ts_length(void* handle, uint64_t index) {
  auto* s = static_cast<Store*>(handle);
  if (!s || index >= s->count) return -1;
  return static_cast<int64_t>(s->offsets[index + 1] - s->offsets[index]);
}

// Gather `n` records into a padded [n, max_len] int32 row-major buffer.
// Rows longer than max_len are truncated; shorter rows are padded with
// `pad`.  out_lengths[i] receives the (untruncated) record length.
// Returns 0 on success.
int ts_gather(void* handle, const uint64_t* indices, uint64_t n,
              int32_t* out, uint64_t max_len, int32_t pad,
              int64_t* out_lengths) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t idx = indices[i];
    if (idx >= s->count) return 2;
    uint64_t beg = s->offsets[idx], end = s->offsets[idx + 1];
    uint64_t len = end - beg;
    uint64_t copy = len < max_len ? len : max_len;
    int32_t* row = out + i * max_len;
    std::memcpy(row, s->tokens + beg, copy * sizeof(int32_t));
    for (uint64_t j = copy; j < max_len; ++j) row[j] = pad;
    if (out_lengths) out_lengths[i] = static_cast<int64_t>(len);
  }
  return 0;
}

void ts_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

}  // extern "C"
