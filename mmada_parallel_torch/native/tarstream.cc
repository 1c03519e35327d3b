// Native tar-shard streamer: sequential tar parsing + file IO on a C++
// prefetch thread, entries handed to Python as (name, bytes).
//
// The reference streams webdataset tar shards through Python tarfile inside
// torch DataLoader worker processes (MMaDA-Parallel-M/training/data.py:
// 73-108, 279-286).  Here one process reads: header parsing and read()
// syscalls move off the Python thread with the GIL released: one
// background std::thread fills a
// byte-bounded queue while the trainer's Python thread only memcpy's
// finished entries out (ctypes releases the GIL for the blocking calls).
//
// Supports ustar + GNU longname ('L') + pax extended headers ('x': the
// `path` record overrides the name).  Directories/links/other types are
// skipped.  A malformed header stops the stream with an error flag — the
// Python side maps it to the same corrupt-shard handling as tarfile.
//
// Copy of mmada_parallel_tpu/native/tarstream.cc; data/tarstream.py builds it
// into mmada_parallel_torch/_build/:
//   g++ -O2 -shared -fPIC -pthread -o libtarstream.so tarstream.cc

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Entry {
  std::string name;
  std::vector<uint8_t> data;
};

struct Stream {
  FILE* f = nullptr;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv_pop;   // consumer waits: queue non-empty/eof
  std::condition_variable cv_push;  // producer waits: queue under cap
  std::deque<Entry> q;
  size_t q_bytes = 0;
  size_t cap_bytes = 0;
  bool eof = false;      // producer finished cleanly
  bool error = false;    // producer hit a malformed header / short read
  bool closed = false;   // consumer asked to shut down
  bool has_cur = false;  // an entry has been handed out via tar_next
  Entry cur;
};

// Parse a NUL/space-terminated octal field.  Returns -1 on garbage
// (including GNU base-256 encodings, which shard members never need).
int64_t parse_octal(const char* p, size_t n) {
  if (n && (static_cast<unsigned char>(p[0]) & 0x80)) return -1;
  int64_t v = 0;
  size_t i = 0;
  while (i < n && (p[i] == ' ' || p[i] == '\0')) ++i;
  bool any = false;
  for (; i < n && p[i] != ' ' && p[i] != '\0'; ++i) {
    if (p[i] < '0' || p[i] > '7') return -1;
    v = (v << 3) | (p[i] - '0');
    any = true;
  }
  return any ? v : 0;
}

bool read_block(FILE* f, uint8_t* buf) {
  return std::fread(buf, 1, 512, f) == 512;
}

bool skip_padded(FILE* f, int64_t size, std::vector<uint8_t>* out) {
  int64_t padded = (size + 511) & ~int64_t{511};
  if (out) {
    out->resize(size);
    if (size && std::fread(out->data(), 1, size, f)
                    != static_cast<size_t>(size))
      return false;
    padded -= size;
  }
  if (padded && std::fseek(f, padded, SEEK_CUR) != 0) return false;
  return true;
}

// pax payload: sequence of "<len> key=value\n" records; extract `path`.
std::string pax_path(const std::vector<uint8_t>& buf) {
  const char* p = reinterpret_cast<const char*>(buf.data());
  size_t n = buf.size(), off = 0;
  while (off < n) {
    size_t sp = off;
    while (sp < n && p[sp] != ' ') ++sp;
    if (sp >= n) break;
    long len = std::strtol(p + off, nullptr, 10);
    // record spans [off, off+len); the value part is (sp+1 .. off+len).
    // guard sp+1 <= off+len or the size_t below underflows on a corrupt
    // record (e.g. a declared length shorter than its own digits)
    if (len <= 0 || off + static_cast<size_t>(len) > n
        || sp + 1 > off + static_cast<size_t>(len))
      break;
    std::string rec(p + sp + 1, off + len - (sp + 1));
    if (!rec.empty() && rec.back() == '\n') rec.pop_back();
    if (rec.rfind("path=", 0) == 0) return rec.substr(5);
    off += len;
  }
  return "";
}

void producer_impl(Stream* s);

// any C++ exception on the producer thread (bad_alloc from a corrupt
// multi-GB size field, length_error, ...) must become the error flag, not
// std::terminate — ShardReader maps it to warn-and-skip like tarfile
void producer(Stream* s) {
  try {
    producer_impl(s);
  } catch (...) {
    std::lock_guard<std::mutex> g(s->mu);
    s->error = true;
    s->cv_pop.notify_one();
  }
}

void producer_impl(Stream* s) {
  uint8_t hdr[512];
  std::string longname;   // from 'L' / pax 'path='
  bool ok_eof = false;
  while (true) {
    {
      std::lock_guard<std::mutex> g(s->mu);
      if (s->closed) return;
    }
    if (!read_block(s->f, hdr)) break;  // truncated -> error
    bool zero = true;
    for (int i = 0; i < 512; ++i)
      if (hdr[i]) { zero = false; break; }
    if (zero) { ok_eof = true; break; }  // end-of-archive marker

    int64_t size = parse_octal(reinterpret_cast<char*>(hdr) + 124, 12);
    if (size < 0) break;
    char type = static_cast<char>(hdr[156]);

    if (type == 'L') {  // GNU longname: payload is the next entry's name
      std::vector<uint8_t> buf;
      if (!skip_padded(s->f, size, &buf)) break;
      longname.assign(reinterpret_cast<char*>(buf.data()), buf.size());
      while (!longname.empty() && longname.back() == '\0')
        longname.pop_back();
      continue;
    }
    if (type == 'x') {  // pax extended header for the next entry
      std::vector<uint8_t> buf;
      if (!skip_padded(s->f, size, &buf)) break;
      std::string p = pax_path(buf);
      if (!p.empty()) longname = p;
      continue;
    }
    if (type != '0' && type != '\0') {  // dirs, links, 'g', ... : skip
      if (!skip_padded(s->f, size, nullptr)) break;
      longname.clear();
      continue;
    }

    Entry e;
    if (!longname.empty()) {
      e.name = longname;
      longname.clear();
    } else {
      char name[101] = {0}, prefix[156] = {0};
      std::memcpy(name, hdr, 100);
      std::memcpy(prefix, hdr + 345, 155);
      e.name = prefix[0] ? std::string(prefix) + "/" + name : name;
    }
    if (!skip_padded(s->f, size, &e.data)) break;

    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_push.wait(lk, [s, &e] {
      return s->closed || s->q_bytes + e.data.size() <= s->cap_bytes
             || s->q.empty();
    });
    if (s->closed) return;
    s->q_bytes += e.data.size();
    s->q.push_back(std::move(e));
    s->cv_pop.notify_one();
  }
  std::lock_guard<std::mutex> g(s->mu);
  if (ok_eof) s->eof = true;
  else s->error = true;
  s->cv_pop.notify_one();
}

}  // namespace

extern "C" {

void* tar_open(const char* path, uint64_t cap_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Stream();
  s->f = f;
  s->cap_bytes = cap_bytes ? cap_bytes : (64u << 20);
  s->th = std::thread(producer, s);
  return s;
}

// Wait for the next entry.  Returns 0 (entry ready: *size_out and
// *name_len_out set, name copied — truncated if it exceeds name_cap-1;
// re-call with a bigger buffer to get the full name), 1 (clean EOF),
// 2 (malformed archive).  The entry stays current until tar_read consumes
// it.
int tar_next(void* handle, uint64_t* size_out, char* name_out,
             uint64_t name_cap, uint64_t* name_len_out) {
  auto* s = static_cast<Stream*>(handle);
  if (!s) return 2;
  std::unique_lock<std::mutex> lk(s->mu);
  if (!s->has_cur) {
    s->cv_pop.wait(lk, [s] { return !s->q.empty() || s->eof || s->error; });
    if (s->q.empty()) return s->error ? 2 : 1;
    s->cur = std::move(s->q.front());
    s->q.pop_front();
    s->q_bytes -= s->cur.data.size();
    s->has_cur = true;
    s->cv_push.notify_one();
  }
  *size_out = s->cur.data.size();
  if (name_len_out) *name_len_out = s->cur.name.size();
  if (name_cap) {
    size_t n = s->cur.name.size();
    if (n >= name_cap) n = name_cap - 1;
    std::memcpy(name_out, s->cur.name.data(), n);
    name_out[n] = '\0';
  }
  return 0;
}

// Copy the current entry's payload (up to cap bytes) and advance.
// Returns bytes copied, or -1 if no current entry.
int64_t tar_read(void* handle, uint8_t* out, uint64_t cap) {
  auto* s = static_cast<Stream*>(handle);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  if (!s->has_cur) return -1;
  size_t n = s->cur.data.size();
  if (n > cap) n = cap;
  if (n) std::memcpy(out, s->cur.data.data(), n);
  s->has_cur = false;
  s->cur = Entry();
  return static_cast<int64_t>(n);
}

void tar_close(void* handle) {
  auto* s = static_cast<Stream*>(handle);
  if (!s) return;
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->closed = true;
    s->cv_push.notify_all();
    s->cv_pop.notify_all();
  }
  if (s->th.joinable()) s->th.join();
  std::fclose(s->f);
  delete s;
}

}  // extern "C"
