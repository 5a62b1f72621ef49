// Native RecordIO reader/writer + threaded prefetcher: the port's own copy
// of mxnet_tpu/_native/recordio.cc, built by mxnet_tpu_torch/io_native.py.
//
// The host side of the reference's C++ data plane: dmlc-core
// RecordIO (wire format: uint32 magic 0xced7230a, uint32 (cflag<<29|len),
// payload padded to 4 bytes — see dmlc/recordio.h as consumed by
// src/io/iter_image_recordio_2.cc) plus the double-buffering prefetch
// pattern of src/io/iter_prefetcher.h: a bounded queue filled by reader
// threads so the Python side never blocks on disk.
//
// Exposed as a flat C ABI for ctypes (the same boundary role as
// include/mxnet/c_api.h, scoped to IO).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

inline size_t Pad4(size_t n) { return (4 - n % 4) % 4; }

struct Reader {
  FILE* f = nullptr;
};

struct Writer {
  FILE* f = nullptr;
};

// Read one logical record (handling multi-part cflag chunks).
//
// dmlc wire format: the writer splits a record at 4-byte-aligned
// in-payload occurrences of the magic word, DROPPING the 4 magic bytes
// at each split point; the reader re-inserts them between continuation
// chunks (dmlc-core src/recordio.cc RecordIOReader::NextRecord).
//
// Returns malloc'd buffer in *out (caller frees via rio_free), length in
// *len. Returns 0 on success, 1 on EOF, negative on error.
int ReadRecord(FILE* f, uint8_t** out, int64_t* len) {
  std::vector<uint8_t> buf;
  bool first = true;
  for (;;) {
    uint32_t header[2];
    if (fread(header, 4, 2, f) != 2) return first ? 1 : -2;  // EOF
    if (header[0] != kMagic) return -1;
    uint32_t cflag = header[1] >> 29;
    size_t length = header[1] & ((1u << 29) - 1);
    size_t old = buf.size();
    buf.resize(old + length);
    if (length && fread(buf.data() + old, 1, length, f) != length) return -2;
    fseek(f, static_cast<long>(Pad4(length)), SEEK_CUR);
    if (cflag == 0 || cflag == 3) break;  // whole record / final chunk
    // continuation (cflag 1 begin / 2 middle): re-insert the magic word
    // the splitting writer dropped at this boundary
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(&kMagic);
    buf.insert(buf.end(), mb, mb + 4);
    first = false;
  }
  *out = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
  memcpy(*out, buf.data(), buf.size());
  *len = static_cast<int64_t>(buf.size());
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetcher: N reader threads stream records into a bounded queue.
// ---------------------------------------------------------------------------
struct Prefetcher {
  FILE* f = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::deque<std::pair<uint8_t*, int64_t>> queue;
  size_t capacity = 64;
  bool done = false;
  bool stop = false;
  int error = 0;  // <0 read error (corrupt/truncated), distinct from EOF

  void Run() {
    for (;;) {
      uint8_t* buf = nullptr;
      int64_t len = 0;
      int rc = ReadRecord(f, &buf, &len);
      std::unique_lock<std::mutex> lk(mu);
      if (rc != 0 || stop) {
        if (rc < 0) error = rc;
        done = true;
        not_empty.notify_all();
        if (buf) free(buf);
        return;
      }
      not_full.wait(lk, [&] { return queue.size() < capacity || stop; });
      if (stop) { free(buf); done = true; not_empty.notify_all(); return; }
      queue.emplace_back(buf, len);
      not_empty.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// -- sequential reader -------------------------------------------------------
void* rio_open_reader(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  return r;
}

// 0 ok, 1 eof, <0 error
int rio_read_next(void* handle, uint8_t** out, int64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  return ReadRecord(r->f, out, len);
}

int rio_read_at(void* handle, int64_t offset, uint8_t** out, int64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  if (fseek(r->f, static_cast<long>(offset), SEEK_SET) != 0) return -3;
  return ReadRecord(r->f, out, len);
}

void rio_close_reader(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->f) fclose(r->f);
  delete r;
}

// -- writer ------------------------------------------------------------------
void* rio_open_writer(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int64_t rio_tell(void* handle) {
  return ftell(static_cast<Writer*>(handle)->f);
}

namespace {
int WriteChunk(FILE* f, uint32_t cflag, const uint8_t* data, size_t len) {
  uint32_t header[2] = {kMagic,
                        (cflag << 29) | static_cast<uint32_t>(len)};
  if (fwrite(header, 4, 2, f) != 2) return -1;
  if (fwrite(data, 1, len, f) != len) return -1;
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  size_t pad = Pad4(len);
  if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  return 0;
}
}  // namespace

int rio_write(void* handle, const uint8_t* data, int64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (len >= (1 << 29)) return -4;  // dmlc: records must be < 2^29 bytes
  // dmlc wire format (dmlc-core src/recordio.cc WriteRecord): split the
  // record at 4-byte-aligned in-payload occurrences of the magic word so
  // a reader scanning for record starts never mistakes payload for a
  // header; the 4 magic bytes at each split are dropped (the reader
  // re-inserts them).  Split chunks are 4-aligned so only the final
  // chunk needs padding (WriteChunk pads, which is a no-op for aligned).
  const uint8_t* mb = reinterpret_cast<const uint8_t*>(&kMagic);
  size_t lower_align = (static_cast<size_t>(len) >> 2) << 2;
  size_t dptr = 0;
  for (size_t i = 0; i < lower_align; i += 4) {
    if (data[i] == mb[0] && data[i + 1] == mb[1] &&
        data[i + 2] == mb[2] && data[i + 3] == mb[3]) {
      uint32_t cflag = dptr == 0 ? 1u : 2u;
      if (WriteChunk(w->f, cflag, data + dptr, i - dptr) != 0) return -1;
      dptr = i + 4;  // skip the magic word
    }
  }
  uint32_t cflag = dptr != 0 ? 3u : 0u;
  return WriteChunk(w->f, cflag, data + dptr,
                    static_cast<size_t>(len) - dptr);
}

void rio_close_writer(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (w->f) fclose(w->f);
  delete w;
}

void rio_free(uint8_t* buf) { free(buf); }

// -- prefetcher --------------------------------------------------------------
void* rio_prefetcher_create(const char* path, int capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* p = new Prefetcher();
  p->f = f;
  p->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 64;
  p->worker = std::thread([p] { p->Run(); });
  return p;
}

// 0 ok, 1 end-of-stream, <0 read error (corrupt/truncated file)
int rio_prefetcher_next(void* handle, uint8_t** out, int64_t* len) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->not_empty.wait(lk, [&] { return !p->queue.empty() || p->done; });
  if (p->queue.empty()) return p->error != 0 ? p->error : 1;
  auto item = p->queue.front();
  p->queue.pop_front();
  p->not_full.notify_one();
  *out = item.first;
  *len = item.second;
  return 0;
}

void rio_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->not_full.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  for (auto& item : p->queue) free(item.first);
  if (p->f) fclose(p->f);
  delete p;
}

}  // extern "C"
