// csdr_io — native streaming IO runtime for csdr_tpu.
//
// The reference's native layer is SoapySDR's C++ stream engine (MTU-sized
// reads, 30 driver buffers, 1 s timeout — /root/reference/src/ComposableSDR/
// Source.chs:193-233) and libsndfile.  This library provides the host-side
// equivalent: a threaded, double(+)-buffered file reader that keeps the
// host→device feed saturated while the device computes, and a threaded
// writer that decouples sink disk latency from the stream loop.
//
// C ABI (ctypes-friendly):
//   reader_open(path, chunk_bytes, n_buffers) -> handle | 0
//   reader_next(handle, &ptr, &len)           -> 1 data, 0 EOF, -1 error
//     (len may be < chunk_bytes on the final chunk; buffer valid until the
//      next reader_next/reader_close call on the same handle)
//   reader_close(handle)
//   writer_open(path, n_buffers)              -> handle | 0
//   writer_write(handle, ptr, len)            -> 0 ok, -1 error (copies)
//   writer_close(handle)                      (flushes, joins)
//
// Build: make -C native   (g++ -O3 -shared -fPIC -pthread)

#include <atomic>
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

struct Buffer {
  std::vector<uint8_t> data;
  size_t len = 0;
  bool eof = false;
};

struct Reader {
  FILE* f = nullptr;
  size_t chunk = 0;
  std::vector<Buffer> bufs;
  std::deque<int> ready;   // filled buffers awaiting the consumer
  std::deque<int> free_;   // empty buffers awaiting the producer
  int in_flight = -1;      // buffer currently lent to the consumer
  bool error = false;
  bool done = false;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread th;

  void produce() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return !free_.empty() || done; });
        if (done) return;
        idx = free_.front();
        free_.pop_front();
      }
      Buffer& b = bufs[idx];
      b.len = fread(b.data.data(), 1, chunk, f);
      b.eof = (b.len < chunk) && (feof(f) != 0);
      bool err = (b.len < chunk) && (ferror(f) != 0);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (err) error = true;
        ready.push_back(idx);
        if (b.eof || err) done = true;
      }
      cv_ready.notify_one();
      if (b.eof || err) return;
    }
  }
};

struct Writer {
  FILE* f = nullptr;
  std::deque<std::vector<uint8_t>> q;
  size_t max_depth = 8;
  bool closing = false;
  bool error = false;
  std::mutex mu;
  std::condition_variable cv_q, cv_space;
  std::thread th;

  void drain() {
    for (;;) {
      std::vector<uint8_t> item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_q.wait(lk, [&] { return !q.empty() || closing; });
        if (q.empty() && closing) return;
        item = std::move(q.front());
        q.pop_front();
      }
      cv_space.notify_one();
      if (fwrite(item.data(), 1, item.size(), f) != item.size()) {
        std::lock_guard<std::mutex> lk(mu);
        error = true;
      }
    }
  }
};

}  // namespace

extern "C" {

void* reader_open(const char* path, size_t chunk_bytes, int n_buffers) {
  if (chunk_bytes == 0 || n_buffers < 2) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->chunk = chunk_bytes;
  r->bufs.resize(n_buffers);
  for (int i = 0; i < n_buffers; ++i) {
    r->bufs[i].data.resize(chunk_bytes);
    r->free_.push_back(i);
  }
  r->th = std::thread([r] { r->produce(); });
  return r;
}

int reader_next(void* handle, const uint8_t** out, size_t* len) {
  auto* r = static_cast<Reader*>(handle);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->in_flight >= 0) {
      r->free_.push_back(r->in_flight);
      r->in_flight = -1;
    }
  }
  r->cv_free.notify_one();
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_ready.wait(lk, [&] { return !r->ready.empty() || r->done; });
  // drain already-filled buffers BEFORE reporting a trailing error: the
  // producer may have read several valid chunks ahead of the failure, and
  // dropping them would truncate the stream at a timing-dependent point
  if (r->ready.empty()) return r->error ? -1 : 0;
  int idx = r->ready.front();
  r->ready.pop_front();
  Buffer& b = r->bufs[idx];
  if (b.len == 0) return b.eof ? 0 : -1;  // terminal marker buffer
  r->in_flight = idx;
  *out = b.data.data();
  *len = b.len;
  return 1;
}

void reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->done = true;
  }
  r->cv_free.notify_all();
  if (r->th.joinable()) r->th.join();
  fclose(r->f);
  delete r;
}

void* writer_open(const char* path, int n_buffers) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->max_depth = n_buffers > 0 ? static_cast<size_t>(n_buffers) : 8;
  w->th = std::thread([w] { w->drain(); });
  return w;
}

int writer_write(void* handle, const uint8_t* data, size_t len) {
  auto* w = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lk(w->mu);
  if (w->error) return -1;
  w->cv_space.wait(lk, [&] { return w->q.size() < w->max_depth; });
  w->q.emplace_back(data, data + len);
  lk.unlock();
  w->cv_q.notify_one();
  return 0;
}

int writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv_q.notify_all();
  if (w->th.joinable()) w->th.join();
  int rc = w->error ? -1 : 0;
  fclose(w->f);
  delete w;
  return rc;
}

}  // extern "C"
