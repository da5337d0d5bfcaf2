// Native runtime components for ins_tpu.
//
// The JAX/XLA side owns all device compute; this library owns the host
// runtime around it: fast base64 encoding for VTK payloads and an
// asynchronous threaded file writer so simulation loops never block on
// disk I/O (this framework's analogue of the reference's delegation of
// native work to C libraries - WriteVTK/FFTW/SuiteSparse; SURVEY.md §2).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread ins_native.cpp -o libins_native.so

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

const char kB64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

void b64_encode_impl(const uint8_t* src, size_t n, char* dst) {
  size_t i = 0, o = 0;
  while (i + 3 <= n) {
    uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8) |
                 uint32_t(src[i + 2]);
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = kB64[(v >> 6) & 63];
    dst[o++] = kB64[v & 63];
    i += 3;
  }
  size_t rem = n - i;
  if (rem == 1) {
    uint32_t v = uint32_t(src[i]) << 16;
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = '=';
    dst[o++] = '=';
  } else if (rem == 2) {
    uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8);
    dst[o++] = kB64[(v >> 18) & 63];
    dst[o++] = kB64[(v >> 12) & 63];
    dst[o++] = kB64[(v >> 6) & 63];
    dst[o++] = '=';
  }
  dst[o] = '\0';
}

struct WriteJob {
  std::string path;
  std::string data;
};

struct Writer {
  std::vector<std::thread> threads;
  std::deque<WriteJob> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable cv_done;
  std::atomic<int> inflight{0};
  bool stop = false;

  explicit Writer(int nthreads) {
    for (int i = 0; i < nthreads; ++i) {
      threads.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (f) {
        std::fwrite(job.data.data(), 1, job.data.size(), f);
        std::fclose(f);
      }
      if (--inflight == 0) cv_done.notify_all();
    }
  }

  void submit(const char* path, const char* data, size_t n) {
    ++inflight;
    {
      std::lock_guard<std::mutex> lock(mu);
      queue.push_back(WriteJob{path, std::string(data, n)});
    }
    cv.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [this] { return inflight.load() == 0; });
  }

  ~Writer() {
    flush();
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

// ---- base64 (with the VTK UInt32 length header prepended) ----

size_t ins_b64_size(size_t n) {
  size_t total = n + 4;  // + header
  return ((total + 2) / 3) * 4 + 1;
}

void ins_b64_encode_vtk(const uint8_t* src, size_t n, char* dst) {
  // VTK "binary" format: base64( uint32 byte-count || payload )
  std::vector<uint8_t> buf(n + 4);
  uint32_t header = static_cast<uint32_t>(n);
  std::memcpy(buf.data(), &header, 4);
  std::memcpy(buf.data() + 4, src, n);
  b64_encode_impl(buf.data(), buf.size(), dst);
}

// ---- async writer ----

void* ins_writer_create(int nthreads) {
  return new Writer(nthreads > 0 ? nthreads : 1);
}

void ins_writer_submit(void* w, const char* path, const char* data,
                       size_t n) {
  static_cast<Writer*>(w)->submit(path, data, n);
}

void ins_writer_flush(void* w) { static_cast<Writer*>(w)->flush(); }

void ins_writer_destroy(void* w) { delete static_cast<Writer*>(w); }

int ins_native_version() { return 1; }
}
