// Native asynchronous binary game logger.
//
// The reference's Logger writes raw little-endian doubles synchronously
// from the sim loop; here writes are staged into an in-memory buffer and
// flushed by a background thread, so the host control loop (which feeds
// the GPU) never blocks on disk.  Exposed to Python through a plain C API
// via ctypes.
//
// Built on first use by robogame_tpu_torch/native/__init__.py (g++).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

class AsyncLogger {
 public:
  explicit AsyncLogger(const char* path, size_t buf_doubles)
      : file_(std::fopen(path, "wb")),
        capacity_(buf_doubles < 1024 ? 1024 : buf_doubles),
        stop_(false),
        ok_(file_ != nullptr) {
    if (ok_) {
      front_.reserve(capacity_);
      back_.reserve(capacity_);
      worker_ = std::thread([this] { this->Run(); });
    }
  }

  ~AsyncLogger() { Close(); }

  bool ok() const { return ok_; }

  // Append n doubles; copies into the staging buffer and returns
  // immediately (blocks only if the buffer is persistently full).
  bool Write(const double* data, size_t n) {
    if (!ok_) return false;
    std::unique_lock<std::mutex> lk(mu_);
    space_cv_.wait(lk, [this, n] {
      return stop_ || front_.size() + n <= capacity_ * 4;
    });
    if (stop_) return false;
    front_.insert(front_.end(), data, data + n);
    lk.unlock();
    data_cv_.notify_one();
    return true;
  }

  void Flush() {
    std::unique_lock<std::mutex> lk(mu_);
    flush_requested_ = true;
    data_cv_.notify_one();
    flush_cv_.wait(lk, [this] { return !flush_requested_ || stop_; });
    if (file_) std::fflush(file_);
  }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      stop_ = true;
    }
    data_cv_.notify_all();
    space_cv_.notify_all();
    if (worker_.joinable()) worker_.join();
    if (file_) {
      DrainLocked();
      std::fclose(file_);
      file_ = nullptr;
    }
  }

 private:
  void DrainLocked() {
    if (!front_.empty() && file_) {
      std::fwrite(front_.data(), sizeof(double), front_.size(), file_);
      front_.clear();
    }
  }

  void Run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu_);
      data_cv_.wait(lk, [this] {
        return stop_ || !front_.empty() || flush_requested_;
      });
      if (stop_ && front_.empty()) {
        flush_requested_ = false;
        flush_cv_.notify_all();
        return;
      }
      back_.swap(front_);
      bool want_flush = flush_requested_;
      lk.unlock();
      space_cv_.notify_all();

      if (!back_.empty() && file_) {
        std::fwrite(back_.data(), sizeof(double), back_.size(), file_);
        back_.clear();
      }
      if (want_flush) {
        if (file_) std::fflush(file_);
        std::lock_guard<std::mutex> lk2(mu_);
        flush_requested_ = false;
        flush_cv_.notify_all();
      }
    }
  }

  std::FILE* file_;
  size_t capacity_;
  std::vector<double> front_, back_;
  std::mutex mu_;
  std::condition_variable data_cv_, space_cv_, flush_cv_;
  std::thread worker_;
  bool stop_;
  bool flush_requested_ = false;
  bool ok_;
};

}  // namespace

extern "C" {

void* rg_logger_open(const char* path, uint64_t buf_doubles) {
  AsyncLogger* lg = new AsyncLogger(path, buf_doubles);
  if (!lg->ok()) {
    delete lg;
    return nullptr;
  }
  return lg;
}

int rg_logger_write(void* handle, const double* data, uint64_t n) {
  if (!handle) return -1;
  return static_cast<AsyncLogger*>(handle)->Write(data, n) ? 0 : -1;
}

void rg_logger_flush(void* handle) {
  if (handle) static_cast<AsyncLogger*>(handle)->Flush();
}

void rg_logger_close(void* handle) {
  if (!handle) return;
  AsyncLogger* lg = static_cast<AsyncLogger*>(handle);
  lg->Close();
  delete lg;
}

}  // extern "C"
