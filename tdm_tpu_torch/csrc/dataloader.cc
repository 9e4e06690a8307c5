// The port's native prompt loader: C++17, no external dependencies.
//
// The host-side data machinery of training (the reference's DataLoader
// worker processes, src/main.py:263-304): TDM training reads no images, so
// the loader mmaps a prompt shard (.txt one prompt per line, or .jsonl with
// a caption key), indexes it once, and keeps a ring of shuffled prompt
// batches filled from a background thread so the training loop never waits
// on host IO. The same program as the JAX package's loader, kept as the
// port's own copy; it runs on the host, not on the card.
//
// A C ABI for ctypes (tdm_tpu_torch/data/native_loader.py):
//   ldr_create(path, caption_key, batch, seed, host_idx, host_cnt, depth)
//   ldr_next(h, buf, cap, offsets, max_items) -> n items (packed strings)
//   ldr_num_prompts(h)
//   ldr_destroy(h)
//
// Determinism: per-epoch Fisher-Yates with splitmix64 seeded by
// (seed, epoch): the same sequence every run; host h takes lines
// [h::host_count], as the Python PromptBatcher does, so the two paths are
// interchangeable.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x, r;
    do {
      x = next();
      r = x % n;
    } while (x - r > UINT64_MAX - n + 1);
    return r;
  }
};

// Extract the string value of `"key": "..."` from one JSON line. Minimal
// scanner (handles \" escapes); returns false when absent.
bool extract_json_string(const char* line, size_t len, const std::string& key,
                         std::string* out) {
  std::string needle = "\"" + key + "\"";
  const char* end = line + len;
  const char* p = static_cast<const char*>(
      memmem(line, len, needle.data(), needle.size()));
  while (p != nullptr) {
    const char* q = p + needle.size();
    while (q < end && (*q == ' ' || *q == '\t')) q++;
    if (q < end && *q == ':') {
      q++;
      while (q < end && (*q == ' ' || *q == '\t')) q++;
      if (q < end && *q == '"') {
        q++;
        out->clear();
        while (q < end) {
          if (*q == '\\' && q + 1 < end) {
            char c = q[1];
            out->push_back(c == 'n' ? '\n' : c == 't' ? '\t' : c);
            q += 2;
          } else if (*q == '"') {
            return true;
          } else {
            out->push_back(*q++);
          }
        }
        return false;  // unterminated
      }
    }
    size_t remaining = end - (p + 1);
    p = static_cast<const char*>(
        memmem(p + 1, remaining, needle.data(), needle.size()));
  }
  return false;
}

struct Batch {
  std::string packed;            // prompts back to back
  std::vector<int64_t> offsets;  // size n+1, prefix offsets into packed
};

class Loader {
 public:
  Loader(const char* path, const char* caption_key, int batch, uint64_t seed,
         int host_idx, int host_cnt, int depth)
      : batch_(batch), seed_(seed), depth_(depth > 0 ? depth : 4) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) { ok_ = false; return; }
    struct stat st;
    fstat(fd, &st);
    size_ = static_cast<size_t>(st.st_size);
    data_ = static_cast<const char*>(
        mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (data_ == MAP_FAILED) { ok_ = false; return; }
    madvise(const_cast<char*>(data_), size_, MADV_SEQUENTIAL);

    bool jsonl = std::string(path).size() > 6 &&
                 std::string(path).substr(std::string(path).size() - 6) ==
                     ".jsonl";
    std::string key = caption_key ? caption_key : "prompt";
    // index line spans, host-sharded h::H
    size_t start = 0;
    int64_t line_no = 0;
    for (size_t i = 0; i <= size_; i++) {
      if (i == size_ || data_[i] == '\n') {
        if (i > start) {
          if (line_no % host_cnt == host_idx) {
            if (jsonl) {
              std::string val;
              if (extract_json_string(data_ + start, i - start, key, &val)) {
                owned_.push_back(std::move(val));
                spans_.emplace_back(-1, -1);  // sentinel: use owned_
                owned_idx_.push_back(owned_.size() - 1);
              }
            } else {
              spans_.emplace_back(start, i - start);
              owned_idx_.push_back(-1);
            }
          }
          line_no++;
        }
        start = i + 1;
      }
    }
    if (spans_.size() < static_cast<size_t>(batch_)) { ok_ = false; return; }
    worker_ = std::thread([this] { this->fill(); });
  }

  ~Loader() {
    stop_.store(true);
    cv_space_.notify_all();
    if (worker_.joinable()) worker_.join();
    if (data_ != nullptr && data_ != MAP_FAILED) {
      munmap(const_cast<char*>(data_), size_);
    }
  }

  bool ok() const { return ok_; }
  int64_t num_prompts() const { return static_cast<int64_t>(spans_.size()); }

  // Pop one batch; returns item count, fills caller buffers.
  int next(char* buf, int64_t cap, int64_t* offsets, int max_items) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [this] { return !queue_.empty() || !ok_; });
    if (!ok_ && queue_.empty()) return -1;
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    lk.unlock();
    cv_space_.notify_one();
    int n = static_cast<int>(b.offsets.size()) - 1;
    if (n > max_items) n = max_items;
    int64_t total = b.offsets[n];
    if (total > cap) return -2;  // caller buffer too small
    memcpy(buf, b.packed.data(), static_cast<size_t>(total));
    memcpy(offsets, b.offsets.data(), sizeof(int64_t) * (n + 1));
    return n;
  }

 private:
  void fill() {
    size_t n = spans_.size();
    std::vector<uint32_t> order(n);
    uint64_t epoch = 0;
    while (!stop_.load()) {
      for (size_t i = 0; i < n; i++) order[i] = static_cast<uint32_t>(i);
      SplitMix64 rng(seed_ * 0x100000001b3ULL + epoch + 1);
      for (size_t i = n - 1; i > 0; i--) {
        size_t j = static_cast<size_t>(rng.bounded(i + 1));
        std::swap(order[i], order[j]);
      }
      for (size_t s = 0; s + batch_ <= n && !stop_.load(); s += batch_) {
        Batch b;
        b.offsets.push_back(0);
        for (int k = 0; k < batch_; k++) {
          uint32_t idx = order[s + k];
          if (owned_idx_[idx] >= 0) {
            b.packed += owned_[static_cast<size_t>(owned_idx_[idx])];
          } else {
            b.packed.append(data_ + spans_[idx].first,
                            static_cast<size_t>(spans_[idx].second));
          }
          b.offsets.push_back(static_cast<int64_t>(b.packed.size()));
        }
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return queue_.size() < static_cast<size_t>(depth_) || stop_.load();
        });
        if (stop_.load()) return;
        queue_.push_back(std::move(b));
        lk.unlock();
        cv_data_.notify_one();
      }
      epoch++;
    }
  }

  const char* data_ = nullptr;
  size_t size_ = 0;
  std::vector<std::pair<int64_t, int64_t>> spans_;  // (offset, len) into mmap
  std::vector<int64_t> owned_idx_;                  // -1 or index into owned_
  std::vector<std::string> owned_;                  // jsonl-extracted strings
  int batch_;
  uint64_t seed_;
  int depth_;
  bool ok_ = true;
  std::atomic<bool> stop_{false};
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::deque<Batch> queue_;
};

}  // namespace

extern "C" {

void* ldr_create(const char* path, const char* caption_key, int batch,
                 uint64_t seed, int host_idx, int host_cnt, int depth) {
  auto* l = new Loader(path, caption_key, batch, seed, host_idx, host_cnt,
                       depth);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

int ldr_next(void* h, char* buf, int64_t cap, int64_t* offsets,
             int max_items) {
  return static_cast<Loader*>(h)->next(buf, cap, offsets, max_items);
}

int64_t ldr_num_prompts(void* h) {
  return static_cast<Loader*>(h)->num_prompts();
}

void ldr_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
