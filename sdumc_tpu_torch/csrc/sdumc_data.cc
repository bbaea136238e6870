// sdumc_data: the host data plane of sdumc_tpu_torch's input pipeline.
//
// A thread-pooled .npy reader and a packed-store batch fill that pad (or
// mean-pool-compress, func_mapping_feature semantics) each clip straight
// into a caller-provided [B, T, D] batch buffer, which may be page-locked
// memory that a copy to the card reads next. The arithmetic is that of the
// JAX package's native/sdumc_data.cc, to the bit: f32 accumulation, a
// multiply by 1/pool, round-to-nearest-even to bf16, truncation toward zero
// for int8.
//
// Exposed as a plain C ABI for ctypes (data/native.py). Built with the host
// compiler at first use (ops/kernels/build.py, into build/native/).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- npy read
// Minimal NPY v1/v2 parser for C-contiguous little-endian arrays
// ('<f4'/'<f8' payloads; '<f8' is converted to f32 on load).
struct NpyArray {
  std::vector<float> data;
  int64_t rows = 0;
  int64_t cols = 0;
  bool ok = false;
};

bool parse_header(FILE* f, std::string* descr, bool* fortran,
                  std::vector<int64_t>* shape) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_value = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    ++p;
    while (p < header.size() && (header[p] == ' ')) ++p;
    return header.substr(p);
  };

  std::string d = find_value("descr");
  if (d.size() < 2) return false;
  size_t q1 = d.find('\'');
  size_t q2 = d.find('\'', q1 + 1);
  *descr = d.substr(q1 + 1, q2 - q1 - 1);

  std::string fo = find_value("fortran_order");
  *fortran = fo.rfind("True", 0) == 0;

  std::string sh = find_value("shape");
  size_t l = sh.find('('), r = sh.find(')');
  if (l == std::string::npos || r == std::string::npos) return false;
  std::string inner = sh.substr(l + 1, r - l - 1);
  shape->clear();
  char* end = nullptr;
  const char* cur = inner.c_str();
  while (*cur) {
    while (*cur == ' ' || *cur == ',') ++cur;
    if (!*cur) break;
    long long v = strtoll(cur, &end, 10);
    if (end == cur) break;
    shape->push_back(v);
    cur = end;
  }
  return true;
}

NpyArray read_npy(const char* path) {
  NpyArray out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  std::string descr;
  bool fortran = false;
  std::vector<int64_t> shape;
  if (!parse_header(f, &descr, &fortran, &shape) || fortran || shape.empty()) {
    fclose(f);
    return out;
  }
  int64_t rows = shape[0];
  int64_t cols = 1;
  for (size_t i = 1; i < shape.size(); ++i) cols *= shape[i];
  if (shape.size() == 1) {  // utterance-level [D] -> [1, D]
    cols = shape[0];
    rows = 1;
  }
  int64_t n = rows * cols;
  out.data.resize(n);
  if (descr == "<f4") {
    if (fread(out.data.data(), 4, n, f) != size_t(n)) {
      fclose(f);
      return out;
    }
  } else if (descr == "<f8") {
    std::vector<double> tmp(n);
    if (fread(tmp.data(), 8, n, f) != size_t(n)) {
      fclose(f);
      return out;
    }
    for (int64_t i = 0; i < n; ++i) out.data[i] = float(tmp[i]);
  } else {
    fclose(f);
    return out;
  }
  fclose(f);
  out.rows = rows;
  out.cols = cols;
  out.ok = true;
  return out;
}

// func_mapping_feature: shorter -> zero-pad at end
// (already implicit in a zeroed dst); longer -> LEFT-pad to a multiple and
// mean adjacent frames.
void map_into(const NpyArray& src, float* dst, int64_t dst_len, int64_t dim) {
  const int64_t n = std::min(src.cols, dim);
  if (src.rows <= dst_len) {
    for (int64_t t = 0; t < src.rows; ++t)
      memcpy(dst + t * dim, src.data.data() + t * src.cols, n * sizeof(float));
    return;
  }
  const int64_t pool =
      (src.rows % dst_len == 0) ? src.rows / dst_len : src.rows / dst_len + 1;
  const int64_t pad = pool * dst_len - src.rows;  // virtual leading zeros
  for (int64_t t = 0; t < dst_len; ++t) {
    float* row = dst + t * dim;
    for (int64_t p = 0; p < pool; ++p) {
      const int64_t s = t * pool + p - pad;  // index into src rows
      if (s < 0) continue;                   // leading zero-pad rows
      const float* sr = src.data.data() + s * src.cols;
      for (int64_t c = 0; c < n; ++c) row[c] += sr[c];
    }
    const float inv = 1.0f / float(pool);
    for (int64_t c = 0; c < n; ++c) row[c] *= inv;
  }
}

// ---------------------------------------------------------------- pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(std::max(4u, std::thread::hardware_concurrency()));
  return &p;
}

// ------------------------------------------------------------- mmap cache
// One process-lifetime read-only mapping per packed blob: clip reads become
// direct memcpy from page cache into the batch buffer (one copy, vs the
// fread path's copy-into-scratch + copy-into-batch).
struct Mapping {
  const uint8_t* ptr = nullptr;
  size_t size = 0;
};

Mapping map_blob(const std::string& path) {
  static std::mutex mu;
  static std::unordered_map<std::string, Mapping> cache;
  std::unique_lock<std::mutex> lk(mu);
  auto it = cache.find(path);
  if (it != cache.end()) return it->second;
  Mapping m;
  int fd = open(path.c_str(), O_RDONLY);
  if (fd >= 0) {
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size > 0) {
      void* p = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
      if (p != MAP_FAILED) {
        m.ptr = static_cast<const uint8_t*>(p);
        m.size = size_t(st.st_size);
      }
    }
    close(fd);
  }
  cache[path] = m;  // negative results cached too: missing file fails fast
  return m;
}

// ------------------------------------------------- non-temporal copy/zero
// The batch buffers these write are far larger than any LLC and are never
// re-read by the producer, so cached stores are pure loss: a plain memcpy
// of a ~0.5 MB clip takes the RFO path (3 memory touches per byte: src
// read + dst cache-line fill + dst writeback) while non-temporal stores
// need 2 (src read + dst write); glibc only switches memcpy to NT stores
// far above clip size.
// Callers must nt_fence() before publishing the buffer to other threads.
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

inline void nt_copy(void* dstv, const void* srcv, size_t n) {
  uint8_t* dst = static_cast<uint8_t*>(dstv);
  const uint8_t* src = static_cast<const uint8_t*>(srcv);
#if defined(__SSE2__)
  if (n >= 1024) {
    const size_t head = (64 - (reinterpret_cast<uintptr_t>(dst) & 63)) & 63;
    if (head) {
      memcpy(dst, src, head);
      dst += head;
      src += head;
      n -= head;
    }
    while (n >= 64) {
      const __m128i a =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src));
      const __m128i b =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 16));
      const __m128i c =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 32));
      const __m128i d =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 48));
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst), a);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 16), b);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 32), c);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 48), d);
      src += 64;
      dst += 64;
      n -= 64;
    }
  }
#endif
  memcpy(dst, src, n);
}

inline void nt_zero(void* dstv, size_t n) {
  uint8_t* dst = static_cast<uint8_t*>(dstv);
#if defined(__SSE2__)
  if (n >= 1024) {
    const size_t head = (64 - (reinterpret_cast<uintptr_t>(dst) & 63)) & 63;
    if (head) {
      memset(dst, 0, head);
      dst += head;
      n -= head;
    }
    const __m128i z = _mm_setzero_si128();
    while (n >= 64) {
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst), z);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 16), z);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 32), z);
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 48), z);
      dst += 64;
      n -= 64;
    }
  }
#endif
  memset(dst, 0, n);
}

inline void nt_fence() {
#if defined(__SSE2__)
  _mm_sfence();
#endif
}

// ------------------------------------------------------------- bf16 <-> f32
inline float bf16_to_f32(uint16_t h) {
  uint32_t u = uint32_t(h) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {  // round-to-nearest-even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return uint16_t(u >> 16);
}

// Single-touch packed-clip fill: copy/compress src (rows x cols, elem_size
// bytes from the mapped blob) into dst (bucket x dim, same dtype), zeroing
// ONLY the pad bytes — every output byte is written exactly once (the
// producer is bound by the host's memory bandwidth, so a redundant memset
// costs throughput one-for-one).
// zero_upto: rows in [written, zero_upto) are memset; pass `bucket` for a
// fresh (uninitialized) buffer, or the previous fill's written extent for a
// reused ring buffer whose tail is already zero (see fill_batch_packed's
// `prev_rows`).
template <typename T>
void fill_clip(const T* src, int64_t rows, int64_t cols, T* dst,
               int64_t bucket, int64_t dim, int64_t zero_upto) {
  const int64_t n = cols;  // caller guarantees cols <= dim
  if (rows <= bucket) {
    if (n == dim) {
      // contiguous in both src and dst: ONE streaming copy for the whole clip
      nt_copy(dst, src, size_t(rows) * dim * sizeof(T));
    } else {
      for (int64_t t = 0; t < rows; ++t) {
        nt_copy(dst + t * dim, src + t * cols, n * sizeof(T));
        memset(dst + t * dim + n, 0, (dim - n) * sizeof(T));
      }
    }
    if (rows < zero_upto)
      nt_zero(dst + rows * dim, size_t(zero_upto - rows) * dim * sizeof(T));
    nt_fence();
    return;
  }
  // mean-pool compress (func_mapping_feature semantics)
  const int64_t pool =
      (rows % bucket == 0) ? rows / bucket : rows / bucket + 1;
  const int64_t pad = pool * bucket - rows;  // virtual leading zero rows
  std::vector<float> acc(n);
  const float inv = 1.0f / float(pool);
  for (int64_t t = 0; t < bucket; ++t) {
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int64_t p = 0; p < pool; ++p) {
      const int64_t s = t * pool + p - pad;
      if (s < 0) continue;
      const T* sr = src + s * cols;
      for (int64_t c = 0; c < n; ++c) acc[c] += float(sr[c]);
    }
    T* row = dst + t * dim;
    for (int64_t c = 0; c < n; ++c) row[c] = T(acc[c] * inv);
    if (n < dim) memset(row + n, 0, (dim - n) * sizeof(T));
  }
}

// uint16 payloads are bf16 bits: specialize the accumulate/convert steps.
template <>
void fill_clip<uint16_t>(const uint16_t* src, int64_t rows, int64_t cols,
                         uint16_t* dst, int64_t bucket, int64_t dim,
                         int64_t zero_upto) {
  const int64_t n = cols;
  if (rows <= bucket) {
    if (n == dim) {
      nt_copy(dst, src, size_t(rows) * dim * sizeof(uint16_t));
    } else {
      for (int64_t t = 0; t < rows; ++t) {
        nt_copy(dst + t * dim, src + t * cols, n * sizeof(uint16_t));
        memset(dst + t * dim + n, 0, (dim - n) * sizeof(uint16_t));
      }
    }
    if (rows < zero_upto)
      nt_zero(dst + rows * dim,
              size_t(zero_upto - rows) * dim * sizeof(uint16_t));
    nt_fence();
    return;
  }
  const int64_t pool =
      (rows % bucket == 0) ? rows / bucket : rows / bucket + 1;
  const int64_t pad = pool * bucket - rows;
  std::vector<float> acc(n);
  const float inv = 1.0f / float(pool);
  for (int64_t t = 0; t < bucket; ++t) {
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int64_t p = 0; p < pool; ++p) {
      const int64_t s = t * pool + p - pad;
      if (s < 0) continue;
      const uint16_t* sr = src + s * cols;
      for (int64_t c = 0; c < n; ++c) acc[c] += bf16_to_f32(sr[c]);
    }
    uint16_t* row = dst + t * dim;
    for (int64_t c = 0; c < n; ++c) row[c] = f32_to_bf16(acc[c] * inv);
    if (n < dim) memset(row + n, 0, (dim - n) * sizeof(uint16_t));
  }
}

}  // namespace

extern "C" {

// Read one .npy; returns rows (or -1) and writes up to max_rows*dim floats
// into dst (zero-padded). lengths_out gets the true row count.
int64_t sdumc_read_npy_into(const char* path, float* dst, int64_t max_rows,
                            int64_t dim) {
  NpyArray arr = read_npy(path);
  if (!arr.ok || arr.cols > dim) return -1;
  memset(dst, 0, size_t(max_rows) * dim * sizeof(float));
  map_into(arr, dst, max_rows, dim);
  return std::min(arr.rows, max_rows);
}

// Assemble a [batch, bucket, dim] float32 batch from `batch` .npy paths
// (concatenated, NUL-separated) in parallel. lengths[b] receives each clip's
// true (pre-pad, post-compress) length. Returns 0 on success, -1 if any
// file failed.
int sdumc_fill_batch(const char* paths, int64_t batch, int64_t bucket,
                     int64_t dim, float* dst, int64_t* lengths) {
  std::atomic<int> failed{0};
  std::atomic<int64_t> done{0};
  std::mutex mu;
  std::condition_variable cv;

  const char* cur = paths;
  std::vector<std::string> files;
  for (int64_t b = 0; b < batch; ++b) {
    files.emplace_back(cur);
    cur += files.back().size() + 1;
  }

  memset(dst, 0, size_t(batch) * bucket * dim * sizeof(float));
  for (int64_t b = 0; b < batch; ++b) {
    pool()->submit([&, b] {
      NpyArray arr = read_npy(files[b].c_str());
      if (!arr.ok || arr.cols > dim) {
        failed.fetch_add(1);
      } else {
        map_into(arr, dst + b * bucket * dim, bucket, dim);
        lengths[b] = std::min(arr.rows, bucket);
      }
      if (done.fetch_add(1) + 1 == batch) {
        std::unique_lock<std::mutex> lk(mu);
        cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == batch; });
  return failed.load() ? -1 : 0;
}

// Single-touch mmap packed fill. dtype: 0 = float32, 2 = int8,
// 1 = bfloat16 — blob payload and dst share it. offs are in ELEMENTS.
// Every dst byte is written at most once (payload memcpy or pad memset).
//
// prev_rows: NULL for a fresh (uninitialized) buffer -> pad rows are zeroed
// up to `bucket`. For a REUSED ring buffer pass the previous fill's written
// extents: slot b only zeroes rows [rows[b], prev_rows[b]) because rows
// beyond the previous extent are still zero (invariant: after every fill,
// rows [extent, bucket) are zero). This skips both the pad memset and the
// fresh-page faults — the producer is host-memory-bandwidth-bound, so
// bytes not touched are throughput won. Returns 0 on success.
int sdumc_fill_batch_packed2(const char* bin_path, const int64_t* offs,
                             const int64_t* rows, const int64_t* cols,
                             int64_t batch, int64_t bucket, int64_t dim,
                             void* dst, int64_t* lengths, int dtype,
                             const int64_t* prev_rows) {
  const size_t esize = dtype == 1 ? 2 : (dtype == 2 ? 1 : 4);
  Mapping m = map_blob(bin_path);
  if (!m.ptr) return -1;
  // bounds check up front so worker tasks can't fault on a bad index
  for (int64_t b = 0; b < batch; ++b) {
    if (cols[b] > dim || offs[b] < 0 ||
        size_t(offs[b] + rows[b] * cols[b]) * esize > m.size)
      return -1;
  }
  auto fill_one = [&](int64_t b) {
    const int64_t zero_upto =
        prev_rows ? std::min(std::max(prev_rows[b], rows[b]), bucket)
                  : bucket;
    if (dtype == 1) {
      fill_clip<uint16_t>(
          reinterpret_cast<const uint16_t*>(m.ptr) + offs[b], rows[b],
          cols[b], static_cast<uint16_t*>(dst) + b * bucket * dim, bucket,
          dim, zero_upto);
    } else if (dtype == 2) {
      // int8 payload (quantized feature store): the generic template's
      // copy path is a straight memcpy; the mean-pool path accumulates
      // f32 codes and truncates back (numpy .astype(int8) matches)
      fill_clip<int8_t>(
          reinterpret_cast<const int8_t*>(m.ptr) + offs[b], rows[b],
          cols[b], static_cast<int8_t*>(dst) + b * bucket * dim, bucket,
          dim, zero_upto);
    } else {
      fill_clip<float>(reinterpret_cast<const float*>(m.ptr) + offs[b],
                       rows[b], cols[b],
                       static_cast<float*>(dst) + b * bucket * dim, bucket,
                       dim, zero_upto);
    }
    lengths[b] = std::min(rows[b], bucket);
  };
  const unsigned hc = std::thread::hardware_concurrency();
  if (hc <= 1) {
    // single-core host: the fill is pure memcpy/memset (memory-bound), so
    // pool handoffs are pure loss — run inline (caller already dropped
    // the GIL at the ctypes boundary)
    for (int64_t b = 0; b < batch; ++b) fill_one(b);
    return 0;
  }
  // multi-core: contiguous clip chunks, ~2 tasks per worker for balance
  const int64_t nchunks =
      std::min<int64_t>(batch, int64_t(std::max(4u, hc)) * 2);
  const int64_t per = (batch + nchunks - 1) / nchunks;
  std::atomic<int64_t> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int64_t c = 0; c < nchunks; ++c) {
    pool()->submit([&, c] {
      const int64_t lo = c * per;
      const int64_t hi = std::min(batch, lo + per);
      for (int64_t b = lo; b < hi; ++b) fill_one(b);
      if (done.fetch_add(1) + 1 == nchunks) {
        std::unique_lock<std::mutex> lk(mu);
        cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == nchunks; });
  return 0;
}

int sdumc_version() { return 3; }

}  // extern "C"
