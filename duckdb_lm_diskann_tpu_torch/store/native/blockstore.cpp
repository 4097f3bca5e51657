// Native block-file store for graph.lmd — the concrete implementation of the
// reference's store::IFileSystemService interface
// (src/lm_diskann/store/IFileSystemService.hpp:16-76: Open/Close/ReadBlock/
// WriteBlock/GetFileSize/Truncate/Sync over one data file), which the
// reference leaves with no concrete impl (SURVEY §2.1). The V2 design doc
// specifies graph.lmd as an append-friendly fixed-size-block file with
// per-block checksums (Consolidated Proposal:15-26, :41).
//
// Layout:
//   [4096-byte header][block 0][block 1]...[block n-1]
// Header: magic, format version, block_size, num_blocks, clean_shutdown.
// CRC32 integrity is computed here (zlib's CRC-32, a byte-wise table CRC) and
// stored by the Python layer in the shadow store per the design doc.
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in this image).
// Batch read/write entry points move whole [n, block_size] buffers in one
// call so Python overhead is O(1) per checkpoint, not O(blocks).

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4C4D444B414E4E31ULL;  // "LMDKANN1"
constexpr uint32_t kFormatVersion = 3;              // LMDISKANN format v3
constexpr uint64_t kHeaderSize = 4096;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t block_size;
  uint64_t num_blocks;
  uint32_t clean_shutdown;
  uint32_t reserved;
};

// --- Async flush engine -----------------------------------------------------
// The V2 design's background flush daemon (Consolidated Proposal:96-107):
// a per-store writer thread draining a bounded FIFO of write jobs, so the
// caller overlaps block encoding / CRC / device pulls with disk I/O.
// Jobs copy their payload (bounded by kMaxQueueBytes back-pressure), are
// executed strictly in submission order, and the first failure latches an
// error code returned by every subsequent wait (fail-stop semantics: the
// checkpoint aborts and the dirty flag keeps the file in full-rewrite mode).

struct FlushJob {
  uint64_t id;
  bool scattered;            // use idx[] per row; else contiguous at first
  uint64_t first = 0;
  std::vector<uint64_t> idx;
  std::vector<uint8_t> data; // n_blocks * block_size bytes; empty => fsync
  uint64_t n_blocks = 0;
};

struct Store;
int do_write_blocks(Store* s, uint64_t first_idx, uint64_t n,
                    const uint8_t* buf);
int do_write_blocks_at(Store* s, const uint64_t* indices, uint64_t n,
                       const uint8_t* buf);

struct AsyncEngine {
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_submit;  // queue has room / shutdown
  std::condition_variable cv_done;    // job completed
  std::deque<std::unique_ptr<FlushJob>> q;
  uint64_t next_id = 1;
  uint64_t completed_id = 0;  // all jobs <= this id are done
  size_t queued_bytes = 0;
  int error = 0;      // first failure, sticky until bs_async_reset
  bool stopping = false;
  static constexpr size_t kMaxQueueBytes = 256ull << 20;
};

struct Store {
  int fd = -1;
  Header hdr{};
  std::unique_ptr<AsyncEngine> async_;  // created on first async submit
};

// CRC32 (IEEE 802.3 polynomial, table-driven).
uint32_t crc_table[256];
std::once_flag crc_init_once;

// Thread-safe: checkpoints compute CRCs from several threads at once.
void crc_init() {
  std::call_once(crc_init_once, [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  });
}

uint32_t crc32_buf(const uint8_t* buf, size_t len, uint32_t seed) {
  crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Full-transfer pwrite/pread loops. One pwrite syscall is capped (~2GiB on
// Linux) and a short transfer does NOT set errno, so single-call I/O over a
// large checkpoint silently truncates; loop until every byte moves and
// return a distinct error for genuinely short transfers (EOF on read).
constexpr int kErrShortIO = -75000;  // distinct from any -errno

int full_pwrite(int fd, const uint8_t* buf, size_t len, off_t off) {
  while (len > 0) {
    ssize_t w = pwrite(fd, buf, len, off);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (w == 0) return kErrShortIO;
    buf += w;
    off += w;
    len -= (size_t)w;
  }
  return 0;
}

int full_pread(int fd, uint8_t* buf, size_t len, off_t off) {
  while (len > 0) {
    ssize_t r = pread(fd, buf, len, off);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return kErrShortIO;  // EOF before len bytes
    buf += r;
    off += r;
    len -= (size_t)r;
  }
  return 0;
}

bool write_header(Store* s) {
  uint8_t page[kHeaderSize] = {0};
  std::memcpy(page, &s->hdr, sizeof(Header));
  return full_pwrite(s->fd, page, kHeaderSize, 0) == 0;
}

off_t block_offset(const Store* s, uint64_t idx) {
  return (off_t)kHeaderSize + (off_t)idx * s->hdr.block_size;
}

int do_write_blocks(Store* s, uint64_t first_idx, uint64_t n,
                    const uint8_t* buf) {
  size_t bytes = (size_t)n * s->hdr.block_size;
  int rc = full_pwrite(s->fd, buf, bytes, block_offset(s, first_idx));
  if (rc != 0) return rc;
  if (first_idx + n > s->hdr.num_blocks) {
    s->hdr.num_blocks = first_idx + n;
    if (!write_header(s)) return -EIO;
  }
  return 0;
}

int do_write_blocks_at(Store* s, const uint64_t* indices, uint64_t n,
                       const uint8_t* buf) {
  uint64_t max_idx = 0;
  for (uint64_t i = 0; i < n; ++i) {
    int rc = full_pwrite(s->fd, buf + (size_t)i * s->hdr.block_size,
                         s->hdr.block_size, block_offset(s, indices[i]));
    if (rc != 0) return rc;
    if (indices[i] > max_idx) max_idx = indices[i];
  }
  if (n && max_idx + 1 > s->hdr.num_blocks) {
    s->hdr.num_blocks = max_idx + 1;
    if (!write_header(s)) return -EIO;
  }
  return 0;
}

void async_worker(Store* s) {
  AsyncEngine* e = s->async_.get();
  for (;;) {
    std::unique_ptr<FlushJob> job;
    {
      std::unique_lock<std::mutex> lk(e->mu);
      e->cv_submit.wait(lk, [&] { return e->stopping || !e->q.empty(); });
      if (e->q.empty()) return;  // stopping and drained
      job = std::move(e->q.front());
      e->q.pop_front();
      e->queued_bytes -= job->data.size();
    }
    e->cv_submit.notify_all();  // queue freed room
    int rc = 0;
    if (e->error == 0) {  // fail-stop: skip work after first error
      if (job->data.empty()) {
        rc = fsync(s->fd) == 0 ? 0 : -errno;
      } else if (job->scattered) {
        rc = do_write_blocks_at(s, job->idx.data(), job->n_blocks,
                                job->data.data());
      } else {
        rc = do_write_blocks(s, job->first, job->n_blocks, job->data.data());
      }
    }
    {
      std::lock_guard<std::mutex> lk(e->mu);
      if (rc != 0 && e->error == 0) e->error = rc;
      e->completed_id = job->id;
    }
    e->cv_done.notify_all();
  }
}

AsyncEngine* ensure_engine(Store* s) {
  if (!s->async_) {
    s->async_ = std::make_unique<AsyncEngine>();
    s->async_->worker = std::thread(async_worker, s);
  }
  return s->async_.get();
}

// Enqueue a job (copies buf); blocks while the queue is over budget.
uint64_t submit_job(Store* s, std::unique_ptr<FlushJob> job) {
  AsyncEngine* e = ensure_engine(s);
  std::unique_lock<std::mutex> lk(e->mu);
  size_t sz = job->data.size();
  e->cv_submit.wait(lk, [&] {
    return e->queued_bytes + sz <= AsyncEngine::kMaxQueueBytes ||
           e->q.empty();
  });
  job->id = e->next_id++;
  uint64_t id = job->id;
  e->queued_bytes += sz;
  e->q.push_back(std::move(job));
  lk.unlock();
  e->cv_submit.notify_all();
  return id;
}

void stop_engine(Store* s) {
  if (!s->async_) return;
  AsyncEngine* e = s->async_.get();
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->stopping = true;
  }
  e->cv_submit.notify_all();
  if (e->worker.joinable()) e->worker.join();
  s->async_.reset();
}

}  // namespace

extern "C" {

// Returns handle (>0 cast of pointer) or 0 on failure.
void* bs_open(const char* path, uint32_t block_size, int create) {
  Store* s = new Store();
  int flags = O_RDWR | (create ? O_CREAT : 0);
  s->fd = ::open(path, flags, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  struct stat st;
  if (fstat(s->fd, &st) != 0) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  if (st.st_size >= (off_t)kHeaderSize) {
    uint8_t page[kHeaderSize];
    if (full_pread(s->fd, page, kHeaderSize, 0) != 0) {
      ::close(s->fd);
      delete s;
      return nullptr;
    }
    std::memcpy(&s->hdr, page, sizeof(Header));
    if (s->hdr.magic != kMagic || s->hdr.block_size != block_size) {
      ::close(s->fd);
      delete s;
      return nullptr;
    }
  } else {
    s->hdr = Header{kMagic, kFormatVersion, block_size, 0, 1, 0};
    if (!write_header(s)) {
      ::close(s->fd);
      delete s;
      return nullptr;
    }
  }
  return s;
}

// Close WITHOUT touching the clean_shutdown flag: the flag is the
// checkpoint protocol's crash marker (bs_mark_dirty(1) before phase 1,
// bs_mark_dirty(0) after phase 2 commits) — an exception path that still
// closes the handle must leave the file marked dirty so the next save
// falls back to a full rewrite.
int bs_close(void* h) {
  Store* s = (Store*)h;
  if (!s) return -1;
  stop_engine(s);  // drain pending async jobs before the final fsync
  fsync(s->fd);
  int rc = ::close(s->fd);
  delete s;
  return rc;
}

uint64_t bs_num_blocks(void* h) { return ((Store*)h)->hdr.num_blocks; }
uint32_t bs_block_size(void* h) { return ((Store*)h)->hdr.block_size; }
uint32_t bs_format_version(void* h) { return ((Store*)h)->hdr.version; }

// Grow/shrink the block count (Truncate of IFileSystemService).
int bs_truncate(void* h, uint64_t num_blocks) {
  Store* s = (Store*)h;
  if (ftruncate(s->fd, block_offset(s, num_blocks)) != 0) return -errno;
  s->hdr.num_blocks = num_blocks;
  return write_header(s) ? 0 : -EIO;
}

// Write n contiguous blocks starting at first_idx from buf (n * block_size
// bytes). Extends the file as needed.
int bs_write_blocks(void* h, uint64_t first_idx, uint64_t n, const uint8_t* buf) {
  return do_write_blocks((Store*)h, first_idx, n, buf);
}

// Scattered write: indices[i] gives the block index of buf row i.
int bs_write_blocks_at(void* h, const uint64_t* indices, uint64_t n,
                       const uint8_t* buf) {
  return do_write_blocks_at((Store*)h, indices, n, buf);
}

// --- Async flush API (background writer thread; see AsyncEngine above) -----
// Contract: while async jobs are pending, do not issue synchronous writes
// on the same handle (jobs run strictly in submission order on the worker
// thread). bs_job_wait(last_id) — or bs_close — drains the pipeline.

// Enqueue a contiguous write; copies buf. Returns job id (>0).
uint64_t bs_submit_write(void* h, uint64_t first_idx, uint64_t n,
                         const uint8_t* buf) {
  Store* s = (Store*)h;
  auto job = std::make_unique<FlushJob>();
  job->scattered = false;
  job->first = first_idx;
  job->n_blocks = n;
  job->data.assign(buf, buf + (size_t)n * s->hdr.block_size);
  return submit_job(s, std::move(job));
}

// Enqueue a scattered write; copies buf and indices. Returns job id (>0).
uint64_t bs_submit_write_at(void* h, const uint64_t* indices, uint64_t n,
                            const uint8_t* buf) {
  Store* s = (Store*)h;
  auto job = std::make_unique<FlushJob>();
  job->scattered = true;
  job->idx.assign(indices, indices + n);
  job->n_blocks = n;
  job->data.assign(buf, buf + (size_t)n * s->hdr.block_size);
  return submit_job(s, std::move(job));
}

// Enqueue an fsync barrier (runs after all previously submitted jobs).
uint64_t bs_submit_sync(void* h) {
  auto job = std::make_unique<FlushJob>();
  job->scattered = false;
  job->n_blocks = 0;  // empty data => fsync
  return submit_job((Store*)h, std::move(job));
}

// Block until job_id (and every earlier job) completes. Returns 0 or the
// engine's first (sticky) error.
int bs_job_wait(void* h, uint64_t job_id) {
  Store* s = (Store*)h;
  if (!s->async_) return 0;
  AsyncEngine* e = s->async_.get();
  std::unique_lock<std::mutex> lk(e->mu);
  e->cv_done.wait(lk, [&] { return e->completed_id >= job_id; });
  return e->error;
}

// Jobs still queued or running (0 == idle).
uint64_t bs_async_pending(void* h) {
  Store* s = (Store*)h;
  if (!s->async_) return 0;
  AsyncEngine* e = s->async_.get();
  std::lock_guard<std::mutex> lk(e->mu);
  return (e->next_id - 1) - e->completed_id;
}

// Sticky first error of the async engine (0 == none).
int bs_async_error(void* h) {
  Store* s = (Store*)h;
  if (!s->async_) return 0;
  std::lock_guard<std::mutex> lk(s->async_->mu);
  return s->async_->error;
}

int bs_read_blocks(void* h, uint64_t first_idx, uint64_t n, uint8_t* buf) {
  Store* s = (Store*)h;
  size_t bytes = (size_t)n * s->hdr.block_size;
  return full_pread(s->fd, buf, bytes, block_offset(s, first_idx));
}

int bs_read_blocks_at(void* h, const uint64_t* indices, uint64_t n,
                      uint8_t* buf) {
  Store* s = (Store*)h;
  for (uint64_t i = 0; i < n; ++i) {
    int rc = full_pread(s->fd, buf + (size_t)i * s->hdr.block_size,
                        s->hdr.block_size, block_offset(s, indices[i]));
    if (rc != 0) return rc;
  }
  return 0;
}

int bs_sync(void* h) { return fsync(((Store*)h)->fd) == 0 ? 0 : -errno; }

int64_t bs_file_size(void* h) {
  struct stat st;
  if (fstat(((Store*)h)->fd, &st) != 0) return -errno;
  return st.st_size;
}

// CRC32 of n contiguous buffer rows of row_bytes each -> out[n].
// Rows are independent, so a large batch is split over threads (one per
// hardware thread, at least 8 MiB each); the table is built first, so the
// workers only read it.
void bs_crc32_rows(const uint8_t* buf, uint64_t n, uint64_t row_bytes,
                   uint32_t* out) {
  crc_init();
  auto run = [=](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i)
      out[i] = crc32_buf(buf + i * row_bytes, row_bytes, 0);
  };
  constexpr uint64_t kMinBytesPerThread = 8ull << 20;
  uint64_t threads = std::thread::hardware_concurrency();
  uint64_t by_size = (n * row_bytes) / kMinBytesPerThread;
  if (by_size < threads) threads = by_size;
  if (threads < 2) {
    run(0, n);
    return;
  }
  std::vector<std::thread> pool;
  uint64_t per = (n + threads - 1) / threads;
  for (uint64_t lo = 0; lo < n; lo += per)
    pool.emplace_back(run, lo, lo + per < n ? lo + per : n);
  for (auto& t : pool) t.join();
}

// Mark the store dirty (called before a mutation batch); clean on close.
int bs_mark_dirty(void* h, int dirty) {
  Store* s = (Store*)h;
  s->hdr.clean_shutdown = dirty ? 0 : 1;
  return write_header(s) ? 0 : -EIO;
}

int bs_clean_shutdown(void* h) { return ((Store*)h)->hdr.clean_shutdown; }

}  // extern "C"
