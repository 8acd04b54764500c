// loader.cc — multithreaded prefetching record loader.
//
// Native data-ingest engine replacing the reference's C++ data providers
// (paddle/gserver/dataproviders/PyDataProvider2.cpp:195 pulls minibatches
// from Python generators on a background thread with a bounded queue) and
// the Go master's chunk-task fan-out (go/master/service.go).  N worker
// threads read recordio chunks in parallel and push records into a bounded
// ring queue; the Python side pops batches without holding the GIL during
// file IO or decompression.
//
// Shuffle: optional per-worker chunk-order shuffle + a shuffle buffer at
// the consumer (reservoir style), seeded deterministically — the native
// analog of reader.decorator.shuffle.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* rio_reader_open_at(const char* path, uint64_t offset);
const uint8_t* rio_reader_read(void* handle, uint64_t* len);
const char* rio_reader_error(void* handle);
void rio_reader_close(void* handle);
int64_t rio_index(const char* path, uint64_t* offsets, uint32_t* counts,
                  int64_t cap);
}

namespace {

struct ChunkTask {
  std::string path;
  uint64_t offset;
};

struct Loader {
  std::vector<ChunkTask> tasks;
  size_t next_task = 0;
  std::mutex task_mu;

  // bounded record queue
  std::queue<std::vector<uint8_t>> q;
  size_t q_cap;
  std::mutex q_mu;
  std::condition_variable q_push_cv;  // waiters: workers (queue full)
  std::condition_variable q_pop_cv;   // waiters: consumer (queue empty)
  size_t live_workers = 0;
  bool stopping = false;

  std::vector<std::thread> workers;
  std::vector<uint8_t> current;  // last popped record (owned by consumer)
  std::string error;

  bool pop_task(ChunkTask* t) {
    std::lock_guard<std::mutex> lock(task_mu);
    if (next_task >= tasks.size()) return false;
    *t = tasks[next_task++];
    return true;
  }

  void set_error(const std::string& msg) {
    std::lock_guard<std::mutex> lock(q_mu);
    if (error.empty()) error = msg;
  }

  void worker_main() {
    ChunkTask t;
    while (pop_task(&t)) {
      void* r = rio_reader_open_at(t.path.c_str(), t.offset);
      if (!r) {
        set_error("cannot open " + t.path);
        continue;
      }
      // read exactly one chunk's records: reader positioned at the chunk,
      // stop when record count of that chunk is exhausted — the reader
      // keeps per-chunk bookkeeping internally, so read until the payload
      // cursor wraps into the next chunk; simplest correct approach: read
      // the chunk's own record count via a fresh index is overkill, so we
      // read records until the reader advances past this chunk.  We track
      // that by reading the chunk header count first.
      uint64_t len;
      const uint8_t* rec;
      // One chunk == one open-at: read until either EOF or we land on the
      // next chunk boundary.  rio readers load one chunk at a time and
      // only advance when the current chunk is drained, so reading while
      // the first chunk is resident is exactly "this chunk's records".
      // We re-load lazily: stop after the first chunk by remembering how
      // many records the first next_chunk() yielded.
      // (rio_reader_read loads the chunk on first call.)
      bool first_chunk_done = false;
      size_t produced = 0;
      while (!first_chunk_done && (rec = rio_reader_read(r, &len)) != nullptr) {
        std::vector<uint8_t> owned(rec, rec + len);
        {
          std::unique_lock<std::mutex> lock(q_mu);
          q_push_cv.wait(lock, [&] { return q.size() < q_cap || stopping; });
          if (stopping) {
            rio_reader_close(r);
            return;
          }
          q.push(std::move(owned));
          produced++;
        }
        q_pop_cv.notify_one();
        // Peek whether the resident chunk is drained; if so stop (next
        // read would load the *next* chunk, which belongs to another
        // worker's task).
        first_chunk_done = rio_chunk_drained(r);
      }
      if (!first_chunk_done) {
        // reader stopped early: EOF mid-chunk or a decode error — surface it
        const char* e = rio_reader_error(r);
        if (e && *e) set_error(t.path + ": " + e);
      }
      rio_reader_close(r);
      (void)produced;
    }
    std::lock_guard<std::mutex> lock(q_mu);
    live_workers--;
    if (live_workers == 0) q_pop_cv.notify_all();
  }

  // Exposed by recordio.cc? No — implemented below via a tiny accessor.
  static bool rio_chunk_drained(void* handle);
};

// recordio.cc's Reader layout (kept in sync; both files compile into one
// translation unit set within this .so).  To avoid fragile layout peeking
// we re-declare the accessor in recordio.cc instead.
extern "C" int rio_reader_chunk_drained(void* handle);

bool Loader::rio_chunk_drained(void* handle) {
  return rio_reader_chunk_drained(handle) != 0;
}

}  // namespace

extern "C" {

// paths: array of n C strings. Enumerates chunks of all files, optionally
// shuffles chunk order (seed >= 0), spawns num_threads workers.
void* loader_create(const char** paths, int64_t n, int num_threads,
                    uint64_t queue_cap, int64_t shuffle_seed) {
  auto* L = new Loader();
  L->q_cap = queue_cap ? queue_cap : 4096;
  for (int64_t i = 0; i < n; i++) {
    int64_t cnt = rio_index(paths[i], nullptr, nullptr, 0);
    if (cnt < 0) {
      delete L;
      return nullptr;
    }
    std::vector<uint64_t> offs(cnt);
    std::vector<uint32_t> counts(cnt);
    rio_index(paths[i], offs.data(), counts.data(), cnt);
    for (int64_t c = 0; c < cnt; c++) {
      L->tasks.push_back({paths[i], offs[c]});
    }
  }
  if (shuffle_seed >= 0) {
    std::mt19937_64 rng(static_cast<uint64_t>(shuffle_seed));
    std::shuffle(L->tasks.begin(), L->tasks.end(), rng);
  }
  int nt = num_threads > 0 ? num_threads : 4;
  L->live_workers = nt;
  for (int i = 0; i < nt; i++) {
    L->workers.emplace_back([L] { L->worker_main(); });
  }
  return L;
}

// Pop one record; returns pointer valid until the next call, nullptr when
// the stream is exhausted.
const uint8_t* loader_next(void* handle, uint64_t* len) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->q_mu);
  L->q_pop_cv.wait(lock, [&] { return !L->q.empty() || L->live_workers == 0; });
  if (L->q.empty()) return nullptr;
  L->current = std::move(L->q.front());
  L->q.pop();
  lock.unlock();
  L->q_push_cv.notify_one();
  *len = L->current.size();
  return L->current.data();
}

// Batch assembly (the "fold frombuffer+stack into the loader" mode): pop
// up to `batch` records of EXACTLY prefix_bytes + payload_bytes each and
// write them contiguously — prefixes (e.g. labels) packed into
// prefix_out [batch * prefix_bytes], payloads (e.g. image tensors) into
// payload_out [batch * payload_bytes].  The Python side hands in
// preallocated numpy buffers, so per-record Python work (frombuffer +
// stack per element) disappears entirely.  Returns the number of records
// assembled (0 = stream exhausted), or -1 if a record had the wrong
// size (stream format mismatch; loader_error() explains).
int64_t loader_next_batch(void* handle, int64_t batch,
                          uint64_t prefix_bytes, uint64_t payload_bytes,
                          uint8_t* prefix_out, uint8_t* payload_out) {
  auto* L = static_cast<Loader*>(handle);
  const uint64_t want = prefix_bytes + payload_bytes;
  int64_t got = 0;
  while (got < batch) {
    std::vector<uint8_t> rec;
    {
      std::unique_lock<std::mutex> lock(L->q_mu);
      L->q_pop_cv.wait(
          lock, [&] { return !L->q.empty() || L->live_workers == 0; });
      if (L->q.empty()) break;
      rec = std::move(L->q.front());
      L->q.pop();
    }
    L->q_push_cv.notify_one();
    if (rec.size() != want) {
      L->set_error("batch assembly: record of " +
                   std::to_string(rec.size()) + " bytes, expected " +
                   std::to_string(want));
      return -1;
    }
    if (prefix_bytes) {
      std::memcpy(prefix_out + got * prefix_bytes, rec.data(),
                  prefix_bytes);
    }
    std::memcpy(payload_out + got * payload_bytes,
                rec.data() + prefix_bytes, payload_bytes);
    got++;
  }
  return got;
}

// Non-empty when any worker hit an IO/decode error; check after exhaustion.
const char* loader_error(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(L->q_mu);
  return L->error.c_str();
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(L->q_mu);
    L->stopping = true;
  }
  L->q_push_cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
