// recordio.cc — chunked record file format with CRC32 + optional zlib
// compression.
//
// The port's own copy of the JAX package's recordio codec (the same
// on-disk bytes, so files cross between the packages both ways): the Go
// master partitions datasets into RecordIO chunks and hands them out as
// tasks (reference go/master/service.go:106 partition), and the v2 reader
// layer creates readers over recordio files (reference
// python/paddle/v2/reader/creator.py:60).  This is the native (C++)
// storage layer under paddle_tpu_torch.reader /
// paddle_tpu_torch.distributed.master.
//
// File layout:
//   File  := Chunk*
//   Chunk := Header Payload
//   Header (little-endian):
//     u32 magic       0x50545243 ("CRTP")
//     u32 compressor  0 = none, 1 = zlib
//     u32 crc32       of the *stored* (possibly compressed) payload bytes
//     u32 num_records
//     u64 raw_len     uncompressed payload length
//     u64 stored_len  stored payload length
//   Payload (after decompression) := { u32 record_len, bytes }*
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in this image).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545243u;  // "CRTP"

#pragma pack(push, 1)
struct ChunkHeader {
  uint32_t magic;
  uint32_t compressor;
  uint32_t crc;
  uint32_t num_records;
  uint64_t raw_len;
  uint64_t stored_len;
};
#pragma pack(pop)

struct Writer {
  FILE* f = nullptr;
  int compressor = 0;
  size_t max_chunk_bytes = 0;
  uint32_t num_records = 0;
  std::vector<uint8_t> buf;  // raw payload being accumulated
  std::string error;

  bool flush_chunk() {
    if (num_records == 0) return true;
    std::vector<uint8_t> stored;
    const std::vector<uint8_t>* out = &buf;
    if (compressor == 1) {
      uLongf bound = compressBound(buf.size());
      stored.resize(bound);
      if (compress2(stored.data(), &bound, buf.data(), buf.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK) {
        error = "zlib compress failed";
        return false;
      }
      stored.resize(bound);
      out = &stored;
    }
    ChunkHeader h;
    h.magic = kMagic;
    h.compressor = static_cast<uint32_t>(compressor);
    h.crc = crc32(0, out->data(), out->size());
    h.num_records = num_records;
    h.raw_len = buf.size();
    h.stored_len = out->size();
    if (fwrite(&h, sizeof(h), 1, f) != 1 ||
        (!out->empty() && fwrite(out->data(), 1, out->size(), f) != out->size())) {
      error = "short write";
      return false;
    }
    buf.clear();
    num_records = 0;
    return true;
  }
};

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> payload;  // decompressed current chunk
  size_t pos = 0;                // cursor into payload
  uint32_t remaining = 0;        // records left in current chunk
  std::string error;

  // Load the next chunk; returns false at EOF or error.
  bool next_chunk() {
    ChunkHeader h;
    size_t n = fread(&h, 1, sizeof(h), f);
    if (n == 0) return false;  // clean EOF
    if (n != sizeof(h) || h.magic != kMagic) {
      error = "corrupt chunk header";
      return false;
    }
    std::vector<uint8_t> stored(h.stored_len);
    if (fread(stored.data(), 1, stored.size(), f) != stored.size()) {
      error = "truncated chunk payload";
      return false;
    }
    if (crc32(0, stored.data(), stored.size()) != h.crc) {
      error = "chunk crc mismatch";
      return false;
    }
    if (h.compressor == 1) {
      payload.resize(h.raw_len);
      uLongf raw = h.raw_len;
      if (uncompress(payload.data(), &raw, stored.data(), stored.size()) !=
              Z_OK ||
          raw != h.raw_len) {
        error = "zlib uncompress failed";
        return false;
      }
    } else {
      payload = std::move(stored);
    }
    pos = 0;
    remaining = h.num_records;
    return true;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer
void* rio_writer_open(const char* path, int compressor,
                      uint64_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  w->max_chunk_bytes = max_chunk_bytes ? max_chunk_bytes : (1u << 20);
  return w;
}

int rio_writer_write(void* handle, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (len > UINT32_MAX) {
    w->error = "record larger than 4 GiB";
    return -1;
  }
  uint32_t len32 = static_cast<uint32_t>(len);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&len32);
  w->buf.insert(w->buf.end(), p, p + sizeof(len32));
  w->buf.insert(w->buf.end(), data, data + len);
  w->num_records++;
  if (w->buf.size() >= w->max_chunk_bytes) {
    if (!w->flush_chunk()) return -1;
  }
  return 0;
}

int rio_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  int rc = w->flush_chunk() ? 0 : -1;
  fclose(w->f);
  delete w;
  return rc;
}

// ---------------------------------------------------------------- reader
void* rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  return r;
}

// Returns pointer to the record bytes (valid until the next call) and sets
// *len.  Returns nullptr at EOF or error (check rio_reader_error).
const uint8_t* rio_reader_read(void* handle, uint64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  while (r->remaining == 0) {
    if (!r->next_chunk()) return nullptr;
  }
  if (r->pos + 4 > r->payload.size()) {
    r->error = "corrupt record length";
    return nullptr;
  }
  uint32_t rec_len;
  memcpy(&rec_len, r->payload.data() + r->pos, 4);
  r->pos += 4;
  if (r->pos + rec_len > r->payload.size()) {
    r->error = "corrupt record payload";
    return nullptr;
  }
  const uint8_t* out = r->payload.data() + r->pos;
  r->pos += rec_len;
  r->remaining--;
  *len = rec_len;
  return out;
}

const char* rio_reader_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

// 1 when the currently-resident chunk has been fully consumed (the next
// read would load a new chunk).  Lets the loader treat "one chunk" as one
// unit of work (go/master task granularity).
int rio_reader_chunk_drained(void* handle) {
  return static_cast<Reader*>(handle)->remaining == 0 ? 1 : 0;
}

void rio_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  fclose(r->f);
  delete r;
}

// ------------------------------------------------------- chunk indexing
// Scan chunk boundaries so a dataset master can partition a file into
// chunk-granular tasks (go/master/service.go partition analog).  Fills up
// to cap (offset, num_records) pairs; returns total chunk count, or -1.
int64_t rio_index(const char* path, uint64_t* offsets, uint32_t* counts,
                  int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  for (;;) {
    long off = ftell(f);
    ChunkHeader h;
    size_t got = fread(&h, 1, sizeof(h), f);
    if (got == 0) break;
    if (got != sizeof(h) || h.magic != kMagic) {
      fclose(f);
      return -1;
    }
    if (n < cap) {
      offsets[n] = static_cast<uint64_t>(off);
      counts[n] = h.num_records;
    }
    n++;
    if (fseek(f, static_cast<long>(h.stored_len), SEEK_CUR) != 0) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return n;
}

// Open a reader positioned at a specific chunk offset (task execution).
void* rio_reader_open_at(const char* path, uint64_t offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  auto* r = new Reader();
  r->f = f;
  return r;
}

}  // extern "C"
