// recordio: chunked, CRC-checked, optionally zlib-compressed record file.
//
// Reference: paddle/fluid/recordio/{header,chunk,writer,
// scanner}.cc — same design (records batched into chunks, each chunk
// framed by a header carrying record count, sizes and a CRC32 of the
// payload), re-implemented as a dependency-free C API consumed from
// Python via ctypes (paddle_tpu_torch/native/__init__.py).
//
// Chunk layout (little-endian u32 fields):
//   MAGIC  FLAGS(0=raw,1=zlib)  N_RECORDS  RAW_LEN  STORED_LEN  CRC32
//   payload[STORED_LEN]      payload = concat{ u32 len, bytes } per record
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x7061646c;  // "padl"
constexpr uint32_t kFlagRaw = 0;
constexpr uint32_t kFlagZlib = 1;

struct Writer {
  FILE* f;
  std::vector<std::string> pending;
  size_t pending_bytes;
  size_t max_chunk_bytes;
  uint32_t flags;
};

struct Scanner {
  FILE* f;
  std::vector<std::string> records;  // current chunk, decoded
  size_t cursor;
  bool error;
};

bool write_u32(FILE* f, uint32_t v) { return fwrite(&v, 4, 1, f) == 1; }
bool read_u32(FILE* f, uint32_t* v) { return fread(v, 4, 1, f) == 1; }

bool flush_chunk(Writer* w) {
  if (w->pending.empty()) return true;
  std::string payload;
  payload.reserve(w->pending_bytes + 4 * w->pending.size());
  for (const auto& r : w->pending) {
    uint32_t len = static_cast<uint32_t>(r.size());
    payload.append(reinterpret_cast<const char*>(&len), 4);
    payload.append(r);
  }
  std::string stored;
  uint32_t flags = w->flags;
  if (flags == kFlagZlib) {
    uLongf bound = compressBound(payload.size());
    stored.resize(bound);
    if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &bound,
                  reinterpret_cast<const Bytef*>(payload.data()), payload.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
      return false;
    }
    stored.resize(bound);
  } else {
    stored = payload;
  }
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()), stored.size());
  if (!write_u32(w->f, kMagic) || !write_u32(w->f, flags) ||
      !write_u32(w->f, static_cast<uint32_t>(w->pending.size())) ||
      !write_u32(w->f, static_cast<uint32_t>(payload.size())) ||
      !write_u32(w->f, static_cast<uint32_t>(stored.size())) || !write_u32(w->f, crc)) {
    return false;
  }
  if (fwrite(stored.data(), 1, stored.size(), w->f) != stored.size()) return false;
  w->pending.clear();
  w->pending_bytes = 0;
  return true;
}

bool load_chunk(Scanner* s) {
  uint32_t magic, flags, n, raw_len, stored_len, crc;
  if (!read_u32(s->f, &magic)) return false;  // clean EOF
  if (magic != kMagic || !read_u32(s->f, &flags) || !read_u32(s->f, &n) ||
      !read_u32(s->f, &raw_len) || !read_u32(s->f, &stored_len) || !read_u32(s->f, &crc)) {
    s->error = true;
    return false;
  }
  std::string stored(stored_len, '\0');
  if (fread(&stored[0], 1, stored_len, s->f) != stored_len) {
    s->error = true;
    return false;
  }
  if (crc32(0L, reinterpret_cast<const Bytef*>(stored.data()), stored.size()) != crc) {
    s->error = true;
    return false;
  }
  std::string payload;
  if (flags == kFlagZlib) {
    payload.resize(raw_len);
    uLongf out_len = raw_len;
    if (uncompress(reinterpret_cast<Bytef*>(&payload[0]), &out_len,
                   reinterpret_cast<const Bytef*>(stored.data()), stored.size()) != Z_OK ||
        out_len != raw_len) {
      s->error = true;
      return false;
    }
  } else {
    payload = std::move(stored);
  }
  s->records.clear();
  s->records.reserve(n);
  size_t off = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + 4 > payload.size()) { s->error = true; return false; }
    uint32_t len;
    memcpy(&len, payload.data() + off, 4);
    off += 4;
    if (off + len > payload.size()) { s->error = true; return false; }
    s->records.emplace_back(payload.data() + off, len);
    off += len;
  }
  s->cursor = 0;
  return true;
}

}  // namespace

extern "C" {

void* recordio_writer_create(const char* path, int compress, int max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->pending_bytes = 0;
  w->max_chunk_bytes = max_chunk_bytes > 0 ? static_cast<size_t>(max_chunk_bytes) : (1 << 20);
  w->flags = compress ? kFlagZlib : kFlagRaw;
  return w;
}

int recordio_writer_write(void* handle, const char* data, int len) {
  auto* w = static_cast<Writer*>(handle);
  w->pending.emplace_back(data, len);
  w->pending_bytes += len;
  if (w->pending_bytes >= w->max_chunk_bytes) {
    return flush_chunk(w) ? 0 : -1;
  }
  return 0;
}

int recordio_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  int rc = flush_chunk(w) ? 0 : -1;
  fclose(w->f);
  delete w;
  return rc;
}

void* recordio_scanner_create(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner();
  s->f = f;
  s->cursor = 0;
  s->error = false;
  return s;
}

// Returns pointer to record bytes valid until the next call; len in *len.
// nullptr + *len==0 on EOF; nullptr + *len==-1 on corruption.
const char* recordio_scanner_next(void* handle, int* len) {
  auto* s = static_cast<Scanner*>(handle);
  if (s->cursor >= s->records.size()) {
    if (!load_chunk(s)) {
      *len = s->error ? -1 : 0;
      return nullptr;
    }
  }
  const std::string& r = s->records[s->cursor++];
  *len = static_cast<int>(r.size());
  return r.data();
}

void recordio_scanner_close(void* handle) {
  auto* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

// ---------------------------------------------------------------------------
// MultiSlot text parser (reference: paddle/fluid/framework/data_feed.cc
// MultiSlotDataFeed::ParseOneInstance — per line, per slot:
//   <num><space><num values...>   repeated for each slot)
// Parses a whole text block into per-slot flattened values + per-line
// counts, avoiding the Python tokenize/float() hot loop for CTR data.
// ---------------------------------------------------------------------------
struct ParsedSlots {
  std::vector<std::vector<float>> values;   // per slot
  std::vector<std::vector<int32_t>> counts; // per slot, per line
};

void* multislot_parse(const char* text, long text_len, int n_slots, int* n_lines_out) {
  auto* p = new ParsedSlots();
  p->values.resize(n_slots);
  p->counts.resize(n_slots);
  const char* cur = text;
  const char* end = text + text_len;
  int n_lines = 0;
  std::vector<size_t> line_start_values(n_slots);
  std::vector<size_t> line_start_counts(n_slots);
  while (cur < end) {
    const char* line_end = static_cast<const char*>(memchr(cur, '\n', end - cur));
    if (!line_end) line_end = end;
    if (line_end > cur) {
      // snapshot per-slot sizes so a malformed line restores exactly the
      // state before it, regardless of how many values were pushed
      for (int slot = 0; slot < n_slots; ++slot) {
        line_start_values[slot] = p->values[slot].size();
        line_start_counts[slot] = p->counts[slot].size();
      }
      const char* q = cur;
      bool ok = true;
      // strtol/strtof skip leading whitespace INCLUDING newlines, so an
      // under-filled line would otherwise steal tokens from the next
      // line; bound every token to [q, line_end).
      auto skip_ws = [&](const char*& s) {
        while (s < line_end && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
        return s < line_end;
      };
      for (int slot = 0; slot < n_slots && ok; ++slot) {
        char* next = nullptr;
        if (!skip_ws(q)) { ok = false; break; }
        long n = strtol(q, &next, 10);
        if (next == q || next > line_end || n < 0) { ok = false; break; }
        q = next;
        p->counts[slot].push_back(static_cast<int32_t>(n));
        for (long i = 0; i < n; ++i) {
          if (!skip_ws(q)) { ok = false; break; }
          float v = strtof(q, &next);
          if (next == q || next > line_end) { ok = false; break; }
          q = next;
          p->values[slot].push_back(v);
        }
      }
      if (ok) {
        ++n_lines;
      } else {
        for (int slot = 0; slot < n_slots; ++slot) {
          p->values[slot].resize(line_start_values[slot]);
          p->counts[slot].resize(line_start_counts[slot]);
        }
      }
    }
    cur = line_end + 1;
  }
  *n_lines_out = n_lines;
  return p;
}

long multislot_slot_size(void* handle, int slot) {
  return static_cast<ParsedSlots*>(handle)->values[slot].size();
}

void multislot_copy_slot(void* handle, int slot, float* values_out, int32_t* counts_out) {
  auto* p = static_cast<ParsedSlots*>(handle);
  memcpy(values_out, p->values[slot].data(), p->values[slot].size() * sizeof(float));
  memcpy(counts_out, p->counts[slot].data(), p->counts[slot].size() * sizeof(int32_t));
}

void multislot_free(void* handle) { delete static_cast<ParsedSlots*>(handle); }

}  // extern "C"
