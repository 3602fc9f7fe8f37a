// Native TTRS shard reader for the PyTorch package's data path
// (data/shards.py: ShardedDataset reads through it when it builds).
//
// The package's own copy of the JAX package's reader
// (two_tower_recommender_model_tpu/native/ttrs_reader.cpp): the same format,
// the same C ABI, the same bytes out. The format, as data/shards.py writes
// it:
//
//   magic  "TTRS1\n"
//   u64le  header_len
//   json   {"rows": R, "columns": [{"name","dtype","shape","compressed",
//                                   "stored_bytes"}]}
//   bytes  per-column payloads (zlib-compressed or raw), header order
//
// Exposed as a tiny C ABI (ctypes-friendly, no pybind11):
//   ttrs_open(path)          -> handle (parses header, leaves payloads on disk)
//   ttrs_num_columns/rows    -> introspection
//   ttrs_column_{name,dtype,shape,...}
//   ttrs_read_column(h, i, out, out_cap) -> decompress/copy into caller buffer
//   ttrs_read_columns_parallel(...)      -> one worker thread per column
//   ttrs_close(handle)
//
// Decompression is the CPU hotspot when streaming compressed shards: the
// parallel entry point inflates the columns on a thread each, so a shard
// reads in about the time of its largest column. Host code, no device: it
// feeds the loader that feeds the card. Python reads in numpy where this
// library does not build (ShardedDataset's use_native rule).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Column {
  std::string name;
  std::string dtype;        // numpy dtype str, e.g. "<i8"
  std::vector<int64_t> shape;
  bool compressed = false;
  int64_t stored_bytes = 0;
  int64_t raw_bytes = 0;    // product(shape) * itemsize
  int64_t file_offset = 0;  // payload start
};

struct Shard {
  std::string path;
  int64_t rows = 0;
  std::vector<Column> columns;
  std::string error;
};

constexpr char kMagic[] = "TTRS1\n";
constexpr size_t kMagicLen = 6;

int64_t DtypeItemsize(const std::string& dtype) {
  // numpy dtype strings: <i8, <f4, |b1, <u4, ...
  if (dtype.size() < 2) return -1;
  const std::string digits = dtype.substr(2);
  char* end = nullptr;
  long v = strtol(digits.c_str(), &end, 10);
  if (end == digits.c_str() || v <= 0) return -1;
  return v;
}

// Minimal JSON scanning for the fixed header schema (no external deps). The
// header is produced by our own writer, so strings contain no escapes beyond
// standard JSON for filenames/column names; we keep a strict tokenizer.
struct JsonScanner {
  const char* p;
  const char* end;
  bool fail = false;

  void SkipWs() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' || *p == ',')) ++p;
  }
  bool Consume(char c) {
    SkipWs();
    if (p < end && *p == c) { ++p; return true; }
    fail = true;
    return false;
  }
  bool Peek(char c) {
    SkipWs();
    return p < end && *p == c;
  }
  std::string String() {
    SkipWs();
    std::string out;
    if (p >= end || *p != '"') { fail = true; return out; }
    ++p;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) { ++p; }
      out.push_back(*p++);
    }
    if (p < end) ++p; else fail = true;
    return out;
  }
  int64_t Int() {
    SkipWs();
    char* e = nullptr;
    long long v = strtoll(p, &e, 10);
    if (e == p) { fail = true; return 0; }
    p = e;
    return v;
  }
  bool Bool() {
    SkipWs();
    if (end - p >= 4 && strncmp(p, "true", 4) == 0) { p += 4; return true; }
    if (end - p >= 5 && strncmp(p, "false", 5) == 0) { p += 5; return false; }
    fail = true;
    return false;
  }
  void SkipValue() {  // only used for unknown scalar fields
    SkipWs();
    if (p < end && *p == '"') { String(); return; }
    if (p < end && (*p == 't' || *p == 'f')) { Bool(); return; }
    Int();
  }
};

bool ParseHeader(const char* data, size_t len, Shard* shard) {
  JsonScanner s{data, data + len};
  if (!s.Consume('{')) return false;
  while (!s.Peek('}')) {
    std::string key = s.String();
    if (s.fail || !s.Consume(':')) return false;
    if (key == "rows") {
      shard->rows = s.Int();
    } else if (key == "columns") {
      if (!s.Consume('[')) return false;
      while (!s.Peek(']')) {
        if (!s.Consume('{')) return false;
        Column col;
        while (!s.Peek('}')) {
          std::string k = s.String();
          if (s.fail || !s.Consume(':')) return false;
          if (k == "name") col.name = s.String();
          else if (k == "dtype") col.dtype = s.String();
          else if (k == "compressed") col.compressed = s.Bool();
          else if (k == "stored_bytes") col.stored_bytes = s.Int();
          else if (k == "shape") {
            if (!s.Consume('[')) return false;
            while (!s.Peek(']')) col.shape.push_back(s.Int());
            s.Consume(']');
          } else s.SkipValue();
          if (s.fail) return false;
        }
        s.Consume('}');
        int64_t n = 1;
        for (int64_t d : col.shape) n *= d;
        int64_t item = DtypeItemsize(col.dtype);
        if (item <= 0) return false;
        col.raw_bytes = n * item;
        shard->columns.push_back(std::move(col));
      }
      s.Consume(']');
    } else {
      s.SkipValue();
    }
    if (s.fail) return false;
  }
  return !s.fail;
}

int ReadColumnImpl(const Shard* sh, int col_idx, uint8_t* out, int64_t out_cap) {
  if (col_idx < 0 || col_idx >= (int)sh->columns.size()) return -2;
  const Column& col = sh->columns[col_idx];
  if (out_cap < col.raw_bytes) return -3;

  FILE* f = fopen(sh->path.c_str(), "rb");
  if (!f) return -4;
  if (fseek(f, (long)col.file_offset, SEEK_SET) != 0) { fclose(f); return -5; }

  int rc = 0;
  if (!col.compressed) {
    if ((int64_t)fread(out, 1, col.raw_bytes, f) != col.raw_bytes) rc = -6;
  } else {
    std::vector<uint8_t> stored(col.stored_bytes);
    if ((int64_t)fread(stored.data(), 1, col.stored_bytes, f) != col.stored_bytes) {
      rc = -6;
    } else {
      uLongf dest_len = (uLongf)col.raw_bytes;
      if (uncompress(out, &dest_len, stored.data(), (uLong)col.stored_bytes) != Z_OK ||
          (int64_t)dest_len != col.raw_bytes) {
        rc = -7;
      }
    }
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

void* ttrs_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[kMagicLen];
  if (fread(magic, 1, kMagicLen, f) != kMagicLen ||
      memcmp(magic, kMagic, kMagicLen) != 0) {
    fclose(f);
    return nullptr;
  }
  uint64_t hlen = 0;
  if (fread(&hlen, 1, 8, f) != 8 || hlen > (64u << 20)) {  // little-endian host assumed (x86/ARM)
    fclose(f);
    return nullptr;
  }
  std::vector<char> header(hlen);
  if (fread(header.data(), 1, hlen, f) != hlen) {
    fclose(f);
    return nullptr;
  }
  auto* shard = new Shard();
  shard->path = path;
  if (!ParseHeader(header.data(), hlen, shard)) {
    delete shard;
    fclose(f);
    return nullptr;
  }
  int64_t offset = (int64_t)kMagicLen + 8 + (int64_t)hlen;
  for (auto& col : shard->columns) {
    col.file_offset = offset;
    offset += col.stored_bytes;
  }
  fclose(f);
  return shard;
}

void ttrs_close(void* handle) { delete static_cast<Shard*>(handle); }

int64_t ttrs_rows(void* handle) { return static_cast<Shard*>(handle)->rows; }

int ttrs_num_columns(void* handle) {
  return (int)static_cast<Shard*>(handle)->columns.size();
}

const char* ttrs_column_name(void* handle, int i) {
  return static_cast<Shard*>(handle)->columns[i].name.c_str();
}

const char* ttrs_column_dtype(void* handle, int i) {
  return static_cast<Shard*>(handle)->columns[i].dtype.c_str();
}

int ttrs_column_ndim(void* handle, int i) {
  return (int)static_cast<Shard*>(handle)->columns[i].shape.size();
}

int64_t ttrs_column_dim(void* handle, int i, int d) {
  return static_cast<Shard*>(handle)->columns[i].shape[d];
}

int64_t ttrs_column_nbytes(void* handle, int i) {
  return static_cast<Shard*>(handle)->columns[i].raw_bytes;
}

int ttrs_read_column(void* handle, int col_idx, uint8_t* out, int64_t out_cap) {
  return ReadColumnImpl(static_cast<Shard*>(handle), col_idx, out, out_cap);
}

// Read several columns concurrently (one thread each; zlib inflate is the
// bottleneck and parallelizes perfectly across columns).
int ttrs_read_columns_parallel(void* handle, const int* col_idxs, int n,
                               uint8_t** outs, const int64_t* out_caps) {
  const Shard* sh = static_cast<Shard*>(handle);
  std::vector<int> rcs(n, 0);
  std::vector<std::thread> threads;
  threads.reserve(n);
  for (int t = 0; t < n; ++t) {
    threads.emplace_back([&, t]() {
      rcs[t] = ReadColumnImpl(sh, col_idxs[t], outs[t], out_caps[t]);
    });
  }
  for (auto& th : threads) th.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

}  // extern "C"
