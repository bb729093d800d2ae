// First-party packed-record IO for the host input pipeline.
//
// The reference serializes every dataset with CPython `marshal`
// (create_mt_batches.py:38-40, dataset.py:59) — load time deserializes the
// whole corpus into Python lists. This replaces that with a flat mmap-able
// format so readers touch no Python objects until batch assembly, and batch
// padding/packing runs in C.
//
// ITR1 layout (little-endian):
//   magic   "ITR1"                                   4 bytes
//   F       u32   fields per record                  4 bytes
//   N       u64   record count                       8 bytes
//   index   u64[N*F + 1]  cumulative int32 offsets into the data region
//   data    i32[total]    all field payloads, concatenated
//
// Field f of record i spans data[index[i*F+f] .. index[i*F+f+1]).
// Scalars are stored as length-1 fields.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- writer

struct RecWriter {
  FILE* data;
  std::string path;
  std::string tmp_path;
  uint64_t n_fields;
  uint64_t fields_written;
  std::vector<uint64_t> offsets;  // cumulative int32 counts, starts at 0
  uint64_t total;
};

RecWriter* rec_writer_new(const char* path, uint64_t n_fields) {
  RecWriter* w = new RecWriter();
  w->path = path;
  w->tmp_path = std::string(path) + ".data.tmp";
  w->data = fopen(w->tmp_path.c_str(), "wb");
  if (!w->data) {
    delete w;
    return nullptr;
  }
  w->n_fields = n_fields;
  w->fields_written = 0;
  w->total = 0;
  w->offsets.push_back(0);
  return w;
}

int rec_writer_add_field(RecWriter* w, const int32_t* data, uint64_t len) {
  if (len > 0 && fwrite(data, sizeof(int32_t), len, w->data) != len)
    return -1;
  w->total += len;
  w->offsets.push_back(w->total);
  w->fields_written++;
  return 0;
}

void rec_writer_abort(RecWriter* w) {
  fclose(w->data);
  remove(w->tmp_path.c_str());
  delete w;
}

int rec_writer_close(RecWriter* w) {
  fclose(w->data);
  if (w->fields_written % w->n_fields != 0) {
    remove(w->tmp_path.c_str());
    delete w;
    return -2;  // torn record
  }
  uint64_t n_records = w->fields_written / w->n_fields;
  FILE* out = fopen(w->path.c_str(), "wb");
  if (!out) {
    remove(w->tmp_path.c_str());
    delete w;
    return -1;
  }
  fwrite("ITR1", 1, 4, out);
  uint32_t F = (uint32_t)w->n_fields;
  fwrite(&F, 4, 1, out);
  fwrite(&n_records, 8, 1, out);
  fwrite(w->offsets.data(), 8, w->offsets.size(), out);
  FILE* in = fopen(w->tmp_path.c_str(), "rb");
  if (!in) {  // tmp vanished underneath us (external cleanup)
    fclose(out);
    remove(w->path.c_str());
    delete w;
    return -1;
  }
  std::vector<char> buf(1 << 20);
  size_t k;
  while ((k = fread(buf.data(), 1, buf.size(), in)) > 0)
    fwrite(buf.data(), 1, k, out);
  fclose(in);
  int rc = fclose(out) == 0 ? 0 : -1;
  remove(w->tmp_path.c_str());
  delete w;
  return rc;
}

// ---------------------------------------------------------------- reader

struct RecReader {
  void* map;
  size_t size;
  uint32_t F;
  uint64_t N;
  const uint64_t* index;
  const int32_t* data;
};

// Opening VALIDATES the whole header + index against the mapped size: a
// truncated or bit-flipped file (valid magic, bogus N/F, non-monotonic
// or out-of-range offsets) must surface as a clean refusal (nullptr ->
// OSError in Python, where the loaders fall back / report the path), not
// as a segfault in the middle of an epoch. The monotonic index scan is a
// one-time sequential read of 8 bytes/field — page-cache speed.
RecReader* rec_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return nullptr;
  const char* p = (const char*)m;
  uint32_t F;
  uint64_t N;
  memcpy(&F, p + 4, 4);
  memcpy(&N, p + 8, 8);
  const uint64_t size = (uint64_t)st.st_size;
  bool ok = memcmp(p, "ITR1", 4) == 0 && F > 0;
  // Overflow-safe: need 8*(N*F + 1) <= size - 16.
  const uint64_t max_fields = (size - 16) / 8;  // >= N*F + 1 required
  if (ok) ok = max_fields >= 1 && N <= (max_fields - 1) / F;
  uint64_t nf = ok ? N * (uint64_t)F : 0;
  const uint64_t* index = (const uint64_t*)(p + 16);
  if (ok) {
    const uint64_t data_bytes = size - 16 - 8 * (nf + 1);
    const uint64_t data_elems = data_bytes / sizeof(int32_t);
    ok = index[0] == 0 && index[nf] <= data_elems;
    for (uint64_t k = 0; ok && k < nf; k++) {
      if (index[k + 1] < index[k]) ok = false;
    }
  }
  if (!ok) {
    munmap(m, st.st_size);
    return nullptr;
  }
  RecReader* r = new RecReader();
  r->map = m;
  r->size = st.st_size;
  r->F = F;
  r->N = N;
  r->index = index;
  r->data = (const int32_t*)(p + 16 + 8 * (nf + 1));
  return r;
}

void rec_close(RecReader* r) {
  munmap(r->map, r->size);
  delete r;
}

uint64_t rec_count(RecReader* r) { return r->N; }
uint32_t rec_fields(RecReader* r) { return r->F; }

uint64_t rec_field_len(RecReader* r, uint64_t i, uint32_t f) {
  uint64_t k = i * r->F + f;
  return r->index[k + 1] - r->index[k];
}

const int32_t* rec_field_ptr(RecReader* r, uint64_t i, uint32_t f) {
  return r->data + r->index[i * r->F + f];
}

// All lengths of field f (for length-sorting/bucketing without touching data).
void rec_lens(RecReader* r, uint32_t f, int64_t* out) {
  for (uint64_t i = 0; i < r->N; i++)
    out[i] = (int64_t)rec_field_len(r, i, f);
}

// All values of a scalar (length-1) field f.
void rec_scalars(RecReader* r, uint32_t f, int32_t* out) {
  for (uint64_t i = 0; i < r->N; i++) out[i] = *rec_field_ptr(r, i, f);
}

// Gather records idx[0..n) field f into a padded [n, T] int32 matrix —
// the batch-assembly hot loop, in C instead of a Python row loop.
void rec_pack_padded(RecReader* r, const int64_t* idx, int64_t n, uint32_t f,
                     int64_t T, int32_t pad, int32_t* out) {
  for (int64_t row = 0; row < n; row++) {
    uint64_t i = (uint64_t)idx[row];
    uint64_t len = rec_field_len(r, i, f);
    if ((int64_t)len > T) len = (uint64_t)T;
    memcpy(out + row * T, rec_field_ptr(r, i, f), len * sizeof(int32_t));
    for (int64_t t = (int64_t)len; t < T; t++) out[row * T + t] = pad;
  }
}

}  // extern "C"
