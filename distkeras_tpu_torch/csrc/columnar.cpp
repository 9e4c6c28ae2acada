// Native columnar ETL kernels (C ABI, loaded via ctypes —
// distkeras_tpu_torch/native.py builds this with g++ on first use).
// The port's copy of the JAX package's native/columnar.cpp: the same
// entry points and the same arithmetic, so either package's lanes give
// the same columns.
//
// The reference is pure Python and delegates its host-side data work to
// Spark executors (SURVEY.md §2.2 "no native components"); the rebuild's
// hot host-side ETL loops — categorical hashing, affine feature scaling,
// sparse->dense scatter — run here instead of through numpy's
// per-column-fold / fancy-indexing paths.  Kernels are deliberately
// dependency-free scalar loops: -O3 autovectorizes the inner loops, and
// semantics exactly match the numpy reference implementations in
// data/transformers.py (tests assert parity).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// FNV-1a (64-bit) over each row's bytes, reduced mod num_buckets.
// data: [n, width] row-major fixed-width byte matrix (numpy 'S' dtype
// buffer); lengths[i] gives row i's real byte count.
void fnv1a_bucket(const uint8_t* data, int64_t n, int64_t width,
                  const int64_t* lengths, uint64_t num_buckets,
                  int32_t* out) {
  const uint64_t kOffset = 0xcbf29ce484222325ULL;
  const uint64_t kPrime = 0x100000001b3ULL;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = data + i * width;
    const int64_t len = lengths[i];
    uint64_t h = kOffset;
    for (int64_t j = 0; j < len; ++j) {
      h = (h ^ static_cast<uint64_t>(row[j])) * kPrime;
    }
    out[i] = static_cast<int32_t>(h % num_buckets);
  }
}

// Column-wise affine map: out[i,c] = f32(in[i,c] * scale[c] + shift[c]).
// Covers MinMax (scale = range_ratio/span, shift = new_min - min*scale)
// and StandardScale (scale = 1/(std+eps), shift = -mean*scale); the
// f64 accumulate matches the numpy paths' broadcast-to-f64 behavior.
void affine_scale(const float* in, int64_t rows, int64_t cols,
                  const double* scale, const double* shift, float* out) {
  for (int64_t i = 0; i < rows; ++i) {
    const float* src = in + i * cols;
    float* dst = out + i * cols;
    for (int64_t c = 0; c < cols; ++c) {
      dst[c] = static_cast<float>(
          static_cast<double>(src[c]) * scale[c] + shift[c]);
    }
  }
}

// Sparse (indices, values) padded pairs -> dense rows.
// idx: [rows, nnz] (pad entries < 0 ignored), out: [rows, dim] zeroed
// by the caller.
void dense_scatter(const int64_t* idx, const float* val, int64_t rows,
                   int64_t nnz, int64_t dim, float* out) {
  for (int64_t i = 0; i < rows; ++i) {
    float* dst = out + i * dim;
    for (int64_t j = 0; j < nnz; ++j) {
      const int64_t k = idx[i * nnz + j];
      if (k >= 0 && k < dim) {
        dst[k] = val[i * nnz + j];
      }
    }
  }
}

// ---- CSV fast lane (GIL-free parse for the out-of-core text path) ----
//
// The Python reference (`Dataset.from_csv`) is csv.reader + per-cell
// int()/float() — GIL-bound, so the segment-prefetch thread cannot
// overlap it with training dispatch.  These kernels tokenize and
// type-convert inside ctypes calls (GIL released), with semantics
// matched to the Python path (tests assert column-for-column parity).

// Tokenize a plain (unquoted) delimited buffer into per-cell
// (offset, length) pairs.  Scans data[skip..nbytes): one row per
// '\n'-terminated line (final unterminated line included), a trailing
// '\r' stripped, EMPTY lines skipped (csv.reader yields [] for them —
// the Python path drops falsy rows).  Every kept row must have exactly
// `cols` fields; on a mismatch returns -(1-based line number counted
// from `skip`).  Returns the number of data rows filled; `off`/`lens`
// are caller-allocated for the line-count upper bound.
int64_t csv_index(const char* data, int64_t nbytes, int64_t skip,
                  char delim, int64_t cols, int64_t* off,
                  int32_t* lens) {
  int64_t row = 0;
  int64_t line_no = 0;
  int64_t i = skip;
  while (i < nbytes) {
    int64_t j = i;
    while (j < nbytes && data[j] != '\n') ++j;
    int64_t end = j;
    if (end > i && data[end - 1] == '\r') --end;
    ++line_no;
    if (end > i) {
      int64_t c = 0;
      int64_t f = i;
      for (int64_t k = i; k <= end; ++k) {
        if (k == end || data[k] == delim) {
          if (c < cols) {
            off[row * cols + c] = f;
            lens[row * cols + c] = static_cast<int32_t>(k - f);
          }
          ++c;
          f = k + 1;
        }
      }
      if (c != cols) return -line_no;
      ++row;
    }
    i = j + 1;
  }
  return row;
}

// Numeric conversion for one column of a csv_index'd buffer.
// Fills iout AND fout; returns 0 when every cell parses as an int64,
// 1 when every cell parses as a double (fout valid), or -(row+1) at
// the first cell that is neither — the caller then takes the string
// path.  Matches Python int()/float() semantics for plain decimal
// spellings; hex ('0x..') and digit-underscore spellings are treated
// as strings (the Python path is strictened to agree — see
// Dataset.from_csv).
int64_t csv_parse_numeric(const char* data, const int64_t* off,
                          const int32_t* lens, int64_t rows,
                          int64_t cols, int64_t c, int64_t* iout,
                          double* fout) {
  char stack_buf[128];
  char* heap_buf = nullptr;
  int64_t heap_cap = 0;
  int all_int = 1;
  for (int64_t r = 0; r < rows; ++r) {
    const char* s = data + off[r * cols + c];
    int64_t len = lens[r * cols + c];
    while (len > 0 && (*s == ' ' || *s == '\t')) { ++s; --len; }
    while (len > 0 && (s[len - 1] == ' ' || s[len - 1] == '\t')) --len;
    if (len == 0) {
      free(heap_buf);
      return -(r + 1);
    }
    for (int64_t k = 0; k < len; ++k) {
      if (s[k] == 'x' || s[k] == 'X' || s[k] == '_') {
        free(heap_buf);
        return -(r + 1);
      }
    }
    char* buf = stack_buf;
    if (len >= static_cast<int64_t>(sizeof(stack_buf))) {
      if (len + 1 > heap_cap) {
        free(heap_buf);
        heap_cap = 2 * (len + 1);
        heap_buf = static_cast<char*>(malloc(heap_cap));
        if (heap_buf == nullptr) return -(r + 1);
      }
      buf = heap_buf;
    }
    memcpy(buf, s, len);
    buf[len] = '\0';
    char* endp = nullptr;
    if (all_int) {
      errno = 0;
      long long v = strtoll(buf, &endp, 10);
      if (endp == buf + len && errno == 0) {
        iout[r] = static_cast<int64_t>(v);
        fout[r] = static_cast<double>(v);
        continue;
      }
      // not an int (or overflowed past int64): re-parse everything
      // seen so far as doubles and continue on the float path —
      // matching the Python column-level int->float fallback
      all_int = 0;
      for (int64_t rr = 0; rr < r; ++rr) {
        fout[rr] = static_cast<double>(iout[rr]);
      }
    }
    errno = 0;
    double d = strtod(buf, &endp);
    if (endp != buf + len) {
      free(heap_buf);
      return -(r + 1);
    }
    (void)d;
    fout[r] = d;
  }
  free(heap_buf);
  return all_int ? 0 : 1;
}

// Copy one column's cells into a fixed-width, zero-padded byte matrix
// (numpy 'S' layout) for the string-column path.
void csv_fill_bytes(const char* data, const int64_t* off,
                    const int32_t* lens, int64_t rows, int64_t cols,
                    int64_t c, int64_t width, uint8_t* out) {
  for (int64_t r = 0; r < rows; ++r) {
    const char* s = data + off[r * cols + c];
    int64_t len = lens[r * cols + c];
    if (len > width) len = width;
    uint8_t* dst = out + r * width;
    memcpy(dst, s, len);
    if (len < width) memset(dst + len, 0, width - len);
  }
}

}  // extern "C"
