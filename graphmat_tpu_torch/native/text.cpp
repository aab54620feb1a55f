// The text edge-list parser: "src dst [val]" rows.
//
// A copy of gm_parse_text_edges with skip_ws, parse_i32 and parse_f64
// (graphmat_tpu/native/planner.cpp:1497-1588), which the port does not
// import: the native counterpart of the reference's readLine text path
// (edgelist.h:89-151).  Two passes over chunks of the buffer cut at line
// starts, one thread a chunk: count the non-blank lines and take their
// prefix sum, then parse each chunk's rows into its global offsets.
// Returns the number of rows parsed (blank lines skipped), or -1 on a
// malformed row.  val_kind: 0 = no value (val untouched), 1 = int32
// (the value parsed as a double, then truncated), 2 = float32,
// 3 = float64.

#include <omp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <vector>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i32(const char* p, const char* end, int32_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = *p++ == '-';
  if (p >= end || *p < '0' || *p > '9') return nullptr;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = (int32_t)(neg ? -v : v);
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  *out = strtod(p, &q);
  if (q == p) return nullptr;
  return q;
}

}  // namespace

extern "C" {

int64_t gm_parse_text_edges(const char* buf, int64_t len, int32_t val_kind,
                            int32_t* src, int32_t* dst, void* val) {
  const int nthreads = omp_get_max_threads();
  // chunk boundaries aligned to line starts
  std::vector<int64_t> starts(nthreads + 1, len);
  starts[0] = 0;
  for (int t = 1; t < nthreads; ++t) {
    int64_t pos = len * t / nthreads;
    while (pos < len && buf[pos] != '\n') ++pos;
    starts[t] = std::min(pos + 1, len);
  }
  starts[nthreads] = len;

  // pass 1: count non-blank lines per chunk
  std::vector<int64_t> cnt(nthreads, 0);
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t c = 0;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* stop = nl ? nl : end;
      const char* q = skip_ws(p, stop);
      if (q < stop) ++c;
      p = nl ? nl + 1 : end;
    }
    cnt[t] = c;
  }
  std::vector<int64_t> off(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t) off[t + 1] = off[t] + cnt[t];

  // pass 2: parse
  std::atomic<bool> bad{false};
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t i = off[t];
    while (p < end && !bad.load(std::memory_order_relaxed)) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* stop = nl ? nl : end;
      const char* q = skip_ws(p, stop);
      if (q < stop) {
        q = parse_i32(q, stop, &src[i]);
        if (q) q = parse_i32(q, stop, &dst[i]);
        if (q && val_kind) {
          double d;
          q = parse_f64(q, stop, &d);
          if (q) {
            if (val_kind == 1) ((int32_t*)val)[i] = (int32_t)d;
            else if (val_kind == 2) ((float*)val)[i] = (float)d;
            else ((double*)val)[i] = d;
          }
        }
        if (!q) { bad.store(true, std::memory_order_relaxed); break; }
        ++i;
      }
      p = nl ? nl + 1 : end;
    }
  }
  return bad.load() ? -1 : off[nthreads];
}

}  // extern "C"
