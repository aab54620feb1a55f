// TriangleCounting's host prep: dedup, degree ranks, orientation, the
// core bitmap and the tail lists, in one native pass.
//
// A copy of TcPrep, gm_tc_create, gm_tc_fill and gm_tc_destroy
// (graphmat_tpu/native/planner.cpp:2504-2679), which the port does not
// import; ops/triangles.py: _tc_prep_native calls it for
// count_triangles_bucketed(impl="host"), and its outputs equal the numpy
// prep's (_tc_prep_numpy) array for array.  One change from the copy: the
// first pass joins its per-thread blocks of keys in thread order, so the
// order of the keys, and with assume_canonical that of each sender's
// edges, does not depend on which thread finishes first.  Reference
// analog: the tile build and GetNeighbors prep
// (src/TriangleCounting.cpp:82-111).

#include <omp.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <parallel/algorithm>
#include <vector>

namespace {

struct TcPrep {
  int64_t m = 0;    // oriented deduped edge count
  int64_t m2 = 0;   // tail-receiver edges (part-2 list entries)
  int32_t n = 0, h = 0, W = 0, ncr = 0, core_lo = 0;
  std::vector<int32_t> s, r;          // [m] grouped by sender
  std::vector<int64_t> off;           // [n+1] sender CSR offsets
  std::vector<int64_t> t2off;         // [n+1] tail-list offsets
  std::vector<int32_t> odeg, t_of, crow, rank_of;
};

}  // namespace

extern "C" {

// Phase 1.  assume_canonical != 0 promises the caller already passes
// unique undirected pairs with u < v (no self loops required — they are
// still dropped); the dedup sort is skipped entirely.
void* gm_tc_create(const int32_t* u, const int32_t* v, int64_t e,
                   int32_t n, int32_t h, int32_t assume_canonical,
                   int64_t* m_out, int64_t* m2_out, int32_t* ncr_out) {
  auto* p = new TcPrep();
  p->n = n;
  const int64_t N = n;
  // the keys in input order: thread t takes the t-th block of the input
  // (a static schedule) and the blocks are joined in thread order, so
  // with assume_canonical the order within a sender is the input's, as
  // in the numpy prep (the JAX copy joins the blocks as threads finish)
  std::vector<int64_t> key;
  {
    const int nt = omp_get_max_threads();
    std::vector<std::vector<int64_t>> parts(nt);
#pragma omp parallel num_threads(nt)
    {
      std::vector<int64_t>& local = parts[omp_get_thread_num()];
      local.reserve(e / nt + 1);
#pragma omp for schedule(static)
      for (int64_t i = 0; i < e; ++i) {
        if (u[i] == v[i]) continue;
        const int64_t a = std::min(u[i], v[i]);
        const int64_t b = std::max(u[i], v[i]);
        local.push_back(a * N + b);
      }
    }
    size_t total = 0;
    for (const auto& part : parts) total += part.size();
    key.reserve(total);
    for (const auto& part : parts)
      key.insert(key.end(), part.begin(), part.end());
  }
  if (!assume_canonical) {
    __gnu_parallel::sort(key.begin(), key.end());
    key.erase(std::unique(key.begin(), key.end()), key.end());
  }
  const int64_t m = (int64_t)key.size();
  p->m = m;

  // degrees over the deduped undirected support
  std::vector<int32_t> deg(n, 0);
  for (int64_t i = 0; i < m; ++i) {
    ++deg[key[i] / N];
    ++deg[key[i] % N];
  }

  // degree ranks: rank_of[vtx] = position in (deg, id) ascending order
  p->rank_of.resize(n);
  {
    std::vector<int32_t> ord(n);
    for (int32_t i = 0; i < n; ++i) ord[i] = i;
    __gnu_parallel::sort(ord.begin(), ord.end(),
                         [&](int32_t a, int32_t b) {
                           return deg[a] < deg[b]
                                  || (deg[a] == deg[b] && a < b);
                         });
    for (int32_t i = 0; i < n; ++i) p->rank_of[ord[i]] = i;
  }

  // orient toward the (deg, id)-larger endpoint; histogram by sender
  p->odeg.assign(n, 0);
  p->s.resize(m);
  p->r.resize(m);
#pragma omp parallel
  {
    std::vector<int32_t> part(n, 0);
#pragma omp for
    for (int64_t i = 0; i < m; ++i) {
      const int32_t a = (int32_t)(key[i] / N);
      const int32_t b = (int32_t)(key[i] % N);
      const bool fwd = p->rank_of[a] < p->rank_of[b];
      p->s[i] = fwd ? a : b;   // temporarily unsorted
      p->r[i] = fwd ? b : a;
      ++part[p->s[i]];
    }
#pragma omp critical
    for (int32_t x = 0; x < n; ++x) p->odeg[x] += part[x];
  }

  // counting sort by sender (receiver order within a sender is free)
  p->off.assign(n + 1, 0);
  for (int32_t x = 0; x < n; ++x) p->off[x + 1] = p->off[x] + p->odeg[x];
  {
    std::vector<int32_t> ss(m), rr(m);
    std::vector<int64_t> cur(p->off.begin(), p->off.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      const int64_t at = cur[p->s[i]]++;
      ss[at] = p->s[i];
      rr[at] = p->r[i];
    }
    p->s.swap(ss);
    p->r.swap(rr);
  }

  // core split
  p->h = std::min<int32_t>(h, n);
  p->core_lo = n - p->h;
  p->W = (p->h + 31) / 32;
  p->t_of.assign(n, 0);
  std::atomic<int64_t> m2{0};
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t x = 0; x < n; ++x) {
    int32_t t = 0;
    for (int64_t i = p->off[x]; i < p->off[x + 1]; ++i)
      if (p->rank_of[p->r[i]] < p->core_lo) ++t;
    p->t_of[x] = t;
    if (t) m2.fetch_add(t);
  }
  p->m2 = m2.load();
  p->t2off.assign(n + 1, 0);
  for (int32_t x = 0; x < n; ++x)
    p->t2off[x + 1] = p->t2off[x] + p->t_of[x];

  // compressed bitmap rows: only senders with >= 1 core out-neighbor
  p->crow.assign(n, -1);
  int32_t ncr = 0;
  for (int32_t x = 0; x < n; ++x)
    if (p->odeg[x] - p->t_of[x] > 0) p->crow[x] = ncr++;
  p->ncr = ncr;

  *m_out = p->m;
  *m2_out = p->m2;
  *ncr_out = ncr;
  return p;
}

// Phase 2.  Caller allocates:
//   s_all, r_all, iu_row, iv_row : int32 [m]
//   bitmap                       : uint32 [(ncr+1) * W], ZERO-initialized
//   s2, r2, t2rank               : int32 [m2]
//   t_of_out, odeg_out           : int32 [n]
void gm_tc_fill(void* handle, int32_t* s_all, int32_t* r_all,
                int32_t* iu_row, int32_t* iv_row, uint32_t* bitmap,
                int32_t* s2, int32_t* r2, int32_t* t2rank,
                int32_t* t_of_out, int32_t* odeg_out) {
  auto* p = static_cast<TcPrep*>(handle);
  const int32_t n = p->n, W = p->W, ncr = p->ncr, core_lo = p->core_lo;
#pragma omp parallel for schedule(dynamic, 2048)
  for (int32_t x = 0; x < n; ++x) {
    const int32_t cu = p->crow[x] < 0 ? ncr : p->crow[x];
    int32_t trk = 0;
    int64_t t2 = p->t2off[x];
    for (int64_t i = p->off[x]; i < p->off[x + 1]; ++i) {
      const int32_t rv = p->r[i];
      const int32_t rk = p->rank_of[rv];
      s_all[i] = x;
      r_all[i] = rv;
      iu_row[i] = cu;
      iv_row[i] = p->crow[rv] < 0 ? ncr : p->crow[rv];
      if (rk >= core_lo) {
        const int32_t bit = rk - core_lo;
        bitmap[(int64_t)p->crow[x] * W + (bit >> 5)] |= 1u << (bit & 31);
      } else {
        s2[t2] = x;
        r2[t2] = rv;
        t2rank[t2] = trk++;
        ++t2;
      }
    }
  }
  memcpy(t_of_out, p->t_of.data(), (size_t)n * sizeof(int32_t));
  memcpy(odeg_out, p->odeg.data(), (size_t)n * sizeof(int32_t));
}

void gm_tc_destroy(void* handle) { delete static_cast<TcPrep*>(handle); }
}  // extern "C"
