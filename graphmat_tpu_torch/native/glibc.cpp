// The reference converter's seeded vertex-id permutation, in C.
//
// A copy of gm_glibc_square_mapping (graphmat_tpu/native/planner.cpp:
// 2429-2463), which the port does not import.  GraphMat's
// randomize_edgelist_square (edgelist.h:337-366) calls srand(seed), draws
// rval[i] = rand() % m for every vertex, then swaps mapping[i] and
// mapping[rval[i]] in order.  rand() here is glibc's TYPE_3 generator
// replicated bit for bit: a 31-word ring seeded by a Park-Miller LCG
// (Schrage's method), 310 warm-up outputs discarded, then
// out = (r[f] += r[p]) >> 1.  The numpy form
// (utils/reference_rng.py: glibc_square_mapping_np) is a Python loop over
// the vertices, too slow at 2^20 vertices and more; this one takes
// milliseconds there.

#include <stdint.h>

#include <vector>

extern "C" {

void gm_glibc_square_mapping(int64_t m, uint32_t seed, int32_t* mapping) {
  uint32_t r[31];
  long long word = (seed == 0) ? 1 : (long long)seed;
  r[0] = (uint32_t)word;
  for (int i = 1; i < 31; ++i) {
    long long hi = word / 127773, lo = word % 127773;
    word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (uint32_t)word;
  }
  int f = 3, p = 0;
  for (int i = 0; i < 310; ++i) {
    r[f] += r[p];
    if (++f == 31) f = 0;
    if (++p == 31) p = 0;
  }
  std::vector<int64_t> rval(m);
  for (int64_t i = 0; i < m; ++i) {
    r[f] += r[p];
    rval[i] = (int64_t)((r[f] >> 1) % (uint32_t)m);
    if (++f == 31) f = 0;
    if (++p == 31) p = 0;
  }
  for (int64_t i = 0; i < m; ++i) mapping[i] = (int32_t)i;
  for (int64_t i = 0; i < m; ++i) {
    int64_t j = rval[i];
    int32_t tmp = mapping[i];
    mapping[i] = mapping[j];
    mapping[j] = tmp;
  }
}

}  // extern "C"
