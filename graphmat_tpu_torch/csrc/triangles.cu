// T1 and T2: the two hot loops of the core-bitmap triangle count on Hopper.
//
// They replace no Pallas kernel: the JAX package runs both as XLA ops, T1
// as the part-1 scan of graphmat_tpu/ops/triangles.py:_tc_count (p1,
// 439-446; host route _count_device, 252-261), T2 as its part-2 scan
// (body, 483-503; host route 266-281).  PyTorch has no popcount, and T2
// written in PyTorch would materialise [B, Ds, Dr] boolean slabs, so both
// are written here.  Both work on integers and are exact.
//
// T1, the core count.  For each oriented edge e,
//     c[e] = sum_w popc(bm[iu[e], w] & bm[iv[e], w]),   pv[s[e]] += c[e],
// where bm is the core bitmap: one row per vertex with a core
// out-neighbour, a bit per core rank (W = ceil(min(h, n) / 32) words,
// padded to W4, a multiple of 4, with zero words), and a last row of zeros
// (zero_row) for the vertices without one.  Beside it, sm holds a
// summary row per bitmap row, a bit per word (ceil(W4 / 32) words: 16
// bytes at h = 4096), set where the word is not 0; the kernel sums over
// the words set in both summaries, which is the same sum.
//   What bounds it on an H100: the sender's row.  The edges come grouped
//   by receiver (half share the previous edge's), and 25,000 receiver rows
//   take 74% of the edges at RMAT-22, so the receiver's row is mostly in
//   L1 or L2; the sender's is a random one of 1.7M rows (865 MB), from
//   device memory.  Reading both rows whole cost 1 KB an edge and 13.9 ms
//   at RMAT-22 (the first design: 16-byte quads of both rows).  At h = 4096
//   an edge's two rows share 26.5 nonzero words of 128, in 7.0 of the
//   sender row's 16 sectors of 32 bytes (PERF.md, section 6).
//   The design: a group of 2 lanes an edge (16 edges a warp; 4 lanes
//   were 3-10% slower at RMAT-20 and within 3% at RMAT-22); each lane
//   takes summary words of both rows (L2-resident: 27 MB at RMAT-22),
//   ANDs them and reads only the words whose bits are set, 4 words of
//   each row a step with their 8 loads issued together, __popc of their
//   AND.  A shuffle sum over the group and one integer atomic per edge
//   into pv (none when the count is 0) follow.  An edge that touches the
//   zero row counts 0 without a read.  The grid walks the edges
//   grid-stride, a few blocks per SM.
//
// T2, the tail count.  For each probe edge p,
//     c[p] = |{i : A[i] != PAD, A[i] in B}|,   pv[sp[p]] += c[p],
// with A = mats[fa[p] .. fa[p] + Ds) and B = mats[fb[p] .. fb[p] + Dr):
// the tail lists (out-neighbours below the core) of the edge's two ends,
// each padded with PAD = INT32_MAX to the width of its class of the
// ladder (the class pair is gk[p] = cs * ncls + cr, widths ladder[cs] and
// ladder[cr]).  The lists are duplicate-free.  The prep sorts each list
// ascending (ops/triangles.py builds them by a sort on (row, id)), where
// the JAX package leaves a list as two ascending runs and compares all
// pairs; this kernel takes sorted lists only, and its plain version,
// which compares all pairs, any lists.
//   What bounds it on an H100: the loads of its searches.  Each id of the
//   narrower list looks itself up in the wider one, log2(width) reads that
//   wait on each other, scattered over the lists of the warp's probes;
//   the lists (236 MB at RMAT-22) come from device memory and L2.  At
//   RMAT-22 lists of class 256 carry most of the work: the pair (256,
//   256) took 5.3 of the first design's 19.9 ms (PERF.md, section 6).
//   The design: 128-thread blocks, at most 48 registers a thread, as many
//   blocks as the SMs hold.  The lane count a probe follows its class
//   pair: the preps list the narrow pairs' probes (a list narrower than
//   wide_from, 64) before the wide pairs' (ops/triangles.py:
//   _tail_order); each warp
//   finds the first wide probe by a 32-way search of gk (a load a lane,
//   6 rounds at RMAT-22), then groups of 4 lanes walk the narrow probes
//   grid-stride, one probe a group (a narrow list's ids fill 4 lanes, and
//   twice the probes are in flight), and groups of 8 lanes the wide ones.
//   The split only chooses the lanes: probes in another order are counted
//   all the same.  When the wider list has at most 256 ids (128 in a
//   4-lane group) and at most 4 times the narrower class's, the group
//   copies it into its own row of shared memory with 16-byte loads, all
//   issued at once (rows 260 or 132 ints apart, so that the groups of a
//   warp, reading like places of their lists, fall on other banks); other
//   probes search the wider list where it lies.  The lanes take the
//   narrower list's ids in turn, up to its first pad, 4 at a time, and
//   look each up by a branchless bisection of the wider list's whole
//   width (pads sort last): every search over one width takes the same
//   steps, so a lane's 4 searches run in step and issue their reads
//   together.  A shuffle sum over the group and one atomic per probe
//   follow.  Measured on the card (PERF.md, section 6): 8 lanes a probe
//   for every pair lost to the first design's 4 lanes on the narrow
//   pairs of RMAT-20, and 4 lost on the wide pairs of RMAT-22; a warp
//   running 8 probes as one tile, skipping the loads of a pad's search,
//   staging every list through a warp, merging the two lists (element by
//   element or in 16-byte blocks), galloping from the last bound and 64
//   or more registers a thread were slower; rows at a stride of 256 ints
//   put the groups of a warp on one bank and took twice the first
//   design's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
constexpr int kPad = 0x7fffffff;
constexpr int kMaxClasses = 32;
// T1: lanes an edge (at most), words a lane reads in one step
constexpr int kCoreLanes = 2;
constexpr int kCoreStep = 4;
// T2: lanes a probe on a narrow pair and on a wide one (a pair is wide
// when both its widths are at least the caller's wide_from, by which the
// preps order the probes), searches a lane runs at once,
// the widest list a group stages in shared memory in each mode and how
// much wider than the narrower class it may be, threads a block and
// blocks an SM (at most 48 registers a thread)
constexpr int kTailWideLanes = 8;
constexpr int kTailNarrowLanes = 4;
constexpr int kTailIds = 4;
constexpr int kTailCap = 256;
constexpr int kTailNarrowCap = 128;
constexpr int kTailStageRatio = 4;
constexpr int kTailThreads = 128;
constexpr int kTailMinBlocks = 10;
// a group's staged list at a stride of its cap + 4 ints (16-byte rows),
// so that the groups of a warp, reading like places of their lists, hit
// other banks; a warp's share holds either mode's rows
constexpr int kTailWideRow = kTailCap + 4;
constexpr int kTailNarrowRow = kTailNarrowCap + 4;
constexpr int kTailWarpInts =
    (32 / kTailWideLanes) * kTailWideRow >
            (32 / kTailNarrowLanes) * kTailNarrowRow
        ? (32 / kTailWideLanes) * kTailWideRow
        : (32 / kTailNarrowLanes) * kTailNarrowRow;

struct Ladder {
  int w[kMaxClasses];
  int wide_from;   // T2: a pair of two classes this wide or wider is wide
};

// popc(x[j] & y[j]) over the words j of `m`'s set bits, kCoreStep words a
// step, their 2 * kCoreStep loads issued before any is used (a word past
// the last set bit repeats the step's first, an L1 hit, and counts 0)
__device__ __forceinline__ int count_words(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ y,
                                           uint32_t m) {
  int c = 0;
  while (m) {
    int j[kCoreStep];
    uint32_t keep[kCoreStep];
#pragma unroll
    for (int t = 0; t < kCoreStep; ++t) {
      keep[t] = m != 0 ? 0xffffffffu : 0u;
      j[t] = m != 0 ? __ffs(m) - 1 : j[0];
      m &= m - 1;
    }
    uint32_t xs[kCoreStep], ys[kCoreStep];
#pragma unroll
    for (int t = 0; t < kCoreStep; ++t) {
      xs[t] = __ldg(x + j[t]);
      ys[t] = __ldg(y + j[t]);
    }
#pragma unroll
    for (int t = 0; t < kCoreStep; ++t) c += __popc(xs[t] & ys[t] & keep[t]);
  }
  return c;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
core_count_kernel(const uint32_t* __restrict__ bm, int w4,
                  const uint32_t* __restrict__ sm, int sw, int zero_row,
                  const int* __restrict__ iu, const int* __restrict__ iv,
                  const int* __restrict__ s, long long e,
                  int* __restrict__ pv) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = static_cast<long long>(gridDim.x) * kThreads / G;
  for (long long k = tid / G; k < e; k += groups) {
    const int a = __ldg(iu + k);
    const int b = __ldg(iv + k);
    int c = 0;
    if (a != zero_row && b != zero_row) {
      const uint32_t* ra = bm + static_cast<long long>(a) * w4;
      const uint32_t* rb = bm + static_cast<long long>(b) * w4;
      const uint32_t* sa = sm + static_cast<long long>(a) * sw;
      const uint32_t* sb = sm + static_cast<long long>(b) * sw;
      for (int q = sub; q < sw; q += G) {
        uint32_t m = __ldg(sa + q) & __ldg(sb + q);
        const int left = w4 - 32 * q;   // the row's words from 32q on
        if (left < 32) m &= (1u << left) - 1u;
        c += count_words(ra + 32 * q, rb + 32 * q, m);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(mask, c, off);
    if (sub == 0 && c != 0) atomicAdd(pv + __ldg(s + k), c);
  }
}

struct GlobalList {
  const int* p;
  __device__ int operator()(int i) const { return __ldg(p + i); }
};

struct SharedList {
  const int* p;
  __device__ int operator()(int i) const { return p[i]; }
};

// How many ids of the sorted, padded list a (width da) lie in the sorted,
// padded list b (width db), counted by lane `sub` of G: the lane takes
// a's ids sub, sub + G, ... up to the first pad, kTailIds of them at a
// time, and looks each up in b by a branchless bisection of b's whole
// width (pads sort last).  Every bisection over db entries takes the same
// steps, so the lane's searches run in step and issue their reads
// together.  A search ends at a place p with v in b exactly when v is
// b[p] or b[p + 1].
template <int G, typename List>
__device__ __forceinline__ int count_in(const int* __restrict__ a, int da,
                                        List b, int db, int sub) {
  constexpr int U = kTailIds;
  int c = 0;
  for (int i0 = sub; i0 < da; i0 += G * U) {
    int v[U];
    int p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + G * u;
      v[u] = i < da ? __ldg(a + i) : kPad;
      p[u] = 0;
    }
    if (v[0] == kPad) break;   // sorted: the rest of the list is pad
    for (int n = db; n > 1;) {
      const int half = n >> 1;
      int x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = b(p[u] + half);
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = x[u] < v[u] ? p[u] + half : p[u];
      n -= half;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x0 = b(p[u]);
      const int x1 = p[u] + 1 < db ? b(p[u] + 1) : kPad;
      c += v[u] != kPad && (x0 == v[u] || x1 == v[u]);
    }
    if (v[U - 1] == kPad) break;
  }
  return c;
}

// One probe's count by the G lanes of its group (lane `sub`, the group's
// lanes `mask`): the narrower list's ids searched in the wider list,
// which the group first copies into its row `buf` of shared memory with
// 16-byte loads when it has at most Cap ids and at most kTailStageRatio
// times the narrower class's (so that the copy pays), summed over the
// group.
template <int G, int Cap>
__device__ __forceinline__ int tail_probe(const int* __restrict__ a, int da,
                                          const int* __restrict__ b, int db,
                                          int* buf, int sub, unsigned mask) {
  if (da > db) {   // walk the narrower class, search the wider
    const int* t = a;
    a = b;
    b = t;
    const int d = da;
    da = db;
    db = d;
  }
  int c;
  if (db <= Cap && db <= kTailStageRatio * da) {
    __syncwarp(mask);   // every lane is done with the last probe's list
    if ((db & 3) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0) {
      for (int i = sub; i < db / 4; i += G)
        reinterpret_cast<int4*>(buf)[i] =
            __ldg(reinterpret_cast<const int4*>(b) + i);
    } else {
      for (int i = sub; i < db; i += G) buf[i] = __ldg(b + i);
    }
    __syncwarp(mask);
    c = count_in<G>(a, da, SharedList{buf}, db, sub);
  } else {
    c = count_in<G>(a, da, GlobalList{b}, db, sub);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    c += __shfl_xor_sync(mask, c, off);
  return c;
}

__device__ __forceinline__ bool wide_pair(const Ladder& ladder, int ncls,
                                          int g) {
  return ladder.w[g / ncls] >= ladder.wide_from &&
         ladder.w[g % ncls] >= ladder.wide_from;
}

// The first probe of a wide pair, found by the whole warp (a 32-way
// search, a load a lane a round), where the probes come with the narrow
// pairs first, as the prep orders them; in any other order it is some
// place in [0, np], and the probes on either side of it are counted all
// the same.
__device__ long long first_wide(const int* __restrict__ gk, long long np,
                                const Ladder& ladder, int ncls, int lane) {
  long long lo = 0, hi = np;   // the probes below lo are narrow; hi is np
                               // or a wide probe
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long x = lo + step * lane;
    const bool w = x >= hi || wide_pair(ladder, ncls, __ldg(gk + x));
    const unsigned b = __ballot_sync(0xffffffffu, w);
    if (b == 0) {
      lo += 31 * step + 1;
    } else {
      const int i = __ffs(b) - 1;
      if (i == 0) {
        hi = lo;
      } else {
        const long long x1 = lo + step * i;
        lo += step * (i - 1) + 1;
        hi = x1 < hi ? x1 : hi;
      }
    }
  }
  return lo;
}

// The probes of [lo, hi) counted by the kernel's groups of G lanes, the
// groups walking them grid-stride.
template <int G, int Cap, int Row>
__device__ __forceinline__ void tail_span(
    const int* __restrict__ mats, const Ladder& ladder, int ncls,
    const int* __restrict__ gk, const int* __restrict__ fa,
    const int* __restrict__ fb, const int* __restrict__ sp, long long lo,
    long long hi, int* share, int* __restrict__ pv) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  int* buf = share + (lane / G) * Row;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kTailThreads + threadIdx.x;
  const long long groups =
      static_cast<long long>(gridDim.x) * kTailThreads / G;
  for (long long p = lo + tid / G; p < hi; p += groups) {
    const int g = __ldg(gk + p);
    const int c = tail_probe<G, Cap>(mats + __ldg(fa + p),
                                     ladder.w[g / ncls],
                                     mats + __ldg(fb + p),
                                     ladder.w[g % ncls], buf, sub, mask);
    if (sub == 0 && c != 0) atomicAdd(pv + __ldg(sp + p), c);
  }
}

__global__ void __launch_bounds__(kTailThreads, kTailMinBlocks)
tail_count_kernel(const int* __restrict__ mats, Ladder ladder, int ncls,
                  const int* __restrict__ gk, const int* __restrict__ fa,
                  const int* __restrict__ fb, const int* __restrict__ sp,
                  long long np, int* __restrict__ pv) {
  __shared__ __align__(16) int stage[kTailThreads / 32][kTailWarpInts];
  int* share = stage[threadIdx.x >> 5];
  const long long split = first_wide(gk, np, ladder, ncls, threadIdx.x & 31);
  // the narrow pairs' probes by groups of 4 lanes, then the wide pairs'
  // by groups of 8; the warp's rows of the two differ, hence the sync
  tail_span<kTailNarrowLanes, kTailNarrowCap, kTailNarrowRow>(
      mats, ladder, ncls, gk, fa, fb, sp, 0, split, share, pv);
  __syncwarp();
  tail_span<kTailWideLanes, kTailCap, kTailWideRow>(
      mats, ladder, ncls, gk, fa, fb, sp, split, np, share, pv);
}

// The current device's SM count, read once per device.
int sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) cached[dev] = *sms;
  return 0;
}

unsigned grid_for(long long threads, int sms) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <int G>
void launch_core(unsigned grid, cudaStream_t st, const void* bm, int w4,
                 const void* sm, int sw, int zero_row, const void* iu,
                 const void* iv, const void* s, long long e, void* pv) {
  core_count_kernel<G><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(bm), w4, static_cast<const uint32_t*>(sm),
      sw, zero_row, static_cast<const int*>(iu), static_cast<const int*>(iv),
      static_cast<const int*>(s), e, static_cast<int*>(pv));
}

}  // namespace

// One launch of T1 over e edges.  bm: the bitmap, rows of w4 uint32
// words; sm: its summaries, rows of sw = ceil(w4 / 32) uint32 words, bit
// j of a row set where word j of its bitmap row is not 0; row zero_row of
// both is all zeros.  iu, iv, s: int32[e]; pv: int32 counts, added to.
// Returns a CUDA error code: cudaGetLastError() after the launch.
extern "C" int gm_tc_core_count(const void* bm, int w4, const void* sm,
                                int sw, int zero_row, const void* iu,
                                const void* iv, const void* s, long long e,
                                void* pv, void* stream) {
  if (e <= 0 || w4 <= 0 || sw != (w4 + 31) / 32 || zero_row < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  // a lane a summary word, up to kCoreLanes lanes an edge
  const int g = sw < kCoreLanes ? 1 : kCoreLanes;
  const unsigned grid = grid_for(e * g, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g == 1)
    launch_core<1>(grid, st, bm, w4, sm, sw, zero_row, iu, iv, s, e, pv);
  else
    launch_core<kCoreLanes>(grid, st, bm, w4, sm, sw, zero_row, iu, iv, s, e,
                            pv);
  return static_cast<int>(cudaGetLastError());
}

// One launch of T2 over np probes.  mats: int32 tail lists, each sorted
// ascending and padded with INT32_MAX to its class width; ladder: ncls
// class widths (a host array, at most 32); wide_from: the probes of the
// pairs whose two widths are both at least this take 8 lanes, the others
// 4, and should come after the others; gk, fa, fb, sp: int32[np]; pv:
// int32 counts, added to.  Returns a CUDA error code.
extern "C" int gm_tc_tail_count(const void* mats, const int* ladder,
                                int ncls, int wide_from, const void* gk,
                                const void* fa, const void* fb,
                                const void* sp, long long np, void* pv,
                                void* stream) {
  if (np <= 0 || ncls <= 0 || ncls > kMaxClasses || ladder == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Ladder lad = {};
  lad.wide_from = wide_from;
  for (int i = 0; i < ncls; ++i) {
    if (ladder[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lad.w[i] = ladder[i];
  }
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  // as many blocks as the SMs hold at once (shared memory bounds it), so
  // that none waits for another to finish its share of the probes
  static int resident[kMaxDevices] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  int per_sm = dev < kMaxDevices ? resident[dev] : 0;
  if (per_sm <= 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tail_count_kernel, kTailThreads, 0));
    if (err != 0) return err;
    if (per_sm < 1) per_sm = 1;
    if (dev < kMaxDevices) resident[dev] = per_sm;
  }
  long long blocks =
      (np * kTailWideLanes + kTailThreads - 1) / kTailThreads;
  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;
  tail_count_kernel<<<static_cast<unsigned>(blocks), kTailThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mats), lad, ncls, static_cast<const int*>(gk),
      static_cast<const int*>(fa), static_cast<const int*>(fb),
      static_cast<const int*>(sp), np, static_cast<int*>(pv));
  return static_cast<int>(cudaGetLastError());
}
