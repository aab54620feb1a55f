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
// padded here to a multiple of 4 with zero words), and a last row of zeros
// (zero_row) for the vertices without one.
//   What bounds it on an H100: an edge whose two rows are both real reads
//   2 x 4W bytes (1 KB at h = 4096), one row of the two a random one, from
//   L2 or device memory; the index planes are streamed once (12 B an
//   edge).  The bound the repo reports counts the bitmap and the three
//   planes once each.  Measured (PERF.md, section 6), the chain of
//   dependent reads each edge waits on (its indices, its rows, its
//   atomic) bounds it more than its bytes.
//   The design: a group of G lanes an edge, G the power of two at or above
//   W/4 but at most 4 (8 edges a warp: more edges in flight; about 1.3x
//   as fast as a warp an edge at RMAT-22), each lane a 16-byte
//   quad of each row per step, __popc of the AND, a shuffle sum over the
//   group and one integer atomic per edge into pv (none when the count is
//   0).  An edge that touches the zero row counts 0 without a read.  The
//   grid walks the edges grid-stride, a few blocks per SM.
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
//   What bounds it: the latency of its reads.  Per probe it reads its four
//   probe words, then, per id of the narrower list, a binary search of the
//   wider one: log2(Dr) + 1 reads, each waiting on the one before, from L1
//   and L2 for the most part.  The bound the repo reports counts the probe
//   planes and the lists once each.
//   The design: a group of 4 lanes a probe (8 probes a warp), whose lanes
//   take the ids of the list of the narrower class in turn, stop at the
//   first pad (the list is sorted, so the rest is pad) and each look their
//   id up in the other list by binary search over its whole width (pads
//   sort last).  So a pair costs Ds/4 * log2(Dr) steps a lane, not Ds * Dr
//   compares, and a hub tail of 10^3 to 10^4 ids costs a group some
//   thousands of steps.  A shuffle sum over the group and one atomic per
//   probe follow.  The groups walk the probes grid-stride; the probes come
//   sorted by class pair, so neighbouring groups take probes of one shape.
//   Measured on the card (PERF.md, section 6): more lanes a probe are
//   slower (8, 16 and 32 lanes take 1.1, 1.35 and 1.8 times as long at
//   RMAT-22: fewer probes in flight), and so are a chunked merge of the two lists
//   and one that holds both in registers (the shuffles of their searches
//   bound them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
constexpr int kPad = 0x7fffffff;
constexpr int kMaxClasses = 32;
// T1's lanes an edge, at most, and T2's a probe (PERF.md, section 6)
constexpr int kCoreLanes = 4;
constexpr int kTailLanes = 4;

struct Ladder {
  int w[kMaxClasses];
};

template <int G>
__global__ void __launch_bounds__(kThreads)
core_count_kernel(const uint4* __restrict__ bm, int quads, int zero_row,
                  const int* __restrict__ iu, const int* __restrict__ iv,
                  const int* __restrict__ s, long long e,
                  int* __restrict__ pv) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : ((1u << (G & 31)) - 1u) << (lane & ~(G - 1));
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = static_cast<long long>(gridDim.x) * kThreads / G;
  for (long long k = tid / G; k < e; k += groups) {
    const int a = __ldg(iu + k);
    const int b = __ldg(iv + k);
    int c = 0;
    if (a != zero_row && b != zero_row) {
      const uint4* ra = bm + static_cast<long long>(a) * quads;
      const uint4* rb = bm + static_cast<long long>(b) * quads;
      for (int q = sub; q < quads; q += G) {
        const uint4 x = __ldg(ra + q);
        const uint4 y = __ldg(rb + q);
        c += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(mask, c, off);
    if (sub == 0 && c != 0) atomicAdd(pv + __ldg(s + k), c);
  }
}

__global__ void __launch_bounds__(kThreads)
tail_count_kernel(const int* __restrict__ mats, Ladder ladder, int ncls,
                  const int* __restrict__ gk, const int* __restrict__ fa,
                  const int* __restrict__ fb, const int* __restrict__ sp,
                  long long np, int* __restrict__ pv) {
  constexpr int G = kTailLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = static_cast<long long>(gridDim.x) * kThreads / G;
  for (long long p = tid / G; p < np; p += groups) {
    const int g = __ldg(gk + p);
    int da = ladder.w[g / ncls];
    int db = ladder.w[g % ncls];
    const int* a = mats + __ldg(fa + p);
    const int* b = mats + __ldg(fb + p);
    if (da > db) {   // walk the narrower class, search the wider
      const int* t = a;
      a = b;
      b = t;
      const int d = da;
      da = db;
      db = d;
    }
    int c = 0;
    for (int i = sub; i < da; i += G) {
      const int v = __ldg(a + i);
      if (v == kPad) break;   // sorted: the rest of the list is pad
      int lo = 0;
      int hi = db;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(b + mid) < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      c += (lo < db && __ldg(b + lo) == v) ? 1 : 0;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(mask, c, off);
    if (sub == 0 && c != 0) atomicAdd(pv + __ldg(sp + p), c);
  }
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
void launch_core(unsigned grid, cudaStream_t st, const void* bm, int quads,
                 int zero_row, const void* iu, const void* iv, const void* s,
                 long long e, void* pv) {
  core_count_kernel<G><<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(bm), quads, zero_row,
      static_cast<const int*>(iu), static_cast<const int*>(iv),
      static_cast<const int*>(s), e, static_cast<int*>(pv));
}

}  // namespace

// One launch of T1 over e edges.  bm: the bitmap as rows of `quads`
// 16-byte words (4 uint32 each), starting on a 16-byte boundary; row
// zero_row is all zeros.  iu, iv, s: int32[e]; pv: int32 counts, added
// to.  Returns a CUDA error code: cudaGetLastError() after the launch.
extern "C" int gm_tc_core_count(const void* bm, int quads, int zero_row,
                                const void* iu, const void* iv,
                                const void* s, long long e, void* pv,
                                void* stream) {
  if (e <= 0 || quads <= 0 || zero_row < 0 ||
      reinterpret_cast<uintptr_t>(bm) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  int g = 1;
  while (g < quads && g < kCoreLanes) g <<= 1;
  const unsigned grid = grid_for(e * g, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1:
      launch_core<1>(grid, st, bm, quads, zero_row, iu, iv, s, e, pv);
      break;
    case 2:
      launch_core<2>(grid, st, bm, quads, zero_row, iu, iv, s, e, pv);
      break;
    default:
      launch_core<kCoreLanes>(grid, st, bm, quads, zero_row, iu, iv, s, e,
                              pv);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of T2 over np probes.  mats: int32 tail lists, each sorted
// ascending and padded with INT32_MAX to its class width; ladder: ncls
// class widths (a host array, at most 32); gk, fa, fb, sp: int32[np];
// pv: int32 counts, added to.  Returns a CUDA error code.
extern "C" int gm_tc_tail_count(const void* mats, const int* ladder,
                                int ncls, const void* gk, const void* fa,
                                const void* fb, const void* sp, long long np,
                                void* pv, void* stream) {
  if (np <= 0 || ncls <= 0 || ncls > kMaxClasses || ladder == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Ladder lad = {};
  for (int i = 0; i < ncls; ++i) {
    if (ladder[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lad.w[i] = ladder[i];
  }
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const unsigned grid = grid_for(np * kTailLanes, sms);
  tail_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mats), lad, ncls, static_cast<const int*>(gk),
      static_cast<const int*>(fa), static_cast<const int*>(fb),
      static_cast<const int*>(sp), np, static_cast<int*>(pv));
  return static_cast<int>(cudaGetLastError());
}
