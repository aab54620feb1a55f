// K6 and K7 on Hopper: the frontier push SpMV
//     y[r] = (+)_{s->r, sent[s]} process(x[s], val_e)
//
// Replaces the TPU kernels graphmat_tpu/ops/pallas_spmv2.py:_make_kernel
// (K6, the v2r sum kernel, driven by _spmv2_call and spmv2) and
// _make_kernel_mm (K7, the v2m min/max kernel, driven by _spmv2m_call and
// spmv2m), which the JAX Engine runs under GRAPHMAT_KERNEL=v2.  It computes
// their function, not their layout: no 128-lane routed slots, colouring,
// window classes, bf16 split planes or VMEM plans.  What K6/K7 add over K1
// is the frontier-driven skip over sender chunks (_chunk_activity,
// pallas_spmv2.py:604, applied at 1296-1303): a chunk whose senders are
// all inactive is never fetched.  On Hopper that is a push over the active
// senders' out-edges, read from the sender-major index of the direction
// (rowptr over senders, col = receiver of each edge, val), so the work of
// a level is the frontier's out-edges, not the whole edge set.
//
//   (+) in {sum, min, max}, identities 0, +inf, -inf (true infinities:
//       the JAX kernel path clamps to +-1e30 instead).  The wrapper fills
//       y with the identity (and got with 0) before the launch.
//   (x) in {x, x*val, x+val, key+val}: K1's closed set (csrc/spmv2u.cu).
//   dense:      every sender pushes (PageRank under GRAPHMAT_KERNEL=v2).
//   sparse:     only senders with sent[s] != 0 push.
//   sparse got: sum only; also an int32 count per receiver of the edges
//               from senders that sent (the JAX kernel rides that bit in
//               x's low mantissa bit instead).
//
// What bounds it on an H100: per pushed edge it streams col (4 B) and val
// (4 B, when (x) reads it) and makes one atomic to y (and one to got) in
// L2; per sender it reads sent (1 B), and per active sender rowptr and x.
// At RMAT-22 y is 16 MB and sits in the 50 MB L2, so a dense push is
// bound by L2 atomic throughput, a sparse level by its frontier's edges.
//
// The design: work goes to warps by edges, not by senders.  A chunk is at
// most C = 1024 consecutive edges of one tile of 32 consecutive senders:
// chunk k of tile t covers edges [lo + k*C, lo + (k+1)*C) of the tile's
// range [lo, hi).  Warp t takes chunk 0 of tile t; the plan
// (ops/spmv2.py: push_plan, built once per index) lists the further
// chunks of the tiles that hold more than C edges, one warp each after
// the tiles'.  So no warp handles more than C edges or 32 senders
// whatever the degrees or the permutation: a hub sender's out-edges
// spread over ceil(degree / C) + 1 warps at most, where before one warp
// walked the 32 largest senders' edges (tile 0 of a degree-permuted
// graph) alone.  C is 32 steps of the warp's 32 lanes: enough edges to
// pay for the chunk's fixed cost (its sent, rowptr and x loads and a
// scan), few enough that an RMAT-22 dense push gives some 170,000 warps,
// 20 for each warp slot of the 132 SMs.  A sparse level costs a warp per
// tile that reads 32 sent bytes, as the one-warp-per-tile kernel did.
//
// In a warp, lane l holds sender 32t + l: its sent byte (one coalesced
// load; __ballot_sync of it skips a chunk with no active sender, the
// Hopper form of the chunk skip), then, if active, its edge range clipped
// to the chunk, its length and x.  An inclusive shuffle scan of the
// lengths gives the chunk's active edges as one range [0, T); the lanes
// take 32 of them at a time, each finding its sender by a 5-step binary
// search over the scan (shuffles, no memory) and its edge as that
// sender's start plus the offset.  So every lane carries an edge on every
// step whatever the degrees, and consecutive lanes read consecutive col.
// Each edge (+)-combines into y[r] with an atomic:
//   sum: atomicAdd on float (and on int for got);
//   min/max: the ordered-integer trick.  A non-negative float orders as
//     its int32 bits and a negative one inversely as its uint32 bits, so
//     min is atomicMin on the int bits of a value with the sign bit clear
//     and atomicMax on the unsigned bits of one with it set (max the
//     mirror).  +-inf are ordinary patterns there.  -0.0 orders below
//     +0.0, where fminf treats them as equal; the apps' payloads (vertex
//     ids, labels, distances, packed keys) are integers or keys and never
//     produce -0.0.  A read of y first skips the atomic when it cannot
//     improve y (y only moves one way, so a stale read is safe); that
//     also drops NaN contributions, as fminf/fmaxf in K1 do.
// Min and max are order-free, so they equal K1 and the plain version
// exactly.  A sum by atomics has no fixed order: float sums differ from
// run to run in the last bits (ROADMAP H1); integer payloads below 2^24
// and the got counts are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };
enum Process { kX = 0, kXMulVal = 1, kXAddVal = 2, kKeyAddVal = 3 };
enum Mode { kDense = 0, kSparse = 1, kSparseGot = 2 };

constexpr int kWarpsPerBlock = 8;
constexpr int kChunkEdges = 1024;   // C; ops/spmv2.py: CHUNK_EDGES
constexpr int kKeyBias = 0x20000000;
constexpr int kKeySpan = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__device__ __forceinline__ float process(float x, float v, int bits) {
  if (P == kX) return x;
  if (P == kXMulVal) return x * v;
  if (P == kXAddVal) return x + v;
  int u = __float_as_int(x);
  if (u >= kKeyBias && u < kKeyBias + kKeySpan) {
    const unsigned w = static_cast<unsigned>(static_cast<int>(v) - 1);
    u = static_cast<int>(static_cast<unsigned>(u) + (w << bits));
  }
  return __int_as_float(u);
}

template <int R>
__device__ __forceinline__ void combine_atomic(float* y, float u) {
  if (R == kSum) {
    atomicAdd(y, u);
    return;
  }
  const float cur = *reinterpret_cast<volatile float*>(y);
  if (R == kMin) {
    if (!(u < cur)) return;
    if (__float_as_int(u) >= 0)
      atomicMin(reinterpret_cast<int*>(y), __float_as_int(u));
    else
      atomicMax(reinterpret_cast<unsigned*>(y), __float_as_uint(u));
  } else {
    if (!(u > cur)) return;
    if (__float_as_int(u) >= 0)
      atomicMax(reinterpret_cast<int*>(y), __float_as_int(u));
    else
      atomicMin(reinterpret_cast<unsigned*>(y), __float_as_uint(u));
  }
}

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const float* x;
  const uint8_t* sent;
  const int* extra_tile;
  const int* extra_k;
  float* y;
  int* got;
  int n_tiles;
  int n_extra;
  int n_send;
  int bits;
};

template <int R, int P, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
push_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= a.n_tiles + a.n_extra) return;   // the whole warp
  int t = w, k = 0;
  if (w >= a.n_tiles) {
    t = __ldg(a.extra_tile + (w - a.n_tiles));
    k = __ldg(a.extra_k + (w - a.n_tiles));
  }
  const int s = (t << 5) + lane;
  bool act = s < a.n_send;
  if (M != kDense && act) act = __ldg(a.sent + s) != 0;
  if (__ballot_sync(kFull, act) == 0) return;
  int lo = 0, hi = 0;
  if (s < a.n_send) {
    lo = __ldg(a.rowptr + s);
    hi = __ldg(a.rowptr + s + 1);
  }
  // the chunk's edges; the wrapper keeps e_hi below 2^31
  const int e_lo = __shfl_sync(kFull, lo, 0) + k * kChunkEdges;
  const int e_hi = e_lo + kChunkEdges;
  int start = 0, len = 0;
  float xs = 0.0f;
  if (act) {
    start = max(lo, e_lo);
    len = max(min(hi, e_hi) - start, 0);
    if (len > 0) xs = __ldg(a.x + s);
  }
  int incl = len;   // inclusive scan of the lanes' edge counts
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  // edge t of the chunk's active range, held by lane j, is first_j + t
  const int first = start - (incl - len);
  for (int base = 0; base < total; base += 32) {
    const int t = base + lane;
    // j = the number of lanes whose scan is <= t: the lane holding edge t
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, incl, j + step - 1) <= t) j += step;
    }
    const int e = __shfl_sync(kFull, first, j) + t;
    const float xj = __shfl_sync(kFull, xs, j);
    if (t < total) {
      const int r = __ldg(a.col + e);
      const float v = (P == kX) ? 0.0f : __ldg(a.val + e);
      combine_atomic<R>(a.y + r, process<P>(xj, v, a.bits));
      if (M == kSparseGot) atomicAdd(a.got + r, 1);
    }
  }
}

template <int R, int P, int M>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  push_kernel<R, P, M><<<grid, kWarpsPerBlock * 32, 0, st>>>(a);
}

template <int R, int P>
bool launch_mode(int mode, dim3 grid, cudaStream_t st, const Args& a) {
  switch (mode) {
    case kDense: launch<R, P, kDense>(grid, st, a); return true;
    case kSparse: launch<R, P, kSparse>(grid, st, a); return true;
    case kSparseGot:
      if constexpr (R == kSum) {
        launch<R, P, kSparseGot>(grid, st, a);
        return true;
      }
      return false;
  }
  return false;
}

template <int R>
bool launch_process(int proc, int mode, dim3 grid, cudaStream_t st,
                    const Args& a) {
  switch (proc) {
    case kX: return launch_mode<R, kX>(mode, grid, st, a);
    case kXMulVal: return launch_mode<R, kXMulVal>(mode, grid, st, a);
    case kXAddVal: return launch_mode<R, kXAddVal>(mode, grid, st, a);
    case kKeyAddVal: return launch_mode<R, kKeyAddVal>(mode, grid, st, a);
  }
  return false;
}

}  // namespace

// One launch of the push SpMV.  rowptr int32[n_send + 1] over senders, col
// int32[nnz] the receiver of each edge (nnz < 2^31 - C), y (and got)
// already filled with the identity (and 0); extra_tile and extra_k
// int32[n_extra], the plan's further chunks (chunk k of tile t: edges
// [rowptr[32t] + k*C, + C) of senders [32t, 32t + 32)).  reduce: 0 sum, 1
// min, 2 max; process: 0 x, 1 x*val, 2 x+val, 3 key+val (shift `bits`);
// mode: 0 dense, 1 sparse, 2 sparse with got (sum only).  Pointers the
// mode or process does not read may be null.  Returns cudaGetLastError().
extern "C" int gm_spmv_push(const void* rowptr, const void* col,
                            const void* val, const void* x, const void* sent,
                            void* y, void* got, const void* extra_tile,
                            const void* extra_k, int n_extra, int n_send,
                            int reduce, int process, int mode, int bits,
                            void* stream) {
  if (n_send <= 0 || n_extra < 0 || bits < 0 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_send + 31) / 32;
  const int n_warps = n_tiles + n_extra;
  const int blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const Args a{static_cast<const int*>(rowptr), static_cast<const int*>(col),
               static_cast<const float*>(val), static_cast<const float*>(x),
               static_cast<const uint8_t*>(sent),
               static_cast<const int*>(extra_tile),
               static_cast<const int*>(extra_k), static_cast<float*>(y),
               static_cast<int*>(got), n_tiles, n_extra, n_send, bits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks);
  bool ok = false;
  switch (reduce) {
    case kSum: ok = launch_process<kSum>(process, mode, grid, st, a); break;
    case kMin: ok = launch_process<kMin>(process, mode, grid, st, a); break;
    case kMax: ok = launch_process<kMax>(process, mode, grid, st, a); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
