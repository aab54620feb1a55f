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
// The design: one warp per tile of 32 senders.  The warp reads the tile's
// 32 sent bytes in one coalesced load and takes __ballot_sync of them: an
// all-inactive tile costs that one load (the Hopper form of the chunk
// skip).  Each active lane also loads its sender's rowptr pair and x once;
// then, for each set bit, the warp broadcasts that sender's range and x by
// shuffle and walks its out-edges with its 32 lanes, coalesced over col and
// val, and (+)-combines into y[r] with atomics:
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
//
// What bounds it on an H100: per pushed edge it streams col (4 B) and val
// (4 B, when (x) reads it) and makes one atomic to y (and one to got) in
// L2; per sender it reads sent (1 B), and per active sender rowptr and x.
// At RMAT-22 y is 16 MB and sits in the 50 MB L2, so a dense push is
// bound by L2 atomic throughput, a sparse level by its frontier's edges.
// A hub sender runs on one warp: load balance (splitting a hub's
// out-edges across warps) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };
enum Process { kX = 0, kXMulVal = 1, kXAddVal = 2, kKeyAddVal = 3 };
enum Mode { kDense = 0, kSparse = 1, kSparseGot = 2 };

constexpr int kWarpsPerBlock = 8;
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

template <int R, int P, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
push_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
            const float* __restrict__ val, const float* __restrict__ x,
            const uint8_t* __restrict__ sent, float* y, int* got,
            int n_send, int bits) {
  const int lane = threadIdx.x & 31;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int n_tiles = (n_send + 31) >> 5;
  for (int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < n_tiles;
       t += nwarps) {
    const int s = (t << 5) + lane;
    bool act = s < n_send;
    if (M != kDense && act) act = __ldg(sent + s) != 0;
    unsigned todo = __ballot_sync(kFull, act);
    if (todo == 0) continue;
    int my_start = 0, my_end = 0;
    float my_x = 0.0f;
    if (act) {
      my_start = __ldg(rowptr + s);
      my_end = __ldg(rowptr + s + 1);
      my_x = __ldg(x + s);
    }
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      const int start = __shfl_sync(kFull, my_start, b);
      const int end = __shfl_sync(kFull, my_end, b);
      const float xs = __shfl_sync(kFull, my_x, b);
      for (int e = start + lane; e < end; e += 32) {
        const int r = __ldg(col + e);
        const float v = (P == kX) ? 0.0f : __ldg(val + e);
        combine_atomic<R>(y + r, process<P>(xs, v, bits));
        if (M == kSparseGot) atomicAdd(got + r, 1);
      }
    }
  }
}

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const float* x;
  const uint8_t* sent;
  float* y;
  int* got;
  int n_send;
  int bits;
};

template <int R, int P, int M>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  push_kernel<R, P, M><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      a.rowptr, a.col, a.val, a.x, a.sent, a.y, a.got, a.n_send, a.bits);
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
// int32[nnz] the receiver of each edge, y (and got) already filled with
// the identity (and 0).  reduce: 0 sum, 1 min, 2 max; process: 0 x,
// 1 x*val, 2 x+val, 3 key+val (shift `bits`); mode: 0 dense, 1 sparse,
// 2 sparse with got (sum only).  Pointers the mode or process does not
// read may be null.  Returns cudaGetLastError().
extern "C" int gm_spmv_push(const void* rowptr, const void* col,
                            const void* val, const void* x, const void* sent,
                            void* y, void* got, int n_send, int reduce,
                            int process, int mode, int bits, void* stream) {
  if (n_send <= 0 || bits < 0 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp per 32-sender tile up to 2^25 senders; beyond, warps stride
  const int n_tiles = (n_send + 31) / 32;
  int blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const Args a{static_cast<const int*>(rowptr), static_cast<const int*>(col),
               static_cast<const float*>(val), static_cast<const float*>(x),
               static_cast<const uint8_t*>(sent), static_cast<float*>(y),
               static_cast<int*>(got), n_send, bits};
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
