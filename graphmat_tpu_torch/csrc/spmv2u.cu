// K1: the generalized SpMV  y[r] = (+)_{s->r} process(x[s], val_e)  on Hopper.
//
// Replaces the TPU kernel graphmat_tpu/ops/pallas_spmv2u.py:_make_kernel_u
// (driven by _spmv2u_call and spmv2u).  It computes the same function, not
// the TPU layout: no 128-lane routed slots, window classes, bf16 splits or
// VMEM plans.  The input is the receiver CSR that graphmat_tpu_torch builds
// (rowptr over receivers, col = sender of each edge, edges sorted by
// (receiver, sender)).
//
//   (+) in {sum, min, max}, identities 0, +inf, -inf (true infinities:
//       the JAX kernel path clamps to +-1e30 instead).
//   (x) in {x, x*val, x+val, key+val}.  key+val is packed-key BFS's op
//       (graphmat_tpu/apps/bfs.py:251-262): it adds (int(val) - 1) << bits
//       to the int32 bit pattern of x when that pattern lies in
//       [KEY_BIAS, KEY_BIAS + 2^28), and passes x through otherwise (the
//       +inf fill, INF keys).  Keys are non-negative int32 patterns of
//       normal floats (KEY_BIAS = 0x20000000 keeps them out of the
//       denormals), so float min orders them as int min.  The library is
//       built without --use_fast_math: no flush-to-zero question arises.
//   dense:   every edge contributes.
//   sparse:  an edge contributes only when sent[sender] != 0; with `got`
//            the kernel also writes an int32 count of the receiver's edges
//            whose sender sent (the JAX kernel hides that bit in the low
//            mantissa bit of x instead).  With recv_final (one byte per
//            receiver row, the program's GraphProgram.receiver_final), a
//            row marked final is not read: its warp writes the identity
//            and a count of 0.  The JAX kernel skips a receiver block of
//            wr rows only when every row in it is final
//            (pallas_spmv2u.py:1381-1391); a row-granular skip is exact
//            for the same reason, since the program's apply is a no-op on
//            a final row.
//
// What bounds it on an H100: bytes.  Per edge it streams col (4 B), and
// val (4 B) when (x) reads it, and gathers x[col] (4 B, one 32-B sector
// per scattered access) and in sparse mode sent[col] (1 B); per receiver
// it reads rowptr and writes y (and got).  At RMAT-22 x is 16 MB, so the
// gathers are served by the 50 MB L2 and the streamed col is the HBM
// traffic.  The design: one warp per receiver row, its lanes reading
// consecutive edges so the col/val loads coalesce, x and sent through the
// read-only path, the row's (+) reduced in registers by a fixed xor-shuffle
// tree.  No atomics, so a sum has one order for a given graph and is
// bitwise the same from run to run.  A row shorter than 32 edges leaves
// lanes idle and a hub row runs on one warp: a load-balanced form is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };
enum Process { kX = 0, kXMulVal = 1, kXAddVal = 2, kKeyAddVal = 3 };
enum Mode { kDense = 0, kSparse = 1, kSparseGot = 2 };

constexpr int kWarpsPerBlock = 8;
constexpr int kKeyBias = 0x20000000;
constexpr int kKeySpan = 1 << 28;

template <int R>
__device__ __forceinline__ float identity() {
  if (R == kSum) return 0.0f;
  if (R == kMin) return __int_as_float(0x7f800000);  // +inf
  return __int_as_float(0xff800000);                  // -inf
}

template <int R>
__device__ __forceinline__ float combine(float a, float b) {
  if (R == kSum) return a + b;
  if (R == kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <int P>
__device__ __forceinline__ float process(float x, float v, int bits) {
  if (P == kX) return x;
  if (P == kXMulVal) return x * v;
  if (P == kXAddVal) return x + v;
  int u = __float_as_int(x);
  if (u >= kKeyBias && u < kKeyBias + kKeySpan) {
    // unsigned arithmetic: int32 wrap as in the JAX op, no signed shift
    const unsigned w = static_cast<unsigned>(static_cast<int>(v) - 1);
    u = static_cast<int>(static_cast<unsigned>(u) + (w << bits));
  }
  return __int_as_float(u);
}

template <int R, int P, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
            const float* __restrict__ val, const float* __restrict__ x,
            const uint8_t* __restrict__ sent,
            const uint8_t* __restrict__ recv_final, float* __restrict__ y,
            int* __restrict__ got, int n_rows, int bits) {
  const int lane = threadIdx.x & 31;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < n_rows;
       row += nwarps) {
    if (M != kDense && recv_final != nullptr && __ldg(recv_final + row)) {
      if (lane == 0) {
        y[row] = identity<R>();
        if (M == kSparseGot) got[row] = 0;
      }
      continue;
    }
    const int start = __ldg(rowptr + row);
    const int end = __ldg(rowptr + row + 1);
    float acc = identity<R>();
    int cnt = 0;
    for (int e = start + lane; e < end; e += 32) {
      const int s = __ldg(col + e);
      if (M != kDense) {
        if (!__ldg(sent + s)) continue;
        ++cnt;
      }
      const float v = (P == kX) ? 0.0f : __ldg(val + e);
      acc = combine<R>(acc, process<P>(__ldg(x + s), v, bits));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = combine<R>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (M == kSparseGot) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      y[row] = acc;
      if (M == kSparseGot) got[row] = cnt;
    }
  }
}

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const float* x;
  const uint8_t* sent;
  const uint8_t* recv_final;
  float* y;
  int* got;
  int n_rows;
  int bits;
};

template <int R, int P, int M>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  spmv_kernel<R, P, M><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      a.rowptr, a.col, a.val, a.x, a.sent, a.recv_final, a.y, a.got,
      a.n_rows, a.bits);
}

template <int R, int P>
bool launch_mode(int mode, dim3 grid, cudaStream_t st, const Args& a) {
  switch (mode) {
    case kDense: launch<R, P, kDense>(grid, st, a); return true;
    case kSparse: launch<R, P, kSparse>(grid, st, a); return true;
    case kSparseGot: launch<R, P, kSparseGot>(grid, st, a); return true;
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

// One launch of K1.  reduce: 0 sum, 1 min, 2 max; process: 0 x, 1 x*val,
// 2 x+val, 3 key+val (shift `bits`); mode: 0 dense, 1 sparse, 2 sparse
// with got.  recv_final (sparse modes) may be null: no row is final.
// Pointers the mode or process does not read may be null.  Returns
// cudaGetLastError().
extern "C" int gm_spmv(const void* rowptr, const void* col, const void* val,
                       const void* x, const void* sent,
                       const void* recv_final, void* y, void* got,
                       int n_rows, int reduce, int process, int mode,
                       int bits, void* stream) {
  if (n_rows <= 0 || bits < 0 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp per row up to 2^23 rows (the hardware schedules the blocks);
  // beyond that the warps stride over rows and thread ids stay in 32 bits
  int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const dim3 grid(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const int*>(rowptr), static_cast<const int*>(col),
               static_cast<const float*>(val), static_cast<const float*>(x),
               static_cast<const uint8_t*>(sent),
               static_cast<const uint8_t*>(recv_final),
               static_cast<float*>(y), static_cast<int*>(got), n_rows, bits};
  bool ok = false;
  switch (reduce) {
    case kSum: ok = launch_process<kSum>(process, mode, grid, st, a); break;
    case kMin: ok = launch_process<kMin>(process, mode, grid, st, a); break;
    case kMax: ok = launch_process<kMax>(process, mode, grid, st, a); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
