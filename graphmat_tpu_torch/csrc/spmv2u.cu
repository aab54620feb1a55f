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
//   operand: a sender id s < n_send reads x[s] (and sent[s]), where the
//            send wrote them; on a CSR that compaction diverted, an edge
//            of sender n_send + p reads position p of K2's extension,
//            x_aux[p] (and sent_aux[p]; csrc/compact.cu).  Diversion
//            changes only where a value is read, never the order of a
//            row's edges, so the result is bitwise that of the
//            uncompacted CSR.
//   dense:   every edge contributes.
//   sparse:  an edge contributes only when sent[sender] != 0; with `got`
//            the kernel also writes an int32 count of the receiver's edges
//            whose sender sent (the JAX kernel hides that bit in the low
//            mantissa bit of x instead).  With recv_final (one byte per
//            receiver row, the program's GraphProgram.receiver_final), a
//            row marked final is not read: it gets the identity and a
//            count of 0.  The JAX kernel skips a receiver block of wr rows
//            only when every row in it is final (pallas_spmv2u.py:
//            1381-1391); a row-granular skip is exact for the same reason,
//            since the program's apply is a no-op on a final row.
//
// What bounds it on an H100: the latency of the gathers, not bytes.  Per
// edge it streams col (4 B), and val (4 B) when (x) reads it, and gathers
// x[col] (4 B, one 32-B sector per scattered access) and in sparse mode
// sent[col] (1 B); per receiver it reads rowptr and writes y (and got).
// At RMAT-22 x is 16 MB and sits in the 50 MB L2; the byte bound is some
// 9x below what one warp per row reached (78 G edges/s), because each
// step of such a warp waits on a dependent L2 gather, half its lanes idle
// on RMAT's 15.6-edge rows and an in-degree hub row ran on one warp.
//
// The design: rows go to lane groups by length, from a plan built once per
// CSR (ops/spmv2u.py: k1_plan), and no warp handles more than C = 1024
// edges in a launch, whatever the degrees or the permutation.
//   * A row of at most 16, 32, 64 or C edges is read by a group of 4, 8,
//     16 or 32 lanes (at most 4 edges a lane below 64; the plan lists the
//     rows of each width, so the widths hold on an unpermuted graph too).
//     So a warp reads at most 8 x 16, 4 x 32, 2 x 64 or 1 x C edges.
//   * A row of more than C edges (an in-degree hub) is cut into chunks of
//     C edges, one warp each, which write their partial (and count) to
//     scratch; a second launch gives each such row a warp that combines
//     its partials in chunk order.
// Each lane reads its edges 4 at a time: the 4 col (and val) loads first,
// then the 4 gathers, so several gathers are in flight per lane.  A lane
// combines its edges in increasing edge order, a group reduces its lanes by
// a fixed xor-shuffle tree, and a hub row its partials by a fixed order
// too.  No atomics: a sum has one order for a given CSR and is bitwise the
// same from run to run.  The blocks of one launch are cut into ranges, one
// for each width and one for the chunks, so one launch (two with hub rows)
// does a whole SpMV.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };
enum Process { kX = 0, kXMulVal = 1, kXAddVal = 2, kKeyAddVal = 3 };
enum Mode { kDense = 0, kSparse = 1, kSparseGot = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkEdges = 1024;   // C; ops/spmv2u.py: CHUNK_EDGES
constexpr int kUnroll = 4;
constexpr int kKeyBias = 0x20000000;
constexpr int kKeySpan = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;

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

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const float* x;
  const float* x_aux;
  const uint8_t* sent;
  const uint8_t* sent_aux;
  const uint8_t* recv_final;
  float* y;
  int* got;
  int n_send;
  int bits;
};

// Sender s's value and sent flag: the operand's below n_send, K2's
// extension's above.
__device__ __forceinline__ float load_x(const Args& a, int s) {
  return __ldg(s < a.n_send ? a.x + s : a.x_aux + (s - a.n_send));
}

__device__ __forceinline__ uint8_t load_sent(const Args& a, int s) {
  return __ldg(s < a.n_send ? a.sent + s : a.sent_aux + (s - a.n_send));
}

// The plan: rows[seg[w] .. seg[w + 1]) are the rows of width 4 << w;
// chunk c of a hub row covers edges [chunk_start[c], + C) of row
// chunk_row[c]; hub row h (long_rows[h]) owns chunks [long_first[h],
// long_first[h + 1]).  blk[w] .. blk[w + 1] are the launch's blocks for
// width 4 << w, blk[4] .. blk[5] those for the chunks.
struct Plan {
  const int* rows;
  const int* chunk_row;
  const int* chunk_start;
  const int* long_rows;
  const int* long_first;
  float* part;
  int* part_cnt;
  int seg[5];
  int blk[6];
  int n_chunks;
  int n_long;
};

// One lane's edges e, e + S, e + 2S, ... below `end`, in that order,
// kUnroll at a time: the loads of col (and val) first, then the gathers.
template <int S, int R, int P, int M>
__device__ __forceinline__ void lane_edges(const Args& a, int e, int end,
                                           float& acc, int& cnt) {
  for (; e < end; e += kUnroll * S) {
    int s[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int eu = e + u * S;
      s[u] = eu < end ? __ldg(a.col + eu) : -1;
      v[u] = (P != kX && eu < end) ? __ldg(a.val + eu) : 0.0f;
    }
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ok[u] = s[u] >= 0 && (M == kDense || load_sent(a, s[u]) != 0);
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      xv[u] = ok[u] ? load_x(a, s[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
        acc = combine<R>(acc, process<P>(xv[u], v[u], a.bits));
        if (M == kSparseGot) ++cnt;
      }
    }
  }
}

template <int M>
__device__ __forceinline__ bool is_final(const Args& a, int row) {
  return M != kDense && a.recv_final != nullptr &&
         __ldg(a.recv_final + row) != 0;
}

// Rows of width G: a group of G lanes per row, kThreads / G rows a block.
template <int G, int R, int P, int M>
__device__ __forceinline__ void rows_of_width(const Args& a, const Plan& p,
                                              int blk, int lo, int hi) {
  const int sub = threadIdx.x & (G - 1);
  const int i = lo + blk * (kThreads / G) + threadIdx.x / G;
  const bool has = i < hi;
  int row = 0, start = 0, end = 0;
  if (has) {
    row = __ldg(p.rows + i);
    if (!is_final<M>(a, row)) {
      start = __ldg(a.rowptr + row);
      end = __ldg(a.rowptr + row + 1);
    }
  }
  float acc = identity<R>();
  int cnt = 0;
  lane_edges<G, R, P, M>(a, start + sub, end, acc, cnt);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc = combine<R>(acc, __shfl_xor_sync(kFull, acc, off));
    if (M == kSparseGot) cnt += __shfl_xor_sync(kFull, cnt, off);
  }
  if (has && sub == 0) {
    a.y[row] = acc;   // a final row: the identity, count 0
    if (M == kSparseGot) a.got[row] = cnt;
  }
}

// One chunk of C edges of a hub row per warp: its partial to scratch.
template <int R, int P, int M>
__device__ __forceinline__ void hub_chunk(const Args& a, const Plan& p,
                                          int blk) {
  const int lane = threadIdx.x & 31;
  const int c = blk * kWarps + (threadIdx.x >> 5);
  if (c >= p.n_chunks) return;   // the whole warp
  const int row = __ldg(p.chunk_row + c);
  if (is_final<M>(a, row)) return;   // the combining pass writes it
  const int start = __ldg(p.chunk_start + c);
  const int end = min(start + kChunkEdges, __ldg(a.rowptr + row + 1));
  float acc = identity<R>();
  int cnt = 0;
  lane_edges<32, R, P, M>(a, start + lane, end, acc, cnt);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = combine<R>(acc, __shfl_xor_sync(kFull, acc, off));
    if (M == kSparseGot) cnt += __shfl_xor_sync(kFull, cnt, off);
  }
  if (lane == 0) {
    p.part[c] = acc;
    if (M == kSparseGot) p.part_cnt[c] = cnt;
  }
}

template <int R, int P, int M>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(const Args a, const Plan p) {
  const int b = blockIdx.x;
  if (b < p.blk[1])
    rows_of_width<4, R, P, M>(a, p, b - p.blk[0], p.seg[0], p.seg[1]);
  else if (b < p.blk[2])
    rows_of_width<8, R, P, M>(a, p, b - p.blk[1], p.seg[1], p.seg[2]);
  else if (b < p.blk[3])
    rows_of_width<16, R, P, M>(a, p, b - p.blk[2], p.seg[2], p.seg[3]);
  else if (b < p.blk[4])
    rows_of_width<32, R, P, M>(a, p, b - p.blk[3], p.seg[3], p.seg[4]);
  else
    hub_chunk<R, P, M>(a, p, b - p.blk[4]);
}

// One warp per hub row: its chunks' partials, lane-strided in chunk order
// then by the xor tree, so the sum's order is fixed.
template <int R, int M>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Args a, const Plan p) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (h >= p.n_long) return;   // the whole warp
  const int row = __ldg(p.long_rows + h);
  float acc = identity<R>();
  int cnt = 0;
  if (!is_final<M>(a, row)) {
    const int end = __ldg(p.long_first + h + 1);
    for (int c = __ldg(p.long_first + h) + lane; c < end; c += 32) {
      acc = combine<R>(acc, p.part[c]);
      if (M == kSparseGot) cnt += p.part_cnt[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = combine<R>(acc, __shfl_xor_sync(kFull, acc, off));
    if (M == kSparseGot) cnt += __shfl_xor_sync(kFull, cnt, off);
  }
  if (lane == 0) {
    a.y[row] = acc;
    if (M == kSparseGot) a.got[row] = cnt;
  }
}

template <int R, int P, int M>
void launch(cudaStream_t st, const Args& a, const Plan& p) {
  if (p.blk[5] > 0)
    spmv_kernel<R, P, M><<<p.blk[5], kThreads, 0, st>>>(a, p);
  if (p.n_long > 0)
    combine_kernel<R, M><<<(p.n_long + kWarps - 1) / kWarps, kThreads, 0,
                           st>>>(a, p);
}

template <int R, int P>
bool launch_mode(int mode, cudaStream_t st, const Args& a, const Plan& p) {
  switch (mode) {
    case kDense: launch<R, P, kDense>(st, a, p); return true;
    case kSparse: launch<R, P, kSparse>(st, a, p); return true;
    case kSparseGot: launch<R, P, kSparseGot>(st, a, p); return true;
  }
  return false;
}

template <int R>
bool launch_process(int proc, int mode, cudaStream_t st, const Args& a,
                    const Plan& p) {
  switch (proc) {
    case kX: return launch_mode<R, kX>(mode, st, a, p);
    case kXMulVal: return launch_mode<R, kXMulVal>(mode, st, a, p);
    case kXAddVal: return launch_mode<R, kXAddVal>(mode, st, a, p);
    case kKeyAddVal: return launch_mode<R, kKeyAddVal>(mode, st, a, p);
  }
  return false;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// One K1 SpMV (one launch, and a second when the CSR has rows of more than
// C edges).  reduce: 0 sum, 1 min, 2 max; process: 0 x, 1 x*val, 2 x+val,
// 3 key+val (shift `bits`); mode: 0 dense, 1 sparse, 2 sparse with got.
// x and sent hold n_send senders; x_aux and sent_aux (null on an
// uncompacted CSR) hold the senders col names from n_send up.
// recv_final (sparse modes) may be null: no row is final.  The plan
// (ops/spmv2u.py: k1_plan): rows int32[n4 + n8 + n16 + n32], the rows of
// each width in that order; chunk_row and chunk_start int32[n_chunks];
// long_rows int32[n_long] and long_first int32[n_long + 1]; part float32
// and part_cnt int32 [n_chunks] scratch (part_cnt read in mode 2 only).
// Every row of the CSR is in rows or long_rows once.  Pointers the mode,
// process or plan does not read may be null.  Returns cudaGetLastError().
extern "C" int gm_spmv(const void* rowptr, const void* col, const void* val,
                       const void* x, const void* x_aux, const void* sent,
                       const void* sent_aux, const void* recv_final, void* y,
                       void* got,
                       const void* rows, const void* chunk_row,
                       const void* chunk_start, const void* long_rows,
                       const void* long_first, void* part, void* part_cnt,
                       int n4, int n8, int n16, int n32, int n_chunks,
                       int n_long, int n_send, int reduce, int process,
                       int mode, int bits, void* stream) {
  if (n4 < 0 || n8 < 0 || n16 < 0 || n32 < 0 || n_chunks < n_long ||
      n_long < 0 || n_send < 0 || bits < 0 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(rowptr), static_cast<const int*>(col),
               static_cast<const float*>(val), static_cast<const float*>(x),
               static_cast<const float*>(x_aux),
               static_cast<const uint8_t*>(sent),
               static_cast<const uint8_t*>(sent_aux),
               static_cast<const uint8_t*>(recv_final),
               static_cast<float*>(y), static_cast<int*>(got), n_send, bits};
  Plan p{static_cast<const int*>(rows), static_cast<const int*>(chunk_row),
         static_cast<const int*>(chunk_start),
         static_cast<const int*>(long_rows),
         static_cast<const int*>(long_first), static_cast<float*>(part),
         static_cast<int*>(part_cnt), {}, {}, n_chunks, n_long};
  const int counts[4] = {n4, n8, n16, n32};
  p.seg[0] = 0;
  p.blk[0] = 0;
  for (int w = 0; w < 4; ++w) {
    p.seg[w + 1] = p.seg[w] + counts[w];
    p.blk[w + 1] = p.blk[w] + ceil_div(counts[w], kThreads / (4 << w));
  }
  p.blk[5] = p.blk[4] + ceil_div(n_chunks, kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (reduce) {
    case kSum: ok = launch_process<kSum>(process, mode, st, a, p); break;
    case kMin: ok = launch_process<kMin>(process, mode, st, a, p); break;
    case kMax: ok = launch_process<kMax>(process, mode, st, a, p); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
