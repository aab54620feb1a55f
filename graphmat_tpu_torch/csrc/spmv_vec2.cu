// K3: the K-wide three-operand SpMV on Hopper,
//
//   y[r, :] = sum_{s->r} process(x[s, :], val_e, vp[r, :], extra)
//
// and, in its sparse mode, K4 with K5's got pass fused in:
//
//   y[r, :] = sum_{s->r, sent[s]} process(x[s, :], val_e, vp[r, :], extra)
//   got[r]  = #{s->r : sent[s]}
//
// The dense mode replaces the TPU kernel
// graphmat_tpu/ops/pallas_spmv_vec2.py: _make_vec2_kernel (driven by
// _spmv_vec2_seg and spmv_vec2), which serves ALL_VERTICES programs.  The
// sparse mode replaces graphmat_tpu/ops/pallas_spmv_vec.py:
// _make_vec_kernel (driven by _spmv_vec_call and spmv_vec), the ACTIVE_ONLY
// route, together with the got pass the JAX engine runs after it through
// graphmat_tpu/ops/pallas_spmv.py: _make_kernel (K5, the scalar SpMV of the
// sent bits with the identity process).  Unlike K4, an edge whose sender
// did not send contributes nothing, for every op: K4 only masks pad edges,
// so ops for which process(0, ...) != 0 (sgd_sqerr, lda, lda_loglik,
// lda_init) add terms of senders that did not send; the XLA path, and
// GraphMat, do not.  Both modes compute the same function as the TPU
// kernels, not their layout: no V4 rows of four 32-lane slots, window
// classes, WYK receiver windows, rotations, one-hot MXU gathers, bf16 split
// planes or range-prefix-sum scatter (those served VMEM and the MXU).  A
// row with no sent edge writes 0 and a count of 0.  The input is the
// receiver CSR of graphmat_tpu_torch (rowptr over receivers, col = sender
// of each edge, edges sorted by (receiver, sender)); x is [n_send, k] with
// rows ldx floats apart, vp [n_rows, k], both float32.
//
// The JAX kernel takes process as a closure traced into the kernel; CUDA
// needs a closed set, so process is a template parameter over the ops the
// shipped programs declare (graphmat_tpu_torch/ops/spmv_vec2.py holds the
// torch function of each, which is the plain version):
//
//   sgd         x * (val - <x, vp_r>)                       k columns out
//   sgd_sqerr   (val - <x, vp_r>)^2                          1 column out
//   lda_init    gamma / sum(gamma) * val, gamma_j the j-th rand_r draw
//               seeded with (uint32)(int)val; vp unused      k columns out
//   lda         gamma ~ (vp_r + my_off - 1)(x + other_off - 1)
//               / (extra + V(eta - 1)), normalised over the k - 1 topics,
//               times val; column k - 1 of vp_r is the receiver's is_doc
//               flag (ids may be permuted, so never rid < ndoc)
//                                                            k - 1 columns out
//   lda_loglik  val * log(sum_j phi_j theta_j / sum theta),
//               phi = (vp_r + eta - 1) / extra, theta = x + eta - 1
//                                                            1 column out
//
// What bounds it on an H100.  Per edge it gathers one row of x (80 B at
// k = 20: three 32-B sectors) from L2, where x (18-39 MB at the slices'
// sizes) stays; col and val (8 B an edge) stream from HBM.  That gather,
// about 2.4 GB of sectors per sgd and 6.7 GB per lda launch at the
// slices' shapes, is the floor, far above the HBM bound.  Reaching it
// takes many gathers in flight.  The parent design (one warp per row,
// one component per lane, the warp walking one edge at a time) sat far
// above it, held by the issue rate: every edge cost a 5-step shuffle tree
// per in-row sum, two shuffles to broadcast the edge, idle lanes for
// k < 32, and for lda two IEEE divisions per component per edge (48% of
// its time; PERF.md, K3's step 0).
//
// The design: edges across lanes, not components.  A warp owns a
// receiver row (so what depends on the receiver alone is computed once
// per row, at its first (sent) edge, in registers), and a group of G
// lanes owns
// a whole edge: lane `sub` of the group holds components
// 4 (sub + G i) + j (i < V, j < 4) and gathers them with 16-byte loads
// where x's rows are 16-byte aligned (the wrapper pads x to a multiple of
// 4 columns), so a warp has 32 / G row gathers in flight where it had
// one.  G and V follow the width (template parameters): one lane an edge
// up to 8 components, then the fewest lanes of 2, 4, ..., 32 with V = 2,
// up to 256.  A lane never holds more than 8 components, so a kernel
// keeps to 64 registers (its launch bounds hold it there) and an SM runs
// 32 warps: on the card more warps beat fuller lanes (PERF.md).  The
// in-row sums (sgd's dot product, lda's normaliser, lda_loglik's theta
// total and dot) are taken inside the lane in four fixed partial chains,
// then across the group by an xor tree.  lda multiplies by reciprocals:
// the block keeps
// 1 / (extra[c] + V(eta - 1)) in shared memory, a lane folds it into the
// receiver's factor once per row, and scales an edge by val / tot, one
// division an edge instead of 2 (k - 1); each term moves by about one
// unit of roundoff against the JAX formula.  lda_init's rand_r jumps (the
// LCG advanced 3c steps for component c) are built once per block into
// shared memory, by squaring; lda_init, which runs once a run, sums in
// double and rounds once.  One wave of blocks, as many as the card
// holds, walks the rows, each warp loading its next row's extent and the
// next 64 edges' col and val while it works.  At the row's end the
// groups' partial sums meet in a fixed xor tree and are written once: no
// atomics.  The edges of a row go to the groups by rank, the i-th to
// group i mod (32 / G), and each group sums its edges in edge order with
// one fused multiply-add each, so a sum is bitwise the same from launch
// to launch.
//
// No warp takes more than C = 1024 edges, whatever the degrees.  A row of
// at most C edges is walked as above by one warp.  A longer row (a
// MovieLens film with 81,000 ratings, on one warp, held a whole launch for
// as long as the rest of the card took for all other rows) is cut into
// chunks of C edges, the chunks of K1's split of the CSR (ops/spmv2u.py:
// k1_plan, built once per CSR), one warp each: the chunk computes the
// receiver's values itself, sums its edges exactly as a row's, and writes
// its K-wide partial (one float for the scalar ops; for lda_init in
// double) and, in the sparse mode, its count to scratch.  A second launch
// sums each such row's partials in chunk order and writes y and got.  The
// wave's warps take the chunks by stride, then the rows, as before; which
// warp takes a chunk or a row never changes a bit.  So a CSR with no row
// over C runs the one-warp-a-row walk and gives its bits, and the sparse
// mode with every sender sent gives those of the dense mode.
//
// Wider rows (more than 256 components) take the slab kernel: the warp
// walks the row's edges one at a time, each lane holding components
// lane + 32 t of a slab of 128; an op with an in-row sum makes one pass
// over x's row for the sum and a second for the terms, which accumulate
// in y's row itself (the warp owns it; edge order, no atomics).  Any
// width int32 indexing addresses runs.
//
// The sparse mode keeps the structure.  It reads a row's edges 64 at a
// time: each lane loads its two edges' sender flags (dependent byte
// gathers) and the values of the sent ones, and the next 64 edges' col,
// all in flight together.  The sent edges are compacted in order into a
// per-warp buffer in shared memory, which is handed out, by rank in the
// row, once it holds 32 edges or the row ends, exactly as the dense mode
// hands out all edges: with every sender sent the two modes give the same
// bits.  At a sparse frontier a row's few sent edges are so gathered in
// one step, not one step each.  The popcount of the ballots is the row's
// got count, written once: K5's one use in the JAX engine costs no second
// pass.  At a sparse frontier the walk still reads every edge's col and
// gathers its sender's flag, which holds the mode near the old design's
// time below 10% sent (at 1% sent a few percent above it; PERF.md); a
// frontier worklist is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { kSgd = 0, kSgdSqerr = 1, kLdaInit = 2, kLda = 3, kLdaLoglik = 4 };

constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSm = 4;   // 32 warps an SM: at most 64 registers
constexpr int kMaxV = 2;     // float4s of components a lane holds
constexpr int kMaxG = 32;    // lanes an edge takes in the register layout
constexpr int kRegWidth = 4 * kMaxV * kMaxG;   // 256; wider: the slab kernel
constexpr int kSlab = 128;   // components a slab covers, 4 per lane
constexpr int kDenseSpan = 64;     // edges the dense mode reads at once
constexpr int kSparseSpan = 64;    // edges the sparse mode reads at once
constexpr int kChunkEdges = 1024;  // C; ops/spmv2u.py: CHUNK_EDGES
constexpr int kCombineThreads = 256;
constexpr uint32_t kLcgA = 1103515245u;
constexpr uint32_t kLcgC = 12345u;
constexpr float kInvRandMaxF32 = 4.656612873077392578125e-10f;  // 2^-31

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const float* x;
  const float* vp;
  const float* extra;
  const uint8_t* sent;
  float* y;
  int* got;
  int n_rows, k, ldx, nc;
  bool xvec, vpvec, yvec;   // x's, vp's and y's rows 16-byte aligned
  float s0, s1, s2;
  // the chunks of the rows of more than C edges (register layout only):
  // chunk c covers edges [chunk_start[c], + C) of row chunk_row[c], cut at
  // the row's end; long row h (long_rows[h]) owns chunks [long_first[h],
  // long_first[h + 1]).  part holds a chunk's partial, [n_chunks, out
  // width] float32 (float64 for lda_init), part_cnt its count in the
  // sparse mode.
  const int* chunk_row;
  const int* chunk_start;
  const int* long_rows;
  const int* long_first;
  void* part;
  int* part_cnt;
  int n_chunks, n_long;
  bool pvec;                // part's rows 16-byte aligned
};

// The LCG s -> A s + C advanced n steps, as s -> a s + c (mod 2^32): by
// squaring (powers of one affine map commute).
struct Jump {
  uint32_t a, c;
};

__device__ __forceinline__ Jump lcg_jump(uint32_t n) {
  Jump r{1u, 0u}, p{kLcgA, kLcgC};
  while (n != 0u) {
    if (n & 1u) r = Jump{p.a * r.a, p.a * r.c + p.c};
    p = Jump{p.a * p.a, p.a * p.c + p.c};
    n >>= 1;
  }
  return r;
}

// glibc rand_r from a state already advanced by the component's jump:
// three LCG steps, 11 + 10 + 10 bits.  Divided by float32(RAND_MAX) = 2^31
// as the JAX package does, which is exact.
__device__ __forceinline__ float rand_r_uniform(uint32_t st) {
  st = st * kLcgA + kLcgC;
  uint32_t r = (st >> 16) & 2047u;
  st = st * kLcgA + kLcgC;
  r = (r << 10) ^ ((st >> 16) & 1023u);
  st = st * kLcgA + kLcgC;
  r = (r << 10) ^ ((st >> 16) & 1023u);
  return __int2float_rn(static_cast<int>(r)) * kInvRandMaxF32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// An xor tree over the lanes [lo, hi) of an offset range; every lane ends
// with the same bits (IEEE addition commutes).
template <typename T>
__device__ __forceinline__ T xor_sum(T v, int lo, int hi) {
  for (int off = lo; off < hi; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of n values in four fixed chains, then a fixed pairing.
template <int N>
__device__ __forceinline__ float sum4(const float* v) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i) p[i & 3] += v[i];
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// ------------------------------------------- register layout, width <= 256

// One warp per item, a receiver row or a chunk of one; a group of G lanes
// per edge; lane `sub` of a group holds components 4 (sub + G i) + j,
// i < V, j < 4.
template <int OP, int G, int V, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSm)
k3_lanes(const Args a) {
  constexpr int C = 4 * V;
  constexpr int NG = 32 / G;       // edges a warp holds in flight
  constexpr bool kCst = OP == kLda || OP == kLdaLoglik;
  // the sparse mode's buffer of sent edges: fewer than 32 wait while a
  // span is read
  __shared__ int s_col[kWarpsPerBlock][SPARSE ? kSparseSpan + 32 : 1];
  __shared__ float s_val[kWarpsPerBlock][SPARSE ? kSparseSpan + 32 : 1];
  // per-component constants, built once per block: lda's
  // 1 / (extra + V(eta - 1)), lda_loglik's extra, lda_init's jumps
  __shared__ float s_cst[kCst ? kRegWidth : 1];
  __shared__ Jump s_jmp[OP == kLdaInit ? kRegWidth : 1];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int grp = lane / G;
  const int sub = lane % G;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int nc = a.nc;
  const int k = a.k;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    if (OP == kLda) s_cst[c] = 1.0f / (__ldg(a.extra + c) + a.s2);
    if (OP == kLdaLoglik) s_cst[c] = __ldg(a.extra + c);
    if (OP == kLdaInit) s_jmp[c] = lcg_jump(3u * static_cast<uint32_t>(c));
  }
  __syncthreads();
  // the component of slot (i, j)
  auto comp = [&](int i, int j) { return 4 * (sub + G * i) + j; };

  // one item: edges [start, end) of row `row`, the whole row, or with
  // kChunk chunk `item` of it, whose partial (and count) go to scratch
  auto walk = [&](int row, int start, int end, int item, auto chunk_flag) {
    constexpr bool kChunk = decltype(chunk_flag)::value;
    const float* vpr = a.vp + static_cast<size_t>(row) * k;

    // what depends on the receiver alone, computed at the row's first
    // edge: sgd's vp row; lda's (vp + my_off - 1) / (extra + V(eta - 1));
    // lda_loglik's phi
    float rv[C];
    float other_off = 0.0f;
    bool ready = false;
    auto receiver = [&]() {
      bool is_doc = false;
      if (OP == kLda) {
        is_doc = __ldg(vpr + (k - 1)) > 0.5f;
        other_off = is_doc ? a.s1 : a.s0;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int c0 = comp(i, 0);
        if (OP != kLdaInit && c0 < nc) {
          if (a.vpvec) {
            const float4 f =
                __ldg(reinterpret_cast<const float4*>(vpr + c0));
            v[0] = f.x;
            v[1] = f.y;
            v[2] = f.z;
            v[3] = f.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < nc) v[j] = __ldg(vpr + c0 + j);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          float r = 0.0f;
          if (c < nc) {
            if (OP == kSgd || OP == kSgdSqerr) r = v[j];
            if (OP == kLda)
              r = ((v[j] + (is_doc ? a.s0 : a.s1)) - 1.0f) * s_cst[c];
            if (OP == kLdaLoglik) r = (v[j] + a.s0) / s_cst[c];
          }
          rv[4 * i + j] = r;
        }
      }
    };

    float acc[C];
    double dacc[C];   // lda_init's (the other ops leave it unused)
#pragma unroll
    for (int q = 0; q < C; ++q) {
      acc[q] = 0.0f;
      dacc[q] = 0.0;
    }
    // acc[q] += t[q] * f, by one fused multiply-add in either mode
    auto accumulate = [&](const float (&t)[C], float f) {
#pragma unroll
      for (int q = 0; q < C; ++q) acc[q] = __fmaf_rn(t[q], f, acc[q]);
    };

    // one edge of the group in two parts, the gather of sender s's row
    // and the work on it with value v; `ok` is false on a slot past the
    // batch, which computes on zeros and adds nothing.  Past nc a slot's
    // rv is 0 and its x finite (x's pad is 0), so its terms in the in-row
    // sums are 0; its acc is never written.
    auto gather = [&](int s, bool ok, float (&xv)[C]) {
      if (OP != kLdaInit) {
        const float* xs = a.x + static_cast<size_t>(s) * a.ldx;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int c0 = comp(i, 0);
          if (a.xvec) {
            float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (ok && c0 < nc)
              f = __ldg(reinterpret_cast<const float4*>(xs + c0));
            xv[4 * i] = f.x;
            xv[4 * i + 1] = f.y;
            xv[4 * i + 2] = f.z;
            xv[4 * i + 3] = f.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xv[4 * i + j] = ok && c0 + j < nc ? __ldg(xs + c0 + j) : 0.0f;
          }
        }
      }
    };
    auto work = [&](const float (&xv)[C], float v, bool ok) {
      if (OP == kSgd || OP == kSgdSqerr) {
        float t[C];
#pragma unroll
        for (int q = 0; q < C; ++q) t[q] = xv[q] * rv[q];
        const float err = v - xor_sum(sum4<C>(t), 1, G);
        if (ok) {
          if (OP == kSgd) {
            accumulate(xv, err);
          } else {
            acc[0] += err * err;
          }
        }
      } else if (OP == kLdaInit) {
        const uint32_t seed = static_cast<uint32_t>(static_cast<int>(v));
        float g[C];
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = comp(i, j);
            g[4 * i + j] = c < nc ? rand_r_uniform(s_jmp[c].a * seed +
                                                   s_jmp[c].c)
                                  : 0.0f;
          }
        // lda_init runs once a run: its normaliser and sums are taken in
        // double, rounded to float32 once at the row's end
        double t = 0.0;
#pragma unroll
        for (int q = 0; q < C; ++q) t += g[q];
        const double scale = v / xor_sum(t, 1, G);
        if (ok) {
#pragma unroll
          for (int q = 0; q < C; ++q)
            dacc[q] = fma(static_cast<double>(g[q]), scale, dacc[q]);
        }
      } else if (OP == kLda) {
        float g[C];
#pragma unroll
        for (int q = 0; q < C; ++q)
          g[q] = rv[q] * ((xv[q] + other_off) - 1.0f);
        const float scale = v / xor_sum(sum4<C>(g), 1, G);
        if (ok) {
          accumulate(g, scale);
        }
      } else {  // kLdaLoglik
        float th[C];
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            th[4 * i + j] = comp(i, j) < nc ? xv[4 * i + j] + a.s0 : 0.0f;
        const float th_tot = xor_sum(sum4<C>(th), 1, G);
        float d[C];
#pragma unroll
        for (int q = 0; q < C; ++q) d[q] = rv[q] * (th[q] / th_tot);
        const float dot = xor_sum(sum4<C>(d), 1, G);
        if (ok) acc[0] += v * logf(dot);
      }
    };

    // hand out n edges, the j-th of rank cnt + j going to group
    // (cnt + j) mod NG: sender and value by fetch(j)
    int cnt = 0;   // edges handed out so far (sent edges in the sparse mode)
    auto hand_out = [&](int n, auto fetch) {
      if (!ready) {
        receiver();
        ready = true;
      }
      int j = grp - cnt % NG;
      if (j < 0) j += NG;
      const int steps = (n + NG - 1) / NG;
      for (int t = 0; t < steps; ++t, j += NG) {
        const bool ok0 = j < n;
        int s0;
        float v0;
        fetch(j, ok0, s0, v0);
        float x0[C];
        gather(s0, ok0, x0);
        work(x0, v0, ok0);
      }
      cnt += n;
    };
    if (SPARSE) {
      // a span of edges at a time (their col loaded with the span before):
      // sent flags and (where sent) values load together, and the next
      // span's col; the sent ones join the warp's buffer in
      // order, which is handed out once it holds 32 or the row ends (one
      // pass past the last span)
      int q = 0;   // edges waiting in the buffer
      int cl[kSparseSpan / 32];   // the span's senders, loaded a span ahead
#pragma unroll
      for (int b = 0; b < kSparseSpan / 32; ++b) {
        const int e = start + 32 * b + lane;
        cl[b] = e < end ? __ldg(a.col + e) : 0;
      }
      for (int base = start;; base += kSparseSpan) {
        const bool last = base >= end;
        if (!last) {
          int nx_cl[kSparseSpan / 32];
          float vl[kSparseSpan / 32];
          bool on[kSparseSpan / 32];
#pragma unroll
          for (int b = 0; b < kSparseSpan / 32; ++b) {
            const int e = base + kSparseSpan + 32 * b + lane;
            nx_cl[b] = e < end ? __ldg(a.col + e) : 0;
          }
          // a value is read only for a sent edge
#pragma unroll
          for (int b = 0; b < kSparseSpan / 32; ++b) {
            const int e = base + 32 * b + lane;
            on[b] = e < end && __ldg(a.sent + cl[b]) != 0;
            vl[b] = on[b] ? __ldg(a.val + e) : 0.0f;
          }
#pragma unroll
          for (int b = 0; b < kSparseSpan / 32; ++b) {
            const unsigned m = __ballot_sync(0xffffffffu, on[b]);
            if (on[b]) {
              const int pos = q + __popc(m & ((1u << lane) - 1u));
              s_col[wib][pos] = cl[b];
              s_val[wib][pos] = vl[b];
            }
            q += __popc(m);
          }
#pragma unroll
          for (int b = 0; b < kSparseSpan / 32; ++b) cl[b] = nx_cl[b];
        }
        if (q >= 32 || (last && q > 0)) {
          __syncwarp();
          hand_out(q, [&](int j, bool ok, int& s, float& v) {
            s = ok ? s_col[wib][j] : 0;
            v = ok ? s_val[wib][j] : 0.0f;
          });
          q = 0;
          __syncwarp();   // the buffer is refilled next
        }
        if (last) break;
      }
    } else {
      // 64 edges at a time, lane l holding edges l and 32 + l; the next
      // 64 load while these are worked
      int cl[2];
      float vl[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int e = start + 32 * b + lane;
        cl[b] = e < end ? __ldg(a.col + e) : 0;
        vl[b] = e < end ? __ldg(a.val + e) : 0.0f;
      }
      for (int base = start; base < end; base += kDenseSpan) {
        int nx_cl[2];
        float nx_vl[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = base + kDenseSpan + 32 * b + lane;
          nx_cl[b] = e < end ? __ldg(a.col + e) : 0;
          nx_vl[b] = e < end ? __ldg(a.val + e) : 0.0f;
        }
        hand_out(min(kDenseSpan, end - base),
                 [&](int j, bool ok, int& s, float& v) {
                   const int s0 = __shfl_sync(0xffffffffu, cl[0], j & 31);
                   const int s1 = __shfl_sync(0xffffffffu, cl[1], j & 31);
                   const float v0 = __shfl_sync(0xffffffffu, vl[0], j & 31);
                   const float v1 = __shfl_sync(0xffffffffu, vl[1], j & 31);
                   s = !ok ? 0 : j < 32 ? s0 : s1;
                   v = !ok ? 0.0f : j < 32 ? v0 : v1;
                 });
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          cl[b] = nx_cl[b];
          vl[b] = nx_vl[b];
        }
      }
    }
    if (SPARSE && lane == 0) {
      if (kChunk)
        a.part_cnt[item] = cnt;
      else
        a.got[row] = cnt;
    }

    // a row's sum goes to y, a chunk's partial to its row of part
    const bool scalar_out = OP == kSgdSqerr || OP == kLdaLoglik;
    const int w = scalar_out ? 1 : nc;
    if (OP == kLdaInit && kChunk) {   // kept in double until combined
      double* pr =
          static_cast<double*>(a.part) + static_cast<size_t>(item) * w;
#pragma unroll
      for (int q = 0; q < C; ++q)
        dacc[q] = cnt == 0 ? 0.0 : xor_sum(dacc[q], G, 32);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i % NG != grp) continue;   // one group per float4
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (comp(i, j) < nc) pr[comp(i, j)] = dacc[4 * i + j];
      }
      return;
    }
    float* yr = kChunk ? static_cast<float*>(a.part) +
                             static_cast<size_t>(item) * w
                       : a.y + static_cast<size_t>(row) * w;
    const bool yvec = kChunk ? a.pvec : a.yvec;
    if (cnt == 0) {   // no (sent) edge: 0, the bits the tree would give
      if (scalar_out) {
        if (lane == 0) yr[0] = 0.0f;
      } else {
        for (int c = lane; c < nc; c += 32) yr[c] = 0.0f;
      }
      return;
    }
    // the groups' partial sums meet in a fixed xor tree
    if (scalar_out) {
      const float r = xor_sum(acc[0], G, 32);
      if (lane == 0) yr[0] = r;
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (OP == kLdaInit)
          acc[q] = static_cast<float>(xor_sum(dacc[q], G, 32));
        else
          acc[q] = xor_sum(acc[q], G, 32);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c0 = comp(i, 0);
        if (i % NG != grp || c0 >= nc) continue;   // one group per float4
        if (yvec) {
          *reinterpret_cast<float4*>(yr + c0) = make_float4(
              acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < nc) yr[c0 + j] = acc[4 * i + j];
        }
      }
    }
  };

  // the chunks first, then the rows as before: row it - n_chunks, with
  // the next row's extent in flight; a row of more than C edges is its
  // chunks' work
  int it = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int nx_row = it < a.n_chunks ? __ldg(a.chunk_row + it) : 0;
  int nx_start = it < a.n_chunks ? __ldg(a.chunk_start + it) : 0;
  for (; it < a.n_chunks; it += nwarps) {
    const int row = nx_row, start = nx_start;
    const int row_end = __ldg(a.rowptr + row + 1);
    if (it + nwarps < a.n_chunks) {
      nx_row = __ldg(a.chunk_row + it + nwarps);
      nx_start = __ldg(a.chunk_start + it + nwarps);
    }
    walk(row, start,
         row_end - start <= kChunkEdges ? row_end : start + kChunkEdges, it,
         std::true_type());
  }
  int row = it - a.n_chunks;
  nx_start = row < a.n_rows ? __ldg(a.rowptr + row) : 0;
  int nx_end = row < a.n_rows ? __ldg(a.rowptr + row + 1) : 0;
  for (; row < a.n_rows; row += nwarps) {
    const int start = nx_start, end = nx_end;
    if (row + nwarps < a.n_rows) {
      nx_start = __ldg(a.rowptr + row + nwarps);
      nx_end = __ldg(a.rowptr + row + nwarps + 1);
    }
    if (end - start <= kChunkEdges)
      walk(row, start, end, row, std::false_type());
  }
}

// ------------------------------------------------ slab kernel, width > 256

// One warp per receiver row walking its edges one at a time; lane holds
// components c0 + lane + 32 t of the slab at c0.  Vector ops accumulate
// in y's row (the warp owns it).
template <int OP, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k3_slabs(const Args a) {
  const int lane = threadIdx.x & 31;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int nc = a.nc;
  const int k = a.k;
  Jump jmp0[4] = {{1u, 0u}, {1u, 0u}, {1u, 0u}, {1u, 0u}};
  Jump slab_step{1u, 0u};   // lda_init: jumps of components lane + 32 t,
  if (OP == kLdaInit) {     // and the step from one slab to the next
#pragma unroll
    for (int t = 0; t < 4; ++t)
      jmp0[t] = lcg_jump(3u * static_cast<uint32_t>(lane + 32 * t));
    slab_step = lcg_jump(3u * kSlab);
  }

  int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int nx_start = row < a.n_rows ? __ldg(a.rowptr + row) : 0;
  int nx_end = row < a.n_rows ? __ldg(a.rowptr + row + 1) : 0;
  for (; row < a.n_rows; row += nwarps) {
    // the warp's next row's extent loads while this row is worked
    const int start = nx_start, end = nx_end;
    if (row + nwarps < a.n_rows) {
      nx_start = __ldg(a.rowptr + row + nwarps);
      nx_end = __ldg(a.rowptr + row + nwarps + 1);
    }
    const float* vpr = a.vp + static_cast<size_t>(row) * k;
    float* yr = a.y + static_cast<size_t>(row) * nc;
    const bool vector_out = OP == kSgd || OP == kLdaInit || OP == kLda;
    if (vector_out)
      for (int c = lane; c < nc; c += 32) yr[c] = 0.0f;
    float my_off = 0.0f, other_off = 0.0f;
    if (OP == kLda) {
      const bool is_doc = __ldg(vpr + (k - 1)) > 0.5f;
      my_off = is_doc ? a.s0 : a.s1;
      other_off = is_doc ? a.s1 : a.s0;
    }
    float acc = 0.0f;

    // each op's per-component value: pass 1 sums it, pass 2 uses it
    auto edge = [&](int s, float v) {
      const float* xs = a.x + static_cast<size_t>(s) * a.ldx;
      const uint32_t seed = static_cast<uint32_t>(static_cast<int>(v));
      // pass 1: the in-row sum
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      Jump jm[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) jm[t] = jmp0[t];
      for (int c0 = 0; c0 < nc; c0 += kSlab) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = c0 + lane + 32 * t;
          if (c >= nc) continue;
          if (OP == kSgd || OP == kSgdSqerr)
            p[t] += __ldg(xs + c) * __ldg(vpr + c);
          if (OP == kLdaInit) p[t] += rand_r_uniform(jm[t].a * seed + jm[t].c);
          if (OP == kLda)
            p[t] += (((__ldg(vpr + c) + my_off) - 1.0f) *
                     (1.0f / (__ldg(a.extra + c) + a.s2))) *
                    ((__ldg(xs + c) + other_off) - 1.0f);
          if (OP == kLdaLoglik) p[t] += __ldg(xs + c) + a.s0;
        }
        if (OP == kLdaInit) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            jm[t] = Jump{slab_step.a * jm[t].a,
                         slab_step.a * jm[t].c + slab_step.c};
        }
      }
      const float sum = warp_sum((p[0] + p[1]) + (p[2] + p[3]));
      if (OP == kSgdSqerr) {
        const float err = v - sum;
        acc += err * err;
        return;
      }
      // pass 2: the terms
      const float err = v - sum;         // sgd
      const float scale = v / sum;       // lda
#pragma unroll
      for (int t = 0; t < 4; ++t) jm[t] = jmp0[t];
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c0 = 0; c0 < nc; c0 += kSlab) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = c0 + lane + 32 * t;
          if (c >= nc) continue;
          if (OP == kSgd) yr[c] += __ldg(xs + c) * err;
          if (OP == kLdaInit)
            yr[c] += (rand_r_uniform(jm[t].a * seed + jm[t].c) / sum) * v;
          if (OP == kLda)
            yr[c] += ((((__ldg(vpr + c) + my_off) - 1.0f) *
                       (1.0f / (__ldg(a.extra + c) + a.s2))) *
                      ((__ldg(xs + c) + other_off) - 1.0f)) *
                     scale;
          if (OP == kLdaLoglik)
            d[t] += ((__ldg(vpr + c) + a.s0) / __ldg(a.extra + c)) *
                    ((__ldg(xs + c) + a.s0) / sum);
        }
        if (OP == kLdaInit) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            jm[t] = Jump{slab_step.a * jm[t].a,
                         slab_step.a * jm[t].c + slab_step.c};
        }
      }
      if (OP == kLdaLoglik)
        acc += v * logf(warp_sum((d[0] + d[1]) + (d[2] + d[3])));
    };

    int cnt = 0;
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      const int my_col = e < end ? __ldg(a.col + e) : 0;
      const float my_val = e < end ? __ldg(a.val + e) : 0.0f;
      if (SPARSE) {
        unsigned m = __ballot_sync(
            0xffffffffu, e < end && __ldg(a.sent + my_col) != 0);
        cnt += __popc(m);
        while (m != 0u) {   // m is the same in every lane
          const int j = __ffs(m) - 1;
          m &= m - 1u;
          edge(__shfl_sync(0xffffffffu, my_col, j),
               __shfl_sync(0xffffffffu, my_val, j));
        }
      } else {
        const int n = min(32, end - base);
        for (int j = 0; j < n; ++j)
          edge(__shfl_sync(0xffffffffu, my_col, j),
               __shfl_sync(0xffffffffu, my_val, j));
      }
    }
    if (SPARSE && lane == 0) a.got[row] = cnt;
    if (!vector_out && lane == 0) a.y[row] = acc;
  }
}

// One thread per component of a long row: its chunks' partials summed in
// chunk order (T double for lda_init, rounded once), and in the sparse
// mode its count.
template <typename T, bool SPARSE>
__global__ void __launch_bounds__(kCombineThreads)
k3_combine(const Args a, int w) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(a.n_long) * w) return;
  const int h = static_cast<int>(t / w), q = static_cast<int>(t % w);
  const int row = __ldg(a.long_rows + h);
  const int first = __ldg(a.long_first + h);
  const int end = __ldg(a.long_first + h + 1);
  const T* p = static_cast<const T*>(a.part) + q;
  T acc = p[static_cast<size_t>(first) * w];
#pragma unroll 8
  for (int c = first + 1; c < end; ++c) acc += p[static_cast<size_t>(c) * w];
  a.y[static_cast<size_t>(row) * w + q] = static_cast<float>(acc);
  if (SPARSE && q == 0) {
    int cnt = 0;
    for (int c = first; c < end; ++c) cnt += a.part_cnt[c];
    a.got[row] = cnt;
  }
}

// One wave of blocks, as many as the card holds at once for this kernel
// (none past a warp per item): each warp walks items i, i + warps, ...
// with the next item's extent in flight.
// The blocks of one wave are counted once per kernel (one card a process).
template <void (*Kernel)(Args)>
void launch_wave(cudaStream_t st, const Args& a, int items) {
  static long long wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                  kWarpsPerBlock * 32, 0);
    wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  const long long need =
      (static_cast<long long>(items) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(need < wave ? need : wave));
  Kernel<<<grid, kWarpsPerBlock * 32, 0, st>>>(a);
}

// The items, then (with long rows) the combine.
template <int OP, int G, int V, bool SPARSE>
void launch_lanes(cudaStream_t st, const Args& a) {
  launch_wave<k3_lanes<OP, G, V, SPARSE>>(st, a, a.n_chunks + a.n_rows);
  if (a.n_long == 0) return;
  using T = typename std::conditional<OP == kLdaInit, double, float>::type;
  const int w = OP == kSgdSqerr || OP == kLdaLoglik ? 1 : a.nc;
  const long long threads = static_cast<long long>(a.n_long) * w;
  k3_combine<T, SPARSE><<<static_cast<unsigned>(
                              (threads + kCombineThreads - 1) /
                              kCombineThreads),
                          kCombineThreads, 0, st>>>(a, w);
}

// layout: 1 and 2 for one lane an edge with that many float4s, 3-7 for
// 2, 4, 8, 16 and 32 lanes an edge with 2 float4s each, 0 for the slab
// kernel
template <int OP, bool SPARSE>
bool launch_op(int layout, cudaStream_t st, const Args& a) {
  switch (layout) {
    case 0: launch_wave<k3_slabs<OP, SPARSE>>(st, a, a.n_rows); return true;
    case 1: launch_lanes<OP, 1, 1, SPARSE>(st, a); return true;
    case 2: launch_lanes<OP, 1, 2, SPARSE>(st, a); return true;
    case 3: launch_lanes<OP, 2, 2, SPARSE>(st, a); return true;
    case 4: launch_lanes<OP, 4, 2, SPARSE>(st, a); return true;
    case 5: launch_lanes<OP, 8, 2, SPARSE>(st, a); return true;
    case 6: launch_lanes<OP, 16, 2, SPARSE>(st, a); return true;
    case 7: launch_lanes<OP, 32, 2, SPARSE>(st, a); return true;
  }
  return false;
}

template <bool SPARSE>
bool launch_mode(int op, int layout, cudaStream_t st, const Args& a) {
  switch (op) {
    case kSgd: return launch_op<kSgd, SPARSE>(layout, st, a);
    case kSgdSqerr: return launch_op<kSgdSqerr, SPARSE>(layout, st, a);
    case kLdaInit: return launch_op<kLdaInit, SPARSE>(layout, st, a);
    case kLda: return launch_op<kLda, SPARSE>(layout, st, a);
    case kLdaLoglik: return launch_op<kLdaLoglik, SPARSE>(layout, st, a);
  }
  return false;
}

}  // namespace

// One launch of K3 (two with long rows).  op: 0 sgd, 1 sgd_sqerr,
// 2 lda_init, 3 lda, 4 lda_loglik.  k is the row width of x and vp (for
// lda the topics plus the flag column); x's rows are ldx >= k floats
// apart, vp's k.  vp may be null for lda_init, extra for the ops other
// than lda and lda_loglik.  y holds n_rows rows of the op's output width.
// sent (one byte per sender) and got (one int32 per row) are both null for
// the dense mode and both given for the sparse mode.  Rows up to 256
// components wide take the chunks of K1's split of rowptr (ops/spmv2u.py:
// k1_plan; n_chunks and n_long 0 where no row holds more than C edges):
// chunk_row and chunk_start int32[n_chunks], long_rows int32[n_long]
// (every row of more than C edges), long_first int32[n_long + 1]; part
// the chunks' partials, [n_chunks, out width] float32 (float64 for
// lda_init), and part_cnt int32[n_chunks] in the sparse mode.  The slab
// kernel reads none of these.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gm_spmv_vec2(const void* rowptr, const void* col,
                            const void* val, const void* x, const void* vp,
                            const void* extra, const void* sent, void* y,
                            void* got, const void* chunk_row,
                            const void* chunk_start, const void* long_rows,
                            const void* long_first, void* part,
                            void* part_cnt, int n_rows, int n_chunks,
                            int n_long, int k, int ldx, int op, float s0,
                            float s1, float s2, void* stream) {
  const int nc = op == kLda ? k - 1 : k;
  if (n_rows <= 0 || nc < 1 || ldx < k || op < kSgd || op > kLdaLoglik ||
      k > 0x7fffffff - kSlab)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op != kLdaInit && vp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((op == kLda || op == kLdaLoglik) && extra == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((sent == nullptr) != (got == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the register layout: one lane an edge with ceil(nc / 4) float4s up
  // to 8 components, then the fewest lanes (2, 4, ..., 32) with 2 float4s
  // each; wider rows: the slab kernel
  int layout = nc <= 4 * kMaxV ? (nc + 3) / 4 : 0;
  for (int g = 2, l = 3; layout == 0 && g <= kMaxG; g <<= 1, ++l)
    if (nc <= 4 * kMaxV * g) layout = l;
  if (layout != 0 &&
      (n_long < 0 || n_chunks < n_long || n_long > n_rows ||
       (n_chunks > 0) != (n_long > 0) ||
       static_cast<long long>(n_rows) + n_chunks > 0x7fffffff ||
       (n_chunks > 0 && (chunk_row == nullptr || chunk_start == nullptr ||
                         long_rows == nullptr || long_first == nullptr ||
                         part == nullptr ||
                         (sent != nullptr && part_cnt == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xvec = ldx % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vpvec = k % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const bool yvec = nc % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool pvec = nc % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0;
  const Args a{static_cast<const int*>(rowptr),
               static_cast<const int*>(col),
               static_cast<const float*>(val),
               static_cast<const float*>(x),
               static_cast<const float*>(vp),
               static_cast<const float*>(extra),
               static_cast<const uint8_t*>(sent),
               static_cast<float*>(y),
               static_cast<int*>(got),
               n_rows, k, ldx, nc, xvec, vpvec, yvec, s0, s1, s2,
               static_cast<const int*>(chunk_row),
               static_cast<const int*>(chunk_start),
               static_cast<const int*>(long_rows),
               static_cast<const int*>(long_first),
               part,
               static_cast<int*>(part_cnt),
               n_chunks, n_long, pvec};
  const bool ok = sent != nullptr
                      ? launch_mode<true>(op, layout, st, a)
                      : launch_mode<false>(op, layout, st, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
