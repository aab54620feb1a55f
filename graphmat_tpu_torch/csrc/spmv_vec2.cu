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
// row with no sent edge writes 0 and a count of 0.  The input is
// the receiver CSR of graphmat_tpu_torch (rowptr over receivers, col =
// sender of each edge, edges sorted by (receiver, sender)); x is
// [n_send, k] and vp [n_rows, k], both row-major float32.
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
// What bounds it on an H100: per edge it gathers one k-float row of x
// (80 B at k = 20, three 32-B sectors) and runs one or two in-row
// reductions across the k components.  At the slice's sizes x is 18-34 MB
// and stays in the 50 MB L2; col and val (8 B per edge) stream from HBM.
// The design: one warp per receiver row.  The receiver is fixed along the
// row, so vp[r, :], the extra operand and whatever depends only on them
// are loaded or computed once per row into registers (the receiver gather
// the TPU built its windows for disappears).  Lane j holds components j,
// j + 32, ... (at most kMaxPerLane, so k <= 160).  The row's edges are
// read 32 at a time, coalesced, and broadcast by shuffle; each edge's x
// row is a coalesced load across the lanes; the in-row dot products and
// normalisations are xor-shuffle trees, which leave the same value in
// every lane.  Each lane sums its components in registers in edge order
// and writes y[r, :] once: no atomics, so a sum is bitwise repeatable.  A
// row with no edges writes 0.  Long rows run on one warp; load balancing
// is later work, as for K1.
//
// The sparse mode keeps that structure.  For each group of 32 edges each
// lane loads its edge's sender flag (a dependent byte gather); a ballot
// skips the group when no sender in it sent, else the warp walks only the
// set bits, lowest first, so edges are summed in the dense mode's order:
// with every sender sent the two modes give the same bits.  The popcount
// of the ballots is the row's got count, written once by lane 0: K5's one
// use in the JAX engine costs no second pass.  At a sparse frontier the
// walk over col still reads every edge of the row; a frontier worklist is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kSgd = 0, kSgdSqerr = 1, kLdaInit = 2, kLda = 3, kLdaLoglik = 4 };

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 5;  // k <= 32 * kMaxPerLane = 160
constexpr uint32_t kLcgA = 1103515245u;
constexpr uint32_t kLcgC = 12345u;
constexpr float kInvRandMaxF32 = 4.656612873077392578125e-10f;  // 2^-31

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The op's number of components (the width of the per-edge vectors).
template <int OP>
__device__ __forceinline__ int components(int k) {
  return OP == kLda ? k - 1 : k;
}

// glibc rand_r from a state already advanced by the lane's jump: three LCG
// steps, 11 + 10 + 10 bits.  Divided by float32(RAND_MAX) = 2^31 as the
// JAX package does, which is exact.
__device__ __forceinline__ float rand_r_uniform(uint32_t st) {
  st = st * kLcgA + kLcgC;
  uint32_t r = (st >> 16) & 2047u;
  st = st * kLcgA + kLcgC;
  r = (r << 10) ^ ((st >> 16) & 1023u);
  st = st * kLcgA + kLcgC;
  r = (r << 10) ^ ((st >> 16) & 1023u);
  return __int2float_rn(static_cast<int>(r)) * kInvRandMaxF32;
}

// s0, s1, s2: for lda, alpha, eta and V * (eta - 1); for lda_loglik,
// eta - 1; unused otherwise.
template <int OP, int NPL, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_vec2_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                 const float* __restrict__ val, const float* __restrict__ x,
                 const float* __restrict__ vp,
                 const float* __restrict__ extra,
                 const uint8_t* __restrict__ sent, float* __restrict__ y,
                 int* __restrict__ got, int n_rows, int k, float s0,
                 float s1, float s2) {
  const int lane = threadIdx.x & 31;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int nc = components<OP>(k);

  bool live[NPL];
  float ex[NPL];        // per-component constant from extra
  uint32_t jump_a[NPL];  // lda_init: LCG state after 3 * c steps is
  uint32_t jump_c[NPL];  //   jump_a * seed + jump_c (mod 2^32)
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    live[i] = c < nc;
    ex[i] = 0.0f;
    if (OP == kLda && live[i]) ex[i] = __ldg(extra + c) + s2;
    if (OP == kLdaLoglik && live[i]) ex[i] = __ldg(extra + c);
    jump_a[i] = 1u;
    jump_c[i] = 0u;
    if (OP == kLdaInit && live[i]) {
      // topics advance the LCG in global order: topic c starts 3c steps in
      for (int s = 0; s < 3 * c; ++s) {
        jump_c[i] = jump_c[i] * kLcgA + kLcgC;
        jump_a[i] = jump_a[i] * kLcgA;
      }
    }
  }

  for (int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < n_rows;
       row += nwarps) {
    const int start = __ldg(rowptr + row);
    const int end = __ldg(rowptr + row + 1);
    const size_t rk = static_cast<size_t>(row) * k;

    // what depends on the receiver alone
    float rv[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      rv[i] = 0.0f;
      if (OP != kLdaInit && live[i]) rv[i] = __ldg(vp + rk + lane + 32 * i);
    }
    float other_off = 0.0f;
    if (OP == kLda) {
      const bool is_doc = __ldg(vp + rk + (k - 1)) > 0.5f;
      const float my_off = is_doc ? s0 : s1;
      other_off = is_doc ? s1 : s0;
#pragma unroll
      for (int i = 0; i < NPL; ++i) rv[i] = (rv[i] + my_off) - 1.0f;
    }
    if (OP == kLdaLoglik) {
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (live[i]) rv[i] = (rv[i] + s0) / ex[i];  // phi
    }

    float acc[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] = 0.0f;

    // one edge: sender s, value v; the same code for both modes
    auto edge = [&](int s, float v) {
      const float* xs = x + static_cast<size_t>(s) * k + lane;
      float xv[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        xv[i] = (OP != kLdaInit && live[i]) ? __ldg(xs + 32 * i) : 0.0f;

      if (OP == kSgd || OP == kSgdSqerr) {
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) d += xv[i] * rv[i];
        const float err = v - warp_sum(d);
        if (OP == kSgd) {
#pragma unroll
          for (int i = 0; i < NPL; ++i) acc[i] += xv[i] * err;
        } else {
          acc[0] += err * err;
        }
      } else if (OP == kLdaInit || OP == kLda) {
        float g[NPL];
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          g[i] = 0.0f;
          if (live[i]) {
            if (OP == kLdaInit) {
              const uint32_t seed =
                  static_cast<uint32_t>(static_cast<int>(v));
              g[i] = rand_r_uniform(jump_a[i] * seed + jump_c[i]);
            } else {
              g[i] = (rv[i] * ((xv[i] + other_off) - 1.0f)) / ex[i];
            }
          }
          t += g[i];
        }
        const float tot = warp_sum(t);
#pragma unroll
        for (int i = 0; i < NPL; ++i) acc[i] += (g[i] / tot) * v;
      } else {  // kLdaLoglik
        float th[NPL];
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          th[i] = live[i] ? xv[i] + s0 : 0.0f;
          t += th[i];
        }
        const float th_tot = warp_sum(t);
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (live[i]) d += rv[i] * (th[i] / th_tot);
        acc[0] += v * logf(warp_sum(d));
      }
    };

    int cnt = 0;
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      const int my_col = e < end ? __ldg(col + e) : 0;
      const float my_val = e < end ? __ldg(val + e) : 0.0f;
      if (SPARSE) {
        unsigned m = __ballot_sync(
            0xffffffffu, e < end && __ldg(sent + my_col) != 0);
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
    if (SPARSE && lane == 0) got[row] = cnt;

    if (OP == kSgdSqerr || OP == kLdaLoglik) {
      if (lane == 0) y[row] = acc[0];  // every lane holds the same sum
    } else {
      float* yr = y + static_cast<size_t>(row) * nc + lane;
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (live[i]) yr[32 * i] = acc[i];
    }
  }
}

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
  int n_rows, k;
  float s0, s1, s2;
};

template <int OP, int NPL, bool SPARSE>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  spmv_vec2_kernel<OP, NPL, SPARSE><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      a.rowptr, a.col, a.val, a.x, a.vp, a.extra, a.sent, a.y, a.got,
      a.n_rows, a.k, a.s0, a.s1, a.s2);
}

template <int OP, bool SPARSE>
bool launch_width(int npl, dim3 grid, cudaStream_t st, const Args& a) {
  switch (npl) {
    case 1: launch<OP, 1, SPARSE>(grid, st, a); return true;
    case 2: launch<OP, 2, SPARSE>(grid, st, a); return true;
    case 3: launch<OP, 3, SPARSE>(grid, st, a); return true;
    case 4: launch<OP, 4, SPARSE>(grid, st, a); return true;
    case 5: launch<OP, 5, SPARSE>(grid, st, a); return true;
  }
  return false;
}

template <bool SPARSE>
bool launch_op(int op, int npl, dim3 grid, cudaStream_t st, const Args& a) {
  switch (op) {
    case kSgd: return launch_width<kSgd, SPARSE>(npl, grid, st, a);
    case kSgdSqerr: return launch_width<kSgdSqerr, SPARSE>(npl, grid, st, a);
    case kLdaInit: return launch_width<kLdaInit, SPARSE>(npl, grid, st, a);
    case kLda: return launch_width<kLda, SPARSE>(npl, grid, st, a);
    case kLdaLoglik:
      return launch_width<kLdaLoglik, SPARSE>(npl, grid, st, a);
  }
  return false;
}

}  // namespace

// One launch of K3.  op: 0 sgd, 1 sgd_sqerr, 2 lda_init, 3 lda,
// 4 lda_loglik.  k is the row width of x and vp (for lda the topics plus
// the flag column), at most 160.  vp may be null for lda_init, extra for
// the ops other than lda and lda_loglik.  y holds n_rows rows of the op's
// output width.  sent (one byte per sender) and got (one int32 per row)
// are both null for the dense mode and both given for the sparse mode.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int gm_spmv_vec2(const void* rowptr, const void* col,
                            const void* val, const void* x, const void* vp,
                            const void* extra, const void* sent, void* y,
                            void* got, int n_rows, int k, int op, float s0,
                            float s1, float s2, void* stream) {
  const int nc = op == kLda ? k - 1 : k;
  if (n_rows <= 0 || nc < 1 || k > 32 * kMaxPerLane || op < kSgd ||
      op > kLdaLoglik)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op != kLdaInit && vp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((op == kLda || op == kLdaLoglik) && extra == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((sent == nullptr) != (got == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npl = (nc + 31) / 32;
  // a warp per row up to 2^23 rows; beyond that the warps stride over rows
  int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const dim3 grid(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const int*>(rowptr),
               static_cast<const int*>(col),
               static_cast<const float*>(val),
               static_cast<const float*>(x),
               static_cast<const float*>(vp),
               static_cast<const float*>(extra),
               static_cast<const uint8_t*>(sent),
               static_cast<float*>(y),
               static_cast<int*>(got),
               n_rows, k, s0, s1, s2};
  const bool ok = sent != nullptr ? launch_op<true>(op, npl, grid, st, a)
                                  : launch_op<false>(op, npl, grid, st, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
