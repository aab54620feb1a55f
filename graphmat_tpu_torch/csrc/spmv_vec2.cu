// K3: the K-wide three-operand SpMV on Hopper,
//
//   y[r, :] = sum_{s->r} process(x[s, :], val_e, vp[r, :], extra)
//
// Replaces the TPU kernel graphmat_tpu/ops/pallas_spmv_vec2.py:
// _make_vec2_kernel (driven by _spmv_vec2_seg and spmv_vec2).  It computes
// the same function, not the TPU layout: no V4 rows of four 32-lane slots,
// window classes, WYK receiver windows, rotations, bf16 split planes or
// range-prefix-sum scatter (those served VMEM and the MXU).  The input is
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
template <int OP, int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_vec2_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                 const float* __restrict__ val, const float* __restrict__ x,
                 const float* __restrict__ vp,
                 const float* __restrict__ extra, float* __restrict__ y,
                 int n_rows, int k, float s0, float s1, float s2) {
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

    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      const int my_col = e < end ? __ldg(col + e) : 0;
      const float my_val = e < end ? __ldg(val + e) : 0.0f;
      const int n = min(32, end - base);
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(0xffffffffu, my_col, j);
        const float v = __shfl_sync(0xffffffffu, my_val, j);
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
      }
    }

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
  float* y;
  int n_rows, k;
  float s0, s1, s2;
};

template <int OP, int NPL>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  spmv_vec2_kernel<OP, NPL><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      a.rowptr, a.col, a.val, a.x, a.vp, a.extra, a.y, a.n_rows, a.k, a.s0,
      a.s1, a.s2);
}

template <int OP>
bool launch_width(int npl, dim3 grid, cudaStream_t st, const Args& a) {
  switch (npl) {
    case 1: launch<OP, 1>(grid, st, a); return true;
    case 2: launch<OP, 2>(grid, st, a); return true;
    case 3: launch<OP, 3>(grid, st, a); return true;
    case 4: launch<OP, 4>(grid, st, a); return true;
    case 5: launch<OP, 5>(grid, st, a); return true;
  }
  return false;
}

}  // namespace

// One launch of K3.  op: 0 sgd, 1 sgd_sqerr, 2 lda_init, 3 lda,
// 4 lda_loglik.  k is the row width of x and vp (for lda the topics plus
// the flag column), at most 160.  vp may be null for lda_init, extra for
// the ops other than lda and lda_loglik.  y holds n_rows rows of the op's
// output width.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int gm_spmv_vec2(const void* rowptr, const void* col,
                            const void* val, const void* x, const void* vp,
                            const void* extra, void* y, int n_rows, int k,
                            int op, float s0, float s1, float s2,
                            void* stream) {
  const int nc = op == kLda ? k - 1 : k;
  if (n_rows <= 0 || nc < 1 || k > 32 * kMaxPerLane || op < kSgd ||
      op > kLdaLoglik)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op != kLdaInit && vp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((op == kLda || op == kLdaLoglik) && extra == nullptr)
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
               static_cast<float*>(y),
               n_rows, k, s0, s1, s2};
  bool ok = false;
  switch (op) {
    case kSgd: ok = launch_width<kSgd>(npl, grid, st, a); break;
    case kSgdSqerr: ok = launch_width<kSgdSqerr>(npl, grid, st, a); break;
    case kLdaInit: ok = launch_width<kLdaInit>(npl, grid, st, a); break;
    case kLda: ok = launch_width<kLda>(npl, grid, st, a); break;
    case kLdaLoglik: ok = launch_width<kLdaLoglik>(npl, grid, st, a); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
