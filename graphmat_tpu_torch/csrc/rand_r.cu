// glibc rand_r's uniform draw on Hopper: the initial factors of SGD.
//
// It replaces no Pallas kernel.  The JAX package draws SGD's initial
// factors on the host (graphmat_tpu/apps/sgd.py: init_sgd_graph, through
// utils/reference_rng.py: rand_r_uniform_np), as the reference does
// (src/SGD.cpp:176-184): vertex v's k factors are k successive
// rand_r(&s) / RAND_MAX with s seeded v + 1.  On the host that draw and
// its upload held three quarters of an SGD job at MovieLens-25M shape;
// each vertex's stream is its own, so the card draws every row at once.
//
// The values are bit for bit those of rand_r_uniform_np: one rand_r is
// three LCG steps s = s * 1103515245 + 12345 (mod 2^32) giving 11 + 10 +
// 10 bits, divided by 2147483647.0 in float64 (IEEE division, as numpy's)
// and, for float32, rounded once to nearest (__double2float_rn, as
// numpy's astype).  This is not lda_init's float32 draw in spmv_vec2.cu,
// which multiplies by 2^-31 in float32 and gives other bits.
//
// What bounds it on an H100: writing the n x k values (17.7 MB in float32
// at MovieLens-25M shape, K = 20: 5.3 us at 3.35 TB/s).  The design: a
// block owns kRows consecutive rows and one thread a row, which carries
// its rand_r state from one value to the next as glibc does (no jump, no
// per-value division of an index); a row's values go to shared memory a
// chunk of at most kCols columns at a time, and the block then writes the
// chunk's rows out together, consecutive threads on consecutive words.
// For k <= kCols the block's whole output is one contiguous run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows a block, one thread each
constexpr int kCols = 32;    // columns staged in shared memory at a time
constexpr uint32_t kLcgA = 1103515245u;
constexpr uint32_t kLcgC = 12345u;

__device__ __forceinline__ uint32_t rand_r_step(uint32_t& s) {
  s = s * kLcgA + kLcgC;
  uint32_t r = (s >> 16) & 2047u;
  s = s * kLcgA + kLcgC;
  r = (r << 10) ^ ((s >> 16) & 1023u);
  s = s * kLcgA + kLcgC;
  return (r << 10) ^ ((s >> 16) & 1023u);
}

template <typename T>
__device__ __forceinline__ T from_double(double x);

template <>
__device__ __forceinline__ float from_double<float>(double x) {
  return __double2float_rn(x);
}

template <>
__device__ __forceinline__ double from_double<double>(double x) {
  return x;
}

// out[v, j] = rand_r_j(first_seed + v) / RAND_MAX for v < n, j < k.
template <typename T>
__global__ void __launch_bounds__(kRows)
rand_r_uniform_kernel(uint32_t first_seed, long long n, int k,
                      T* __restrict__ out) {
  __shared__ T tile[kRows][kCols + 1];   // +1: a row's words on other banks
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = n - r0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const int t = threadIdx.x;
  uint32_t s = first_seed + static_cast<uint32_t>(r0 + t);
  for (int c0 = 0; c0 < k; c0 += kCols) {
    const int kc = k - c0 < kCols ? k - c0 : kCols;
    if (t < rows)
      for (int j = 0; j < kc; ++j)
        tile[t][j] = from_double<T>(
            static_cast<double>(rand_r_step(s)) / 2147483647.0);
    __syncthreads();
    T* dst = out + r0 * k + c0;
    for (int e = t; e < rows * kc; e += kRows) {
      const int row = e / kc;
      const int col = e - row * kc;
      dst[static_cast<long long>(row) * k + col] = tile[row][col];
    }
    __syncthreads();
  }
}

}  // namespace

// One launch that writes out[v * k + j], v < n, j < k, the j-th uniform
// of rand_r seeded first_seed + v (mod 2^32): float32 when f64 is 0,
// float64 otherwise.  Returns a CUDA error code: cudaGetLastError() after
// the launch.
extern "C" int gm_rand_r_uniform(unsigned int first_seed, long long n, int k,
                                 int f64, void* out, void* stream) {
  if (n <= 0 || k <= 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kRows - 1) / kRows;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    rand_r_uniform_kernel<double><<<grid, kRows, 0, st>>>(
        first_seed, n, k, static_cast<double*>(out));
  else
    rand_r_uniform_kernel<float><<<grid, kRows, 0, st>>>(
        first_seed, n, k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
