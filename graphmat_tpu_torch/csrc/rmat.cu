// The RMAT edge stream on Hopper: gm_rmat_gen's keys and weights.
//
// It replaces no Pallas kernel.  It is the counterpart of the JAX
// package's C++/OpenMP generator gm_rmat_gen
// (graphmat_tpu/native/planner.cpp:1627-1697), which
// graphmat_tpu/utils/generators.py: rmat_edgelist draws from by default,
// and it keeps a draw of 67M edges (RMAT-22 x 16) on the card: the host
// would take seconds and a 537 MB upload.
//
// Edge i of a draw is counter-based: its state starts at
//     splitmix64(seed * 0xD1342543DE82EF95 + i),
// and each of `scale` levels takes the next splitmix64 word x: r1 is its
// high 32 bits times 2^-32, r2 its low 32 bits times 2^-32, compared in
// float64 with a + b, c / (1 - a - b) and a / (a + b).  The sender and
// receiver bits of the level are shifted in, and the key is (s << 32) | d
// (0-based ids).  A kept edge's weight is 1 + splitmix64(seed ^ key) %
// weight_range.  The sort, the drop of self loops and duplicates and the
// compaction are torch's on the card (utils/generators.py).
//
// What bounds it on an H100: writing 8 B a key (537 MB at RMAT-22: 0.16
// ms at 3.35 TB/s).  Its integer work, `scale` 64-bit splitmix64 rounds
// an edge, has no rate in the card's table (its 64-bit products are
// several 32-bit instructions each), so the bound the repo reports is the
// bytes.  The design: one thread an edge, the grid a few blocks for each
// SM walking the edges grid-stride; every thread's stores are consecutive
// 8-byte words, so a warp writes whole sectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(kThreads)
rmat_keys_kernel(int scale, long long nnz, double ab, double c_norm,
                 double a_norm, uint64_t seed, uint64_t* __restrict__ keys) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint64_t base = seed * 0xD1342543DE82EF95ULL;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nnz; i += stride) {
    uint64_t state = splitmix64(base + static_cast<uint64_t>(i));
    uint32_t s = 0;
    uint32_t d = 0;
    for (int lvl = 0; lvl < scale; ++lvl) {
      const uint64_t x = state = splitmix64(state);
      const double r1 = static_cast<uint32_t>(x >> 32) * 0x1.0p-32;
      const double r2 = static_cast<uint32_t>(x) * 0x1.0p-32;
      const uint32_t sb = r1 > ab;
      const uint32_t db = sb ? (r2 > c_norm) : (r2 > a_norm);
      s = (s << 1) | sb;
      d = (d << 1) | db;
    }
    keys[i] = (static_cast<uint64_t>(s) << 32) | d;
  }
}

__global__ void __launch_bounds__(kThreads)
rmat_weights_kernel(const uint64_t* __restrict__ keys, long long m,
                    uint64_t seed, uint32_t weight_range,
                    int* __restrict__ val) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < m; i += stride)
    val[i] = static_cast<int>(
        1 + splitmix64(seed ^ __ldg(keys + i)) % weight_range);
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

}  // namespace

// One launch that draws the nnz keys of an RMAT-`scale` draw into keys
// (uint64[nnz], in generation order), with the thresholds a + b,
// c / (1 - a - b) and a / (a + b) computed by the caller in float64.
// Returns a CUDA error code: cudaGetLastError() after the launch.
extern "C" int gm_rmat_keys(int scale, long long nnz, double ab,
                            double c_norm, double a_norm,
                            unsigned long long seed, void* keys,
                            void* stream) {
  if (nnz <= 0 || scale < 0 || scale > 31 || keys == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  rmat_keys_kernel<<<grid_for(nnz, sms), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      scale, nnz, ab, c_norm, a_norm, seed, static_cast<uint64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// One launch that writes val[i] = 1 + splitmix64(seed ^ keys[i]) %
// weight_range for the m kept keys (uint64[m]); val: int32[m].
extern "C" int gm_rmat_weights(const void* keys, long long m,
                               unsigned long long seed, int weight_range,
                               void* val, void* stream) {
  if (m <= 0 || weight_range <= 0 || keys == nullptr || val == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  rmat_weights_kernel<<<grid_for(m, sms), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(keys), m, seed,
      static_cast<uint32_t>(weight_range), static_cast<int*>(val));
  return static_cast<int>(cudaGetLastError());
}
