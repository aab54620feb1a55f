// K2: the compaction gather on Hopper,
//
//   out[p] = x[src_of_pos[p]]            (and, fused in the sparse modes,
//   out_sent[p] = sent[src_of_pos[p]])
//
// Replaces the TPU kernel graphmat_tpu/ops/pallas_compact.py:
// _make_aux_kernel (408), which _aux_impl's pallas_call (476) runs for
// aux_gather (488).  There it builds, per super-block of receiver blocks, a
// compacted copy of the operand values that the block's straggler edges
// read, so the SpMV walks dense windows.  Here it builds the same values as
// a flat extension: position p takes the value of sender src_of_pos[p],
// and K1 (csrc/spmv2u.cu) reads a diverted edge's sender n_send + p there.
//
// What bounds it on an H100: bytes, and the latency of the gathers.  Per
// position it reads src_of_pos (4 B), writes the value (4 B) and the sent
// flag (1 B, fused form) and gathers the sectors of x and sent that its
// senders touch; the senders are sorted ascending within a super-block
// (ops/compact.py: divert_stragglers), so a warp's gathers share sectors.
// At RMAT-22 (2.09M positions) that is 24.8 MB, 28.8 MB with the flags:
// 7.4 and 8.6 us at 3.35 TB/s.  On an H100 80GB HBM3 a launch takes about
// three times that, so the gathers' latency and the launch set its time.
//
// The design does three things about that.
//   * It writes only the extension.  K1 reads a sender below n_send from
//     the operand where the send wrote it, so the copy of the whole operand
//     in front of the extension (16.8 MB read and written at RMAT-22, and
//     4.2 MB more for the sent mask) is gone.
//   * One launch per SpMV: in the sparse modes the same launch gathers each
//     position's value and its sent flag from one read of src_of_pos.
//   * Each thread takes 4 consecutive positions: one 16-byte load of
//     src_of_pos, 4 gathers (8 with the flags) issued before any store, one
//     16-byte store of values and one 4-byte store of flags.  The CSR pads
//     src_of_pos to a multiple of 4 positions (sender 0, never read by K1);
//     a count that is not a multiple of 4 ends with one position a thread.
//     The grid is a few blocks for each SM, from the device's SM count, and
//     walks the positions grid-stride.
// It copies bits: values move as uint32, so a NaN payload, -0.0 and +-inf
// arrive unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 threads, the SM's limit
constexpr int kMaxDevices = 64;

template <bool kFlags>
__global__ void __launch_bounds__(kThreads)
aux_gather_kernel(const uint32_t* __restrict__ x,
                  const uint8_t* __restrict__ sent,
                  const int* __restrict__ src, uint32_t* __restrict__ out,
                  uint8_t* __restrict__ out_sent, long long n) {
  const long long quads = n >> 2;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = first; q < quads; q += stride) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(src) + q);
    uint4 v;
    v.x = __ldg(x + s.x);
    v.y = __ldg(x + s.y);
    v.z = __ldg(x + s.z);
    v.w = __ldg(x + s.w);
    uint32_t f = 0;
    if (kFlags) {
      f = static_cast<uint32_t>(__ldg(sent + s.x)) |
          static_cast<uint32_t>(__ldg(sent + s.y)) << 8 |
          static_cast<uint32_t>(__ldg(sent + s.z)) << 16 |
          static_cast<uint32_t>(__ldg(sent + s.w)) << 24;
    }
    reinterpret_cast<uint4*>(out)[q] = v;
    if (kFlags) reinterpret_cast<uint32_t*>(out_sent)[q] = f;
  }
  // the last n % 4 positions, one thread each
  const long long p = (quads << 2) + first;
  if (p < n) {
    const int s = __ldg(src + p);
    out[p] = __ldg(x + s);
    if (kFlags) out_sent[p] = __ldg(sent + s);
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

}  // namespace

// One launch of K2 over n positions: x float32 (moved as bits) to out;
// with sent and out_sent both given (uint8), the flags too.  src and out
// must start on a 16-byte boundary, out_sent on a 4-byte one.  Returns a
// CUDA error code: cudaGetLastError() after the launch.
extern "C" int gm_aux_gather(const void* x, const void* sent, const void* src,
                             void* out, void* out_sent, long long n,
                             void* stream) {
  const bool flags = sent != nullptr;
  if (n <= 0 || flags != (out_sent != nullptr) ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out_sent) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long work = (n >> 2) > 0 ? (n >> 2) : 1;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  const uint8_t* ss = static_cast<const uint8_t*>(sent);
  const int* pos = static_cast<const int*>(src);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint8_t* os = static_cast<uint8_t*>(out_sent);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (flags)
    aux_gather_kernel<true><<<grid, kThreads, 0, st>>>(xs, ss, pos, o, os, n);
  else
    aux_gather_kernel<false><<<grid, kThreads, 0, st>>>(xs, ss, pos, o, os,
                                                        n);
  return static_cast<int>(cudaGetLastError());
}
