// K2: the compaction gather  out[p] = x[src_of_pos[p]]  on Hopper.
//
// Replaces the TPU kernel graphmat_tpu/ops/pallas_compact.py:_make_aux_kernel
// (driven by _aux_impl and aux_gather).  There it builds, once per
// super-block of receivers, a compacted copy of the operand values that the
// block's straggler edges read, so the SpMV walks dense windows.  Here it
// computes the same function on a flat operand: position p of the extension
// takes the value of sender src_of_pos[p], and the SpMV reads the
// extension as senders n_send + p.  No lanes, no 8-row granules, no window
// classes: one thread per position, grid-stride.
//
// What bounds it on an H100: bytes.  Per position it streams src_of_pos
// (4 B) and out (4 B, or 1 B for the sent mask) and gathers one x value
// from senders sorted ascending within a super-block, so the gathers of a
// warp fall on few sectors; the operand (16 MB at RMAT-22) sits in L2.
// It copies bits: a 4-byte element moves as uint32, so a float arrives
// bitwise unchanged, and 1-byte elements carry the SpMV's sent mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void aux_gather_kernel(const T* __restrict__ x,
                                  const int* __restrict__ src,
                                  T* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n; p += stride) {
    out[p] = __ldg(x + __ldg(src + p));
  }
}

}  // namespace

// One launch of K2 over n positions of elem_bytes (4 or 1) each.  Returns
// cudaGetLastError().
extern "C" int gm_aux_gather(const void* x, const void* src, void* out,
                             long long n, int elem_bytes, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  switch (elem_bytes) {
    case 4:
      aux_gather_kernel<uint32_t><<<static_cast<unsigned>(blocks), threads, 0,
                                    st>>>(static_cast<const uint32_t*>(x), s,
                                          static_cast<uint32_t*>(out), n);
      break;
    case 1:
      aux_gather_kernel<uint8_t><<<static_cast<unsigned>(blocks), threads, 0,
                                   st>>>(static_cast<const uint8_t*>(x), s,
                                         static_cast<uint8_t*>(out), n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
