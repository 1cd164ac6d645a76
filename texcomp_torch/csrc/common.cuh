// Helpers that every source under texcomp_torch/csrc shares.

#pragma once

#include <cuda_runtime.h>

namespace texcomp {

// Registers per thread, static shared memory in bytes, and resident CTAs
// of `threads` per SM of kernel fn, into out[0..2]; a cudaError_t.
inline int kernel_info(const void* fn, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = attr.numRegs;
  out[1] = int(attr.sharedSizeBytes);
  out[2] = ctas;
  return 0;
}

}  // namespace texcomp
