// Shared by every kernel source of the port: each source builds into its
// own shared library with a plain C interface (see kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks for a grid of `work` threads at `threads` per block.
static inline unsigned int repro_blocks(long long work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}
