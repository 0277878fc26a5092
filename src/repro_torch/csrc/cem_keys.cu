// Fused coarsen + bit-pack of CEM group keys.
//
// Replaces: repro/kernels/cem_keys.py::cem_keys_pallas (Pallas, TPU).
//
// Computes, per row i of X (N, d) f32:
//   bucket_j = #{k < n_cuts[j] : X[i, j] >= cut[j, k]}      (cutpoints +inf
//              padded to C per covariate; categoricals come in as 1..card-1)
//   (hi, lo) <<= widths[j]; lo |= bucket_j                 (MSB-first, u32)
//   invalid rows -> hi = lo = 0xFFFFFFFF
// and writes hi, lo zero-extended into int64 (the port's key layout).
//
// Bound on the H100: memory. Each row reads 4d bytes of covariates and one
// validity byte and writes 16 bytes of key words; the comparisons are a few
// dozen integer ops per row, far below the card's op rate. Design: one
// thread per row, so neighbouring threads stream neighbouring rows; the
// (d, C) cutpoint table, n_cuts and widths sit in shared memory, loaded
// once per block. Integer arithmetic only: bitwise equal to the plain
// version and to KeyCodec.pack(coarsen(...)).
#include "common.cuh"

__global__ void cem_keys_kernel(const float* __restrict__ X,
                                const float* __restrict__ cut,
                                const int* __restrict__ n_cuts,
                                const int* __restrict__ widths,
                                const unsigned char* __restrict__ valid,
                                int64_t* __restrict__ hi_out,
                                int64_t* __restrict__ lo_out,
                                long long n, int d, int c) {
  extern __shared__ float smem[];
  float* s_cut = smem;
  int* s_n = reinterpret_cast<int*>(smem + d * c);
  int* s_w = s_n + d;
  for (int k = threadIdx.x; k < d * c; k += blockDim.x) s_cut[k] = cut[k];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    s_n[k] = n_cuts[k];
    s_w[k] = widths[k];
  }
  __syncthreads();
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t hi = 0u, lo = 0u;
  const float* row = X + i * d;
  for (int j = 0; j < d; ++j) {
    int w = s_w[j];
    if (w == 0) continue;
    float x = row[j];
    uint32_t b = 0u;
    const float* cj = s_cut + j * c;
    for (int k = 0; k < s_n[j]; ++k) b += (x >= cj[k]) ? 1u : 0u;
    hi = (hi << w) | (lo >> (32 - w));
    lo = (lo << w) | b;
  }
  if (!valid[i]) {
    hi = 0xFFFFFFFFu;
    lo = 0xFFFFFFFFu;
  }
  hi_out[i] = static_cast<int64_t>(hi);
  lo_out[i] = static_cast<int64_t>(lo);
}

extern "C" int cem_keys_launch(const void* X, const void* cut,
                               const void* n_cuts, const void* widths,
                               const void* valid, void* hi, void* lo,
                               long long n, int d, int c, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  size_t smem = sizeof(float) * d * c + 2 * sizeof(int) * d;
  cem_keys_kernel<<<repro_blocks(n, threads), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(cut),
      static_cast<const int*>(n_cuts), static_cast<const int*>(widths),
      static_cast<const unsigned char*>(valid), static_cast<int64_t*>(hi),
      static_cast<int64_t*>(lo), n, d, c);
  return static_cast<int>(cudaGetLastError());
}
