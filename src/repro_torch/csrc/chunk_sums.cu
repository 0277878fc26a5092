// Canonical chunked column sums of an (N, S) stat bundle — every reduction
// of the online query's estimator (estimate_ate_from_stats).
//
// Replaces: repro/kernels/segment_stats.py::chunk_sums_pallas (Pallas, TPU)
// together with the sequential combine of chunked_sum.
//
// Computes partials[c, s] = sum of vals[1024c : 1024(c+1), s] (rows past N
// read as 0.0, exactly as a zero-padded tail) in a PINNED pairwise order:
// x[i] + x[i+512] for i < 512, then + 256, + 128, ..., + 1 — ten halving
// steps. Then totals[s] = ((p[0, s] + p[1, s]) + p[2, s]) + ..., strictly
// in chunk order. Appending zero rows appends exact "+ 0.0" steps, so the
// totals are invariant to trailing zero padding (the capacity invariance
// the query path relies on). The plain version in kernels/segment_stats.py
// writes the same halving steps on a reshaped tensor: bitwise equal.
//
// Bound on the H100: memory (N*S*4 bytes in, one add per element). Design:
// one 512-thread block per (chunk, column) reduces in shared memory; a
// second launch, one thread per column, walks the chunk partials in order.
// Both launches go on the same stream from this one entry point.
#include "common.cuh"

#define REPRO_CHUNK 1024
#define REPRO_HALF 512

__global__ void chunk_partials_kernel(const float* __restrict__ vals,
                                      float* __restrict__ partials,
                                      long long n, int s) {
  __shared__ float buf[REPRO_HALF];
  long long c = blockIdx.x;
  int col = blockIdx.y;
  int i = threadIdx.x;
  long long r0 = c * REPRO_CHUNK + i;
  long long r1 = r0 + REPRO_HALF;
  float a = r0 < n ? vals[r0 * s + col] : 0.0f;
  float b = r1 < n ? vals[r1 * s + col] : 0.0f;
  buf[i] = a + b;
  __syncthreads();
  for (int h = REPRO_HALF / 2; h > 0; h >>= 1) {
    if (i < h) buf[i] = buf[i] + buf[i + h];
    __syncthreads();
  }
  if (i == 0) partials[c * s + col] = buf[0];
}

__global__ void chunk_combine_kernel(const float* __restrict__ partials,
                                     float* __restrict__ totals,
                                     long long nb, int s) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= s) return;
  float t = partials[col];
  for (long long c = 1; c < nb; ++c) t = t + partials[c * s + col];
  totals[col] = t;
}

extern "C" int chunk_sums_launch(const void* vals, void* partials,
                                 void* totals, long long n, int s,
                                 long long nb, void* stream) {
  if (s == 0 || nb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(s));
  chunk_partials_kernel<<<grid, REPRO_HALF, 0, st>>>(
      static_cast<const float*>(vals), static_cast<float*>(partials), n, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_combine_kernel<<<repro_blocks(s, 32), 32, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(totals), nb,
      s);
  return static_cast<int>(cudaGetLastError());
}
