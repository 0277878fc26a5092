// Newton terms of masked logistic regression, pass 1: per-tile partials.
//
// Replaces: repro/kernels/logistic_grad.py::logistic_newton_terms_pallas
// (Pallas, TPU), which accumulates g and H across its sequential grid.
//
// For X (N, d) f32 (with the caller's bias column), t, m (N,) and w (d,):
//   z = sum_j x_j w_j  (j ascending)    p = 1 / (1 + expf(-z))
//   r = m (p - t)                        s = (m p)(1 - p)
// and the tile's sums of the Q = d + d(d+1)/2 per-row terms
//   r x_j (j < d), then (s x_j) x_k for j <= k (upper triangle, row-major)
// one row of partials (n_tiles, Q) per 1024-row tile. Rows past N give
// exactly +0.0. The caller adds the tile partials with the chunk_sums
// kernel (pass 2) and mirrors H's upper triangle.
//
// Every sum is pinned, and the plain version in kernels/logistic_grad.py
// writes the same order: the logit adds in ascending j (__fadd_rn /
// __fmul_rn keep nvcc from contracting into FMAs, which eager PyTorch
// never forms), and a tile reduces each term by the halving tree of
// chunk_sums: x[i] + x[i+512], then + 256, ..., + 1. No float atomics:
// the same inputs give the same bits on every run.
//
// Bound on the H100: memory. The function reads X once (4d B per row)
// plus t and m (8 B per row); the work is O(d^2) flops per row, far below
// the f32 rate for d <= 64. Design: one 512-thread block per 1024-row tile,
// each thread owning rows i and i + 512 (the pairs of the tree's first
// step). The tile's terms reduce REPRO_QB at a time in a (QB, 512) shared
// buffer, every halving step spread over the whole block. X is re-read
// per term from L1. d is limited to 64 (the wrapper raises above it).
#include "common.cuh"

#define REPRO_TILE 1024
#define REPRO_HALF 512
#define REPRO_QB 16
#define REPRO_MAX_D 64
#define REPRO_MAX_PAIRS (REPRO_MAX_D * (REPRO_MAX_D + 1) / 2)

__device__ __forceinline__ float row_term(const float* __restrict__ x,
                                          float r, float s, int q, int d,
                                          const unsigned char* pj,
                                          const unsigned char* pk) {
  if (q < d) return __fmul_rn(r, x[q]);
  int h = q - d;
  return __fmul_rn(__fmul_rn(s, x[pj[h]]), x[pk[h]]);
}

__device__ __forceinline__ void row_weights(const float* __restrict__ x,
                                            float t, float m,
                                            const float* w, int d,
                                            float* r, float* s) {
  float z = 0.0f;
  for (int j = 0; j < d; ++j) z = __fadd_rn(z, __fmul_rn(x[j], w[j]));
  float p = 1.0f / (1.0f + expf(-z));
  *r = __fmul_rn(m, __fsub_rn(p, t));
  *s = __fmul_rn(__fmul_rn(m, p), __fsub_rn(1.0f, p));
}

__global__ void newton_partials_kernel(const float* __restrict__ X,
                                       const float* __restrict__ t,
                                       const float* __restrict__ m,
                                       const float* __restrict__ w,
                                       float* __restrict__ partials,
                                       long long n, int d, int q_total) {
  __shared__ float s_w[REPRO_MAX_D];
  __shared__ unsigned char s_pj[REPRO_MAX_PAIRS];
  __shared__ unsigned char s_pk[REPRO_MAX_PAIRS];
  __shared__ float buf[REPRO_QB][REPRO_HALF];
  const int i = threadIdx.x;
  const long long tile = blockIdx.x;
  for (int j = i; j < d; j += REPRO_HALF) s_w[j] = w[j];
  const int n_pairs = q_total - d;
  for (int h = i; h < n_pairs; h += REPRO_HALF) {
    int j = 0, rem = h;
    while (rem >= d - j) {
      rem -= d - j;
      ++j;
    }
    s_pj[h] = static_cast<unsigned char>(j);
    s_pk[h] = static_cast<unsigned char>(j + rem);
  }
  __syncthreads();

  const long long ra = tile * REPRO_TILE + i;
  const long long rb = ra + REPRO_HALF;
  const bool in_a = ra < n, in_b = rb < n;
  const float* xa = X + (in_a ? ra : 0) * d;
  const float* xb = X + (in_b ? rb : 0) * d;
  float r_a = 0.0f, s_a = 0.0f, r_b = 0.0f, s_b = 0.0f;
  if (in_a) row_weights(xa, t[ra], m[ra], s_w, d, &r_a, &s_a);
  if (in_b) row_weights(xb, t[rb], m[rb], s_w, d, &r_b, &s_b);

  for (int q0 = 0; q0 < q_total; q0 += REPRO_QB) {
    const int nq = min(REPRO_QB, q_total - q0);
    for (int q = 0; q < nq; ++q) {
      float a = in_a ? row_term(xa, r_a, s_a, q0 + q, d, s_pj, s_pk) : 0.0f;
      float b = in_b ? row_term(xb, r_b, s_b, q0 + q, d, s_pj, s_pk) : 0.0f;
      buf[q][i] = __fadd_rn(a, b);
    }
    __syncthreads();
    for (int h = REPRO_HALF / 2, lg = 8; h > 0; h >>= 1, --lg) {
      for (int k = i; k < nq * h; k += REPRO_HALF) {
        const int q = k >> lg, j = k & (h - 1);
        buf[q][j] = __fadd_rn(buf[q][j], buf[q][j + h]);
      }
      __syncthreads();
    }
    if (i < nq) partials[tile * q_total + q0 + i] = buf[i][0];
    __syncthreads();
  }
}

extern "C" int logistic_newton_partials_launch(
    const void* X, const void* t, const void* m, const void* w,
    void* partials, long long n, int d, long long n_tiles, void* stream) {
  if (d < 1 || d > REPRO_MAX_D || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_total = d + d * (d + 1) / 2;
  newton_partials_kernel<<<static_cast<unsigned int>(n_tiles), REPRO_HALF,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(t),
      static_cast<const float*>(m), static_cast<const float*>(w),
      static_cast<float*>(partials), n, d, q_total);
  return static_cast<int>(cudaGetLastError());
}
