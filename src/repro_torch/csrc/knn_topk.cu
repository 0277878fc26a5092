// k nearest valid controls per query, by squared Euclidean distance.
//
// Replaces: repro/kernels/knn_topk.py::knn_topk_pallas (Pallas, TPU), the
// tiled all-pairs k-NN of nearest-neighbour matching, with the contract of
// repro/core/matching.py::knn_quadratic (which the reference's matching
// runs): per query row, the k smallest (d2, idx) in lexicographic order
// over the VALID controls, where
//   d2 = max((|q|^2 + |c|^2) - 2 (q . c), 0)
// and slots that no valid control fills hold (BIG, -1). Ties go to the
// lower control index.
//
// Every product and sum is pinned, and the plain version in
// kernels/knn_topk.py writes the same order with elementwise tensor ops:
// |q|^2, |c|^2 and q . c add their d terms in ascending column order, each
// product and each sum rounded on its own (__fmul_rn / __fadd_rn keep nvcc
// from contracting them into FMAs, which eager PyTorch never forms; no
// tensor cores: TF32 would lose the agreement). So kernel and plain
// version agree bit for bit.
//
// Bound on the H100: operations. For Nq x Nc pairs at width d the
// function needs about 2d + 3 f32 operations per pair (the dot product,
// the norms' sum, the subtraction, the clamp) and reads only
// (Nq + Nc) x d floats, so at the matching path's 2^17 x 2^17, d = 5 it is
// ~3.3 ms at 67 TFLOP/s. Design: one thread per query, 128 queries per
// block, the query row in registers (D = 8 or 64 slots, the width rounded
// up). Controls stream through shared memory in tiles of 128 rows with
// their norms and valid flags; every thread scans the tile in index order
// (warp-uniform broadcast reads) and keeps its running top-K in registers
// (K = k rounded up to 1, 8 or 16, unrolled). A candidate is taken
// only when its d2 is strictly below the current K-th; it is inserted by
// a lexicographic bubble, so equal distances keep index order. The first k
// of the top-K are the top-k. Invalid controls are never inserted. Tensor
// cores and shared-memory merges of the candidate lists are later work.
#include "common.cuh"

#define REPRO_KNN_THREADS 128
#define REPRO_KNN_TILE 128
#define REPRO_KNN_MAX_D 64
#define REPRO_KNN_MAX_K 16
#define REPRO_KNN_BIG 3.4e38f

template <int K, int D>
__global__ void knn_topk_kernel(const float* __restrict__ Q,
                                const float* __restrict__ C,
                                const unsigned char* __restrict__ c_valid,
                                float* __restrict__ out_d,
                                long long* __restrict__ out_i, long long nq,
                                long long nc, int d, int k) {
  __shared__ float s_c[REPRO_KNN_TILE * D];
  __shared__ float s_cn[REPRO_KNN_TILE];
  __shared__ unsigned char s_v[REPRO_KNN_TILE];
  const long long qi =
      static_cast<long long>(blockIdx.x) * REPRO_KNN_THREADS + threadIdx.x;
  const bool live = qi < nq;

  float q[D];
  float qn = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    q[j] = (live && j < d) ? Q[qi * d + j] : 0.0f;
    if (j == 0) {
      qn = __fmul_rn(q[0], q[0]);
    } else if (j < d) {
      qn = __fadd_rn(qn, __fmul_rn(q[j], q[j]));
    }
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = REPRO_KNN_BIG;
    bi[s] = -1;
  }

  for (long long base = 0; base < nc; base += REPRO_KNN_TILE) {
    const int rows = static_cast<int>(
        nc - base < REPRO_KNN_TILE ? nc - base : REPRO_KNN_TILE);
    __syncthreads();  // the previous tile is consumed
    for (int e = static_cast<int>(threadIdx.x); e < rows * d;
         e += REPRO_KNN_THREADS)
      s_c[e] = C[base * d + e];
    __syncthreads();
    const int tid = static_cast<int>(threadIdx.x);
    if (tid < rows) {
      const float* c = s_c + tid * d;
      float cn = __fmul_rn(c[0], c[0]);
      for (int j = 1; j < d; ++j) cn = __fadd_rn(cn, __fmul_rn(c[j], c[j]));
      s_cn[tid] = cn;
      s_v[tid] = c_valid[base + tid];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < rows; ++r) {
      if (!s_v[r]) continue;  // the same r in every thread: no divergence
      const float* c = s_c + r * d;
      float dot = __fmul_rn(q[0], c[0]);
#pragma unroll
      for (int j = 1; j < D; ++j)
        if (j < d) dot = __fadd_rn(dot, __fmul_rn(q[j], c[j]));
      float x = __fsub_rn(__fadd_rn(qn, s_cn[r]), __fmul_rn(2.0f, dot));
      x = x < 0.0f ? 0.0f : x;  // NaN stays NaN and is never taken
      if (!(x < bd[K - 1])) continue;
      float cd = x;
      int ci = static_cast<int>(base) + r;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const bool lt = cd < bd[s] || (cd == bd[s] && ci < bi[s]);
        const float td = bd[s];
        const int ti = bi[s];
        bd[s] = lt ? cd : td;
        bi[s] = lt ? ci : ti;
        cd = lt ? td : cd;
        ci = lt ? ti : ci;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[qi * k + s] = bd[s];
      out_i[qi * k + s] = bi[s];
    }
  }
}

template <int D>
static void launch_width(int kmax, unsigned int blocks, cudaStream_t stream,
                         const float* Q, const float* C,
                         const unsigned char* v, float* od, long long* oi,
                         long long nq, long long nc, int d, int k) {
  switch (kmax) {
    case 1:
      knn_topk_kernel<1, D><<<blocks, REPRO_KNN_THREADS, 0, stream>>>(
          Q, C, v, od, oi, nq, nc, d, k);
      break;
    case 8:
      knn_topk_kernel<8, D><<<blocks, REPRO_KNN_THREADS, 0, stream>>>(
          Q, C, v, od, oi, nq, nc, d, k);
      break;
    default:
      knn_topk_kernel<16, D><<<blocks, REPRO_KNN_THREADS, 0, stream>>>(
          Q, C, v, od, oi, nq, nc, d, k);
      break;
  }
}

extern "C" int knn_topk_launch(const void* Q, const void* C,
                               const void* c_valid, void* out_d, void* out_i,
                               long long nq, long long nc, int d, int k,
                               void* stream) {
  if (d < 1 || d > REPRO_KNN_MAX_D || k < 1 || k > REPRO_KNN_MAX_K ||
      nq < 1 || nc < 0 || nc > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kmax = k <= 1 ? 1 : k <= 8 ? 8 : 16;
  const unsigned int blocks = repro_blocks(nq, REPRO_KNN_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(Q);
  const float* c = static_cast<const float*>(C);
  const unsigned char* v = static_cast<const unsigned char*>(c_valid);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  if (d <= 8)
    launch_width<8>(kmax, blocks, s, q, c, v, od, oi, nq, nc, d, k);
  else
    launch_width<REPRO_KNN_MAX_D>(kmax, blocks, s, q, c, v, od, oi, nq, nc,
                                  d, k);
  return static_cast<int>(cudaGetLastError());
}
