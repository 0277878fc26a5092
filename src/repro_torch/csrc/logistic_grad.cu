// Newton terms of masked logistic regression, in one launch.
//
// Replaces: repro/kernels/logistic_grad.py::logistic_newton_terms_pallas
// (Pallas, TPU), which accumulates g and H across its sequential grid.
//
// For X (N, d) f32 (with the caller's bias column), t, m (N,) and w (d,):
//   z = sum_j x_j w_j  (j ascending)    p = 1 / (1 + expf(-z))
//   r = m (p - t)                        s = (m p)(1 - p)
// and the sums of the Q = d + d(d+1)/2 per-row terms
//   r x_j (j < d), then (s x_j) x_k for j <= k (upper triangle, row-major)
// in the order of chunk_sums_plain(chunk_sums_plain(terms)[0])[1]: each
// 1024-row tile by the halving tree of chunk_tree.cuh (rows past N give
// exactly +0.0), then the (n_tiles, Q) tile partials by the same tree over
// each 1024 tiles (zero-padded) and those group sums in order. Out: g (d),
// then H (d, d) with its lower triangle the mirror of its upper one.
//
// Every sum is pinned, and the plain version in kernels/logistic_grad.py
// writes the same order: the logit adds in ascending j (__fadd_rn /
// __fmul_rn keep nvcc from contracting into FMAs, which eager PyTorch
// never forms). No float atomics: the same inputs give the same bits on
// every run.
//
// Bound on the H100: memory. The function reads X once (4d B per row)
// plus t and m (8 B per row); the work is O(d^2) flops per row, far below
// the f32 rate for d <= 64. Design: one warp per 1024-row tile, lane l
// owning rows l + 32a (a < 32), so each term's 32 values a lane reduce by
// chunk_tree with no shared memory and no barrier; each s x_j is formed
// once for its row of H. For d <= REPRO_STAGE_D the warp first stages its
// tile of X into shared memory, transposed, by asynchronous 4-byte copies
// (cp.async: the whole tile in flight at once, each byte of X read from
// DRAM once); the logit and every term then read it without bank
// conflicts. Three blocks of four warps fit a SM at d = 4. Wider X is read
// from global memory per term (L1 / L2). Pass 2 runs in the same launch:
// the last block by ticket reduces the tile partials (stored term-major,
// so its loads are coalesced) and writes g and the mirrored H. d is
// limited to 64.
#include "chunk_tree.cuh"

// warps (tiles in flight) of a block
#define REPRO_NT_WARPS 4
#define REPRO_MAX_D 64
// widest X staged in shared memory (REPRO_NT_WARPS * d * REPRO_XS floats)
#define REPRO_STAGE_D 8
// floats per staged column: the tile's rows and 8 pad floats, so column j
// starts 8j banks on and the staging copies of d = 4 hit 32 banks
#define REPRO_XS (REPRO_CHUNK + 8)
// most blocks launched; their warps stride over the tiles
#define REPRO_NT_MAX_BLOCKS 65536
// floats of each of pass 2's two combine buffers
#define REPRO_NT_COMBINE 256
// (group, term) pairs a warp of pass 2 loads at once
#define REPRO_NT_PASS2_PAIRS 4

// The warp's tile of X (`count` = rows * d floats, row-major at src) into
// xs, column j at xs + j * REPRO_XS, by 4-byte asynchronous copies: every
// load of the tile is in flight at once and none holds a register; the
// copies past count fill zeros. The caller waits (cp.async.wait_all).
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int count, int d, float* xs,
                                           int lane) {
  const int total = REPRO_CHUNK * d;
  const int step_r = 32 / d, step_c = 32 % d;
  int row = lane / d, col = lane - row * d;
  const unsigned int base =
      static_cast<unsigned int>(__cvta_generic_to_shared(xs));
  for (int f = lane; f < total; f += 32) {
    const bool in = f < count;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     base + 4u * static_cast<unsigned int>(
                                     col * REPRO_XS + row)),
                 "l"(src + (in ? f : 0)), "r"(in ? 4 : 0));
    row += step_r;
    col += step_c;
    if (col >= d) col -= d, ++row;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// X[row0 + i, j] of the warp's tile (i = lane + 32a): staged, or from
// global memory (+0.0 past the data).
template <bool STAGED>
__device__ __forceinline__ float x_at(const float* xs,
                                      const float* __restrict__ X,
                                      long long row0, int rows, int d, int i,
                                      int j) {
  if (STAGED) return xs[j * REPRO_XS + i];
  return i < rows ? __ldg(X + (row0 + i) * d + j) : 0.0f;
}

template <bool STAGED>
__global__ void __launch_bounds__(REPRO_NT_WARPS * 32)
    newton_terms_kernel(const float* __restrict__ X,
                        const float* __restrict__ t,
                        const float* __restrict__ m,
                        const float* __restrict__ w, float* scratch,
                        unsigned int* ticket, long long n, int d,
                        int q_total, long long n_tiles) {
  extern __shared__ float xs_all[];  // STAGED: REPRO_NT_WARPS x d columns
  __shared__ float s_w[REPRO_MAX_D];
  __shared__ __align__(16) float stage[2 * REPRO_NT_COMBINE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < d; j += blockDim.x) s_w[j] = w[j];
  __syncthreads();

  // tile partials, term-major: term q of tile i at part[q * n_tiles + i]
  float* part = scratch;
  float* xs = xs_all + (STAGED ? warp * d * REPRO_XS : 0);
  for (long long tile = static_cast<long long>(blockIdx.x) * REPRO_NT_WARPS +
                        warp;
       tile < n_tiles;
       tile += static_cast<long long>(gridDim.x) * REPRO_NT_WARPS) {
    const long long row0 = tile * REPRO_CHUNK;
    const long long left = n - row0;
    const int rows = left >= REPRO_CHUNK ? REPRO_CHUNK
                                         : (left > 0 ? static_cast<int>(left)
                                                     : 0);
    float tv[32], mv[32];
#pragma unroll
    for (int a = 0; a < 32; ++a) {
      const int i = lane + 32 * a;
      tv[a] = i < rows ? __ldg(t + row0 + i) : 0.0f;
      mv[a] = i < rows ? __ldg(m + row0 + i) : 0.0f;
    }
    if (STAGED) {
      stage_tile(X + row0 * d, rows * d, d, xs, lane);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
    }
    float z[32];
#pragma unroll
    for (int a = 0; a < 32; ++a) z[a] = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float wj = s_w[j];
#pragma unroll
      for (int a = 0; a < 32; ++a)
        z[a] = __fadd_rn(
            z[a], __fmul_rn(x_at<STAGED>(xs, X, row0, rows, d,
                                         lane + 32 * a, j),
                            wj));
    }
    // r and s (rows past N: 0, so their terms are exactly +0.0 * +0.0)
    float r[32], s[32];
#pragma unroll
    for (int a = 0; a < 32; ++a) {
      const float p = 1.0f / (1.0f + expf(-z[a]));
      const bool in = lane + 32 * a < rows;
      r[a] = in ? __fmul_rn(mv[a], __fsub_rn(p, tv[a])) : 0.0f;
      s[a] = in ? __fmul_rn(__fmul_rn(mv[a], p), __fsub_rn(1.0f, p)) : 0.0f;
    }
    // g's terms r x_j, then H's (s x_j) x_k for j <= k in row-major order,
    // each s x_j formed once for its row of H
    for (int j = 0; j < d; ++j) {
      float v[32];
#pragma unroll
      for (int a = 0; a < 32; ++a)
        v[a] = __fmul_rn(
            r[a], x_at<STAGED>(xs, X, row0, rows, d, lane + 32 * a, j));
      const float sum = chunk_tree(v);
      if (lane == 0) part[j * n_tiles + tile] = sum;
    }
    int q = d;
    for (int j = 0; j < d; ++j) {
      float sx[32];
#pragma unroll
      for (int a = 0; a < 32; ++a)
        sx[a] = __fmul_rn(
            s[a], x_at<STAGED>(xs, X, row0, rows, d, lane + 32 * a, j));
      for (int k = j; k < d; ++k, ++q) {
        float v[32];
#pragma unroll
        for (int a = 0; a < 32; ++a)
          v[a] = __fmul_rn(
              sx[a], x_at<STAGED>(xs, X, row0, rows, d, lane + 32 * a, k));
        const float sum = chunk_tree(v);
        if (lane == 0) part[q * n_tiles + tile] = sum;
      }
    }
    __syncwarp();  // the next tile restages xs
  }
  if (!chunk_last_block(ticket)) return;

  // pass 2, by the last block: chunk_sums_plain(partials)[1]
  const long long n_groups = (n_tiles + REPRO_CHUNK - 1) / REPRO_CHUNK;
  float* gsum = part + q_total * n_tiles;  // (n_groups, Q)
  float* tot = gsum + n_groups * q_total;  // (Q,)
  float* out = tot + q_total;              // g (d), then H (d, d)
  chunk_pairs<true, REPRO_NT_PASS2_PAIRS>(part, gsum, n_tiles, q_total,
                                          n_groups, 1, n_tiles, warp,
                                          REPRO_NT_WARPS);
  __syncthreads();
  chunk_combine(gsum, tot, n_groups, q_total, stage, REPRO_NT_COMBINE);
  __syncthreads();
  for (int i = tid; i < d + d * d; i += blockDim.x) {
    int src = i;
    if (i >= d) {
      const int j = (i - d) / d, k = (i - d) - j * d;
      const int lo = j < k ? j : k, hi = j < k ? k : j;
      src = d + lo * d - lo * (lo - 1) / 2 + (hi - lo);
    }
    out[i] = tot[src];
  }
  chunk_ticket_reset(ticket);
}

extern "C" int logistic_newton_terms_launch(const void* X, const void* t,
                                            const void* m, const void* w,
                                            void* scratch, long long n, int d,
                                            long long n_tiles, void* ticket,
                                            void* stream) {
  if (d < 1 || d > REPRO_MAX_D || n < 0 ||
      n_tiles != (n > 0 ? (n + REPRO_CHUNK - 1) / REPRO_CHUNK : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_total = d + d * (d + 1) / 2;
  const long long want = (n_tiles + REPRO_NT_WARPS - 1) / REPRO_NT_WARPS;
  const unsigned int blocks = static_cast<unsigned int>(
      want < REPRO_NT_MAX_BLOCKS ? want : REPRO_NT_MAX_BLOCKS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* tf = static_cast<const float*>(t);
  const float* mf = static_cast<const float*>(m);
  const float* wf = static_cast<const float*>(w);
  float* sf = static_cast<float*>(scratch);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  if (d <= REPRO_STAGE_D) {
    // above 48 KB of dynamic shared memory only once allowed, per device
    static bool allowed[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(
          newton_terms_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(REPRO_NT_WARPS * REPRO_STAGE_D * REPRO_XS *
                           sizeof(float)));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) allowed[dev] = true;
    }
    const size_t smem = static_cast<size_t>(REPRO_NT_WARPS) * d * REPRO_XS *
                        sizeof(float);
    newton_terms_kernel<true><<<blocks, REPRO_NT_WARPS * 32, smem, st>>>(
        Xf, tf, mf, wf, sf, tk, n, d, q_total, n_tiles);
  } else {
    newton_terms_kernel<false><<<blocks, REPRO_NT_WARPS * 32, 0, st>>>(
        Xf, tf, mf, wf, sf, tk, n, d, q_total, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
