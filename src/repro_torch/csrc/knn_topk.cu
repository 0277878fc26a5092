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
// ~3.3 ms at 67 TFLOP/s; the pinned products and sums cannot fuse, so the
// issue of ~14 f32 instructions per pair floors it near 7.7 ms.
//
// Design: knn_partial_kernel, 128 threads a block, each thread R queries
// (R = 4 for K = 1 and 8, 2 for K = 16, 1 above width 8: what registers
// hold), query q0 + r * 128 + thread of its block (coalesced writes). The
// controls stream through shared memory in tiles of 128 rows, each row
// loaded once by one thread, which pins its norm and stores the row padded
// to P floats (a multiple of 4) with the norm in the padding: an invalid
// control's norm is NaN, so its d2 is NaN and never passes the strict test
// below (no per-control branch). Every thread reads a row with P / 4
// broadcast 16-byte loads and uses it for its R queries. Widths up to 8
// are templates of their own; wider rows up to 64 are padded with zero
// columns, whose +0.0 products leave every d2 bit as it is (the norms'
// sum is never -0.0). Each query keeps a running top-K in registers (K = k
// rounded up to 1, 8 or 16, unrolled): a candidate is taken only when its
// d2 is strictly below the current K-th (one branch for the thread's R
// queries), and goes in after every held entry of equal or lower d2, all
// of which have lower indices: the lexicographic order, so equal
// distances keep index order; the first k of the top-K are the top-k.
//
// Split over control ranges: when the query blocks alone would not fill
// the card's resident blocks (knn_topk_blocks_per_sm on every SM), the
// wrapper splits the controls into S contiguous ranges of whole tiles
// (gridDim.y), as many as keep every block resident in one wave (each
// range restarts its top-K, so more ranges cost more inserts). Each block
// then writes its queries' top-k of its range, (d2, int32 idx) in scratch
// laid out [S][k][Nq], and knn_merge_kernel, a thread a query, merges the
// S lists in range order with the same test and insert (a list ends at
// its first entry not below the running K-th: the lists are sorted),
// keeps the first k and leaves (BIG, -1) in unfilled slots. The top-k of
// (d2, idx) in lexicographic order is fixed by its inputs, and every
// member of it is in its own range's top-k, so the merge gives the same
// bits for any S.
#include "common.cuh"

#define REPRO_KNN_THREADS 128
#define REPRO_KNN_TILE 128
#define REPRO_KNN_MAX_D 64
#define REPRO_KNN_MAX_K 16
#define REPRO_KNN_BIG 3.4e38f

// Insert (x, ci) into the sorted top-K (bd, bi), given x < bd[K-1] and a
// lower index than ci in every held entry whose d2 equals x (the controls
// come in index order, and the merge takes the ranges in order): ci goes
// after every entry with d2 <= x, the entries from there on move down one
// slot. The lexicographic order of (d2, idx), with one compare a slot.
template <int K>
__device__ __forceinline__ void knn_insert(float (&bd)[K], int (&bi)[K],
                                           float x, int ci) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const bool here = x < bd[s];
    const bool below = s > 0 && x < bd[s - 1];
    bd[s] = here ? (below ? bd[s - 1] : x) : bd[s];
    bi[s] = here ? (below ? bi[s - 1] : ci) : bi[s];
  }
}

template <int K, int D, int R>
__global__ void __launch_bounds__(REPRO_KNN_THREADS)
    knn_partial_kernel(const float* __restrict__ Q,
                       const float* __restrict__ C,
                       const unsigned char* __restrict__ c_valid,
                       float* __restrict__ out_d,
                       long long* __restrict__ out_i,
                       float* __restrict__ part_d, int* __restrict__ part_i,
                       long long nq, long long nc, int d, int k,
                       long long span) {
  constexpr int P = (D + 1 + 3) / 4 * 4;  // D columns and the norm
  __shared__ __align__(16) float s_c[REPRO_KNN_TILE * P];
  const int tid = static_cast<int>(threadIdx.x);
  const long long q0 =
      static_cast<long long>(blockIdx.x) * (REPRO_KNN_THREADS * R);

  float q[R][D];
  float qn[R];
  float bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = q0 + r * REPRO_KNN_THREADS + tid;
    const bool live = qi < nq;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      q[r][j] = (live && j < d) ? Q[qi * d + j] : 0.0f;
      if (j == 0) {
        qn[r] = __fmul_rn(q[r][0], q[r][0]);
      } else if (j < d) {
        qn[r] = __fadd_rn(qn[r], __fmul_rn(q[r][j], q[r][j]));
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[r][s] = REPRO_KNN_BIG;
      bi[r][s] = -1;
    }
  }

  const long long lo = static_cast<long long>(blockIdx.y) * span;
  const long long hi = lo + span < nc ? lo + span : nc;
  for (long long base = lo; base < hi; base += REPRO_KNN_TILE) {
    // this thread's row of the tile: its columns, zero past d, and its
    // pinned norm (NaN for an invalid control or past the range)
    const long long row = base + tid;
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = 0.0f;
    float cn = __int_as_float(0x7fc00000);
    if (row < hi) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < d) v[j] = C[row * d + j];
      float s = __fmul_rn(v[0], v[0]);
#pragma unroll
      for (int j = 1; j < D; ++j)
        if (j < d) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
      if (c_valid[row]) cn = s;
    }
    v[D] = cn;
    __syncthreads();  // the previous tile is consumed
    float4* dst = reinterpret_cast<float4*>(s_c + tid * P);
#pragma unroll
    for (int j = 0; j < P / 4; ++j)
      dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                           v[4 * j + 3]);
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < REPRO_KNN_TILE; ++rr) {
      float c[P];
      const float4* src = reinterpret_cast<const float4*>(s_c + rr * P);
#pragma unroll
      for (int j = 0; j < P / 4; ++j) {
        const float4 w = src[j];
        c[4 * j] = w.x;
        c[4 * j + 1] = w.y;
        c[4 * j + 2] = w.z;
        c[4 * j + 3] = w.w;
      }
      const int ci = static_cast<int>(base) + rr;
      float x[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = __fmul_rn(q[r][0], c[0]);
#pragma unroll
        for (int j = 1; j < D; ++j)
          dot = __fadd_rn(dot, __fmul_rn(q[r][j], c[j]));
        // the clamp below waits for a candidate: the K-th is never
        // negative, and a negative x tested against a K-th of 0 is a 0
        // that the insert puts after every held 0 (all of lower index),
        // that is, off the end
        x[r] = __fsub_rn(__fadd_rn(qn[r], c[D]), __fmul_rn(2.0f, dot));
        any |= x[r] < bd[r][K - 1];  // NaN is never a candidate
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (x[r] < bd[r][K - 1])
            knn_insert<K>(bd[r], bi[r], x[r] < 0.0f ? 0.0f : x[r], ci);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = q0 + r * REPRO_KNN_THREADS + tid;
    if (qi >= nq) continue;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s >= k) break;
      if (gridDim.y == 1) {
        out_d[qi * k + s] = bd[r][s];
        out_i[qi * k + s] = bi[r][s];
      } else {
        const long long at = (static_cast<long long>(blockIdx.y) * k + s) * nq + qi;
        part_d[at] = bd[r][s];
        part_i[at] = bi[r][s];
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(REPRO_KNN_THREADS)
    knn_merge_kernel(const float* __restrict__ part_d,
                     const int* __restrict__ part_i,
                     float* __restrict__ out_d,
                     long long* __restrict__ out_i, long long nq, int k,
                     int n_ranges) {
  const long long qi =
      static_cast<long long>(blockIdx.x) * REPRO_KNN_THREADS + threadIdx.x;
  if (qi >= nq) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = REPRO_KNN_BIG;
    bi[s] = -1;
  }
  for (int g = 0; g < n_ranges; ++g) {
    for (int s = 0; s < k; ++s) {
      const long long at = (static_cast<long long>(g) * k + s) * nq + qi;
      const float x = part_d[at];
      if (!(x < bd[K - 1])) break;  // the rest of this list is no better
      knn_insert<K>(bd, bi, x, part_i[at]);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[qi * k + s] = bd[s];
      out_i[qi * k + s] = bi[s];
    }
  }
}

// One instance of the partial kernel: K slots, width D (d itself up to 8,
// else 64, zero-padded), R queries a thread.
template <int K_, int D_, int R_>
struct KnnInstance {
  static constexpr int K = K_, D = D_, R = R_;
};

template <int D, typename F>
static void with_width(int kmax, F&& f) {
  constexpr int R = D > 8 ? 1 : 4;
  switch (kmax) {
    case 1: f(KnnInstance<1, D, R>{}); break;
    case 8: f(KnnInstance<8, D, R>{}); break;
    default: f(KnnInstance<16, D, (D > 8 ? 1 : 2)>{}); break;
  }
}

// Calls f with the instance for (d, k): what the wrapper's
// queries_per_thread mirrors.
template <typename F>
static void with_instance(int d, int k, F&& f) {
  const int kmax = k <= 1 ? 1 : k <= 8 ? 8 : 16;
  switch (d) {
    case 1: with_width<1>(kmax, f); break;
    case 2: with_width<2>(kmax, f); break;
    case 3: with_width<3>(kmax, f); break;
    case 4: with_width<4>(kmax, f); break;
    case 5: with_width<5>(kmax, f); break;
    case 6: with_width<6>(kmax, f); break;
    case 7: with_width<7>(kmax, f); break;
    case 8: with_width<8>(kmax, f); break;
    default: with_width<REPRO_KNN_MAX_D>(kmax, f); break;
  }
}

// The partial kernel's resident blocks per SM at (d, k), on the current
// device (the wrapper's plan fills the card with them).
extern "C" int knn_topk_blocks_per_sm(int d, int k) {
  int blocks = 0;
  with_instance(d, k, [&](auto inst) {
    using I = decltype(inst);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, knn_partial_kernel<I::K, I::D, I::R>, REPRO_KNN_THREADS, 0);
  });
  return blocks;
}

// Q (nq, d), C (nc, d) f32, c_valid (nc,) bytes; out (nq, k) f32 / int64.
// r queries a thread, n_ranges control ranges of span rows (whole tiles;
// the wrapper's plan); part_d / part_i scratch of n_ranges * k * nq
// entries when n_ranges > 1.
extern "C" int knn_topk_launch(const void* Q, const void* C,
                               const void* c_valid, void* out_d, void* out_i,
                               void* part_d, void* part_i, long long nq,
                               long long nc, int d, int k, int r,
                               int n_ranges, long long span, void* stream) {
  if (d < 1 || d > REPRO_KNN_MAX_D || k < 1 || k > REPRO_KNN_MAX_K ||
      nq < 1 || nc < 0 || nc > 0x7FFFFFFFLL || r < 1 || n_ranges < 1 ||
      n_ranges > 65535 || span < REPRO_KNN_TILE ||
      span % REPRO_KNN_TILE != 0 ||
      (n_ranges > 1 && (part_d == nullptr || part_i == nullptr ||
                        (n_ranges - 1) * span >= nc)) ||
      static_cast<long long>(n_ranges) * span < nc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(Q);
  const float* c = static_cast<const float*>(C);
  const unsigned char* v = static_cast<const unsigned char*>(c_valid);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  bool planned = false;
  with_instance(d, k, [&](auto inst) {
    using I = decltype(inst);
    if (r != I::R) return;  // the wrapper's plan has another R
    planned = true;
    const dim3 grid(repro_blocks(nq, REPRO_KNN_THREADS * I::R),
                    static_cast<unsigned>(n_ranges));
    knn_partial_kernel<I::K, I::D, I::R><<<grid, REPRO_KNN_THREADS, 0, s>>>(
        q, c, v, od, oi, pd, pi, nq, nc, d, k, span);
    if (n_ranges > 1)
      knn_merge_kernel<I::K><<<repro_blocks(nq, REPRO_KNN_THREADS),
                               REPRO_KNN_THREADS, 0, s>>>(pd, pi, od, oi, nq,
                                                          k, n_ranges);
  });
  if (!planned) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
