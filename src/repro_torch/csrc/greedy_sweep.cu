// The greedy sweep of nearest-neighbour matching without replacement.
//
// Replaces: the lax.scan of repro/core/matching.py::greedy_nnmnr (no TPU
// kernel: the reference runs the sweep as a scan; a scan on the hot path
// becomes a kernel here). The paper's greedy 1/2-approximation (Fig. 3):
// the candidate edges (d, control, treated), already sorted by distance
// (stable), are walked in that order, and an edge is taken iff
//   d < BIG, its control is unused, and its treated unit has fewer than k
//   controls;
// taking it marks the control used and counts it for the treated unit.
// Control and treated indices are clipped to [0, n_rows), as the scan
// clips them. Integer logic only, so kernel and plain version
// (kernels/greedy_sweep.py) agree bit for bit.
//
// One thread: each edge's verdict depends on every earlier one (the exact
// problem is NLOGSPACE-hard, the paper's Prop. 1, and the greedy order is
// the contract). Bound on the H100: the latency of one dependent chain,
// about two cached loads and two stores per edge; the bytes it must move
// (21 per edge) would take microseconds. The state, used_c (u8) and cnt_t
// (i32) of n_rows each, is in global memory, zeroed by the wrapper: the
// kernel allocates nothing. Keeping the state in shared memory (it fits
// for n_rows up to ~2^17 as bits and bytes) is later work.
#include "common.cuh"

#define REPRO_SWEEP_BIG 3.4e38f

__global__ void greedy_sweep_kernel(const float* __restrict__ d,
                                    const long long* __restrict__ c,
                                    const long long* __restrict__ t,
                                    long long n_edges, long long n_rows,
                                    int k, unsigned char* used_c, int* cnt_t,
                                    unsigned char* __restrict__ taken) {
  for (long long e = 0; e < n_edges; ++e) {
    long long ci = c[e], ti = t[e];
    ci = ci < 0 ? 0 : (ci >= n_rows ? n_rows - 1 : ci);
    ti = ti < 0 ? 0 : (ti >= n_rows ? n_rows - 1 : ti);
    const bool ok = d[e] < REPRO_SWEEP_BIG && !used_c[ci] && cnt_t[ti] < k;
    if (ok) {
      used_c[ci] = 1;
      cnt_t[ti] += 1;
    }
    taken[e] = ok ? 1 : 0;
  }
}

extern "C" int greedy_sweep_launch(const void* d, const void* c,
                                   const void* t, long long n_edges,
                                   long long n_rows, int k, void* used_c,
                                   void* cnt_t, void* taken, void* stream) {
  if (n_edges < 1 || n_rows < 1 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  greedy_sweep_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const long long*>(c),
      static_cast<const long long*>(t), n_edges, n_rows, k,
      static_cast<unsigned char*>(used_c), static_cast<int*>(cnt_t),
      static_cast<unsigned char*>(taken));
  return static_cast<int>(cudaGetLastError());
}
