// Per-segment sums of an (N, S) stat bundle over SORTED segment ids — the
// GROUP-BY reduction of the delta build, the view rollups, the slow-path
// re-sort merge and the query's canonical re-sort.
//
// Replaces: repro/kernels/segment_stats.py::segment_partials_pallas and its
// combine step combine_partials (Pallas, TPU). The TPU kernel routed the
// reduction through a one-hot (B, B) @ (B, S) matmul because the TPU has no
// fast scatter; Hopper does not need that detour, so it is not ported.
//
// Computes out[g, s] = sum of vals[perm[r], s] over the rows r of segment g
// (seg[r] == g; seg is non-decreasing), for g < G; ids outside [0, G) are
// dropped. Rows are read through perm, so the gather into sorted order is
// fused into the reduction. Each sum is the pinned pairwise tree of
// segment_tree.cuh, bit for bit the plain version's.
//
// Bound on the H100: memory (N*S*4 bytes of stats plus 16 bytes of perm and
// segment id per row in, G*S*4 out; one add per element). Design: the
// tree's tiles of 256 rows in parallel, then one thread per (segment,
// column) over its tile sums, so the long trailing pseudo-group of invalid
// rows costs max(256, rows / 256) steps on its thread, not rows.
#include "segment_tree.cuh"

__global__ void segment_fold_kernel(const float* __restrict__ tiles,
                                    const int64_t* __restrict__ seg,
                                    const int64_t* __restrict__ starts,
                                    float* __restrict__ out, long long n,
                                    int s, long long g) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= g * s) return;
  long long sid = t / s;
  int col = static_cast<int>(t - sid * s);
  int64_t first = starts[sid];
  if (first < 0) return;  // an empty segment: out stays 0
  out[sid * s + col] = run_tree(tiles, seg, first, sid, n, s, col);
}

// starts (G,) int64 filled with -1, tiles (N, S) f32 scratch and out (G, S)
// f32 filled with 0 come from the caller.
extern "C" int segment_sums_launch(const void* vals, const void* perm,
                                   const void* seg, void* starts, void* tiles,
                                   void* out, long long n, int s, long long g,
                                   void* stream) {
  if (n == 0 || s == 0 || g == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* seg_p = static_cast<const int64_t*>(seg);
  int64_t* starts_p = static_cast<int64_t*>(starts);
  float* tiles_p = static_cast<float*>(tiles);
  cudaError_t err = run_tiles_launch(
      static_cast<const float*>(vals), static_cast<const int64_t*>(perm),
      seg_p, starts_p, tiles_p, n, s, g, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  segment_fold_kernel<<<repro_blocks(g * s, threads), threads, 0, st>>>(
      tiles_p, seg_p, starts_p, static_cast<float*>(out), n, s, g);
  return static_cast<int>(cudaGetLastError());
}
