// Per-segment sums of an (N, S) stat bundle over SORTED segment ids — the
// GROUP-BY reduction of the delta build, the view rollups, the slow-path
// re-sort merge, the query's canonical re-sort and the offline group stats.
//
// Replaces: repro/kernels/segment_stats.py::segment_partials_pallas and its
// combine step combine_partials (Pallas, TPU). The TPU kernel routed the
// reduction through a one-hot (B, B) @ (B, S) matmul because the TPU has no
// fast scatter; Hopper does not need that detour, so it is not ported.
//
// Computes out[g, s] = sum of vals[perm[r], s] over the rows r of segment g
// (seg[r] == g), for g < G; ids outside [0, G) are dropped, and the rows of
// each kept id are contiguous (seg is non-decreasing, or, in the batched
// slow-path merge, -1 between partitions' increasing ids). Rows are read
// through perm, so the gather into sorted order is fused into the
// reduction. Each sum is the pinned pairwise tree of segment_tree.cuh, bit
// for bit the plain version's.
//
// Bound on the H100: memory — N*S*4 bytes of stats plus 16 bytes of perm and
// segment id per summed row in, G*S*4 out; one add per element. The old
// design walked each 256-row tile with one thread, a chain of dependent
// loads per row. Design now (segment_tree.cuh): a warp per 256-row window
// and group of four columns finds every row's run and tile from ballot
// head masks (a search over the keys only for a run that began more than
// 32 rows back), gathers the owned rows into registers in one batch of
// vector loads, runs the tree's eight in-tile levels by shuffles and
// register adds, and writes a one-tile segment's row of out directly; a
// longer segment's tile sums are folded by a warp, or a block, in the same
// tree order. No thread walks rows or tile sums one by one. Three device
// ops per call: the zero fill of out, the tile pass, the fold.
#include "segment_tree.cuh"

// out (G, S) f32 filled with 0 and scratch (ceil(N / 256) * (2 + S) int64)
// come from the caller.
extern "C" int segment_sums_launch(const void* vals, const void* perm,
                                   const void* seg, void* scratch, void* out,
                                   long long n, int s, long long g,
                                   void* stream) {
  if (n == 0 || s == 0 || g == 0) return 0;
  return static_cast<int>(run_tree_launch<false>(
      static_cast<const float*>(vals), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(seg), static_cast<float*>(out),
      static_cast<int64_t*>(scratch), n, s, g,
      static_cast<cudaStream_t>(stream)));
}
