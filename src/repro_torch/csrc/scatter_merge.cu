// Fast-path merge of a delta stat table into a materialized view, in place:
// table[pos[j], :] += vals[j, :], duplicate positions summed.
//
// Replaces: repro/kernels/segment_stats.py::scatter_merge_pallas (Pallas,
// TPU), which routed the scatter through a one-hot (C, B) @ (B, S) matmul.
//
// PRECONDITION: pos is non-decreasing. The online engine's fast path
// guarantees it: the delta and the view are both key-sorted, the invalid
// marker sorts last, and a lower-bound lookup (clipped to C-1) is monotone
// in the key (tests/test_torch_online.py asserts it on the engine's fast
// path). Duplicates DO occur there: every invalid row of a rolled-up delta
// carries zero stats and looks up to the same slot — the view's first
// padding slot, or C-1 when the view is full, which may be a valid group's
// slot. That run can hold thousands of rows.
//
// Order (pinned, bit for bit the plain version's): each run of equal
// positions is summed as the pairwise tree of segment_tree.cuh, in
// delta-row order, and the run's sum is added onto the table cell by ONE
// writer: table[p] = table[p] + tree(run). No float atomics, no lost
// updates. Positions outside [0, C) are dropped.
//
// Bound on the H100: memory (per touched row: the table cells read and
// written, plus the delta row and its position). Design: the tree's tiles
// in parallel, then one thread per (run, column) folds the run's tile sums
// and updates the cell, so the long run of invalid rows costs max(256,
// rows / 256) steps on its thread, not rows.
#include "segment_tree.cuh"

// starts (C,) int64 filled with -1 and tiles (B, S) f32 scratch come from
// the caller.
extern "C" int scatter_merge_launch(void* table, const void* pos,
                                    const void* vals, void* starts,
                                    void* tiles, long long b, int s,
                                    long long c, void* stream) {
  if (b == 0 || s == 0 || c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* pos_p = static_cast<const int64_t*>(pos);
  int64_t* starts_p = static_cast<int64_t*>(starts);
  float* tiles_p = static_cast<float*>(tiles);
  cudaError_t err = run_tiles_launch(static_cast<const float*>(vals), nullptr,
                                     pos_p, starts_p, tiles_p, b, s, c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  scatter_fold_kernel<<<repro_blocks(b * s, threads), threads, 0, st>>>(
      static_cast<float*>(table), pos_p, starts_p, tiles_p, b, s, c);
  return static_cast<int>(cudaGetLastError());
}
