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
// written, plus the delta row and its position). Design (segment_tree.cuh):
// a warp per 256-row window of the delta and group of four columns, its
// rows' values and the one-tile runs' cells read in one batch of 16-byte
// loads, the in-tile tree levels in registers; a run of one tile (every
// unique position, and most runs) updates its cell right in that pass, and
// the long run of invalid rows is folded over its tile sums by one warp.
// Two device ops per call: the tile pass and the fold.
#include "segment_tree.cuh"

// scratch (ceil(B / 256) * (2 + S) int64) comes from the caller.
extern "C" int scatter_merge_launch(void* table, const void* pos,
                                    const void* vals, void* scratch,
                                    long long b, int s, long long c,
                                    void* stream) {
  if (b == 0 || s == 0 || c == 0) return 0;
  return static_cast<int>(run_tree_launch<true>(
      static_cast<const float*>(vals), nullptr,
      static_cast<const int64_t*>(pos), static_cast<float*>(table),
      static_cast<int64_t*>(scratch), b, s, c,
      static_cast<cudaStream_t>(stream)));
}
