// Partition-local fast-path merge of routed delta stat tables into a
// key-range partitioned view, in place, for every partition in ONE launch:
// tables[p, pos[p, j], :] += vals[p, j, :], duplicate positions summed.
//
// Replaces: repro/kernels/segment_stats.py::scatter_merge_parts_pallas
// (Pallas, TPU), which ran the single-table kernel's one-hot (C, B) @
// (B, S) matmul over a (P, blocks) grid. The matmul was the TPU's way to
// scatter; it is not carried over.
//
// PRECONDITION: pos[p, :] is non-decreasing within each partition p (not
// across partitions). The partitioned fast path guarantees it: partition
// p's routed delta rows are key-sorted, its padding rows carry the invalid
// marker (the largest key), and a lower-bound lookup in p's sorted table
// (clipped to C-1) is monotone in the key. The padding rows — most of the
// (P, B) input, since every partition is padded to the delta's full
// length — all look up to one slot of their partition: its first padding
// slot, or C-1 when the partition is full. They carry zero stats and are
// SUMMED like any run (exact zeros; no per-partition row count is passed,
// so no host read is needed to skip them).
//
// Runs are keyed by (partition, position): a first pass maps row (p, j) to
// the slot p*C + pos[p, j] of the flattened (P*C, S) tables, or to -1 when
// pos[p, j] is outside [0, C) — dropped BEFORE the offset, so it never
// lands in a neighbouring partition. Two partitions' rows never share a
// slot, even where a 256-row tile straddles their boundary with equal
// positions on both sides. Then the single-table kernel's machinery runs on
// the flattened tables (segment_tree.cuh): each run summed by the pinned
// pairwise tree in delta-row order, added onto its cell by ONE writer. No
// float atomics. So tables[p] ends bit for bit as scatter_merge(tables[p],
// pos[p], vals[p]) would leave it.
//
// Bound on the H100: memory (per touched slot: the table cells read and
// written; per row: its position and its delta stats). Design: the slot
// pass, then scatter_merge.cu's machinery (segment_tree.cuh) on the
// flattened rows: a warp per 256-row window, one-tile runs merged in the
// tile pass, a partition's long padding run folded over its tile sums.
// Three device ops per call.
#include "segment_tree.cuh"

// slots[i] = p*c + pos[i] for row i = p*b + j, or -1 when pos[i] is outside
// [0, c).
__global__ void part_slots_kernel(const int64_t* __restrict__ pos,
                                  int64_t* __restrict__ slots, long long n,
                                  long long b, long long c) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t q = pos[i];
  slots[i] = (q >= 0 && q < c) ? (i / b) * c + q : -1;
}

// slots (P*B,) int64 and scratch (ceil(P*B / 256) * (2 + S) int64) come
// from the caller.
extern "C" int scatter_merge_parts_launch(void* tables, const void* pos,
                                          const void* vals, void* slots,
                                          void* scratch, long long p,
                                          long long b, int s, long long c,
                                          void* stream) {
  if (p == 0 || b == 0 || s == 0 || c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = p * b;
  int64_t* slots_p = static_cast<int64_t*>(slots);
  const int threads = 256;
  part_slots_kernel<<<repro_blocks(n, threads), threads, 0, st>>>(
      static_cast<const int64_t*>(pos), slots_p, n, b, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_tree_launch<true>(
      static_cast<const float*>(vals), nullptr, slots_p,
      static_cast<float*>(tables), static_cast<int64_t*>(scratch), n, s,
      p * c, st));
}
