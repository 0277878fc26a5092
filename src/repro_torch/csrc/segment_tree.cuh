// The pinned pairwise tree over runs of equal keys, shared by the segment-sum
// and scatter-merge kernels.
//
// The sum of a run (the rows whose sorted key equals one value) is a
// pairwise tree over the run's own rows, indexed relative to the run's first
// row: level k adds the node at relative index r (r a multiple of 2^(k+1))
// to the node at r + 2^k, if that exists. It depends only on the run's rows,
// in their order, never on where the run sits or on the launch shape. The
// plain versions in kernels/segment_stats.py write the same tree.
//
// Built in three steps, each one thread per item, no atomics:
//   run_starts_kernel  the first row of every run whose key is in [0, g);
//   run_tiles_kernel   the tree's subtrees over aligned tiles of TILE rows
//                      (relative to the run's first row), one thread per
//                      (tile, column) walking at most TILE rows;
//   run_tree           the levels above a tile: the same tree over the run's
//                      tile sums (a short last tile included), walked by one
//                      thread per (run, column).
// scatter_fold_kernel, the last step of both scatter merges, adds each run's
// tree onto its table cell.
// A walk keeps the pending left operands on a small stack — a binary
// counter: pushing item r merges one level per trailing one bit of r — and
// folds the stack at the end. No thread walks more than max(TILE, rows /
// TILE) items, so one long run (the pseudo-group of invalid rows) does not
// serialise on one thread.
#pragma once

#include "common.cuh"

#define REPRO_TREE_TILE_LOG 8
#define REPRO_TREE_TILE (1 << REPRO_TREE_TILE_LOG)
#define REPRO_TREE_LEVELS 48

// Push item number r (0-based) onto the binary-counter stack.
__device__ __forceinline__ void tree_push(float* stack, long long r,
                                          float carry) {
  int k = 0;
  for (; (r >> k) & 1; ++k) carry = stack[k] + carry;
  stack[k] = carry;
}

// Fold a stack that holds r items: its set bits are the occupied levels,
// joined from the lowest (rightmost, shortest) subtree up.
__device__ __forceinline__ float tree_fold(const float* stack, long long r,
                                           int levels) {
  float acc = 0.0f;
  bool have = false;
  for (int k = 0; k < levels; ++k) {
    if ((r >> k) & 1) {
      acc = have ? stack[k] + acc : stack[k];
      have = true;
    }
  }
  return acc;
}

// starts[key] = first row of the run of `key`, for keys in [0, g). Keys
// outside that range are dropped. starts comes filled with -1.
__global__ void run_starts_kernel(const int64_t* __restrict__ keys,
                                  int64_t* __restrict__ starts, long long n,
                                  long long g) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t key = keys[i];
  if (key < 0 || key >= g) return;
  if (i == 0 || keys[i - 1] != key) starts[key] = i;
}

// tiles[i, col] = the tree over rows [i, i + TILE) of i's run, for every
// tile head i (a row whose offset in its run is a multiple of TILE). Row r
// reads vals[perm[r], col], or vals[r, col] when perm is null.
__global__ void run_tiles_kernel(const float* __restrict__ vals,
                                 const int64_t* __restrict__ perm,
                                 const int64_t* __restrict__ keys,
                                 const int64_t* __restrict__ starts,
                                 float* __restrict__ tiles, long long n,
                                 int s, long long g) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * s) return;
  long long i = t / s;
  int col = static_cast<int>(t - i * s);
  int64_t key = keys[i];
  if (key < 0 || key >= g) return;
  if ((i - starts[key]) & (REPRO_TREE_TILE - 1)) return;  // not a tile head
  float stack[REPRO_TREE_TILE_LOG + 1];
  long long r = 0;
  for (long long row = i; r < REPRO_TREE_TILE && row < n && keys[row] == key;
       ++row, ++r) {
    long long src = perm ? perm[row] : row;
    tree_push(stack, r, vals[src * s + col]);
  }
  tiles[i * s + col] = tree_fold(stack, r, REPRO_TREE_TILE_LOG + 1);
}

// The whole tree of the run of `key` that starts at row `first`, from its
// tile sums.
__device__ __forceinline__ float run_tree(const float* __restrict__ tiles,
                                          const int64_t* __restrict__ keys,
                                          long long first, int64_t key,
                                          long long n, int s, int col) {
  float stack[REPRO_TREE_LEVELS];
  long long r = 0;
  for (long long row = first; row < n && keys[row] == key;
       row += REPRO_TREE_TILE, ++r)
    tree_push(stack, r, tiles[row * s + col]);
  return tree_fold(stack, r, REPRO_TREE_LEVELS);
}

// The first two steps, launched on `st`.
static inline cudaError_t run_tiles_launch(const float* vals,
                                           const int64_t* perm,
                                           const int64_t* keys,
                                           int64_t* starts, float* tiles,
                                           long long n, int s, long long g,
                                           cudaStream_t st) {
  const int threads = 256;
  run_starts_kernel<<<repro_blocks(n, threads), threads, 0, st>>>(
      keys, starts, n, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  run_tiles_kernel<<<repro_blocks(n * s, threads), threads, 0, st>>>(
      vals, perm, keys, starts, tiles, n, s, g);
  return cudaGetLastError();
}

// The scatter merges' last step: table[p, :] += tree(run of p), one thread
// per (run, column) — the run's first row finds itself in starts — so each
// cell has ONE writer. Positions outside [0, c) are dropped.
__global__ void scatter_fold_kernel(float* __restrict__ table,
                                    const int64_t* __restrict__ pos,
                                    const int64_t* __restrict__ starts,
                                    const float* __restrict__ tiles,
                                    long long b, int s, long long c) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= b * s) return;
  long long j = t / s;
  int col = static_cast<int>(t - j * s);
  int64_t p = pos[j];
  if (p < 0 || p >= c || starts[p] != j) return;  // one thread per run
  float run = run_tree(tiles, pos, j, p, b, s, col);
  table[p * s + col] = table[p * s + col] + run;
}
