// The pinned chunk tree and the chunk-order combine, shared by the
// chunk_sums and logistic_newton_terms kernels.
//
// A chunk is 1,024 rows x[0..1023] of one column (+0.0 past the data). Its
// sum is pinned to ten halving steps: x[i] + x[i+512] for i < 512, then
// + 256, ..., + 1 (the plain versions' reshape-and-add in
// kernels/segment_stats.py). A warp holds the chunk as 32 registers a
// lane, lane l holding x[l + 32a] in v[a]: the steps h = 512 ... 32 pair
// v[a] with v[a + h/32] inside the lane, the steps 16 ... 1 pair lanes by
// __shfl_down_sync. Only the pairing fixes the bits (an IEEE add is
// commutative), so where an add runs does not matter. Chunk sums are then
// added strictly in chunk order, starting from chunk 0's own value (not
// from 0.0: -0.0 + -0.0 stays -0.0).
//
// Across blocks the chunk-order combine runs in the launch that made the
// chunk sums: every block writes its sums, fences, and takes an integer
// ticket; the block that draws the last one combines and puts the counter
// back to 0 (the pattern of the CUDA samples' threadFenceReduction). No
// float atomics: the same inputs give the same bits on every run.
#pragma once

#include "common.cuh"

#define REPRO_CHUNK 1024

// The chunk's sum (in lane 0) from v[a] = x[lane + 32a]. Lanes past 32 - o
// read their own value at shuffle step o; no lane that feeds lane 0 does.
// (Loops of constant trip counts, so both unroll and v stays in
// registers.)
__device__ __forceinline__ float chunk_tree(float (&v)[32]) {
#pragma unroll
  for (int k = 4; k >= 0; --k) {
#pragma unroll
    for (int a = 0; a < 16; ++a)
      if (a < (1 << k)) v[a] = __fadd_rn(v[a], v[a + (1 << k)]);
  }
  float x = v[0];
#pragma unroll
  for (int k = 4; k >= 0; --k)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, 1 << k));
  return x;
}

// Chunk sums of the columns of an (n, s) matrix whose element (r, c) lies
// at src[r * rs + c * cs], over nb chunks of rows: pair p = chunk * s + col
// is reduced by one warp and written to out[p], so out is (nb, s)
// row-major. Pairs are dealt from `warp0` in steps of `warps` (warp-uniform,
// so every lane of a warp takes part in its shuffles), P at a time: the
// loads of P pairs are in flight together. COHERENT reads past L1: the
// matrix was written by other blocks of this launch.
template <bool COHERENT, int P>
__device__ __forceinline__ void chunk_pairs(const float* src, float* out,
                                            long long n, long long s,
                                            long long nb, long long rs,
                                            long long cs, long long warp0,
                                            long long warps) {
  const int lane = threadIdx.x & 31;
  const long long pairs = nb * s;
  for (long long p0 = warp0; p0 < pairs; p0 += P * warps) {
    float v[P][32];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const long long p = p0 + j * warps;
      const long long c = p / s, col = p - c * s;
      const long long r0 = c * REPRO_CHUNK + lane;
      const float* base = src + col * cs;
#pragma unroll
      for (int a = 0; a < 32; ++a) {
        const long long r = r0 + 32 * a;
        v[j][a] = p < pairs && r < n
                      ? (COHERENT ? __ldcg(base + r * rs)
                                  : __ldg(base + r * rs))
                      : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const long long p = p0 + j * warps;
      if (p < pairs) {
        const float x = chunk_tree(v[j]);
        if (lane == 0) out[p] = x;
      }
    }
  }
}

// True, in every thread of the block, for the block that finished last. A
// one-block grid needs no ticket (one barrier). Every thread fences its own
// writes before the block's ticket; the last block fences again before it
// reads what the others wrote.
__device__ __forceinline__ bool chunk_last_block(unsigned int* ticket) {
  __shared__ bool last;
  if (gridDim.x == 1) {
    __syncthreads();
    return true;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block puts the counter back to 0 for the next launch on the
// stream (launches on one stream run one after the other).
__device__ __forceinline__ void chunk_ticket_reset(unsigned int* ticket) {
  if (gridDim.x > 1 && threadIdx.x == 0) *ticket = 0u;
}

// totals[c] = ((part[0][c] + part[1][c]) + part[2][c]) + ... over the
// (nb, s) row-major partials, strictly in chunk order. Columns go in groups
// of 32: lane c of warp 0 adds column c0 + c while the block's other warps
// stage the next rows into the other of two buffers of `tile` floats
// (16-byte aligned). A buffer holds the rows column by column, `pitch`
// floats a column, so the lane reads its column four rows at a time and
// eight rows ahead of its adds: the dependent chain is the adds alone.
// Needs blockDim.x >= 64 and tile >= 256; reads the partials past L1.
__device__ __forceinline__ void chunk_combine(const float* part,
                                              float* totals, long long nb,
                                              long long s, float* stage,
                                              int tile) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (long long c0 = 0; c0 < s; c0 += 32) {
    const int w = static_cast<int>(s - c0 < 32 ? s - c0 : 32);
    // rows a buffer holds (a multiple of 4, at least 4) and the column
    // pitch (4 more: the read-ahead stays inside the column)
    const int rows = (tile / w - 4) & ~3, pitch = rows + 4;
    const long long n_tiles = (nb + rows - 1) / rows;
    // rows [k * rows, ...) of the group's columns into buf, by the threads
    // from `first` on, eight loads a thread in flight at once; with w == s
    // the rows are contiguous in part
    auto stage_rows = [&](long long k, float* buf, int first) {
      const long long r0 = k * rows;
      const int cnt =
          static_cast<int>((nb - r0 < rows ? nb - r0 : rows) * w);
      const float* src = part + r0 * s + c0;
      const int step = blockDim.x - first;
      for (int e0 = tid - first; e0 < cnt; e0 += 8 * step) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * step;
          x[u] = e < cnt ? __ldcg(w == s ? src + e
                                         : src + static_cast<long long>(
                                                     e / w) * s + e % w)
                         : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * step, r = e / w;
          if (e < cnt) buf[(e - r * w) * pitch + r] = x[u];
        }
      }
    };
    stage_rows(0, stage, 0);
    __syncthreads();
    float t = 0.0f;
    for (long long k = 0; k < n_tiles; ++k) {
      const float* cur = stage + (k & 1) * tile;
      if (warp == 0) {
        if (lane < w) {
          const int cnt = static_cast<int>(
              nb - k * rows < rows ? nb - k * rows : rows);
          const float* col = cur + lane * pitch;
          int r = 0;
          if (k == 0) {
            t = col[0];
            r = 1;
          }
          for (; r < cnt && (r & 3); ++r) t = __fadd_rn(t, col[r]);
          // whole eights, their loads issued eight rows ahead
          const int full = r + (cnt - r) / 8 * 8, ahead = pitch - 8;
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
          if (r < full) {
            a = *reinterpret_cast<const float4*>(col + r);
            b = *reinterpret_cast<const float4*>(col + r + 4);
          }
          for (; r < full; r += 8) {
            const float4 na =
                *reinterpret_cast<const float4*>(col + min(r + 8, ahead));
            const float4 nb4 = *reinterpret_cast<const float4*>(
                col + min(r + 12, ahead + 4));
            t = __fadd_rn(t, a.x);
            t = __fadd_rn(t, a.y);
            t = __fadd_rn(t, a.z);
            t = __fadd_rn(t, a.w);
            t = __fadd_rn(t, b.x);
            t = __fadd_rn(t, b.y);
            t = __fadd_rn(t, b.z);
            t = __fadd_rn(t, b.w);
            a = na;
            b = nb4;
          }
          for (; r < cnt; ++r) t = __fadd_rn(t, col[r]);
        }
      } else if (k + 1 < n_tiles) {
        stage_rows(k + 1, stage + ((k + 1) & 1) * tile, 32);
      }
      __syncthreads();
    }
    if (warp == 0 && lane < w) totals[c0 + lane] = t;
  }
}
