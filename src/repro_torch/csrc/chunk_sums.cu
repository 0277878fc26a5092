// Canonical chunked column sums of an (N, S) stat bundle — every reduction
// of the online query's estimator (estimate_ate_from_stats), the
// propensity standardisation and the offline estimators.
//
// Replaces: repro/kernels/segment_stats.py::chunk_sums_pallas (Pallas, TPU)
// together with the sequential combine of chunked_sum.
//
// Computes partials[c, s] = sum of vals[1024c : 1024(c+1), s] (rows past N
// read as 0.0, exactly as a zero-padded tail) by the pinned halving tree of
// chunk_tree.cuh, then totals[s] = ((p[0, s] + p[1, s]) + p[2, s]) + ...,
// strictly in chunk order. Appending zero rows appends exact "+ 0.0"
// steps, so the totals are invariant to trailing zero padding (the
// capacity invariance the query path relies on). The plain version in
// kernels/segment_stats.py writes the same steps on a reshaped tensor:
// bitwise equal.
//
// Bound on the H100: memory (N*S*4 bytes in, one add per element); at the
// query's 10,240 x 5 the launch itself. Design: ONE launch per call. A
// warp reduces one (chunk, column) in registers (chunk_tree: no shared
// memory, no barrier); the warps of a block take neighbouring columns of
// the same rows, so L1 serves the strided repeats and each byte comes from
// DRAM once. Up to REPRO_CS_ONE_BLOCK_PAIRS pairs run in one block, which
// combines after one barrier; more run on many blocks, and the last block
// by ticket combines (chunk_combine: one lane a column, the other warps
// staging the partials ahead through shared memory). That combine is a
// chain of nb dependent adds a column, a floor the pinned order sets on
// large inputs. Output: one (nb + 1, S) buffer, the partials then the
// totals.
#include "chunk_tree.cuh"

// warps of a block when many blocks run
#define REPRO_CS_WARPS 16
// up to this many (chunk, column) pairs run in one block of up to 32 warps
#define REPRO_CS_ONE_BLOCK_PAIRS 64
// floats of each of the combine's two staging buffers
#define REPRO_CS_TILE 4096
// most blocks launched; their warps stride over the pairs
#define REPRO_CS_MAX_BLOCKS 65536

__global__ void __launch_bounds__(1024)
    chunk_sums_kernel(const float* __restrict__ vals, float* out,
                      unsigned int* ticket, long long n, long long s,
                      long long nb) {
  __shared__ __align__(16) float stage[2 * REPRO_CS_TILE];
  const long long warps = blockDim.x >> 5;
  chunk_pairs<false, 1>(vals, out, n, s, nb, s, 1,
                        blockIdx.x * warps + (threadIdx.x >> 5),
                        gridDim.x * warps);
  if (!chunk_last_block(ticket)) return;
  chunk_combine(out, out + nb * s, nb, s, stage, REPRO_CS_TILE);
  chunk_ticket_reset(ticket);
}

extern "C" int chunk_sums_launch(const void* vals, void* out, long long n,
                                 long long s, long long nb, void* ticket,
                                 void* stream) {
  if (n < 0 || s < 1 ||
      nb != (n > 0 ? (n + REPRO_CHUNK - 1) / REPRO_CHUNK : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = nb * s;
  unsigned int threads, blocks;
  if (pairs <= REPRO_CS_ONE_BLOCK_PAIRS) {
    // at least two warps: the combine stages with the second
    threads = 32u * static_cast<unsigned int>(
                        pairs < 2 ? 2 : (pairs > 32 ? 32 : pairs));
    blocks = 1u;
  } else {
    const long long want = (pairs + REPRO_CS_WARPS - 1) / REPRO_CS_WARPS;
    threads = 32u * REPRO_CS_WARPS;
    blocks = static_cast<unsigned int>(
        want < REPRO_CS_MAX_BLOCKS ? want : REPRO_CS_MAX_BLOCKS);
  }
  chunk_sums_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(out),
      static_cast<unsigned int*>(ticket), n, s, nb);
  return static_cast<int>(cudaGetLastError());
}
