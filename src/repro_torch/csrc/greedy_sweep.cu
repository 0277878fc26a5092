// The greedy sweep of nearest-neighbour matching without replacement.
//
// Replaces: the lax.scan of repro/core/matching.py::greedy_nnmnr (no TPU
// kernel: the reference runs the sweep as a scan; a scan on the hot path
// becomes a kernel here). The paper's greedy 1/2-approximation (Fig. 3):
// the candidate edges (d, control, treated), in their given order (the
// caller sorts them by distance, stable), are walked in that order, and an
// edge is taken iff
//   d < BIG, its control is unused, and its treated unit has fewer than k
//   controls;
// taking it marks the control used and counts it for the treated unit.
// Control and treated indices are clipped to [0, n_rows), as the scan
// clips them. Integer logic only, so kernel and plain version
// (kernels/greedy_sweep.py) agree bit for bit.
//
// Bound on the H100: each verdict depends on every earlier one (the exact
// problem is NLOGSPACE-hard, the paper's Prop. 1, and the greedy order is
// the contract), so the time is one dependent chain; the bytes it must
// move (21 per edge) would take microseconds. The design shortens the
// chain in three ways:
//
// 1. Compaction. An edge that is not below BIG (NaN included) is never
//    taken and changes no state, so dropping it, keeping the order of the
//    rest, leaves the taken set as it is, for any input order. Two passes
//    over all E edges on many blocks (each block a span of whole 4,096-edge
//    tiles): sweep_count_kernel counts each block's edges below BIG;
//    sweep_compact_kernel adds the counts of the blocks before it and
//    writes the indices of its edges below BIG in order (per warp, 16
//    ballots of 32 edges), and the last block writes the total. Counts and
//    offsets are 64-bit, as the edge indices are. The count stays on the
//    device.
// 2. One thread of one block walks the compacted edges only, with the
//    state in shared memory: used_c as bits, cnt_t as bytes (k <= 255 and
//    both fit in the opt-in shared memory beside the edge buffers: n_rows
//    up to ~177,000). Otherwise the same walk keeps the state in device
//    memory (the scratch the wrapper passes, zeroed here), a branch inside
//    the kernel.
// 3. Warps 1-8 stage the next 1,024 compacted edges (clipped (c, t) and
//    the edge index) into shared memory while the walking thread walks
//    the chunk before (double-buffered, one barrier per chunk), so the
//    chain per edge is the state's reads and writes only.
//
// Also here: greedy_sweep_serial_launch, the one-thread kernel this one
// replaced (state in device memory, one edge after another). Nothing
// calls it on a path; chip_smoke.py times the redesign against it on the
// same edges.
#include "common.cuh"

#define REPRO_SWEEP_BIG 3.4e38f
#define REPRO_SWEEP_THREADS 256
#define REPRO_SWEEP_WARP_EDGES 512  // 16 ballots of 32 edges
#define REPRO_SWEEP_TILE (8 * REPRO_SWEEP_WARP_EDGES)
#define REPRO_SWEEP_MAX_BLOCKS 4096
#define REPRO_SWEEP_CHUNK 1024
#define REPRO_SWEEP_STAGERS 8     // warps 1-8 stage, warp 0 walks
#define REPRO_SWEEP_WALK_THREADS (32 * (1 + REPRO_SWEEP_STAGERS))
#define REPRO_SWEEP_FULL 0xffffffffu

// ------------------------------------------------------------- compaction

__device__ __forceinline__ long long sweep_block_sum(long long v,
                                                     long long* s_w) {
  // the sum of v over the block's 8 warps (integer: exact in any order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(REPRO_SWEEP_FULL, v, o);
  __syncthreads();  // s_w is free
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < REPRO_SWEEP_THREADS / 32; ++w) t += s_w[w];
  return t;
}

__global__ void __launch_bounds__(REPRO_SWEEP_THREADS)
    sweep_count_kernel(const float* __restrict__ d, long long n,
                       long long span, long long* __restrict__ counts) {
  __shared__ long long s_w[REPRO_SWEEP_THREADS / 32];
  const long long lo = static_cast<long long>(blockIdx.x) * span;
  const long long hi = lo + span < n ? lo + span : n;
  long long cnt = 0;
  for (long long e = lo + threadIdx.x; e < hi; e += REPRO_SWEEP_THREADS)
    cnt += d[e] < REPRO_SWEEP_BIG ? 1 : 0;
  cnt = sweep_block_sum(cnt, s_w);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(REPRO_SWEEP_THREADS)
    sweep_compact_kernel(const float* __restrict__ d, long long n,
                         long long span, const long long* __restrict__ counts,
                         long long* __restrict__ edges,
                         long long* __restrict__ n_below) {
  __shared__ long long s_w[REPRO_SWEEP_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  long long before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x);
       b += REPRO_SWEEP_THREADS)
    before += counts[b];
  long long base = sweep_block_sum(before, s_w);
  const long long lo = static_cast<long long>(blockIdx.x) * span;
  const long long hi = lo + span < n ? lo + span : n;
  for (long long t0 = lo; t0 < hi; t0 += REPRO_SWEEP_TILE) {
    const long long w0 = t0 + warp * REPRO_SWEEP_WARP_EDGES;
    unsigned m[REPRO_SWEEP_WARP_EDGES / 32];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < REPRO_SWEEP_WARP_EDGES / 32; ++j) {
      const long long e = w0 + j * 32 + lane;
      m[j] = __ballot_sync(REPRO_SWEEP_FULL,
                           e < hi && d[e] < REPRO_SWEEP_BIG);
      mine += __popc(m[j]);
    }
    __syncthreads();  // s_w is free
    if (lane == 0) s_w[warp] = mine;
    __syncthreads();
    long long off = base, tile = 0;
#pragma unroll
    for (int w = 0; w < REPRO_SWEEP_THREADS / 32; ++w) {
      off += w < warp ? s_w[w] : 0;
      tile += s_w[w];
    }
#pragma unroll
    for (int j = 0; j < REPRO_SWEEP_WARP_EDGES / 32; ++j) {
      if ((m[j] >> lane) & 1u)
        edges[off + __popc(m[j] & lt)] = w0 + j * 32 + lane;
      off += __popc(m[j]);
    }
    base += tile;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *n_below = base;
}

// ------------------------------------------------------------------ sweep

// The walking thread: the m >= 1 staged edges of one chunk, in order. The
// state is the used bits and the counts (bytes in shared memory, int32 in
// device memory); one thread reads and writes it. Each edge is read from
// the buffer ahead of the state of the edge before it, so the chain is the
// state's loads and stores only.
template <typename Cnt>
__device__ __forceinline__ void sweep_walk(const int4* __restrict__ buf,
                                           int m, int k, unsigned* used,
                                           Cnt* cnt,
                                           bool* __restrict__ taken) {
  int4 next = buf[0];
  for (int j = 0; j < m; ++j) {
    const int4 v = next;
    next = buf[j + 1 < m ? j + 1 : j];
    const unsigned bit = 1u << (v.x & 31);
    const unsigned w = used[v.x >> 5];
    const int n = static_cast<int>(cnt[v.y]);
    if (!(w & bit) && n < k) {
      used[v.x >> 5] = w | bit;
      cnt[v.y] = static_cast<Cnt>(n + 1);
      taken[(static_cast<unsigned long long>(static_cast<unsigned>(v.w))
             << 32) | static_cast<unsigned>(v.z)] = true;
    }
  }
}

// Warps 1-8: the compacted edges [e0, e0 + m), clipped, in order into dst.
__device__ __forceinline__ void sweep_stage(
    int4* __restrict__ dst, const long long* __restrict__ edges,
    long long e0, int m, const long long* __restrict__ c,
    const long long* __restrict__ t, long long n_rows) {
  for (int j = threadIdx.x - 32; j < m; j += 32 * REPRO_SWEEP_STAGERS) {
    const long long e = edges[e0 + j];
    long long ci = c[e], ti = t[e];
    ci = ci < 0 ? 0 : (ci >= n_rows ? n_rows - 1 : ci);
    ti = ti < 0 ? 0 : (ti >= n_rows ? n_rows - 1 : ti);
    dst[j] = make_int4(static_cast<int>(ci), static_cast<int>(ti),
                       static_cast<int>(e & 0xffffffffLL),
                       static_cast<int>(e >> 32));
  }
}

// The state in shared memory: the used bits in whole 16-byte rows, then
// one count byte per row, rounded up to 16 bytes.
static __host__ __device__ long long sweep_used_words(long long n_rows) {
  return (n_rows + 127) / 128 * 4;
}

static __host__ __device__ long long sweep_shared_state_bytes(
    long long n_rows) {
  return sweep_used_words(n_rows) * 4 + (n_rows + 15) / 16 * 16;
}

// The walk over every compacted edge: the staging warps fill one buffer
// with the next chunk while the walking thread walks the other.
template <typename Cnt>
__device__ __forceinline__ void sweep_run(
    const long long* __restrict__ edges, long long n,
    const long long* __restrict__ c, const long long* __restrict__ t,
    long long n_rows, int k, unsigned* used, Cnt* cnt, int4* s_edge,
    bool* __restrict__ taken) {
  const int warp = threadIdx.x >> 5;
  if (warp > 0 && n > 0)
    sweep_stage(s_edge, edges, 0,
                static_cast<int>(n < REPRO_SWEEP_CHUNK ? n
                                                       : REPRO_SWEEP_CHUNK),
                c, t, n_rows);
  __syncthreads();
  int buf = 0;
  for (long long at = 0; at < n; at += REPRO_SWEEP_CHUNK, buf ^= 1) {
    const long long rest = n - at - REPRO_SWEEP_CHUNK;
    if (threadIdx.x == 0)
      sweep_walk(s_edge + buf * REPRO_SWEEP_CHUNK,
                 static_cast<int>(n - at < REPRO_SWEEP_CHUNK
                                      ? n - at : REPRO_SWEEP_CHUNK),
                 k, used, cnt, taken);
    else if (warp > 0 && rest > 0)
      sweep_stage(s_edge + (buf ^ 1) * REPRO_SWEEP_CHUNK, edges,
                  at + REPRO_SWEEP_CHUNK,
                  static_cast<int>(rest < REPRO_SWEEP_CHUNK
                                       ? rest : REPRO_SWEEP_CHUNK),
                  c, t, n_rows);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(REPRO_SWEEP_WALK_THREADS)
    sweep_walk_kernel(const long long* __restrict__ edges,
                      const long long* __restrict__ n_below,
                      const long long* __restrict__ c,
                      const long long* __restrict__ t, long long n_rows,
                      int k, int shared_state, unsigned* g_used, int* g_cnt,
                      bool* __restrict__ taken) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_edge = reinterpret_cast<int4*>(smem);
  unsigned* s_used =
      reinterpret_cast<unsigned*>(s_edge + 2 * REPRO_SWEEP_CHUNK);
  unsigned char* s_cnt =
      reinterpret_cast<unsigned char*>(s_used + sweep_used_words(n_rows));
  const long long n = *n_below;
  if (shared_state) {
    const long long bytes = sweep_shared_state_bytes(n_rows);
    int4* z = reinterpret_cast<int4*>(s_used);
    for (long long i = threadIdx.x; i < bytes / 16;
         i += REPRO_SWEEP_WALK_THREADS)
      z[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    sweep_run(edges, n, c, t, n_rows, k, s_used, s_cnt, s_edge, taken);
  } else {
    sweep_run(edges, n, c, t, n_rows, k, g_used, g_cnt, s_edge, taken);
  }
}

extern "C" long long greedy_sweep_scratch_words(long long n_edges,
                                                long long n_rows) {
  // int64 words: the compacted edge list, the count, the block counts and
  // the state in device memory (used bits, int32 counts)
  return n_edges + 1 + REPRO_SWEEP_MAX_BLOCKS + (n_rows + 63) / 64 +
         (n_rows + 1) / 2;
}

extern "C" int greedy_sweep_launch(const void* d, const void* c,
                                   const void* t, long long n_edges,
                                   long long n_rows, int k, void* scratch,
                                   long long scratch_words, void* taken,
                                   void* stream) {
  if (n_edges < 1 || n_rows < 1 || n_rows > 0x7FFFFFFFLL || k < 0 ||
      scratch_words < greedy_sweep_scratch_words(n_edges, n_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* edges = static_cast<long long*>(scratch);
  long long* n_below = edges + n_edges;
  long long* counts = n_below + 1;
  unsigned* g_used =
      reinterpret_cast<unsigned*>(counts + REPRO_SWEEP_MAX_BLOCKS);
  const long long words = (n_rows + 31) / 32;
  int* g_cnt = reinterpret_cast<int*>(g_used + ((words + 1) / 2) * 2);

  const long long tiles = (n_edges + REPRO_SWEEP_TILE - 1) / REPRO_SWEEP_TILE;
  const long long per = (tiles + REPRO_SWEEP_MAX_BLOCKS - 1) /
                        REPRO_SWEEP_MAX_BLOCKS;
  const long long span = per * REPRO_SWEEP_TILE;
  const unsigned blocks = static_cast<unsigned>((n_edges + span - 1) / span);
  const float* dp = static_cast<const float*>(d);
  sweep_count_kernel<<<blocks, REPRO_SWEEP_THREADS, 0, s>>>(dp, n_edges,
                                                            span, counts);
  sweep_compact_kernel<<<blocks, REPRO_SWEEP_THREADS, 0, s>>>(
      dp, n_edges, span, counts, edges, n_below);

  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long buffers = 2LL * REPRO_SWEEP_CHUNK * sizeof(int4);
  const long long state = sweep_shared_state_bytes(n_rows);
  const int shared_state = k <= 255 && buffers + state <= optin;
  const size_t smem =
      static_cast<size_t>(buffers + (shared_state ? state : 0));
  if (!shared_state) {
    cudaMemsetAsync(g_used, 0, words * 4, s);
    cudaMemsetAsync(g_cnt, 0, n_rows * 4, s);
  }
  cudaFuncSetAttribute(sweep_walk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sweep_walk_kernel<<<1, REPRO_SWEEP_WALK_THREADS, smem, s>>>(
      edges, n_below, static_cast<const long long*>(c),
      static_cast<const long long*>(t), n_rows, k, shared_state, g_used,
      g_cnt, static_cast<bool*>(taken));
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- the one-thread kernel

__global__ void greedy_sweep_serial_kernel(const float* __restrict__ d,
                                           const long long* __restrict__ c,
                                           const long long* __restrict__ t,
                                           long long n_edges,
                                           long long n_rows, int k,
                                           unsigned char* used_c, int* cnt_t,
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

extern "C" int greedy_sweep_serial_launch(const void* d, const void* c,
                                          const void* t, long long n_edges,
                                          long long n_rows, int k,
                                          void* used_c, void* cnt_t,
                                          void* taken, void* stream) {
  if (n_edges < 1 || n_rows < 1 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  greedy_sweep_serial_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const long long*>(c),
      static_cast<const long long*>(t), n_edges, n_rows, k,
      static_cast<unsigned char*>(used_c), static_cast<int*>(cnt_t),
      static_cast<unsigned char*>(taken));
  return static_cast<int>(cudaGetLastError());
}
