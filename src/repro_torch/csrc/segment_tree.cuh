// The pinned pairwise tree over runs of equal keys, shared by the segment-sum
// and scatter-merge kernels.
//
// The sum of a run (the rows whose key equals one value) is a pairwise tree
// over the run's own rows, indexed relative to the run's first row: level k
// adds the node at relative index r (r a multiple of 2^(k+1)) to the node at
// r + 2^k, if that exists; a node with no right operand passes through
// unchanged (never `+ 0.0`: -0.0 + 0.0 is +0.0). It depends only on the run's
// rows, in their order, never on where the run sits or on the launch shape.
// The plain versions in kernels/segment_stats.py write the same tree.
//
// PRECONDITION: the rows of every kept key (a key in [0, g)) are contiguous.
// Rows whose key is outside [0, g) are dropped and may sit anywhere.
//
// Two kernels, no atomics, no order that depends on scheduling:
//
// run_tiles_kernel: one warp per window of TILE = 256 rows and group of four
//   columns (gridDim.y groups). A run's TILE-row tiles start at its first
//   row, so they straddle windows; a window's warp owns the tiles whose FIRST
//   row lies in the window (a tile ends at most 255 rows past it). The warp
//   loads the keys of rows [w0 - 32, w0 + 512) in coalesced 32-row words,
//   with each row's perm entry in the same batch, and turns the keys into
//   run-head bit masks by ballot (a head is a row whose key differs from the
//   row before). The start of the run crossing into the window comes from
//   those masks, or, for a run that began more than 32 rows back, from a
//   warp search over the keys (32 probes per step: galloping back, then
//   narrowing). So every row knows its run start, run end, tile and the
//   levels at which it is a left node up front, without a branch; nothing is
//   found one row at a time. Lane l holds rows w0 + 32t + l (t < 16); the
//   owned rows' four columns are gathered into registers in one batch, with
//   16- or 8-byte loads where the row stride and base pointer allow. The
//   tree's eight in-tile levels run in registers: row q's right operand q +
//   2^k is lane + 2^k of the same word (a shuffle) for 2^k < 32, the same
//   lane 2^k / 32 words on above. A run of one tile (nearly every run) is
//   written to its destination right there: out[key] = tree (segment sums)
//   or table[key] = table[key] + tree (scatter merges, the cell read in the
//   gather's batch), one writer per cell. A run of several tiles leaves its
//   tile sums in the window records of `scratch`, and the window holding its
//   last tile records the run's bounds for the fold.
// run_fold_kernel: a warp per window reads its fold record; each recorded
//   run's tile sums (tile j is the tree's node j at level 8) are folded by
//   the same pairwise tree, cooperatively in shared memory: a run whose
//   tiles fit one warp's buffer by that warp, a longer one by the warp's
//   whole block of eight, in super-chunks of eight power-of-two chunks side
//   by side, joined in order by a binary counter. Then the run's
//   destination is written as above. Every loop over tile sums issues its
//   loads together before it uses one.
//
// scratch: per window of 256 rows, 2 + S int64 words: the fold record (s, or
// -1, then e), then two tile sums of S floats — slot A, the tile of a run
// that began in an earlier window, and slot B, the first tile of a run that
// begins here and is longer than one tile (at most one of each per window).
#pragma once

#include "common.cuh"

#define REPRO_TREE_TILE_LOG 8
#define REPRO_TREE_TILE (1 << REPRO_TREE_TILE_LOG)
// rows before its window that a warp loads (the search's first probes)
#define REPRO_TREE_BACK 32
// rows of a warp's region: BACK, its window, and the TILE rows after it
#define REPRO_TREE_REGION (REPRO_TREE_BACK + 2 * REPRO_TREE_TILE)
#define REPRO_TREE_WORDS (REPRO_TREE_REGION / 32)
#define REPRO_TREE_SPAN (2 * REPRO_TREE_TILE)
#define REPRO_TREE_WARPS 4
#define REPRO_TREE_CW 4
#define REPRO_FOLD_WARPS 8
#define REPRO_FOLD_BUF 1024
#define REPRO_FOLD_CG 16
#define REPRO_FOLD_LEVELS 32
#define REPRO_FULL_MASK 0xffffffffu

// Push item number r (0-based) onto a binary-counter stack of subtrees:
// pushing item r joins one level per trailing one bit of r.
__device__ __forceinline__ void tree_push(float* stack, long long r,
                                          float carry) {
  int k = 0;
  for (; (r >> k) & 1; ++k) carry = stack[k] + carry;
  stack[k] = carry;
}

// Fold a stack that holds r items: its set bits are the occupied levels,
// joined from the lowest (rightmost, shortest) subtree up.
__device__ __forceinline__ float tree_fold(const float* stack, long long r) {
  float acc = 0.0f;
  bool have = false;
  for (int k = 0; k < REPRO_FOLD_LEVELS; ++k) {
    if ((r >> k) & 1) {
      acc = have ? stack[k] + acc : stack[k];
      have = true;
    }
  }
  return acc;
}

// The first row of the run of key `key`, given keys[hi] == key and that
// the run holds the 32 rows before hi; the whole warp calls it. A kept
// key's rows are contiguous, so keys[j] == key exactly for j in [start,
// hi]: 32 probes a step, galloping back from stride 32 by powers of 32
// until a probe differs, then narrowing the bracket 32-fold per step.
__device__ long long tree_run_start(const int64_t* __restrict__ keys,
                                    long long hi, int64_t key, int lane) {
  long long lo, step = 32;
  for (;;) {
    long long j = hi - step * (lane + 1);
    bool differs = j < 0 || keys[j] != key;
    unsigned b = __ballot_sync(REPRO_FULL_MASK, differs);
    if (b) {
      int f = __ffs(b) - 1;
      lo = hi - step * (f + 1);
      hi -= step * f;
      break;
    }
    hi -= step * 32;
    step *= 32;
  }
  // keys[lo] != key (or lo < 0), keys[hi] == key
  while (hi - lo > 1) {
    long long step2 = (hi - lo + 31) / 32;
    long long j = lo + step2 * (lane + 1);
    bool equal = j >= hi || (j >= 0 && keys[j] == key);
    int f = __ffs(__ballot_sync(REPRO_FULL_MASK, equal)) - 1;
    long long nhi = lo + step2 * (f + 1);
    lo += step2 * f;
    if (nhi < hi) hi = nhi;
  }
  return hi;
}

// Row meta of a lane's 16 rows, packed: bit 0 the row is in a tile this
// warp owns; bits 1-8 its tile's first row, relative to the window; bit 9
// the tile is its run's first, bit 10 its run's last; bits 11-14 the number
// of levels at which the row is a left node with a right operand (levels
// 0 .. n-1: its offset in the tile is a multiple of 2^(k+1) and row + 2^k
// is inside the tile).
#define REPRO_META_T0(m) (((m) >> 1) & 0xff)
#define REPRO_META_FIRST (1u << 9)
#define REPRO_META_LAST (1u << 10)
#define REPRO_META_LEVELS(m) (((m) >> 11) & 0xf)
#define REPRO_ROWS (REPRO_TREE_WORDS - 1)

// One level of the in-tile tree on words [T0, T0 + ROWS/2) of a lane's
// rows, all its shuffles in flight together: row q adds row q + 2^lv
// where meta says it is a left node. Row q + 2^lv is lane + 2^lv of the
// same word (a shuffle) below 32, the same lane 2^lv / 32 words on above
// (indices clamped for the compiler: a clamped read is never a right
// operand, row q + 2^lv stays inside its tile).
template <int T0>
__device__ __forceinline__ void tree_level(
    float (&v)[REPRO_ROWS][REPRO_TREE_CW], const unsigned (&meta)[REPRO_ROWS],
    int lv, int lane) {
  const int h = 1 << lv;
  float right[REPRO_ROWS / 2][REPRO_TREE_CW];
#pragma unroll
  for (int u = 0; u < REPRO_ROWS / 2; ++u) {
    const int t = T0 + u;
#pragma unroll
    for (int j = 0; j < REPRO_TREE_CW; ++j) {
      if (h < 32) {
        const float next = v[min(t + 1, REPRO_ROWS - 1)][j];
        right[u][j] = __shfl_sync(REPRO_FULL_MASK,
                                  lane >= h ? v[t][j] : next,
                                  (lane + h) & 31);
      } else {
        right[u][j] = v[min(t + h / 32, REPRO_ROWS - 1)][j];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < REPRO_ROWS / 2; ++u) {
    const int t = T0 + u;
    if (static_cast<int>(REPRO_META_LEVELS(meta[t])) > lv) {
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; ++j) v[t][j] = v[t][j] + right[u][j];
    }
  }
}

// The tile pass; see the header comment. MERGE: dst is the (g, S) table and
// each one-tile run is added onto its cell; else dst is the zero-filled
// (g, S) output and the run's sum is written there. perm may be null (row r
// reads vals[r]). vec: 4 or 2 when every row's S floats may be read in 16-
// or 8-byte pieces (S a multiple of it, vals aligned to it), else 1.
// n, g < 2^31.
template <bool MERGE>
__global__ void __launch_bounds__(REPRO_TREE_WARPS * 32)
    run_tiles_kernel(const float* __restrict__ vals,
                     const int64_t* __restrict__ perm,
                     const int64_t* __restrict__ keys, float* __restrict__ dst,
                     int64_t* __restrict__ scratch, long long n, int s,
                     long long g, int vec) {
  __shared__ unsigned heads_sh[REPRO_TREE_WARPS][REPRO_TREE_WORDS];
  __shared__ unsigned kept_sh[REPRO_TREE_WARPS][REPRO_TREE_WORDS];
  __shared__ int last_sh[REPRO_TREE_WARPS][REPRO_TREE_WORDS];
  __shared__ int first_sh[REPRO_TREE_WARPS][REPRO_TREE_WORDS];
  __shared__ int cells_sh[REPRO_TREE_WARPS][REPRO_TREE_SPAN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m =
      static_cast<long long>(blockIdx.x) * REPRO_TREE_WARPS + warp;
  if (m * REPRO_TREE_TILE >= n) return;  // the whole warp
  unsigned* hw = heads_sh[warp];
  unsigned* kw = kept_sh[warp];
  int* last = last_sh[warp];
  int* first = first_sh[warp];
  int* cells = cells_sh[warp];
  const long long w0 = m * REPRO_TREE_TILE;
  const long long w1 = min(w0 + REPRO_TREE_TILE, n);
  const long long r0 = w0 - REPRO_TREE_BACK;
  int64_t* rec = scratch + m * (2 + s);
  float* slots = reinterpret_cast<float*>(rec + 2);

  // keys -> head and kept bit words; word t holds rows r0 + 32t + lane. A
  // row past the end is a head (it ends the last run); the first row's
  // head bit is unknown (its predecessor is not loaded) and left 0
  // (each row's source row is loaded in the same batch as the keys, for
  // every row of the span: the gather then waits one round trip less)
  int64_t k[REPRO_TREE_WORDS];
  int src[REPRO_ROWS];
#pragma unroll
  for (int t = 0; t < REPRO_TREE_WORDS; ++t) {
    const long long r = r0 + 32 * t + lane;
    k[t] = (r >= 0 && r < n) ? keys[r] : 0;
  }
#pragma unroll
  for (int t = 0; t < REPRO_ROWS; ++t) {
    const long long row = w0 + 32 * t + lane;
    src[t] = row >= n ? -1
             : perm   ? static_cast<int>(perm[row])
                      : static_cast<int>(row);
  }
  const int64_t cross_key = __shfl_sync(REPRO_FULL_MASK, k[1], 0);
#pragma unroll
  for (int t = 0; t < REPRO_TREE_WORDS; ++t) {
    const long long r = r0 + 32 * t + lane;
    int64_t before = __shfl_up_sync(REPRO_FULL_MASK, k[t], 1);
    if (t > 0) {
      const int64_t carry = __shfl_sync(REPRO_FULL_MASK, k[t - 1], 31);
      if (lane == 0) before = carry;
    }
    const bool head = r >= n || r == 0 ||
                      (r > 0 && (t > 0 || lane > 0) && before != k[t]);
    const bool kept = r >= 0 && r < n && k[t] >= 0 && k[t] < g;
    const unsigned hb = __ballot_sync(REPRO_FULL_MASK, head);
    const unsigned kb = __ballot_sync(REPRO_FULL_MASK, kept);
    if (lane == 0) {
      hw[t] = hb;
      kw[t] = kb;
    }
    if (t > 0) cells[32 * (t - 1) + lane] = static_cast<int>(k[t]);
  }
  __syncwarp();
  // per word: the last head up to it and the first head from it (a scan
  // over the words, lane w holding word w)
  {
    const unsigned b = lane < REPRO_TREE_WORDS ? hw[lane] : 0u;
    int lst = b ? (lane << 5) + 31 - __clz(b) : -1;
    int fst = b ? (lane << 5) + __ffs(b) - 1 : REPRO_TREE_REGION;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(REPRO_FULL_MASK, lst, d);
      const int down = __shfl_down_sync(REPRO_FULL_MASK, fst, d);
      if (lane >= d) lst = max(lst, up);
      if (lane + d < 32) fst = min(fst, down);
    }
    if (lane < REPRO_TREE_WORDS) {
      last[lane] = lst;
      first[lane] = fst;
    }
  }
  __syncwarp();

  // the run crossing into the window (row w0 not a head): its start
  long long s_cross = -1;
  if (!(hw[1] & 1u) && (kw[1] & 1u)) {
    const int ph = last[0];  // the last head before row w0
    s_cross = ph >= 0 ? r0 + ph : tree_run_start(keys, r0, cross_key, lane);
  }

  // every row's tile, and the fold record of the window, without a branch
  // (the words' loads and the bit arithmetic of all rows overlap). Rows
  // from the first head at or after the window's end on are in tiles of
  // later windows, so no word past it holds an owned row.
  const int words =
      (first[(REPRO_TREE_BACK + REPRO_TREE_TILE) >> 5] - REPRO_TREE_BACK +
       31) >> 5;
  // (32-bit offsets from w0 throughout: n < 2^31; sx is the crossing
  // run's start, rows q < nq exist, tile heads q < wq are the window's)
  const int sx = static_cast<int>(s_cross - w0);
  const int nq = static_cast<int>(min(n - w0, static_cast<long long>(
                                                  REPRO_TREE_SPAN)));
  const int wq = static_cast<int>(w1 - w0);
  unsigned meta[REPRO_ROWS];
  bool last_tile = false;  // this lane heads the last tile of a longer run
  int reg_s = 0, reg_e = 0;
  int levels = 0;
#pragma unroll
  for (int t = 0; t < REPRO_ROWS; ++t) {
    const int w = t + 1;  // the region word of this row
    const int q = 32 * t + lane;
    const unsigned hb = hw[w];
    const unsigned below = hb & (REPRO_FULL_MASK >> (31 - lane));
    const unsigned above =
        lane == 31 ? 0u : hb & (REPRO_FULL_MASK << (lane + 1));
    const int ph = below ? 32 * w + 31 - __clz(below) : last[w - 1];
    const int nh = above ? 32 * w + __ffs(above) - 1
                   : w + 1 < REPRO_TREE_WORDS
                       ? first[min(w + 1, REPRO_TREE_WORDS - 1)]
                       : REPRO_TREE_REGION;
    const int rs = ph >= 0 ? ph - REPRO_TREE_BACK : sx;
    const int re = nh - REPRO_TREE_BACK;
    const int t0 = rs + ((q - rs) & ~(REPRO_TREE_TILE - 1));
    const int te = min(t0 + REPRO_TREE_TILE, re);
    const bool own = t < words && q < nq && ((kw[w] >> lane) & 1u) &&
                     t0 >= 0 && t0 < wq;
    const int rel = q - t0;
    const int rem = te - q;
    const int nlev = min(rel ? __ffs(rel) - 1 : REPRO_TREE_TILE_LOG,
                         rem > 1 ? 32 - __clz(rem - 1) : 0);
    meta[t] = own ? 1u | static_cast<unsigned>(t0) << 1 |
                        (t0 == rs ? REPRO_META_FIRST : 0u) |
                        (te == re ? REPRO_META_LAST : 0u) |
                        static_cast<unsigned>(nlev) << 11
                  : 0u;
    if (own && q == t0 && t0 != rs && te == re) {
      last_tile = true;
      reg_s = rs;
      reg_e = re;
    }
    if (own) levels = max(levels, nlev);
    if (!own) src[t] = -1;
  }
  const unsigned reg = __ballot_sync(REPRO_FULL_MASK, last_tile);
  if (blockIdx.y == 0 && (reg ? lane == __ffs(reg) - 1 : lane == 0)) {
    rec[0] = reg ? w0 + reg_s : -1;
    rec[1] = w0 + reg_e;
  }
  levels = static_cast<int>(
      __reduce_max_sync(REPRO_FULL_MASK, static_cast<unsigned>(levels)));

  // this block's columns [c0, c0 + cw): every owned row's into registers
  // (and, for a merge, the cells of the one-tile runs), all loads in
  // flight at once
  const int c0 = blockIdx.y * REPRO_TREE_CW;
  const int cw = min(REPRO_TREE_CW, s - c0);
  float v[REPRO_ROWS][REPRO_TREE_CW];
  float old[REPRO_ROWS][REPRO_TREE_CW];
#pragma unroll
  for (int t = 0; t < REPRO_ROWS; ++t) {
#pragma unroll
    for (int j = 0; j < REPRO_TREE_CW; ++j) v[t][j] = 0.0f;
    if (src[t] < 0) continue;
    const float* p = vals + static_cast<long long>(src[t]) * s + c0;
    if (vec == 4) {
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; j += 4) {
        const float4 y = *reinterpret_cast<const float4*>(p + j);
        v[t][j] = y.x;
        v[t][j + 1] = y.y;
        v[t][j + 2] = y.z;
        v[t][j + 3] = y.w;
      }
    } else if (vec == 2) {
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; j += 2)
        if (j < cw) {
          const float2 y = *reinterpret_cast<const float2*>(p + j);
          v[t][j] = y.x;
          v[t][j + 1] = y.y;
        }
    } else {
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; ++j)
        if (j < cw) v[t][j] = p[j];
    }
    const unsigned mt = meta[t];
    if (MERGE && 32 * t + lane == static_cast<int>(REPRO_META_T0(mt)) &&
        (mt & REPRO_META_FIRST) && (mt & REPRO_META_LAST)) {
      const float* d =
          dst + static_cast<long long>(cells[32 * t + lane]) * s + c0;
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; ++j)
        if (j < cw) old[t][j] = d[j];
    }
  }
  // the tree's levels inside each tile, on the first half of the span,
  // then on the second where the span reaches it
#pragma unroll
  for (int lv = 0; lv < REPRO_TREE_TILE_LOG; ++lv) {
    if (lv >= levels) break;
    tree_level<0>(v, meta, lv, lane);
    if (words > REPRO_ROWS / 2) tree_level<REPRO_ROWS / 2>(v, meta, lv, lane);
  }
  // each tile head: a one-tile run to its destination, else a slot
#pragma unroll
  for (int t = 0; t < REPRO_ROWS; ++t) {
    const unsigned mt = meta[t];
    const int q = 32 * t + lane;
    if (!(mt & 1u) || q != static_cast<int>(REPRO_META_T0(mt))) continue;
    if ((mt & REPRO_META_FIRST) && (mt & REPRO_META_LAST)) {
      float* d = dst + static_cast<long long>(cells[q]) * s + c0;
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; ++j)
        if (j < cw) d[j] = MERGE ? old[t][j] + v[t][j] : v[t][j];
    } else {
      float* d = slots + ((mt & REPRO_META_FIRST) ? s : 0) + c0;
#pragma unroll
      for (int j = 0; j < REPRO_TREE_CW; ++j)
        if (j < cw) d[j] = v[t][j];
    }
  }
}

// The tree over the first `cnt` tiles of a warp's column-major buffer b
// (b[col * ch + jt], cg columns), by the calling warp: level k adds tile
// a + 2^k onto tile a, a a multiple of 2^(k+1), where it exists. The sums
// end in b[col * ch].
__device__ __forceinline__ void tree_fold_chunk(float* b, int cnt, int cg,
                                                int lch, int lane) {
  const int ch = 1 << lch;
  for (int lh = 0; (1 << lh) < cnt; ++lh) {
    const int h = 1 << lh;
    const int lp = lch - lh - 1;  // log2 of this level's pairs per column
    for (int f = lane; f < (cg << lp); f += 32) {
      const int a = (f & ((1 << lp) - 1)) << (lh + 1);
      const int col = f >> lp;
      if (a + h < cnt)
        b[col * ch + a] = b[col * ch + a] + b[col * ch + a + h];
    }
    __syncwarp();
  }
}

// Tile sums [c * ch, c * ch + cnt) of the run starting in window m0,
// columns [c0, c0 + cg), into the calling warp's buffer b (column-major),
// 32 loads in flight per lane: tile j is slot B of window m0 for j = 0,
// else slot A of window m0 + j.
__device__ __forceinline__ void tree_load_chunk(
    float* b, const int64_t* __restrict__ scratch, long long m0, long long c,
    int cnt, int s, int c0, int cg, int lch, int lane) {
  const int ch = 1 << lch;
  float x[REPRO_FOLD_BUF / 32];
#pragma unroll
  for (int e = 0; e < REPRO_FOLD_BUF / 32; ++e) {
    const int f = 32 * e + lane;
    const int col = f >> lch, jt = f & (ch - 1);
    if (col < cg && jt < cnt) {
      const long long j = c * ch + jt;
      x[e] = reinterpret_cast<const float*>(scratch + (m0 + j) * (2 + s) +
                                            2)[(j == 0 ? s : 0) + c0 + col];
    }
  }
#pragma unroll
  for (int e = 0; e < REPRO_FOLD_BUF / 32; ++e) {
    const int f = 32 * e + lane;
    if ((f >> lch) < cg && (f & (ch - 1)) < cnt) b[f] = x[e];
  }
  __syncwarp();
}

// log2 of the tiles per chunk for cg columns: the largest power of two
// with ch * cg <= FOLD_BUF.
__device__ __forceinline__ int tree_chunk_log(int cg) {
  return 31 - __clz(REPRO_FOLD_BUF / cg);
}

// A run of at most one chunk per column pass, by the calling warp.
template <bool MERGE>
__device__ void tree_fold_small(const int64_t* __restrict__ keys,
                                float* __restrict__ dst,
                                const int64_t* __restrict__ scratch,
                                long long first, long long end, int s,
                                float* b, int lane) {
  const int tiles = static_cast<int>(
      (end - first + REPRO_TREE_TILE - 1) >> REPRO_TREE_TILE_LOG);
  float* d = dst + keys[first] * s;
  for (int c0 = 0; c0 < s; c0 += REPRO_FOLD_CG) {
    const int cg = min(REPRO_FOLD_CG, s - c0);
    const int lch = tree_chunk_log(cg);
    tree_load_chunk(b, scratch, first >> REPRO_TREE_TILE_LOG, 0, tiles, s, c0,
                    cg, lch, lane);
    tree_fold_chunk(b, tiles, cg, lch, lane);
    if (lane < cg) {
      float* cell = d + c0 + lane;
      *cell = MERGE ? *cell + b[lane << lch] : b[lane << lch];
    }
    __syncwarp();
  }
}

// A longer run, by the whole block: per column pass, super-chunks of eight
// chunks side by side (a super-chunk of 8 * ch tiles is again a node of
// the tree); each warp folds its chunk, one thread per column joins the
// eight chunk sums by the tree and pushes the super-chunk's sum onto its
// binary counter; the counter's fold is the run's sum.
template <bool MERGE>
__device__ void tree_fold_big(const int64_t* __restrict__ keys,
                              float* __restrict__ dst,
                              const int64_t* __restrict__ scratch,
                              long long first, long long end, int s,
                              float (*buf)[REPRO_FOLD_BUF],
                              float (*part)[REPRO_FOLD_CG],
                              float (*stack)[REPRO_FOLD_LEVELS]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tiles =
      (end - first + REPRO_TREE_TILE - 1) >> REPRO_TREE_TILE_LOG;
  float* d = dst + keys[first] * s;
  for (int c0 = 0; c0 < s; c0 += REPRO_FOLD_CG) {
    const int cg = min(REPRO_FOLD_CG, s - c0);
    const int lch = tree_chunk_log(cg);
    const long long ch = 1LL << lch;
    const long long sup = ch * REPRO_FOLD_WARPS;
    const long long supers = (tiles + sup - 1) / sup;
    for (long long sc = 0; sc < supers; ++sc) {
      const long long c = sc * REPRO_FOLD_WARPS + warp;  // this warp's chunk
      const int cnt = static_cast<int>(max(0LL, min(ch, tiles - c * ch)));
      tree_load_chunk(buf[warp], scratch, first >> REPRO_TREE_TILE_LOG, c,
                      cnt, s, c0, cg, lch, lane);
      tree_fold_chunk(buf[warp], cnt, cg, lch, lane);
      if (lane < cg && cnt > 0) part[warp][lane] = buf[warp][lane << lch];
      __syncthreads();
      if (threadIdx.x < cg) {
        const int col = threadIdx.x;
        const int nres = static_cast<int>(
            min(static_cast<long long>(REPRO_FOLD_WARPS),
                (tiles - sc * sup + ch - 1) / ch));
        for (int h = 1; h < nres; h <<= 1)
          for (int a = 0; a + h < nres; a += 2 * h)
            part[a][col] = part[a][col] + part[a + h][col];
        tree_push(stack[col], sc, part[0][col]);
      }
      __syncthreads();
    }
    if (threadIdx.x < cg) {
      const float v = tree_fold(stack[threadIdx.x], supers);
      float* cell = d + c0 + threadIdx.x;
      *cell = MERGE ? *cell + v : v;
    }
    __syncthreads();
  }
}

// The fold: a block per FOLD_WARPS windows, a warp per window reads its
// fold record and folds a small run alone; then the block folds the longer
// ones together, in window order.
template <bool MERGE>
__global__ void __launch_bounds__(REPRO_FOLD_WARPS * 32)
    run_fold_kernel(const int64_t* __restrict__ keys, float* __restrict__ dst,
                    const int64_t* __restrict__ scratch, long long windows,
                    int s) {
  __shared__ float buf_sh[REPRO_FOLD_WARPS][REPRO_FOLD_BUF];
  __shared__ float part_sh[REPRO_FOLD_WARPS][REPRO_FOLD_CG];
  __shared__ float stack_sh[REPRO_FOLD_CG][REPRO_FOLD_LEVELS];
  __shared__ long long first_sh[REPRO_FOLD_WARPS], end_sh[REPRO_FOLD_WARPS];
  __shared__ int big_sh[REPRO_FOLD_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m =
      static_cast<long long>(blockIdx.x) * REPRO_FOLD_WARPS + warp;
  const long long first = m < windows ? scratch[m * (2 + s)] : -1;
  const long long end = first >= 0 ? scratch[m * (2 + s) + 1] : 0;
  // small: one chunk holds the run's tiles in every column pass
  const bool small =
      first >= 0 &&
      ((end - first + REPRO_TREE_TILE - 1) >> REPRO_TREE_TILE_LOG) <=
          (1 << tree_chunk_log(min(REPRO_FOLD_CG, s)));
  if (small)
    tree_fold_small<MERGE>(keys, dst, scratch, first, end, s, buf_sh[warp],
                           lane);
  if (lane == 0) {
    first_sh[warp] = first;
    end_sh[warp] = end;
    big_sh[warp] = first >= 0 && !small;
  }
  __syncthreads();
  for (int w = 0; w < REPRO_FOLD_WARPS; ++w) {
    if (!big_sh[w]) continue;
    tree_fold_big<MERGE>(keys, dst, scratch, first_sh[w], end_sh[w], s,
                         buf_sh, part_sh, stack_sh);
  }
}

// Both kernels on `st`. scratch: ceil(n / 256) * (2 + s) int64 words.
template <bool MERGE>
static inline cudaError_t run_tree_launch(const float* vals,
                                          const int64_t* perm,
                                          const int64_t* keys, float* dst,
                                          int64_t* scratch, long long n,
                                          int s, long long g,
                                          cudaStream_t st) {
  if (n > INT32_MAX || g > INT32_MAX) return cudaErrorInvalidValue;
  const long long windows = (n + REPRO_TREE_TILE - 1) / REPRO_TREE_TILE;
  const uintptr_t a = reinterpret_cast<uintptr_t>(vals);
  const int vec = (s % 4 == 0 && a % 16 == 0)  ? 4
                  : (s % 2 == 0 && a % 8 == 0) ? 2
                                               : 1;
  const dim3 tiles_grid(repro_blocks(windows, REPRO_TREE_WARPS),
                        (s + REPRO_TREE_CW - 1) / REPRO_TREE_CW);
  run_tiles_kernel<MERGE><<<tiles_grid, REPRO_TREE_WARPS * 32, 0, st>>>(
      vals, perm, keys, dst, scratch, n, s, g, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  run_fold_kernel<MERGE>
      <<<repro_blocks(windows, REPRO_FOLD_WARPS), REPRO_FOLD_WARPS * 32, 0,
         st>>>(
          keys, dst, scratch, windows, s);
  return cudaGetLastError();
}
