// Fused coarsen + bit-pack of CEM group keys, straight from a batch's
// columns.
//
// Replaces: repro/kernels/cem_keys.py::cem_keys_pallas (Pallas, TPU).
//
// Computes, per row i of d columns, each read where it lies (its own dtype
// and element stride):
//   x_j      = element i of column j converted to f32 exactly as
//              Tensor.to(torch.float32) converts it (round to nearest even)
//   bucket_j = #{k < n_cuts[j] : x_j >= cut[j, k]}     (cutpoints +inf
//              padded to C per column; categoricals come in as 1..card-1)
//   key = (key << width_j) | bucket_j                 (MSB-first, 64 bits)
//   hi = key >> 32, lo = key & 0xFFFFFFFF; invalid rows -> both 0xFFFFFFFF
// and writes hi, lo zero-extended into int64 (the port's key layout). For
// widths of at most 32 bits this is the u32 (hi, lo) shift pair of the
// Pallas kernel and of the plain version.
//
// Bound on the H100: memory. A row reads its d column elements and one
// validity element and writes 16 bytes of key words; the compares are a
// few dozen per row, below the card's op rate. Design:
// - One launch, no copy of the batch: the parameter block carries one
//   struct, passed by value (__grid_constant__), with each column's
//   pointer, element stride, dtype code, real cutpoint count and bit
//   width. The C entry point fills it from a host array, so n_cuts and
//   widths need no device copy.
// - A warp takes 32 consecutive rows, so the loads of a contiguous column
//   are coalesced. A thread takes REPRO_CEM_ROWS rows a block-width apart
//   and, before any arithmetic, issues the loads of their validity
//   elements and of REPRO_CEM_GROUP columns, so they are in flight
//   together.
// - The grid is sized to the card (resident blocks per SM x SMs) and
//   strides over the rows; each block stages the cut table in shared
//   memory once for all its rows, each column's real cutpoints padded with
//   NaN (which no x is >=) to a multiple of 4, so one float4 read serves
//   four compares of each of the thread's rows.
// - The bucket is the linear count of the real cutpoints <= x: exact
//   whatever their order (every table on the port's paths has at most 15).
//   A column whose cutpoints are exactly 1, 2, ..., m (a categorical spec)
//   takes the same count in closed form, min(floor(x), m) for x >= 1.
// Exact conversions, compares and integer shifts only, so the kernel is
// bitwise equal to the plain version and to KeyCodec.pack(coarsen(...)).
#include "common.cuh"

#include <cuda_fp16.h>

#define REPRO_CEM_MAX_COLS 64
#define REPRO_CEM_THREADS 256
#define REPRO_CEM_GROUP 2
#define REPRO_CEM_ROWS 2
#define REPRO_CEM_MAX_DEVICES 64

// dtype codes (kernels/cem_keys.py DTYPES)
enum CemDtype {
  CEM_F32 = 0, CEM_F64 = 1, CEM_F16 = 2, CEM_BF16 = 3, CEM_I64 = 4,
  CEM_I32 = 5, CEM_I16 = 6, CEM_I8 = 7, CEM_U8 = 8, CEM_BOOL = 9,
  CEM_N_DTYPES = 10
};

struct CemCol {
  const void* ptr;
  long long stride;  // in elements
  int dtype;
  int n_cuts;
  int width;
  int pad_;
};

struct CemCols {
  CemCol col[REPRO_CEM_MAX_COLS];
};

// log2 of the element size of a dtype code
__device__ __forceinline__ int cem_lg(int dtype) {
  switch (dtype) {
    case CEM_F64:
    case CEM_I64:
      return 3;
    case CEM_F32:
    case CEM_I32:
      return 2;
    case CEM_F16:
    case CEM_BF16:
    case CEM_I16:
      return 1;
    default:
      return 0;
  }
}

// The bits of the element at byte address a, zero-extended, by the
// element's log2 size lg (none for lg < 0). The size is uniform across a
// warp, so the switch never diverges.
__device__ __forceinline__ unsigned long long cem_ld(const char* a, int lg) {
  switch (lg) {
    case 3:
      return __ldg(reinterpret_cast<const unsigned long long*>(a));
    case 2:
      return __ldg(reinterpret_cast<const unsigned int*>(a));
    case 1:
      return __ldg(reinterpret_cast<const unsigned short*>(a));
    case 0:
      return __ldg(reinterpret_cast<const unsigned char*>(a));
    default:
      return 0ull;
  }
}

// One element as f32, rounded as Tensor.to(torch.float32) rounds it.
__device__ __forceinline__ float cem_to_f32(int dtype,
                                            unsigned long long r) {
  switch (dtype) {
    case CEM_F32:
      return __uint_as_float(static_cast<unsigned int>(r));
    case CEM_F64:
      return __double2float_rn(__longlong_as_double(
          static_cast<long long>(r)));
    case CEM_F16:
      return __half2float(__ushort_as_half(static_cast<unsigned short>(r)));
    case CEM_BF16:
      return __uint_as_float(static_cast<unsigned int>(r) << 16);
    case CEM_I64:
      return __ll2float_rn(static_cast<long long>(r));
    case CEM_I32:
      return __int2float_rn(static_cast<int>(static_cast<unsigned int>(r)));
    case CEM_I16:
      return __int2float_rn(static_cast<short>(
          static_cast<unsigned short>(r)));
    case CEM_I8:
      return __int2float_rn(static_cast<signed char>(
          static_cast<unsigned char>(r)));
    case CEM_U8:
      return __uint2float_rn(static_cast<unsigned int>(r));
    default:  // bool
      return r ? 1.0f : 0.0f;
  }
}

// 0xFFFFFFFF if x >= c, else 0 (false when either is NaN); a float4 of
// cutpoints is counted by four of these and two three-way adds.
__device__ __forceinline__ unsigned int cem_ge(float x, float c) {
  unsigned int m;
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(x), "f"(c));
  return m;
}

// Tensor.to(torch.bool) of the element: non-zero (NaN included; -0.0 not).
__device__ __forceinline__ bool cem_nonzero(int dtype, unsigned long long r) {
  switch (dtype) {
    case CEM_F32:
      return (r & 0x7FFFFFFFull) != 0ull;
    case CEM_F64:
      return (r & 0x7FFFFFFFFFFFFFFFull) != 0ull;
    case CEM_F16:
    case CEM_BF16:
      return (r & 0x7FFFull) != 0ull;
    default:
      return r != 0ull;
  }
}

// The bucket of each of the thread's rows in column j: for a column whose
// real cutpoints are exactly 1, 2, ..., m (a categorical spec) the count
// is min(floor(x), m) for x >= 1 and 0 otherwise (NaN included), exactly;
// any other column counts its cutpoints (whole float4s of the staged row).
__device__ __forceinline__ void cem_count(const float (&x)[REPRO_CEM_ROWS],
                                          const float4* cj, int nc, int grid,
                                          unsigned int (&b)[REPRO_CEM_ROWS]) {
#pragma unroll
  for (int r = 0; r < REPRO_CEM_ROWS; ++r) b[r] = 0u;
  if (grid) {
    const float m = static_cast<float>(nc);
#pragma unroll
    for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
      b[r] = x[r] >= 1.0f ? static_cast<unsigned int>(
                                fminf(floorf(x[r]), m))
                          : 0u;
    }
    return;
  }
  const int nq = (nc + 3) >> 2;
  for (int q = 0; q < nq; ++q) {
    const float4 cq = cj[q];
#pragma unroll
    for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
      b[r] -= cem_ge(x[r], cq.x) + cem_ge(x[r], cq.y) + cem_ge(x[r], cq.z) +
              cem_ge(x[r], cq.w);
    }
  }
}

// c4: the table's row length C rounded up to a multiple of 4; a block
// stages column j's real cutpoints in s_cut[j * c4 ..] and pads the row
// with NaN, which no x is >=, so the count reads whole float4s.
__global__ void __launch_bounds__(REPRO_CEM_THREADS)
cem_keys_kernel(const __grid_constant__ CemCols cols, const CemCol valid,
                const float* __restrict__ cut, int64_t* __restrict__ hi_out,
                int64_t* __restrict__ lo_out, long long n, int d, int c,
                int c4) {
  extern __shared__ float4 s_cut4[];
  __shared__ int s_grid[REPRO_CEM_MAX_COLS];
  float* s_cut = reinterpret_cast<float*>(s_cut4);
  for (int k = threadIdx.x; k < d * c4; k += blockDim.x) {
    const int j = k / c4;
    const int q = k - j * c4;
    s_cut[k] = q < cols.col[j].n_cuts ? cut[j * c + q] : __int_as_float(
                                                             0x7FC00000);
  }
  __syncthreads();
  // which columns hold the integer grid 1, 2, ..., m (from the staged
  // rows: a read of global memory per cutpoint here would hold up every
  // block of a one-pass grid)
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    int grid = 1;
    for (int k = 0; k < cols.col[j].n_cuts; ++k) {
      grid &= s_cut[j * c4 + k] == static_cast<float>(k + 1) ? 1 : 0;
    }
    s_grid[j] = grid;
  }
  __syncthreads();
  const int vlg = cem_lg(valid.dtype);
  const char* vptr = static_cast<const char*>(valid.ptr);
  const long long vstride = valid.stride << vlg;
  const long long tile = static_cast<long long>(REPRO_CEM_ROWS) * blockDim.x;
  const long long step = tile * gridDim.x;
  for (long long i0 = blockIdx.x * tile + threadIdx.x; i0 < n; i0 += step) {
    // rows past the end read row n - 1 and are not written
    long long rows[REPRO_CEM_ROWS];
#pragma unroll
    for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
      const long long i = i0 + static_cast<long long>(r) * blockDim.x;
      rows[r] = i < n ? i : n - 1;
    }
    unsigned long long v[REPRO_CEM_ROWS];
    unsigned long long key[REPRO_CEM_ROWS];
#pragma unroll
    for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
      v[r] = cem_ld(vptr + rows[r] * vstride, vlg);
      key[r] = 0ull;
    }
    for (int j0 = 0; j0 < d; j0 += REPRO_CEM_GROUP) {
      // every load of the group first, so they are in flight together
      // (REPRO_CEM_MAX_COLS is a multiple of REPRO_CEM_GROUP: j stays in
      // the struct)
      unsigned long long raw[REPRO_CEM_GROUP][REPRO_CEM_ROWS];
#pragma unroll
      for (int g = 0; g < REPRO_CEM_GROUP; ++g) {
        const CemCol& col = cols.col[j0 + g];
        const int lg = (j0 + g < d && col.width != 0) ? cem_lg(col.dtype)
                                                      : -1;
        const char* ptr = static_cast<const char*>(col.ptr);
        const long long stride = col.stride << (lg > 0 ? lg : 0);
#pragma unroll
        for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
          raw[g][r] = cem_ld(ptr + rows[r] * stride, lg);
        }
      }
#pragma unroll
      for (int g = 0; g < REPRO_CEM_GROUP; ++g) {
        const int j = j0 + g;
        if (j >= d) break;
        const int w = cols.col[j].width;
        if (w == 0) continue;
        const int dtype = cols.col[j].dtype;
        float x[REPRO_CEM_ROWS];
#pragma unroll
        for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
          x[r] = cem_to_f32(dtype, raw[g][r]);
        }
        unsigned int b[REPRO_CEM_ROWS];
        cem_count(x, s_cut4 + j * (c4 >> 2), cols.col[j].n_cuts, s_grid[j],
                  b);
#pragma unroll
        for (int r = 0; r < REPRO_CEM_ROWS; ++r) key[r] = (key[r] << w) | b[r];
      }
    }
#pragma unroll
    for (int r = 0; r < REPRO_CEM_ROWS; ++r) {
      const long long i = i0 + static_cast<long long>(r) * blockDim.x;
      if (i >= n) break;
      const bool ok = cem_nonzero(valid.dtype, v[r]);
      hi_out[i] = ok ? static_cast<int64_t>(key[r] >> 32) : 0xFFFFFFFFll;
      lo_out[i] = ok ? static_cast<int64_t>(key[r] & 0xFFFFFFFFull)
                     : 0xFFFFFFFFll;
    }
  }
}

// Blocks of the launch: enough for n rows, at most the card's resident
// blocks (SMs x blocks a SM holds), counted once per device.
static unsigned int cem_blocks(long long n) {
  static int cap[REPRO_CEM_MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < REPRO_CEM_MAX_DEVICES;
  int most = cached ? cap[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cem_keys_kernel,
                                                  REPRO_CEM_THREADS, 0);
    most = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (cached) cap[dev] = most;
  }
  const long long tile =
      static_cast<long long>(REPRO_CEM_THREADS) * REPRO_CEM_ROWS;
  const long long want = (n + tile - 1) / tile;
  return static_cast<unsigned int>(want < most ? want : most);
}

// call: int64 words hi, lo, cut, valid pointer, valid element stride, valid
// dtype code, n, d, C, then d triples (pointer, element stride, dtype
// code); fields: d int32 pairs (real cutpoint count, bit width). Both are
// host arrays, read before this returns.
extern "C" int cem_keys_launch(const long long* call, const int* fields,
                               void* stream) {
  const long long n = call[6];
  const int d = static_cast<int>(call[7]);
  const int c = static_cast<int>(call[8]);
  if (n < 0 || d < 0 || d > REPRO_CEM_MAX_COLS || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CemCol valid = {reinterpret_cast<const void*>(call[3]), call[4],
                  static_cast<int>(call[5]), 0, 0, 0};
  if (valid.dtype < 0 || valid.dtype >= CEM_N_DTYPES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CemCols cols = {};
  int bits = 0;
  for (int j = 0; j < d; ++j) {
    const long long* w = call + 9 + 3 * j;
    CemCol& col = cols.col[j];
    col.ptr = reinterpret_cast<const void*>(w[0]);
    col.stride = w[1];
    col.dtype = static_cast<int>(w[2]);
    col.n_cuts = fields[2 * j];
    col.width = fields[2 * j + 1];
    if (col.dtype < 0 || col.dtype >= CEM_N_DTYPES || col.n_cuts < 0 ||
        col.n_cuts > c || col.width < 0 || col.width > 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bits += col.width;
  }
  if (bits > 63) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int c4 = ((c > 0 ? c : 1) + 3) / 4 * 4;
  const size_t smem = sizeof(float) * static_cast<size_t>(d) * c4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cem_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cem_keys_kernel<<<cem_blocks(n), REPRO_CEM_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      cols, valid, reinterpret_cast<const float*>(call[2]),
      reinterpret_cast<int64_t*>(call[0]), reinterpret_cast<int64_t*>(call[1]),
      n, d, c, c4);
  return static_cast<int>(cudaGetLastError());
}
