// The f32 SIMT mainloop that both pair-score kernels run: one 128 x 128 tile
// of a . b^T by a block of 256 threads, every cell summed with fmaf in k
// order from 0.
//
// pair_scores.cu (the dense grid) and pair_scores_compact.cu (gathered tile
// pairs) include this one function, so the two kernels score a pair bit for
// bit alike by construction: the blocked path's cross-table dedup
// (blocking.py) keeps one of several re-finds of a pair and relies on their
// scores being equal, and the blocked candidates must be a subset of the
// dense ones with equal scores.  Nothing here may change a cell's summation
// order: no split-K, no TF32, no reassociation.
//
// Design.
//   * Thread tile: 8 x 8 cells in registers, rows tr..tr+3 and tr+64..tr+67,
//     columns tc..tc+3 and tc+64..tc+67 (tr = (tid / 16) * 4, tc = (tid % 16)
//     * 4).  A warp's shared-memory reads of one k step are then contiguous
//     16-byte loads with no bank conflict.
//   * k slices of kBK = 16 double-buffered in shared memory, k-major;
//     the next slice's global loads are in flight, in registers, during
//     this slice's FMAs; one barrier a slice.
//   * Staging: each thread loads kBK / 2 contiguous floats of one row and
//     stores them k-major; a warp covers 32 consecutive rows, so the
//     transposing stores meet no bank conflict.
#pragma once

#include <cuda_runtime.h>

namespace score_tile {

constexpr int kRows = 128;      // rows of a (and of b) a tile
constexpr int kThreads = 256;
constexpr int kTM = 8;          // rows a thread: 4, and 4 more 64 rows down
constexpr int kTN = 8;          // columns a thread: 4, and 4 more 64 on
constexpr int kHalf = 64;
constexpr int kBK = 16;        // k depth of a slice (the wrappers' TILE_DEPTH)

// The two operands' double-buffered k slices.
struct Slices {
  float as[2][kBK][kRows];
  float bs[2][kBK][kRows];
};

// Row (column) of the tile that a thread's i-th (j-th) register row holds:
// 4 from tr (tc), then 4 from tr + 64 (tc + 64).
__device__ __forceinline__ int half_index(int i, int t0) {
  return (i < 4 ? 0 : kHalf) + t0 + (i & 3);
}

// This thread's first tile row (tr) and column (tc).
__device__ __forceinline__ int thread_row() {
  return (threadIdx.x / (kRows / kTN)) * 4;
}
__device__ __forceinline__ int thread_col() {
  return (threadIdx.x % (kRows / kTN)) * 4;
}

// One k slice of this thread's row: kBK / 2 floats from column k0 + c of row
// r of a and of b, zeros past bn / bm.
__device__ __forceinline__ void load_slice(const float* a0, const float* b0,
                                           int r, int c, int k0, int bn,
                                           int bm, int d,
                                           float4 (&va)[kBK / 8],
                                           float4 (&vb)[kBK / 8]) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* pa = reinterpret_cast<const float4*>(
      a0 + static_cast<size_t>(r) * d + k0 + c);
  const float4* pb = reinterpret_cast<const float4*>(
      b0 + static_cast<size_t>(r) * d + k0 + c);
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) va[q] = r < bn ? pa[q] : z;
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) vb[q] = r < bm ? pb[q] : z;
}

__device__ __forceinline__ void store_slice(float (&s)[kBK][kRows], int r,
                                            int c,
                                            const float4 (&v)[kBK / 8]) {
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) {
    s[c + 4 * q + 0][r] = v[q].x;
    s[c + 4 * q + 1][r] = v[q].y;
    s[c + 4 * q + 2][r] = v[q].z;
    s[c + 4 * q + 3][r] = v[q].w;
  }
}

// acc[i][j] = <row half_index(i, tr) of a0, row half_index(j, tc) of b0>,
// summed with fmaf in k order from 0.  a0 and b0 point at the tile's first
// rows (row stride d, d % kBK == 0, 16-byte aligned); rows past bn (bm)
// load as zeros.  kRowHalves (kColHalves) = 1 skips the FMAs of register
// rows (columns) 4-7, which hold tile rows 64 and on: a caller passes it
// only when bn (bm) <= 64, which makes the choice uniform across the block,
// and those accumulators stay 0.  Every thread of the block must call it;
// it ends in a barrier, after which sm may be reused.
template <int kRowHalves = 2, int kColHalves = 2>
__device__ inline void tile_product(const float* __restrict__ a0,
                             const float* __restrict__ b0, int bn, int bm,
                             int d, Slices& sm, int tr, int tc,
                             float (&acc)[kTM][kTN]) {
  constexpr int kRowsUsed = kRowHalves * (kTM / 2);
  constexpr int kColsUsed = kColHalves * (kTN / 2);
  const int tid = threadIdx.x;
  const int r = tid % kRows;                // the row this thread loads
  const int c = (tid / kRows) * (kBK / 2);  // and its columns of the slice
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  float4 va[kBK / 8], vb[kBK / 8];
  load_slice(a0, b0, r, c, 0, bn, bm, d, va, vb);
  store_slice(sm.as[0], r, c, va);
  store_slice(sm.bs[0], r, c, vb);
  __syncthreads();
  const int n_slices = d / kBK;
  for (int s = 0; s < n_slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_slices;
    if (more)  // the next slice's loads fly during this slice's FMAs
      load_slice(a0, b0, r, c, (s + 1) * kBK, bn, bm, d, va, vb);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float x[kTM], y[kTN];
#pragma unroll
      for (int i = 0; i < kRowsUsed; ++i)
        x[i] = sm.as[cur][k][half_index(i, tr)];
#pragma unroll
      for (int j = 0; j < kColsUsed; ++j)
        y[j] = sm.bs[cur][k][half_index(j, tc)];
#pragma unroll
      for (int i = 0; i < kRowsUsed; ++i)
#pragma unroll
        for (int j = 0; j < kColsUsed; ++j)
          acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    if (more) {
      store_slice(sm.as[cur ^ 1], r, c, va);
      store_slice(sm.bs[cur ^ 1], r, c, vb);
    }
    __syncthreads();
  }
}

}  // namespace score_tile
