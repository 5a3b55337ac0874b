// Fused similarity + threshold + candidate compaction over gathered tiles.
//
// Replaces: src/repro/kernels/pair_scores/kernel.py::pair_scores_compact
// (Pallas, TPU), which blocking.py::score_block_pairs calls once per chunk of
// LSH tile pairs.  Tile pair t scores rows [t*bn, (t+1)*bn) of a_g against
// rows [t*bm, (t+1)*bm) of b_g (f32, row-major, zero rows on padding):
//   s = a_tile . b_tile^T,   keep = s >= tau && ida[r] >= 0 && idb[c] >= 0,
// and the kept cells (ida[r], idb[c], s) go out in tile order, then row-major
// within a tile, each at its global position g in that order and only where
// g < capacity.  n_total is the true count.
//
// Design.  The TPU kernel walked its grid in order with a cursor in SMEM.
// Blocks on the card run in no order, so the cursor becomes per-tile counts,
// an exclusive prefix over tiles and a scatter, in two launches:
//   1. count: one block per tile computes the tile's product and writes its
//      candidate count to counts[t];
//   2. write: one block per tile sums counts[0..t) (its base), recomputes the
//      product, ranks each candidate row-major within the tile with an
//      exclusive block scan over (row, 8-column group) counts, and writes it
//      at base + rank when that is below capacity; tile T-1 writes n_total.
// Recomputing the product doubles the operations but keeps every score block
// out of device memory, which was the TPU kernel's point, and the output does
// not depend on block order.  The product is pair_scores.cu's mainloop
// (128 x 128 block, 16-deep k slices in shared memory, 8 x 8 per thread,
// fmaf in k order from 0), so each cell scores bit for bit as the dense
// kernel scores the same pair: the cross-table dedup in blocking.py keeps one
// of several re-finds of a pair and relies on their scores being equal.
// Tensor cores are out: they have no IEEE-f32 mode and TF32 changes the
// candidate set.
//
// Bound on an H100 at the blocked path's chunk (T = 256 tiles of 128 x 128,
// D = 384): operations, 2*T*bn*bm*D = 3.2 GFLOP of f32 FFMA, 0.048 ms at
// 67 TFLOP/s, against (T*(bn+bm)*(4*D + 4) + 12*kept) bytes, about 0.03 ms at
// 3.35 TB/s.  Counted once, as the function needs; the two passes issue the
// product twice.  A one-pass version with a decoupled look-back (its tile
// index from an atomic ticket, not blockIdx, so no block waits on a
// predecessor that was never scheduled) is later work.
//
// Contract (checked by the Python wrapper): T >= 1, 1 <= bn, bm <= 128,
// d % 16 == 0, contiguous 16-byte-aligned rows, T*bn*bm and capacity + bn*bm
// below 2^31, rows / cols prefilled with -1 and scores with 0.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;   // most rows of a per tile (bn)
constexpr int kBN = 128;   // most rows of b per tile (bm)
constexpr int kBK = 16;
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kGroups = kBN / kTN;                 // 16 column groups a row
constexpr int kThreads = (kBM / kTM) * kGroups;    // 256
constexpr int kWarps = kThreads / 32;
constexpr int kCells = kBM * kGroups;              // (row, group) counts
constexpr int kCellsPerThread = kCells / kThreads; // 8

struct Smem {
  float as[kBK][kBM];
  float bs[kBK][kBN];
  int ra[kBM];          // global ids of the tile's a rows, -1 past bn
  int cb[kBN];          // global ids of the tile's b rows, -1 past bm
  int warp_sums[kWarps];
};

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// Load tile t's ids, then acc[i][j] = <a row tr+i, b row tc+j> of the tile,
// summed with fmaf in k order from 0 (pair_scores.cu's mainloop).  Rows past
// bn / bm load as zeros.
__device__ void tile_product(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const int* __restrict__ ida,
                             const int* __restrict__ idb, int t, int bn,
                             int bm, int d, Smem& sm, int tr, int tc,
                             float (&acc)[kTM][kTN]) {
  const int tid = threadIdx.x;
  const float* a0 = a + static_cast<size_t>(t) * bn * d;
  const float* b0 = b + static_cast<size_t>(t) * bm * d;
  for (int i = tid; i < kBM; i += kThreads) {
    sm.ra[i] = i < bn ? ida[static_cast<size_t>(t) * bn + i] : -1;
    sm.cb[i] = i < bm ? idb[static_cast<size_t>(t) * bm + i] : -1;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int l = tid; l < kBM * kBK / 4; l += kThreads) {
      const int r = l / (kBK / 4);
      const int c = (l % (kBK / 4)) * 4;
      float4 va = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 vb = va;
      if (r < bn)
        va = *reinterpret_cast<const float4*>(
            a0 + static_cast<size_t>(r) * d + k0 + c);
      if (r < bm)
        vb = *reinterpret_cast<const float4*>(
            b0 + static_cast<size_t>(r) * d + k0 + c);
      sm.as[c + 0][r] = va.x; sm.as[c + 1][r] = va.y;
      sm.as[c + 2][r] = va.z; sm.as[c + 3][r] = va.w;
      sm.bs[c + 0][r] = vb.x; sm.bs[c + 1][r] = vb.y;
      sm.bs[c + 2][r] = vb.z; sm.bs[c + 3][r] = vb.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ra[i] = sm.as[k][tr + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) rb[j] = sm.bs[k][tc + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Bit j of the result: cell (tr + i, tc + j) is a candidate.
__device__ __forceinline__ unsigned keep_bits(const Smem& sm,
                                              const float (&acc)[kTN],
                                              int row, int tc, float tau) {
  unsigned bits = 0;
  if (sm.ra[row] < 0) return 0;
#pragma unroll
  for (int j = 0; j < kTN; ++j)
    if (acc[j] >= tau && sm.cb[tc + j] >= 0) bits |= 1u << j;
  return bits;
}

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const int* __restrict__ ida, const int* __restrict__ idb,
                     int* __restrict__ counts, int bn, int bm, int d,
                     float tau) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int tr = (tid / kGroups) * kTM;
  const int tc = (tid % kGroups) * kTN;
  float acc[kTM][kTN];
  tile_product(a, b, ida, idb, blockIdx.x, bn, bm, d, sm, tr, tc, acc);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    cnt += __popc(keep_bits(sm, acc[i], tr + i, tc, tau));
  int total;
  block_exclusive_scan(cnt, sm.warp_sums, &total);
  if (tid == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
compact_write_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const int* __restrict__ ida, const int* __restrict__ idb,
                     const int* __restrict__ counts, int* __restrict__ rows,
                     int* __restrict__ cols, float* __restrict__ scores,
                     int* __restrict__ n_total, int T, int bn, int bm, int d,
                     float tau, int capacity) {
  __shared__ Smem sm;
  __shared__ int cell[kCells];   // (row, group) counts, then their prefix
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int tr = (tid / kGroups) * kTM;
  const int g = tid % kGroups;
  const int tc = g * kTN;

  int part = 0;
  for (int i = tid; i < t; i += kThreads) part += counts[i];
  int base;
  block_exclusive_scan(part, sm.warp_sums, &base);

  float acc[kTM][kTN];
  tile_product(a, b, ida, idb, t, bn, bm, d, sm, tr, tc, acc);
  unsigned bits[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    bits[i] = keep_bits(sm, acc[i], tr + i, tc, tau);
    cell[(tr + i) * kGroups + g] = __popc(bits[i]);
  }
  __syncthreads();
  // exclusive prefix of cell[] in row-major (row, group) order: each thread
  // scans 8 consecutive entries, the block scans the threads' sums
  int local[kCellsPerThread];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kCellsPerThread; ++e) {
    local[e] = sum;
    sum += cell[tid * kCellsPerThread + e];
  }
  int tile_total;
  const int before = block_exclusive_scan(sum, sm.warp_sums, &tile_total);
#pragma unroll
  for (int e = 0; e < kCellsPerThread; ++e)
    cell[tid * kCellsPerThread + e] = before + local[e];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    unsigned m = bits[i];
    int pos = base + cell[(tr + i) * kGroups + g];
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      if (pos < capacity) {
        rows[pos] = sm.ra[tr + i];
        cols[pos] = sm.cb[tc + j];
        scores[pos] = acc[i][j];
      }
      ++pos;
    }
  }
  if (t == T - 1 && tid == 0) *n_total = base + tile_total;
}

}  // namespace

// Plain C entry point: the count and the write launch, in that order, on
// `stream`; returns the first failing launch's status.  counts is (T,)
// scratch the first launch fills.
extern "C" cudaError_t pair_scores_compact_launch(
    const float* a, const float* b, const int* ida, const int* idb,
    int* counts, int* rows, int* cols, float* scores, int* n_total, int T,
    int bn, int bm, int d, float tau, int capacity, cudaStream_t stream) {
  compact_count_kernel<<<T, kThreads, 0, stream>>>(a, b, ida, idb, counts, bn,
                                                   bm, d, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  compact_write_kernel<<<T, kThreads, 0, stream>>>(
      a, b, ida, idb, counts, rows, cols, scores, n_total, T, bn, bm, d, tau,
      capacity);
  return cudaGetLastError();
}
