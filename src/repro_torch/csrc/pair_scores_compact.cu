// Fused similarity + threshold + candidate compaction over gathered tiles,
// in one pass.
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
// Bound on an H100 at the blocked path's chunk (T = 256 tiles of 128 x 128,
// D = 384): operations, 2*T*bn*bm*D = 3.2 GFLOP of f32 FFMA, 0.048 ms at
// 67 TFLOP/s, against (T*(bn+bm)*(4*D + 4) + 12*kept) bytes, about 0.03 ms at
// 3.35 TB/s.  Tensor cores are out: they have no IEEE-f32 mode and TF32
// changes the candidate set.
//
// Design.  The TPU kernel walked its grid in order with a cursor in SMEM.
// Blocks on the card run in no order, so each tile's base position comes
// from a decoupled look-back over its predecessors, in one launch that
// computes each product once:
//   1. ticket: a block takes its tile index t from an atomic counter, not
//      from blockIdx, so every tile below t belongs to a block that has
//      already started;
//   2. product: score_tile::tile_product (score_tile.cuh), the mainloop
//      that pair_scores.cu runs too, at 16-deep slices: 8 x 8 cells a
//      thread in registers, conflict-free shared-memory reads and stores,
//      the next slice's loads in flight during this slice's FMAs.  Every
//      cell is fmaf in k order from 0 in one shared function, so a pair
//      scores bit for bit as the dense kernel scores it: the cross-table
//      dedup in blocking.py keeps one of several re-finds of a pair and
//      relies on their scores being equal;
//   3. rank: an exclusive block scan over (row, 4-column group) counts gives
//      each candidate its rank in the tile and the tile's count;
//   4. look-back: the block publishes its count as an aggregate in status[t]
//      (a 64-bit word: flag in the high half, value in the low, stored with
//      release and read with acquire semantics, so no reader sees a flag
//      without its value); one warp then reads 32 predecessors' words at a
//      time, from t-1 down, waits until each is published, and sums back to
//      the nearest inclusive prefix; the block publishes its own inclusive
//      prefix and writes its candidates at base + rank where that is below
//      capacity.  Tile T-1 (by index) writes n_total.
// It cannot deadlock: a block waits only on tiles with smaller tickets,
// whose blocks are resident and wait only on smaller tickets still; tile 0
// waits on none.  Positions come from counts alone, so the output does not
// depend on which block finished first.  The caller zeroes status and the
// ticket before every call.  __launch_bounds__(256, 2) keeps two blocks an
// SM, so a 256-tile chunk runs in one wave on 132 SMs.
//
// Tiles wider than 128 rows on a side (any bn, bm >= 1) take a second
// kernel, pair_scores_compact_wide_kernel below.  Row-major order over a
// tile more than 128 columns wide interleaves its 128-column blocks, so a
// 128 x 128 sub-tile cannot be a look-back item of its own.  The item is a
// band of up to 128 rows of one tile across all bm columns (items in tile
// order, then band order, which is the output order), and the block walks
// the band's column blocks twice:
//   1. count: each column block's product, its kept cells counted per row
//      (a half-warp owns a row's 8-column slices, so a shuffle sum and one
//      shared-memory add a row); an exclusive scan over the 128 rows gives
//      each row's offset in the band and the band's count;
//   2. look-back over the items before it, exactly as above;
//   3. write: each column block's product again (kept from pass 1 when the
//      band has one column block), its (row, 4-column group) counts scanned
//      within the row, and each kept cell written at base + its row's offset
//      + its row's counts in earlier column blocks + its rank in the block.
// Both passes run score_tile::tile_product, so a pair scores bit for bit as
// in the one-pass kernel and the dense one.  The one-pass kernel stays the
// path of every tile of at most 128 x 128.
//
// Contract (checked by the Python wrapper): T >= 1, bn, bm >= 1, d % 16 ==
// 0, contiguous 16-byte-aligned rows, T*bn*bm and capacity + bn*bm below
// 2^31, rows / cols prefilled with -1 and scores with 0, status (items + 1
// words: the items' look-back words and the ticket, items = T when bn, bm
// <= 128, else T * ceil(bn / 128)) zeroed.
#include <cuda_runtime.h>

#include "score_tile.cuh"

namespace {

using score_tile::half_index;
using score_tile::kTM;
using score_tile::kTN;
using score_tile::kThreads;                        // 256
constexpr int kBM = score_tile::kRows;   // most rows of a per tile (bn)
constexpr int kBN = score_tile::kRows;   // most rows of b per tile (bm)
constexpr int kGroups = kBN / 4;                   // 32 column groups a row
constexpr int kWarps = kThreads / 32;
constexpr int kCells = kBM * kGroups;              // (row, group) counts
constexpr int kCellsPerThread = kCells / kThreads; // 16

// status words: flag << 32 | value
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct Smem {
  union {
    score_tile::Slices k;  // the mainloop's slices
    int cell[kCells];     // then (row, group) counts and their prefix
  } u;
  int ra[kBM];          // global ids of the tile's a rows, -1 past bn
  int cb[kBN];          // global ids of the tile's b rows, -1 past bm
  int warp_sums[kWarps];
  int item;  // the ticket: a tile, or a band of a tile
  int base;
};

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

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

// Bit j of the result: cell (row, half_index(j, tc)) is a candidate.
__device__ __forceinline__ unsigned keep_bits(const Smem& sm,
                                              const float (&acc)[kTN],
                                              int row, int tc, float tau) {
  unsigned bits = 0;
  if (sm.ra[row] < 0) return 0;
#pragma unroll
  for (int j = 0; j < kTN; ++j)
    if (acc[j] >= tau && sm.cb[half_index(j, tc)] >= 0) bits |= 1u << j;
  return bits;
}

// Warp 0: the sum of the counts of tiles [0, t), from the predecessors'
// status words (see the note at the top).
__device__ int look_back(unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int end = t;; end -= 32) {
    const int i = end - 1 - lane;    // lane 0 is the nearest predecessor
    unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
    if (i >= 0) {
      do {
        w = peek(status + i);
      } while ((w >> 32) == 0);
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(w & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    base += v;
    if (prefix) return base;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
pair_scores_compact_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const int* __restrict__ ida,
                           const int* __restrict__ idb,
                           unsigned long long* __restrict__ status,
                           int* __restrict__ rows, int* __restrict__ cols,
                           float* __restrict__ scores,
                           int* __restrict__ n_total, int T, int bn, int bm,
                           int d, float tau, int capacity) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int g = tid % (kBN / kTN);   // column groups g and g + 16 of a row
  const int tr = (tid / (kBN / kTN)) * 4;
  const int tc = g * 4;

  if (tid == 0)
    sm.item = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status + T), 1u));
  __syncthreads();
  const int t = sm.item;
  for (int i = tid; i < kBM; i += kThreads) {
    sm.ra[i] = i < bn ? ida[static_cast<size_t>(t) * bn + i] : -1;
    sm.cb[i] = i < bm ? idb[static_cast<size_t>(t) * bm + i] : -1;
  }

  float acc[kTM][kTN];
  score_tile::tile_product(a + static_cast<size_t>(t) * bn * d,
                                b + static_cast<size_t>(t) * bm * d, bn, bm,
                                d, sm.u.k, tr, tc, acc);  // ends in a barrier
  unsigned bits[kTM];
  int* cell = sm.u.cell;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = half_index(i, tr);
    bits[i] = keep_bits(sm, acc[i], row, tc, tau);
    cell[row * kGroups + g] = __popc(bits[i] & 0xfu);
    cell[row * kGroups + g + kGroups / 2] = __popc(bits[i] >> 4);
  }
  __syncthreads();
  // exclusive prefix of cell[] in row-major (row, 4-column group) order:
  // each thread scans 16 consecutive entries, the block scans their sums
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

  if (tid < 32) {
    int base = 0;
    if (t == 0) {
      if (tid == 0) publish(status, kPrefix | static_cast<unsigned>(tile_total));
    } else {
      if (tid == 0)
        publish(status + t, kAggregate | static_cast<unsigned>(tile_total));
      base = look_back(status, t);
      if (tid == 0)
        publish(status + t,
                kPrefix | static_cast<unsigned>(base + tile_total));
    }
    if (tid == 0) sm.base = base;
  }
  __syncthreads();
  const int base = sm.base;

  // j runs at compile time, so acc stays in registers
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = half_index(i, tr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int pos = base + cell[row * kGroups + g + h * (kGroups / 2)];
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        if (!((bits[i] >> j) & 1u)) continue;
        if (pos < capacity) {
          rows[pos] = sm.ra[row];
          cols[pos] = sm.cb[half_index(j, tc)];
          scores[pos] = acc[i][j];
        }
        ++pos;
      }
    }
  }
  if (t == T - 1 && tid == 0) *n_total = base + tile_total;
}

// The ids of column block cb of tile t into sm.cb and its product with the
// band at a0 (rows_a rows) into acc.  Every thread of the block must call
// it; it ends in a barrier.
__device__ __forceinline__ void block_product(
    Smem& sm, const float* __restrict__ a0, const float* __restrict__ b,
    const int* __restrict__ idb, int t, int cb, int rows_a, int bm, int d,
    int tr, int tc, float (&acc)[kTM][kTN]) {
  const int c0 = cb * kBN, cols_b = min(kBN, bm - c0);
  for (int i = threadIdx.x; i < kBN; i += kThreads)
    sm.cb[i] = i < cols_b ? idb[static_cast<size_t>(t) * bm + c0 + i] : -1;
  score_tile::tile_product(a0, b + (static_cast<size_t>(t) * bm + c0) * d,
                           rows_a, cols_b, d, sm.u.k, tr, tc, acc);
}

// The band kernel of tiles past 128 rows on a side (see the note at the
// top): item i is band i % n_bands of tile i / n_bands.
__global__ void __launch_bounds__(kThreads, 2)
pair_scores_compact_wide_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const int* __restrict__ ida,
                                const int* __restrict__ idb,
                                unsigned long long* __restrict__ status,
                                int* __restrict__ rows, int* __restrict__ cols,
                                float* __restrict__ scores,
                                int* __restrict__ n_total, int n_items,
                                int n_bands, int bn, int bm, int d, float tau,
                                int capacity) {
  __shared__ Smem sm;
  __shared__ int row_off[kBM];  // pass 1: kept cells a row; then its offset
  const int tid = threadIdx.x;
  const int g = tid % (kBN / kTN);
  const int tr = (tid / (kBN / kTN)) * 4;
  const int tc = g * 4;
  const int n_cb = (bm + kBN - 1) / kBN;

  if (tid == 0)
    sm.item = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status + n_items), 1u));
  if (tid < kBM) row_off[tid] = 0;
  __syncthreads();
  const int item = sm.item;
  const int t = item / n_bands, r0 = (item % n_bands) * kBM;
  const int rows_a = min(kBM, bn - r0);
  const float* a0 = a + (static_cast<size_t>(t) * bn + r0) * d;
  for (int i = tid; i < kBM; i += kThreads)
    sm.ra[i] = i < rows_a ? ida[static_cast<size_t>(t) * bn + r0 + i] : -1;

  // 1. kept cells a row, over the band's column blocks
  float acc[kTM][kTN];
  unsigned bits[kTM];
  for (int cb = 0; cb < n_cb; ++cb) {
    block_product(sm, a0, b, idb, t, cb, rows_a, bm, d, tr, tc, acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = half_index(i, tr);
      bits[i] = keep_bits(sm, acc[i], row, tc, tau);
      int n = __popc(bits[i]);
#pragma unroll
      for (int o = 1; o < kBN / kTN; o <<= 1)  // the row's 16 lanes
        n += __shfl_xor_sync(0xffffffffu, n, o);
      if (g == 0) row_off[row] += n;
    }
    __syncthreads();  // sm.cb and the slices are reused
  }
  int band_total;
  const int before = block_exclusive_scan(tid < kBM ? row_off[tid] : 0,
                                          sm.warp_sums, &band_total);
  if (tid < kBM) row_off[tid] = before;

  // 2. look-back
  if (tid < 32) {
    int base = 0;
    if (item == 0) {
      if (tid == 0) publish(status, kPrefix | static_cast<unsigned>(band_total));
    } else {
      if (tid == 0)
        publish(status + item, kAggregate | static_cast<unsigned>(band_total));
      base = look_back(status, item);
      if (tid == 0)
        publish(status + item,
                kPrefix | static_cast<unsigned>(base + band_total));
    }
    if (tid == 0) sm.base = base;
  }
  __syncthreads();
  const int base = sm.base;

  // 3. write, column block by column block
  int* cell = sm.u.cell;
  const int crow = tid / (kGroups / kCellsPerThread);  // the row scanned
  for (int cb = 0; cb < n_cb; ++cb) {
    if (n_cb > 1) {
      block_product(sm, a0, b, idb, t, cb, rows_a, bm, d, tr, tc, acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        bits[i] = keep_bits(sm, acc[i], half_index(i, tr), tc, tau);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = half_index(i, tr);
      cell[row * kGroups + g] = __popc(bits[i] & 0xfu);
      cell[row * kGroups + g + kGroups / 2] = __popc(bits[i] >> 4);
    }
    __syncthreads();
    // the prefix of cell[] within each row: a row's 32 groups are the 16
    // entries of two neighbouring threads
    int local[kCellsPerThread];
    int sum = 0;
#pragma unroll
    for (int e = 0; e < kCellsPerThread; ++e) {
      local[e] = sum;
      sum += cell[tid * kCellsPerThread + e];
    }
    const int other = __shfl_xor_sync(0xffffffffu, sum, 1);
    const int start = row_off[crow] + ((tid & 1) ? other : 0);
#pragma unroll
    for (int e = 0; e < kCellsPerThread; ++e)
      cell[tid * kCellsPerThread + e] = start + local[e];
    __syncthreads();
    if ((tid & 1) == 0) row_off[crow] += sum + other;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = half_index(i, tr);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int pos = base + cell[row * kGroups + g + h * (kGroups / 2)];
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          if (!((bits[i] >> j) & 1u)) continue;
          if (pos < capacity) {
            rows[pos] = sm.ra[row];
            cols[pos] = sm.cb[half_index(j, tc)];
            scores[pos] = acc[i][j];
          }
          ++pos;
        }
      }
    }
    __syncthreads();  // cell[], row_off and sm.cb are reused
  }
  if (item == n_items - 1 && tid == 0) *n_total = base + band_total;
}

}  // namespace

// Plain C entry point: one launch on `stream`; returns its status.  status
// is (items + 1) zeroed 64-bit words: the items' look-back words, then the
// ticket; items is T for tiles of at most 128 x 128 (the one-pass kernel),
// else T * ceil(bn / 128) (the band kernel).
extern "C" cudaError_t pair_scores_compact_launch(
    const float* a, const float* b, const int* ida, const int* idb,
    unsigned long long* status, int* rows, int* cols, float* scores,
    int* n_total, int T, int bn, int bm, int d, float tau, int capacity,
    cudaStream_t stream) {
  if (bn <= kBM && bm <= kBN) {
    pair_scores_compact_kernel<<<T, kThreads, 0, stream>>>(
        a, b, ida, idb, status, rows, cols, scores, n_total, T, bn, bm, d,
        tau, capacity);
  } else {
    const int n_bands = (bn + kBM - 1) / kBM;
    const int n_items = T * n_bands;
    pair_scores_compact_wide_kernel<<<n_items, kThreads, 0, stream>>>(
        a, b, ida, idb, status, rows, cols, scores, n_total, n_items, n_bands,
        bn, bm, d, tau, capacity);
  }
  return cudaGetLastError();
}
