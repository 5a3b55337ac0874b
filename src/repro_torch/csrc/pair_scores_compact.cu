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
// kernel, pair_scores_compact_band_kernel below.  Row-major order over a
// tile more than 128 columns wide interleaves its 128-column blocks, so a
// 128 x 128 sub-tile cannot be a look-back item of its own.  The item is a
// band of up to 128 rows of one tile across all bm columns (items in tile
// order, then band order, which is the output order), served by a
// thread-block cluster of cs = min(ceil(bm / 128), 8) blocks, block j
// taking the band's column block j:
//   1. ticket: block 0 takes the item as above; the others read it from
//      its shared memory after a cluster barrier;
//   2. product: each block computes its 128 x <= 128 product once, into
//      registers, by score_tile::tile_product, without the FMAs of a half
//      of the thread tile that holds no real row (the band's rows <= 64)
//      or column (the block's columns <= 64): half_index makes that
//      uniform across the block;
//   3. count: its (row, 4-column group) counts, scanned within each row,
//      and each row's kept cells, in its own shared memory;
//   4. share: after a cluster barrier each block reads the others' row
//      counts through distributed shared memory.  Their sum over the
//      cluster, scanned over the rows, gives each row's offset in the band
//      and the band's count; their sum over the blocks before it, the
//      row's cells in earlier column blocks;
//   5. look-back: block 0 runs it over the items before its own, exactly as
//      above, and writes base into every block's shared memory before a
//      cluster barrier;
//   6. write: each block writes its kept cells straight from its
//      accumulators, at base + the row's offset + the row's cells in
//      earlier column blocks + the cell's rank in the row within the block.
// Each cell's product is computed once, by the same tile_product, so a pair
// scores bit for bit as in the one-pass kernel and the dense one.  It
// cannot deadlock: a cluster's blocks are scheduled together, so a cluster
// barrier waits only on running blocks, and block 0 waits in the look-back
// only on smaller tickets, whose clusters have all started and wait only on
// smaller tickets still.  Past 8 column blocks (bm > 1024; right, not
// fast) block j takes column blocks j, j + 8, ..., one a round: step 1 runs
// the rounds from the last to round 0, with a cluster barrier between
// them, so that round 0's product is the one left in registers; step 6
// writes it, then computes each later round's product again (with every
// FMA of the thread tile) and adds the earlier rounds' cells of each row.
// __launch_bounds__(256, 2), no stack frame and no spill.  The one-pass
// kernel stays the path of every tile of at most 128 x 128.
//
// Contract (checked by the Python wrapper): T >= 1, bn, bm >= 1, d % 16 ==
// 0, contiguous 16-byte-aligned rows, T*bn*bm and capacity + bn*bm below
// 2^31, rows / cols prefilled with -1 and scores with 0, status (items + 1
// words: the items' look-back words and the ticket, items = T when bn, bm
// <= 128, else T * ceil(bn / 128)) zeroed; past 128 a side, a cluster the
// card can place (the wrapper asks pair_scores_compact_band_max_clusters).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "score_tile.cuh"

namespace cg = cooperative_groups;

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
constexpr int kMaxCluster = 8;  // the portable cluster: bm up to 1024 at once

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

// The band kernel's shared memory: the one-pass kernel's, then for each
// row of the band its kept cells in this block's column block (which the
// cluster's other blocks read), its first position past base in this
// block, and a running count (the row's cells in the band while counting,
// then its offset plus its cells in the rounds written so far).  Thread
// r < 128 keeps row r's counts here rather than in registers that would
// stay live across the products.
struct BandSmem {
  Smem s;
  int row_cnt[kBM];
  int row_pos[kBM];
  int row_next[kBM];
};

// The ids of column block c of tile t into sm.cb and its product with the
// band at a0 (rows_a rows) into acc; with kHalves, without the FMAs of a
// half that holds no real row or column (rows_a or cols_b <= 64; uniform
// across the block).  A block past the tile's last column block (only past
// 8 column blocks) gets ids of -1 and zeros.  Every thread of the block
// must call it; it ends in a barrier.
template <bool kHalves>
__device__ __forceinline__ void band_product(
    Smem& sm, const float* __restrict__ a0, const float* __restrict__ b,
    const int* __restrict__ idb, int t, int c, int rows_a, int bm, int d,
    int tr, int tc, float (&acc)[kTM][kTN]) {
  using score_tile::kHalf;
  using score_tile::tile_product;
  const int c0 = c * kBN, cols_b = max(0, min(kBN, bm - c0));
  for (int i = threadIdx.x; i < kBN; i += kThreads)
    sm.cb[i] = i < cols_b ? idb[static_cast<size_t>(t) * bm + c0 + i] : -1;
  const float* b0 = b + (static_cast<size_t>(t) * bm + c0) * d;
  if (cols_b == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    __syncthreads();
  } else if (!kHalves || (rows_a > kHalf && cols_b > kHalf)) {
    tile_product<2, 2>(a0, b0, rows_a, cols_b, d, sm.u.k, tr, tc, acc);
  } else if (rows_a > kHalf) {
    tile_product<2, 1>(a0, b0, rows_a, cols_b, d, sm.u.k, tr, tc, acc);
  } else if (cols_b > kHalf) {
    tile_product<1, 2>(a0, b0, rows_a, cols_b, d, sm.u.k, tr, tc, acc);
  } else {
    tile_product<1, 1>(a0, b0, rows_a, cols_b, d, sm.u.k, tr, tc, acc);
  }
}

// The (row, 4-column group) counts of acc's candidates, scanned within
// each row into cell[] (a row's 32 groups are the 16 entries of two
// neighbouring threads), and each row's kept cells into row_cnt.  Every
// thread of the block must call it; the caller's cluster barrier then
// publishes both.
__device__ __forceinline__ void count_cells(BandSmem& sm,
                                            const float (&acc)[kTM][kTN],
                                            int tr, int tc, float tau) {
  const int tid = threadIdx.x;
  const int g = tc / 4;
  int* cell = sm.s.u.cell;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = half_index(i, tr);
    const unsigned bits = keep_bits(sm.s, acc[i], row, tc, tau);
    cell[row * kGroups + g] = __popc(bits & 0xfu);
    cell[row * kGroups + g + kGroups / 2] = __popc(bits >> 4);
  }
  __syncthreads();
  int local[kCellsPerThread];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kCellsPerThread; ++e) {
    local[e] = sum;
    sum += cell[tid * kCellsPerThread + e];
  }
  const int other = __shfl_xor_sync(0xffffffffu, sum, 1);
  const int start = (tid & 1) ? other : 0;
#pragma unroll
  for (int e = 0; e < kCellsPerThread; ++e)
    cell[tid * kCellsPerThread + e] = start + local[e];
  if ((tid & 1) == 0) sm.row_cnt[tid / 2] = sum + other;
}

// Thread r < 128, after a cluster barrier: row r's kept cells in the
// column blocks of the cluster's blocks before this one (x) and of all of
// them (y), read from their shared memory.
__device__ __forceinline__ int2 cluster_row_cells(cg::cluster_group& cluster,
                                                  const BandSmem& sm,
                                                  int rank, int cs) {
  int2 n = make_int2(0, 0);
  // not unrolled: the unrolled loads spill the accumulators
#pragma unroll 1
  for (int k = 0; k < cs; ++k) {
    const int c = cluster.map_shared_rank(sm.row_cnt, k)[threadIdx.x];
    if (k < rank) n.x += c;
    n.y += c;
  }
  return n;
}

// Each kept cell of acc at base + its row's first position + its rank in
// the row (cell[], from count_cells).  The candidate bits are taken again
// here rather than kept from count_cells, so that they hold no registers
// across the cluster barriers.
__device__ __forceinline__ void write_cells(
    const BandSmem& sm, const float (&acc)[kTM][kTN], int tr, int tc,
    float tau, int* __restrict__ rows, int* __restrict__ cols,
    float* __restrict__ scores, int capacity) {
  const int g = tc / 4;
  const int base = sm.s.base;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = half_index(i, tr);
    const unsigned bits = keep_bits(sm.s, acc[i], row, tc, tau);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int pos = base + sm.row_pos[row] +
                sm.s.u.cell[row * kGroups + g + h * (kGroups / 2)];
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        if (!((bits >> j) & 1u)) continue;
        if (pos < capacity) {
          rows[pos] = sm.s.ra[row];
          cols[pos] = sm.s.cb[half_index(j, tc)];
          scores[pos] = acc[i][j];
        }
        ++pos;
      }
    }
  }
}

// The band kernel of tiles past 128 rows on a side (see the note at the
// top): a cluster of cs blocks an item, item i being band i % n_bands of
// tile i / n_bands; block `rank` of the cluster takes column blocks rank,
// rank + cs, ... of the band, one a round.
__global__ void __launch_bounds__(kThreads, 2)
pair_scores_compact_band_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const int* __restrict__ ida,
                                const int* __restrict__ idb,
                                unsigned long long* __restrict__ status,
                                int* __restrict__ rows, int* __restrict__ cols,
                                float* __restrict__ scores,
                                int* __restrict__ n_total, int n_items,
                                int n_bands, int bn, int bm, int d, float tau,
                                int capacity) {
  __shared__ BandSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int tr = score_tile::thread_row();
  const int tc = score_tile::thread_col();
  const int rounds = ((bm + kBN - 1) / kBN + cs - 1) / cs;

  if (rank == 0 && tid == 0)
    sm.s.item = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status + n_items), 1u));
  cluster.sync();  // every block has started; block 0 holds the ticket
  const int item = *cluster.map_shared_rank(&sm.s.item, 0);
  const int t = item / n_bands, r0 = (item % n_bands) * kBM;
  const int rows_a = min(kBM, bn - r0);
  const float* a0 = a + (static_cast<size_t>(t) * bn + r0) * d;
  for (int i = tid; i < kBM; i += kThreads)
    sm.s.ra[i] = i < rows_a ? ida[static_cast<size_t>(t) * bn + r0 + i] : -1;

  // 1. kept cells a row over the band, rounds from the last to round 0,
  // whose product then stays in registers for step 3
  float acc[kTM][kTN];
  if (tid < kBM) sm.row_next[tid] = 0;
  for (int round = rounds - 1;; --round) {
    band_product<true>(sm.s, a0, b, idb, t, round * cs + rank, rows_a, bm,
                       d, tr, tc, acc);
    count_cells(sm, acc, tr, tc, tau);
    cluster.sync();  // the round's row counts are in every block
    if (round == 0) break;
    if (tid < kBM)
      sm.row_next[tid] += cluster_row_cells(cluster, sm, rank, cs).y;
    cluster.sync();  // read before the next round's counts
  }
  // thread r < 128: row r's cells in round 0, before this block's and in all
  const int2 first = tid < kBM ? cluster_row_cells(cluster, sm, rank, cs)
                               : make_int2(0, 0);
  int band_total;
  const int row_off = block_exclusive_scan(
      tid < kBM ? sm.row_next[tid] + first.y : 0, sm.s.warp_sums,
      &band_total);

  // 2. look-back, by block 0, which hands base to the cluster
  if (rank == 0 && tid < 32) {
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
    if (tid == 0) {
      for (int k = 0; k < cs; ++k)
        *cluster.map_shared_rank(&sm.s.base, k) = base;
      if (item == n_items - 1) *n_total = base + band_total;
    }
  }
  if (tid < kBM) {
    sm.row_pos[tid] = row_off + first.x;
    sm.row_next[tid] = row_off + first.y;
  }
  // base is in every block, and every read of another block's row counts
  // is done
  cluster.sync();

  // 3. write: round 0 from registers; past 8 column blocks, each later
  // round's product again (the full mainloop only: one instance less keeps
  // the kernel in 128 registers without a spill), its rows' cells in
  // earlier column blocks gathered as in step 1
  write_cells(sm, acc, tr, tc, tau, rows, cols, scores, capacity);
  for (int round = 1; round < rounds; ++round) {
    __syncthreads();  // cell[], sm.cb and row_pos are reused
    band_product<false>(sm.s, a0, b, idb, t, round * cs + rank, rows_a, bm,
                        d, tr, tc, acc);
    count_cells(sm, acc, tr, tc, tau);
    cluster.sync();
    if (tid < kBM) {
      const int2 n = cluster_row_cells(cluster, sm, rank, cs);
      sm.row_pos[tid] = sm.row_next[tid] + n.x;
      sm.row_next[tid] += n.y;
    }
    // every block's counts read before they change or their block exits
    cluster.sync();
    write_cells(sm, acc, tr, tc, tau, rows, cols, scores, capacity);
  }
}

// Blocks a band's cluster: one a 128-column block, at most the portable 8.
int band_cluster(int bm) {
  const int n_cb = (bm + kBN - 1) / kBN;
  return n_cb < kMaxCluster ? n_cb : kMaxCluster;
}

cudaLaunchConfig_t band_config(int n_items, int cluster,
                               cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_items * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Clusters of `cluster` band-kernel blocks the current device can hold at
// once (0: none can be placed).  The wrapper asks once per device and
// cluster size, and raises rather than launch where it is 0.
extern "C" cudaError_t pair_scores_compact_band_max_clusters(int cluster,
                                                             int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = band_config(1, cluster, &attr, 0);
  return cudaOccupancyMaxActiveClusters(count, pair_scores_compact_band_kernel,
                                        &cfg);
}

// Plain C entry point: one launch on `stream`; returns its status.  status
// is (items + 1) zeroed 64-bit words: the items' look-back words, then the
// ticket.  Tiles of at most 128 x 128 run the one-pass kernel, T blocks of
// an item each; larger ones the band kernel, T * ceil(bn / 128) items of a
// cluster of min(ceil(bm / 128), 8) blocks each (kernel.py::compact_plan).
extern "C" cudaError_t pair_scores_compact_launch(
    const float* a, const float* b, const int* ida, const int* idb,
    unsigned long long* status, int* rows, int* cols, float* scores,
    int* n_total, int T, int bn, int bm, int d, float tau, int capacity,
    cudaStream_t stream) {
  if (bn <= kBM && bm <= kBN) {
    pair_scores_compact_kernel<<<T, kThreads, 0, stream>>>(
        a, b, ida, idb, status, rows, cols, scores, n_total, T, bn, bm, d,
        tau, capacity);
    return cudaGetLastError();
  }
  const int n_bands = (bn + kBM - 1) / kBM;
  const int n_items = T * n_bands;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      band_config(n_items, band_cluster(bm), &attr, stream);
  return cudaLaunchKernelEx(&cfg, pair_scores_compact_band_kernel, a, b, ida,
                            idb, status, rows, cols, scores, n_total, n_items,
                            n_bands, bn, bm, d, tau, capacity);
}
