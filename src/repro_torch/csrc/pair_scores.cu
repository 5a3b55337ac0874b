// Dense thresholded cosine scores with per-row candidate counts.
//
// Replaces: src/repro/kernels/pair_scores/kernel.py::pair_scores (Pallas, TPU).
// Computes: scores[i, j] = <a_i, b_j> if >= tau else 0, for (N, D) x (M, D)
// f32 row-major inputs, and counts[i] = #{j < m_valid : scores[i, j] >= tau}.
//
// Bound on an H100: 2*N*M*D FLOP against 4*N*M bytes of score writes.  At
// the main path's 4096 x 4096 x 384 that is 12.9 GFLOP (0.19 ms at the
// 67 TFLOP/s f32 SIMT rate) against 64 MiB (0.02 ms at 3.35 TB/s): the
// kernel is bound by f32 operations.  Tensor cores have no IEEE-f32 mode
// and TF32 changes the candidate set, so this is a SIMT FFMA product.
//
// Design.  One block a 128 x 128 output tile, running the mainloop of
// score_tile.cuh (the one pair_scores_compact.cu runs, so the two kernels
// score a pair bit for bit alike): 8 x 8 cells a thread, conflict-free
// shared-memory reads and stores, double-buffered k slices with the next
// slice's loads in flight, every cell fmaf in k order from 0.
// __launch_bounds__(256, 2) holds a thread to 128 registers, so two blocks
// share an SM: 1024 tiles at 4096^2 run in 3.9 waves on 132 SMs.  The
// epilogue is fused: the threshold, two float4 stores a thread row (a warp's
// 16 threads of a row write 256 contiguous bytes each time), and the row
// counts over m_valid, summed across the 16 threads that share a row with
// __shfl_xor_sync (four rows packed a word, 8 bits each: at most 128) before
// one integer atomicAdd a row and tile.  An integer sum does not depend on
// its order, so the counts are deterministic.
//
// Contract (checked by the Python wrapper): n % 128 == 0, m % 128 == 0,
// d % 16 == 0, contiguous 16-byte-aligned rows, counts zeroed.
#include <cuda_runtime.h>

#include "score_tile.cuh"

namespace {

using score_tile::half_index;
using score_tile::kRows;
using score_tile::kTM;
using score_tile::kTN;
using score_tile::kThreads;

__global__ void __launch_bounds__(kThreads, 2)
pair_scores_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ scores, int* __restrict__ counts,
                   int m, int d, int m_valid, float tau) {
  __shared__ __align__(16) score_tile::Slices sm;  // 32 KB
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kRows;
  const int tr = score_tile::thread_row();
  const int tc = score_tile::thread_col();

  float acc[kTM][kTN];
  score_tile::tile_product(a + static_cast<size_t>(row0) * d,
                                b + static_cast<size_t>(col0) * d, kRows,
                                kRows, d, sm, tr, tc, acc);

  unsigned packed[2] = {0u, 0u};  // candidates of rows 0-3 and 4-7, 8 bits
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + half_index(i, tr);
    float out[kTN];
    unsigned cnt = 0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const bool keep = acc[i][j] >= tau;
      out[j] = keep ? acc[i][j] : 0.0f;
      cnt += (keep && col0 + half_index(j, tc) < m_valid) ? 1u : 0u;
    }
    float* dst = scores + static_cast<size_t>(row) * m + col0 + tc;
    *reinterpret_cast<float4*>(dst) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(dst + score_tile::kHalf) =
        make_float4(out[4], out[5], out[6], out[7]);
    packed[i >> 2] |= cnt << (8 * (i & 3));
  }
  // the 16 threads of a half warp hold the same rows
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    packed[0] += __shfl_xor_sync(0xffffffffu, packed[0], o);
    packed[1] += __shfl_xor_sync(0xffffffffu, packed[1], o);
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int cnt = (packed[i >> 2] >> (8 * (i & 3))) & 0xff;
      if (cnt) atomicAdd(counts + row0 + half_index(i, tr), cnt);
    }
  }
}

}  // namespace

// Plain C entry point: launches on `stream`, returns the launch status.
extern "C" cudaError_t pair_scores_launch(const float* a, const float* b,
                                          float* scores, int* counts, int n,
                                          int m, int d, int m_valid, float tau,
                                          cudaStream_t stream) {
  const dim3 grid(m / kRows, n / kRows);
  pair_scores_kernel<<<grid, kThreads, 0, stream>>>(a, b, scores, counts, m,
                                                    d, m_valid, tau);
  return cudaGetLastError();
}
