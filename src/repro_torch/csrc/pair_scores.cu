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
// and TF32 changes the candidate set, so this is a SIMT FFMA product:
// 128 x 128 output tiles per block, 16-deep k slices of a and b staged in
// shared memory (k-major, so each thread reads its rows and columns as
// broadcasts), and an 8 x 8 register block per thread with f32 accumulation
// in k order.  The epilogue fuses the threshold and adds each thread's
// per-row candidate count to counts[] with an integer atomicAdd, which is
// order-independent and therefore deterministic.
//
// Contract (checked by the Python wrapper): n % 128 == 0, m % 128 == 0,
// d % 16 == 0, contiguous 16-byte-aligned rows, counts zeroed.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
pair_scores_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ scores, int* __restrict__ counts,
                   int m, int d, int m_valid, float tau) {
  __shared__ float as[kBK][kBM];
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tr = (tid / (kBN / kTN)) * kTM;
  const int tc = (tid % (kBN / kTN)) * kTN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // 128 rows x 16 floats of each operand: 512 float4 loads, 2 per thread
#pragma unroll
    for (int l = tid; l < kBM * kBK / 4; l += kThreads) {
      const int r = l / (kBK / 4);
      const int c = (l % (kBK / 4)) * 4;
      const float4 va = *reinterpret_cast<const float4*>(
          a + static_cast<size_t>(row0 + r) * d + k0 + c);
      const float4 vb = *reinterpret_cast<const float4*>(
          b + static_cast<size_t>(col0 + r) * d + k0 + c);
      as[c + 0][r] = va.x; as[c + 1][r] = va.y;
      as[c + 2][r] = va.z; as[c + 3][r] = va.w;
      bs[c + 0][r] = vb.x; bs[c + 1][r] = vb.y;
      bs[c + 2][r] = vb.z; bs[c + 3][r] = vb.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ra[i] = as[k][tr + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) rb[j] = bs[k][tc + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + tr + i;
    float out[kTN];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const bool keep = acc[i][j] >= tau;
      out[j] = keep ? acc[i][j] : 0.0f;
      cnt += (keep && col0 + tc + j < m_valid) ? 1 : 0;
    }
    float4* dst = reinterpret_cast<float4*>(
        scores + static_cast<size_t>(row) * m + col0 + tc);
    dst[0] = make_float4(out[0], out[1], out[2], out[3]);
    dst[1] = make_float4(out[4], out[5], out[6], out[7]);
    if (cnt) atomicAdd(counts + row, cnt);
  }
}

}  // namespace

// Plain C entry point: launches on `stream`, returns the launch status.
extern "C" cudaError_t pair_scores_launch(const float* a, const float* b,
                                          float* scores, int* counts, int n,
                                          int m, int d, int m_valid, float tau,
                                          cudaStream_t stream) {
  const dim3 grid(m / kBN, n / kBM);
  pair_scores_kernel<<<grid, kThreads, 0, stream>>>(a, b, scores, counts, m,
                                                    d, m_valid, tau);
  return cudaGetLastError();
}
