// Causal GQA flash attention for f32 inputs, SIMT, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, pallas_call at :92) for f32 q, k and v; bf16 inputs
// take the tensor-core kernel of flash_attention_wgmma.cu, and the Python
// wrapper (repro_torch/kernels/flash_attention/kernel.py) dispatches between
// the two on dtype.  It computes what the Pallas kernel computes: q
// (B,S,H,d) against k, v (B,S,K,d), head h reading kv head h / (H/K); q is
// scaled by 1/sqrt(d) before the dot; running max, denominator and
// accumulator in f32 (online softmax, masked scores at -1e30); kv tiles past
// the diagonal are skipped; out = acc / l.
//
// Design (SIMT f32 FMAs: the f32 path keeps full f32 products, which the
// tensor cores would round to TF32).  One block of 256 threads per (64-row
// q tile, batch * head).  The q tile and each 64-row k and v tile are
// staged in shared memory (rows padded by one float so column walks across
// rows are conflict-free).  A thread computes a 4 x 4 patch of the 64 x 64
// score tile; four threads share each row for its max and sum (warp
// shuffles) and keep the row's running max and denominator in registers; a
// thread accumulates a 4 x d/16 patch of the output in registers.  The loop
// over kv tiles stops at the diagonal; inside the diagonal tile a
// per-element mask qpos >= kpos applies.  Any S works: rows past S are
// zero-filled on load and never written.  The tensors are read in place
// through their strides (the last dimension contiguous).  Blocks take the q
// tiles longest-first.
//
// Bound on this card: the causal FLOPs 4*B*H*d*S(S+1)/2 at the f32 rate
// outside the tensor cores (67 TFLOP/s on an H100 SXM) against the bytes of
// q, k, v and o read or written once.  Every product is an FMA from shared
// memory, so shared-memory bandwidth holds it well below that bound; the
// f32 path serves parity runs (f32 weights), not the bf16 serving path.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

struct Strides {  // in elements: batch, sequence, head of q, k, v and o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1) +
          2 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int H, int G, Strides st, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // output columns a thread holds
  extern __shared__ float smem[];
  float* qs = smem;                         // kBQ x LD, scaled q
  float* ks = qs + kBQ * LD;                // kBK x LD
  float* vs = ks + kBK * LD;                // kBK x LD
  float* ps = vs + kBK * LD;                // kBQ x (kBK + 1): scores, then p
  float* row_alpha = ps + kBQ * (kBK + 1);  // kBQ
  float* row_l = row_alpha + kBQ;           // kBQ

  const int nq = (S + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + kh * st.kh;
  const float* vb = v + b * st.vb + kh * st.vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, pos = q0 + r;
    qs[r * LD + c] = pos < S ? qb[pos * st.qs + c] * scale : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows 4ty..4ty+3, cols tx+16j
  const int sr = tid / 4, sp = tid % 4;    // softmax: row sr, quarter sp
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  for (int kt = 0; kt <= qi; ++kt) {  // kv tiles up to the diagonal
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, pos = k0 + r;
      const bool in = pos < S;
      ks[r * LD + c] = in ? kb[pos * st.ks + c] : 0.f;
      vs[r * LD + c] = in ? vb[pos * st.vs + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = tx + 16 * j;
        ps[r * (kBK + 1) + c] = (q0 + r >= k0 + c) ? s[i][j] : kNegInf;
      }
    __syncthreads();

    // online softmax over this tile; the four threads of a row are
    // neighbouring lanes of one warp
    float* prow = ps + sr * (kBK + 1);
    float mx = kNegInf;
    for (int j = sp; j < kBK; j += 4) mx = fmaxf(mx, prow[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
    for (int j = sp; j < kBK; j += 4) {
      const float p = expf(prow[j] - m_new);
      prow[j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sp == 0) row_alpha[sr] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[4 * ty + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  if (sp == 0) row_l[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, pos = q0 + r;
    if (pos >= S) continue;
    const float l = row_l[r];
    float* orow = o + b * st.ob + pos * st.os + h * st.oh;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / l;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, const Strides& st,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / K, st,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and o f32; strides: 12 element strides (batch, sequence, head) of
// q, k, v, o; the head dim is contiguous.
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int K, int d, const long long* strides, float scale,
    cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, B, S, H, K, st, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, B, S, H, K, st, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, K, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
