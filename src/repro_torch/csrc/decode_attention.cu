// One-token attention over a KV cache (flash-decode), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (decode_attention, pallas_call at :81).  It computes what that
// kernel computes: q (B,H,d) against the caches (B,S,K,d), the G = H/K query
// heads of a kv head together; q scaled by 1/sqrt(d) before the dot;
// positions >= length masked at -1e30 and tiles past length skipped; an
// online softmax with running max, denominator and accumulator in f32; out =
// acc / l in q's dtype.  The caches may be bf16 under an f32 q (the model's
// caches are bf16 whatever its parameters' type).  It takes no int8 scales:
// the reference kernel has no dequant either.
//
// Design (a simple first kernel).  One block of 128 threads per (b, kv
// head), serving its G query heads.  `length` is read from device memory,
// so a host loop of decode steps never waits on the card.  The block walks
// the cache in tiles of 4096 elements (64 positions at d = 64) up to
// `length`.  Each thread stages its 32 elements of the tile's k and v rows
// in registers (all loads issued before any is used; rows at or past
// `length` read as zeros, so what lies past `length` never reaches a sum),
// stores them to shared memory as f32, then issues the next tile's loads
// before this tile's math: scores for G x T (thread: one position, every
// SSTEP-th head; four partial sums break the FMA chain), an online-softmax
// update per head by one warp (shuffles), and acc = alpha * acc + p.v with
// a thread owning one column of d for a strided set of heads.  A `length`
// below 1 (no valid position: the Pallas kernel and its ref give NaN there)
// stops the kernel with a trap; a `length` above S counts as S, as in the
// ref.
//
// Bound on this card: bytes — the k and v rows up to `length` plus q and o,
// at 3.35 TB/s (H100 SXM).  At paper-scorer's 8 lanes x 12 kv heads there
// are 96 blocks for 132 SMs; splitting the sequence across blocks
// (split-K) is the known fix, left for the redesign.  See PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTileElems = 4096;  // cache elements per tile and tensor
constexpr int kPer = kTileElems / kThreads;  // staged a thread, per tensor
constexpr int kMaxG = 16;       // query heads per kv head
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {  // in elements: q (b, h), k and v (b, s, k), o (b, h)
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
};

template <int D>
constexpr int tile_rows() {  // cache positions per tile: 128, 64 or 32
  return kTileElems / D;
}

template <int D>
size_t smem_bytes(int G) {
  constexpr int T = tile_rows<D>();
  return sizeof(float) * (static_cast<size_t>(G) * D +
                          2 * static_cast<size_t>(T) * (D + 1) +
                          static_cast<size_t>(G) * T + 2 * G);
}

// one tile's k and v rows [t0, t0 + T) into registers, zeros at or past
// `length`; every load is issued before any is used
template <typename TKV, int D>
__device__ __forceinline__ void load_tile(const TKV* kb, const TKV* vb,
                                          long long ks, long long vs, int t0,
                                          int length, TKV (&rk)[kPer],
                                          TKV (&rv)[kPer]) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = threadIdx.x + e * kThreads, pos = t0 + i / D, c = i % D;
    const bool in = pos < length;
    rk[e] = in ? kb[pos * ks + c] : zero<TKV>();
    rv[e] = in ? vb[pos * vs + c] : zero<TKV>();
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ kc,
                            const TKV* __restrict__ vc,
                            const int* __restrict__ length_ptr,
                            TQ* __restrict__ o, int S, int K, int G,
                            Strides st, float scale) {
  constexpr int LD = D + 1;
  constexpr int T = tile_rows<D>();
  constexpr int GSTEP = kThreads / D;       // heads served in parallel
  constexpr int NACC = kMaxG / GSTEP;       // heads a thread accumulates
  constexpr int SSTEP = kThreads / T;       // heads scored in parallel
  constexpr int LANE_POS = T / 32;          // positions a lane softmaxes
  extern __shared__ float smem[];
  float* qs = smem;                         // G x D, scaled q
  float* ks = qs + G * D;                   // T x LD
  float* vs = ks + T * LD;                  // T x LD
  float* ps = vs + T * LD;                  // G x T: scores, then p
  float* head_alpha = ps + G * T;           // G
  float* head_l = head_alpha + G;           // G

  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int length_in = *length_ptr;
  if (length_in < 1) __trap();
  const int length = length_in < S ? length_in : S;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, c = i % D;
    qs[i] = to_f32(q[b * st.qb + (kh * G + g) * st.qh + c]) * scale;
  }
  const TKV* kb = kc + b * st.kb + kh * st.kh;
  const TKV* vb = vc + b * st.vb + kh * st.vh;

  const int col = tid % D, g0 = tid / D;        // the p.v role
  const int sj = tid % T, sg0 = tid / T;        // the score role
  float acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.f;
  float m_run[kMaxG / 4], l_run[kMaxG / 4];  // heads warp, warp + 4, ...
#pragma unroll
  for (int n = 0; n < kMaxG / 4; ++n) {
    m_run[n] = kNegInf;
    l_run[n] = 0.f;
  }

  TKV rk[kPer], rv[kPer];
  load_tile<TKV, D>(kb, vb, st.ks, st.vs, 0, length, rk, rv);
  for (int t0 = 0; t0 < length; t0 += T) {
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads, r = i / D, c = i % D;
      ks[r * LD + c] = to_f32(rk[e]);
      vs[r * LD + c] = to_f32(rv[e]);
    }
    __syncthreads();
    if (t0 + T < length)  // the next tile's loads fly during this one's math
      load_tile<TKV, D>(kb, vb, st.ks, st.vs, t0 + T, length, rk, rv);

    for (int g = sg0; g < G; g += SSTEP) {
      const float* qrow = qs + g * D;
      const float* krow = ks + sj * LD;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qrow[c], krow[c], s0);
        s1 = fmaf(qrow[c + 1], krow[c + 1], s1);
        s2 = fmaf(qrow[c + 2], krow[c + 2], s2);
        s3 = fmaf(qrow[c + 3], krow[c + 3], s3);
      }
      ps[g * T + sj] = (t0 + sj < length) ? (s0 + s1) + (s2 + s3) : kNegInf;
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < kMaxG / 4; ++n) {
      const int g = warp + 4 * n;
      if (g >= G) break;
      float* prow = ps + g * T;
      float x[LANE_POS];
      float mx = kNegInf;
#pragma unroll
      for (int m = 0; m < LANE_POS; ++m) {
        x[m] = prow[lane + 32 * m];
        mx = fmaxf(mx, x[m]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[n], mx);
      const float alpha = expf(m_run[n] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < LANE_POS; ++m) {
        const float p = expf(x[m] - m_new);
        prow[lane + 32 * m] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[n] = l_run[n] * alpha + sum;
      m_run[n] = m_new;
      if (lane == 0) head_alpha[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      const int g = g0 + n * GSTEP;
      if (g >= G) break;
      const float* prow = ps + g * T;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int j = 0; j < T; j += 4) {
        a0 = fmaf(prow[j], vs[j * LD + col], a0);
        a1 = fmaf(prow[j + 1], vs[(j + 1) * LD + col], a1);
        a2 = fmaf(prow[j + 2], vs[(j + 2) * LD + col], a2);
        a3 = fmaf(prow[j + 3], vs[(j + 3) * LD + col], a3);
      }
      acc[n] = acc[n] * head_alpha[g] + ((a0 + a1) + (a2 + a3));
    }
  }

#pragma unroll
  for (int n = 0; n < kMaxG / 4; ++n) {
    const int g = warp + 4 * n;
    if (g < G && lane == 0) head_l[g] = l_run[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NACC; ++n) {
    const int g = g0 + n * GSTEP;
    if (g >= G) break;
    store(o + b * st.ob + (kh * G + g) * st.oh + col, acc[n] / head_l[g]);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* length, void* o, int B, int S, int K, int G,
                   const Strides& st, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(G);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  decode_attention_kernel<TQ, TKV, D><<<B * K, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), length, static_cast<TQ*>(o), S, K, G, st,
      scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const void* q, const void* kc, const void* vc,
                       const int* length, void* o, int B, int S, int K, int G,
                       int d, const Strides& st, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<TQ, TKV, 32>(q, kc, vc, length, o, B, S, K, G, st, scale,
                                 stream);
    case 64:
      return launch<TQ, TKV, 64>(q, kc, vc, length, o, B, S, K, G, st, scale,
                                 stream);
    case 128:
      return launch<TQ, TKV, 128>(q, kc, vc, length, o, B, S, K, G, st,
                                  scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype / kv_dtype: 0 = f32, 1 = bf16; the pairs (f32, f32), (bf16, bf16)
// and (f32, bf16) are built.  o has q's dtype.  length: one int32 in device
// memory.  strides: 10 element strides — q (b, h), k (b, s, k), v (b, s, k),
// o (b, h); the head dim is contiguous.
extern "C" cudaError_t decode_attention_launch(
    const void* q, const void* kc, const void* vc, const int* length, void* o,
    int q_dtype, int kv_dtype, int B, int S, int H, int K, int d,
    const long long* strides, float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || H / K > kMaxG)
    return cudaErrorInvalidValue;
  const int G = H / K;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_d<float, float>(q, kc, vc, length, o, B, S, K, G, d, st,
                                    scale, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, length, o, B, S, K, G, d, st, scale, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_d<float, __nv_bfloat16>(q, kc, vc, length, o, B, S, K, G,
                                            d, st, scale, stream);
  return cudaErrorInvalidValue;
}
