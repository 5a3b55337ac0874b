// One-token attention over a KV cache (flash-decode), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (decode_attention, pallas_call at :81).  It computes what that
// kernel computes: q (B,H,d) against the caches (B,S,K,d), the G = H/K query
// heads of a kv head together; q scaled by 1/sqrt(d) before the dot;
// positions >= length never reach a sum; an online softmax with running
// max, denominator and accumulator in f32; out = acc / l in q's dtype.  The
// caches may be bf16 under an f32 q (the model's caches are bf16 whatever
// its parameters' type).  The caches may also be int8 with bf16 scales a
// (lane, position, kv head), the model's int8 KV cache (kv_quant): the
// kernel dequantizes each value as it loads it, the int8 value times its
// scale (exact in f32: 7 bits by 8) rounded once to bf16 with
// __float2bfloat16_rn, which is the reference's dequantization
// (src/repro/models/layers.py:306-308, a bf16 product, run there in XLA over
// the whole cache before its decode kernel) bit for bit; only the
// attention's summation order differs.  `length` is read from device
// memory, so a host loop of decode steps never waits on the card; a
// `length` below 1 (no valid position: the Pallas kernel and its ref give
// NaN there) stops the kernel with a trap, and one above S counts as S, as
// in the ref.
//
// Bound on this card: bytes.  The k and v rows up to `length`, plus q and
// o, at 3.35 TB/s (H100 SXM): at paper-scorer's (8, 12, 64) against an (8,
// 2048, 12, 64) bf16 cache, 50.3 MB in 0.0150 ms; over an int8 cache the
// rows and their two-byte scales, (d + 2) / (2 d) of that (0.52 at d = 64).
//
// Design: split across the sequence, in one launch.  The grid is (B * K *
// head chunks, splits): a block serves one (lane, kv head) and a chunk of
// GC of its query heads (GC = 1 when G = 1, else 4, so a kv row is read
// once for up to four heads), over `chunk` cache positions.  splits is
// fixed on the host from S (the cache's capacity) and the SM count, so that
// about 8 blocks an SM are in flight (at the serving shape: 96 x 11 = 1056
// blocks of 192 positions), and at most kMaxSplits.
//   Inside a block, a row group of LPR = d / EPL lanes reads a cache row
// with one 16-byte load a lane (EPL = 8 bf16 or 4 f32 elements), so every
// thread works whatever G is.  An int8 row is read 8 bytes a lane (EPL = 8
// again), so it keeps the bf16 path's lanes a row, row groups and launch
// plan, and each row group also reads the row's k and v scales.  Each row
// group walks its share of the chunk kUnroll rows at a time, all loads
// issued before any is used, and keeps
// its own online softmax (m, l, and acc over its lanes' columns); a score
// is the lanes' partial dots summed by an xor butterfly, which leaves the
// same sum on every lane.  At the chunk's end the block merges its row
// groups in group order and writes a partial (m, l, acc[d]) per query head
// to an f32 workspace.  A block whose chunk starts at or past `length`
// writes nothing.
//   The combine runs in the same launch: each block fences its writes and
// adds one to its (lane, kv head, head chunk)'s counter; the block that
// sees splits - 1 there is the last, merges the first ceil(length / chunk)
// partials in split order (m, then weights exp(m_s - M), then l and acc),
// writes out, and resets the counter to 0.  The merge order is fixed, so
// the output does not depend on which block finished last, and repeated
// calls agree bit for bit.  The counters are zeroed once when the caller
// allocates them; no memset or second kernel runs per call.  Calls must be
// ordered on one stream (a second stream would share the counters).
//   Cache rows are read with 16-byte (int8: 8-byte) loads where the bases
// and the batch, position and head strides allow it, element by element
// otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kUnroll = 4;      // cache rows a row group has in flight
constexpr int kMaxG = 16;       // query heads per kv head
constexpr int kMaxSplits = 64;  // partials one combine merges (two a lane)
constexpr int kBlocksPerSM = 8;
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {  // in elements: q (b, h), k and v (b, s, k), o (b, h),
                  // the int8 cache's k and v scales (b, s, k)
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh, sb_k, ss_k, sh_k, sb_v,
      ss_v, sh_v;
};

// One lane's load of a cache row: 16 bytes of f32 or bf16, 8 of int8.
template <typename TKV>
struct Load {
  using type = uint4;
  static constexpr int kBytes = 16;
};
template <>
struct Load<int8_t> {
  using type = uint2;
  static constexpr int kBytes = 8;
};

// How a cache of element type TKV and head dim D is read.
template <typename TKV, int D>
struct Rows {
  static constexpr int kEPL = Load<TKV>::kBytes / static_cast<int>(sizeof(TKV));
  static constexpr int kLPR = D / kEPL;             // lanes a row
  static constexpr int kGroups = kThreads / kLPR;   // row groups a block
  static constexpr int kStep = kGroups * kUnroll;   // rows a block iteration
  static_assert(kLPR <= 32 && D % kEPL == 0, "a row fits one warp");
};

// 16 bytes of cache row at p: one load when aligned, else element by
// element (the bits of each element, as they lie).
template <typename TKV>
__device__ __forceinline__ uint4 load_row(const TKV* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 u;
  if (sizeof(TKV) == 2) {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
    unsigned short x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __ldg(e + i);
    memcpy(&u, x, 16);
  } else {
    const unsigned* e = reinterpret_cast<const unsigned*>(p);
    u = make_uint4(__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3));
  }
  return u;
}

// 8 bytes of int8 cache row at p, likewise.
__device__ __forceinline__ uint2 load_row(const int8_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned char* e = reinterpret_cast<const unsigned char*>(p);
  unsigned char x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __ldg(e + i);
  uint2 u;
  memcpy(&u, x, 8);
  return u;
}

// A bf16 scale as f32 (exact: the bits go to the high half).
__device__ __forceinline__ float load_scale(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

// The EPL elements of a 16-byte load as f32 (bf16 -> f32 is exact: the
// bits go to the high half).
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// The 8 int8 values of an 8-byte load dequantized with the row's scale s:
// each product, exact in f32, rounded once to bf16 and widened back.
__device__ __forceinline__ void unpack(const uint2& u, float (&x)[8],
                                       float s) {
  const unsigned w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = static_cast<float>(
          static_cast<signed char>((w[i] >> (8 * j)) & 0xffu));
      x[4 * i + j] = __bfloat162float(__float2bfloat16_rn(v * s));
    }
}

template <typename TQ, typename TKV, int D, int GC>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ kc,
                            const TKV* __restrict__ vc,
                            const unsigned short* __restrict__ k_scale,
                            const unsigned short* __restrict__ v_scale,
                            const int* __restrict__ length_ptr,
                            TQ* __restrict__ o, float* __restrict__ ws,
                            int* __restrict__ counters, int S, int K, int G,
                            int chunk, int splits, bool vec, Strides st,
                            float scale) {
  using R = Rows<TKV, D>;
  using V = typename Load<TKV>::type;
  constexpr bool kQ8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = R::kEPL, LPR = R::kLPR, NG = R::kGroups;
  constexpr int W = D + 2;                 // a partial: m, l, acc[D]
  constexpr int NW = kMaxSplits > NG ? kMaxSplits : NG;
  __shared__ float sm_acc[GC][NG][D];
  __shared__ float sm_m[GC][NG], sm_l[GC][NG];
  __shared__ float sm_w[GC][NW];           // weights of groups, then splits
  __shared__ float sm_L[GC];
  __shared__ int sm_last;

  const int n_hc = (G + GC - 1) / GC;
  const int x = blockIdx.x;                // (lane, kv head, head chunk)
  const int b = x / (K * n_hc), kh = (x / n_hc) % K, g0 = (x % n_hc) * GC;
  const int H = K * G;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, grp = tid / LPR, j = tid % LPR;
  const int length_in = *length_ptr;
  if (length_in < 1) __trap();
  const int len = length_in < S ? length_in : S;
  const int n_valid = (len + chunk - 1) / chunk;  // splits with a position

  if (split < n_valid) {
    const int c0 = split * chunk;
    const int c1 = c0 + chunk < len ? c0 + chunk : len;
    float qr[GC][EPL], m[GC], l[GC], acc[GC][EPL];
#pragma unroll
    for (int gg = 0; gg < GC; ++gg) {
      const int g = g0 + gg;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        qr[gg][e] = g < G ? to_f32(q[b * st.qb + (kh * G + g) * st.qh +
                                     j * EPL + e]) * scale
                          : 0.f;
        acc[gg][e] = 0.f;
      }
      m[gg] = kNegInf;
      l[gg] = 0.f;
    }
    const TKV* kb = kc + b * st.kb + kh * st.kh + j * EPL;
    const TKV* vb = vc + b * st.vb + kh * st.vh + j * EPL;
    const unsigned short* ksb = k_scale + b * st.sb_k + kh * st.sh_k;
    const unsigned short* vsb = v_scale + b * st.sb_v + kh * st.sh_v;

    for (int base = c0; base < c1; base += R::kStep) {  // block-uniform
      V rk[kUnroll], rv[kUnroll];
      float sk[kUnroll], sv[kUnroll];  // the int8 rows' scales
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + u * NG + grp;
        in[u] = pos < c1;
        rk[u] = in[u] ? load_row(kb + pos * st.ks, vec) : V{};
        rv[u] = in[u] ? load_row(vb + pos * st.vs, vec) : V{};
        if constexpr (kQ8) {
          sk[u] = in[u] ? load_scale(ksb + pos * st.ss_k) : 0.f;
          sv[u] = in[u] ? load_scale(vsb + pos * st.ss_v) : 0.f;
        }
      }
      float s[GC][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[EPL];
        if constexpr (kQ8)
          unpack(rk[u], kf, sk[u]);
        else
          unpack(rk[u], kf);
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[gg][e], kf[e], dot);
#pragma unroll
          for (int off = LPR / 2; off > 0; off /= 2)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[gg][u] = dot;
        }
      }
      float vf[kUnroll][EPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (kQ8)
          unpack(rv[u], vf[u], sv[u]);
        else
          unpack(rv[u], vf[u]);
      }
#pragma unroll
      for (int gg = 0; gg < GC; ++gg) {
        float mx = m[gg];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (in[u]) mx = fmaxf(mx, s[gg][u]);
        const float alpha = expf(m[gg] - mx);
        float p[kUnroll], psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = in[u] ? expf(s[gg][u] - mx) : 0.f;
          psum += p[u];
        }
        l[gg] = l[gg] * alpha + psum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[gg][e] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][e], a);
          acc[gg][e] = a;
        }
        m[gg] = mx;
      }
    }

    // merge the row groups in group order into this split's partial
#pragma unroll
    for (int gg = 0; gg < GC; ++gg) {
      if (j == 0) {
        sm_m[gg][grp] = m[gg];
        sm_l[gg][grp] = l[gg];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[gg][grp][j * EPL + e] = acc[gg][e];
    }
    __syncthreads();
    for (int i = tid; i < GC * NG; i += kThreads) {
      const int gg = i / NG, r = i % NG;
      float M = kNegInf;
      for (int r2 = 0; r2 < NG; ++r2) M = fmaxf(M, sm_m[gg][r2]);
      sm_w[gg][r] = expf(sm_m[gg][r] - M);
    }
    __syncthreads();
    for (int i = tid; i < GC * D; i += kThreads) {
      const int gg = i / D, c = i % D, g = g0 + gg;
      if (g >= G) continue;
      float a = 0.f;
      for (int r = 0; r < NG; ++r) a = fmaf(sm_w[gg][r], sm_acc[gg][r][c], a);
      float* part = ws + (static_cast<long long>(b * H + kh * G + g) * splits +
                          split) * W;
      part[2 + c] = a;
      if (c == 0) {
        float M = kNegInf, L = 0.f;
        for (int r = 0; r < NG; ++r) M = fmaxf(M, sm_m[gg][r]);
        for (int r = 0; r < NG; ++r) L = fmaf(sm_w[gg][r], sm_l[gg][r], L);
        part[0] = M;
        part[1] = L;
      }
    }
  }

  // the last block of this (lane, kv head, head chunk) merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(counters + x, 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < GC && g0 + warp < G) {
    const float* parts =
        ws + static_cast<long long>(b * H + kh * G + g0 + warp) * splits * W;
    float ms[2], ls[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      ms[h] = sp < n_valid ? __ldcg(parts + sp * W) : kNegInf;
      ls[h] = sp < n_valid ? __ldcg(parts + sp * W + 1) : 0.f;
    }
    float M = fmaxf(ms[0], ms[1]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      const float w = sp < n_valid ? expf(ms[h] - M) : 0.f;
      if (sp < NW) sm_w[warp][sp] = w;
      L = fmaf(w, ls[h], L);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) sm_L[warp] = L;
  }
  __syncthreads();
  for (int i = tid; i < GC * D; i += kThreads) {
    const int gg = i / D, c = i % D, g = g0 + gg;
    if (g >= G) continue;
    const float* parts =
        ws + static_cast<long long>(b * H + kh * G + g) * splits * W;
    float a = 0.f;
    for (int sp = 0; sp < n_valid; ++sp)
      a = fmaf(sm_w[gg][sp], __ldcg(parts + sp * W + 2 + c), a);
    store(o + b * st.ob + (kh * G + g) * st.oh + c, a / sm_L[gg]);
  }
  if (tid == 0) counters[x] = 0;
}

// The SM count of the current device, asked once per device.
int sm_count() {
  static std::atomic<int> known[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && known[dev].load(std::memory_order_relaxed))
    return known[dev].load(std::memory_order_relaxed);
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

struct Plan {
  int gx, splits, chunk;
};

// The grid and the chunk: about kBlocksPerSM blocks an SM, chunks a
// multiple of a block iteration's rows, at most kMaxSplits splits.
template <typename TKV, int D>
Plan plan(int B, int S, int K, int G, int sms) {
  const int gc = G == 1 ? 1 : 4;
  const int gx = B * K * ((G + gc - 1) / gc);
  const int step = Rows<TKV, D>::kStep;
  auto cdiv = [](long long a, long long b) {
    return static_cast<int>((a + b - 1) / b);
  };
  const int want = cdiv(static_cast<long long>(kBlocksPerSM) * sms, gx);
  int chunk = cdiv(cdiv(S, want > 0 ? want : 1), step) * step;
  if (cdiv(S, chunk) > kMaxSplits) chunk = cdiv(cdiv(S, kMaxSplits), step) * step;
  return {gx, cdiv(S, chunk), chunk};
}

template <typename TKV>
Plan plan_d(int d, int B, int S, int K, int G, int sms) {
  switch (d) {
    case 32: return plan<TKV, 32>(B, S, K, G, sms);
    case 64: return plan<TKV, 64>(B, S, K, G, sms);
    case 128: return plan<TKV, 128>(B, S, K, G, sms);
    default: return {0, 0, 0};
  }
}

Plan plan_for(int kv_dtype, int d, int B, int S, int H, int K) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || H / K > kMaxG)
    return {0, 0, 0};
  const int sms = sm_count();
  if (sms < 1) return {0, 0, 0};
  switch (kv_dtype) {
    case 0: return plan_d<float>(d, B, S, K, H / K, sms);
    case 1: return plan_d<__nv_bfloat16>(d, B, S, K, H / K, sms);
    case 2: return plan_d<int8_t>(d, B, S, K, H / K, sms);
    default: return {0, 0, 0};
  }
}

template <typename TQ, typename TKV, int D, int GC>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const int* length, void* o,
                   float* ws, int* counters, const Plan& p, int S, int K,
                   int G, const Strides& st, float scale,
                   cudaStream_t stream) {
  constexpr int EPL = Rows<TKV, D>::kEPL, BYTES = Load<TKV>::kBytes;
  const bool vec = reinterpret_cast<uintptr_t>(kc) % BYTES == 0 &&
                   reinterpret_cast<uintptr_t>(vc) % BYTES == 0 &&
                   st.kb % EPL == 0 && st.ks % EPL == 0 && st.kh % EPL == 0 &&
                   st.vb % EPL == 0 && st.vs % EPL == 0 && st.vh % EPL == 0;
  const dim3 grid(p.gx, p.splits);
  decode_attention_kernel<TQ, TKV, D, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), static_cast<const unsigned short*>(ks),
      static_cast<const unsigned short*>(vs), length, static_cast<TQ*>(o), ws,
      counters,
      S, K, G, p.chunk, p.splits, vec, st, scale);
  return cudaGetLastError();
}

// The pointers and sizes of one call, passed down the dispatch.
struct Call {
  const void *q, *kc, *vc, *ks, *vs;
  const int* length;
  void* o;
  float* ws;
  int* counters;
  Plan p;
  int S, K, G;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Call& c) {
  if (c.G == 1)
    return launch<TQ, TKV, D, 1>(c.q, c.kc, c.vc, c.ks, c.vs, c.length, c.o,
                                 c.ws, c.counters, c.p, c.S, c.K, c.G, c.st,
                                 c.scale, c.stream);
  return launch<TQ, TKV, D, 4>(c.q, c.kc, c.vc, c.ks, c.vs, c.length, c.o,
                               c.ws, c.counters, c.p, c.S, c.K, c.G, c.st,
                               c.scale, c.stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const Call& c, int d) {
  switch (d) {
    case 32: return launch_g<TQ, TKV, 32>(c);
    case 64: return launch_g<TQ, TKV, 64>(c);
    case 128: return launch_g<TQ, TKV, 128>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan of a call: splits (blocks a (lane, kv head, head chunk))
// and chunk (cache positions a split), for the f32 workspace of B * H *
// splits partials of d + 2 floats.  Returns 0 for shapes the kernel does
// not take.
extern "C" int decode_attention_plan(int kv_dtype, int B, int S, int H,
                                     int K, int d, int* splits, int* chunk) {
  const Plan p = plan_for(kv_dtype, d, B, S, H, K);
  *splits = p.splits;
  *chunk = p.chunk;
  return p.splits > 0;
}

// q_dtype / kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (caches only); the pairs
// (f32, f32), (bf16, bf16), (f32, bf16), (f32, int8) and (bf16, int8) are
// built.  An int8 cache needs ks and vs, its bf16 scales (B, S, K); the
// other caches take none (null).  o has q's dtype.  length: one int32 in
// device memory.  ws: B * H * splits * (d + 2) floats
// (decode_attention_plan).  counters: at least B * H int32, zero between
// calls (each call leaves them so).  strides: 16 element strides — q (b,
// h), k (b, s, k), v (b, s, k), o (b, h), the k scales (b, s, k), the v
// scales (b, s, k); the head dim is contiguous.
extern "C" cudaError_t decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const int* length, void* o, float* ws, int* counters,
    long long n_counters, int q_dtype, int kv_dtype, int B, int S, int H,
    int K, int d, const long long* strides, float scale,
    cudaStream_t stream) {
  const Plan p = plan_for(kv_dtype, d, B, S, H, K);
  if (p.splits < 1 || n_counters < p.gx) return cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return cudaErrorInvalidValue;
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13], strides[14], strides[15]};
  const Call c{q, kc, vc, ks, vs, length, o, ws, counters, p, S, K, H / K,
               st, scale, stream};
  if (q_dtype == 0 && kv_dtype == 0) return dispatch_d<float, float>(c, d);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(c, d);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_d<float, __nv_bfloat16>(c, d);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch_d<float, int8_t>(c, d);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_d<__nv_bfloat16, int8_t>(c, d);
  return cudaErrorInvalidValue;
}
