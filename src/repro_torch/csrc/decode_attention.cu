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
// scale (exact: 7 bits by 8) rounded once to bf16, which is the reference's
// dequantization (src/repro/models/layers.py:306-308, a bf16 product, run
// there in XLA over the whole cache before its decode kernel) bit for bit;
// only the attention's summation order differs.  It does so without the
// conversion pipe (16 results a clock an SM on this card, against 128 for
// an f32 FMA), which an int8 -> f32 and an f32 -> bf16 conversion a value
// would take: see dequant4.  `length` is read from device
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
// once for up to four heads), over `chunk` cache positions.  Any group G
// runs: its heads take ceil(G / GC) chunks, each with its own blocks,
// counter and partials, so nothing in a block grows with G.  splits is
// fixed on the host from S (the cache's capacity) and the SM count, so that
// about 8 blocks an SM are in flight (at the serving shape: 96 x 11 = 1056
// blocks of 192 positions), and at most kMaxSplits.
//   Inside a block, a row group of LPR = D / EPL lanes reads a cache row
// with one 16-byte load a lane (EPL = 8 bf16, 4 f32 or 16 int8 elements;
// two loads, 8 elements, for f32 at width 256, so that LPR stays a power
// of two of at most 32 for the butterfly), so every thread works whatever
// G is.  D is the compiled width (32, 64, 128 or 256) at or above the head
// dim d, any d from 1: a lane whose columns are all past d loads nothing
// and counts zeros (at d = 96 in bf16, 4 of 16 lanes), a lane whose vector
// straddles d loads exactly its elements below d, element by element (an
// int8 half as one 8-byte load), never a byte past the row's d elements,
// and only the d real columns reach the partials and the output; past 256,
// decode_attention_wide_kernel holds NV = ceil(d / 256) vectors a lane
// (up to 4; past them decode_attention_chunked_kernel takes the columns in
// chunks of 256); an int8 row takes half the bf16
// path's lanes, so a block has twice its row groups in flight, and each row
// group also reads the row's k and v scales (one 2-byte load a row that
// its lanes share).  An int8 block serves GC = 2 query heads (not 4) when
// G > 1, which keeps its 16 columns a lane of q and acc per head within the
// registers.  Each row group walks its share of the chunk kUnroll rows at a
// time, all loads issued before any is used, and keeps
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
//   Cache rows are read with 16-byte loads where the bases and the batch,
// position and head strides allow it, element by element otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kUnroll = 4;      // cache rows a row group has in flight
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

// One lane's share of a cache row: NV 16-byte vectors of f32, bf16 or
// int8.
template <int NV>
struct Lane {
  uint4 v[NV];
};

// How a cache of element type TKV and width D is read.
template <typename TKV, int D>
struct Rows {
  // elements of a 16-byte vector, and vectors a lane: two for f32 at
  // width 256, where one a lane would take 64 lanes a row
  static constexpr int kE = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kVecs = D / kE > 32 ? 2 : 1;
  static constexpr int kEPL = kVecs * kE;           // elements a lane
  static constexpr int kLPR = D / kEPL;             // lanes a row
  static constexpr int kGroups = kThreads / kLPR;   // row groups a block
  static constexpr int kStep = kGroups * kUnroll;   // rows a block iteration
  // query heads a block when G > 1: an int8 lane holds 16 columns of each
  static constexpr int kGC = sizeof(TKV) == 1 ? 2 : 4;
  // blocks an SM the registers must leave room for: 4 for int8, whose
  // two-head blocks would take 168 registers a thread (3 blocks) uncapped
  // and ran 18% faster capped at 128 (q (8, 16, 128) over (8, 2048, 8, 128)
  // on an H100); no cap for the others
  static constexpr int kMinBlocks = sizeof(TKV) == 1 ? 4 : 1;
  static_assert(kLPR <= 32 && D % kEPL == 0 && (kLPR & (kLPR - 1)) == 0,
                "a row is a power-of-two share of one warp");
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

// 16 bytes of int8 cache row at p, likewise.
__device__ __forceinline__ uint4 load_row(const int8_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned char* e = reinterpret_cast<const unsigned char*>(p);
  unsigned char x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = __ldg(e + i);
  uint4 u;
  memcpy(&u, x, 16);
  return u;
}

// The first 8 bytes of int8 cache row at p, zeros after them: an int8
// lane half past the head dim.
__device__ __forceinline__ uint4 load_half(const int8_t* p, bool vec) {
  if (vec) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(h.x, h.y, 0u, 0u);
  }
  const unsigned char* e = reinterpret_cast<const unsigned char*>(p);
  unsigned char x[16] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __ldg(e + i);
  uint4 u;
  memcpy(&u, x, 16);
  return u;
}

// The first n (0 < n < 16 bytes' worth) elements of a cache row at p,
// element by element, zeros after them: nothing past the n-th element is
// read, so the cache's last row never reads past its allocation.
template <typename TKV>
__device__ __forceinline__ uint4 load_part(const TKV* p, int n) {
  constexpr int E = 16 / static_cast<int>(sizeof(TKV));
  using U = typename std::conditional<
      sizeof(TKV) == 1, unsigned char,
      typename std::conditional<sizeof(TKV) == 2, unsigned short,
                                unsigned>::type>::type;
  const U* e = reinterpret_cast<const U*>(p);
  U x[E] = {};
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (i < n) x[i] = __ldg(e + i);
  uint4 u;
  memcpy(&u, x, 16);
  return u;
}

// A lane's share of a cache row at p, of which its first nv elements lie
// below the head dim: its vectors loaded there, zeros past it.  A vector
// wholly below the head dim is one 16-byte load (when vec), one that
// straddles it loads exactly its elements below it (an int8 half by one
// 8-byte load); without kPart nv is the whole share, and the vectors load
// with no test.
template <int NV, bool kPart, typename TKV>
__device__ __forceinline__ Lane<NV> load_lane(const TKV* p, bool vec,
                                              int nv) {
  constexpr int E = 16 / static_cast<int>(sizeof(TKV));
  Lane<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int n = nv - i * E;  // elements of vector i below the head dim
    if (!kPart || n >= E) {
      r.v[i] = load_row(p + i * E, vec);
    } else if (n <= 0) {
      r.v[i] = make_uint4(0u, 0u, 0u, 0u);
    } else if (sizeof(TKV) == 1 && n == 8) {
      r.v[i] = load_half(reinterpret_cast<const int8_t*>(p + i * E), vec);
    } else {
      r.v[i] = load_part(p + i * E, n);
    }
  }
  return r;
}

// A bf16 scale twice, as both halves of a bf16x2 word.
__device__ __forceinline__ unsigned load_scale2(const unsigned short* p) {
  const unsigned s = __ldg(p);
  return s | s << 16;
}

// The EPL elements of a lane's f32 or bf16 vectors as f32 (bf16 -> f32 is
// exact: the bits go to the high half).
template <int NV>
__device__ __forceinline__ void unpack(const Lane<NV>& l, float (&x)[4 * NV],
                                       float) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    x[4 * i] = __uint_as_float(l.v[i].x);
    x[4 * i + 1] = __uint_as_float(l.v[i].y);
    x[4 * i + 2] = __uint_as_float(l.v[i].z);
    x[4 * i + 3] = __uint_as_float(l.v[i].w);
  }
}
__device__ __forceinline__ void unpack(const Lane<1>& l, float (&x)[8],
                                       __nv_bfloat16) {
  const unsigned w[4] = {l.v[0].x, l.v[0].y, l.v[0].z, l.v[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// Two bf16 products (a bf16x2 word of values times one of scales), each
// exact product rounded once to bf16, to nearest even: one packed bf16 fma
// with -0 as the addend, which leaves a product's sign of zero as it is.
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// The 4 int8 values of a 32-bit word (byte j is element j) dequantized with
// the row's bf16 scale (s2, twice) into f32: each value times its scale
// rounded once to bf16, ref.py::dequantize bit for bit, on no conversion
// pipe.  Each byte with its sign bit flipped (v + 128, in [0, 255]) goes
// into the low mantissa byte of 2^23 (one byte permute a value), and one
// subtract of 2^23 + 128 leaves v exactly.  |v| <= 127 has at most 7
// significant bits, so each f32's low half is zero and its high half is v
// in bf16: one permute packs two.  A packed bf16 multiply rounds the exact
// products, and the widen back to f32 is a shift or a mask.
__device__ __forceinline__ void dequant4(unsigned w, unsigned s2, float* x) {
  const unsigned b = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(b, 0x4bu, 0x4550u + j)) - 8388736.f;
  const unsigned lo = mul_bf16x2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u), s2);
  const unsigned hi = mul_bf16x2(
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u), s2);
  x[0] = __uint_as_float(lo << 16);
  x[1] = __uint_as_float(lo & 0xffff0000u);
  x[2] = __uint_as_float(hi << 16);
  x[3] = __uint_as_float(hi & 0xffff0000u);
}

// The 16 int8 values of a 16-byte load dequantized with the row's scale.
__device__ __forceinline__ void unpack(const Lane<1>& l, float (&x)[16],
                                       unsigned s2) {
  dequant4(l.v[0].x, s2, x);
  dequant4(l.v[0].y, s2, x + 4);
  dequant4(l.v[0].z, s2, x + 8);
  dequant4(l.v[0].w, s2, x + 12);
}

// kPart: the head dim d is below the width D, so lanes past d load nothing
// (else d == D, and no lane tests it).
template <typename TQ, typename TKV, int D, int GC, bool kPart>
__global__ void __launch_bounds__(kThreads, Rows<TKV, D>::kMinBlocks)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ kc,
                            const TKV* __restrict__ vc,
                            const unsigned short* __restrict__ k_scale,
                            const unsigned short* __restrict__ v_scale,
                            const int* __restrict__ length_ptr,
                            TQ* __restrict__ o, float* __restrict__ ws,
                            int* __restrict__ counters, int S, int K, int G,
                            int d, int chunk, int splits, bool vec,
                            Strides st, float scale) {
  using R = Rows<TKV, D>;
  using V = Lane<R::kVecs>;
  constexpr bool kQ8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = R::kEPL, LPR = R::kLPR, NG = R::kGroups;
  const int DC = kPart ? d : D;            // the columns that are d's
  const int W = DC + 2;                    // a partial: m, l, acc[d]
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
  // this lane's elements below the head dim: EPL, 0 or (int8) 8
  const int nv = kPart ? min(max(d - j * EPL, 0), EPL) : EPL;
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
        qr[gg][e] = g < G && (!kPart || e < nv)
                        ? to_f32(q[b * st.qb + (kh * G + g) * st.qh +
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
      unsigned sk[kUnroll], sv[kUnroll];  // the int8 rows' scales, bf16x2
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + u * NG + grp;
        in[u] = pos < c1;
        rk[u] = in[u] ? load_lane<R::kVecs, kPart>(kb + pos * st.ks, vec, nv)
                      : V{};
        rv[u] = in[u] ? load_lane<R::kVecs, kPart>(vb + pos * st.vs, vec, nv)
                      : V{};
        if constexpr (kQ8) {
          sk[u] = in[u] ? load_scale2(ksb + pos * st.ss_k) : 0u;
          sv[u] = in[u] ? load_scale2(vsb + pos * st.ss_v) : 0u;
        }
      }
      float s[GC][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[EPL];
        if constexpr (kQ8)
          unpack(rk[u], kf, sk[u]);
        else
          unpack(rk[u], kf, TKV{});
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
      if constexpr (kQ8) {
        // the softmax's statistics first, then the v rows dequantized a
        // word (4 columns) at a time into the accumulators: each column's
        // sum in the order of the other paths, acc * alpha then the rows
        float alpha[GC], p[GC][kUnroll];
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) {
          float mx = m[gg];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (in[u]) mx = fmaxf(mx, s[gg][u]);
          alpha[gg] = expf(m[gg] - mx);
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            p[gg][u] = in[u] ? expf(s[gg][u] - mx) : 0.f;
            psum += p[gg][u];
          }
          l[gg] = l[gg] * alpha[gg] + psum;
          m[gg] = mx;
        }
#pragma unroll
        for (int w = 0; w < EPL / 4; ++w) {
          float vw[kUnroll][4];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const unsigned word[4] = {rv[u].v[0].x, rv[u].v[0].y,
                                      rv[u].v[0].z, rv[u].v[0].w};
            dequant4(word[w], sv[u], vw[u]);
          }
#pragma unroll
          for (int gg = 0; gg < GC; ++gg)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float a = acc[gg][4 * w + c] * alpha[gg];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                a = fmaf(p[gg][u], vw[u][c], a);
              acc[gg][4 * w + c] = a;
            }
        }
      } else {
        float vf[kUnroll][EPL];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) unpack(rv[u], vf[u], TKV{});
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
    for (int i = tid; i < GC * DC; i += kThreads) {
      const int gg = i / DC, c = i % DC, g = g0 + gg;
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
  for (int i = tid; i < GC * DC; i += kThreads) {
    const int gg = i / DC, c = i % DC, g = g0 + gg;
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

// A head dim past kMaxVectors vectors of kWide = 256 columns (past d =
// 1024, where decode_attention_wide_kernel's registers would not hold q
// and the accumulators): the output columns in chunks of kWide, a chunk a
// grid index beside the (lane, kv head, head chunk), so nothing in a block
// grows with d.  A row group reads its rows at width kWide, as
// decode_attention_kernel<..., 256, ...> does (the same lanes, loads and
// dequantization), but one row at a time: its score sums the lanes' dots
// over every chunk of the row's d columns in order (ceil(d / 256) loads of
// k a row a block, so every column block reads all of k: the chunks' count
// times the k bytes of one read), and only chunk cc's columns of v reach
// its accumulators.  q is read from memory (its cache lines stay in L1)
// where the narrow kernel keeps it in registers.  The softmax's statistics
// are the same in every chunk's blocks.  A split's partial of chunk cc is
// (m, l, acc[256 or the last chunk's columns]) at cc * 258 in the split's d
// + 2 ceil(d / 256) floats; the last block of a (lane, kv head, head chunk,
// column chunk) merges the splits of its chunk as the narrow kernel does.
constexpr int kWide = 256;

template <typename TQ, typename TKV, int GC>
__global__ void __launch_bounds__(kThreads, Rows<TKV, kWide>::kMinBlocks)
    decode_attention_chunked_kernel(const TQ* __restrict__ q,
                                 const TKV* __restrict__ kc,
                                 const TKV* __restrict__ vc,
                                 const unsigned short* __restrict__ k_scale,
                                 const unsigned short* __restrict__ v_scale,
                                 const int* __restrict__ length_ptr,
                                 TQ* __restrict__ o, float* __restrict__ ws,
                                 int* __restrict__ counters, int S, int K,
                                 int G, int d, int n_cc, int chunk,
                                 int splits, bool vec, Strides st,
                                 float scale) {
  constexpr int D = kWide;
  using R = Rows<TKV, D>;
  using V = Lane<R::kVecs>;
  constexpr bool kQ8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = R::kEPL, LPR = R::kLPR, NG = R::kGroups;
  constexpr int NW = kMaxSplits > NG ? kMaxSplits : NG;
  __shared__ float sm_acc[GC][NG][D];
  __shared__ float sm_m[GC][NG], sm_l[GC][NG];
  __shared__ float sm_w[GC][NW];
  __shared__ float sm_L[GC];
  __shared__ int sm_last;

  const int W = d + 2 * n_cc;              // a split's partials
  const int n_hc = (G + GC - 1) / GC;
  const int x = blockIdx.x;  // ((lane, kv head, head chunk), column chunk)
  const int cc = x % n_cc, y = x / n_cc;
  const int b = y / (K * n_hc), kh = (y / n_hc) % K, g0 = (y % n_hc) * GC;
  const int H = K * G;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, grp = tid / LPR, j = tid % LPR;
  const int col0 = cc * D;
  const int DC = min(D, d - col0);         // chunk cc's columns
  const int nv = min(max(DC - j * EPL, 0), EPL);
  const int length_in = *length_ptr;
  if (length_in < 1) __trap();
  const int len = length_in < S ? length_in : S;
  const int n_valid = (len + chunk - 1) / chunk;

  if (split < n_valid) {
    const int c0 = split * chunk;
    const int c1 = c0 + chunk < len ? c0 + chunk : len;
    float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
    for (int gg = 0; gg < GC; ++gg) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gg][e] = 0.f;
      m[gg] = kNegInf;
      l[gg] = 0.f;
    }
    const TQ* qb = q + b * st.qb + (kh * G + g0) * st.qh + j * EPL;
    const TKV* kb = kc + b * st.kb + kh * st.kh + j * EPL;
    const TKV* vb = vc + b * st.vb + kh * st.vh + col0 + j * EPL;
    const unsigned short* ksb = k_scale + b * st.sb_k + kh * st.sh_k;
    const unsigned short* vsb = v_scale + b * st.sb_v + kh * st.sh_v;

    for (int base = c0; base < c1; base += NG) {  // block-uniform
      const int pos = base + grp;
      const bool in = pos < c1;
      unsigned sk = 0u, sv = 0u;
      if constexpr (kQ8) {
        sk = in ? load_scale2(ksb + pos * st.ss_k) : 0u;
        sv = in ? load_scale2(vsb + pos * st.ss_v) : 0u;
      }
      float dot[GC];
#pragma unroll
      for (int gg = 0; gg < GC; ++gg) dot[gg] = 0.f;
      for (int p = 0; p < n_cc; ++p) {
        const int np = min(max(d - p * D - j * EPL, 0), EPL);
        const V rk = in ? load_lane<R::kVecs, true>(kb + pos * st.ks + p * D,
                                                    vec, np)
                        : V{};
        float kf[EPL];
        if constexpr (kQ8)
          unpack(rk, kf, sk);
        else
          unpack(rk, kf, TKV{});
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) {
          if (g0 + gg >= G) continue;
          const TQ* qr = qb + gg * st.qh + p * D;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (e < np) dot[gg] = fmaf(to_f32(qr[e]) * scale, kf[e], dot[gg]);
        }
      }
      const V rv = in ? load_lane<R::kVecs, true>(vb + pos * st.vs, vec, nv)
                      : V{};
      float vf[EPL];
      if constexpr (kQ8)
        unpack(rv, vf, sv);
      else
        unpack(rv, vf, TKV{});
#pragma unroll
      for (int gg = 0; gg < GC; ++gg) {
        float s = dot[gg];
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const float mx = in ? fmaxf(m[gg], s) : m[gg];
        const float alpha = expf(m[gg] - mx);
        const float pr = in ? expf(s - mx) : 0.f;
        l[gg] = l[gg] * alpha + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[gg][e] = fmaf(pr, vf[e], acc[gg][e] * alpha);
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
    for (int i = tid; i < GC * DC; i += kThreads) {
      const int gg = i / DC, c = i % DC, g = g0 + gg;
      if (g >= G) continue;
      float a = 0.f;
      for (int r = 0; r < NG; ++r) a = fmaf(sm_w[gg][r], sm_acc[gg][r][c], a);
      float* part = ws +
                    (static_cast<long long>(b * H + kh * G + g) * splits +
                     split) * W + cc * (D + 2);
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

  // the last block of this (lane, kv head, head chunk, column chunk)
  // merges the splits of its chunk
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(counters + x, 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < GC && g0 + warp < G) {
    const float* parts =
        ws + static_cast<long long>(b * H + kh * G + g0 + warp) * splits * W +
        cc * (D + 2);
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
  for (int i = tid; i < GC * DC; i += kThreads) {
    const int gg = i / DC, c = i % DC, g = g0 + gg;
    if (g >= G) continue;
    const float* parts =
        ws + static_cast<long long>(b * H + kh * G + g) * splits * W +
        cc * (D + 2);
    float a = 0.f;
    for (int sp = 0; sp < n_valid; ++sp)
      a = fmaf(sm_w[gg][sp], __ldcg(parts + sp * W + 2 + c), a);
    store(o + b * st.ob + (kh * G + g) * st.oh + col0 + c, a / sm_L[gg]);
  }
  if (tid == 0) counters[x] = 0;
}

// A head dim past kWide up to kMaxVectors * kWide (decode_attention_wide
// _kernel): a block a (lane, kv head, head chunk) over all of d, no column
// chunk on the grid, so each k and v byte is read once.  A row group's
// lanes are width kWide's (Rows<TKV, 256>), each holding NV = ceil(d / 256)
// vectors of a row: lane j's vector v is the EPL columns at v 256 + j EPL,
// so a lane's dot sums its columns in the order of the chunked kernel
// (vector by vector, element by element) and the butterfly adds the lanes
// as before.  q, scaled once, and the accumulators stay in registers for
// all NV vectors: GC query heads a block, the narrow kernel's GC, its half
// or 1, whichever keeps q and acc within kBudget registers a thread
// (Wide<TKV, NV>).  The rows stream through a ring of kStages stages in
// shared memory, `unroll` rows a row group a stage (about kStageBytes a
// stage, twice that over int8, whose dequantization makes the sums the
// longer part of a step), by 16-byte cp.async copies that hold no
// register: a thread copies its own lanes' vectors, and an int8 row's two
// scale words, and reads back only those, so a stage needs no barrier,
// only the thread's own cp.async.wait_group, while the next stage is in
// flight.  Only the last vector, which may straddle d, copies part of its
// 16 bytes (the rest zero-filled, nothing read past d); rows past the
// split copy nothing.  Where the caches' bases or strides are not on 16
// bytes a thread loads its vectors element by element (load_lane) and
// stores them to its slots itself.  The softmax's statistics of a stage's
// rows come first, then each vector's v values, 4 columns at a time (int8
// dequantized as in the narrow kernel), into the accumulators: each
// column's sum in the narrow kernel's order.  A split's partial is (m, l,
// acc[d]), d + 2 floats, merged as the narrow kernel's: its row groups 256
// columns at a time through shared memory (the ring's, once drained), the
// splits by the last block in split order, kComb outputs a thread at once.
// The planner aims at kWideBlocksPerSM blocks an SM (what its registers
// leave resident), so the splits the last block merges are few.  Bound:
// bytes, as the narrow kernel's; over an int8 cache the dequantization,
// done once a head chunk (two chunks at G = 4), is the longer part of a
// step.  No instance keeps a stack frame (cuobjdump -res-usage of the
// sm_90a build).
constexpr int kMaxVectors = 4;  // past 1024 columns: the chunked kernel
constexpr int kWideBlocksPerSM = 2;  // resident at its registers
constexpr int kStages = 2;           // the ring's stages
constexpr int kStageBytes = 16384;   // a stage's rows, about (int8: 2x)

template <typename TKV, int NV>
struct Wide {
  using R = Rows<TKV, kWide>;
  static constexpr int kBudget = 128;
  static constexpr int kHead = 2 * NV * R::kEPL;  // q and acc of a head
  // query heads a block when G > 1: the narrow kernel's, its half or 1
  static constexpr int kGC = R::kGC * kHead <= kBudget       ? R::kGC
                             : R::kGC / 2 * kHead <= kBudget ? R::kGC / 2
                                                             : 1;
  // 16-byte pieces of one row a row group: k and v, NV vectors of kVecs
  static constexpr int kRowPieces = 2 * NV * R::kVecs * R::kLPR;
  // rows a row group a stage, and a stage's 16-byte pieces
  // (an int8 row's dequantization makes its stage's sums the longer part
  // of a step, so its stages take twice the rows)
  static constexpr int kBytes = kStageBytes * (sizeof(TKV) == 1 ? 2 : 1);
  static constexpr int kUnroll = kBytes / (16 * R::kGroups * kRowPieces) > 1
                                     ? kBytes / (16 * R::kGroups * kRowPieces)
                                     : 1;
  static constexpr int kStage = R::kGroups * kUnroll * kRowPieces;
  // an int8 row's k and v scale words, a thread's own copies, a stage
  static constexpr int kScales =
      std::is_same<TKV, int8_t>::value ? 2 * kUnroll * kThreads : 0;
  static constexpr int kRingBytes = kStages * (16 * kStage + 4 * kScales);
  static_assert(kRingBytes >= 4 * R::kGC * R::kGroups * kWide,
                "the ring holds the row groups' merge");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

// The 4-byte word holding the bf16 at p (a scale), to dst: 4-byte aligned,
// so inside the allocation that holds p (device allocations come in
// multiples of 256 bytes); nothing read when src_bytes is 0.
__device__ __forceinline__ void cp_async_word(unsigned* dst,
                                              const unsigned short* p,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3}),
               "r"(src_bytes));
}

// The bf16 at p twice, as both halves of a bf16x2 word, from w, the
// 4-byte word that holds it.
__device__ __forceinline__ unsigned scale2_of(unsigned w,
                                              const unsigned short* p) {
  const unsigned s = reinterpret_cast<uintptr_t>(p) & 2 ? w >> 16
                                                        : w & 0xffffu;
  return s | s << 16;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements 4 w .. 4 w + 3 of a lane's vector as f32: f32 and bf16 as they
// lie, int8 dequantized with the row's scale s2.
template <typename TKV, int NVec>
__device__ __forceinline__ void values4(const Lane<NVec>& l, int w,
                                        unsigned s2, float* x) {
  if constexpr (std::is_same<TKV, float>::value) {
    const uint4 u = l.v[w];
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  } else {
    const unsigned words[4] = {l.v[0].x, l.v[0].y, l.v[0].z, l.v[0].w};
    if constexpr (std::is_same<TKV, int8_t>::value) {
      dequant4(words[w], s2, x);
    } else {
      x[0] = __uint_as_float(words[2 * w] << 16);
      x[1] = __uint_as_float(words[2 * w] & 0xffff0000u);
      x[2] = __uint_as_float(words[2 * w + 1] << 16);
      x[3] = __uint_as_float(words[2 * w + 1] & 0xffff0000u);
    }
  }
}

// A thread's part of the wide kernel's ring: its slots and its copies.
template <typename TKV, int NV>
struct WideRing {
  using Wd = Wide<TKV, NV>;
  using R = Rows<TKV, kWide>;
  using V = Lane<R::kVecs>;
  static constexpr int NG = R::kGroups, E = R::kE, U = Wd::kUnroll;
  uint4* ring;
  unsigned* scales;
  const TKV *kb, *vb;                // the thread's lane of its kv head
  const unsigned short *ksb, *vsb;   // the int8 rows' scales
  long long ks, vs, ss_k, ss_v;      // position strides
  int c0, c1, steps, grp, j, tid, nl;
  bool vec;

  // the 16-byte slot of piece p of vector v of k (kv 0) or v (kv 1) of
  // the thread's row u in a stage
  __device__ __forceinline__ uint4* slot(int stage, int u, int v, int kv,
                                         int p) const {
    return ring + stage * Wd::kStage +
           ((((u * NG + grp) * NV + v) * 2 + kv) * R::kVecs + p) * R::kLPR +
           j;
  }

  // the word holding row u's k (kv 0) or v (kv 1) scale in a stage
  __device__ __forceinline__ unsigned* scale(int stage, int u, int kv) const {
    return scales + stage * Wd::kScales + (2 * u + kv) * kThreads + tid;
  }

  // stage i's copies: rows c0 + i NG U + u NG + grp (nothing past c1),
  // then a commit (an empty group past the last stage)
  __device__ __forceinline__ void issue(int i) const {
    if (i < steps) {
      const int stage = i % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = c0 + (i * U + u) * NG + grp;
        const bool in = pos < c1;
        const int row = in ? pos : c0;
        if constexpr (std::is_same<TKV, int8_t>::value) {
          cp_async_word(scale(stage, u, 0), ksb + row * ss_k, in ? 4 : 0);
          cp_async_word(scale(stage, u, 1), vsb + row * ss_v, in ? 4 : 0);
        }
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const TKV* first = kv == 0 ? kb + row * ks : vb + row * vs;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int nv = !in ? 0 : v < NV - 1 ? R::kEPL : nl;
            const TKV* src = first + v * kWide;
            if (vec) {
#pragma unroll
              for (int p = 0; p < R::kVecs; ++p) {
                // a piece past d copies nothing, from the row's first
                const int n = min(max(nv - p * E, 0), E);
                cp_async16(slot(stage, u, v, kv, p),
                           n > 0 ? src + p * E : first,
                           n * static_cast<int>(sizeof(TKV)));
              }
            } else {
              const V r = in ? load_lane<R::kVecs, true>(src, false, nv)
                             : V{};
#pragma unroll
              for (int p = 0; p < R::kVecs; ++p)
                *slot(stage, u, v, kv, p) = r.v[p];
            }
          }
        }
      }
    }
    cp_async_commit();
  }
};

template <typename TQ, typename TKV, int NV, int GC>
__global__ void __launch_bounds__(kThreads)
    decode_attention_wide_kernel(const TQ* __restrict__ q,
                                 const TKV* __restrict__ kc,
                                 const TKV* __restrict__ vc,
                                 const unsigned short* __restrict__ k_scale,
                                 const unsigned short* __restrict__ v_scale,
                                 const int* __restrict__ length_ptr,
                                 TQ* __restrict__ o, float* __restrict__ ws,
                                 int* __restrict__ counters, int S, int K,
                                 int G, int d, int chunk, int splits,
                                 bool vec, Strides st, float scale) {
  using R = Rows<TKV, kWide>;
  using Wd = Wide<TKV, NV>;
  using V = Lane<R::kVecs>;
  constexpr bool kQ8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = R::kEPL, LPR = R::kLPR, NG = R::kGroups;
  constexpr int NVec = R::kVecs, U = Wd::kUnroll;
  constexpr int NW = kMaxSplits > NG ? kMaxSplits : NG;
  extern __shared__ uint4 ring[];          // kStages stages of Wd::kStage
  // then kStages stages of Wd::kScales scale words (int8)
  unsigned* sc_ring = reinterpret_cast<unsigned*>(ring + kStages * Wd::kStage);
  __shared__ float sm_m[GC][NG], sm_l[GC][NG];
  __shared__ float sm_w[GC][NW];           // weights of groups, then splits
  __shared__ float sm_L[GC];
  __shared__ int sm_last;

  const int W = d + 2;                     // a partial: m, l, acc[d]
  const int n_hc = (G + GC - 1) / GC;
  const int x = blockIdx.x;                // (lane, kv head, head chunk)
  const int b = x / (K * n_hc), kh = (x / n_hc) % K, g0 = (x % n_hc) * GC;
  const int H = K * G;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, grp = tid / LPR, j = tid % LPR;
  // this lane's elements of the last vector below the head dim
  const int nl = min(max(d - (NV - 1) * kWide - j * EPL, 0), EPL);
  const int length_in = *length_ptr;
  if (length_in < 1) __trap();
  const int len = length_in < S ? length_in : S;
  const int n_valid = (len + chunk - 1) / chunk;  // splits with a position

  if (split < n_valid) {
    const int c0 = split * chunk;
    const int c1 = c0 + chunk < len ? c0 + chunk : len;
    float qr[GC][NV][EPL], m[GC], l[GC], acc[GC][NV][EPL];
#pragma unroll
    for (int gg = 0; gg < GC; ++gg) {
      const int g = g0 + gg;
      const TQ* qh = q + b * st.qb + (kh * G + g) * st.qh + j * EPL;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          qr[gg][v][e] = g < G && (v < NV - 1 || e < nl)
                             ? to_f32(qh[v * kWide + e]) * scale
                             : 0.f;
          acc[gg][v][e] = 0.f;
        }
      m[gg] = kNegInf;
      l[gg] = 0.f;
    }
    const TKV* kb = kc + b * st.kb + kh * st.kh + j * EPL;
    const TKV* vb = vc + b * st.vb + kh * st.vh + j * EPL;
    const unsigned short* ksb = k_scale + b * st.sb_k + kh * st.sh_k;
    const unsigned short* vsb = v_scale + b * st.sb_v + kh * st.sh_v;
    const int steps = (c1 - c0 + NG * U - 1) / (NG * U);
    const WideRing<TKV, NV> rg{ring,  sc_ring, kb,  vb,    ksb,   vsb,
                               st.ks, st.vs,   st.ss_k, st.ss_v, c0, c1,
                               steps, grp,     j,   tid,   nl,    vec};
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) rg.issue(i);

    for (int i = 0; i < steps; ++i) {  // block-uniform
      rg.issue(i + kStages - 1);
      cp_async_wait<kStages - 1>();  // this thread's copies of stage i in
      const int stage = i % kStages;
      unsigned sk[U] = {}, sv[U] = {};  // the int8 rows' scales, bf16x2
      if constexpr (kQ8) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int pos = c0 + (i * U + u) * NG + grp;
          sk[u] = scale2_of(*rg.scale(stage, u, 0), ksb + pos * st.ss_k);
          sv[u] = scale2_of(*rg.scale(stage, u, 1), vsb + pos * st.ss_v);
        }
      }
      bool in[U];
      float s[GC][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        in[u] = c0 + (i * U + u) * NG + grp < c1;
        float dot[GC];
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) dot[gg] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          V rk;
#pragma unroll
          for (int p = 0; p < NVec; ++p) rk.v[p] = *rg.slot(stage, u, v, 0, p);
#pragma unroll
          for (int w = 0; w < EPL / 4; ++w) {
            float kf[4];
            values4<TKV>(rk, w, sk[u], kf);
#pragma unroll
            for (int gg = 0; gg < GC; ++gg)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                dot[gg] = fmaf(qr[gg][v][4 * w + c], kf[c], dot[gg]);
          }
        }
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) {
#pragma unroll
          for (int off = LPR / 2; off > 0; off /= 2)
            dot[gg] += __shfl_xor_sync(0xffffffffu, dot[gg], off);
          s[gg][u] = dot[gg];
        }
      }
      // the softmax's statistics, then each vector's v values 4 columns
      // at a time into the accumulators: acc * alpha, then the rows
      float alpha[GC], pr[GC][U];
#pragma unroll
      for (int gg = 0; gg < GC; ++gg) {
        float mx = m[gg];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (in[u]) mx = fmaxf(mx, s[gg][u]);
        alpha[gg] = expf(m[gg] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pr[gg][u] = in[u] ? expf(s[gg][u] - mx) : 0.f;
          psum += pr[gg][u];
        }
        l[gg] = l[gg] * alpha[gg] + psum;
        m[gg] = mx;
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        V rv[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int p = 0; p < NVec; ++p)
            rv[u].v[p] = *rg.slot(stage, u, v, 1, p);
#pragma unroll
        for (int w = 0; w < EPL / 4; ++w) {
          float vw[U][4];
#pragma unroll
          for (int u = 0; u < U; ++u) values4<TKV>(rv[u], w, sv[u], vw[u]);
#pragma unroll
          for (int gg = 0; gg < GC; ++gg)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float a = acc[gg][v][4 * w + c] * alpha[gg];
#pragma unroll
              for (int u = 0; u < U; ++u) a = fmaf(pr[gg][u], vw[u][c], a);
              acc[gg][v][4 * w + c] = a;
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring drained: it holds the merge from here

    // merge the row groups in group order into this split's partial, a
    // vector's 256 columns at a time
    float(*sm_acc)[NG][kWide] = reinterpret_cast<float(*)[NG][kWide]>(ring);
#pragma unroll
    for (int gg = 0; gg < GC; ++gg)
      if (j == 0) {
        sm_m[gg][grp] = m[gg];
        sm_l[gg][grp] = l[gg];
      }
    __syncthreads();
    for (int i = tid; i < GC * NG; i += kThreads) {
      const int gg = i / NG, r = i % NG;
      float M = kNegInf;
      for (int r2 = 0; r2 < NG; ++r2) M = fmaxf(M, sm_m[gg][r2]);
      sm_w[gg][r] = expf(sm_m[gg][r] - M);
    }
    __syncthreads();
    for (int gg = tid; gg < GC; gg += kThreads) {
      if (g0 + gg >= G) continue;
      float M = kNegInf, L = 0.f;
      for (int r = 0; r < NG; ++r) M = fmaxf(M, sm_m[gg][r]);
      for (int r = 0; r < NG; ++r) L = fmaf(sm_w[gg][r], sm_l[gg][r], L);
      float* part = ws + (static_cast<long long>(b * H + kh * G + g0 + gg) *
                              splits + split) * W;
      part[0] = M;
      part[1] = L;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int cols = min(kWide, d - v * kWide);  // vector v's below d
#pragma unroll
      for (int gg = 0; gg < GC; ++gg)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          sm_acc[gg][grp][j * EPL + e] = acc[gg][v][e];
      __syncthreads();
      for (int i = tid; i < GC * cols; i += kThreads) {
        const int gg = i / cols, c = i % cols, g = g0 + gg;
        if (g >= G) continue;
        float a = 0.f;
        for (int r = 0; r < NG; ++r)
          a = fmaf(sm_w[gg][r], sm_acc[gg][r][c], a);
        ws[(static_cast<long long>(b * H + kh * G + g) * splits + split) * W +
           2 + v * kWide + c] = a;
      }
      __syncthreads();  // read before the next vector's columns land
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
  // kComb outputs a thread at once, each summed in split order
  constexpr int kComb = 8;
  for (int i0 = tid; i0 < GC * d; i0 += kComb * kThreads) {
    float a[kComb];
    const float* col[kComb];
    int gs[kComb];
#pragma unroll
    for (int t = 0; t < kComb; ++t) {  // past the heads: read a real one
      const int i = min(i0 + t * kThreads, GC * d - 1);
      gs[t] = min(i / d, G - 1 - g0);
      col[t] = ws + static_cast<long long>(b * H + kh * G + g0 + gs[t]) *
                        splits * W + 2 + i % d;
      a[t] = 0.f;
    }
#pragma unroll 4
    for (int sp = 0; sp < n_valid; ++sp)
#pragma unroll
      for (int t = 0; t < kComb; ++t)
        a[t] = fmaf(sm_w[gs[t]][sp], __ldcg(col[t] + sp * W), a[t]);
#pragma unroll
    for (int t = 0; t < kComb; ++t) {
      const int i = i0 + t * kThreads, g = g0 + i / d;
      if (i < GC * d && g < G)
        store(o + b * st.ob + (kh * G + g) * st.oh + i % d,
              a[t] / sm_L[gs[t]]);
    }
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

// The grid and the chunk: about `blocks` blocks in all, chunks a multiple
// of `step` (a block iteration's rows), at most kMaxSplits splits; gc
// query heads a block, n_cc column chunks (the chunked kernel's)
// multiplying the grid's x.
Plan plan_grid(int B, int S, int K, int G, int gc, int step, int n_cc,
               long long blocks) {
  const int gx = B * K * ((G + gc - 1) / gc) * n_cc;
  auto cdiv = [](long long a, long long b) {
    return static_cast<int>((a + b - 1) / b);
  };
  const int want = cdiv(blocks, gx);
  int chunk = cdiv(cdiv(S, want > 0 ? want : 1), step) * step;
  if (cdiv(S, chunk) > kMaxSplits) chunk = cdiv(cdiv(S, kMaxSplits), step) * step;
  return {gx, cdiv(S, chunk), chunk};
}

// The narrow kernel at width D (n_cc = 1) and the chunked kernel (D =
// kWide, n_cc chunks, a row a step).
template <typename TKV, int D>
Plan plan(int B, int S, int K, int G, int n_cc, int sms) {
  const int gc = G == 1 ? 1 : Rows<TKV, D>::kGC;
  const int step = n_cc > 1 ? Rows<TKV, D>::kGroups : Rows<TKV, D>::kStep;
  return plan_grid(B, S, K, G, gc, step, n_cc,
                   static_cast<long long>(kBlocksPerSM) * sms);
}

// The wide kernel over NV vectors of a row: about kWideBlocksPerSM blocks
// an SM, as many as its registers leave resident, so that its splits
// (whose partials of d + 2 floats the last block merges) are few.
template <typename TKV, int NV>
Plan plan_wide(int B, int S, int K, int G, int sms) {
  using W = Wide<TKV, NV>;
  return plan_grid(B, S, K, G, G == 1 ? 1 : W::kGC,
                   Rows<TKV, kWide>::kGroups * W::kUnroll, 1,
                   static_cast<long long>(kWideBlocksPerSM) * sms);
}

// The compiled width a head dim runs at: the next of 32, 64, 128, 256;
// past 256 vectors (or chunks) of kWide columns (kernel.py's flash width()
// is the same rule).
int width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
// Vectors (or column chunks) of kWide a row: 1 up to it.
int column_chunks(int d) { return (d + kWide - 1) / kWide; }

template <typename TKV>
Plan plan_d(int d, int B, int S, int K, int G, int sms) {
  switch (width(d)) {
    case 32: return plan<TKV, 32>(B, S, K, G, 1, sms);
    case 64: return plan<TKV, 64>(B, S, K, G, 1, sms);
    case 128: return plan<TKV, 128>(B, S, K, G, 1, sms);
    default: break;
  }
  switch (column_chunks(d)) {
    case 1: return plan<TKV, 256>(B, S, K, G, 1, sms);
    case 2: return plan_wide<TKV, 2>(B, S, K, G, sms);
    case 3: return plan_wide<TKV, 3>(B, S, K, G, sms);
    case 4: return plan_wide<TKV, 4>(B, S, K, G, sms);
    default: return plan<TKV, 256>(B, S, K, G, column_chunks(d), sms);
  }
}

Plan plan_for(int kv_dtype, int d, int B, int S, int H, int K) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || d < 1) return {0, 0, 0};
  const int sms = sm_count();
  if (sms < 1) return {0, 0, 0};
  switch (kv_dtype) {
    case 0: return plan_d<float>(d, B, S, K, H / K, sms);
    case 1: return plan_d<__nv_bfloat16>(d, B, S, K, H / K, sms);
    case 2: return plan_d<int8_t>(d, B, S, K, H / K, sms);
    default: return {0, 0, 0};
  }
}

// The pointers and sizes of one call, passed down the dispatch.
struct Call {
  const void *q, *kc, *vc, *ks, *vs;
  const int* length;
  void* o;
  float* ws;
  int* counters;
  Plan p;
  int S, K, G, d;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GC, bool kPart>
cudaError_t launch(const Call& c) {
  constexpr int E = Rows<TKV, D>::kE;  // elements of a 16-byte load
  const Strides& st = c.st;
  const bool vec = reinterpret_cast<uintptr_t>(c.kc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c.vc) % 16 == 0 &&
                   st.kb % E == 0 && st.ks % E == 0 && st.kh % E == 0 &&
                   st.vb % E == 0 && st.vs % E == 0 && st.vh % E == 0;
  const dim3 grid(c.p.gx, c.p.splits);
  decode_attention_kernel<TQ, TKV, D, GC, kPart>
      <<<grid, kThreads, 0, c.stream>>>(
          static_cast<const TQ*>(c.q), static_cast<const TKV*>(c.kc),
          static_cast<const TKV*>(c.vc),
          static_cast<const unsigned short*>(c.ks),
          static_cast<const unsigned short*>(c.vs), c.length,
          static_cast<TQ*>(c.o), c.ws, c.counters, c.S, c.K, c.G, c.d,
          c.p.chunk, c.p.splits, vec, st, c.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D, int GC>
cudaError_t launch_part(const Call& c) {
  return c.d == D ? launch<TQ, TKV, D, GC, false>(c)
                  : launch<TQ, TKV, D, GC, true>(c);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Call& c) {
  if (c.G == 1) return launch_part<TQ, TKV, D, 1>(c);
  return launch_part<TQ, TKV, D, Rows<TKV, D>::kGC>(c);
}

// The 16-byte load rule: both caches' bases and strides on 16 bytes.
template <typename TKV>
bool vec_rows(const Call& c) {
  constexpr int E = Rows<TKV, kWide>::kE;
  const Strides& st = c.st;
  return reinterpret_cast<uintptr_t>(c.kc) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c.vc) % 16 == 0 && st.kb % E == 0 &&
         st.ks % E == 0 && st.kh % E == 0 && st.vb % E == 0 &&
         st.vs % E == 0 && st.vh % E == 0;
}

template <typename TQ, typename TKV, int GC>
cudaError_t launch_chunked(const Call& c) {
  const dim3 grid(c.p.gx, c.p.splits);
  decode_attention_chunked_kernel<TQ, TKV, GC>
      <<<grid, kThreads, 0, c.stream>>>(
          static_cast<const TQ*>(c.q), static_cast<const TKV*>(c.kc),
          static_cast<const TKV*>(c.vc),
          static_cast<const unsigned short*>(c.ks),
          static_cast<const unsigned short*>(c.vs), c.length,
          static_cast<TQ*>(c.o), c.ws, c.counters, c.S, c.K, c.G, c.d,
          column_chunks(c.d), c.p.chunk, c.p.splits, vec_rows<TKV>(c), c.st,
          c.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int NV, int GC>
cudaError_t launch_wide(const Call& c) {
  constexpr int smem = Wide<TKV, NV>::kRingBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_wide_kernel<TQ, TKV, NV, GC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.p.gx, c.p.splits);
  decode_attention_wide_kernel<TQ, TKV, NV, GC>
      <<<grid, kThreads, smem, c.stream>>>(
          static_cast<const TQ*>(c.q), static_cast<const TKV*>(c.kc),
          static_cast<const TKV*>(c.vc),
          static_cast<const unsigned short*>(c.ks),
          static_cast<const unsigned short*>(c.vs), c.length,
          static_cast<TQ*>(c.o), c.ws, c.counters, c.S, c.K, c.G, c.d,
          c.p.chunk, c.p.splits, vec_rows<TKV>(c), c.st, c.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int NV>
cudaError_t launch_wide_g(const Call& c) {
  if (c.G == 1) return launch_wide<TQ, TKV, NV, 1>(c);
  return launch_wide<TQ, TKV, NV, Wide<TKV, NV>::kGC>(c);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const Call& c) {
  if (c.d > kWide) {
    switch (column_chunks(c.d)) {
      case 2: return launch_wide_g<TQ, TKV, 2>(c);
      case 3: return launch_wide_g<TQ, TKV, 3>(c);
      case 4: return launch_wide_g<TQ, TKV, 4>(c);
      default: break;
    }
    if (c.G == 1) return launch_chunked<TQ, TKV, 1>(c);
    return launch_chunked<TQ, TKV, Rows<TKV, kWide>::kGC>(c);
  }
  switch (width(c.d)) {
    case 32: return launch_g<TQ, TKV, 32>(c);
    case 64: return launch_g<TQ, TKV, 64>(c);
    case 128: return launch_g<TQ, TKV, 128>(c);
    default: return launch_g<TQ, TKV, 256>(c);
  }
}

}  // namespace

// The launch plan of a call: splits (blocks a (lane, kv head, head chunk,
// column chunk)) and chunk (cache positions a split), for the f32
// workspace of B * H * splits partials of decode_attention_partial(d)
// floats.  Returns 0 for shapes the kernel does not take.
extern "C" int decode_attention_plan(int kv_dtype, int B, int S, int H,
                                     int K, int d, int* splits, int* chunk) {
  const Plan p = plan_for(kv_dtype, d, B, S, H, K);
  *splits = p.splits;
  *chunk = p.chunk;
  return p.splits > 0;
}

// The floats of one split's partial for head dim d: m, l and acc[d], with
// an m and l a column chunk past kMaxVectors vectors (the chunked kernel).
extern "C" long long decode_attention_partial(int d) {
  const int n = column_chunks(d);
  return d + 2LL * (n > kMaxVectors ? n : 1);
}

// q_dtype / kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (caches only); the pairs
// (f32, f32), (bf16, bf16), (f32, bf16), (f32, int8) and (bf16, int8) are
// built.  An int8 cache needs ks and vs, its bf16 scales (B, S, K); the
// other caches take none (null).  o has q's dtype.  length: one int32 in
// device memory.  ws: B * H * splits * decode_attention_partial(d) floats
// (decode_attention_plan).  counters: at least B * H int32 (B * H *
// ceil(d / 256) past 1024 columns), zero between calls (each call leaves
// them so).  strides: 16 element strides — q (b,
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
               d, st, scale, stream};
  if (q_dtype == 0 && kv_dtype == 0) return dispatch_d<float, float>(c);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(c);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_d<float, __nv_bfloat16>(c);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch_d<float, int8_t>(c);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_d<__nv_bfloat16, int8_t>(c);
  return cudaErrorInvalidValue;
}
