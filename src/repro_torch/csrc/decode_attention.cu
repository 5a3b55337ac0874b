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
// decode_attention_wide_kernel takes the columns in chunks of 256; an int8 row takes half the bf16
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

// A head dim past the widest compiled width (kWide = 256): the output
// columns in chunks of kWide, a chunk a grid index beside the (lane, kv
// head, head chunk), so nothing in a block grows with d.  A row group reads
// its rows at width kWide, as decode_attention_kernel<..., 256, ...> does
// (the same lanes, loads and dequantization), but one row at a time: its
// score sums the lanes' dots over every chunk of the row's d columns in
// order (ceil(d / 256) loads of k a row a block, so every column block
// reads all of k: the chunks' count times the k bytes of one read), and
// only chunk cc's columns of v reach its accumulators.  q is read from
// memory (its cache lines stay in L1) where the narrow kernel keeps it in
// registers.  The softmax's statistics are the same in every chunk's
// blocks.  A split's partial of chunk cc is (m, l, acc[256 or the last
// chunk's columns]) at cc * 258 in the split's d + 2 ceil(d / 256) floats;
// the last block of a (lane, kv head, head chunk, column chunk) merges the
// splits of its chunk as the narrow kernel does.
constexpr int kWide = 256;

template <typename TQ, typename TKV, int GC>
__global__ void __launch_bounds__(kThreads, Rows<TKV, kWide>::kMinBlocks)
    decode_attention_wide_kernel(const TQ* __restrict__ q,
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
// multiple of a block iteration's rows, at most kMaxSplits splits.  n_cc
// column chunks (past kWide) multiply the grid's x.
template <typename TKV, int D>
Plan plan(int B, int S, int K, int G, int n_cc, int sms) {
  const int gc = G == 1 ? 1 : Rows<TKV, D>::kGC;
  const int gx = B * K * ((G + gc - 1) / gc) * n_cc;
  const int step = n_cc > 1 ? Rows<TKV, D>::kGroups : Rows<TKV, D>::kStep;
  auto cdiv = [](long long a, long long b) {
    return static_cast<int>((a + b - 1) / b);
  };
  const int want = cdiv(static_cast<long long>(kBlocksPerSM) * sms, gx);
  int chunk = cdiv(cdiv(S, want > 0 ? want : 1), step) * step;
  if (cdiv(S, chunk) > kMaxSplits) chunk = cdiv(cdiv(S, kMaxSplits), step) * step;
  return {gx, cdiv(S, chunk), chunk};
}

// The compiled width a head dim runs at: the next of 32, 64, 128, 256;
// past 256 a chunk of kWide columns (kernel.py's flash width() is the
// same rule).
int width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
// Column chunks of kWide: 1 up to it.
int column_chunks(int d) { return (d + kWide - 1) / kWide; }

template <typename TKV>
Plan plan_d(int d, int B, int S, int K, int G, int sms) {
  switch (width(d)) {
    case 32: return plan<TKV, 32>(B, S, K, G, 1, sms);
    case 64: return plan<TKV, 64>(B, S, K, G, 1, sms);
    case 128: return plan<TKV, 128>(B, S, K, G, 1, sms);
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

template <typename TQ, typename TKV, int GC>
cudaError_t launch_wide(const Call& c) {
  constexpr int E = Rows<TKV, kWide>::kE;
  const Strides& st = c.st;
  const bool vec = reinterpret_cast<uintptr_t>(c.kc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c.vc) % 16 == 0 &&
                   st.kb % E == 0 && st.ks % E == 0 && st.kh % E == 0 &&
                   st.vb % E == 0 && st.vs % E == 0 && st.vh % E == 0;
  const dim3 grid(c.p.gx, c.p.splits);
  decode_attention_wide_kernel<TQ, TKV, GC><<<grid, kThreads, 0, c.stream>>>(
      static_cast<const TQ*>(c.q), static_cast<const TKV*>(c.kc),
      static_cast<const TKV*>(c.vc), static_cast<const unsigned short*>(c.ks),
      static_cast<const unsigned short*>(c.vs), c.length,
      static_cast<TQ*>(c.o), c.ws, c.counters, c.S, c.K, c.G, c.d,
      column_chunks(c.d), c.p.chunk, c.p.splits, vec, st, c.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const Call& c) {
  if (c.d > kWide) {
    if (c.G == 1) return launch_wide<TQ, TKV, 1>(c);
    return launch_wide<TQ, TKV, Rows<TKV, kWide>::kGC>(c);
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
// workspace of B * H * splits partials of d + 2 ceil(d / 256) floats.
// Returns 0 for shapes the kernel does not take.
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
// device memory.  ws: B * H * splits * (d + 2 ceil(d / 256)) floats
// (decode_attention_plan).  counters: at least B * H * ceil(d / 256)
// int32, zero between calls (each call leaves them so).  strides: 16 element strides — q (b,
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
