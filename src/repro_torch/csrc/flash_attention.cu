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
// the diagonal are skipped; out = acc / l.  Any d from 1: up to 256 it
// runs at the compiled width above it (32, 64, 128 or 256), the copies
// zero-filling the columns past d (element by element where d is not a
// multiple of 4), whose products add exact zeros, and only the d real
// output columns are stored.  Past 256 flash_attention_wide_kernel runs
// it on a thread-block cluster, a block a slab of 128 or 256 columns, the
// slabs' partial scores summed over distributed shared memory, so Q.K^T
// runs once over d (see its note); past 8 slabs of 256, beyond the portable
// cluster, flash_attention_slab_loop_kernel runs it in column chunks of
// 256 (ceil(d / 256) times Q.K^T's work).
//
// Bound on this card: the causal FLOPs 4*B*H*d*S(S+1)/2 at the f32 rate
// outside the tensor cores (67 TFLOP/s on an H100 SXM), far above the bytes
// of q, k, v and o.  Every product stays an exact f32 FMA (the tensor cores
// would round the inputs to TF32), so the FMA pipe is the limit, and the
// design keeps shared-memory loads, global loads and the softmax off its
// path.
//
// Design.  A block of Plan<D>::kThreads threads per (q tile of BQ rows,
// batch * head), on a one-dimensional grid, every head's longest q tile
// first; any B * H runs.  Threads form TY row groups x TX column groups, TX
// = d / 8.  A thread holds 8 q rows (8 ty .. 8 ty + 7) in both products:
//   S = Q.K^T: an 8 x NS register tile of scores, keys 4 tx + e + g BK/2.
//   Q (scaled) and K are kept transposed in shared memory, Q once a block
//   and K after each tile lands, so each dim of the sum is two 16-byte
//   loads of Q^T and NS/4 of K^T: at d = 64 four loads for 64 FMAs, the
//   same register plan as P.V, which lets the compiler load a dim ahead.
//   Scores are summed over d in order from 0, as the SIMT kernel before.
//   Softmax in registers: a row's max and sum over the thread's keys, then
//   shuffles across the TX lanes that share the row; the running max and
//   denominator of the thread's 8 rows stay in registers.  exp(x - m) is
//   2^(x log2 e - m log2 e) on the MUFU's ex2 (one FMA and one ex2 where
//   expf took about ten instructions).  Only tiles that reach past the
//   block's first row are masked, per element.  P goes to shared memory
//   once, transposed (P^T[key][row]) with its 16-byte row chunks
//   XOR-swizzled by (key / 4) & 7, the layout the P.V loop reads.
//   O += P.V: an 8 x 8 register tile of the output (columns 4 tx .. 4 tx + 3
//   and d/2 + 4 tx ..), four 16-byte loads (two of P^T, two of V) for 64
//   FMAs, keys in order from 0.
// K and V tiles of BK rows are copied by 16-byte cp.async (4-byte when a
// base address or stride is not a multiple of 16 bytes): V[kt] while K[kt]
// is transposed and Q.K^T runs, K[kt + 1] into the freed copy buffer while
// Q.K^T, the softmax and P.V run.  Three barriers a tile.  Rows past S are
// zero-filled by the copies and never stored.  Shared memory holds Q^T, the
// K copy (rows padded by 4 floats, so the transpose's reads of 8 rows fall
// in distinct banks), K^T, V and P^T: 113 KB at d = 64, two blocks an SM.
// At width 256 a row group is a whole warp (TX = 32), so a tile of 32 keys
// gives each thread one key (NS = 1) in Q.K^T; 256 threads, 64 q rows and
// 32-row kv tiles take 169 KB, one block an SM.
// The launch plan (threads, BQ, BK, shared memory) is kernel.py's f32_plan,
// checked here against the compiled constants.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // in elements: batch, sequence, head of q, k, v and o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// The plan of a head dim, kernel.py's F32_PLANS: threads and kv rows a tile.
template <int D>
struct Plan;
template <>
struct Plan<32> {
  static constexpr int kThreads = 64, kBK = 32;
};
template <>
struct Plan<64> {
  static constexpr int kThreads = 128, kBK = 64;
};
template <>
struct Plan<128> {
  static constexpr int kThreads = 256, kBK = 64;
};
template <>
struct Plan<256> {
  static constexpr int kThreads = 256, kBK = 32;
};

template <int D>
struct Tile {
  static constexpr int NT = Plan<D>::kThreads;
  static constexpr int BK = Plan<D>::kBK;
  static constexpr int TX = D / 8;        // column groups
  static constexpr int TY = NT / TX;      // row groups of 8 q rows
  static constexpr int BQ = 8 * TY;       // q rows a block
  static constexpr int NS = BK / TX;      // keys a thread in Q.K^T
  static constexpr int LDK = D + 4;       // K copy row, padded: see stage
  static constexpr int kQt = D * BQ;      // Q^T: D x BQ
  static constexpr int kKs = BK * LDK;    // K as copied: BK x LDK
  static constexpr int kKt = D * BK;      // K^T: D x BK
  static constexpr int kVs = BK * D;
  static constexpr int kPt = BK * BQ;     // P^T: BK x BQ, swizzled chunks
  static constexpr size_t kSmem =
      sizeof(float) * (kQt + kKs + kKt + kVs + kPt);
  static_assert(NT % TX == 0 && BK % TX == 0 && BQ % 32 == 0 &&
                    (NS == 1 || NS == 4 || NS == 8),
                "the plan must tile the block and P^T's swizzle groups");
  static_assert((BK * D / 4) % NT == 0 && (BQ * D / 4) % NT == 0,
                "copies must divide among the threads");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the MUFU's ex2 (within about 2 ulp; subnormal results flushed
// to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lane(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Rows [r0, r0 + R) of one head of k or v into dst (row pitch ld floats),
// zero past S and, with kPart, past column d: 16-byte copies (vec: d, the
// bases and the strides on 4 floats), else 4-byte ones, each element masked.
template <int D, int R, int NT, bool kPart>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long stride, int r0, int S, int d,
                                      bool vec, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int n = 0; n < R * C4 / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / C4, c = 4 * (i % C4), pos = r0 + r;
    const bool in = pos < S && (!kPart || c < d);
    const float* s = src + (in ? pos : S - 1) * stride + (in || !kPart ? c : 0);
    float* dp = dst + r * ld + c;
    if (vec) {
      cp_async16(dp, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ie = in && (!kPart || c + e < d);
        cp_async4(dp + e, s + (ie ? e : 0), ie ? 4 : 0);
      }
    }
  }
}

// Q^T of q rows [q0, q0 + BQ) of one head, scaled, zero past S and, with
// kPart, past column d: consecutive threads take consecutive rows, so the
// transposed stores are conflict-free.
template <int D, bool kPart>
__device__ __forceinline__ void load_qt(float* Qt, const float* qb,
                                        long long qs, int q0, int S, int d,
                                        float scale, bool vec, int tid) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, NT = T::NT;
#pragma unroll
  for (int n = 0; n < BQ * D / 4 / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i % BQ, c = 4 * (i / BQ), pos = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S && (!kPart || c < d)) {
      const float* p = qb + pos * qs + c;
      x = vec ? *reinterpret_cast<const float4*>(p)
              : make_float4(p[0], !kPart || c + 1 < d ? p[1] : 0.f,
                            !kPart || c + 2 < d ? p[2] : 0.f,
                            !kPart || c + 3 < d ? p[3] : 0.f);
    }
    Qt[(c + 0) * BQ + r] = x.x * scale;
    Qt[(c + 1) * BQ + r] = x.y * scale;
    Qt[(c + 2) * BQ + r] = x.z * scale;
    Qt[(c + 3) * BQ + r] = x.w * scale;
  }
}

// K^T from the K copy: consecutive threads take consecutive keys, so the
// transposed stores are conflict-free.
template <int D>
__device__ __forceinline__ void transpose_k(const float* Ks, float* Kt,
                                            int tid) {
  using T = Tile<D>;
  constexpr int BK = T::BK, NT = T::NT;
#pragma unroll
  for (int n = 0; n < BK * D / 4 / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i % BK, c = 4 * (i / BK);
    const float4 x = *reinterpret_cast<const float4*>(Ks + r * T::LDK + c);
    Kt[(c + 0) * BK + r] = x.x;
    Kt[(c + 1) * BK + r] = x.y;
    Kt[(c + 2) * BK + r] = x.z;
    Kt[(c + 3) * BK + r] = x.w;
  }
}

// The thread's output rows, divided by their denominators: columns 4 tx ..
// and D/2 + 4 tx .. of orow's rows, those below d with kPart.
template <int D, bool kPart>
__device__ __forceinline__ void store_out(float* orow0, long long os,
                                          int q0, int row0, int S, int d,
                                          int tx, bool vec,
                                          const float (&acc)[8][8],
                                          const float (&l_run)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pos = q0 + row0 + i;
    if (pos >= S) continue;
    const float l = l_run[i];
    float* orow = orow0 + pos * os + 4 * tx;
    const float4 lo = make_float4(acc[i][0] / l, acc[i][1] / l,
                                  acc[i][2] / l, acc[i][3] / l);
    const float4 hi = make_float4(acc[i][4] / l, acc[i][5] / l,
                                  acc[i][6] / l, acc[i][7] / l);
    if (vec) {  // d % 4 == 0: each group of 4 all below d or all past it
      if (!kPart || 4 * tx < d) *reinterpret_cast<float4*>(orow) = lo;
      if (!kPart || D / 2 + 4 * tx < d)
        *reinterpret_cast<float4*>(orow + D / 2) = hi;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!kPart || 4 * tx + c < d) orow[c] = lane(lo, c);
        if (!kPart || D / 2 + 4 * tx + c < d) orow[D / 2 + c] = lane(hi, c);
      }
    }
  }
}

// S = Q.K^T (S += with kAdd, the slab loop's slabs) for the thread's 8
// q rows (row0 ..) and NS keys (4 tx + e + g BK/2: NS/4 chunks of 4; key
// tx when NS = 1), each summed over the tile's D dims in order from 0
// (with kCols over its first n, a multiple of 8: a cluster block's
// slab).  Both operands come from transposed tiles, so each dim is
// two 16-byte loads of Q^T and NS/4 of K^T (one 4-byte load when NS = 1)
// for 8 NS FMAs.
template <int D, bool kAdd = false, bool kCols = false>
__device__ __forceinline__ void scores(const float* Qt, const float* Kt,
                                       int row0, int tx,
                                       float (&s)[8][Tile<D>::NS],
                                       int n = D) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, NS = T::NS;
  if constexpr (!kAdd) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
  }
  const float* qp = Qt + row0;
  const float* kp = Kt + 4 * tx;
#pragma unroll 8
  for (int c = 0; c < (kCols ? n : D); ++c) {
    const float4 qa = *reinterpret_cast<const float4*>(qp + c * BQ);
    const float4 qz = *reinterpret_cast<const float4*>(qp + c * BQ + 4);
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qz.x, qz.y, qz.z, qz.w};
    float kv[NS];
    if constexpr (NS == 1) kv[0] = Kt[c * BK + tx];
#pragma unroll
    for (int g = 0; g < NS / 4; ++g) {
      const float4 kg =
          *reinterpret_cast<const float4*>(kp + c * BK + g * (BK / 2));
      kv[4 * g] = kg.x;
      kv[4 * g + 1] = kg.y;
      kv[4 * g + 2] = kg.z;
      kv[4 * g + 3] = kg.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// The key of the thread's score column j among the tile's: 4 tx + (j & 3)
// + (j / 4) BK/2, or tx when the thread has one key.
template <int D>
__device__ __forceinline__ int key_of(int tx, int j) {
  if constexpr (Tile<D>::NS == 1) return tx;
  return 4 * tx + (j & 3) + (j >> 2) * (Tile<D>::BK / 2);
}

// The online softmax of one tile: the scores become P in place, the running
// max and denominator move on, the output rows are rescaled.  A row's max
// and sum are taken over the thread's keys, then across the TX lanes that
// share the row.  Scores of keys past a row (pos_q < pos_k) are masked
// first when ``masked``.
template <int D>
__device__ __forceinline__ void softmax(float (&s)[8][Tile<D>::NS],
                                        float (&m_run)[8], float (&l_run)[8],
                                        float (&acc)[8][8], bool masked,
                                        int q_pos, int k0, int tx) {
  using T = Tile<D>;
  constexpr int TX = T::TX, NS = T::NS;
  if (masked) {  // k0: the position of the tile's first key
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (q_pos + i < k0 + key_of<D>(tx, j)) s[i][j] = kNegInf;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < NS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    // exp(x - m) as 2^(x log2 e - m log2 e): one FMA and one ex2
    const float m_new = fmaxf(m_run[i], mx);
    const float ml = m_new * kLog2e;
    const float alpha = exp2_approx(fmaf(m_run[i], kLog2e, -ml));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[i][j] = exp2_approx(fmaf(s[i][j], kLog2e, -ml));
      sum += s[i][j];
    }
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    l_run[i] = l_run[i] * alpha + sum;
    m_run[i] = m_new;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
  }
}

// P^T[key][row]: the thread's 8 rows of each of its keys as two 16-byte
// stores, chunk (row / 4) ^ ((key / 4) & 7) of the key's row, so the 8
// lanes of a row group, which hold keys 4 apart, store to distinct banks.
template <int D>
__device__ __forceinline__ void store_p(const float (&p)[8][Tile<D>::NS],
                                        float* Pt, int ty, int tx) {
  using T = Tile<D>;
#pragma unroll
  for (int j = 0; j < T::NS; ++j) {
    const int key = key_of<D>(tx, j), sw = (key >> 2) & 7;
    float* prow = Pt + key * T::BQ;
    *reinterpret_cast<float4*>(prow + 4 * ((2 * ty) ^ sw)) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    *reinterpret_cast<float4*>(prow + 4 * ((2 * ty + 1) ^ sw)) =
        make_float4(p[4][j], p[5][j], p[6][j], p[7][j]);
  }
}

// O += P.V for the thread's 8 rows and 8 columns (4 tx .., d/2 + 4 tx ..),
// keys in order from 0, 8 a step: keys j0 .. j0 + 3 have swizzle sw (even),
// the next four sw + 1, and the rows' second chunk sits 4 floats after the
// first (sw even) or before it (sw + 1, odd).
template <int D>
__device__ __forceinline__ void accumulate(const float* Pt, const float* Vs,
                                           int ty, int tx,
                                           float (&acc)[8][8]) {
  using T = Tile<D>;
  const float* vp = Vs + 4 * tx;
#pragma unroll 1
  for (int j0 = 0; j0 < T::BK; j0 += 8) {
    const int sw = (j0 >> 2) & 7;
    const int off[2] = {4 * ((2 * ty) ^ sw), 4 * ((2 * ty) ^ (sw + 1))};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
      const float* prow = Pt + j * T::BQ + off[jj >> 2];
      const float4 pa = *reinterpret_cast<const float4*>(prow);
      const float4 pz =
          *reinterpret_cast<const float4*>(prow + (jj < 4 ? 4 : -4));
      const float4 va = *reinterpret_cast<const float4*>(vp + j * D);
      const float4 vz = *reinterpret_cast<const float4*>(vp + j * D + D / 2);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pz.x, pz.y, pz.z, pz.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vz.x, vz.y, vz.z, vz.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
}

// kPart: the head dim d is below the width D, so the copies zero the
// columns past d and only d are stored (else d == D, and nothing tests it).
template <int D, bool kPart>
__global__ void __launch_bounds__(Tile<D>::NT)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int H, int G, int BH, int d, Strides st,
                           float scale, bool vec) {
  using T = Tile<D>;
  constexpr int NT = T::NT, BK = T::BK, TX = T::TX, BQ = T::BQ, NS = T::NS;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + T::kQt;
  float* Kt = Ks + T::kKs;
  float* Vs = Kt + T::kKt;
  float* Pt = Vs + T::kVs;

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, row0 = 8 * ty;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + kh * st.kh;
  const float* vb = v + b * st.vb + kh * st.vh;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;

  stage<D, BK, NT, kPart>(Ks, T::LDK, kb, st.ks, 0, S, d, vec, tid);
  cp_async_commit();
  load_qt<D, kPart>(Qt, qb, st.qs, q0, S, d, scale, vec, tid);

  float acc[8][8], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // K[kt] (and Q^T) in; P.V of kt - 1 done with Vs, Pt
    stage<D, BK, NT, kPart>(Vs, D, vb, st.vs, k0, S, d, vec, tid);
    cp_async_commit();
    transpose_k<D>(Ks, Kt, tid);
    __syncthreads();  // K^T in; the copy buffer free
    if (kt < kt_last) {
      stage<D, BK, NT, kPart>(Ks, T::LDK, kb, st.ks, k0 + BK, S, d, vec,
                              tid);
      cp_async_commit();
    }

    float s[8][NS];
    scores<D>(Qt, Kt, row0, tx, s);
    // only a tile reaching past the block's first row has keys to mask
    softmax<D>(s, m_run, l_run, acc, k0 + BK - 1 > q0, q0 + row0, k0, tx);
    store_p<D>(s, Pt, ty, tx);
    if (kt < kt_last)
      cp_async_wait<1>();  // V[kt] in; K[kt + 1] may still be in flight
    else
      cp_async_wait<0>();
    __syncthreads();  // P^T and V[kt] visible
    accumulate<D>(Pt, Vs, ty, tx, acc);
  }

  store_out<D, kPart>(o + b * st.ob + h * st.oh, st.os, q0, row0, S, d, tx,
                      vec, acc, l_run);
}

// A head dim past the portable cluster's 8 slabs of kWide = 256 (the route
// past d = 2048, whose clusters would need more than 8 blocks): a block a
// (q tile, batch * head, column chunk cc of 256 output columns), on the
// plan of width 256.  For each kv tile the scores are summed over all of d, in
// order from 0, slab by slab of 256 columns: Q^T's slab (scaled) and K's
// slab go to the tiles the narrow kernel keeps (Q^T once a block there,
// here once a slab a kv tile), then Q.K^T adds the slab's dims.  V's chunk
// cc lands with the first slab's K.  So a block recomputes the whole S for
// its chunk: ceil(d / 256) times Q.K^T's work of one pass over d, and the
// copies take no overlap with the products (two barriers a slab).  The
// softmax, P^T and P.V are the narrow kernel's.
constexpr int kWide = 256;

__global__ void __launch_bounds__(Tile<kWide>::NT)
    flash_attention_slab_loop_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int S, int H, int G,
                                int BH, int d, int n_cc, Strides st,
                                float scale, bool vec) {
  constexpr int D = kWide;
  using T = Tile<D>;
  constexpr int NT = T::NT, BK = T::BK, TX = T::TX, BQ = T::BQ, NS = T::NS;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + T::kQt;
  float* Kt = Ks + T::kKs;
  float* Vs = Kt + T::kKt;
  float* Pt = Vs + T::kVs;

  const int nq = (S + BQ - 1) / BQ;
  const long long per_tile = static_cast<long long>(BH) * n_cc;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / per_tile);
  const int rem = static_cast<int>(blockIdx.x % per_tile);
  const int bh = rem / n_cc, cc = rem % n_cc;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, row0 = 8 * ty;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + kh * st.kh;
  const float* vb = v + b * st.vb + kh * st.vh + cc * D;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  const int dv = min(D, d - cc * D);  // chunk cc's columns

  float acc[8][8], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    float s[8][NS];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
    for (int j = 0; j < n_cc; ++j) {
      const int dj = min(D, d - j * D);  // slab j's columns
      __syncthreads();  // Q.K^T of the last slab (and P.V) done with the tiles
      stage<D, BK, NT, true>(Ks, T::LDK, kb + j * D, st.ks, k0, S, dj, vec,
                             tid);
      if (j == 0) stage<D, BK, NT, true>(Vs, D, vb, st.vs, k0, S, dv, vec, tid);
      cp_async_commit();
      load_qt<D, true>(Qt, qb + j * D, st.qs, q0, S, dj, scale, vec, tid);
      cp_async_wait<0>();
      __syncthreads();  // K's slab (and V) in, Q^T's slab written
      transpose_k<D>(Ks, Kt, tid);
      __syncthreads();  // K^T in
      scores<D, true>(Qt, Kt, row0, tx, s);
    }
    softmax<D>(s, m_run, l_run, acc, k0 + BK - 1 > q0, q0 + row0, k0, tx);
    store_p<D>(s, Pt, ty, tx);
    __syncthreads();  // P^T visible
    accumulate<D>(Pt, Vs, ty, tx, acc);
  }

  store_out<D, true>(o + b * st.ob + h * st.oh + cc * D, st.os, q0, row0, S,
                     dv, tx, vec, acc, l_run);
}

// A head dim past 256 on a thread-block cluster (flash_attention_wide
// _kernel): C = ceil(d / D) blocks a (q tile, batch * head), block r the
// slab of columns [r D, r D + D) of q, k, v and o at width D (128 or 256,
// the plan's choice), on Tile<D>'s plan.  Per kv tile each block sums its
// slab's partial S (over the slab's real columns, rounded up to 8), writes
// it to X in its shared memory, and after a cluster barrier reads the C
// partials over distributed shared memory and adds them in slab order 0,
// 1, .., C - 1, so every block holds the same S bits; the softmax, P^T and
// P.V (of V's slab r into output columns r D ..) are the narrow kernel's.
// A second barrier phase (arrived after the reads, waited on before the
// next tile's write) keeps X single-buffered.  Q.K^T runs once over d in
// all, and each block copies 1/C of K and V, double-buffered as in the
// narrow kernel.  The plan's width is 128 where its slabs pad d less than
// 256's do (d = 264-384: 3 blocks of 128 against 2 of 256), so a block's
// work is a narrow kernel's of that width, plus C reads of a BQ x BK tile
// over distributed shared memory a kv tile; at width 128 Tile<128> and X
// take 225 KB, one block an SM, and neither instance keeps a stack frame
// (cuobjdump -res-usage of the sm_90a build: 235 and 222 registers).
template <int D>
struct Cluster {
  using T = Tile<D>;
  static constexpr int kX = T::BQ * T::BK;  // X: a block's partial S
  static constexpr size_t kSmem = T::kSmem + sizeof(float) * kX;
};
constexpr int kMaxCluster = 8;  // the portable cluster: d up to 8 D

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared-memory address a (this block's) in block r of the
// cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, unsigned r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(r));
  return out;
}

__device__ __forceinline__ float ld_cluster(unsigned a) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(a)
               : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_cluster4(unsigned a) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}

// The offset in X (row-major, BQ x BK) of the thread's score chunk g of
// row i: 4 keys a chunk (one when NS = 1), as key_of numbers them.
template <int D>
__device__ __forceinline__ int x_offset(int row0, int tx, int i, int g) {
  using T = Tile<D>;
  return (row0 + i) * T::BK +
         (T::NS == 1 ? tx : 4 * tx + g * (T::BK / 2));
}

// s = the sum of the cluster's C partials of the thread's scores, in rank
// order, read from each block's X (this block's own too).
template <int D>
__device__ __forceinline__ void gather_scores(float (&s)[8][Tile<D>::NS],
                                              const float* X, int row0,
                                              int tx, int C) {
  using T = Tile<D>;
  constexpr int NS = T::NS;
  const unsigned x0 = smem_addr(X);
#pragma unroll 1
  for (int r = 0; r < C; ++r) {
    const unsigned xr = cluster_addr(x0, static_cast<unsigned>(r));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (NS == 1) {
        const float p = ld_cluster(xr + 4 * x_offset<D>(row0, tx, i, 0));
        s[i][0] = r == 0 ? p : s[i][0] + p;
      } else {
#pragma unroll
        for (int g = 0; g < NS / 4; ++g) {
          const float4 p =
              ld_cluster4(xr + 4 * x_offset<D>(row0, tx, i, g));
          s[i][4 * g] = r == 0 ? p.x : s[i][4 * g] + p.x;
          s[i][4 * g + 1] = r == 0 ? p.y : s[i][4 * g + 1] + p.y;
          s[i][4 * g + 2] = r == 0 ? p.z : s[i][4 * g + 2] + p.z;
          s[i][4 * g + 3] = r == 0 ? p.w : s[i][4 * g + 3] + p.w;
        }
      }
    }
  }
}

// The thread's partial scores into X, at the offsets gather_scores reads.
template <int D>
__device__ __forceinline__ void put_scores(const float (&s)[8][Tile<D>::NS],
                                           float* X, int row0, int tx) {
  using T = Tile<D>;
  constexpr int NS = T::NS;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (NS == 1) {
      X[x_offset<D>(row0, tx, i, 0)] = s[i][0];
    } else {
#pragma unroll
      for (int g = 0; g < NS / 4; ++g)
        *reinterpret_cast<float4*>(X + x_offset<D>(row0, tx, i, g)) =
            make_float4(s[i][4 * g], s[i][4 * g + 1], s[i][4 * g + 2],
                        s[i][4 * g + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::NT)
    flash_attention_wide_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   float* __restrict__ o, int S, int H,
                                   int G, int BH, int d, int C, Strides st,
                                   float scale, bool vec) {
  using T = Tile<D>;
  constexpr int NT = T::NT, BK = T::BK, TX = T::TX, BQ = T::BQ, NS = T::NS;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + T::kQt;
  float* Kt = Ks + T::kKs;
  float* Vs = Kt + T::kKt;
  float* Pt = Vs + T::kVs;
  float* X = Pt + T::kPt;

  const int nq = (S + BQ - 1) / BQ;
  const int item = static_cast<int>(blockIdx.x / C);  // the cluster's
  const int qi = nq - 1 - item / BH;
  const int bh = item % BH;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int col0 = static_cast<int>(cluster_rank()) * D;
  const int dr = min(D, d - col0);     // the slab's columns
  const int n8 = (dr + 7) & ~7;        // summed in Q.K^T (zeros past dr)
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, row0 = 8 * ty;
  const float* qb = q + b * st.qb + h * st.qh + col0;
  const float* kb = k + b * st.kb + kh * st.kh + col0;
  const float* vb = v + b * st.vb + kh * st.vh + col0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;

  stage<D, BK, NT, true>(Ks, T::LDK, kb, st.ks, 0, S, dr, vec, tid);
  cp_async_commit();
  load_qt<D, true>(Qt, qb, st.qs, q0, S, dr, scale, vec, tid);

  float acc[8][8], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // K[kt] (and Q^T) in; P.V of kt - 1 done with Vs, Pt
    stage<D, BK, NT, true>(Vs, D, vb, st.vs, k0, S, dr, vec, tid);
    cp_async_commit();
    transpose_k<D>(Ks, Kt, tid);
    __syncthreads();  // K^T in; the copy buffer free
    if (kt < kt_last) {
      stage<D, BK, NT, true>(Ks, T::LDK, kb, st.ks, k0 + BK, S, dr, vec,
                             tid);
      cp_async_commit();
    }

    float s[8][NS];
    scores<D, false, true>(Qt, Kt, row0, tx, s, n8);
    if (kt > 0) cluster_wait();  // every block has read X's last partials
    put_scores<D>(s, X, row0, tx);
    cluster_arrive();
    cluster_wait();  // the cluster's partials in
    gather_scores<D>(s, X, row0, tx, C);
    cluster_arrive();  // done reading the cluster's X
    // only a tile reaching past the block's first row has keys to mask
    softmax<D>(s, m_run, l_run, acc, k0 + BK - 1 > q0, q0 + row0, k0, tx);
    store_p<D>(s, Pt, ty, tx);
    if (kt < kt_last)
      cp_async_wait<1>();  // V[kt] in; K[kt + 1] may still be in flight
    else
      cp_async_wait<0>();
    __syncthreads();  // P^T and V[kt] visible
    accumulate<D>(Pt, Vs, ty, tx, acc);
  }
  cluster_wait();  // no block of the cluster reads this one's X any more

  store_out<D, true>(o + b * st.ob + h * st.oh + col0, st.os, q0, row0, S,
                     dr, tx, vec, acc, l_run);
}

template <int D, bool kPart>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, int d, const Strides& st,
                   float scale, int q_rows, int kv_rows, int threads,
                   int smem_bytes, bool vec, cudaStream_t stream) {
  using T = Tile<D>;
  if (q_rows != T::BQ || kv_rows != T::BK || threads != T::NT ||
      smem_bytes != static_cast<int>(T::kSmem))
    return cudaErrorInvalidValue;  // kernel.py's plan and this build differ
  const long long BH = static_cast<long long>(B) * H;
  const long long blocks = BH * ((S + T::BQ - 1) / T::BQ);
  if (BH > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int smem = static_cast<int>(T::kSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, kPart>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_kernel<D, kPart>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<D, kPart><<<static_cast<unsigned>(blocks), T::NT,
                                     smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / K,
      static_cast<int>(BH), d, st, scale, vec);
  return cudaGetLastError();
}

// Width D, its d == D kernel or the one for a d below it.
template <int D>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int K, int d, const Strides& st,
                         float scale, int q_rows, int kv_rows, int threads,
                         int smem_bytes, bool vec, cudaStream_t stream) {
  return d == D ? launch<D, false>(q, k, v, o, B, S, H, K, d, st, scale,
                                   q_rows, kv_rows, threads, smem_bytes, vec,
                                   stream)
                : launch<D, true>(q, k, v, o, B, S, H, K, d, st, scale,
                                  q_rows, kv_rows, threads, smem_bytes, vec,
                                  stream);
}

// A d past 8 slabs of kWide: ceil(d / 256) column chunks on width 256's
// plan.
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int d, const Strides& st,
                        float scale, int q_rows, int kv_rows, int threads,
                        int smem_bytes, bool vec, cudaStream_t stream) {
  using T = Tile<kWide>;
  if (q_rows != T::BQ || kv_rows != T::BK || threads != T::NT ||
      smem_bytes != static_cast<int>(T::kSmem))
    return cudaErrorInvalidValue;  // kernel.py's plan and this build differ
  const int n_cc = (d + kWide - 1) / kWide;
  const long long BH = static_cast<long long>(B) * H;
  const long long blocks = BH * n_cc * ((S + T::BQ - 1) / T::BQ);
  if (BH > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int smem = static_cast<int>(T::kSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_slab_loop_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_slab_loop_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_attention_slab_loop_kernel<<<static_cast<unsigned>(blocks), T::NT,
                                     smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / K,
      static_cast<int>(BH), d, n_cc, st, scale, vec);
  return cudaGetLastError();
}

// A d past kWide on a cluster of C = ceil(d / D) blocks of width D.
template <int D>
cudaError_t launch_cluster(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int K, int d,
                           const Strides& st, float scale, int q_rows,
                           int kv_rows, int threads, int smem_bytes, int C,
                           bool vec, cudaStream_t stream) {
  using T = Tile<D>;
  constexpr int smem = static_cast<int>(Cluster<D>::kSmem);
  if (q_rows != T::BQ || kv_rows != T::BK || threads != T::NT ||
      smem_bytes != smem || C != (d + D - 1) / D || C < 2 || C > kMaxCluster)
    return cudaErrorInvalidValue;  // kernel.py's plan and this build differ
  const long long BH = static_cast<long long>(B) * H;
  const long long blocks = BH * C * ((S + T::BQ - 1) / T::BQ);
  if (BH > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_wide_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, flash_attention_wide_kernel<D>, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, H / K, static_cast<int>(BH), d, C, st,
      scale, vec);
}

}  // namespace

// q, k, v and o f32; strides: 12 element strides (batch, sequence, head) of
// q, k, v, o; the head dim is contiguous.  d: any head dim from 1, run at
// the next compiled width; past 256 on a cluster of `cluster` blocks of
// `width` (128 or 256) columns each, or, where cluster is 1 (past 8 slabs
// of 256), in column chunks of 256 by the slab loop.  q_rows, kv_rows,
// threads, smem_bytes, width and cluster: kernel.py's f32_plan for d,
// refused unless they are this build's.
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int K, int d, const long long* strides, float scale, int q_rows,
    int kv_rows, int threads, int smem_bytes, int width, int cluster,
    cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || d < 1)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  // 16-byte copies and stores need every base and row stride on 16 bytes,
  // and a head dim of whole 16-byte groups
  bool vec = d % 4 == 0;
  const void* bases[4] = {q, k, v, o};
  for (const void* p : bases)
    vec = vec && reinterpret_cast<unsigned long long>(p) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 4 == 0;
  if (d > kWide) {
    if (cluster == 1 && width == kWide)
      return launch_wide(q, k, v, o, B, S, H, K, d, st, scale, q_rows,
                         kv_rows, threads, smem_bytes, vec, stream);
    if (width == 128)
      return launch_cluster<128>(q, k, v, o, B, S, H, K, d, st, scale,
                                 q_rows, kv_rows, threads, smem_bytes,
                                 cluster, vec, stream);
    if (width == kWide)
      return launch_cluster<kWide>(q, k, v, o, B, S, H, K, d, st, scale,
                                   q_rows, kv_rows, threads, smem_bytes,
                                   cluster, vec, stream);
    return cudaErrorInvalidValue;
  }
  const int w = d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
  if (width != w || cluster != 1) return cudaErrorInvalidValue;
  switch (w) {
    case 32:
      return launch_width<32>(q, k, v, o, B, S, H, K, d, st, scale, q_rows,
                              kv_rows, threads, smem_bytes, vec, stream);
    case 64:
      return launch_width<64>(q, k, v, o, B, S, H, K, d, st, scale, q_rows,
                              kv_rows, threads, smem_bytes, vec, stream);
    case 128:
      return launch_width<128>(q, k, v, o, B, S, H, K, d, st, scale, q_rows,
                               kv_rows, threads, smem_bytes, vec, stream);
    default:
      return launch_width<256>(q, k, v, o, B, S, H, K, d, st, scale, q_rows,
                               kv_rows, threads, smem_bytes, vec, stream);
  }
}
