// Causal GQA flash attention for bf16 inputs on Hopper's tensor cores
// (sm_90a: TMA loads, wgmma products).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, pallas_call at :92) for bf16 q, k and v; f32 inputs
// take the SIMT kernel of flash_attention.cu, and the Python wrapper
// (repro_torch/kernels/flash_attention/kernel.py) dispatches between the two
// on dtype.  It computes what the Pallas kernel computes: q (B,S,H,d)
// against k, v (B,S,K,d), head h reading kv head h / (H/K), scores scaled
// by 1/sqrt(d), running max, denominator and accumulator in f32 (online
// softmax, masked scores at -1e30), kv tiles past the diagonal skipped,
// out = acc / l in bf16.  Any S, any B * H; any d that is a multiple of 8
// (the wrapper stages q, k and v into zero-padded copies of head dim
// 8 ceil(d / 8) where d is not, or where a base or stride breaks TMA's
// 16-byte rule), run at the compiled width above it (32, 64, 128 or 256)
// up to 256 and, past 256, in column chunks of 256 by
// flash_attention_bf16_wide_kernel (ceil(d / 256) times Q.K^T's work).
//
// Bound on this card: the causal FLOPs 4*B*H*d*S(S+1)/2 at the bf16
// tensor-core peak (989 TFLOP/s on an H100 SXM: 0.028 ms at
// (8, 1491, 12, 64)), above the bytes of q, k, v and o read or written
// once (0.022 ms).  The SIMT kernel ran every product as an f32 FMA from
// shared memory, 51x that bound; this one puts both products on the
// tensor cores and takes the loads off the threads.
//
// Design.  One CTA per (64-row q tile, batch * head), on a one-dimensional
// grid with every head's longest q tile first (so any B * H runs: the grid
// takes q tiles x B * H < 2^31 blocks).  A CTA is one warpgroup (128
// threads), two at width 256.  Thread 0 loads the q tile once and each
// 64-row k and v tile by TMA (a 4-D tensor map over (d, heads, S, B) built
// on the host from the tensors' own strides, so q, k and v are read in
// place; TMA's zero fill covers rows past S and, for a d below the
// compiled width, the columns past d, whose products then add exact zeros)
// into a two-stage ring, with an mbarrier a stage: tile kt + 2 is
// requested as soon as tile kt is consumed.  Rows are stored 128B-swizzled
// (64B at width 32) in slabs of 64 columns, the layout wgmma's descriptors
// read; width 128 spans two slabs, 256 four (161 KB of shared memory at two
// stages).  At width 256 a 64 x 256 f32 accumulator would take 128
// registers a thread before S and P, so each of the two warpgroups computes
// the whole S (the same wgmmas on the same tiles, so the same bits and the
// same softmax statistics) and keeps the P.V accumulator of two of the
// four slabs.  Only the d real output columns are stored.
//   S = Q.K^T is a wgmma m64n64k16 chain (A and B both from shared memory,
//   K-major), f32 accumulate: bf16 products are exact in f32, so only the
//   order of the sums differs from the SIMT kernel.  The 1/sqrt(d) scale
//   (times log2 e, for exp2) is applied to the f32 scores, not to bf16 q:
//   1/sqrt(128) is not a power of two.
//   The softmax statistics stay in registers in the accumulator's fragment
//   layout: a thread holds rows r and r + 8 of its warp's 16, four lanes a
//   row, so a row's max and sum take two shuffles.  Only the diagonal tile
//   is masked, per element.
//   O += P.V is a wgmma with P from registers (the accumulator's fragment
//   of S is the register fragment of A, so P never goes to shared memory)
//   and V from shared memory, N-major through the transpose bit.  P keeps
//   its f32 precision by a split: P_hi = bf16(P), P_lo = bf16(P - P_hi),
//   two wgmmas into the same f32 accumulator.  P_hi + P_lo carries 16 of
//   P's bits, so the product is exact to about 2**-17 relative, against the
//   2**-9 of one bf16 rounding, which is expected to turn bf16 outputs'
//   single-ulp disagreements into two-ulp ones.  It costs half again the
//   tensor FLOPs.
// Rows past S are never stored.  The kernel allocates nothing; the host
// side encodes the three tensor maps with libcuda's cuTensorMapEncodeTiled,
// found with dlsym in the libcuda PyTorch loaded.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBQ = 64;         // q rows per CTA
constexpr int kBK = 64;         // k/v rows per tile
constexpr int kWarpgroup = 128;
constexpr int kStages = 2;      // k/v tiles in flight
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

// Shared-memory geometry of a 64-row tile of head dim D: slabs of at most
// 64 bf16 columns, each row of a slab one swizzle span (128 B, or 64 B at
// D = 32), slabs one after another.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;    // columns a slab holds
  static constexpr int kSlabs = D / kCols;         // 1, 1, 2 or 4
  // warpgroups a CTA, and the output slabs each accumulates
  static constexpr int kGroups = D > 128 ? 2 : 1;
  static constexpr int kThreads = kWarpgroup * kGroups;
  static constexpr int kGroupSlabs = kSlabs / kGroups;
  static constexpr int kRowBytes = 2 * kCols;      // the swizzle span
  static constexpr int kSlabBytes = kBK * kRowBytes;
  static constexpr int kBytes = kSlabs * kSlabBytes;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: one atom
  static constexpr uint64_t kLayout = D < 64 ? 2 : 1;   // B64 or B128
};

template <int D>
constexpr int smem_bytes() {  // + 1024 to align the tiles, + barriers
  return 1024 + (1 + 2 * kStages) * Tile<D>::kBytes + 8 * (1 + kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (d, heads, S, B) into shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle.  K-major operands (q, k) step
// from one 8-row atom to the next by SBO and take LBO as 1 (unused: a k16
// step stays inside a swizzle span).  The N-major v steps along K from atom
// to atom by SBO; its N fits in one atom, so LBO (the step between atoms
// along N) is never taken and is given the same value.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching a register a wgmma still reads or
// writes before the wait that completes it.
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// D (64 x 64, f32) {=, +=} A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem,
// N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, smem,
// N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int S, int H,
                                int G, int BH, int d, long long ob,
                                long long os, long long oh,
                                float scale_log2) {
  using T = Tile<D>;
  constexpr int kGS = T::kGroupSlabs;
  constexpr int kN = T::kCols;          // N of a P.V wgmma: one slab
  constexpr int kOR = kN / 2;           // its f32 registers a thread
  constexpr int kKSlab = T::kCols / 16; // k16 steps of Q.K^T in a slab
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kBytes;             // kStages k tiles
  const uint32_t sv = sk + kStages * T::kBytes;   // kStages v tiles
  const uint32_t q_bar = sv + kStages * T::kBytes;
  const uint32_t kv_bar = q_bar + 8;               // one a stage

  const int nq = (S + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qi * kBQ;
  const int n_kv = qi + 1;  // kv tiles up to the diagonal
  const int tid = threadIdx.x;

  // slabs holding a column below d: only these are loaded; the others (at
  // width 256, d <= 192) are zeroed once here, and no copy ever lands there
  const int n_slabs = (d + T::kCols - 1) / T::kCols;
  auto load_kv = [&](int kt, int stage) {
    const uint32_t bar = kv_bar + 8 * stage;
    mbar_expect_tx(bar, 2 * n_slabs * T::kSlabBytes);
#pragma unroll
    for (int s = 0; s < T::kSlabs; ++s) {
      if (s >= n_slabs) break;
      const uint32_t off = stage * T::kBytes + s * T::kSlabBytes;
      tma_load(sk + off, &tk, s * T::kCols, kh, kt * kBK, b, bar);
      tma_load(sv + off, &tv, s * T::kCols, kh, kt * kBK, b, bar);
    }
  };
  if (n_slabs < T::kSlabs) {  // q, then each stage of k and of v
    const int words = (T::kSlabs - n_slabs) * T::kSlabBytes / 16;
    for (int i = tid; i < (1 + 2 * kStages) * words; i += T::kThreads) {
      const uint32_t addr = sq + (i / words) * T::kBytes +
                            n_slabs * T::kSlabBytes + (i % words) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
                   "r"(0u)
                   : "memory");
    }
    // the zeros must be seen by wgmma, which reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(kv_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, n_slabs * T::kSlabBytes);
#pragma unroll
    for (int s = 0; s < T::kSlabs; ++s) {
      if (s >= n_slabs) break;
      tma_load(sq + s * T::kSlabBytes, &tq, s * T::kCols, h, q0, b, q_bar);
    }
    for (int kt = 0; kt < kStages && kt < n_kv; ++kt) load_kv(kt, kt);
  }

  // this thread's rows r0 and r0 + 8, columns 8j + c0 + {0, 1} of its
  // warpgroup's output slabs s0 ..
  const int warp = (T::kGroups > 1 ? tid % kWarpgroup : tid) / 32;
  const int lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int s0 = T::kGroups > 1 ? (tid / kWarpgroup) * kGS : 0;
  float acc[kGS][kOR];
#pragma unroll
  for (int n = 0; n < kGS; ++n)
#pragma unroll
    for (int i = 0; i < kOR; ++i) acc[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int stage = kt % kStages;
    mbar_wait(kv_bar + 8 * stage, (kt / kStages) & 1);
    const uint32_t k_tile = sk + stage * T::kBytes;
    const uint32_t v_tile = sv + stage * T::kBytes;

    // S = Q.K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off =
          (kk / kKSlab) * T::kSlabBytes + (kk % kKSlab) * 32;
      wgmma_ss_n64(s, smem_desc(sq + off, 16, T::kAtomBytes, T::kLayout),
                   smem_desc(k_tile + off, 16, T::kAtomBytes, T::kLayout),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(s[i]);

    // online softmax in the log2 domain; s[4j + e] is row r0 + 8 (e >> 1),
    // column 8j + c0 + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
    const bool diagonal = kt == qi;  // there k0 == q0
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + c0 + (i & 1);
      const float x = diagonal && col > row ? kNegInf : s[i] * scale_log2;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // P as bf16 pairs, hi and lo: pair 4kk + {0, 1, 2, 3} is the register
    // fragment of A for kv columns 16kk..16kk + 15
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i & 1;
      const float p0 = exp2f(s[2 * i] - m_run[r]);
      const float p1 = exp2f(s[2 * i + 1] - m_run[r]);
      l_run[r] += p0 + p1;
      p_hi[i] = bf16x2(p0, p1);
      p_lo[i] = bf16x2(p0 - bf16_lo(p_hi[i]), p1 - bf16_hi(p_hi[i]));
    }
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int i = 0; i < kOR; ++i) acc[n][i] *= alpha[(i >> 1) & 1];

    // O += P_hi.V + P_lo.V
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(
            v_tile + (s0 + n) * T::kSlabBytes + kk * 2 * T::kAtomBytes,
            T::kAtomBytes, T::kAtomBytes, T::kLayout);
        if constexpr (kN == 64) {
          wgmma_rs_n64(acc[n], p_hi + 4 * kk, dv);
          wgmma_rs_n64(acc[n], p_lo + 4 * kk, dv);
        } else {
          wgmma_rs_n32(acc[n], p_hi + 4 * kk, dv);
          wgmma_rs_n32(acc[n], p_lo + 4 * kk, dv);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int i = 0; i < kOR; ++i) fence_reg(acc[n][i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_reg(p_hi[i]);
      fence_reg(p_lo[i]);
    }

    __syncthreads();  // every warp is done with this stage's k and v
    if (tid == 0 && kt + kStages < n_kv) load_kv(kt + kStages, stage);
  }

  // out = acc / l, rows below S and columns below d only (d % 8 == 0, so
  // a thread's column pair is both in or both out)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + r0 + 8 * r;
    if (pos >= S) continue;
    __nv_bfloat16* orow = o + b * ob + pos * os + h * oh;
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = (s0 + n) * kN + 8 * j + c0;
        if (col < d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              bf16x2(acc[n][4 * j + 2 * r] / l_run[r],
                     acc[n][4 * j + 2 * r + 1] / l_run[r]);
      }
  }
}

// A head dim past 256 (kWide): a CTA a (64-row q tile, batch * head,
// column chunk cc of 256 output columns), on width 256's tiles and its two
// warpgroups.  For each kv tile, S = Q.K^T runs over all of d in slabs of
// 256 columns: the slab's q and k boxes (its 64-column pieces that hold a
// column below d) land on one mbarrier, both warpgroups chain its wgmmas
// into the same S, and the next slab (or the next kv tile's first) is
// requested once every warp is done with this one.  V's chunk cc has an
// mbarrier of its own and is requested as soon as P.V of the tile before
// is done.  q is loaded again for every slab of every kv tile (from L2), and
// every chunk recomputes S: ceil(d / 256) times the Q.K^T work of one pass
// over d.  The softmax and P.V are the narrow kernel's; pieces of V's
// chunk past d are zeroed once and never loaded.
constexpr int kWide = 256;

__global__ void __launch_bounds__(Tile<kWide>::kThreads)
    flash_attention_bf16_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     __nv_bfloat16* __restrict__ o, int S,
                                     int H, int G, int BH, int d, int n_cc,
                                     long long ob, long long os, long long oh,
                                     float scale_log2) {
  using T = Tile<kWide>;
  constexpr int kGS = T::kGroupSlabs;
  constexpr int kN = T::kCols;
  constexpr int kOR = kN / 2;
  constexpr int kKSlab = T::kCols / 16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kBytes;
  const uint32_t sv = sk + T::kBytes;
  const uint32_t qk_bar = sv + T::kBytes;
  const uint32_t v_bar = qk_bar + 8;

  const int nq = (S + kBQ - 1) / kBQ;
  const long long per_tile = static_cast<long long>(BH) * n_cc;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / per_tile);
  const int rem = static_cast<int>(blockIdx.x % per_tile);
  const int bh = rem / n_cc, cc = rem % n_cc;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = qi * kBQ;
  const int n_kv = qi + 1;
  const int tid = threadIdx.x;

  // 64-column pieces of slab j holding a column below d
  auto pieces = [&](int j) {
    const int n = (d - j * kWide + T::kCols - 1) / T::kCols;
    return n < T::kSlabs ? n : T::kSlabs;
  };
  const int n_v = pieces(cc);
  auto load_qk = [&](int kt, int j) {
    const int n = pieces(j);
    mbar_expect_tx(qk_bar, 2 * n * T::kSlabBytes);
    for (int s = 0; s < n; ++s) {
      const int c = j * kWide + s * T::kCols;
      tma_load(sq + s * T::kSlabBytes, &tq, c, h, q0, b, qk_bar);
      tma_load(sk + s * T::kSlabBytes, &tk, c, kh, kt * kBK, b, qk_bar);
    }
  };
  auto load_v = [&](int kt) {
    mbar_expect_tx(v_bar, n_v * T::kSlabBytes);
    for (int s = 0; s < n_v; ++s)
      tma_load(sv + s * T::kSlabBytes, &tv, cc * kWide + s * T::kCols, kh,
               kt * kBK, b, v_bar);
  };
  if (n_v < T::kSlabs) {
    const int words = (T::kSlabs - n_v) * T::kSlabBytes / 16;
    for (int i = tid; i < words; i += T::kThreads) {
      const uint32_t addr = sv + n_v * T::kSlabBytes + i * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
                   "r"(0u)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    mbar_init(qk_bar, 1);
    mbar_init(v_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_v(0);
    load_qk(0, 0);
  }

  const int warp = (tid % kWarpgroup) / 32;
  const int lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int s0 = (tid / kWarpgroup) * kGS;
  float acc[kGS][kOR];
#pragma unroll
  for (int n = 0; n < kGS; ++n)
#pragma unroll
    for (int i = 0; i < kOR; ++i) acc[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  uint32_t qk_phase = 0, v_phase = 0;

  for (int kt = 0; kt < n_kv; ++kt) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int j = 0; j < n_cc; ++j) {
      mbar_wait(qk_bar, qk_phase);
      qk_phase ^= 1u;
      const int n = pieces(j);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWide / 16; ++kk) {
        if (kk / kKSlab >= n) break;
        const uint32_t off =
            (kk / kKSlab) * T::kSlabBytes + (kk % kKSlab) * 32;
        wgmma_ss_n64(s, smem_desc(sq + off, 16, T::kAtomBytes, T::kLayout),
                     smem_desc(sk + off, 16, T::kAtomBytes, T::kLayout), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(s[i]);
      __syncthreads();  // every warp is done with this slab's q and k
      if (tid == 0) {
        if (j + 1 < n_cc)
          load_qk(kt, j + 1);
        else if (kt + 1 < n_kv)
          load_qk(kt + 1, 0);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
    const bool diagonal = kt == qi;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + c0 + (i & 1);
      const float x = diagonal && col > row ? kNegInf : s[i] * scale_log2;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i & 1;
      const float p0 = exp2f(s[2 * i] - m_run[r]);
      const float p1 = exp2f(s[2 * i + 1] - m_run[r]);
      l_run[r] += p0 + p1;
      p_hi[i] = bf16x2(p0, p1);
      p_lo[i] = bf16x2(p0 - bf16_lo(p_hi[i]), p1 - bf16_hi(p_hi[i]));
    }
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int i = 0; i < kOR; ++i) acc[n][i] *= alpha[(i >> 1) & 1];

    mbar_wait(v_bar, v_phase);
    v_phase ^= 1u;
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(
            sv + (s0 + n) * T::kSlabBytes + kk * 2 * T::kAtomBytes,
            T::kAtomBytes, T::kAtomBytes, T::kLayout);
        wgmma_rs_n64(acc[n], p_hi + 4 * kk, dv);
        wgmma_rs_n64(acc[n], p_lo + 4 * kk, dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int i = 0; i < kOR; ++i) fence_reg(acc[n][i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_reg(p_hi[i]);
      fence_reg(p_lo[i]);
    }
    __syncthreads();  // every warp is done with this tile's v
    if (tid == 0 && kt + 1 < n_kv) load_v(kt + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + r0 + 8 * r;
    if (pos >= S) continue;
    __nv_bfloat16* orow = o + b * ob + pos * os + h * oh + cc * kWide;
#pragma unroll
    for (int n = 0; n < kGS; ++n)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = (s0 + n) * kN + 8 * j + c0;
        if (cc * kWide + col < d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              bf16x2(acc[n][4 * j + 2 * r] / l_run[r],
                     acc[n][4 * j + 2 * r + 1] / l_run[r]);
      }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, from the libcuda already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D map of a (B, S, heads, d) bf16 tensor, innermost first, boxes of
// one slab of width D: 64 rows of one head, zero-filled past d.  Strides in
// elements.
template <int D>
bool encode(CUtensorMap* map, const void* base, int B, int S, int heads,
            int d, long long sb, long long ss, long long sh) {
  using T = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kCols), 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Strides {  // in elements: batch, sequence, head of q, k, v and o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, int d, const Strides& st,
                   float scale_log2, cudaStream_t stream) {
  const long long BH = static_cast<long long>(B) * H;
  const long long blocks = BH * ((S + kBQ - 1) / kBQ);
  if (BH > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, B, S, H, d, st.qb, st.qs, st.qh) ||
      !encode<D>(&tk, k, B, S, K, d, st.kb, st.ks, st.kh) ||
      !encode<D>(&tv, v, B, S, K, d, st.vb, st.vs, st.vh))
    return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<D>();
  // The shared-memory limit is raised once per device and head dim, not on
  // every call: one bit per device that has it.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((raised.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  flash_attention_bf16_kernel<D>
      <<<static_cast<unsigned>(blocks), Tile<D>::kThreads, bytes, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, H / K,
          static_cast<int>(BH), d, st.ob, st.os, st.oh, scale_log2);
  return cudaGetLastError();
}

// A d past kWide: ceil(d / 256) column chunks on width 256's tiles.
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int d, const Strides& st,
                        float scale_log2, cudaStream_t stream) {
  const int n_cc = (d + kWide - 1) / kWide;
  const long long BH = static_cast<long long>(B) * H;
  const long long blocks = BH * n_cc * ((S + kBQ - 1) / kBQ);
  if (BH > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode<kWide>(&tq, q, B, S, H, d, st.qb, st.qs, st.qh) ||
      !encode<kWide>(&tk, k, B, S, K, d, st.kb, st.ks, st.kh) ||
      !encode<kWide>(&tv, v, B, S, K, d, st.vb, st.vs, st.vh))
    return cudaErrorInvalidValue;
  constexpr int bytes = 1024 + 3 * Tile<kWide>::kBytes + 16;
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((raised.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(flash_attention_bf16_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  flash_attention_bf16_wide_kernel<<<static_cast<unsigned>(blocks),
                                     Tile<kWide>::kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, H / K,
      static_cast<int>(BH), d, n_cc, st.ob, st.os, st.oh, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and o bf16; strides: 12 element strides (batch, sequence, head)
// of q, k, v, o, the head dim contiguous.  The caller has checked that the
// bases and the q, k, v strides are multiples of 16 bytes (TMA's rule), and
// staged inputs that break it, or whose head dim is not a multiple of 8,
// into copies of head dim a multiple of 8 (scale stays 1/sqrt of the true
// head dim).  d: a multiple of 8 from 8, run at the next compiled width up
// to 256 and in column chunks of 256 past it.
extern "C" cudaError_t flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int K, int d, const long long* strides, float scale,
    cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || d < 8 || d % 8)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  if (d > kWide)
    return launch_wide(q, k, v, o, B, S, H, K, d, st, scale_log2, stream);
  if (d <= 32)
    return launch<32>(q, k, v, o, B, S, H, K, d, st, scale_log2, stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, B, S, H, K, d, st, scale_log2, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, B, S, H, K, d, st, scale_log2, stream);
  return launch<256>(q, k, v, o, B, S, H, K, d, st, scale_log2, stream);
}
