// Fused union + conflict screen + transitive deduce, one block per lane.
//
// Replaces: src/repro/kernels/union_deduce/kernel.py::union_deduce (Pallas,
// TPU), which the JAX round engine reaches from _screen_fused and
// _deduce_fused (src/repro/core/jax_graph.py).
//
// Per lane b, given a compressed union-find forest parent0 (n,) whose roots
// are the least id of their component, pairs u, v (P,), a POS-edge mask and
// a sorted, INT32_MAX-padded index of canonical neg keys lo * n + hi:
//   roots    = the forest after uniting every masked edge (each object points
//              at the least id of its component),
//   conflict = 1 iff some neg key's endpoints now share a root,
//   deduced  = POS if roots[u] == roots[v], NEG if the canonical root key of
//              (u, v) is a re-keyed neg key, else UNKNOWN.
//
// Design.  The forest lives in shared memory (n ints; n * n < 2^31 keeps
// n <= 46340, at most 185 KB).  The union hooks with shared-memory atomicMin
// and then jumps pointers until every object points at a root, repeating
// until a pass over the edges finds no edge left to hook.  Hooks run in
// parallel in no fixed order, so the schedule differs from the TPU kernel's
// fixed trip count, but the fixed point does not: every object ends at the
// least id of its component, so roots match the reference bit for bit.  A
// trip cap guards the loop; hitting it sets error[b] and the wrapper raises.
// Membership does not compare all P x P key pairs as the TPU kernel does:
// re-keyed neg keys go into a per-lane open-addressing hash set in global
// scratch (atomicCAS, load factor <= 1/2), and each pair probes it with its
// canonical root key.  A set does not depend on insertion order, so deduced
// matches the reference bit for bit too.
//
// Bound on an H100: bytes, about 4 * (2n + 5P) per lane (forest in and
// out, four P-long inputs, one P-long output), a few microseconds at
// 3.35 TB/s for the main path's lanes.  One block per lane leaves most of
// the 132 SMs idle at 4 lanes and each block serialises its trips behind
// __syncthreads; splitting a lane over a cluster of blocks is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kEmpty = -1;
constexpr int kSentinel = 0x7fffffff;
constexpr int kPos = 1;
constexpr int kNeg = 0;
constexpr int kUnknown = -1;

__device__ __forceinline__ unsigned int mix(unsigned int x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// Jump every pointer until each object points at a root.
__device__ void compress(int* p, int n, int* flag) {
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) *flag = 0;
    __syncthreads();
    for (int x = threadIdx.x; x < n; x += kThreads) {
      const int px = p[x];
      const int ppx = p[px];
      if (ppx != px) {
        p[x] = ppx;
        *flag = 1;
      }
    }
    __syncthreads();
    if (!*flag) return;
  }
}

__global__ void __launch_bounds__(kThreads)
union_deduce_kernel(const int* __restrict__ parent0, const int* __restrict__ u,
                    const int* __restrict__ v, const uint8_t* __restrict__ pos,
                    const int* __restrict__ neg_keys, int* __restrict__ roots,
                    int* __restrict__ deduced, int* __restrict__ conflict,
                    int* __restrict__ error, int* __restrict__ table, int n,
                    int P, int table_size, int max_trips) {
  extern __shared__ int p[];
  __shared__ int flag;
  __shared__ int conf;
  const int lane = blockIdx.x;
  parent0 += static_cast<size_t>(lane) * n;
  roots += static_cast<size_t>(lane) * n;
  u += static_cast<size_t>(lane) * P;
  v += static_cast<size_t>(lane) * P;
  pos += static_cast<size_t>(lane) * P;
  neg_keys += static_cast<size_t>(lane) * P;
  deduced += static_cast<size_t>(lane) * P;
  table += static_cast<size_t>(lane) * table_size;
  const unsigned int mask = static_cast<unsigned int>(table_size - 1);

  for (int x = threadIdx.x; x < n; x += kThreads) p[x] = parent0[x];
  for (int h = threadIdx.x; h < table_size; h += kThreads) table[h] = kEmpty;
  if (threadIdx.x == 0) conf = 0;

  // union: hook the larger root under the smaller, compress, repeat
  int trips = 0;
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) flag = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += kThreads) {
      if (!pos[i]) continue;
      const int ru = p[u[i]];
      const int rv = p[v[i]];
      if (ru != rv) {
        atomicMin(&p[max(ru, rv)], min(ru, rv));
        flag = 1;
      }
    }
    __syncthreads();
    const int hooked = flag;
    compress(p, n, &flag);
    if (!hooked) break;
    if (++trips >= max_trips) {
      if (threadIdx.x == 0) error[lane] = 1;
      break;
    }
  }
  __syncthreads();

  // re-key the neg index under the new forest into the hash set; a key whose
  // endpoints now share a root is the conflict signature
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int key = neg_keys[i];
    if (key == kSentinel) continue;
    const int rlo = p[key / n];
    const int rhi = p[key % n];
    if (rlo == rhi) {
      conf = 1;
      continue;
    }
    const int k2 = min(rlo, rhi) * n + max(rlo, rhi);
    unsigned int h = mix(static_cast<unsigned int>(k2)) & mask;
    for (;;) {
      const int prev = atomicCAS(&table[h], kEmpty, k2);
      if (prev == kEmpty || prev == k2) break;
      h = (h + 1) & mask;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int ru = p[u[i]];
    const int rv = p[v[i]];
    int out = kPos;
    if (ru != rv) {
      const int q = min(ru, rv) * n + max(ru, rv);
      unsigned int h = mix(static_cast<unsigned int>(q)) & mask;
      out = kUnknown;
      for (;;) {
        const int t = __ldcg(&table[h]);
        if (t == q) {
          out = kNeg;
          break;
        }
        if (t == kEmpty) break;
        h = (h + 1) & mask;
      }
    }
    deduced[i] = out;
  }
  for (int x = threadIdx.x; x < n; x += kThreads) roots[x] = p[x];
  if (threadIdx.x == 0) conflict[lane] = conf;
}

}  // namespace

// Plain C entry point: launches B blocks on `stream`, returns the status.
// The forest takes n * 4 bytes of dynamic shared memory.
extern "C" cudaError_t union_deduce_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const int* neg_keys, int* roots, int* deduced, int* conflict, int* error,
    int* table, int B, int n, int P, int table_size, int max_trips,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      union_deduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  union_deduce_kernel<<<B, kThreads, smem, stream>>>(
      parent0, u, v, pos, neg_keys, roots, deduced, conflict, error, table, n,
      P, table_size, max_trips);
  return cudaGetLastError();
}
