// Fused union + conflict screen + transitive deduce, one thread-block
// cluster per lane.
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
// Bound on an H100: bytes, about 4 * (2n + 5P) per lane (forest in and out,
// four P-long inputs, one P-long output), a few microseconds at 3.35 TB/s
// for the main path's lanes.  What holds a kernel back here is latency: the
// hash set's probes and inserts are dependent L2 accesses at random
// addresses, and one SM keeps only so many in flight.  So a lane runs on a
// cluster of C = 16 blocks (cudaLaunchKernelEx with a cluster dimension; 16
// needs the non-portable attribute), each on its own SM with its own L2
// bandwidth, and the blocks meet at two cluster barriers:
//   1. each block fills its share of the lane's hash set with EMPTY, lists
//      the POS edges of its slice of the pairs (u | v << 16; n <= 46340) in
//      its slice of an edge list in global scratch, publishes their count,
//      and loads the whole forest into its own shared memory (n ints, at
//      most 185 KB);  -- cluster barrier --
//   2. each block copies the lane's POS edges (the blocks' lists end to
//      end) into the shared memory after its forest, as many as fit (the
//      rest it reads from L2 on every trip), and unites them into its own
//      copy of the forest: hook the larger root under the smaller with
//      shared-memory atomicMin, take every object up its tree (compress)
//      until each points at a root, repeat until a pass hooks nothing.  The
//      union's fixed point is unique (every object at the least id of its
//      component, since a parent is never larger than its child), so every
//      block ends with the same forest, bit for bit the reference's,
//      whatever order the hooks ran in, and the trips need only the block's
//      own barriers.  A trip cap guards the loop; a block that hits it sets
//      error[b] and the wrapper raises;
//   3. each block writes its slice of the ids' roots, and re-keys its share
//      of the neg index under the new forest into the lane's open-addressing
//      hash set (atomicCAS, load factor <= 1/2); a key whose endpoints now
//      share a root sets conflict[b].  The index is sorted with its keys
//      ahead of its padding, so a block's share is every C-th chunk of
//      1024 entries, not a slice: the re-keying stays balanced;
//      -- cluster barrier --
//   4. each block probes the set with the canonical root key of each pair
//      of its slice.
// Every pass over a slice of global memory takes kBatch items a thread at
// a time and issues their loads together, so a block waits on one memory
// latency a batch, not one an item.
// A set does not depend on insertion order and conflict is an OR, so every
// output matches the reference bit for bit.  Block 0 of the cluster zeroes
// conflict[b] and error[b] before the first barrier, and the blocks set them
// after it, so the wrapper launches this kernel and nothing else.  The
// blocks share nothing through distributed shared memory: exchanging the
// forest between them would put a cluster barrier on every trip of the
// union, whose POS edges are a few thousand a lane on the main path.
//
// Slices (repro_torch/kernels/union_deduce/kernel.py::plan computes the
// same): block r of a cluster of C takes pairs [lo, hi) with
// lo = min(P, r * pair_slice), hi = min(P, lo + pair_slice), neg keys
// [(r + C j) * 1024, (r + C j + 1) * 1024) for j = 0, 1, ..., table slots
// [r * T / C, (r + 1) * T / C), ids [r * ceil(n / C), ...) up to n.  A
// lane's scratch is `stride` ints: the hash set (T, a power of two >= 64),
// C edge counts, then the P-long edge list.
//
// Past 46340 objects (n * n >= 2^31) the keys are int64 and the forest does
// not fit a block's shared memory, so a second kernel, union_deduce_wide,
// serves those lanes (the wrapper picks it by n).  It keeps the cluster of
// C blocks a lane and the four steps, with these changes:
//   - the lane's one forest lives in global memory, in `roots` itself: each
//     block copies its slice of parent0 there, and the blocks hook it in
//     place with global atomicMin (at n = 65536 it is 256 KB, resident in
//     the 50 MB L2); every read of it goes to L2 (__ldcg), never to a
//     stale L1 line;
//   - a union trip is a hook pass over each block's own POS edges, a
//     cluster barrier, a compress of each block's slice of the ids (the
//     roots are fixed while no hook runs, so a block needs only its own
//     barriers until its slice points at roots), and a cluster barrier;
//     a flag in global scratch says whether any block hooked in the trip;
//   - edges are two int32 lists, u and v, with no 16-bit packing;
//   - the hash set has 64-bit slots (atomicCAS on unsigned long long, empty
//     = all ones) and a mix of both halves; keys decompose with 64-bit
//     division.
// The fixed point is the same unique one, so its outputs equal the plain
// version's bit for bit.  Its bound is bytes too, about 8n + 21P per lane
// (forest in and out; u, v, the mask, the 8-byte keys in, deduced out);
// one cluster a lane leaves most SMs idle at one lane, and each union trip
// waits on two cluster barriers and dependent L2 loads.  A wide lane's scratch is `stride` ints: the set
// (T 64-bit slots, 2T ints), C edge counts, 4 ints of trip flags, then the
// two P-long edge lists.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 16;  // blocks a lane (kernel.py's CLUSTER)
constexpr int kBatch = 8;   // items a thread loads at once (see the note)
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

// Point every object at its root: each pass takes each object up to kChase
// links towards its root (no hook runs meanwhile, so a root seen is a root
// for good), and a pass that leaves no object short of a root is the last.
// Shallow trees take one pass; a long path shrinks about kChase + 1 times
// a pass.  flag[0..2] are zero on entry and on return; one barrier a pass,
// and the caller's barrier before the next call.
constexpr int kChase = 8;

__device__ void compress(int* p, int n, int* flag) {
  for (int pass = 0;; ++pass) {
    bool short_of_root = false;
    for (int x = threadIdx.x; x < n; x += kThreads) {
      int r = p[x];
      int up = p[r];
      if (up == r) continue;
      for (int s = 0; s < kChase && up != r; ++s) {
        r = up;
        up = p[r];
      }
      p[x] = r;
      if (up != r) short_of_root = true;
    }
    if (short_of_root) flag[pass % 3] = 1;
    // flag[(pass + 1) % 3] was last read two barriers ago and is next set
    // after the coming one
    if (threadIdx.x == 0) flag[(pass + 1) % 3] = 0;
    __syncthreads();
    if (!flag[pass % 3]) {
      // the last pass's flag, read before that barrier, is cleared for the
      // next call
      if (threadIdx.x == 0) flag[(pass + 2) % 3] = 0;
      return;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
union_deduce_kernel(const int* __restrict__ parent0, const int* __restrict__ u,
                    const int* __restrict__ v, const uint8_t* __restrict__ pos,
                    const int* __restrict__ neg_keys, int* __restrict__ roots,
                    int* __restrict__ deduced, int* __restrict__ conflict,
                    int* __restrict__ error, int* __restrict__ scratch, int n,
                    int P, int pair_slice, int table_size, int stride,
                    int edge_cap, int max_trips) {
  extern __shared__ int p[];  // this block's copy of the forest, then edges
  __shared__ int seg[kCluster + 1];  // where each block's edges start
  __shared__ int n_edges;
  __shared__ int flag;
  __shared__ int jumps[3];            // compress's pass flags
  __shared__ int conf;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / C;
  const int tid = threadIdx.x;
  parent0 += static_cast<size_t>(lane) * n;
  roots += static_cast<size_t>(lane) * n;
  u += static_cast<size_t>(lane) * P;
  v += static_cast<size_t>(lane) * P;
  pos += static_cast<size_t>(lane) * P;
  neg_keys += static_cast<size_t>(lane) * P;
  deduced += static_cast<size_t>(lane) * P;
  int* table = scratch + static_cast<size_t>(lane) * stride;
  int* counts = table + table_size;
  unsigned* edges = reinterpret_cast<unsigned*>(counts + C);
  const unsigned int mask = static_cast<unsigned int>(table_size - 1);
  const int lo = min(P, rank * pair_slice);
  const int hi = min(P, lo + pair_slice);

  // 1. this block's share of the set's fill, its POS edges, its forest copy
  {
    const int share = table_size / C;   // a multiple of 4
    int4* t4 = reinterpret_cast<int4*>(table + rank * share);
    for (int h = tid; h < share / 4; h += kThreads)
      t4[h] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  }
  for (int x0 = 0; x0 < n; x0 += kBatch * kThreads) {
    int t[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int x = x0 + k * kThreads + tid;
      t[k] = x < n ? parent0[x] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int x = x0 + k * kThreads + tid;
      if (x < n) p[x] = t[k];
    }
  }
  if (tid == 0) {
    n_edges = 0;
    conf = 0;
    jumps[0] = jumps[1] = jumps[2] = 0;
  }
  __syncthreads();
  for (int base = lo; base < hi; base += kBatch * kThreads) {
    bool take[kBatch];
    unsigned w[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + tid;
      take[k] = i < hi && pos[i];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + tid;
      w[k] = take[k] ? static_cast<unsigned>(u[i]) |
                           (static_cast<unsigned>(v[i]) << 16)
                     : 0u;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned ballot = __ballot_sync(0xffffffffu, take[k]);
      int at = 0;
      if ((tid & 31) == 0 && ballot) at = atomicAdd(&n_edges, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (take[k])
        edges[lo + at + __popc(ballot & ((1u << (tid & 31)) - 1u))] = w[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    counts[rank] = n_edges;
    if (rank == 0) {
      conflict[lane] = 0;
      error[lane] = 0;
    }
  }
  cluster.sync();  // the set is empty and every block's edges are listed

  // 2. union every POS edge of the lane into this block's forest.  The
  //    lane's list is the blocks' lists end to end; as much of it as the
  //    shared memory after the forest holds is copied there once, the rest
  //    is read from L2 on every trip
  if (tid == 0) {
    int s = 0;
    for (int r = 0; r < C; ++r) {
      seg[r] = s;
      s += __ldcg(counts + r);
    }
    seg[C] = s;
  }
  __syncthreads();
  const int total = seg[C];
  const int cached = min(total, edge_cap);
  auto edge = [&](int j) {  // the block whose list holds edge j: the last
    int r = 0;              // r with seg[r] <= j (seg is non-decreasing)
#pragma unroll
    for (int step = C / 2; step > 0; step >>= 1)
      if (j >= seg[r + step]) r += step;
    return __ldcg(edges + min(P, r * pair_slice) + (j - seg[r]));
  };
  unsigned* le = reinterpret_cast<unsigned*>(p + n);
  for (int j0 = 0; j0 < cached; j0 += kBatch * kThreads) {
    unsigned w[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * kThreads + tid;
      w[k] = j < cached ? edge(j) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * kThreads + tid;
      if (j < cached) le[j] = w[k];
    }
  }
  int trips = 0;
  for (;;) {
    __syncthreads();
    if (tid == 0) flag = 0;
    __syncthreads();
    bool hooked = false;
    for (int j = tid; j < total; j += kThreads) {
      const unsigned w = j < cached ? le[j] : edge(j);
      const int ru = p[w & 0xffffu];
      const int rv = p[w >> 16];
      if (ru != rv) {
        atomicMin(&p[max(ru, rv)], min(ru, rv));
        hooked = true;
      }
    }
    if (hooked) flag = 1;
    __syncthreads();
    const int any = flag;
    if (!any && trips > 0) break;  // the last trip left the forest compressed
    compress(p, n, jumps);
    if (!any) break;
    if (++trips >= max_trips) {
      if (tid == 0) error[lane] = 1;
      break;
    }
  }
  __syncthreads();

  // 3. this block's roots, and its neg keys re-keyed into the set
  {
    const int ids = (n + C - 1) / C;
    const int end = min(n, (rank + 1) * ids);
    for (int x = rank * ids + tid; x < end; x += kThreads) roots[x] = p[x];
  }
  // the index is sorted, its keys ahead of its padding, so blocks take it in
  // chunks of kThreads dealt round the cluster, not in slices
  for (int g0 = rank * kThreads; g0 < P; g0 += C * kBatch * kThreads) {
    int key[kBatch], prev[kBatch];
    unsigned int h[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = g0 + k * C * kThreads + tid;
      key[k] = i < P ? neg_keys[i] : kSentinel;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {  // first probes, all in flight
      if (key[k] == kSentinel) continue;
      const int rlo = p[key[k] / n];
      const int rhi = p[key[k] % n];
      if (rlo == rhi) {
        conf = 1;
        key[k] = kSentinel;
        continue;
      }
      key[k] = min(rlo, rhi) * n + max(rlo, rhi);
      h[k] = mix(static_cast<unsigned int>(key[k])) & mask;
      prev[k] = atomicCAS(&table[h[k]], kEmpty, key[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {  // then along each collision chain
      if (key[k] == kSentinel) continue;
      while (prev[k] != kEmpty && prev[k] != key[k]) {
        h[k] = (h[k] + 1) & mask;
        prev[k] = atomicCAS(&table[h[k]], kEmpty, key[k]);
      }
    }
  }
  __syncthreads();
  if (tid == 0 && conf) conflict[lane] = 1;
  cluster.sync();  // every block's keys are in the set

  // 4. probe the set with each pair of this block's slice
  for (int i0 = lo + tid; i0 < hi; i0 += kBatch * kThreads) {
    int x[kBatch], y[kBatch];  // u and v; then the key and the slot's content
    unsigned int h[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      x[k] = i < hi ? u[i] : 0;
      y[k] = i < hi ? v[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int ru = p[x[k]];
      const int rv = p[y[k]];
      x[k] = -1;  // the roots agree: POS
      if (ru != rv) {
        x[k] = min(ru, rv) * n + max(ru, rv);
        h[k] = mix(static_cast<unsigned int>(x[k])) & mask;
        y[k] = __ldcg(&table[h[k]]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i >= hi) continue;
      int out = kPos;
      if (x[k] >= 0) {
        for (;;) {
          if (y[k] == x[k]) {
            out = kNeg;
            break;
          }
          if (y[k] == kEmpty) {
            out = kUnknown;
            break;
          }
          h[k] = (h[k] + 1) & mask;
          y[k] = __ldcg(&table[h[k]]);
        }
      }
      deduced[i] = out;
    }
  }
}

// ---------------------------------------------------------------------------
// union_deduce_wide: n > 46340 objects, int64 keys, the forest in global
// memory (see the note at the top)
// ---------------------------------------------------------------------------
constexpr unsigned long long kEmpty64 = ~0ull;
constexpr long long kSentinel64 = 0x7fffffffffffffffll;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return x;
}

// Point every object of [begin, end) at its root, as compress() does for a
// block's shared forest, on the lane's global forest: no hook runs
// meanwhile, so a root seen is a root for good, and the other blocks'
// concurrent writes only move an object closer to its root.  flag[0..2]
// are zero on entry and on return.
__device__ void compress_global(int* p, int begin, int end, int* flag) {
  for (int pass = 0;; ++pass) {
    bool short_of_root = false;
    for (int x = begin + threadIdx.x; x < end; x += kThreads) {
      int r = __ldcg(p + x);
      int up = __ldcg(p + r);
      if (up == r) continue;
      for (int s = 0; s < kChase && up != r; ++s) {
        r = up;
        up = __ldcg(p + r);
      }
      __stcg(p + x, r);
      if (up != r) short_of_root = true;
    }
    if (short_of_root) flag[pass % 3] = 1;
    if (threadIdx.x == 0) flag[(pass + 1) % 3] = 0;
    __syncthreads();
    if (!flag[pass % 3]) {
      if (threadIdx.x == 0) flag[(pass + 2) % 3] = 0;
      return;
    }
  }
}

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  __threadfence();  // this thread's global writes, before the others read
  cluster.sync();
}

__global__ void __launch_bounds__(kThreads, 1)
union_deduce_wide_kernel(const int* __restrict__ parent0,
                         const int* __restrict__ u, const int* __restrict__ v,
                         const uint8_t* __restrict__ pos,
                         const long long* __restrict__ neg_keys, int* roots,
                         int* __restrict__ deduced, int* __restrict__ conflict,
                         int* __restrict__ error, int* __restrict__ scratch,
                         int n, int P, int pair_slice, int table_size,
                         int stride, int max_trips) {
  __shared__ int n_edges;
  __shared__ int flag;
  __shared__ int jumps[3];  // compress_global's pass flags
  __shared__ int conf;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / C;
  const int tid = threadIdx.x;
  parent0 += static_cast<size_t>(lane) * n;
  roots += static_cast<size_t>(lane) * n;
  u += static_cast<size_t>(lane) * P;
  v += static_cast<size_t>(lane) * P;
  pos += static_cast<size_t>(lane) * P;
  neg_keys += static_cast<size_t>(lane) * P;
  deduced += static_cast<size_t>(lane) * P;
  int* base = scratch + static_cast<size_t>(lane) * stride;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(base);
  int* counts = base + 2 * static_cast<size_t>(table_size);
  int* hooked = counts + C;  // a trip's "anything hooked", two in turn
  int* eu = hooked + 4;
  int* ev = eu + P;
  const unsigned long long mask =
      static_cast<unsigned long long>(table_size - 1);
  const int lo = min(P, rank * pair_slice);
  const int hi = min(P, lo + pair_slice);
  const int ids = (n + C - 1) / C;
  const int id_lo = min(n, rank * ids);
  const int id_hi = min(n, id_lo + ids);

  // 1. this block's share of the set's fill, its slice of the forest, its
  //    POS edges
  {
    const int share = table_size / C;
    for (int h = tid; h < share; h += kThreads)
      table[static_cast<size_t>(rank) * share + h] = kEmpty64;
  }
  for (int x = id_lo + tid; x < id_hi; x += kThreads)
    __stcg(roots + x, parent0[x]);
  if (tid == 0) {
    n_edges = 0;
    conf = 0;
    jumps[0] = jumps[1] = jumps[2] = 0;
  }
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + tid;
    const bool take = i < hi && pos[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if ((tid & 31) == 0 && ballot) at = atomicAdd(&n_edges, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (take) {
      const int slot = lo + at + __popc(ballot & ((1u << (tid & 31)) - 1u));
      eu[slot] = u[i];
      ev[slot] = v[i];
    }
  }
  __syncthreads();
  const int mine = n_edges;
  if (tid == 0) {
    counts[rank] = mine;
    if (rank == 0) {
      conflict[lane] = 0;
      error[lane] = 0;
      hooked[0] = hooked[1] = 0;
    }
  }
  cluster_barrier(cluster);  // the set is empty, the forest copied

  // 2. union: hook this block's POS edges into the lane's forest, then
  //    compress this block's ids, until a trip hooks nothing
  for (int trips = 0;; ++trips) {
    if (tid == 0) flag = 0;
    __syncthreads();
    bool any_hook = false;
    for (int j = tid; j < mine; j += kThreads) {
      const int ru = __ldcg(roots + __ldcg(eu + lo + j));
      const int rv = __ldcg(roots + __ldcg(ev + lo + j));
      if (ru != rv) {
        atomicMin(roots + max(ru, rv), min(ru, rv));
        any_hook = true;
      }
    }
    if (any_hook) flag = 1;
    __syncthreads();
    if (tid == 0 && flag) atomicExch(hooked + (trips & 1), 1);
    cluster_barrier(cluster);  // every hook of the trip has landed
    const int any = __ldcg(hooked + (trips & 1));
    // the next trip's flag was last read before this trip's hooks began
    if (tid == 0 && rank == 0) atomicExch(hooked + ((trips + 1) & 1), 0);
    if (!any && trips > 0) break;  // the last trip left the forest compressed
    compress_global(roots, id_lo, id_hi, jumps);
    cluster_barrier(cluster);  // every slice points at its root
    if (!any) break;
    if (trips + 1 >= max_trips) {
      if (tid == 0) error[lane] = 1;
      break;
    }
  }

  // 3. this block's neg keys re-keyed into the set, in chunks of kThreads
  //    dealt round the cluster
  for (int g = rank * kThreads + tid; g < P; g += C * kThreads) {
    long long key = neg_keys[g];
    if (key == kSentinel64) continue;
    const int rlo = __ldcg(roots + static_cast<int>(key / n));
    const int rhi = __ldcg(roots + static_cast<int>(key % n));
    if (rlo == rhi) {
      conf = 1;
      continue;
    }
    key = static_cast<long long>(min(rlo, rhi)) * n + max(rlo, rhi);
    const unsigned long long k = static_cast<unsigned long long>(key);
    unsigned long long h = mix64(k) & mask;
    for (;;) {
      const unsigned long long prev = atomicCAS(table + h, kEmpty64, k);
      if (prev == kEmpty64 || prev == k) break;
      h = (h + 1) & mask;
    }
  }
  __syncthreads();
  if (tid == 0 && conf) conflict[lane] = 1;
  cluster_barrier(cluster);  // every block's keys are in the set

  // 4. probe the set with each pair of this block's slice
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int ru = __ldcg(roots + u[i]);
    const int rv = __ldcg(roots + v[i]);
    int out = kPos;
    if (ru != rv) {
      const unsigned long long k = static_cast<unsigned long long>(
          static_cast<long long>(min(ru, rv)) * n + max(ru, rv));
      unsigned long long h = mix64(k) & mask;
      for (;;) {
        const unsigned long long got = __ldcg(table + h);
        if (got == k) {
          out = kNeg;
          break;
        }
        if (got == kEmpty64) {
          out = kUnknown;
          break;
        }
        h = (h + 1) & mask;
      }
    }
    deduced[i] = out;
  }
}

cudaLaunchConfig_t launch_config(int B, int smem, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Lets the kernel take as much dynamic shared memory as a block of the
// current device can have beside its static variables, and clusters of
// kCluster blocks; then says how many clusters of blocks with `smem` bytes
// of dynamic shared memory each the device can hold at once (0: none can be
// placed).  With `wide` set, the same for union_deduce_wide_kernel, which
// takes no dynamic shared memory.  The wrapper calls it once per device,
// kernel and size, before the launches, which set no attribute themselves.
extern "C" cudaError_t union_deduce_max_clusters(int smem, int wide,
                                                int* count) {
  if (wide) {  // no dynamic shared memory
    cudaError_t err = cudaFuncSetAttribute(
        union_deduce_wide_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(1, 0, &attr, 0);
    return cudaOccupancyMaxActiveClusters(count, union_deduce_wide_kernel,
                                          &cfg);
  }
  int device = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, union_deduce_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        union_deduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(fa.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(union_deduce_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, smem, &attr, 0);
  return cudaOccupancyMaxActiveClusters(count, union_deduce_kernel, &cfg);
}

// Plain C entry point: one launch of B clusters of kCluster blocks, each
// with `smem` bytes of dynamic shared memory (the forest's 4n, then room
// for (smem - 4n) / 4 edges), on `stream`; returns its status.  scratch
// holds B * stride ints (see the note at the top); nothing needs zeroing.
// union_deduce_max_clusters must have run on the device first.
extern "C" cudaError_t union_deduce_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const int* neg_keys, int* roots, int* deduced, int* conflict, int* error,
    int* scratch, int B, int n, int P, int pair_slice, int table_size,
    int stride, int smem, int max_trips, cudaStream_t stream) {
  if (smem < 4 * n) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, smem, &attr, stream);
  return cudaLaunchKernelEx(&cfg, union_deduce_kernel, parent0, u, v, pos,
                            neg_keys, roots, deduced, conflict, error,
                            scratch, n, P, pair_slice, table_size, stride,
                            (smem - 4 * n) / 4, max_trips);
}

// Plain C entry point of the wide kernel (n > 46340, int64 keys): one
// launch of B clusters of kCluster blocks on `stream`; scratch holds
// B * stride ints (see the note at the top), 8-byte aligned a lane; nothing
// needs zeroing.  union_deduce_max_clusters(0, 1, ...) must have run on the
// device first.
extern "C" cudaError_t union_deduce_wide_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const long long* neg_keys, int* roots, int* deduced, int* conflict,
    int* error, int* scratch, int B, int n, int P, int pair_slice,
    int table_size, int stride, int max_trips, cudaStream_t stream) {
  if (stride % 2 || stride < 2 * table_size + kCluster + 4 + 2 * P)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, 0, &attr, stream);
  return cudaLaunchKernelEx(&cfg, union_deduce_wide_kernel, parent0, u, v,
                            pos, neg_keys, roots, deduced, conflict, error,
                            scratch, n, P, pair_slice, table_size, stride,
                            max_trips);
}
