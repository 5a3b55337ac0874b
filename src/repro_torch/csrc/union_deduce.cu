// Fused union + conflict screen + transitive deduce: one thread-block
// cluster a lane up to 46340 objects, one cooperative grid over every lane
// past it.
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
// serves those lanes (the wrapper picks it by n).  Its bound is bytes too,
// about 8n + 21P per lane (forest in and out; u, v, the mask, the 8-byte
// keys in, deduced out), and what holds it back is again latency: chains
// of dependent L2 accesses at random addresses (a pair, its endpoints'
// parents, their parents, a slot of the set) and the barriers between the
// steps.  So it runs on the whole card, and keeps kBatch items a thread in
// flight in every pass:
//   - one cooperative launch (cudaLaunchKernelEx with the cooperative
//     attribute) of as many blocks as the card holds at once, as the
//     occupancy query says, dealt to the lanes evenly: `bpl` blocks a lane,
//     `slots` lanes at a time, block b serving lanes b / bpl, b / bpl +
//     slots, ... as block b % bpl of each (one block a lane and several
//     lanes a block when the lanes outnumber the blocks); the steps meet at
//     grid barriers (cg::this_grid().sync()), five in all;
//   - the lane's one forest lives in global memory, in `roots` itself (at
//     n = 65536 it is 256 KB, resident in the 50 MB L2); every read of it
//     goes to L2 (__ldcg), never to a stale L1 line;
//   - the union is one lock-free pass in the ECL-CC style (Jaiganesh and
//     Burtscher, HPDC 2018): for each POS edge of the block's pairs, find
//     both roots with path halving (each object passed is pointed at its
//     grandparent), then atomicCAS the larger root's parent from itself to
//     the smaller root, and on a failure climb to what the slot now holds
//     and try again.  A parent is always smaller than its child, so every
//     root is the least id of its tree, and once every edge is in, every
//     component is one tree: the fixed point the plain version computes,
//     bit for bit, in any order.  It cannot fail, so error[b] stays 0.
//     Before it, behind a barrier of its own, every POS edge lowers its
//     larger endpoint root's parent to the smaller root with an atomicMin
//     that no thread waits on: where a round's edges are dense within small
//     components (phase 4g's first screen: 44210 edges, components of up to
//     14 objects) the CAS pass's hooks otherwise collide on a few roots and
//     climb one link an atomic (on an H100: 0.0822 ms against 0.0690 with
//     this pass, which costs 2-6% where edges are few);
//   - after a grid barrier each block points its slice of the ids at their
//     roots (and fills its share of the lane's set), so that after another
//     an endpoint's root is one load, which may stay in L1: the forest is
//     read-only from there on;
//   - each block re-keys its share of the neg index into the set; a key's
//     endpoints decompose without 64-bit division: lo = umulhi(key, magic)
//     >> shift, hi = key - lo * n, with the magic multiplier and shift of
//     kernel.py::wide_magic (Granlund and Montgomery's round-up method,
//     exact for every key below 2^62 > n^2);
//   - the hash set has 64-bit slots (atomicCAS on unsigned long long, empty
//     = all ones, a mix of both halves), filled with 16-byte stores spread
//     over the lane's blocks; after a last grid barrier each block probes
//     its pairs' canonical root keys.  A chain of collisions is walked a
//     slot a round for all of a thread's open items at once, not an item
//     after another: on an H100 the re-key and the probe run at about 60-90
//     G random L2 accesses a second, which sets the kernel's pace.
// A wide lane's scratch is `stride` ints: the set, T 64-bit slots (2T ints).
// The slices (kernel.py::plan sizes them): block rank
// r of a lane's bpl takes pairs [min(P, r * pair_slice), ...) up to P, ids
// [min(n, r * id_slice), ...) up to n, the fill's 16-byte runs
// [min(T / 2, r * fill_slice), ...) up to T / 2, and neg keys in chunks of
// kWideThreads, chunks r, r + bpl, r + 2 bpl, ....
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
// memory, one cooperative grid over every lane (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 512;  // kernel.py's WIDE_THREADS
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

// The root of x in the lane's forest p, given x's parent px and px's parent
// gx, loaded beforehand with the rest of a batch.  Every parent is smaller
// than its child, so the root is the first object on the way up that is its
// own parent.  With `halve` each object passed is pointed at its grandparent
// (path halving): a non-root's parent only ever moves to one of its
// ancestors and a root is never written here, so the forest stays a forest
// while other threads hook roots.
template <bool halve>
__device__ __forceinline__ int find_root(int* p, int x, int px, int gx) {
  if (gx == px) return px;  // px is a root (x itself when px == x)
  int prev = x, curr = px, next = gx;
  for (;;) {
    if (halve) __stcg(p + prev, next);
    prev = curr;
    curr = next;
    next = __ldcg(p + curr);
    if (next == curr) return curr;
  }
}

// Unite the trees of roots a and b: hook the larger root under the smaller
// with an atomicCAS of its parent from itself; if another thread hooked it
// first, climb to what its slot holds now and try again.
__device__ __forceinline__ void hook(int* p, int a, int b) {
  while (a != b) {
    const int hi = max(a, b), lo = min(a, b);
    const int was = atomicCAS(p + hi, hi, lo);
    if (was == hi) return;
    if (a == hi)
      a = was;
    else
      b = was;
  }
}

// key / n for 0 <= key < 2^62, from kernel.py::wide_magic's multiplier and
// shift: no 64-bit division on the device.
__device__ __forceinline__ int key_lo(long long key, unsigned long long magic,
                                      int shift) {
  return static_cast<int>(
      __umul64hi(static_cast<unsigned long long>(key), magic) >> shift);
}

__global__ void __launch_bounds__(kWideThreads)
union_deduce_wide_kernel(const int* __restrict__ parent0,
                         const int* __restrict__ u, const int* __restrict__ v,
                         const uint8_t* __restrict__ pos,
                         const long long* __restrict__ neg_keys, int* roots,
                         int* __restrict__ deduced, int* __restrict__ conflict,
                         int* __restrict__ error, int* __restrict__ scratch,
                         int B, int n, int P, int bpl, int slots,
                         int pair_slice, int id_slice, int fill_slice,
                         int table_size, long long stride,
                         unsigned long long magic, int shift) {
  constexpr int NT = kWideThreads;
  cg::grid_group grid = cg::this_grid();
  const int rank = static_cast<int>(blockIdx.x) % bpl;  // in each lane
  const int first = static_cast<int>(blockIdx.x) / bpl;  // lanes first, +slots
  const int tid = threadIdx.x;
  const unsigned long long mask =
      static_cast<unsigned long long>(table_size - 1);
  const long long r = rank;
  const int lo = static_cast<int>(min(static_cast<long long>(P),
                                      r * pair_slice));
  const int hi = min(P, lo + pair_slice);
  const int id_lo = static_cast<int>(min(static_cast<long long>(n),
                                         r * id_slice));
  const int id_hi = static_cast<int>(
      min(static_cast<long long>(n), static_cast<long long>(id_lo) + id_slice));
  const int runs = table_size / 2;  // 16-byte runs of the set
  const int f_lo = static_cast<int>(min(static_cast<long long>(runs),
                                        r * fill_slice));
  const int f_hi = min(runs, f_lo + fill_slice);

  // 1. this block's ids' parents copied into roots, and the lane's flags
  //    zeroed
  for (int lane = first; lane < B; lane += slots) {
    const size_t ln = static_cast<size_t>(lane);
    const int* src = parent0 + ln * n;
    int* dst = roots + ln * n;
    for (int x0 = id_lo + tid; x0 < id_hi; x0 += kBatch * NT) {
      int t[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = x0 + k * NT;
        t[k] = x < id_hi ? src[x] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = x0 + k * NT;
        if (x < id_hi) __stcg(dst + x, t[k]);
      }
    }
    if (rank == 0 && tid == 0) {
      conflict[lane] = 0;
      error[lane] = 0;  // the union below cannot fail
    }
  }
  grid.sync();

  // 2a. every POS edge of this block's pairs lowers its larger endpoint
  //     root's parent to the smaller root (atomicMin, nobody waits on it):
  //     the forest stays one, its trees each inside a component, and a
  //     clique of edges becomes a star at once; a link that a smaller
  //     minimum overwrote is restored by 2b, which sees every edge again
  for (int lane = first; lane < B; lane += slots) {
    const size_t lp = static_cast<size_t>(lane) * P;
    int* p = roots + static_cast<size_t>(lane) * n;
    for (int i0 = lo + tid; i0 < hi; i0 += kBatch * NT) {
      int x[kBatch], y[kBatch];
      bool take[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * NT;
        take[k] = i < hi && pos[lp + i];
        x[k] = i < hi ? u[lp + i] : 0;
        y[k] = i < hi ? v[lp + i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // parent0 is compressed: roots
        x[k] = take[k] ? __ldcg(p + x[k]) : 0;
        y[k] = take[k] ? __ldcg(p + y[k]) : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (x[k] != y[k]) atomicMin(p + max(x[k], y[k]), min(x[k], y[k]));
    }
  }
  grid.sync();

  // 2b. the union: every POS edge of this block's pairs, its endpoints'
  //     roots found with path halving, the larger hooked under the smaller
  for (int lane = first; lane < B; lane += slots) {
    const size_t lp = static_cast<size_t>(lane) * P;
    int* p = roots + static_cast<size_t>(lane) * n;
    for (int i0 = lo + tid; i0 < hi; i0 += kBatch * NT) {
      int x[kBatch], y[kBatch], px[kBatch], py[kBatch];
      bool take[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * NT;
        take[k] = i < hi && pos[lp + i];
        x[k] = i < hi ? u[lp + i] : 0;
        y[k] = i < hi ? v[lp + i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // the parents, all in flight
        px[k] = take[k] ? __ldcg(p + x[k]) : 0;
        py[k] = take[k] ? __ldcg(p + y[k]) : 0;
      }
      int gx[kBatch], gy[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // then the grandparents
        gx[k] = take[k] ? __ldcg(p + px[k]) : 0;
        gy[k] = take[k] ? __ldcg(p + py[k]) : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // the roots; first hooks in flight
        if (!take[k]) continue;
        x[k] = find_root<true>(p, x[k], px[k], gx[k]);
        y[k] = find_root<true>(p, y[k], py[k], gy[k]);
        if (x[k] != y[k])
          px[k] = atomicCAS(p + max(x[k], y[k]), max(x[k], y[k]),
                            min(x[k], y[k]));
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // then the hooks another beat
        if (!take[k] || x[k] == y[k] || px[k] == max(x[k], y[k])) continue;
        if (x[k] > y[k])
          hook(p, px[k], y[k]);
        else
          hook(p, x[k], px[k]);
      }
    }
  }
  grid.sync();

  // 3. this block's ids pointed at their roots, and its share of the
  //    lane's set filled with empty slots (16-byte stores)
  for (int lane = first; lane < B; lane += slots) {
    const size_t ln = static_cast<size_t>(lane);
    int* p = roots + ln * n;
    uint4* t4 = reinterpret_cast<uint4*>(scratch + ln * stride);
    const uint4 empty = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (int h = f_lo + tid; h < f_hi; h += NT) __stcg(t4 + h, empty);
    for (int x0 = id_lo + tid; x0 < id_hi; x0 += kBatch * NT) {
      int px[kBatch], gx[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = x0 + k * NT;
        px[k] = x < id_hi ? __ldcg(p + x) : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = x0 + k * NT;
        gx[k] = x < id_hi ? __ldcg(p + px[k]) : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = x0 + k * NT;
        if (x < id_hi && gx[k] != px[k])
          __stcg(p + x, find_root<false>(p, x, px[k], gx[k]));
      }
    }
  }
  grid.sync();

  // 4. this block's neg keys, dealt round the lane's blocks in chunks of NT
  //    (the index is sorted, its keys ahead of its padding), re-keyed into
  //    the set; every object points at its root now, so a root is one load,
  //    and the forest is read-only from here on, so its loads may stay in
  //    L1 (the grid barrier's acquire drops the SM's stale lines)
  for (int lane = first; lane < B; lane += slots) {
    const size_t ln = static_cast<size_t>(lane);
    const int* p = roots + ln * n;
    unsigned long long* table =
        reinterpret_cast<unsigned long long*>(scratch + ln * stride);
    const long long* keys = neg_keys + ln * P;
    bool conf = false;
    for (int g0 = rank * NT; g0 < P; g0 += bpl * kBatch * NT) {
      long long key[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = g0 + k * bpl * NT + tid;
        key[k] = i < P ? keys[i] : kSentinel64;
      }
      int ra[kBatch], rb[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // the endpoints' roots
        if (key[k] == kSentinel64) continue;
        const int a = key_lo(key[k], magic, shift);
        ra[k] = p[a];
        rb[k] = p[static_cast<int>(key[k] - static_cast<long long>(a) * n)];
      }
      unsigned long long want[kBatch], h[kBatch], prev[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // first probes, all in flight
        if (key[k] == kSentinel64) continue;
        if (ra[k] == rb[k]) {
          conf = true;
          key[k] = kSentinel64;
          continue;
        }
        want[k] = static_cast<unsigned long long>(
            static_cast<long long>(min(ra[k], rb[k])) * n + max(ra[k], rb[k]));
        h[k] = mix64(want[k]) & mask;
        prev[k] = atomicCAS(table + h[k], kEmpty64, want[k]);
      }
      // then along the collision chains, a slot of each open one a round,
      // so a thread waits on one L2 trip a round and not one an item
      for (bool open = true; open;) {
        open = false;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (key[k] == kSentinel64 || prev[k] == kEmpty64 ||
              prev[k] == want[k])
            continue;
          h[k] = (h[k] + 1) & mask;
          prev[k] = atomicCAS(table + h[k], kEmpty64, want[k]);
          open = true;
        }
      }
    }
    if (__syncthreads_or(conf) && tid == 0) conflict[lane] = 1;
  }
  grid.sync();

  // 5. probe the set with the canonical root key of each of this block's
  //    pairs
  for (int lane = first; lane < B; lane += slots) {
    const size_t lp = static_cast<size_t>(lane) * P;
    const int* p = roots + static_cast<size_t>(lane) * n;
    const unsigned long long* table =
        reinterpret_cast<const unsigned long long*>(
            scratch + static_cast<size_t>(lane) * stride);
    for (int i0 = lo + tid; i0 < hi; i0 += kBatch * NT) {
      int ru[kBatch], rv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * NT;
        ru[k] = i < hi ? u[lp + i] : 0;
        rv[k] = i < hi ? v[lp + i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        ru[k] = p[ru[k]];
        rv[k] = p[rv[k]];
      }
      unsigned long long want[kBatch], got[kBatch], h[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (ru[k] == rv[k]) continue;
        want[k] = static_cast<unsigned long long>(
            static_cast<long long>(min(ru[k], rv[k])) * n + max(ru[k], rv[k]));
        h[k] = mix64(want[k]) & mask;
        got[k] = __ldcg(table + h[k]);
      }
      // along the collision chains, a slot of each open one a round
      for (bool open = true; open;) {
        open = false;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (ru[k] == rv[k] || got[k] == want[k] || got[k] == kEmpty64)
            continue;
          h[k] = (h[k] + 1) & mask;
          got[k] = __ldcg(table + h[k]);
          open = true;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * NT;
        if (i < hi)
          deduced[lp + i] = ru[k] == rv[k]     ? kPos
                            : got[k] == want[k] ? kNeg
                                                : kUnknown;
      }
    }
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
// placed).  The wrapper calls it once per device and size, before the
// launches, which set no attribute themselves.
extern "C" cudaError_t union_deduce_max_clusters(int smem, int* count) {
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

// Blocks of union_deduce_wide_kernel the current device holds at once (the
// blocks a multiprocessor holds times the multiprocessors): the largest
// grid a cooperative launch of it may take; 0 where none can be placed or
// the device has no cooperative launch.
extern "C" cudaError_t union_deduce_wide_max_blocks(int* count) {
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  *count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, union_deduce_wide_kernel, kWideThreads, 0);
  if (err == cudaSuccess && coop) *count = sms * per_sm;
  return err;
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
// cooperative launch of bpl * slots blocks of kWideThreads on `stream`, at
// most union_deduce_wide_max_blocks; the layout (bpl, slots and the
// slices) and the magic multiplier come from kernel.py::plan.  scratch
// holds B * stride ints (the set: 2 * table_size of them a lane), 16-byte
// aligned a lane; nothing needs zeroing.
extern "C" cudaError_t union_deduce_wide_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const long long* neg_keys, int* roots, int* deduced, int* conflict,
    int* error, int* scratch, int B, int n, int P, int bpl, int slots,
    int pair_slice, int id_slice, int fill_slice, int table_size,
    long long stride, unsigned long long magic, int shift,
    cudaStream_t stream) {
  if (bpl < 1 || slots < 1 || table_size < 64 ||
      (table_size & (table_size - 1)) || stride % 4 ||
      stride < 2LL * table_size)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bpl * slots);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, union_deduce_wide_kernel, parent0, u, v,
                            pos, neg_keys, roots, deduced, conflict, error,
                            scratch, B, n, P, bpl, slots, pair_slice,
                            id_slice, fill_slice, table_size, stride, magic,
                            shift);
}
