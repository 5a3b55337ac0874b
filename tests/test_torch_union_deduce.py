"""The plain PyTorch union–deduce step (the CPU path of
``repro_torch.kernels.union_deduce.ops``) against the JAX package's fused
union–deduce, both its XLA oracle (``impl="ref"``) and its Pallas kernel in
interpret mode: roots, deductions and the conflict bit, bit for bit.  The
port runs stacked lanes in one call; the reference runs them one by one.
Then the CUDA kernels' launch planner, which runs on the CPU: its slices,
hash-set size and shared memory, the wide kernel's grid shares and its
division by n through a magic multiplier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.union_deduce.ops import fused_union_deduce as _fused

# jitted once per shape, so the reference's while loops compile once
fused_union_deduce = jax.jit(_fused, static_argnames=("n_objects", "impl"))
from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.graph import key_sentinel
from repro_torch.kernels.union_deduce import kernel as ud_kernel
from repro_torch.kernels.union_deduce.ops import union_deduce


def _components(n, u, v):
    """Least-id component of every object over the edges (u, v)."""
    parent = np.arange(n)
    for a, b in zip(u, v):
        ra, rb = a, b
        while parent[ra] != ra:
            ra = parent[ra]
        while parent[rb] != rb:
            rb = parent[rb]
        parent[max(ra, rb)] = min(ra, rb)
    for x in range(n):
        while parent[x] != parent[parent[x]]:
            parent[x] = parent[parent[x]]
    return parent.astype(np.int32)


def _lane(rng, n, p):
    """A compressed forest over some POS edges, a sorted neg-key index over
    some others, and a fresh POS mask to unite — from a random partition of
    the objects, so most neg keys survive the union; a few random POS edges
    across the partition make some lanes conflict."""
    u = rng.integers(0, n, p).astype(np.int32)
    v = ((u + 1 + rng.integers(0, n - 1, p)) % n).astype(np.int32)
    cluster = rng.integers(0, max(2, n // 3), n)
    truth = np.where(cluster[u] == cluster[v], POS, NEG)
    stage = rng.integers(0, 3, p)          # 0: in the forest, 1: query, 2: new
    fold = (stage == 0) & (truth == POS)
    parent0 = _components(n, u[fold], v[fold])
    ru, rv = parent0[u], parent0[v]
    keys = np.minimum(ru, rv) * n + np.maximum(ru, rv)
    negk = np.sort(np.where((stage == 0) & (truth == NEG), keys,
                            key_sentinel(torch.int32))).astype(np.int32)
    pos = (stage == 2) & ((truth == POS) | (rng.random(p) < 0.3))
    return parent0, u, v, pos, negk


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_union_deduce_matches_reference(seed, impl):
    # two shapes across the seeds keep the reference's compile cache warm
    rng = np.random.default_rng(seed)
    n, p, lanes = (24, 48, 3) if seed % 2 else (40, 96, 3)
    batch = [_lane(rng, n, p) for _ in range(lanes)]
    got = union_deduce(*(torch.from_numpy(np.stack(x))
                         for x in zip(*batch)), n)
    for b, lane in enumerate(batch):
        exp = fused_union_deduce(*(jnp.asarray(x) for x in lane),
                                 n_objects=n, impl=impl)
        for name, g, e in zip(("roots", "deduced", "conflict"), got, exp):
            np.testing.assert_array_equal(
                g[b].numpy(), np.asarray(e),
                err_msg=f"seed={seed} impl={impl} lane={b} {name}")


@pytest.mark.parametrize("n", [64, 1024])
def test_union_deduce_path_graph(n):
    """Worst case for pointer jumping: one long path united in one call."""
    u = np.arange(n - 1, dtype=np.int32)
    args = (np.arange(n, dtype=np.int32), u, u + 1, np.ones(n - 1, bool),
            np.full(n - 1, key_sentinel(torch.int32), np.int32))
    roots, ded, conf = union_deduce(*(torch.from_numpy(x[None])
                                      for x in args), n)
    np.testing.assert_array_equal(roots[0].numpy(), np.zeros(n, np.int32))
    for impl in ("ref", "interpret"):
        exp = fused_union_deduce(*(jnp.asarray(x) for x in args),
                                 n_objects=n, impl=impl)
        np.testing.assert_array_equal(roots[0].numpy(), np.asarray(exp[0]))
        np.testing.assert_array_equal(ded[0].numpy(), np.asarray(exp[1]))
        assert bool(conf[0]) == bool(exp[2]) is False


# the kernel's launch planner (pure Python: it runs here, without a card)
C = ud_kernel.CLUSTER


@pytest.mark.parametrize("P", [1, C - 1, C, C + 1, 8003, 131072])
def test_plan_slices_cover_the_pairs_once(P):
    pl = ud_kernel.plan(8192, P, 4)
    assert pl.cluster == C
    covered = np.zeros(P, np.int64)
    for r in range(C):
        # block r of the cluster takes [min(P, r s), min(P, r s + s))
        covered[min(P, r * pl.pair_slice):
                min(P, r * pl.pair_slice + pl.pair_slice)] += 1
    assert (covered == 1).all()


def test_plan_uses_the_kernels_cluster():
    assert ud_kernel.plan(8192, 131072, 4).cluster == C == 16


@pytest.mark.parametrize("P", [1, 7, 32, 33, 131072, 262145])
def test_plan_table_is_a_power_of_two_past_twice_the_pairs(P):
    pl = ud_kernel.plan(1024, P, 2)
    T = pl.table_size
    assert T & (T - 1) == 0 and T >= 2 * P and T // 2 < max(2 * P, 64)
    # every block of the cluster fills whole 16-byte runs
    assert T % (4 * C) == 0
    assert pl.scratch_ints % 4 == 0
    assert pl.scratch_ints >= T + C + P


@pytest.mark.parametrize("n,P", [(1, 1), (8192, 131072), (32768, 262144),
                                 (ud_kernel.MAX_OBJECTS, 1),
                                 (ud_kernel.MAX_OBJECTS, 4096)])
def test_plan_shared_memory_fits_a_hopper_block(n, P):
    pl = ud_kernel.plan(n, P, 4)
    assert pl.smem_bytes + ud_kernel.SMEM_STATIC <= 227 * 1024
    assert pl.smem_bytes == 4 * n + 4 * pl.edge_cache
    assert 0 < pl.edge_cache and pl.edge_cache % 4 == 0
    assert pl.edge_cache >= min(P, 11708)   # all edges, or what fits


@pytest.mark.parametrize("n,P,lanes", [
    (ud_kernel.MAX_OBJECTS + 1, 8, 1), (0, 8, 1), (8, 0, 1), (8, 8, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(n, P, lanes):
    """Past ``MAX_OBJECTS`` the plan is the wide kernel's (int64 keys, the
    forest in global memory): no cluster and no dynamic shared memory, a
    cooperative grid of blocks dealt to the lanes, a lane's scratch its
    set's 64-bit slots (16-byte aligned a lane).  No objects, no pairs or no
    lanes are refused, and so is a wide grid of no blocks."""
    if n > ud_kernel.MAX_OBJECTS:
        pl = ud_kernel.plan(n, P, lanes, 132)
        assert pl.wide and pl.smem_bytes == 0 and pl.edge_cache == 0
        # a block a WIDE_THREADS ids at most: 91 for 46341 objects
        assert pl.cluster == 0 and pl.blocks_per_lane == -(-n // 512) == 91
        assert pl.grid == pl.blocks_per_lane * pl.lane_slots
        assert pl.lane_slots == lanes
        assert pl.pair_slice == -(-P // pl.blocks_per_lane)
        assert pl.scratch_ints == 2 * pl.table_size
        assert pl.scratch_ints % 4 == 0
        assert not ud_kernel.plan(ud_kernel.MAX_OBJECTS, P, lanes).wide
        with pytest.raises(ValueError):
            ud_kernel.plan(n, P, lanes, 0)
        return
    with pytest.raises(ValueError):
        ud_kernel.plan(n, P, lanes)


def _lanes_of_block(pl, lanes, block):
    """The lanes block ``block`` of a wide launch serves, in turn (as the
    lane's block ``block % pl.blocks_per_lane``), as the kernel deals them."""
    return range(block // pl.blocks_per_lane, lanes, pl.lane_slots)


def _wide_shares(pl, n, P, rank):
    """What the lane's block ``rank`` of a wide launch takes, as
    ``union_deduce_wide_kernel`` computes it from the plan: ``[lo, hi)`` of
    the pairs, the ids and the 16-byte runs of the set's fill, and the
    neg-key index's chunks of ``WIDE_THREADS`` entries (dealt round the
    lane's blocks)."""
    def cut(total, size):
        lo = min(total, rank * size)
        return lo, min(total, lo + size)

    return {"pairs": cut(P, pl.pair_slice), "ids": cut(n, pl.id_slice),
            "fill": cut(pl.table_size // 2, pl.fill_slice),
            "key_chunks": range(rank, -(-P // ud_kernel.WIDE_THREADS),
                                pl.blocks_per_lane)}


# (P, lanes, blocks): one lane on a card's grid (phase 4g's round-1 screen
# at 132 and 264 blocks), stacked lanes sharing it, few pairs, more lanes
# than blocks, a grid of one block
@pytest.mark.parametrize("n,P,lanes,blocks", [
    (65536, 524288, 1, 132), (65536, 524288, 1, 264), (65536, 524288, 8, 264),
    (50000, 20000, 3, 264), (65536, 131072, 3, 528), (46341, 1, 1, 264),
    (60000, 8003, 5, 7), (50000, 777, 300, 132), (70001, 4099, 4, 1)])
def test_wide_plan_shares_cover_each_item_once(n, P, lanes, blocks):
    """Every lane's pairs, ids, neg-key chunks and 16-byte runs of the set's
    fill fall to exactly one of the blocks serving it, every block of the
    grid serves a lane, and the grid fits the blocks the card holds."""
    pl = ud_kernel.plan(n, P, lanes, blocks)
    assert pl.wide and 1 <= pl.grid <= blocks
    assert pl.grid == pl.blocks_per_lane * pl.lane_slots
    assert pl.lane_slots == min(lanes, blocks // pl.blocks_per_lane)
    if lanes <= blocks:   # the lanes share the grid evenly
        assert pl.lane_slots == lanes
        assert pl.blocks_per_lane == min(blocks // lanes,
                                         -(-max(P, n) // 512))
    T = pl.table_size
    n_chunks = -(-P // ud_kernel.WIDE_THREADS)
    cover = {k: np.zeros((lanes, size), np.int64) for k, size in (
        ("pairs", P), ("ids", n), ("fill", T // 2), ("key_chunks", n_chunks))}
    served = np.zeros((lanes, pl.blocks_per_lane), np.int64)
    for block in range(pl.grid):
        mine = _lanes_of_block(pl, lanes, block)
        assert len(mine) >= 1
        rank = block % pl.blocks_per_lane
        shares = _wide_shares(pl, n, P, rank)
        for lane in mine:
            served[lane, rank] += 1
            for k in ("pairs", "ids", "fill"):
                lo, hi = shares[k]
                cover[k][lane, lo:hi] += 1
            cover["key_chunks"][lane, list(shares["key_chunks"])] += 1
    assert (served == 1).all()
    for k, c in cover.items():
        assert (c == 1).all(), k


@pytest.mark.parametrize("n", [46341, 50000, 65536, 2 ** 20 + 7,
                               2 ** 31 - 1])
def test_wide_magic_divides_every_key_exactly(n):
    """The wide kernel's ``key / n`` without division, emulated in Python
    integers: ``__umul64hi(key, magic) >> shift`` and the remainder by one
    multiply-subtract equal ``divmod(key, n)`` at the ends of the key range,
    at the ends of every endpoint's range, and on 10**5 seeded keys below
    n * n."""
    magic, shift = ud_kernel.wide_magic(n)
    assert 0 < magic < 2 ** 63 and 0 <= shift < 64   # an int64 to the card

    def device(key):
        lo = ((key * magic) >> 64) >> shift     # __umul64hi, then the shift
        return lo, key - lo * n

    ends = (0, 1, 2, n - 2, n - 1)
    keys = {0, n - 1, n, n * n - 1} | {a * n + b for a in ends
                                       for b in ends}
    rng = np.random.default_rng(n)
    hi = rng.integers(0, n, 10 ** 5, dtype=np.int64)
    lo = rng.integers(0, n, 10 ** 5, dtype=np.int64)
    keys |= {int(a) * n + int(b) for a, b in zip(lo, hi)}
    for key in sorted(keys):
        assert 0 <= key < n * n
        assert device(key) == divmod(key, n), key
    with pytest.raises(ValueError):
        ud_kernel.wide_magic(2)
