"""Launch of the hand-written CUDA union–deduce kernels
(``repro_torch/csrc/union_deduce.cu``; they replace the Pallas kernel
``repro/kernels/union_deduce/kernel.py::union_deduce``).  Up to
``MAX_OBJECTS`` objects (int32 keys) a lane runs on a thread-block cluster
whose blocks each keep a copy of the forest in shared memory; past it (int64
keys) the wide kernel runs one cooperative grid of as many blocks as the card
holds at once, dealt to the lanes, which hook each lane's one forest in
global memory without locks.  The lanes' hash sets (and the cluster kernel's
POS-edge lists) are in global scratch.  :func:`plan` lays the launch out; it
runs on the CPU."""
from __future__ import annotations

import dataclasses
import functools

import torch

# n * n < 2^31 (int32 keys) bounds the shared-memory kernel's forest at
# 46340 objects, 185 KB of shared memory — within a block's 227 KB on
# Hopper; past it the keys are int64 and the wide kernel runs
MAX_OBJECTS = 46340
# the wide kernel's ids and offsets are int32
MAX_WIDE_OBJECTS = 2 ** 31 - 1
# blocks of a lane's cluster, the kernel's kCluster: 16, which needs the
# non-portable attribute; an H100 places 7 at a time and ran the dense screen
# faster than at the portable 8 (PERF.md section 6)
CLUSTER = 16
SMEM_LIMIT = 232448         # shared memory a Hopper block can use (227 KB)
SMEM_STATIC = 256           # room for the kernel's static shared variables
TABLE_MIN = 64
# threads of a wide kernel's block, its kWideThreads: also the neg keys a
# chunk of the index that the lane's blocks deal round
WIDE_THREADS = 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a kernel for ``lanes`` lanes of n objects and P pairs
    (see the slices note in ``union_deduce.cu``)."""
    cluster: int        # blocks of a lane's cluster: CLUSTER (0: the wide
                        # kernel, which runs no cluster)
    pair_slice: int     # pairs a block: ceil(P / blocks a lane)
    table_size: int     # hash-set slots a lane: a power of two >= 2P
    scratch_ints: int   # a lane's scratch: the set (and the edge lists)
    smem_bytes: int     # dynamic shared memory a block: forest, then edges
    edge_cache: int     # POS edges a block keeps in shared memory
    wide: bool = False  # the wide kernel: n > MAX_OBJECTS, int64 keys
    # the wide kernel's cooperative grid (0 for the cluster kernel):
    # blocks_per_lane * lane_slots blocks; block b serves lanes b // blocks_per_lane + k * lane_slots as
    # the lane's block b % blocks_per_lane, which takes id_slice ids and
    # fill_slice 16-byte runs of the set's fill (the slices note in
    # ``union_deduce.cu``)
    blocks_per_lane: int = 0
    lane_slots: int = 0
    grid: int = 0
    id_slice: int = 0
    fill_slice: int = 0


def plan(n: int, P: int, lanes: int, blocks: int = 1) -> Plan:
    """Lay out the launch for ``lanes`` stacked lanes of ``n`` objects and
    ``P`` pairs: the shared-memory kernel up to ``MAX_OBJECTS`` objects, a
    cluster of ``CLUSTER`` blocks a lane, block r taking pairs
    ``[min(P, r * pair_slice), min(P, (r + 1) * pair_slice))``.  Past it
    the wide kernel on a cooperative grid of at most ``blocks`` blocks (what
    the card holds at once; the wrapper asks it): as many blocks a lane as
    the lanes share evenly, but no more than one a ``WIDE_THREADS`` pairs or
    objects, and when the lanes outnumber the blocks, one block a lane and
    ``blocks`` lanes at a time.  A wide lane's scratch is its set's 64-bit
    slots; no dynamic shared memory."""
    if not 1 <= n <= MAX_WIDE_OBJECTS:
        raise ValueError(f"union_deduce kernel takes 1 to "
                         f"{MAX_WIDE_OBJECTS} objects, got {n}")
    if P < 1 or lanes < 1:
        raise ValueError(f"union_deduce kernel needs a pair and a lane, got "
                         f"P={P} lanes={lanes}")
    table_size = TABLE_MIN
    while table_size < 2 * P:   # load factor <= 1/2
        table_size *= 2
    if n > MAX_OBJECTS:
        if blocks < 1:
            raise ValueError(f"the wide union_deduce kernel needs a block, "
                             f"got a grid of {blocks}")
        bpl = max(1, min(blocks // lanes, -(-max(P, n) // WIDE_THREADS)))
        slots = min(lanes, blocks // bpl)
        return Plan(cluster=0, pair_slice=-(-P // bpl),
                    table_size=table_size, scratch_ints=2 * table_size,
                    smem_bytes=0, edge_cache=0, wide=True,
                    blocks_per_lane=bpl, lane_slots=slots, grid=bpl * slots,
                    id_slice=-(-n // bpl),
                    fill_slice=-(-(table_size // 2) // bpl))
    room = (SMEM_LIMIT - SMEM_STATIC - 4 * n) // 16 * 4   # edges, 16 B steps
    edge_cache = min(room, -(-P // 4) * 4)
    return Plan(cluster=CLUSTER, pair_slice=-(-P // CLUSTER),
                table_size=table_size,
                scratch_ints=table_size + CLUSTER + -(-P // 4) * 4,
                smem_bytes=4 * n + 4 * edge_cache, edge_cache=edge_cache)


def wide_magic(n: int) -> tuple:
    """``(magic, shift)`` with ``key // n == (key * magic >> 64) >> shift``
    for every ``0 <= key < 2**62`` (so every key below n * n, n up to
    ``MAX_WIDE_OBJECTS``): Granlund and Montgomery's round-up method with
    N = 62 and l = ceil(log2 n), magic = ceil(2**(N + l) / n) < 2**63 (it
    fits an int64), whose error m * n - 2**(N + l) < n <= 2**l meets their
    Theorem 4.2.  The wide kernel takes the quotient with ``__umul64hi`` and
    the remainder by one multiply-subtract.  Needs n >= 3."""
    if not 3 <= n <= MAX_WIDE_OBJECTS:
        raise ValueError(f"wide_magic takes 3 to {MAX_WIDE_OBJECTS}, got {n}")
    ell = (n - 1).bit_length()
    return -(-(1 << (62 + ell)) // n), ell - 2


@functools.cache
def _clusters_placeable(device: int, smem: int) -> int:
    """Clusters of the shared-memory kernel the device can hold at once at
    ``smem`` bytes a block; the first call on a device also sets the
    kernel's attributes there, which the launches rely on."""
    from repro_torch.kernels._build import extension

    with torch.cuda.device(device):
        return int(extension().union_deduce_max_clusters(smem))


@functools.cache
def _wide_blocks(device: int) -> int:
    """Blocks of the wide kernel the device holds at once (its occupancy a
    multiprocessor times the multiprocessors): the grid its cooperative
    launch may take at most; 0 where it cannot be placed."""
    from repro_torch.kernels._build import extension

    with torch.cuda.device(device):
        return int(extension().union_deduce_wide_max_blocks())


def launch(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           pos_mask: torch.Tensor, neg_keys: torch.Tensor, n_objects: int):
    """Check the inputs and launch the kernel, once, on the current stream
    without waiting for it.  Stacked lanes on one CUDA device: parent0 (B, n)
    int32 compressed forests, u/v (B, P) int32, pos_mask (B, P) bool,
    neg_keys (B, P) sorted and padded with their dtype's max: int32 up to
    ``MAX_OBJECTS`` objects, int64 past it (the wide kernel).  Returns
    ``(roots (B, n) int32, deduced (B, P) int32, conflict (B,) int32, error
    (B,) int32)``; ``error`` flags lanes whose union hit the trip cap (the
    cluster kernel's; the wide kernel's lock-free union leaves it 0).
    Raises ``RuntimeError`` if the card cannot place one cluster (or the
    wide kernel's grid)."""
    from repro_torch.kernels._build import extension

    n = parent0.shape[-1]
    key_dtype = torch.int32 if n <= MAX_OBJECTS else torch.int64
    for name, x, dt in (("parent0", parent0, torch.int32),
                        ("u", u, torch.int32), ("v", v, torch.int32),
                        ("pos_mask", pos_mask, torch.bool),
                        ("neg_keys", neg_keys, key_dtype)):
        if not x.is_cuda or x.dtype != dt or x.dim() != 2 \
                or x.device != parent0.device:
            raise ValueError(
                f"union_deduce kernel needs {name} as a 2-D {dt} tensor on "
                f"one CUDA device (keys are int32 up to {MAX_OBJECTS} "
                f"objects, int64 past it; n={n}), got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    B = parent0.shape[0]
    P = u.shape[1]
    if n != n_objects or P < 1 \
            or any(t.shape != (B, P) for t in (v, pos_mask, neg_keys)):
        raise ValueError(
            f"union_deduce kernel shapes: parent0 {tuple(parent0.shape)}, "
            f"pairs {tuple(u.shape)}, n_objects={n_objects}")
    dev = parent0.device
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if n > MAX_OBJECTS:
        blocks = _wide_blocks(index)
        if blocks < 1:
            raise RuntimeError("union_deduce: the card cannot place a "
                               "cooperative grid of the wide kernel")
        pl = plan(n, P, B, blocks)
    else:
        pl = plan(n, P, B)
        if not _clusters_placeable(index, pl.smem_bytes):
            raise RuntimeError(
                f"union_deduce: the card cannot place a cluster of "
                f"{pl.cluster} blocks with {pl.smem_bytes} bytes of shared "
                f"memory each")
    roots = torch.empty((B, n), dtype=torch.int32, device=dev)
    deduced = torch.empty((B, P), dtype=torch.int32, device=dev)
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    error = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty((B, pl.scratch_ints), dtype=torch.int32,
                          device=dev)
    args = (parent0.contiguous(), u.contiguous(), v.contiguous(),
            pos_mask.contiguous().view(torch.uint8), neg_keys.contiguous(),
            roots, deduced, conflict, error, scratch)
    if pl.wide:
        extension().union_deduce_wide(
            *args, pl.blocks_per_lane, pl.lane_slots, pl.pair_slice,
            pl.id_slice, pl.fill_slice, pl.table_size, *wide_magic(n))
    else:
        extension().union_deduce(*args, pl.pair_slice, pl.table_size,
                                 pl.smem_bytes, max_trips(n))
    return roots, deduced, conflict, error


def max_trips(n: int) -> int:
    """Cap on the cluster kernel's union trips: every two trips at least
    halve the roots a component still has, so a correct run needs about 2 *
    log2(n); the cap leaves a margin."""
    return 4 * n.bit_length() + 16


def union_deduce(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 pos_mask: torch.Tensor, neg_keys: torch.Tensor,
                 n_objects: int):
    """:func:`launch`, then raise if a lane hit the trip cap.  Returns
    ``(roots (B, n) int32, deduced (B, P) int32, conflict (B,) bool)``."""
    roots, deduced, conflict, error = launch(parent0, u, v, pos_mask,
                                             neg_keys, n_objects)
    if bool(error.any()):
        raise RuntimeError(
            f"union_deduce kernel hit its cap of {max_trips(n_objects)} union"
            f" trips on lanes {torch.nonzero(error).flatten().tolist()}")
    return roots, deduced, conflict.bool()
