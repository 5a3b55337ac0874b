"""Launches of the hand-written CUDA pair-score kernels:
``repro_torch/csrc/pair_scores.cu`` (it replaces the Pallas kernel
``repro/kernels/pair_scores/kernel.py::pair_scores``) and
``repro_torch/csrc/pair_scores_compact.cu`` (it replaces
``pair_scores_compact`` there).  The wrappers in :mod:`.ops` pad to the tile
multiples below."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

TILE_ROWS = 128   # rows of a (and of b) per block; N and M pad to this
TILE_DEPTH = 16   # k slice staged in shared memory; D pads to this
MAX_CLUSTER = 8   # the band kernel's largest cluster (the portable size)
INT32_LIMIT = 2 ** 31


def pair_scores(a: torch.Tensor, b: torch.Tensor, threshold: float,
                m_valid: int):
    """a: (N, D), b: (M, D) contiguous f32 CUDA tensors with N, M multiples
    of ``TILE_ROWS`` and D of ``TILE_DEPTH``.  Returns (scores (N, M) f32
    zeroed below threshold, counts (N,) int32 over the first ``m_valid``
    columns)."""
    from repro_torch.kernels._build import extension

    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(
                f"pair_scores kernel needs {name} as a contiguous 2-D f32 "
                f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    (N, D), (M, D2) = a.shape, b.shape
    if a.device != b.device or D != D2 or N % TILE_ROWS or M % TILE_ROWS \
            or D % TILE_DEPTH or not 0 <= m_valid <= M:
        raise ValueError(
            f"pair_scores kernel shapes a {tuple(a.shape)} b {tuple(b.shape)}"
            f" m_valid={m_valid}: rows must pad to {TILE_ROWS}, depth to "
            f"{TILE_DEPTH}, on one device")
    scores = torch.empty((N, M), dtype=torch.float32, device=a.device)
    counts = torch.zeros(N, dtype=torch.int32, device=a.device)
    extension().pair_scores(a, b, scores, counts, int(m_valid),
                            float(threshold))
    return scores, counts


class CompactPlan(NamedTuple):
    """One ``pair_scores_compact`` launch as ``pair_scores_compact.cu``
    lays it out."""
    kernel: str    # "one-pass" (bn, bm <= TILE_ROWS) or "band"
    items: int     # look-back items: tiles, or bands of up to TILE_ROWS rows
    cluster: int   # blocks an item: one, or a band's cluster
    blocks: int    # items * cluster


def compact_plan(T: int, bn: int, bm: int) -> CompactPlan:
    """The launch of T tiles of bn x bm: T items of one block each on the
    one-pass kernel (bn, bm <= ``TILE_ROWS``); else on the band kernel T *
    ceil(bn / ``TILE_ROWS``) bands of up to ``TILE_ROWS`` rows across all
    bm columns, each a cluster of ceil(bm / ``TILE_ROWS``) blocks, one a
    column block, at most ``MAX_CLUSTER`` (past that each block takes
    every ``MAX_CLUSTER``-th column block)."""
    if bn <= TILE_ROWS and bm <= TILE_ROWS:
        return CompactPlan("one-pass", T, 1, T)
    items = T * -(-bn // TILE_ROWS)
    cluster = min(-(-bm // TILE_ROWS), MAX_CLUSTER)
    return CompactPlan("band", items, cluster, items * cluster)


@functools.cache
def _band_clusters_placeable(device: int, cluster: int) -> int:
    """Clusters of ``cluster`` band-kernel blocks the device can hold at
    once (0: it cannot place one)."""
    from repro_torch.kernels._build import extension

    with torch.cuda.device(device):
        return int(extension().pair_scores_compact_band_max_clusters(cluster))


def pair_scores_compact(a_g: torch.Tensor, b_g: torch.Tensor,
                        ida: torch.Tensor, idb: torch.Tensor,
                        threshold: float, capacity: int, bn: int, bm: int):
    """a_g: (T*bn, D) / b_g: (T*bm, D) contiguous f32 CUDA tensors with D a
    multiple of ``TILE_DEPTH``; ida: (T*bn, 1) / idb: (T*bm, 1) int32 ids,
    -1 on padding; any bn, bm >= 1.  Returns (rows (capacity + bn*bm, 1)
    int32, cols ditto, scores ditto f32, n_total (1, 1) int32), as
    :func:`..ref.pair_scores_compact_ref` does.  One launch
    (:func:`compact_plan`), after one zero-fill of its look-back words (an
    item's, and the ticket): each block, or past ``TILE_ROWS`` rows a side
    each cluster of blocks, takes an item (a tile, or a band of one) from a
    ticket, computes each of its products once and finds its base position
    by a decoupled look-back over the items before it.  Raises
    ``RuntimeError`` if the card cannot place the band kernel's
    cluster."""
    from repro_torch.kernels._build import extension

    for name, x, dt in (("a_g", a_g, torch.float32),
                        ("b_g", b_g, torch.float32),
                        ("ida", ida, torch.int32), ("idb", idb, torch.int32)):
        if not x.is_cuda or x.dtype != dt or x.dim() != 2 \
                or not x.is_contiguous() or x.device != a_g.device:
            raise ValueError(
                f"pair_scores_compact kernel needs {name} as a contiguous 2-D "
                f"{dt} tensor on one CUDA device, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if bn < 1 or bm < 1:
        raise ValueError(f"pair_scores_compact kernel takes tiles of at "
                         f"least one row a side, got bn={bn} bm={bm}")
    T, D = a_g.shape[0] // bn, a_g.shape[1]
    W = bn * bm
    if T < 1 or a_g.shape[0] != T * bn or b_g.shape != (T * bm, D) \
            or ida.shape != (T * bn, 1) or idb.shape != (T * bm, 1) \
            or D % TILE_DEPTH or a_g.data_ptr() % 16 or b_g.data_ptr() % 16 \
            or T * W >= INT32_LIMIT or not 0 <= capacity < INT32_LIMIT - W:
        raise ValueError(
            f"pair_scores_compact kernel shapes a_g {tuple(a_g.shape)} b_g "
            f"{tuple(b_g.shape)} ida {tuple(ida.shape)} idb "
            f"{tuple(idb.shape)} bn={bn} bm={bm} capacity={capacity}: at "
            f"least one tile, depth padded to {TILE_DEPTH}, 16-byte aligned, "
            "int32 positions")
    dev = a_g.device
    plan = compact_plan(T, bn, bm)
    if plan.kernel == "band":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        if not _band_clusters_placeable(index, plan.cluster):
            raise RuntimeError(
                f"pair_scores_compact: the card cannot place the band "
                f"kernel's cluster of {plan.cluster} blocks for tiles of "
                f"{bn} x {bm}")
    size = (int(capacity) + W, 1)
    rows = torch.full(size, -1, dtype=torch.int32, device=dev)
    cols = torch.full(size, -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(size, dtype=torch.float32, device=dev)
    n_total = torch.empty((1, 1), dtype=torch.int32, device=dev)
    # the items' look-back status words, then the ticket: zero every call
    status = torch.zeros(plan.items + 1, dtype=torch.int64, device=dev)
    extension().pair_scores_compact(a_g, b_g, ida, idb, status, rows, cols,
                                    scores, n_total, int(bn), int(bm),
                                    float(threshold), int(capacity))
    return rows, cols, scores, n_total
