"""LSH blocking + fused candidate generation (a port of
``repro/kernels/pair_scores/blocking.py``, DESIGN.md §12).

The dense machine phase scores every cell of the N x M similarity grid.
Blocking puts an LSH stage in front of the scorer: sign-random-projection
hashes put every row into ``n_bits``-bit bucket codes across ``n_tables``
independent tables, and only (a-row, b-row) pairs that collide in at least
one table's bucket reach the kernel.  Colliding buckets are chunked into
(bn x bm) tiles, gathered on the device and streamed through
``pair_scores_compact``, which fuses similarity, threshold and compaction,
so the dense score matrix never exists.

The host side — signatures and bucket tiling — is the reference's numpy,
copied, so the codes and tile lists are identical to the reference's for the
same normalized input.  For unit vectors with cosine ``s`` a pair survives
one table with ``p(s)^n_bits``, ``p(s) = 1 - acos(s)/pi``, and is captured
with ``1 - (1 - p(s)^n_bits)^n_tables`` (:func:`expected_recall`);
:meth:`BlockingConfig.for_recall` sizes the table count for a floor at the
threshold.

Candidates keep the :class:`ShardedCandidates` contract (capacity is hard,
overflow is counted, ``suggested_capacity`` provably fits), extended with
the blocking accounting (cells scored against dense cells, tiles,
duplicates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import next_pow2

from .ops import l2_normalize, pair_scores_compact
from .sharded import ShardedCandidates


@dataclasses.dataclass(frozen=True)
class BlockingConfig:
    """Blocking-stage knobs: LSH shape, kernel tiling, and bookkeeping.

    ``n_bits`` hyperplanes per table (finer buckets = fewer cells scored,
    lower per-table recall); ``n_tables`` independent tables (each adds a
    capture chance); ``seed`` fixes the hyperplanes.  ``bn``/``bm`` are the
    kernel tile shape (any size from 1; past 128 a side the card runs the
    band kernel, see :func:`.kernel.compact_plan`); ``tiles_per_call``
    bounds device buffers by splitting long tile lists into fixed-shape
    kernel calls.  ``recall_floor`` records what :meth:`for_recall` was
    asked for."""

    n_bits: int = 8
    n_tables: int = 8
    seed: int = 0
    bn: int = 128
    bm: int = 128
    tiles_per_call: int = 256
    recall_floor: Optional[float] = None

    def __post_init__(self):
        if not 1 <= self.n_bits <= 30:
            raise ValueError(
                f"n_bits must be in [1, 30] (codes pack into int64 and "
                f"2**30 buckets is already past any useful grain), got "
                f"{self.n_bits}")
        if self.n_tables < 1:
            raise ValueError(f"n_tables must be >= 1, got {self.n_tables}")
        if self.bn < 1 or self.bm < 1 or self.tiles_per_call < 1:
            raise ValueError(
                f"tile shape and tiles_per_call must be positive, got "
                f"bn={self.bn} bm={self.bm} "
                f"tiles_per_call={self.tiles_per_call}")

    @classmethod
    def for_recall(cls, floor: float, threshold: float, n_bits: int = 8,
                   max_tables: int = 256, **kwargs) -> "BlockingConfig":
        """Smallest table count whose analytic capture probability at the
        threshold clears ``floor`` with headroom.  Raises when the floor is
        unreachable within ``max_tables`` — lower ``n_bits``."""
        if not 0.0 < floor < 1.0:
            raise ValueError(f"recall floor must be in (0, 1), got {floor}")
        p = _collision_prob(threshold) ** n_bits
        if p <= 0.0:
            raise ValueError(
                f"threshold {threshold} gives zero per-table collision "
                "probability — no table count can reach the floor")
        target = 1.0 - (1.0 - floor) / 20.0
        n_tables = max(1, math.ceil(math.log(1.0 - target)
                                    / math.log(1.0 - p)))
        if n_tables > max_tables:
            raise ValueError(
                f"recall floor {floor} at threshold {threshold} needs "
                f"{n_tables} tables (> max_tables={max_tables}) with "
                f"n_bits={n_bits} — use fewer bits per table")
        return cls(n_bits=n_bits, n_tables=n_tables, recall_floor=floor,
                   **kwargs)


def _collision_prob(s: float) -> float:
    """P[one random hyperplane keeps a pair with cosine similarity s]."""
    return 1.0 - math.acos(min(max(s, -1.0), 1.0)) / math.pi


def expected_recall(config: BlockingConfig, similarity: float) -> float:
    """Analytic capture probability of a pair at the given similarity — the
    blocker's expected recall at the threshold (its worst case)."""
    p = _collision_prob(similarity) ** config.n_bits
    return 1.0 - (1.0 - p) ** config.n_tables


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def signatures(x, config: BlockingConfig) -> np.ndarray:
    """(n_tables, N) int64 bucket codes: sign bits of ``n_bits`` seeded
    random hyperplane projections, packed per table, computed on the host.
    Deterministic in (seed, D, n_bits, n_tables) alone.  Feed the
    normalized embeddings."""
    x = _host(x)
    rng = np.random.default_rng(config.seed)
    planes = rng.normal(
        size=(config.n_tables, x.shape[1], config.n_bits)).astype(np.float32)
    bits = np.einsum("nd,ldb->lnb", x, planes) >= 0.0
    weights = (np.int64(1) << np.arange(config.n_bits, dtype=np.int64))
    return bits @ weights


def _pad_chunks(rows: np.ndarray, tile: int) -> np.ndarray:
    """Chunk a bucket's member rows into (t, tile) with -1 padding."""
    n = len(rows)
    t = -(-n // tile)
    out = np.full((t, tile), -1, np.int64)
    out.reshape(-1)[:n] = rows
    return out


def block_pairs(codes_a: np.ndarray, idx_a: np.ndarray,
                codes_b: np.ndarray, idx_b: np.ndarray,
                bn: int, bm: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tile pairs for every bucket collision between the given row subsets.

    ``codes_a``/``codes_b`` are signature tables (n_tables, N) / (n_tables,
    M); ``idx_a``/``idx_b`` select the global rows that take part.  Returns
    (tiles_a (T, bn), tiles_b (T, bm)) int64 global row indices, -1 padded:
    tile pair t scores every (row of tiles_a[t]) x (row of tiles_b[t])."""
    idx_a = np.asarray(idx_a, np.int64)
    idx_b = np.asarray(idx_b, np.int64)
    tiles_a: List[np.ndarray] = []
    tiles_b: List[np.ndarray] = []
    if len(idx_a) == 0 or len(idx_b) == 0:
        return (np.zeros((0, bn), np.int64), np.zeros((0, bm), np.int64))
    for table in range(codes_a.shape[0]):
        ca = codes_a[table, idx_a]
        cb = codes_b[table, idx_b]
        oa = np.argsort(ca, kind="stable")
        ob = np.argsort(cb, kind="stable")
        ua, sa, na = np.unique(ca[oa], return_index=True, return_counts=True)
        ub, sb, nb = np.unique(cb[ob], return_index=True, return_counts=True)
        shared, ia, ib = np.intersect1d(ua, ub, assume_unique=True,
                                        return_indices=True)
        for k in range(len(shared)):
            rows = idx_a[oa[sa[ia[k]]:sa[ia[k]] + na[ia[k]]]]
            cols = idx_b[ob[sb[ib[k]]:sb[ib[k]] + nb[ib[k]]]]
            ra = _pad_chunks(rows, bn)
            rb = _pad_chunks(cols, bm)
            tiles_a.append(ra[np.repeat(np.arange(len(ra)), len(rb))])
            tiles_b.append(rb[np.tile(np.arange(len(rb)), len(ra))])
    if not tiles_a:
        return (np.zeros((0, bn), np.int64), np.zeros((0, bm), np.int64))
    return np.concatenate(tiles_a), np.concatenate(tiles_b)


@dataclasses.dataclass
class BlockedCandidates(ShardedCandidates):
    """ShardedCandidates plus the blocking accounting."""

    cells_scored: int = 0    # genuine (row, col) cells the tiles covered
    padded_cells: int = 0    # kernel work actually issued (incl. padding)
    dense_cells: int = 0     # what the dense path would have scored
    n_tiles: int = 0
    n_duplicates: int = 0    # cross-table re-finds removed by dedup

    @property
    def cells_saved_frac(self) -> float:
        if self.dense_cells == 0:
            return 0.0
        return 1.0 - self.cells_scored / self.dense_cells


def _score_chunks(a: torch.Tensor, b: torch.Tensor, tiles_a: np.ndarray,
                  tiles_b: np.ndarray, threshold: float, bn: int, bm: int,
                  chunk: int, cap: int):
    """Gather each chunk of tile pairs on the device, run the compact kernel
    on it, and copy the kept prefix to the host.  Returns (rows, cols,
    scores) host arrays in tile order, and the true candidate count."""
    N, D = a.shape
    M = b.shape[0]
    dev = a.device
    c_call = min(cap, chunk * bn * bm)
    # padding rows gather the appended zero vector (index N / M)
    a_ext = torch.cat([a, a.new_zeros((1, D))])
    b_ext = torch.cat([b, b.new_zeros((1, D))])
    rows_acc: List[np.ndarray] = []
    cols_acc: List[np.ndarray] = []
    scores_acc: List[np.ndarray] = []
    kept_total = 0
    found_total = 0
    for t0 in range(0, tiles_a.shape[0], chunk):
        ta = tiles_a[t0:t0 + chunk]
        tb = tiles_b[t0:t0 + chunk]
        ga = torch.from_numpy(np.where(ta < 0, N, ta).reshape(-1)).to(dev)
        gb = torch.from_numpy(np.where(tb < 0, M, tb).reshape(-1)).to(dev)
        ida = torch.from_numpy(ta.reshape(-1, 1).astype(np.int32)).to(dev)
        idb = torch.from_numpy(tb.reshape(-1, 1).astype(np.int32)).to(dev)
        rows, cols, scores, n_tot = pair_scores_compact(
            a_ext[ga], b_ext[gb], ida, idb, float(threshold), c_call, bn, bm)
        n_found = int(n_tot[0, 0])
        found_total += n_found
        keep = min(n_found, c_call, cap - kept_total)
        if keep > 0:
            rows_acc.append(rows[:keep, 0].cpu().numpy())
            cols_acc.append(cols[:keep, 0].cpu().numpy())
            scores_acc.append(scores[:keep, 0].cpu().numpy())
            kept_total += keep
    rows = (np.concatenate(rows_acc) if rows_acc
            else np.zeros(0, np.int64)).astype(np.int64)
    cols = (np.concatenate(cols_acc) if cols_acc
            else np.zeros(0, np.int64)).astype(np.int64)
    scores = (np.concatenate(scores_acc) if scores_acc
              else np.zeros(0, np.float32))
    return rows, cols, scores, found_total


def _dedup(rows: np.ndarray, cols: np.ndarray, scores: np.ndarray, M: int):
    """Cross-table dedup: a pair colliding in several tables is scored in
    each (same gathered rows, so the same score) and kept once.  Returns
    (rows, cols, scores) sorted by ``row * M + col``, and the duplicates
    removed."""
    keys = rows * np.int64(M) + cols
    _, first = np.unique(keys, return_index=True)
    return (rows[first].astype(np.int32), cols[first].astype(np.int32),
            scores[first].astype(np.float32), len(rows) - len(first))


def score_block_pairs(a: torch.Tensor, b: torch.Tensor, tiles_a: np.ndarray,
                      tiles_b: np.ndarray, threshold: float,
                      config: BlockingConfig,
                      capacity: Optional[int] = None) -> BlockedCandidates:
    """Stream the tile list through the fused kernel on the tensors' device
    and gather the compacted candidates.  ``a``/``b`` must already be
    L2-normalized; the caller owns bucket construction
    (:func:`block_pairs`).

    ``capacity`` bounds the total kept candidates across the whole tile list
    (default: lossless).  Tile lists longer than ``config.tiles_per_call``
    are split into fixed-shape kernel calls, each keeping at most
    ``min(capacity, chunk_cells)`` candidates."""
    if threshold <= 0.0:
        raise ValueError("score_block_pairs requires threshold > 0 "
                         "(padding rows score exactly 0)")
    bn, bm = config.bn, config.bm
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    N, M = a.shape[0], b.shape[0]
    T = tiles_a.shape[0]
    cells_scored = int(((tiles_a >= 0).sum(axis=1)
                        * (tiles_b >= 0).sum(axis=1)).sum()) if T else 0
    cap = T * bn * bm if capacity is None else int(capacity)
    if T == 0 or cap <= 0:
        return BlockedCandidates(
            rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
            scores=np.zeros(0, np.float32), n_dropped=0, capacity=cap,
            cells_scored=cells_scored, padded_cells=0,
            dense_cells=N * M, n_tiles=T)
    # fixed-shape chunks: pad the tile list with all-padding tiles
    chunk = min(config.tiles_per_call, next_pow2(T, floor=1))
    t_pad = (-T) % chunk
    if t_pad:
        tiles_a = np.concatenate(
            [tiles_a, np.full((t_pad, bn), -1, np.int64)])
        tiles_b = np.concatenate(
            [tiles_b, np.full((t_pad, bm), -1, np.int64)])
    rows, cols, scores, found_total = _score_chunks(
        a, b, tiles_a, tiles_b, threshold, bn, bm, chunk, cap)
    n_dropped = found_total - len(rows)
    rows, cols, scores, n_dup = _dedup(rows, cols, scores, M)
    return BlockedCandidates(
        rows=rows, cols=cols, scores=scores, n_dropped=n_dropped,
        capacity=cap, cells_scored=cells_scored,
        padded_cells=int(tiles_a.shape[0]) * bn * bm, dense_cells=N * M,
        n_tiles=T, n_duplicates=n_dup)


def blocked_candidates(a: torch.Tensor, b: torch.Tensor, threshold: float,
                       config: Optional[BlockingConfig] = None,
                       capacity: Optional[int] = None,
                       normalize: bool = True) -> BlockedCandidates:
    """Blocked machine phase: embeddings -> thresholded candidate pairs
    without scoring (or materializing) the dense N x M grid.  Hash both
    sides into LSH buckets on the host, tile every bucket collision, and
    stream the tiles through the fused kernel on the tensors' device.
    Pairs the blocker never buckets together are the recall cost — size
    ``config`` with :meth:`BlockingConfig.for_recall`, measure with
    :func:`blocker_recall`."""
    config = config or BlockingConfig()
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    if normalize:
        a = l2_normalize(a)
        b = l2_normalize(b)
    codes_a = signatures(a, config)
    codes_b = signatures(b, config)
    tiles_a, tiles_b = block_pairs(
        codes_a, np.arange(a.shape[0]), codes_b, np.arange(b.shape[0]),
        config.bn, config.bm)
    return score_block_pairs(a, b, tiles_a, tiles_b, threshold, config,
                             capacity=capacity)


def blocker_recall(cand, a: torch.Tensor, b: torch.Tensor, threshold: float,
                   row_sample: Optional[np.ndarray] = None,
                   col_chunk: int = 8192) -> Tuple[float, int]:
    """Measured recall of a candidate set against the dense candidates of a
    subsample of a-rows, scored in column chunks with plain torch on the
    tensors' device (never more than ``len(row_sample) * col_chunk`` cells
    live).  Returns (recall, n_dense_candidates_in_sample); an empty dense
    set counts as recall 1.0."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    M = b.shape[0]
    rows = (np.arange(a.shape[0]) if row_sample is None
            else np.asarray(row_sample, np.int64))
    cand_keys = np.sort(np.asarray(cand.rows, np.int64) * np.int64(M)
                        + np.asarray(cand.cols, np.int64))
    a_s = a[torch.from_numpy(rows).to(a.device)]
    n_dense = 0
    n_hit = 0
    for c0 in range(0, M, col_chunk):
        s = a_s @ b[c0:c0 + col_chunk].T
        ri, ci = np.nonzero((s >= threshold).cpu().numpy())
        keys = rows[ri] * np.int64(M) + (ci + c0)
        n_dense += len(keys)
        n_hit += int(np.isin(keys, cand_keys, assume_unique=False).sum())
    return (1.0 if n_dense == 0 else n_hit / n_dense), n_dense


def dense_block_pairs(n: int, m: int, bn: int, bm: int) -> Tuple[np.ndarray,
                                                                 np.ndarray]:
    """Tile pairs covering the full N x M grid — the degenerate blocking
    (everything in one bucket) the kernel-vs-dense exactness checks use."""
    ra = _pad_chunks(np.arange(n, dtype=np.int64), bn)
    rb = _pad_chunks(np.arange(m, dtype=np.int64), bm)
    return (ra[np.repeat(np.arange(len(ra)), len(rb))],
            rb[np.tile(np.arange(len(rb)), len(ra))])
