"""Candidate generation: the pair-score kernel plus compaction into
candidate triples (the single-device case of
``repro/kernels/pair_scores/sharded.py``).

The kernel scores the whole (N, M) grid with the threshold fused in; the
candidates are then compacted outside the kernel, as in the reference:
row-major ``torch.nonzero`` over the thresholded block gives the same stable
candidate-first order as the reference's stable argsort, truncated to
``capacity``.  Overflow is a counted contract (``n_dropped``), never a silent
truncation.  Only a 1 x 1 mesh is ported; the multi-GPU mesh is ROADMAP A8.

:class:`StreamingCandidateIndex` is the incremental machine phase of
streaming ingest (DESIGN.md §11): it keeps the normalized corpus on the
device and scores only the cells each arrival epoch adds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import next_pow2
from repro_torch.device import DeviceLike, pick_device

from .ops import l2_normalize, pair_scores


@dataclasses.dataclass
class ShardedCandidates:
    """Thresholded candidates (host numpy) from the compaction buffer."""

    rows: np.ndarray     # (C,) int32 row (index into a)
    cols: np.ndarray     # (C,) int32 col (index into b)
    scores: np.ndarray   # (C,) float32 similarity
    n_dropped: int       # candidates lost to capacity overflow
    capacity: int = 0    # capacity actually used

    @property
    def suggested_capacity(self) -> int:
        """Capacity that provably fits this workload, rounded up to the next
        power of two."""
        return next_pow2(self.capacity + self.n_dropped)


def _check_mesh(mesh: Optional[Tuple[int, int]]) -> None:
    if mesh is not None and tuple(mesh) != (1, 1):
        raise NotImplementedError(
            f"mesh {mesh!r}: only a single device (mesh=None or (1, 1)) is "
            "ported; the multi-GPU (data, model) mesh is ROADMAP A8")


def sharded_candidates(a: torch.Tensor, b: torch.Tensor, threshold: float,
                       mesh: Optional[Tuple[int, int]] = None,
                       capacity: Optional[int] = None,
                       normalize: bool = True) -> ShardedCandidates:
    """Machine phase: embeddings -> thresholded candidate pairs.

    a: (N, D), b: (M, D) on one device.  ``mesh`` is ``None`` or the
    ``(data, model)`` extents ``(1, 1)``.  ``capacity`` bounds the
    candidates kept (default: the whole block, i.e. lossless).  Requires
    ``threshold > 0`` so zero padding can never alias a real candidate."""
    if threshold <= 0.0:
        raise ValueError("sharded_candidates requires threshold > 0 "
                         "(padding rows score exactly 0)")
    _check_mesh(mesh)
    N, M = a.shape[0], b.shape[0]
    if normalize:
        a = l2_normalize(a)
        b = l2_normalize(b)
    cap = N * M if capacity is None else min(int(capacity), N * M)
    s, _ = pair_scores(a, b, threshold, normalize=False)
    rows, cols = torch.nonzero(s >= threshold, as_tuple=True)
    n_cand = int(rows.shape[0])
    rows, cols = rows[:cap], cols[:cap]
    scores = s[rows, cols]
    return ShardedCandidates(
        rows=rows.to(torch.int32).cpu().numpy(),
        cols=cols.to(torch.int32).cpu().numpy(),
        scores=scores.cpu().numpy().astype(np.float32),
        n_dropped=max(n_cand - cap, 0),
        capacity=cap,
    )


# ---------------------------------------------------------------------------
# Streaming ingest: incremental candidate generation (DESIGN.md §11)
# ---------------------------------------------------------------------------
class StreamingCandidateIndex:
    """Incremental machine phase for streaming arrivals (DESIGN.md §11).

    The one-shot :func:`sharded_candidates` scores the full N x M cross
    product; under streaming ingest that cost is paid again on every
    arrival.  This index keeps the normalized corpus on ``device`` and, per
    :meth:`append` of new ``a`` and/or ``b`` rows, scores only the blocks a
    full re-run would add, ``new_a x (b_old + b_new)`` then ``a_old x
    new_b``, each through :func:`sharded_candidates` (the ``pair_scores``
    kernel on the card) with the caller's ``capacity`` a block.  Appended
    rows keep global indices (offset past the cached corpus), so the union
    of every epoch's candidates equals one :func:`sharded_candidates` call
    over the final corpora; on the card a cell's score depends only on its
    two rows (the kernel sums each cell in one fixed order), so the union is
    equal bit for bit.

    ``pairs_scored`` counts grid cells actually scored; ``full_rescore_pairs``
    what re-scoring from scratch every epoch would have scored.

    With a ``blocking`` config (DESIGN.md §12) arrivals hash into the
    existing LSH buckets (the signatures are deterministic in the seed; the
    corpus's ``(n_tables, N)`` codes are cached on the host), and only tiles
    of buckets an arrival touched reach ``pair_scores_compact``.
    """

    def __init__(self, threshold: float,
                 mesh: Optional[Tuple[int, int]] = None,
                 capacity: Optional[int] = None, normalize: bool = True,
                 blocking=None, device: DeviceLike = None):
        if threshold <= 0.0:
            raise ValueError("StreamingCandidateIndex requires threshold > 0 "
                             "(padding rows score exactly 0)")
        _check_mesh(mesh)
        self.threshold = float(threshold)
        self.mesh = mesh
        self.capacity = capacity
        self.normalize = normalize
        self.blocking = blocking
        self.device = pick_device(device)
        # the cached normalized corpus, on the device
        self._a = torch.zeros((0, 0), dtype=torch.float32, device=self.device)
        self._b = torch.zeros((0, 0), dtype=torch.float32, device=self.device)
        # the corpus's (n_tables, N) signature codes, on the host (blocking)
        n_tables = blocking.n_tables if blocking is not None else 0
        self._codes_a = np.zeros((n_tables, 0), np.int64)
        self._codes_b = np.zeros((n_tables, 0), np.int64)
        self.pairs_scored = 0        # grid cells the incremental path scored
        self.full_rescore_pairs = 0  # cells full per-epoch re-runs would score
        self._undo = None            # pre-append snapshot (rollback_append)

    @property
    def n_a(self) -> int:
        return self._a.shape[0]

    @property
    def n_b(self) -> int:
        return self._b.shape[0]

    def _norm(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        x = torch.as_tensor(x).to(self.device, torch.float32)
        return l2_normalize(x) if self.normalize else x

    @staticmethod
    def _grown(old: torch.Tensor, new: Optional[torch.Tensor]
               ) -> torch.Tensor:
        if new is None or not len(new):
            return old
        return new if old.shape[0] == 0 else torch.cat([old, new])

    def _block(self, a: torch.Tensor, b: torch.Tensor, row0: int,
               col0: int) -> ShardedCandidates:
        """Score one (already normalized) block; offset indices to global."""
        self.pairs_scored += a.shape[0] * b.shape[0]
        cand = sharded_candidates(a, b, self.threshold, self.mesh,
                                  capacity=self.capacity, normalize=False)
        return ShardedCandidates(
            rows=cand.rows + np.int32(row0), cols=cand.cols + np.int32(col0),
            scores=cand.scores, n_dropped=cand.n_dropped,
            capacity=cand.capacity)

    def rollback_append(self) -> None:
        """Undo the most recent :meth:`append`: the corpus, the codes and
        the work counters revert to their values before it.  For callers
        that reject an epoch after scoring it (on capacity overflow): the
        index must not remember rows whose candidates were never ingested,
        or every later epoch would score against (and skip) them."""
        if self._undo is None:
            raise RuntimeError("no append to roll back")
        (self._a, self._b, self._codes_a, self._codes_b,
         self.pairs_scored, self.full_rescore_pairs) = self._undo
        self._undo = None

    def _append_blocked(self, na: Optional[torch.Tensor],
                        nb: Optional[torch.Tensor]):
        """Blocked epoch: hash the arrivals into the existing buckets and
        score only the colliding tiles.  The dense path's cell coverage,
        ``new_a x b_full`` then ``a_old x new_b``, restricted per group to
        bucket collisions, so the union over epochs equals one
        :func:`blocking.blocked_candidates` call over the final corpora."""
        from .blocking import (BlockedCandidates, block_pairs,
                               score_block_pairs, signatures)

        cfg = self.blocking
        n0, m0 = self.n_a, self.n_b
        dn = len(na) if na is not None else 0
        dm = len(nb) if nb is not None else 0
        ca_new = (signatures(na, cfg) if dn
                  else np.zeros((cfg.n_tables, 0), np.int64))
        cb_new = (signatures(nb, cfg) if dm
                  else np.zeros((cfg.n_tables, 0), np.int64))
        a_full = self._grown(self._a, na)
        b_full = self._grown(self._b, nb)
        codes_a = np.concatenate([self._codes_a, ca_new], axis=1)
        codes_b = np.concatenate([self._codes_b, cb_new], axis=1)
        parts = []
        if dn and (m0 + dm):
            ta, tb = block_pairs(codes_a, np.arange(n0, n0 + dn),
                                 codes_b, np.arange(m0 + dm),
                                 cfg.bn, cfg.bm)
            parts.append(score_block_pairs(
                a_full, b_full, ta, tb, self.threshold, cfg,
                capacity=self.capacity))
        if dm and n0:
            ta, tb = block_pairs(codes_a, np.arange(n0),
                                 codes_b, np.arange(m0, m0 + dm),
                                 cfg.bn, cfg.bm)
            parts.append(score_block_pairs(
                a_full, b_full, ta, tb, self.threshold, cfg,
                capacity=self.capacity))
        self._a, self._b = a_full, b_full
        self._codes_a, self._codes_b = codes_a, codes_b
        self.pairs_scored += sum(p.cells_scored for p in parts)
        self.full_rescore_pairs += self.n_a * self.n_b
        # the two groups are row-disjoint (group 1 rows >= n0, group 2
        # rows < n0) and each call dedups cross-table re-finds, so a plain
        # concatenation is already duplicate-free

        def cat(field, dtype):
            return (np.concatenate([getattr(p, field) for p in parts])
                    if parts else np.zeros(0, dtype))

        return BlockedCandidates(
            rows=cat("rows", np.int32), cols=cat("cols", np.int32),
            scores=cat("scores", np.float32),
            n_dropped=sum(p.n_dropped for p in parts),
            capacity=(max(p.capacity for p in parts) if parts
                      else (self.capacity or 0)),
            cells_scored=sum(p.cells_scored for p in parts),
            padded_cells=sum(p.padded_cells for p in parts),
            dense_cells=dn * (m0 + dm) + n0 * dm,
            n_tiles=sum(p.n_tiles for p in parts),
            n_duplicates=sum(p.n_duplicates for p in parts),
        )

    def append(self, new_a=None, new_b=None) -> ShardedCandidates:
        """Ingest new rows and return only the new candidate pairs: every
        (row, col) with at least one appended endpoint that scores at or
        above the threshold, with global indices into the grown corpora.
        The rows move to the index's device."""
        self._undo = (self._a, self._b, self._codes_a, self._codes_b,
                      self.pairs_scored, self.full_rescore_pairs)
        na = self._norm(new_a)
        nb = self._norm(new_b)
        if self.blocking is not None:
            return self._append_blocked(na, nb)
        n0, m0 = self.n_a, self.n_b
        blocks = []
        # new_a against the full post-append b corpus (old + new cols), then
        # the old a corpus against new_b: covers each new cell exactly once
        b_full = self._grown(self._b, nb)
        if na is not None and len(na) and len(b_full):
            blocks.append(self._block(na, b_full, n0, 0))
        if nb is not None and len(nb) and n0:
            blocks.append(self._block(self._a, nb, 0, m0))
        self._a = self._grown(self._a, na)
        self._b = b_full
        self.full_rescore_pairs += self.n_a * self.n_b
        if not blocks:
            return ShardedCandidates(
                rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
                scores=np.zeros(0, np.float32), n_dropped=0,
                capacity=self.capacity or 0)
        return ShardedCandidates(
            rows=np.concatenate([c.rows for c in blocks]),
            cols=np.concatenate([c.cols for c in blocks]),
            scores=np.concatenate([c.scores for c in blocks]),
            n_dropped=sum(c.n_dropped for c in blocks),
            capacity=max(c.capacity for c in blocks),
        )
