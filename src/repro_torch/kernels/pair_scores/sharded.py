"""Candidate generation: the pair-score kernel across a (data, model) mesh,
a port of ``repro/kernels/pair_scores/sharded.py``.

The machine phase scores an N x M similarity grid.  On a mesh (DESIGN.md
§7) ``a``'s rows shard over ``data`` and ``b``'s over ``model``: rank
``(i, j)`` of a :class:`~repro_torch.launch.mesh.HostMesh` scores its
``(N/dd) x (M/dm)`` block with the ``pair_scores`` kernel on its own device
and compacts its candidates, in the reference's stable candidate-first
order with global row and column offsets, into a fixed-capacity buffer.
Only those buffers cross the mesh: they are gathered in rank order, the
layout of the reference's ``P("data", "model", None)`` out specs, so the
candidates come back in the reference's order for the same mesh shape.

A mesh call is collective, SPMD: every rank calls it with the same global
embeddings and every rank gets the same candidates.  ``mesh=None`` (or
``(1, 1)``) is one device, with no process group.

Capacity is per device and a counted contract: a device that finds more
than ``capacity`` candidates reports the overflow in ``n_dropped`` (summed
over the mesh), never a silent truncation.

:class:`StreamingCandidateIndex` is the incremental machine phase of
streaming ingest (DESIGN.md §11): it keeps the normalized corpus on the
device and scores only the cells each arrival epoch adds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import next_pow2
from repro_torch.device import DeviceLike, pick_device, same_device
from repro_torch.launch.mesh import all_gather, all_reduce, as_mesh

from .ops import l2_normalize, pair_scores


@dataclasses.dataclass
class ShardedCandidates:
    """Thresholded candidates (host numpy) gathered from the per-device
    compaction buffers."""

    rows: np.ndarray     # (C,) int32 global row (index into a)
    cols: np.ndarray     # (C,) int32 global col (index into b)
    scores: np.ndarray   # (C,) float32 similarity
    n_dropped: int       # candidates lost to per-device capacity overflow
    capacity: int = 0    # per-device capacity actually used

    @property
    def suggested_capacity(self) -> int:
        """Per-device capacity that provably fits this workload (every
        dropped candidate on one device), rounded up to the next power of
        two."""
        return next_pow2(self.capacity + self.n_dropped)


def _rank_block(a, b, mesh, threshold: float):
    """Pad as the reference's ``_pad_rows`` does and score this rank's
    block with the kernel.  Returns (block scores, counts, n_loc, m_loc,
    row offset, col offset)."""
    for name, x in (("a", a), ("b", b)):
        if not same_device(x.device, mesh.device):
            raise ValueError(f"{name} lies on {x.device}, the mesh rank's "
                             f"device is {mesh.device}")
    dd, dm = mesh.extent("data"), mesh.extent("model")
    a = F.pad(a, (0, 0, 0, (-a.shape[0]) % dd))
    b = F.pad(b, (0, 0, 0, (-b.shape[0]) % dm))
    n_loc, m_loc = a.shape[0] // dd, b.shape[0] // dm
    i0, j0 = mesh.index("data") * n_loc, mesh.index("model") * m_loc
    s, c = pair_scores(a[i0:i0 + n_loc], b[j0:j0 + m_loc], threshold,
                       normalize=False)
    return s, c, n_loc, m_loc, i0, j0


def sharded_candidates(a: torch.Tensor, b: torch.Tensor, threshold: float,
                       mesh=None, capacity: Optional[int] = None,
                       normalize: bool = True) -> ShardedCandidates:
    """Machine phase: embeddings -> thresholded candidate pairs.

    a: (N, D), b: (M, D), on the rank's device.  ``mesh`` is ``None`` (one
    device) or a :class:`~repro_torch.launch.mesh.HostMesh`; a mesh call is
    collective, and every rank passes the same global ``a`` and ``b``.
    ``capacity`` bounds each device's candidates (default: its whole block,
    i.e. lossless).  Requires ``threshold > 0`` so zero padding can never
    alias a real candidate."""
    if threshold <= 0.0:
        raise ValueError("sharded_candidates requires threshold > 0 "
                         "(padding rows score exactly 0)")
    mesh = as_mesh(mesh)
    if normalize:
        a = l2_normalize(a)
        b = l2_normalize(b)
    if mesh is None:
        N, M = a.shape[0], b.shape[0]
        cap = N * M if capacity is None else min(int(capacity), N * M)
        s, _ = pair_scores(a, b, threshold, normalize=False)
        rows, cols = torch.nonzero(s >= threshold, as_tuple=True)
        n_cand = int(rows.shape[0])
        rows, cols = rows[:cap], cols[:cap]
        return ShardedCandidates(
            rows=rows.to(torch.int32).cpu().numpy(),
            cols=cols.to(torch.int32).cpu().numpy(),
            scores=s[rows, cols].cpu().numpy().astype(np.float32),
            n_dropped=max(n_cand - cap, 0), capacity=cap)
    s, _, n_loc, m_loc, i0, j0 = _rank_block(a, b, mesh, threshold)
    cap = n_loc * m_loc if capacity is None \
        else min(int(capacity), n_loc * m_loc)
    # row-major nonzero is the reference's stable candidate-first order
    r, c = torch.nonzero(s >= threshold, as_tuple=True)
    n_cand = int(r.shape[0])
    r, c = r[:cap], c[:cap]
    k = int(r.shape[0])
    # one int32 buffer a rank: rows, cols, score bits (-1, -1, 0 past k),
    # then the dropped count
    buf = torch.zeros(3 * cap + 1, dtype=torch.int32, device=s.device)
    buf[:2 * cap] = -1
    buf[:k] = r.to(torch.int32) + i0
    buf[cap:cap + k] = c.to(torch.int32) + j0
    buf[2 * cap:2 * cap + k] = s[r, c].view(torch.int32)
    buf[3 * cap] = max(n_cand - cap, 0)
    every = all_gather(buf, mesh).cpu().numpy()
    rows = every[:, :cap].reshape(-1)
    keep = rows >= 0
    # zero-padded rows score 0 < threshold, so none is a candidate
    return ShardedCandidates(
        rows=rows[keep].astype(np.int32),
        cols=every[:, cap:2 * cap].reshape(-1)[keep].astype(np.int32),
        scores=every[:, 2 * cap:3 * cap].reshape(-1)[keep].view(np.float32),
        n_dropped=int(every[:, 3 * cap].sum()), capacity=cap)


def sharded_pair_scores(a: torch.Tensor, b: torch.Tensor, threshold: float,
                        mesh=None, normalize: bool = True):
    """The dense grid for parity testing and small grids: (scores (N, M)
    f32 zeroed below ``threshold``, counts (N, 1) int32), as
    :func:`.ops.pair_scores`.  On a mesh each rank scores its block with
    the kernel, the row counts are summed over the ``model`` axis (the
    reference's ``psum(cnt, "model")``) and gathered over ``data``, and the
    blocks are gathered over the whole mesh: every rank gets the grid."""
    mesh = as_mesh(mesh)
    if normalize:
        a = l2_normalize(a)
        b = l2_normalize(b)
    if mesh is None:
        return pair_scores(a, b, threshold, normalize=False)
    N, M = a.shape[0], b.shape[0]
    s, cnt, n_loc, m_loc, _, _ = _rank_block(a, b, mesh, threshold)
    cnt = all_reduce(cnt, mesh, "model")
    dd, dm = mesh.extent("data"), mesh.extent("model")
    grid = all_gather(s, mesh).reshape(dd, dm, n_loc, m_loc)
    grid = grid.permute(0, 2, 1, 3).reshape(dd * n_loc, dm * m_loc)
    cnt = all_gather(cnt, mesh, "data").reshape(dd * n_loc, 1)
    return grid[:N, :M], cnt[:N]


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

    With a ``mesh`` the dense epochs go through :func:`sharded_candidates`
    on it (``capacity`` is then per device), and :meth:`append` is
    collective: every rank appends the same rows and gets the same
    candidates.  The blocked path stays on the rank's device and ignores
    the mesh, as the reference's does.
    """

    def __init__(self, threshold: float, mesh=None,
                 capacity: Optional[int] = None, normalize: bool = True,
                 blocking=None, device: DeviceLike = None):
        if threshold <= 0.0:
            raise ValueError("StreamingCandidateIndex requires threshold > 0 "
                             "(padding rows score exactly 0)")
        self.threshold = float(threshold)
        self.mesh = as_mesh(mesh)
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
