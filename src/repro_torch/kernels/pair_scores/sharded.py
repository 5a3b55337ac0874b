"""Candidate generation: the pair-score kernel plus compaction into
candidate triples (the single-device case of
``repro/kernels/pair_scores/sharded.py``).

The kernel scores the whole (N, M) grid with the threshold fused in; the
candidates are then compacted outside the kernel, as in the reference:
row-major ``torch.nonzero`` over the thresholded block gives the same stable
candidate-first order as the reference's stable argsort, truncated to
``capacity``.  Overflow is a counted contract (``n_dropped``), never a silent
truncation.  Only a 1 x 1 mesh is ported; the multi-GPU mesh is ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import next_pow2

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
