"""Plain PyTorch versions of the pair-score kernel: the dense thresholded
score matrix (``pair_scores_ref``) and the dense candidate list
(``candidates_ref``).  The CPU path of :mod:`.ops` and the yardstick the
CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def pair_scores_ref(a: torch.Tensor, b: torch.Tensor, threshold: float):
    """Similarity of every (row of a, row of b) pair.

    a: (N, D), b: (M, D) — L2-normalized embeddings.  Returns (scores (N, M)
    f32 zeroed below threshold, counts (N,) int32 of above-threshold
    candidates per row of a)."""
    s = a.to(torch.float32) @ b.to(torch.float32).T
    mask = s >= threshold
    return torch.where(mask, s, 0.0), mask.sum(1, dtype=torch.int32)


def candidates_ref(a: torch.Tensor, b: torch.Tensor, threshold: float):
    """Every (i, j) with similarity >= threshold, in row-major order.
    Returns (rows (C,) int32, cols (C,) int32, scores (C,) f32)."""
    s = a.to(torch.float32) @ b.to(torch.float32).T
    rows, cols = torch.nonzero(s >= threshold, as_tuple=True)
    return rows.to(torch.int32), cols.to(torch.int32), s[rows, cols]
