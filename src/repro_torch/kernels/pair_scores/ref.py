"""Plain PyTorch versions of the pair-score kernels: the dense thresholded
score matrix (``pair_scores_ref``), the dense candidate list
(``candidates_ref``) and the compacted candidates of gathered tile pairs
(``pair_scores_compact_ref``).  The CPU path of :mod:`.ops` and the
yardsticks the CUDA kernels are held against on the card."""
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


def pair_scores_compact_ref(a_g: torch.Tensor, b_g: torch.Tensor,
                            ida: torch.Tensor, idb: torch.Tensor,
                            threshold: float, capacity: int, bn: int,
                            bm: int):
    """Similarity, threshold and compaction over T gathered tile pairs.

    a_g: (T*bn, D) / b_g: (T*bm, D) — tile t's rows at [t*bn, (t+1)*bn);
    ida: (T*bn, 1) / idb: (T*bm, 1) int32 global ids, -1 on padding.
    Returns (rows (capacity + bn*bm, 1) int32, cols ditto, scores ditto f32,
    n_total (1, 1) int32).  The candidates come in tile order, then
    row-major within a tile; [0, min(n_total, capacity)) holds the first of
    them and [n_total, capacity) holds -1 / -1 / 0.0.  ``n_total`` is the
    true count; the trailing bn*bm rows are slack."""
    T, D = a_g.shape[0] // bn, a_g.shape[1]
    s = torch.bmm(a_g.to(torch.float32).reshape(T, bn, D),
                  b_g.to(torch.float32).reshape(T, bm, D).transpose(1, 2))
    ra = ida.reshape(T, bn)
    cb = idb.reshape(T, bm)
    mask = (s >= threshold) & (ra[:, :, None] >= 0) & (cb[:, None, :] >= 0)
    t, r, c = torch.nonzero(mask, as_tuple=True)
    n_total = int(t.shape[0])
    keep = min(n_total, int(capacity))
    t, r, c = t[:keep], r[:keep], c[:keep]
    size = (int(capacity) + bn * bm, 1)
    dev = a_g.device
    rows = torch.full(size, -1, dtype=torch.int32, device=dev)
    cols = torch.full(size, -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(size, dtype=torch.float32, device=dev)
    rows[:keep, 0] = ra[t, r].to(torch.int32)
    cols[:keep, 0] = cb[t, c].to(torch.int32)
    scores[:keep, 0] = s[t, r, c]
    return (rows, cols, scores,
            torch.full((1, 1), n_total, dtype=torch.int32, device=dev))
