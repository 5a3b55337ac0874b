"""Result-quality metrics (§6.4): precision / recall / F-measure over the
join result, and the transitive-consistency check (the port's copy of
``repro/core/metrics.py``).  Host-side numpy."""
from __future__ import annotations

import dataclasses

import numpy as np

from .pairs import PairSet


@dataclasses.dataclass
class Quality:
    precision: float
    recall: float
    f_measure: float
    tp: int
    fp: int
    fn: int


def _find(parent: list, x: int) -> int:
    root = x
    while parent[root] != root:
        root = parent[root]
    while parent[x] != root:  # path compression
        parent[x], x = root, parent[x]
    return root


def transitively_consistent(candidate: PairSet,
                            predicted_match: np.ndarray) -> bool:
    """True iff the predicted labels admit a consistent clustering: no pair
    labeled non-matching has both endpoints inside one matching-closure
    cluster."""
    predicted_match = np.asarray(predicted_match, bool)
    parent = list(range(candidate.n_objects))
    for i in np.nonzero(predicted_match)[0]:
        ra = _find(parent, int(candidate.u[i]))
        rb = _find(parent, int(candidate.v[i]))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return all(_find(parent, int(candidate.u[i]))
               != _find(parent, int(candidate.v[i]))
               for i in np.nonzero(~predicted_match)[0])


def quality(candidate: PairSet, predicted_match: np.ndarray,
            total_true_matches: int) -> Quality:
    """Precision over predicted matches; recall against every true match of
    the dataset, including those the machine phase filtered out."""
    if candidate.truth is None:
        raise ValueError("quality needs the candidates' ground truth")
    tp = int((predicted_match & candidate.truth).sum())
    fp = int((predicted_match & ~candidate.truth).sum())
    fn = total_true_matches - tp
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f = 2 * prec * rec / max(prec + rec, 1e-12)
    return Quality(prec, rec, f, tp, fp, fn)
