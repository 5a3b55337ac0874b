"""Parallel labeling (§5) — Algorithms 2 & 3, the port's copy of the host
labelers of ``repro/core/parallel.py``.

``parallel_crowdsourced_pairs`` (Algorithm 3): scan the sorted pairs through
a fresh ClusterGraph; labeled pairs are inserted with their real label; an
unlabeled pair that is *not* deducible (under the optimistic assumption
that every unlabeled pair before it is matching) is emitted for
crowdsourcing and inserted as matching.  Every emitted pair must be
crowdsourced *no matter how* the in-flight pairs resolve, so the whole set
can be published at once.

``label_parallel`` (Algorithm 2): iterate selection -> crowdsource batch ->
deduction sweep, until every pair is labeled.  Labels are the engine codes
``POS`` / ``NEG``.  The stream and wall-clock simulators of the reference
module are not ported yet (ROADMAP A9.2).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from .cluster_graph import POS, ClusterGraph
from .crowd import Crowd
from .labeling import LabelingResult
from .pairs import PairSet


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------
def parallel_crowdsourced_pairs(
    pairs: PairSet,
    order: np.ndarray,
    known: Dict[int, int],
    exclude: Optional[Set[int]] = None,
) -> List[int]:
    """Returns pair indices that can be crowdsourced in parallel.

    ``known``   — labels already obtained (crowdsourced or deduced).
    ``exclude`` — already-published in-flight pairs: the instant-decision
    change (§5.2) removes them from the output set, but they still
    participate in the scan as assumed-matching (they are guaranteed
    crowdsourced pairs).
    """
    g = ClusterGraph(pairs.n_objects)
    out: List[int] = []
    u, v = pairs.u, pairs.v
    for i in order:
        i = int(i)
        o, o2 = int(u[i]), int(v[i])
        lab = known.get(i)
        if lab is not None:
            g.add_label(o, o2, lab)
            continue
        if g.deduce(o, o2) is None:
            if exclude is None or i not in exclude:
                out.append(i)
            g.add_label(o, o2, POS)  # optimistic assumption
        # deducible unlabeled pairs are skipped (insert nothing)
    return out


def deduction_sweep(
    pairs: PairSet,
    order: np.ndarray,
    known: Dict[int, int],
    skip: Optional[Set[int]] = None,
) -> List[int]:
    """Algorithm 2 lines 6-8: deduce every still-unlabeled pair that follows
    from the labeled set.  Mutates ``known``; returns newly deduced indices.
    Deduced labels add no edges to the ClusterGraph (a deduced-matching
    pair lies within an existing cluster; a deduced-non-matching pair joins
    two already-negatively-adjacent clusters), so a single sweep is
    complete."""
    g = ClusterGraph(pairs.n_objects)
    for i, lab in known.items():
        g.add_label(int(pairs.u[i]), int(pairs.v[i]), lab)
    newly: List[int] = []
    for i in order:
        i = int(i)
        if i in known or (skip is not None and i in skip):
            continue
        d = g.deduce(int(pairs.u[i]), int(pairs.v[i]))
        if d is not None:
            known[i] = d
            newly.append(i)
    return newly


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------
def _crowdsource_batch(pairs: PairSet, batch: List[int], crowd: Crowd,
                       g: ClusterGraph, known: Dict[int, int],
                       crowdsourced: np.ndarray) -> None:
    """Ask the crowd for ``batch`` in order; an answer contradicting the
    persistent evidence graph ``g`` is dropped and counted there, and the
    pair takes its deduced label instead, so ``known`` stays consistent for
    the selection and deduction scans (DESIGN.md §9)."""
    for i in batch:
        o, o2 = int(pairs.u[i]), int(pairs.v[i])
        lab = crowd.ask(pairs, i)
        crowdsourced[i] = True
        if not g.add_label(o, o2, lab):
            lab = g.deduce(o, o2)
        known[i] = lab


def _result(n: int, known: Dict[int, int], crowdsourced: np.ndarray,
            batch_sizes: List[int], g: ClusterGraph) -> LabelingResult:
    labels = np.zeros(n, dtype=bool)
    for i, lab in known.items():
        labels[i] = lab == POS
    return LabelingResult(
        labels=labels,
        crowdsourced=crowdsourced,
        n_iterations=len(batch_sizes),
        batch_sizes=batch_sizes,
        n_conflicts=g.n_conflicts,
    )


def label_parallel(pairs: PairSet, order: np.ndarray, crowd: Crowd
                   ) -> LabelingResult:
    n = len(pairs)
    known: Dict[int, int] = {}
    crowdsourced = np.zeros(n, dtype=bool)
    batch_sizes: List[int] = []
    g = ClusterGraph(pairs.n_objects)
    while len(known) < n:
        batch = parallel_crowdsourced_pairs(pairs, order, known)
        if not batch:
            raise RuntimeError("no progress — inconsistent state")
        _crowdsource_batch(pairs, batch, crowd, g, known, crowdsourced)
        batch_sizes.append(len(batch))
        deduction_sweep(pairs, order, known)
    return _result(n, known, crowdsourced, batch_sizes, g)


def label_parallel_adaptive(pairs: PairSet, crowd: Crowd) -> LabelingResult:
    """Algorithm 2 under the *adaptive* order (DESIGN.md §10) — the host
    oracle for the engine's posterior-refreshed path.

    Each round re-ranks the still-unlabeled pairs by their live
    expected-deduction gain (``core/ordering.py``'s host formula over the
    same ClusterGraph that drives deduction) and runs the Algorithm 3
    selection scan in that order, with all labeled pairs scanned first:
    labeled evidence is position-free on the device (folded into roots and
    neg keys before selection), so the oracle gives it the same head start.
    Ties break by the static expected order, mirroring the engine's stable
    rank tie-break over pairs stored in expected order."""
    from .ordering import (adaptive_gains_host, adaptive_order_host,
                           expected_rank)

    n = len(pairs)
    known: Dict[int, int] = {}
    crowdsourced = np.zeros(n, dtype=bool)
    batch_sizes: List[int] = []
    g = ClusterGraph(pairs.n_objects)
    erank = expected_rank(pairs.likelihood)
    while len(known) < n:
        gains = adaptive_gains_host(g, pairs.u, pairs.v, pairs.likelihood)
        pending_mask = np.ones(n, bool)
        pending_mask[list(known)] = False
        labeled = np.array(sorted(known), np.int64)
        pending = adaptive_order_host(gains, erank,
                                      np.nonzero(pending_mask)[0])
        order = np.concatenate([labeled, pending])
        batch = parallel_crowdsourced_pairs(pairs, order, known)
        if not batch:
            raise RuntimeError("no progress — inconsistent state")
        _crowdsource_batch(pairs, batch, crowd, g, known, crowdsourced)
        batch_sizes.append(len(batch))
        deduction_sweep(pairs, order, known)
    return _result(n, known, crowdsourced, batch_sizes, g)
