"""Sequential labeling component (§3.2) — one pair at a time, the port's copy
of ``repro/core/labeling.py``.

Walks the sorted list; a pair whose label is deducible from the already
labeled pairs (Algorithm 1 on the ClusterGraph) is deduced for free,
otherwise it is crowdsourced.  Each crowdsourced pair is its own
iteration/HIT round — the latency problem §5 fixes.  Crowd answers are the
engine codes ``POS`` / ``NEG``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .cluster_graph import POS, ClusterGraph
from .crowd import Crowd
from .pairs import PairSet


@dataclasses.dataclass
class LabelingResult:
    labels: np.ndarray             # (P,) bool — final label per pair (True=M)
    crowdsourced: np.ndarray       # (P,) bool — True iff pair was crowdsourced
    n_iterations: int              # crowd round-trips
    batch_sizes: List[int]         # pairs published per iteration
    n_conflicts: int = 0

    @property
    def n_crowdsourced(self) -> int:
        return int(self.crowdsourced.sum())

    @property
    def n_deduced(self) -> int:
        return len(self.labels) - self.n_crowdsourced


def label_sequential(pairs: PairSet, order: np.ndarray, crowd: Crowd
                     ) -> LabelingResult:
    n = len(pairs)
    labels = np.zeros(n, dtype=bool)
    crowdsourced = np.zeros(n, dtype=bool)
    g = ClusterGraph(pairs.n_objects)
    for i in order:
        i = int(i)
        o, o2 = int(pairs.u[i]), int(pairs.v[i])
        d = g.deduce(o, o2)
        if d is None:
            lab = crowd.ask(pairs, i)
            crowdsourced[i] = True
            if not g.add_label(o, o2, lab):
                # contradictory noisy answer: dropped and counted by the
                # graph; the pair takes its deduced label instead (the
                # "drop" conflict policy — DESIGN.md §9)
                lab = g.deduce(o, o2)
        else:
            lab = d
        labels[i] = lab == POS
    nc = int(crowdsourced.sum())
    return LabelingResult(
        labels=labels,
        crowdsourced=crowdsourced,
        n_iterations=nc,
        batch_sizes=[1] * nc,
        n_conflicts=g.n_conflicts,
    )


def label_sequential_adaptive(pairs: PairSet, crowd: Crowd
                              ) -> LabelingResult:
    """Sequential labeling under the *adaptive* order (DESIGN.md §10): after
    every crowdsourced answer the remaining pairs re-rank by their live
    posterior match probability (the machine prior damped by the negative
    evidence in the same ClusterGraph that drives deduction).  Ties break by
    the static expected order, mirroring the engine's stable rank
    tie-break.

    Gains only change when the graph changes (an accepted crowd label);
    deduced pairs add no edges, so each ranking is walked — deducing for
    free — until the first non-deducible pair, which is the one
    crowdsourced."""
    from .ordering import (adaptive_gains_host, adaptive_order_host,
                           expected_rank)

    n = len(pairs)
    labels = np.zeros(n, dtype=bool)
    crowdsourced = np.zeros(n, dtype=bool)
    g = ClusterGraph(pairs.n_objects)
    erank = expected_rank(pairs.likelihood)
    pending = np.ones(n, dtype=bool)
    while pending.any():
        gains = adaptive_gains_host(g, pairs.u, pairs.v, pairs.likelihood)
        idx = np.nonzero(pending)[0]
        # descending gain, ties by earliest expected-order rank; deduced
        # pairs along the walk are free and leave the ranking valid
        for i in adaptive_order_host(gains, erank, idx):
            o, o2 = int(pairs.u[i]), int(pairs.v[i])
            d = g.deduce(o, o2)
            pending[i] = False
            if d is None:
                lab = crowd.ask(pairs, int(i))
                crowdsourced[i] = True
                if not g.add_label(o, o2, lab):
                    lab = g.deduce(o, o2)
                labels[i] = lab == POS
                break  # the graph changed: re-rank the remainder
            labels[i] = d == POS
    nc = int(crowdsourced.sum())
    return LabelingResult(
        labels=labels,
        crowdsourced=crowdsourced,
        n_iterations=nc,
        batch_sizes=[1] * nc,
        n_conflicts=g.n_conflicts,
    )


def label_all_crowdsourced(pairs: PairSet, crowd: Crowd) -> LabelingResult:
    """The Non-Transitive baseline (§6.1): crowdsource every candidate pair,
    publish all of them at once (one parallel round)."""
    n = len(pairs)
    labels = np.zeros(n, dtype=bool)
    for i in range(n):
        labels[i] = crowd.ask(pairs, i) == POS
    return LabelingResult(
        labels=labels,
        crowdsourced=np.ones(n, dtype=bool),
        n_iterations=1,
        batch_sizes=[n],
    )
