"""Labeling orders (§3.1, §4) — the port's copy of the order functions of
``repro/core/sorting.py``.  Each returns an index permutation into a
:class:`~repro_torch.core.pairs.PairSet`.

* ``order_optimal``  — Theorem 1: all matching pairs first (simulation only).
* ``order_expected`` — the practical heuristic (§4.2): descending likelihood.
* ``order_random``   — seeded shuffle.
* ``order_worst``    — all non-matching pairs first.
* ``order_adaptive`` — the initial permutation of the posterior-refreshed
  adaptive order; the live re-ranking runs in ``core/ordering.py``.

Plus the *exact* expected-crowdsourced-pairs enumerator of §4.2 / Example 4
(exponential; for tiny instances and tests only): all 2^n labelings are
filtered to transitively-consistent worlds, prior probabilities
renormalized over those worlds, and the sequential labeler counted per
world.  It keeps the reference's float64 arithmetic as it is, rounding
included (5.000000000000001 for a 5-pair star: ROADMAP R3).
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from .cluster_graph import NEG, POS, ClusterGraph
from .pairs import PairSet


def order_expected(pairs: PairSet) -> np.ndarray:
    # stable descending likelihood (ties broken by index)
    return np.argsort(-pairs.likelihood, kind="stable")


def order_optimal(pairs: PairSet) -> np.ndarray:
    if pairs.truth is None:
        raise ValueError(
            "optimal order needs ground truth: it sorts matching pairs "
            "first (Theorem 1), which only a simulation can know")
    key = np.where(pairs.truth, 1.0, 0.0) * 10.0 + pairs.likelihood
    return np.argsort(-key, kind="stable")


def order_worst(pairs: PairSet) -> np.ndarray:
    if pairs.truth is None:
        raise ValueError(
            "worst order needs ground truth: it sorts non-matching pairs "
            "first, which only a simulation can know")
    key = np.where(pairs.truth, 0.0, 1.0) * 10.0 + pairs.likelihood
    return np.argsort(-key, kind="stable")


def order_random(pairs: PairSet, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(len(pairs))


def order_adaptive(pairs: PairSet) -> np.ndarray:
    """Before any label lands every cluster is a singleton, so the adaptive
    order starts as the §4.2 heuristic."""
    return order_expected(pairs)


ORDERS = {
    "optimal": order_optimal,
    "expected": order_expected,
    "worst": order_worst,
    "adaptive": order_adaptive,
}


def validate_order(name: str) -> str:
    """Raise a ValueError listing the valid order names for anything
    unknown; returns the name unchanged otherwise."""
    if name != "random" and name not in ORDERS:
        raise ValueError(
            f"unknown labeling order {name!r}: valid orders are "
            f"{sorted([*ORDERS, 'random'])}")
    return name


def get_order(pairs: PairSet, name: str, seed: int = 0) -> np.ndarray:
    validate_order(name)
    if name == "random":
        return order_random(pairs, seed)
    return ORDERS[name](pairs)


# --------------------------------------------------------------------------
# Exact E[C(w)] of §4.2 (Example 4) — tiny instances only.
# --------------------------------------------------------------------------
def _consistent(n_objects: int, u, v, labels: Sequence[bool]) -> bool:
    """A labeling is realizable by some entity partition iff no non-matching
    pair joins two objects connected by matching pairs."""
    g = ClusterGraph(n_objects)
    for i, m in enumerate(labels):
        if m:
            g._union(g.find(int(u[i])), g.find(int(v[i])))
    for i, m in enumerate(labels):
        if not m and g.connected(int(u[i]), int(v[i])):
            return False
    return True


def count_crowdsourced(pairs: PairSet, order: np.ndarray,
                       labels: Sequence[bool]) -> int:
    """Sequential labeler (§3.2) crowdsourced-pair count for a known world."""
    g = ClusterGraph(pairs.n_objects)
    n = 0
    for i in order:
        o, o2 = int(pairs.u[i]), int(pairs.v[i])
        if g.deduce(o, o2) is None:
            n += 1
            g.add_label(o, o2, POS if labels[i] else NEG)
        # deduced pairs add no information to the ClusterGraph
    return n


def expected_crowdsourced(pairs: PairSet, order: np.ndarray) -> float:
    """E[C(w)] under the per-pair matching probabilities, conditioned on
    transitive consistency (exactly the §4.2 / Example 4 computation)."""
    n = len(pairs)
    if n > 16:
        raise ValueError(f"exact enumeration is exponential: {n} pairs, at "
                         "most 16")
    p = pairs.likelihood.astype(np.float64)
    total_prob = 0.0
    exp_count = 0.0
    for world in itertools.product([True, False], repeat=n):
        if not _consistent(pairs.n_objects, pairs.u, pairs.v, world):
            continue
        prob = 1.0
        for i in range(n):
            prob *= p[i] if world[i] else (1.0 - p[i])
        total_prob += prob
        exp_count += prob * count_crowdsourced(pairs, order, world)
    return exp_count / total_prob
