"""Labeling orders (§3.1, §4) — the port's copy of the order functions of
``repro/core/sorting.py``.  Each returns an index permutation into a
:class:`~repro_torch.core.pairs.PairSet`.

* ``order_optimal``  — Theorem 1: all matching pairs first (simulation only).
* ``order_expected`` — the practical heuristic (§4.2): descending likelihood.
* ``order_random``   — seeded shuffle.
* ``order_worst``    — all non-matching pairs first.
* ``order_adaptive`` — the initial permutation of the posterior-refreshed
  adaptive order; the live re-ranking runs in ``core/ordering.py``.
"""
from __future__ import annotations

import numpy as np

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
