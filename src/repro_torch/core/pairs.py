"""Candidate pair set — the unit of work flowing through the service.

A ``PairSet`` is a struct-of-arrays over the machine-generated candidate
pairs: object ids ``u``/``v``, the machine ``likelihood`` that each pair
matches (§4.2), and — when known, for simulation — the ground-truth labels.
Host-side numpy, as in the JAX package (a copy of ``repro/core/pairs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PairSet:
    u: np.ndarray           # (P,) int32 object ids
    v: np.ndarray           # (P,) int32 object ids
    likelihood: np.ndarray  # (P,) float32 in [0,1]
    truth: Optional[np.ndarray] = None  # (P,) bool — True = matching
    n_objects: int = 0

    def __post_init__(self):
        self.u = np.asarray(self.u, dtype=np.int32)
        self.v = np.asarray(self.v, dtype=np.int32)
        self.likelihood = np.asarray(self.likelihood, dtype=np.float32)
        if self.truth is not None:
            self.truth = np.asarray(self.truth, dtype=bool)
        if self.n_objects == 0 and len(self.u):
            self.n_objects = int(max(self.u.max(), self.v.max())) + 1

    def __len__(self) -> int:
        return len(self.u)

    def above(self, threshold: float) -> "PairSet":
        """Pairs whose likelihood is above the threshold (§6: the candidate
        set handed to the labeling framework)."""
        m = self.likelihood >= threshold
        return PairSet(
            self.u[m], self.v[m], self.likelihood[m],
            None if self.truth is None else self.truth[m],
            n_objects=self.n_objects,
        )

    def take(self, order: np.ndarray) -> "PairSet":
        return PairSet(
            self.u[order], self.v[order], self.likelihood[order],
            None if self.truth is None else self.truth[order],
            n_objects=self.n_objects,
        )

    def concat(self, other: "PairSet") -> "PairSet":
        """Append another candidate batch (streaming ingest, DESIGN.md §11):
        ids index one shared object universe, so the result spans the larger
        of the two.  Ground truth is all or nothing across the stream: a
        half-truthed session would corrupt the quality accounting."""
        if (self.truth is None) != (other.truth is None):
            raise ValueError(
                "cannot concat PairSets where only one side carries ground "
                "truth: quality accounting needs truth for every pair or "
                "none")
        return PairSet(
            np.concatenate([self.u, other.u]),
            np.concatenate([self.v, other.v]),
            np.concatenate([self.likelihood, other.likelihood]),
            None if self.truth is None
            else np.concatenate([self.truth, other.truth]),
            n_objects=max(self.n_objects, other.n_objects),
        )
