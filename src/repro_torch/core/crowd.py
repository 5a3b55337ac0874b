"""Crowd platform simulator and crowd transport (§2.1, §6.4) — the part of
``repro/core/crowd.py`` the first slice of the port runs.

* :class:`PerfectCrowd` — always returns ground truth (the §2.1 assumption);
  its ``precomputed_answers`` let the round engine fold many rounds without
  surfacing each frontier to the host.
* :class:`CostModel` — AMT accounting of §6.4.
* :class:`CrowdGateway` — the batched transport in immediate mode: every
  posted pair is answered on the next ``poll`` at simulated time 0, and each
  assignment is billed against its request.

Labels are in engine encoding (``POS`` / ``NEG``) throughout.  The noisy
crowd, the latency model, requery, worker reliability and cluster tasks are
not ported yet (ROADMAP A9.2, A9.4, A9.8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster_graph import NEG, POS
from .pairs import PairSet


class Crowd:
    """Interface: label pair ``i`` of a :class:`PairSet`.  ``n_asked``
    counts questions for the §6 cost accounting."""

    def __init__(self) -> None:
        self.n_asked = 0

    def ask(self, pairs: PairSet, i: int) -> int:
        """The crowd's label for pair ``i``: ``POS`` or ``NEG``."""
        raise NotImplementedError

    def precomputed_answers(self, pairs: PairSet) -> Optional[np.ndarray]:
        """Every pair's answer up front (int32 POS/NEG), or ``None`` when
        answers depend on the order they are asked in."""
        return None


class PerfectCrowd(Crowd):
    """Ground-truth oracle crowd — the §2.1 assumption."""

    def ask(self, pairs: PairSet, i: int) -> int:
        if pairs.truth is None:
            raise ValueError("PerfectCrowd needs the pairs' ground truth")
        self.n_asked += 1
        return POS if pairs.truth[i] else NEG

    def precomputed_answers(self, pairs: PairSet) -> Optional[np.ndarray]:
        if pairs.truth is None:
            return None
        return np.where(pairs.truth, POS, NEG).astype(np.int32)


@dataclasses.dataclass
class CostModel:
    """AMT accounting of §6.4: 2 cents/assignment, 20 pairs per HIT, 3
    assignments per HIT."""

    cents_per_assignment: float = 2.0
    pairs_per_hit: int = 20
    assignments_per_hit: int = 3

    def n_hits(self, n_pairs: int) -> int:
        """HITs needed to cover ``n_pairs`` at ``pairs_per_hit`` each."""
        return math.ceil(n_pairs / self.pairs_per_hit)

    def cost_cents(self, n_pairs: int) -> float:
        """Total §6.4 price of ``n_pairs`` pair questions."""
        return (self.n_hits(n_pairs) * self.assignments_per_hit
                * self.cents_per_assignment)


@dataclasses.dataclass
class CrowdTicket:
    """Receipt for one posted batch of pairs."""

    tid: int
    rid: int
    indices: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CrowdAnswer:
    """One completed pair label in engine encoding, with the assignment
    votes behind it (a deterministic crowd casts one)."""

    rid: int
    index: int
    label: int
    minutes: float
    votes: Tuple[int, ...] = ()


class CrowdGateway:
    """Batched crowd transport in immediate mode (DESIGN.md §8): ``post``
    asks the crowd for every pair of a batch and bills each assignment,
    ``poll``/``drain`` return the answers at simulated time 0."""

    def __init__(self, latency=None) -> None:
        if latency is not None:
            raise NotImplementedError(
                "the asynchronous crowd platform (LatencyModel) is not ported "
                "yet: ROADMAP A9.2")
        self._waiting: List[CrowdAnswer] = []
        self._spent_cents: Dict[int, float] = {}
        self._next_tid = 0

    def spent_cents(self, rid: int) -> float:
        """Cents spent on a request so far (assignment-level accounting)."""
        return self._spent_cents.get(rid, 0.0)

    def cluster_pairs(self, rid: int) -> int:
        """Pairs a request resolved through cluster tasks: none, since this
        gateway posts pair questions only (cluster tasks: ROADMAP A9.8)."""
        return 0

    def post(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
             cents_per_assignment: float = 0.0) -> CrowdTicket:
        """Ask the crowd for each pair index and bill one assignment each."""
        indices = tuple(int(i) for i in indices)
        spent = self._spent_cents.get(rid, 0.0)
        for i in indices:
            label = crowd.ask(pairs, i)
            self._waiting.append(CrowdAnswer(rid, i, label, 0.0, (label,)))
            # one addition per assignment, as the reference bills, so the
            # running total rounds identically for any rate
            spent += cents_per_assignment
        self._spent_cents[rid] = spent
        tid = self._next_tid
        self._next_tid += 1
        return CrowdTicket(tid=tid, rid=rid, indices=indices)

    def poll(self) -> List[CrowdAnswer]:
        """Everything posted so far, answered at simulated time 0."""
        out, self._waiting = self._waiting, []
        return out

    def drain(self) -> List[CrowdAnswer]:
        """Poll until nothing is in flight (the round-barrier transport)."""
        return self.poll()
