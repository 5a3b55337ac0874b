"""Crowd platform simulators, the worker-quality model and the crowd
transport (§2.1, §6.4, DESIGN.md §9, §15, §16): the port of
``repro/core/crowd.py``.

* :class:`PerfectCrowd` — always returns ground truth (the §2.1 assumption);
  its ``precomputed_answers`` let the round engine fold many rounds without
  surfacing each frontier to the host.
* :class:`NoisyCrowd` — each of ``n_assignments`` workers flips the true
  label with probability ``error_rate`` (reduced by a qualification-test
  pass rate), final label by majority vote — the §6.4 deployment model.
  With ``n_workers`` set it simulates a heterogeneous pool whose per-worker
  error rates are drawn from a Beta distribution.  Its rng stream is the
  reference's draw for draw, so the same seed gives the same ballots.
* :class:`WorkerModel` — a streaming Dawid-Skene estimator: per-worker
  error rates tracked online from ballots, log-odds weighted voting.
* :class:`ClusterTask` — a CrowdER-style multi-pair task: one worker
  partitions the objects behind a set of pairs.
* :class:`CostModel` — AMT accounting of §6.4, and the cluster-task price.
* :class:`LatencyModel` — lognormal per-assignment completion times and a
  finite worker pool: the simulated asynchronous platform.
* :class:`CrowdGateway` — the batched transport.  In immediate mode every
  posted pair is answered on the next ``poll`` at simulated time 0; with a
  ``LatencyModel`` a pool of workers picks waiting pairs (at random, as AMT
  assigns, or lowest likelihood first under ``nf``) and ``poll`` advances
  the platform clock to the next completion.  Each ballot is billed against
  its request and its votes are tallied.  The gateway's rng draws (worker
  picks, then each pick's latency) are the reference's, draw for draw.
  ``aggregation="em"`` collapses ballots by :class:`WorkerModel` weighted
  voting; ``requery`` escalates rejected answers; ``post_cluster`` posts a
  cluster task.

Every crowd, the worker model and the gateway have a JSON ``state_dict`` /
``load_state_dict`` pair for the service's checkpoints (DESIGN.md §16),
which emits the reference's schema key for key; :func:`crowd_to_state` /
:func:`crowd_from_state` carry a crowd with its class name
(:func:`register_crowd`).

Labels are in engine encoding (``POS`` / ``NEG``) throughout, ballots'
included.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from .cluster_graph import NEG, POS
from .pairs import PairSet


@dataclasses.dataclass(frozen=True)
class Ballot:
    """One completed crowd question: the majority ``label``, the
    per-assignment ``votes`` and the stable ids of the ``workers`` who cast
    them, aligned with the votes."""

    label: int
    votes: Tuple[int, ...]
    workers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ClusterTask:
    """CrowdER-style multi-pair request: one worker partitions ``n_objects``
    objects, the distinct endpoints of the candidate pairs ``indices``, and
    the partition decodes into one POS/NEG verdict a covered pair, for one
    task's price ``cents`` (DESIGN.md §15)."""

    rid: int
    indices: Tuple[int, ...]
    n_objects: int
    cents: float


def _require_odd(n_assignments: int) -> None:
    if n_assignments < 1 or n_assignments % 2 == 0:
        raise ValueError(
            f"n_assignments must be odd and positive, got {n_assignments}: "
            "an even vote can tie, and a tie silently resolves to the wrong "
            "label (majority is defined as n_true * 2 > k); the analytic "
            "pair_error_rate also assumes odd k")


def _truth(pairs: PairSet, i: int, who: str) -> bool:
    if pairs.truth is None:
        raise ValueError(f"{who} needs the pairs' ground truth")
    return bool(pairs.truth[i])


class Crowd:
    """Interface: label pair ``i`` of a :class:`PairSet`.  Concrete crowds
    implement :meth:`ask`; :meth:`ask_votes`, :meth:`ask_ballot` and
    :meth:`ask_cluster` have default implementations that deterministic
    crowds inherit.
    ``n_asked`` counts questions for the §6 cost accounting."""

    def __init__(self) -> None:
        self.n_asked = 0

    def ask(self, pairs: PairSet, i: int) -> int:
        """The crowd's label for pair ``i``: ``POS`` or ``NEG``."""
        raise NotImplementedError

    def ask_votes(self, pairs: PairSet, i: int,
                  n_assignments: Optional[int] = None
                  ) -> Tuple[int, Tuple[int, ...]]:
        """Majority label plus the votes behind it; a deterministic crowd
        casts one unanimous vote."""
        label = self.ask(pairs, i)
        return label, (label,)

    def ask_ballot(self, pairs: PairSet, i: int,
                   n_assignments: Optional[int] = None,
                   exclude: Sequence[int] = ()) -> Ballot:
        """Like :meth:`ask_votes`, each vote from a freshly minted worker id
        (``exclude`` cannot matter: every worker is new)."""
        label, votes = self.ask_votes(pairs, i, n_assignments)
        return Ballot(label, votes, self._fresh_workers(len(votes)))

    def ask_cluster(self, pairs: PairSet, indices: Sequence[int],
                    prefer: Sequence[int] = (), exclude: Sequence[int] = ()
                    ) -> Tuple[Tuple[int, ...], int]:
        """One :class:`ClusterTask` without noise: the truth partition of the
        objects behind ``indices``, decoded to a verdict a pair, from one
        freshly minted worker (``prefer`` and ``exclude`` cannot matter).
        Returns ``(labels, worker)``, labels aligned with ``indices``."""
        if pairs.truth is None:
            raise ValueError(
                "ask_cluster needs ground truth to simulate the partition")
        idx = tuple(int(i) for i in indices)
        self.n_asked += len(idx)
        labels = tuple(POS if bool(pairs.truth[i]) else NEG for i in idx)
        return labels, self._fresh_workers(1)[0]

    def precomputed_answers(self, pairs: PairSet) -> Optional[np.ndarray]:
        """Every pair's answer up front (int32 POS/NEG), or ``None`` when
        answers depend on the order they are asked in."""
        return None

    def reset(self) -> None:
        """Zero the question counter and the fresh-worker id counter."""
        self.n_asked = 0
        self._worker_seq = 0

    def _fresh_workers(self, k: int) -> Tuple[int, ...]:
        start = getattr(self, "_worker_seq", 0)
        self._worker_seq = start + k
        return tuple(range(start, start + k))

    # -- persistence (DESIGN.md §16) ------------------------------------
    def state_dict(self) -> dict:
        """JSON snapshot of the crowd's mutable state; subclasses with rng
        streams or worker pools extend it."""
        return {"n_asked": int(self.n_asked),
                "worker_seq": int(getattr(self, "_worker_seq", 0))}

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot in place."""
        self.n_asked = int(state.get("n_asked", 0))
        self._worker_seq = int(state.get("worker_seq", 0))


_CROWD_CLASSES: Dict[str, type] = {}


def register_crowd(cls: type) -> type:
    """Register a :class:`Crowd` subclass for checkpoint restore, under
    its class name (usable as a decorator; the built-in crowds are
    registered)."""
    _CROWD_CLASSES[cls.__name__] = cls
    return cls


def crowd_to_state(crowd: Crowd) -> dict:
    """``{"class": name, "state": state_dict}`` — JSON, as the reference
    writes it."""
    return {"class": type(crowd).__name__, "state": crowd.state_dict()}


def crowd_from_state(payload: dict) -> Crowd:
    """Rebuild a crowd from :func:`crowd_to_state` output, without running
    ``__init__`` (its rng draws are already in the snapshot): future
    answers match the snapshotted instance's."""
    name = payload["class"]
    cls = _CROWD_CLASSES.get(name)
    if cls is None:
        raise KeyError(
            f"unknown crowd class {name!r} — register it with "
            "repro_torch.core.crowd.register_crowd before restoring")
    crowd = cls.__new__(cls)
    crowd.load_state_dict(payload["state"])
    return crowd


def _rng_to_state(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state


def _rng_from_state(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng


@register_crowd
class PerfectCrowd(Crowd):
    """Ground-truth oracle crowd — the §2.1 assumption."""

    def ask(self, pairs: PairSet, i: int) -> int:
        truth = _truth(pairs, i, "PerfectCrowd")
        self.n_asked += 1
        return POS if truth else NEG

    def precomputed_answers(self, pairs: PairSet) -> Optional[np.ndarray]:
        if pairs.truth is None:
            return None
        return np.where(pairs.truth, POS, NEG).astype(np.int32)


@register_crowd
class NoisyCrowd(Crowd):
    """§6.4 deployment model: majority vote over error-prone workers.

    ``error_rate`` is the base per-assignment error (0.7x with the
    ``qualification`` screen); ``n_assignments`` votes a question (odd).
    With ``n_workers`` set, the per-worker error rates are drawn once here
    from a Beta distribution of concentration ``worker_concentration``
    centred on the qualified rate, and every ballot draws distinct workers
    from that pool.  Answers depend on the rng's position, so
    :meth:`precomputed_answers` is ``None``."""

    def __init__(self, error_rate: float = 0.05, n_assignments: int = 3,
                 qualification: bool = True, seed: int = 0,
                 n_workers: Optional[int] = None,
                 worker_concentration: float = 12.0):
        super().__init__()
        _require_odd(n_assignments)
        self.error_rate = error_rate * (0.7 if qualification else 1.0)
        self.n_assignments = n_assignments
        self.rng = np.random.default_rng(seed)
        self.n_workers = n_workers
        self.worker_errors = None
        if n_workers is not None:
            if n_workers < n_assignments:
                raise ValueError(
                    f"worker pool of {n_workers} cannot cover "
                    f"{n_assignments} distinct assignments per pair")
            mean = min(max(self.error_rate, 1e-3), 0.45)
            c = worker_concentration
            self.worker_errors = np.clip(
                self.rng.beta(mean * c, (1.0 - mean) * c, size=n_workers),
                1e-3, 0.49)

    def ask(self, pairs: PairSet, i: int) -> int:
        return self.ask_ballot(pairs, i).label

    def ask_votes(self, pairs: PairSet, i: int,
                  n_assignments: Optional[int] = None
                  ) -> Tuple[int, Tuple[int, ...]]:
        ballot = self.ask_ballot(pairs, i, n_assignments)
        return ballot.label, ballot.votes

    def ask_ballot(self, pairs: PairSet, i: int,
                   n_assignments: Optional[int] = None,
                   exclude: Sequence[int] = ()) -> Ballot:
        """A noisy ballot.  Homogeneous mode draws one ``rng.random(k)`` and
        mints fresh worker ids; pool mode picks ``k`` distinct workers
        (avoiding ``exclude`` while the pool allows) and flips each vote with
        that worker's own error rate."""
        k = self.n_assignments if n_assignments is None else n_assignments
        _require_odd(k)
        true_match = _truth(pairs, i, "NoisyCrowd")
        self.n_asked += 1
        if self.worker_errors is None:
            workers = self._fresh_workers(k)
            correct = self.rng.random(k) >= self.error_rate
        else:
            workers = tuple(self._pick_workers(k, exclude))
            correct = self.rng.random(k) >= self.worker_errors[list(workers)]
        truth, lie = (POS, NEG) if true_match else (NEG, POS)
        votes = tuple(truth if c else lie for c in correct)
        label = truth if int(correct.sum()) * 2 > k else lie
        return Ballot(label, votes, workers)

    def ask_cluster(self, pairs: PairSet, indices: Sequence[int],
                    prefer: Sequence[int] = (), exclude: Sequence[int] = ()
                    ) -> Tuple[Tuple[int, ...], int]:
        """One worker partitions the task's objects, with per-object noise:
        the truth partition over the objects behind ``indices`` (union-find
        over the truth-POS pairs among them), then each object, with the
        worker's error rate, moved to a random other group or a fresh
        singleton.  Pool mode sends the task to the first worker of
        ``prefer`` in range and not in ``exclude``, else to a random worker
        outside ``exclude``.  Returns ``(labels, worker)``."""
        if pairs.truth is None:
            raise ValueError(
                "ask_cluster needs ground truth to simulate the partition")
        idx = [int(i) for i in indices]
        self.n_asked += len(idx)
        banned = {int(w) for w in exclude}
        if self.worker_errors is None:
            worker = self._fresh_workers(1)[0]
            err = self.error_rate
        else:
            usable = [int(w) for w in prefer
                      if 0 <= int(w) < self.n_workers
                      and int(w) not in banned]
            worker = usable[0] if usable else self._pick_workers(1, banned)[0]
            err = float(self.worker_errors[worker])
        u = np.asarray(pairs.u)[idx]
        v = np.asarray(pairs.v)[idx]
        objs = {int(o): j
                for j, o in enumerate(np.unique(np.concatenate([u, v])))}
        parent = list(range(len(objs)))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for j, i in enumerate(idx):
            if bool(pairs.truth[i]):
                ra, rb = find(objs[int(u[j])]), find(objs[int(v[j])])
                if ra != rb:
                    parent[ra] = rb
        group = [find(a) for a in range(len(objs))]
        next_group = len(objs)  # fresh singleton ids
        for a in range(len(objs)):
            if self.rng.random() < err:
                others = sorted(set(group) - {group[a]}) + [next_group]
                group[a] = int(others[int(self.rng.integers(len(others)))])
                next_group += 1
        labels = tuple(
            POS if group[objs[int(u[j])]] == group[objs[int(v[j])]] else NEG
            for j in range(len(idx)))
        return labels, int(worker)

    def _pick_workers(self, k: int, exclude: Sequence[int]) -> List[int]:
        banned = {int(w) for w in exclude}
        fresh = np.array([w for w in range(self.n_workers)
                          if w not in banned], dtype=int)
        if len(fresh) >= k:
            return [int(w) for w in
                    self.rng.choice(fresh, size=k, replace=False)]
        # pool exhausted: take every unseen worker, top up from the rest
        rest = np.array(sorted(banned & set(range(self.n_workers))),
                        dtype=int)
        top_up = self.rng.choice(rest, size=k - len(fresh), replace=False)
        return [int(w) for w in fresh] + [int(w) for w in top_up]

    def pair_error_rate(self, n_assignments: Optional[int] = None) -> float:
        """Analytic majority-vote error: the probability that a strict
        majority of ``k`` (odd) votes is wrong."""
        e = self.error_rate
        k = self.n_assignments if n_assignments is None else n_assignments
        _require_odd(k)
        return sum(math.comb(k, j) * e**j * (1 - e) ** (k - j)
                   for j in range(k // 2 + 1, k + 1))

    def expected_minority_fraction(self) -> float:
        """Analytic E[minority votes / k]; compare with the gateway's
        ``measured_disagreement``."""
        e, k = self.error_rate, self.n_assignments
        return sum(math.comb(k, j) * e**j * (1 - e) ** (k - j)
                   * min(j, k - j) / k for j in range(k + 1))

    def state_dict(self) -> dict:
        """Snapshot with the rng stream and the drawn worker pool:
        ``error_rate`` after the qualification screen, so a restore replays
        no constructor draw."""
        state = super().state_dict()
        state.update(
            error_rate=float(self.error_rate),
            n_assignments=int(self.n_assignments),
            n_workers=(None if self.n_workers is None
                       else int(self.n_workers)),
            worker_errors=(None if self.worker_errors is None
                           else [float(e) for e in self.worker_errors]),
            rng=_rng_to_state(self.rng),
        )
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.error_rate = float(state["error_rate"])
        self.n_assignments = int(state["n_assignments"])
        self.n_workers = (None if state["n_workers"] is None
                          else int(state["n_workers"]))
        we = state["worker_errors"]
        self.worker_errors = (None if we is None
                              else np.asarray(we, np.float64))
        self.rng = _rng_from_state(state["rng"])


class WorkerModel:
    """Streaming Dawid-Skene estimator on the binary match label space
    (DESIGN.md §15): one symmetric error rate a worker as damped
    pseudo-counts, ballots aggregated by log-odds weighted voting (a vote
    from worker ``w`` adds ``±log((1 - e_w) / e_w)`` to the POS score).
    ``record`` is the online M-step against the aggregate's own posterior,
    damped by a Beta prior of ``strength`` pseudo-votes at ``prior_error``;
    ``refit`` runs batch EM over every recorded ballot."""

    def __init__(self, prior_error: float = 0.15, strength: float = 8.0,
                 min_error: float = 0.005, max_error: float = 0.45):
        if not 0.0 < prior_error < 0.5:
            raise ValueError(
                f"prior_error must be in (0, 0.5), got {prior_error}: at "
                "0.5 a worker carries no information and above it the "
                "weights invert")
        self.prior_error = prior_error
        self.strength = strength
        self.min_error = min_error
        self.max_error = max_error
        self._n: Dict[int, float] = {}        # soft vote counts a worker
        self._wrong: Dict[int, float] = {}    # soft error counts a worker
        self._ballots: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []

    @property
    def workers(self) -> List[int]:
        """Ids of every worker seen so far, ascending."""
        return sorted(self._n)

    def n_votes(self, worker: int) -> float:
        """Soft count of the votes recorded for ``worker``."""
        return self._n.get(int(worker), 0.0)

    def error_rate(self, worker: int) -> float:
        """Posterior-mean error estimate ``(wrong + prior * strength) /
        (n + strength)``, clipped to ``[min_error, max_error]``."""
        w = int(worker)
        e = ((self._wrong.get(w, 0.0) + self.prior_error * self.strength)
             / (self._n.get(w, 0.0) + self.strength))
        return float(min(max(e, self.min_error), self.max_error))

    def weight(self, worker: int) -> float:
        """Log-odds voting weight ``log((1 - e) / e)``, always positive."""
        e = self.error_rate(worker)
        return math.log((1.0 - e) / e)

    def score(self, votes: Sequence[int], workers: Sequence[int]) -> float:
        """Weighted POS log-odds of one ballot; positive favours POS."""
        return sum((1.0 if v == POS else -1.0) * self.weight(w)
                   for v, w in zip(votes, workers))

    def aggregate(self, votes: Sequence[int], workers: Sequence[int]) -> int:
        """One engine label by weighted voting; an exactly tied score falls
        back to the unweighted majority, a still-tied ballot to NEG."""
        s = self.score(votes, workers)
        if abs(s) > 1e-12:
            return POS if s > 0 else NEG
        n_pos = sum(v == POS for v in votes)
        return POS if 2 * n_pos > len(list(votes)) else NEG

    def record(self, votes: Sequence[int], workers: Sequence[int]) -> int:
        """Aggregate a ballot and fold it into the running estimates: the
        aggregate's confidence ``c = sigmoid(|score|)`` counts ``c`` of a
        wrong vote against each dissenter and ``1 - c`` against each
        assenter.  The ballot is kept for :meth:`refit`.  Returns the
        aggregated label."""
        votes = tuple(int(v) for v in votes)
        workers = tuple(int(w) for w in workers)
        label = self.aggregate(votes, workers)
        conf = 1.0 / (1.0 + math.exp(-abs(self.score(votes, workers))))
        for v, w in zip(votes, workers):
            self._n[w] = self._n.get(w, 0.0) + 1.0
            wrong = conf if v != label else 1.0 - conf
            self._wrong[w] = self._wrong.get(w, 0.0) + wrong
        self._ballots.append((votes, workers))
        return label

    def refit(self, iters: int = 25) -> None:
        """Full Dawid-Skene EM over every recorded ballot (uniform class
        prior), replacing the streaming counts."""
        if not self._ballots:
            return
        for _ in range(iters):
            n: Dict[int, float] = {}
            wrong: Dict[int, float] = {}
            for votes, workers in self._ballots:
                s = self.score(votes, workers)
                p_pos = 1.0 / (1.0 + math.exp(-s))
                for v, w in zip(votes, workers):
                    n[w] = n.get(w, 0.0) + 1.0
                    wrong[w] = wrong.get(w, 0.0) + (
                        p_pos if v == NEG else 1.0 - p_pos)
            self._n, self._wrong = n, wrong

    def best_workers(self, limit: int = 8,
                     min_votes: float = 4.0) -> List[int]:
        """Up to ``limit`` workers with at least ``min_votes`` of history,
        by ascending estimated error (ties by id)."""
        ranked = sorted(
            (w for w, c in self._n.items() if c >= min_votes),
            key=lambda w: (self.error_rate(w), w))
        return ranked[:limit]

    def state_dict(self) -> dict:
        """JSON snapshot: the prior, the soft counts (worker ids as string
        keys) and the recorded ballots."""
        return {
            "prior_error": float(self.prior_error),
            "strength": float(self.strength),
            "min_error": float(self.min_error),
            "max_error": float(self.max_error),
            "n": {str(w): float(c) for w, c in self._n.items()},
            "wrong": {str(w): float(c) for w, c in self._wrong.items()},
            "ballots": [[list(map(int, votes)), list(map(int, workers))]
                        for votes, workers in self._ballots],
        }

    def load_state_dict(self, state: dict) -> None:
        self.prior_error = float(state["prior_error"])
        self.strength = float(state["strength"])
        self.min_error = float(state["min_error"])
        self.max_error = float(state["max_error"])
        self._n = {int(w): float(c) for w, c in state["n"].items()}
        self._wrong = {int(w): float(c) for w, c in state["wrong"].items()}
        self._ballots = [(tuple(votes), tuple(workers))
                         for votes, workers in state["ballots"]]


@dataclasses.dataclass
class CostModel:
    """AMT accounting of §6.4: 2 cents/assignment, 20 pairs per HIT, 3
    assignments per HIT.  A cluster task of k objects costs
    ``k / cluster_objects_per_assignment`` assignments, at least one."""

    cents_per_assignment: float = 2.0
    pairs_per_hit: int = 20
    assignments_per_hit: int = 3
    cluster_objects_per_assignment: float = 5.0

    def n_hits(self, n_pairs: int) -> int:
        """HITs needed to cover ``n_pairs`` at ``pairs_per_hit`` each."""
        return math.ceil(n_pairs / self.pairs_per_hit)

    def cost_cents(self, n_pairs: int) -> float:
        """Total §6.4 price of ``n_pairs`` pair questions."""
        return (self.n_hits(n_pairs) * self.assignments_per_hit
                * self.cents_per_assignment)

    def cluster_task_cents(self, n_objects: int,
                           cents_per_assignment: Optional[float] = None
                           ) -> float:
        """Price of one ``n_objects``-object cluster task (§15)."""
        rate = (self.cents_per_assignment if cents_per_assignment is None
                else cents_per_assignment)
        return rate * max(1.0, n_objects / self.cluster_objects_per_assignment)


@dataclasses.dataclass
class LatencyModel:
    """Per-assignment completion latency (minutes), lognormal; a worker pool
    of ``n_workers`` draws available HIT-assignments (AMT assigns randomly)."""

    n_workers: int = 20
    mean_minutes: float = 30.0
    sigma: float = 1.0
    seed: int = 0

    def sampler(self) -> np.random.Generator:
        """Fresh seeded rng for the event-driven simulator."""
        return np.random.default_rng(self.seed)

    def draw_minutes(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` lognormal completion times with mean ``mean_minutes``."""
        mu = math.log(self.mean_minutes) - self.sigma**2 / 2
        return rng.lognormal(mu, self.sigma, size=n)


@dataclasses.dataclass
class CrowdTicket:
    """Receipt for one posted batch of pairs."""

    tid: int
    rid: int
    indices: Tuple[int, ...]


class CrowdAnswer(NamedTuple):
    """One completed pair label in engine encoding, with every vote behind
    it and the ids of the workers who cast them (a cluster verdict carries
    one vote a partitioning worker).  A named tuple: the gateway builds one
    a pair on its hot path."""

    rid: int
    index: int
    label: int
    minutes: float
    votes: Tuple[int, ...] = ()
    workers: Tuple[int, ...] = ()

    @property
    def n_assignments(self) -> int:
        """Number of assignments behind this answer."""
        return len(self.votes)


@dataclasses.dataclass
class _Task:
    """One unit of platform work a single worker picks up: a pair ballot, or
    the agreed verdicts of a whole cluster task, as ``(index, label, votes,
    workers)`` entries."""

    rid: int
    answers: List[Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]]
    likelihood: float


def _one_vote_ballots(crowd: Crowd) -> bool:
    """Whether ``crowd`` keeps :class:`Crowd`'s default ballots: one vote,
    equal to :meth:`Crowd.ask`, from a freshly minted worker."""
    cls = type(crowd)
    return (cls.ask_ballot is Crowd.ask_ballot
            and cls.ask_votes is Crowd.ask_votes)


class CrowdGateway:
    """Batched crowd transport (DESIGN.md §8): ``post`` asks the crowd for a
    ballot on every pair of a batch, in index order, and bills it.

    * ``latency=None`` — immediate mode: ``poll``/``drain`` return every
      posted answer at simulated time 0 (the round-barrier transport).
    * ``latency=LatencyModel`` — the simulated asynchronous platform: each
      ballot (or cluster task) is a task a single worker of
      ``latency.n_workers`` picks up (uniformly at random, or lowest
      likelihood first with ``nf=True``, the §5.2 non-matching-first
      steering) and completes after a lognormal number of minutes; ``poll``
      advances the clock (``now_minutes``) to the next completion and
      returns the answers landing then.

    ``aggregation="em"`` collapses every ballot by :class:`WorkerModel`
    weighted voting at post time, in posting order, and cluster tasks go to
    the model's most trusted workers.  ``requery`` re-posts rejected answers
    with an escalated assignment count, routed around the workers seen on
    the pair, up to ``max_requeries`` times.  ``measured_disagreement`` is
    the minority-vote fraction over every pair ballot posted."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 nf: bool = False, max_requeries: int = 1,
                 aggregation: str = "majority") -> None:
        if latency is not None and latency.n_workers <= 0:
            raise ValueError(
                f"CrowdGateway needs a positive worker pool, got "
                f"n_workers={latency.n_workers} — in-flight pairs could "
                "never complete")
        if nf and latency is None:
            raise ValueError(
                "nf=True requires a LatencyModel: non-matching-first steers "
                "which waiting pair a worker picks up next, and the "
                "immediate-mode poll answers everything at once, so the "
                "steering would be a silent no-op")
        if aggregation not in ("majority", "em"):
            raise ValueError(
                f"aggregation must be 'majority' or 'em', got "
                f"{aggregation!r}")
        self.latency = latency
        self.nf = nf
        self.max_requeries = max_requeries
        self.aggregation = aggregation
        self.worker_model = WorkerModel() if aggregation == "em" else None
        # latency mode only: the platform's rng (worker picks, latencies),
        # the tasks waiting for a worker — a list picked at random, or under
        # nf a heap on (likelihood, rid, first index, posting sequence): the
        # reference's min key, ties to the earliest posted — and the running
        # tasks, a min-heap on (t_done, seq)
        self._rng = latency.sampler() if latency is not None else None
        self._tasks: List = []
        self._running: List[Tuple[float, int, _Task]] = []
        self._free_workers = latency.n_workers if latency is not None else 0
        self._now = 0.0
        self._seq = 0
        self._posted = 0
        # immediate mode: the answers posted, not yet polled, and how many of
        # them are a cluster task's beyond its first (a task is one in flight)
        self._waiting: List[CrowdAnswer] = []
        self._waiting_extra = 0
        # ... and the tasks they came from, for checkpoints: consecutive
        # runs of _waiting as (n answers, likelihood, one task).  A run of
        # pair ballots keeps the posted pairs' likelihood array (a task an
        # answer, keyed by its index); a cluster task keeps its float.
        self._waiting_runs: List[Tuple[int, Any, bool]] = []
        self._seen: Dict[Tuple[int, int], Set[int]] = {}
        # one-vote posts not yet folded into _seen: per request, a list of
        # (indices, workers), aligned
        self._seen_runs: Dict[int, List[Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]]] = {}
        self._attempts: Dict[Tuple[int, int], int] = {}
        self._spent_cents: Dict[int, float] = {}
        self._assignments: Dict[int, int] = {}
        self._cluster_pairs: Dict[int, int] = {}
        self._next_tid = 0
        self.n_posted = 0
        self.n_answered = 0
        self.n_requeried = 0
        self.n_votes = 0
        self.n_minority_votes = 0
        self.n_cluster_tasks = 0
        self.n_cluster_pairs = 0

    def spent_cents(self, rid: int) -> float:
        """Cents spent on a request so far (assignment-level accounting)."""
        return self._spent_cents.get(rid, 0.0)

    def assignments_posted(self, rid: int) -> int:
        """Crowd assignments bought for a request so far (a cluster task's
        partitioning workers count one each)."""
        return self._assignments.get(rid, 0)

    def cluster_pairs(self, rid: int) -> int:
        """Pairs a request resolved through agreed cluster verdicts
        (disagreements escalated to pair ballots excluded)."""
        return self._cluster_pairs.get(rid, 0)

    @property
    def now_minutes(self) -> float:
        """Simulated platform wall clock in minutes."""
        return self._now

    @property
    def in_flight(self) -> int:
        """Tasks posted but not yet answered (waiting + running)."""
        return (len(self._waiting) - self._waiting_extra + len(self._tasks)
                + len(self._running))

    @property
    def measured_disagreement(self) -> float:
        """Observed minority-vote fraction over all posted ballots."""
        return self.n_minority_votes / max(self.n_votes, 1)

    def seen_workers(self, rid: int, index: int) -> Tuple[int, ...]:
        """Workers who have already answered a pair, ascending."""
        self._settle_seen(rid)
        return tuple(sorted(self._seen.get((rid, int(index)), ())))

    def _settle_seen(self, rid: int) -> None:
        for indices, workers in self._seen_runs.pop(rid, ()):
            for i, worker in zip(indices, workers):
                self._seen.setdefault((rid, i), set()).add(worker)

    def post(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
             cents_per_assignment: float = 0.0) -> CrowdTicket:
        """Ask the crowd for a ballot on each pair index, in order, and bill
        ``cents_per_assignment`` times its votes against the request — one
        multiply-add a pair, as the reference bills, so the running total
        rounds identically.  With a latency model each ballot becomes a
        waiting task, and free workers pick tasks up at once."""
        indices = self._enqueue(rid, pairs, indices, crowd, None,
                                cents_per_assignment)
        return self._ticket(rid, indices)

    def _ticket(self, rid: int, indices: Tuple[int, ...]) -> CrowdTicket:
        tid = self._next_tid
        self._next_tid += 1
        return CrowdTicket(tid=tid, rid=rid, indices=indices)

    def _enqueue(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
                 n_assignments: Optional[int],
                 cents_per_assignment: float) -> Tuple[int, ...]:
        """Ask, tally and bill a ballot a pair index, in order, and hand
        each to the transport: a waiting task (latency mode) or an answer
        for the next poll.  A crowd of one-vote ballots posted at its own
        assignment count without EM takes :meth:`_post_one_vote`."""
        indices = tuple(int(i) for i in indices)
        if (self.latency is None and n_assignments is None
                and self.worker_model is None and _one_vote_ballots(crowd)):
            self._post_one_vote(rid, pairs, indices, crowd,
                                cents_per_assignment)
        else:
            for i in indices:
                ballot = crowd.ask_ballot(pairs, i, n_assignments,
                                          exclude=self.seen_workers(rid, i))
                label = self._tally(rid, i, ballot, cents_per_assignment)
                if self.latency is not None:
                    self._push_task(_Task(
                        rid, [(i, label, ballot.votes, ballot.workers)],
                        float(pairs.likelihood[i])))
                else:
                    self._waiting.append(CrowdAnswer(
                        rid, i, label, 0.0, ballot.votes, ballot.workers))
            if self.latency is not None:
                self._assign()
            elif indices:
                self._waiting_runs.append(
                    (len(indices), pairs.likelihood, False))
        self.n_posted += len(indices)
        return indices

    def _tally(self, rid: int, i: int, ballot: Ballot,
               cents_per_assignment: float) -> int:
        """The ballot's label (the worker model's under EM, recorded now),
        its votes tallied against that label, its workers seen on the pair
        and its assignments billed to the request."""
        if self.worker_model is not None:
            label = self.worker_model.record(ballot.votes, ballot.workers)
        else:
            label = ballot.label
        # the request's one-vote runs were settled by ``seen_workers``
        self._seen.setdefault((rid, i), set()).update(ballot.workers)
        k = len(ballot.votes)
        self.n_votes += k
        self.n_minority_votes += sum(v != label for v in ballot.votes)
        self._assignments[rid] = self._assignments.get(rid, 0) + k
        self._spent_cents[rid] = (self._spent_cents.get(rid, 0.0)
                                  + cents_per_assignment * k)
        return label

    def _push_task(self, task: _Task) -> None:
        """A task waits for a worker (latency mode)."""
        if self.nf:
            heapq.heappush(self._tasks, (task.likelihood, task.rid,
                                         task.answers[0][0], self._posted,
                                         task))
            self._posted += 1
        else:
            self._tasks.append(task)

    def _post_one_vote(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
                       cents_per_assignment: float) -> None:
        """What a ballot per pair records, for a crowd whose ballot is one
        vote from a freshly minted worker (``exclude`` cannot matter, no vote
        is in the minority), at a fraction of the cost: the fused rounds
        replay every pair of a deterministic crowd through here.  The
        workers seen on the pairs are logged once for the post and folded
        into ``_seen`` only when asked for."""
        workers = crowd._fresh_workers(len(indices))
        spent = self._spent_cents.get(rid, 0.0)
        waiting = self._waiting
        # one votes tuple per label, shared by the answers: every object
        # allocated here is garbage-collector work while the answers wait
        one_vote: Dict[int, Tuple[int]] = {}
        for i, worker in zip(indices, workers):
            label = crowd.ask(pairs, i)
            votes = one_vote.get(label)
            if votes is None:
                votes = one_vote[label] = (label,)
            waiting.append(CrowdAnswer(rid, i, label, 0.0, votes, (worker,)))
            spent += cents_per_assignment  # times one vote: exact
        self._seen_runs.setdefault(rid, []).append((indices, workers))
        if indices:
            self._waiting_runs.append((len(indices), pairs.likelihood, False))
        self._spent_cents[rid] = spent
        self._assignments[rid] = self._assignments.get(rid, 0) + len(indices)
        self.n_votes += len(indices)

    def post_cluster(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
                     cents: float = 0.0, n_assignments: int = 1,
                     pair_cents_per_assignment: float = 0.0) -> CrowdTicket:
        """Post one :class:`ClusterTask` over ``indices`` (§15):
        ``n_assignments`` distinct workers (the worker model's most trusted
        first under EM) each partition the objects behind the pairs.  The
        verdicts every assignment agrees on land together as one task;
        disagreed pairs escalate at once to pair ballots billed at
        ``pair_cents_per_assignment``, so every index is answered once.  The
        task bills ``cents`` and ``n_assignments`` assignments; its verdicts
        feed neither the vote tallies nor the worker model."""
        indices = tuple(int(i) for i in indices)
        prefer: Tuple[int, ...] = ()
        if self.worker_model is not None:
            prefer = tuple(self.worker_model.best_workers())
        verdicts: List[Tuple[Tuple[int, ...], int]] = []
        for _ in range(max(1, int(n_assignments))):
            asked = tuple(w for _, w in verdicts)
            labels, worker = crowd.ask_cluster(
                pairs, indices,
                prefer=tuple(w for w in prefer if w not in asked),
                exclude=asked)
            verdicts.append((labels, int(worker)))
        workers = tuple(w for _, w in verdicts)
        answers = []
        escalate = []
        for j, i in enumerate(indices):
            votes = tuple(int(lab[j]) for lab, _ in verdicts)
            if all(v == votes[0] for v in votes):
                answers.append((i, votes[0], votes, workers))
            else:
                escalate.append(i)
        for i in indices:
            self._seen.setdefault((rid, i), set()).update(workers)
        self._assignments[rid] = (self._assignments.get(rid, 0)
                                  + len(verdicts))
        self._spent_cents[rid] = self._spent_cents.get(rid, 0.0) + cents
        self.n_posted += len(indices) - len(escalate)  # _enqueue counts those
        self.n_cluster_tasks += 1
        self.n_cluster_pairs += len(answers)
        self._cluster_pairs[rid] = (self._cluster_pairs.get(rid, 0)
                                    + len(answers))
        if answers:
            likelihood = float(min(float(pairs.likelihood[i])
                                   for i, *_ in answers))
            if self.latency is not None:
                self._push_task(_Task(rid, answers, likelihood))
            else:
                self._waiting.extend(
                    CrowdAnswer(rid, i, lab, 0.0, votes, ws)
                    for i, lab, votes, ws in answers)
                self._waiting_extra += len(answers) - 1
                self._waiting_runs.append((len(answers), likelihood, True))
        if escalate:
            self._enqueue(rid, pairs, escalate, crowd, None,
                          pair_cents_per_assignment)
        if self.latency is not None:
            self._assign()
        return self._ticket(rid, indices)

    def requery(self, rid: int, pairs: PairSet, indices, crowd: Crowd,
                cents_per_assignment: float = 0.0,
                budget_cents: Optional[float] = None
                ) -> Tuple[CrowdTicket, List[int]]:
        """Escalate rejected answers (DESIGN.md §9): re-post each pair with
        ``crowd.n_assignments + 2 * (attempt + 1)`` assignments, routed
        around the workers seen on it where the pool allows.  A pair already
        requeried ``max_requeries`` times, or one whose escalation the
        remaining ``budget_cents`` cannot buy, is not re-posted: it comes
        back exhausted, for the caller to trust the graph.  Escalations post
        grouped by assignment count, ascending.  Returns ``(ticket over the
        re-posted pairs, exhausted indices)``."""
        base = getattr(crowd, "n_assignments", 1)
        by_escalation: Dict[int, List[int]] = {}
        exhausted: List[int] = []
        planned_cents = 0.0
        for i in (int(j) for j in indices):
            attempt = self._attempts.get((rid, i), 0)
            if attempt >= self.max_requeries:
                exhausted.append(i)
                continue
            k = base + 2 * (attempt + 1)
            cost = cents_per_assignment * k
            if budget_cents is not None and \
                    self.spent_cents(rid) + planned_cents + cost > \
                    budget_cents + 1e-9:
                exhausted.append(i)  # unaffordable: the graph outvotes
                continue
            planned_cents += cost
            self._attempts[(rid, i)] = attempt + 1
            by_escalation.setdefault(k, []).append(i)
        posted: List[int] = []
        for k, idx in sorted(by_escalation.items()):
            posted.extend(self._enqueue(rid, pairs, idx, crowd, k,
                                        cents_per_assignment))
        self.n_requeried += len(posted)
        return self._ticket(rid, tuple(posted)), exhausted

    def _assign(self) -> None:
        """Free workers pick up waiting tasks (NF: lowest likelihood
        first), each drawing its completion time."""
        while self._free_workers > 0 and self._tasks:
            if self.nf:
                task = heapq.heappop(self._tasks)[-1]
            else:
                task = self._tasks.pop(
                    int(self._rng.integers(len(self._tasks))))
            dt = float(self.latency.draw_minutes(self._rng, 1)[0])
            heapq.heappush(self._running, (self._now + dt, self._seq, task))
            self._seq += 1
            self._free_workers -= 1

    def poll(self) -> List[CrowdAnswer]:
        """Immediate mode: everything posted so far, at simulated time 0.
        Latency mode: advance the clock to the next completion and return
        the answers landing then (a cluster task's verdicts together); the
        freed workers pick up waiting tasks at once."""
        if self.latency is None:
            out, self._waiting = self._waiting, []
            self._waiting_extra = 0
            self._waiting_runs = []
            self.n_answered += len(out)
            return out
        if not self._running:
            return []
        t0 = self._running[0][0]
        out: List[CrowdAnswer] = []
        while self._running and self._running[0][0] <= t0 + 1e-12:
            t, _, task = heapq.heappop(self._running)
            out.extend(CrowdAnswer(task.rid, i, lab, t, votes, workers)
                       for i, lab, votes, workers in task.answers)
            self._free_workers += 1
        self._now = max(self._now, t0)
        self._assign()
        self.n_answered += len(out)
        return out

    def drain(self) -> List[CrowdAnswer]:
        """Poll until nothing is in flight (the round-barrier transport):
        every outstanding answer, in completion order."""
        out = self.poll()
        while self.in_flight:
            out.extend(self.poll())
        return out

    # -- persistence (DESIGN.md §16) ------------------------------------
    @staticmethod
    def _task_to_state(rid: int, likelihood: float, answers) -> dict:
        return {"rid": int(rid),
                "likelihood": float(likelihood),
                "answers": [[int(i), int(lab), list(map(int, votes)),
                             list(map(int, workers))]
                            for i, lab, votes, workers in answers]}

    @staticmethod
    def _task_from_state(d: dict) -> _Task:
        return _Task(
            rid=int(d["rid"]),
            answers=[(int(i), int(lab), tuple(votes), tuple(workers))
                     for i, lab, votes, workers in d["answers"]],
            likelihood=float(d["likelihood"]))

    def _waiting_tasks(self) -> List[dict]:
        """The tasks not yet picked up (latency mode) or not yet polled
        (immediate mode), in the reference's list order: posting order, a
        pair ballot or a cluster task each."""
        if self.latency is not None:
            tasks = self._tasks
            if self.nf:  # heap entries (lik, rid, index, posting seq, task)
                tasks = [e[-1] for e in sorted(tasks, key=lambda e: e[3])]
            return [self._task_to_state(t.rid, t.likelihood, t.answers)
                    for t in tasks]
        out, pos = [], 0
        for n, likelihood, one_task in self._waiting_runs:
            run = self._waiting[pos:pos + n]
            pos += n
            entries = [(a.index, a.label, a.votes, a.workers) for a in run]
            if one_task:
                out.append(self._task_to_state(run[0].rid, likelihood,
                                               entries))
            else:
                out.extend(self._task_to_state(a.rid,
                                               float(likelihood[a.index]),
                                               [e])
                           for a, e in zip(run, entries))
        return out

    def state_dict(self) -> dict:
        """JSON snapshot of everything the platform remembers, in the
        reference's schema: the tasks in flight (waiting and running, their
        answers drawn and billed at post time — a restored service must not
        buy them again), the spend and assignment ledgers, the requery and
        seen-worker bookkeeping (one-vote runs folded in first), the vote
        tallies, the clock, the platform rng and the worker model."""
        for rid in list(self._seen_runs):
            self._settle_seen(rid)
        return {
            "now": float(self._now),
            "seq": int(self._seq),
            "next_tid": int(self._next_tid),
            "rng": (None if self._rng is None else _rng_to_state(self._rng)),
            "waiting": self._waiting_tasks(),
            "running": [[float(t), int(s),
                         self._task_to_state(task.rid, task.likelihood,
                                             task.answers)]
                        for t, s, task in self._running],
            "attempts": [[int(rid), int(i), int(n)]
                         for (rid, i), n in sorted(self._attempts.items())],
            "seen": [[int(rid), int(i), sorted(int(w) for w in ws)]
                     for (rid, i), ws in sorted(self._seen.items())],
            "counters": {
                "n_posted": int(self.n_posted),
                "n_answered": int(self.n_answered),
                "n_requeried": int(self.n_requeried),
                "n_votes": int(self.n_votes),
                "n_minority_votes": int(self.n_minority_votes),
                "n_cluster_tasks": int(self.n_cluster_tasks),
                "n_cluster_pairs": int(self.n_cluster_pairs),
            },
            "cluster_pairs": {str(r): int(n)
                              for r, n in self._cluster_pairs.items()},
            "spent_cents": {str(r): float(c)
                            for r, c in self._spent_cents.items()},
            "assignments": {str(r): int(n)
                            for r, n in self._assignments.items()},
            "worker_model": (None if self.worker_model is None
                             else self.worker_model.state_dict()),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (the port's or the
        reference's) into a gateway built with the same ``(latency, nf,
        aggregation)``: waiting tasks back on the platform queue (under
        ``nf`` the heap, ties in posting order) or, in immediate mode, back
        as unpolled answers; running tasks back on the completion heap with
        their finish times; the free workers recounted."""
        self._now = float(state["now"])
        self._seq = int(state["seq"])
        self._next_tid = int(state["next_tid"])
        if state["rng"] is not None:
            self._rng = _rng_from_state(state["rng"])
        waiting = [self._task_from_state(d) for d in state["waiting"]]
        self._tasks, self._waiting, self._waiting_runs = [], [], []
        self._waiting_extra = 0
        self._posted = 0
        if self.latency is not None:
            for task in waiting:
                self._push_task(task)
        else:
            for task in waiting:
                self._waiting.extend(
                    CrowdAnswer(task.rid, i, lab, 0.0, votes, workers)
                    for i, lab, votes, workers in task.answers)
                self._waiting_extra += len(task.answers) - 1
                self._waiting_runs.append(
                    (len(task.answers), task.likelihood, True))
        self._running = [(float(t), int(s), self._task_from_state(d))
                         for t, s, d in state["running"]]
        heapq.heapify(self._running)
        if self.latency is not None:
            self._free_workers = self.latency.n_workers - len(self._running)
        self._attempts = {(int(rid), int(i)): int(n)
                          for rid, i, n in state["attempts"]}
        self._seen = {(int(rid), int(i)): {int(w) for w in ws}
                      for rid, i, ws in state["seen"]}
        self._seen_runs = {}
        for k, v in state["counters"].items():
            setattr(self, k, int(v))
        self._cluster_pairs = {int(r): int(n)
                               for r, n in state["cluster_pairs"].items()}
        self._spent_cents = {int(r): float(c)
                             for r, c in state["spent_cents"].items()}
        self._assignments = {int(r): int(n)
                             for r, n in state["assignments"].items()}
        if state["worker_model"] is not None:
            if self.worker_model is None:
                self.worker_model = WorkerModel()
            self.worker_model.load_state_dict(state["worker_model"])
