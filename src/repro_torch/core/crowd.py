"""Crowd platform simulators and crowd transport (§2.1, §6.4) — the part of
``repro/core/crowd.py`` the port's round-barrier serving path runs.

* :class:`PerfectCrowd` — always returns ground truth (the §2.1 assumption);
  its ``precomputed_answers`` let the round engine fold many rounds without
  surfacing each frontier to the host.
* :class:`NoisyCrowd` — each of ``n_assignments`` workers flips the true
  label with probability ``error_rate`` (reduced by a qualification-test
  pass rate), final label by majority vote — the §6.4 deployment model.
  With ``n_workers`` set it simulates a heterogeneous pool whose per-worker
  error rates are drawn from a Beta distribution.  Its rng stream is the
  reference's draw for draw, so the same seed gives the same ballots.
* :class:`CostModel` — AMT accounting of §6.4.
* :class:`LatencyModel` — lognormal per-assignment completion times and a
  finite worker pool: the simulated asynchronous platform.
* :class:`CrowdGateway` — the batched transport.  In immediate mode every
  posted pair is answered on the next ``poll`` at simulated time 0; with a
  ``LatencyModel`` a pool of workers picks waiting pairs (at random, as AMT
  assigns, or lowest likelihood first under ``nf``) and ``poll`` advances
  the platform clock to the next completion.  Each ballot is billed against
  its request and its votes are tallied.  The gateway's rng draws (worker
  picks, then each pick's latency) are the reference's, draw for draw.

Labels are in engine encoding (``POS`` / ``NEG``) throughout, ballots'
included.  Requery, worker reliability and cluster tasks are not ported yet
(ROADMAP A9.4, A9.8).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

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
    implement :meth:`ask`; :meth:`ask_votes` and :meth:`ask_ballot` have
    default implementations in terms of it that deterministic crowds inherit.
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
                    prefer: Sequence[int] = (), exclude: Sequence[int] = ()):
        """A CrowdER-style cluster task: not ported yet."""
        raise NotImplementedError(
            "cluster tasks are not ported yet: ROADMAP A9.8")

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
    it and the ids of the workers who cast them.  A named tuple: the
    gateway builds one a pair on its hot path."""

    rid: int
    index: int
    label: int
    minutes: float
    votes: Tuple[int, ...] = ()
    workers: Tuple[int, ...] = ()


@dataclasses.dataclass
class _Task:
    """One unit of platform work a single worker picks up: a pair ballot,
    as ``(index, label, votes, workers)`` in a one-entry list."""

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
      ballot is a task a single worker of ``latency.n_workers`` picks up
      (uniformly at random, or lowest likelihood first with ``nf=True``,
      the §5.2 non-matching-first steering) and completes after a lognormal
      number of minutes; ``poll`` advances the clock (``now_minutes``) to the
      next completion and returns the answers landing then.

    ``measured_disagreement`` is the minority-vote fraction over every
    ballot posted."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 nf: bool = False) -> None:
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
        self.latency = latency
        self.nf = nf
        # latency mode only: the platform's rng (worker picks, latencies),
        # the tasks waiting for a worker — a list picked at random, or under
        # nf a heap on (likelihood, rid, index), the reference's min key,
        # which no two waiting pairs share — and the running tasks, a
        # min-heap on (t_done, seq)
        self._rng = latency.sampler() if latency is not None else None
        self._tasks: List = []
        self._running: List[Tuple[float, int, _Task]] = []
        self._free_workers = latency.n_workers if latency is not None else 0
        self._now = 0.0
        self._seq = 0
        # immediate mode: the answers posted, not yet polled
        self._waiting: List[CrowdAnswer] = []
        self._seen: Dict[Tuple[int, int], Set[int]] = {}
        # one-vote posts not yet folded into _seen: per request, a list of
        # (indices, workers), aligned
        self._seen_runs: Dict[int, List[Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]]] = {}
        self._spent_cents: Dict[int, float] = {}
        self._assignments: Dict[int, int] = {}
        self._next_tid = 0
        self.n_posted = 0
        self.n_answered = 0
        self.n_votes = 0
        self.n_minority_votes = 0

    def spent_cents(self, rid: int) -> float:
        """Cents spent on a request so far (assignment-level accounting)."""
        return self._spent_cents.get(rid, 0.0)

    def assignments_posted(self, rid: int) -> int:
        """Crowd assignments bought for a request so far."""
        return self._assignments.get(rid, 0)

    def cluster_pairs(self, rid: int) -> int:
        """Pairs a request resolved through cluster tasks: none, since this
        gateway posts pair questions only (cluster tasks: ROADMAP A9.8)."""
        return 0

    @property
    def now_minutes(self) -> float:
        """Simulated platform wall clock in minutes."""
        return self._now

    @property
    def in_flight(self) -> int:
        """Tasks posted but not yet answered (waiting + running)."""
        return len(self._waiting) + len(self._tasks) + len(self._running)

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
        indices = tuple(int(i) for i in indices)
        if self.latency is not None:
            for i in indices:
                ballot = crowd.ask_ballot(pairs, i,
                                          exclude=self.seen_workers(rid, i))
                self._bill(rid, ballot, cents_per_assignment)
                self._seen.setdefault((rid, i), set()).update(ballot.workers)
                task = _Task(rid, [(i, ballot.label, ballot.votes,
                                    ballot.workers)],
                             float(pairs.likelihood[i]))
                if self.nf:
                    heapq.heappush(self._tasks,
                                   (task.likelihood, rid, i, task))
                else:
                    self._tasks.append(task)
            self._assign()
        elif _one_vote_ballots(crowd):
            self._post_one_vote(rid, pairs, indices, crowd,
                                cents_per_assignment)
        else:
            for i in indices:
                self._post_ballot(rid, crowd.ask_ballot(
                    pairs, i, exclude=self.seen_workers(rid, i)), i,
                    cents_per_assignment)
        self.n_posted += len(indices)
        tid = self._next_tid
        self._next_tid += 1
        return CrowdTicket(tid=tid, rid=rid, indices=indices)

    def _bill(self, rid: int, ballot: Ballot,
              cents_per_assignment: float) -> None:
        """Tally a ballot's votes and bill its assignments to the request."""
        k = len(ballot.votes)
        self.n_votes += k
        self.n_minority_votes += sum(v != ballot.label for v in ballot.votes)
        self._assignments[rid] = self._assignments.get(rid, 0) + k
        self._spent_cents[rid] = (self._spent_cents.get(rid, 0.0)
                                  + cents_per_assignment * k)

    def _post_ballot(self, rid: int, ballot: Ballot, i: int,
                     cents_per_assignment: float) -> None:
        # the request's one-vote runs were settled by ``seen_workers``
        self._seen.setdefault((rid, i), set()).update(ballot.workers)
        self._bill(rid, ballot, cents_per_assignment)
        self._waiting.append(CrowdAnswer(rid, i, ballot.label, 0.0,
                                         ballot.votes, ballot.workers))

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
        self._spent_cents[rid] = spent
        self._assignments[rid] = self._assignments.get(rid, 0) + len(indices)
        self.n_votes += len(indices)

    def requery(self, *args, **kwargs):
        """Escalated re-posts of rejected answers: not ported yet."""
        raise NotImplementedError(
            "requery escalation is not ported yet: ROADMAP A9.4")

    def post_cluster(self, *args, **kwargs):
        """Cluster tasks: not ported yet."""
        raise NotImplementedError(
            "cluster tasks are not ported yet: ROADMAP A9.8")

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
        the answers landing then; the freed workers pick up waiting tasks
        at once."""
        if self.latency is None:
            out, self._waiting = self._waiting, []
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
