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
deduction sweep, until every pair is labeled.

``simulate_stream``: event-driven simulator where pairs return one at a
time — the **instant decision** (ID) and **non-matching first** (NF)
optimizations of §5.2 and the Figure 16 availability curves; the host
oracle of the service's asynchronous discipline.

``simulate_wallclock_parallel_id`` / ``simulate_wallclock_sequential``:
discrete-event AMT simulator (HIT batching, worker pool, lognormal
assignment latencies) for Table 1 / Table 2 completion times.  Their rng
draws are the reference's, draw for draw.

Labels are the engine codes ``POS`` / ``NEG``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .cluster_graph import NEG, POS, ClusterGraph
from .crowd import CostModel, Crowd, LatencyModel
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


# ---------------------------------------------------------------------------
# §5.2 event-driven stream simulator (Figure 16)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StreamTrace:
    labeled_count: List[int]
    available_count: List[int]
    result: LabelingResult


def simulate_stream(
    pairs: PairSet,
    order: np.ndarray,
    crowd: Crowd,
    mode: str = "parallel",  # parallel | id | id+nf
    seed: int = 0,
) -> StreamTrace:
    """Pairs return from the platform one at a time.  ``parallel`` publishes
    a new batch only when the platform drains; ``id`` re-selects instantly
    after every returned label; ``id+nf`` additionally makes workers label
    probable-non-matching pairs first (ascending likelihood)."""
    if mode not in ("parallel", "id", "id+nf"):
        raise ValueError(f"mode must be parallel, id or id+nf, got {mode!r}")
    rng = np.random.default_rng(seed)
    n = len(pairs)
    known: Dict[int, int] = {}
    crowdsourced = np.zeros(n, dtype=bool)
    published: Set[int] = set()
    batch_sizes: List[int] = []
    # persistent evidence graph for noisy streams (DESIGN.md §9): a returned
    # label contradicting it is dropped and replaced by the deduced label
    g = ClusterGraph(pairs.n_objects)

    def publish_initial():
        batch = parallel_crowdsourced_pairs(pairs, order, known,
                                            exclude=published)
        published.update(batch)
        if batch:
            batch_sizes.append(len(batch))

    publish_initial()
    trace_l, trace_a = [0], [len(published)]

    while len(known) < n:
        if not published:
            # platform drained: sweep + republish (all modes)
            deduction_sweep(pairs, order, known)
            if len(known) == n:
                break
            publish_initial()
            trace_l.append(len(known))
            trace_a.append(len(published))
            continue
        # pick which in-flight pair the crowd finishes next
        plist = sorted(published)
        if mode == "id+nf":
            # workers are steered to probable-non-matching pairs first
            i = plist[int(np.argmin(pairs.likelihood[plist]))]
        else:
            i = plist[int(rng.integers(len(plist)))]
        lab = crowd.ask(pairs, i)
        if not g.add_label(int(pairs.u[i]), int(pairs.v[i]), lab):
            lab = g.deduce(int(pairs.u[i]), int(pairs.v[i]))
        known[i] = lab
        crowdsourced[i] = True
        published.discard(i)
        if mode in ("id", "id+nf") and lab == NEG:
            # §5.2 non-matching-first observation: a returned match agrees
            # with the optimistic assumption — selection cannot change
            deduction_sweep(pairs, order, known, skip=published)
            published.update(parallel_crowdsourced_pairs(
                pairs, order, known, exclude=published))
        trace_l.append(len(known))
        trace_a.append(len(published))

    return StreamTrace(trace_l, trace_a,
                       _result(n, known, crowdsourced, batch_sizes, g))


# ---------------------------------------------------------------------------
# Discrete-event AMT wall-clock simulator (Tables 1 & 2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WallClock:
    hours: float
    n_hits: int
    n_pairs_crowdsourced: int
    cost_cents: float
    labels: Dict[int, int]
    hits: List[List[int]] = dataclasses.field(default_factory=list)
    n_conflicts: int = 0


def simulate_wallclock_parallel_id(
    pairs: PairSet,
    order: np.ndarray,
    crowd: Crowd,
    cost: CostModel,
    latency: LatencyModel,
    seed: int = 0,
) -> WallClock:
    """AMT deployment model of §6.4 for Parallel(ID): selected pairs are
    batched 20-to-a-HIT, each HIT replicated into 3 assignments, a finite
    worker pool draws assignments at random, per-assignment latency is
    lognormal.  When a HIT completes, instant decision re-selects and new
    HITs are published immediately."""
    rng = np.random.default_rng(seed)
    known: Dict[int, int] = {}
    published: Set[int] = set()
    g = ClusterGraph(pairs.n_objects)   # persistent evidence graph (§9)
    hits: List[List[int]] = []          # hit id -> pair indices
    hit_remaining: Dict[int, int] = {}  # hit id -> assignments outstanding
    pending_pairs: List[int] = []       # selected, not yet in a HIT
    assignment_queue: List[int] = []    # hit ids awaiting a worker
    workers = [(0.0, w) for w in range(latency.n_workers)]
    heapq.heapify(workers)
    events: List[Tuple[float, int, int]] = []  # (time, seq, hit id)
    seq = 0
    now = 0.0

    def select_new():
        batch = parallel_crowdsourced_pairs(pairs, order, known,
                                            exclude=published)
        published.update(batch)
        pending_pairs.extend(batch)

    def flush_hits(force: bool):
        while len(pending_pairs) >= cost.pairs_per_hit or \
                (force and pending_pairs):
            chunk = pending_pairs[: cost.pairs_per_hit]
            del pending_pairs[: len(chunk)]
            hid = len(hits)
            hits.append(chunk)
            hit_remaining[hid] = cost.assignments_per_hit
            assignment_queue.extend([hid] * cost.assignments_per_hit)

    def dispatch():
        nonlocal seq
        while assignment_queue and workers[0][0] <= now + 1e-9:
            _, w = heapq.heappop(workers)
            k = int(rng.integers(len(assignment_queue)))  # AMT random pick
            hid = assignment_queue.pop(k)
            done = now + float(latency.draw_minutes(rng, 1)[0])
            heapq.heappush(events, (done, seq, hid))
            seq += 1
            heapq.heappush(workers, (done, w))

    select_new()
    flush_hits(force=True)
    dispatch()

    while events:
        now, _, hid = heapq.heappop(events)
        hit_remaining[hid] -= 1
        if hit_remaining[hid] == 0:
            # HIT complete: all its pairs get their majority-vote labels
            # (contradictory noisy labels drop to the deduced value, §9)
            for i in hits[hid]:
                lab = crowd.ask(pairs, i)
                if not g.add_label(int(pairs.u[i]), int(pairs.v[i]), lab):
                    lab = g.deduce(int(pairs.u[i]), int(pairs.v[i]))
                known[i] = lab
                published.discard(i)
            deduction_sweep(pairs, order, known, skip=published)
            select_new()
            # flush a partial HIT only when the platform would otherwise idle
            flush_hits(force=not events and not assignment_queue)
        dispatch()

    # anything still unlabeled is deducible
    deduction_sweep(pairs, order, known)
    return WallClock(
        hours=now / 60.0,
        n_hits=len(hits),
        n_pairs_crowdsourced=sum(len(h) for h in hits),
        cost_cents=len(hits) * cost.assignments_per_hit
        * cost.cents_per_assignment,
        labels=known,
        hits=hits,
        n_conflicts=g.n_conflicts,
    )


def simulate_wallclock_sequential(
    hits: List[List[int]],
    cost: CostModel,
    latency: LatencyModel,
    seed: int = 0,
) -> float:
    """Non-Parallel baseline of Table 1: the *same* HITs as Parallel(ID),
    published one at a time — each HIT's 3 assignments run concurrently,
    the next HIT is published only when the previous completes.  Returns
    hours."""
    rng = np.random.default_rng(seed + 1)
    total_min = 0.0
    for _ in hits:
        total_min += float(latency.draw_minutes(
            rng, cost.assignments_per_hit).max())
    return total_min / 60.0
