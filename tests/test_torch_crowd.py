"""The port's crowds and gateway (``repro_torch.core.crowd``) against the JAX
package's, on the same seeds: ``NoisyCrowd`` ballots (labels, votes, worker
ids) in the homogeneous and the pool mode, with ``exclude``, must be the
reference's draw for draw, and so must the next rng draw afterwards; the
gateway's spend, vote tallies and measured disagreement must be identical.
The reference's ballot labels are paper strings, the port's engine codes:
``MATCH`` is ``POS``, ``NON_MATCH`` is ``NEG``."""
import numpy as np
import pytest

from repro.core import MATCH
from repro.core import CrowdGateway as JaxGateway
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core.pairs import PairSet as JaxPairSet
from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.crowd import (Crowd, CrowdGateway, NoisyCrowd,
                                    PerfectCrowd, _require_odd)
from repro_torch.core.pairs import PairSet


def _pairs(seed: int, p: int = 40):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 30, p)
    v = (u + 1 + rng.integers(0, 29, p)) % 30
    truth = rng.random(p) < 0.4
    lik = rng.random(p).astype(np.float32)
    return JaxPairSet(u, v, lik, truth, 30), PairSet(u, v, lik, truth, 30)


def _code(label) -> int:
    return POS if label == MATCH else NEG


CROWDS = {
    "homogeneous": dict(error_rate=0.3, seed=4),
    "homogeneous-unqualified": dict(error_rate=0.35, qualification=False,
                                    seed=10, n_assignments=5),
    "pool": dict(error_rate=0.1, n_assignments=3, seed=7, n_workers=25,
                 worker_concentration=3.0, qualification=False),
    "small-pool": dict(error_rate=0.2, n_assignments=3, seed=2, n_workers=4),
}


@pytest.mark.parametrize("kind", sorted(CROWDS))
def test_noisy_ballots_match_reference(kind):
    ref_pairs, pairs = _pairs(1)
    ref = JaxNoisyCrowd(**CROWDS[kind])
    got = NoisyCrowd(**CROWDS[kind])
    if ref.worker_errors is None:
        assert got.worker_errors is None
    else:
        np.testing.assert_array_equal(got.worker_errors, ref.worker_errors)
    assert got.error_rate == ref.error_rate
    rng = np.random.default_rng(0)
    for i in range(len(pairs)):
        # escalated questions and routed-around workers in between
        choices = [1, 3] if (got.n_workers or 5) < 5 else [1, 3, 5]
        k = int(rng.choice(choices)) if i % 3 == 0 else None
        exclude = tuple(int(w) for w in rng.choice(
            max(got.n_workers or 0, 6), size=int(rng.integers(0, 5)),
            replace=False))
        b_ref = ref.ask_ballot(ref_pairs, i, k, exclude=exclude)
        b_got = got.ask_ballot(pairs, i, k, exclude=exclude)
        assert (b_got.label, b_got.votes, b_got.workers) == \
            (_code(b_ref.label), b_ref.votes, b_ref.workers), f"pair {i}"
        assert len(set(b_got.workers)) == len(b_got.workers)
    # votes and labels through the other entry points stay in step too
    label, votes = ref.ask_votes(ref_pairs, 0)
    assert got.ask_votes(pairs, 0) == (_code(label), votes)
    assert got.ask(pairs, 2) == _code(ref.ask(ref_pairs, 2))
    assert got.n_asked == ref.n_asked
    assert got.rng.random() == ref.rng.random()


def test_noisy_crowd_analytics_match_reference():
    for kw in CROWDS.values():
        ref, got = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
        assert got.pair_error_rate() == ref.pair_error_rate()
        assert got.pair_error_rate(5) == ref.pair_error_rate(5)
        assert got.expected_minority_fraction() == \
            ref.expected_minority_fraction()
        assert got.precomputed_answers(_pairs(0)[1]) is None


@pytest.mark.parametrize("k", [0, 2, -1])
def test_even_or_empty_votes_are_refused(k):
    with pytest.raises(ValueError, match="odd"):
        _require_odd(k)
    with pytest.raises(ValueError, match="odd"):
        NoisyCrowd(n_assignments=k)
    with pytest.raises(ValueError, match="odd"):
        NoisyCrowd(seed=1).ask_ballot(_pairs(0)[1], 0, n_assignments=k)
    with pytest.raises(ValueError, match="cannot cover"):
        NoisyCrowd(n_workers=2, n_assignments=3)


def test_deterministic_ballots_mint_fresh_workers_as_reference():
    ref_pairs, pairs = _pairs(3)
    ref, got = JaxPerfectCrowd(), PerfectCrowd()
    for i in range(6):
        b_ref = ref.ask_ballot(ref_pairs, i, exclude=(0, 1))
        b_got = got.ask_ballot(pairs, i, exclude=(0, 1))
        assert (b_got.label, b_got.votes, b_got.workers) == \
            (_code(b_ref.label), b_ref.votes, b_ref.workers)
    got.reset()
    assert got.n_asked == 0 and got.ask_ballot(pairs, 0).workers == (0,)
    with pytest.raises(NotImplementedError):
        Crowd().ask_ballot(pairs, 0)
    with pytest.raises(ValueError, match="ground truth"):
        PerfectCrowd().ask(PairSet(pairs.u, pairs.v, pairs.likelihood), 0)


@pytest.mark.parametrize("cents", [2.0, 0.1, 1.7])
@pytest.mark.parametrize("kind", ["homogeneous", "pool"])
def test_gateway_ledger_matches_reference(kind, cents):
    """Batches from two requests, one pair posted twice (its second ballot
    routed around the workers seen on it), billed at rates that are not
    exact in binary: the running spend must round as the reference's one
    multiply-add a ballot does."""
    ref_pairs, pairs = _pairs(5, p=60)
    ref_crowd = JaxNoisyCrowd(**CROWDS[kind])
    crowd = NoisyCrowd(**CROWDS[kind])
    ref_gw, gw = JaxGateway(), CrowdGateway()
    batches = [(0, range(0, 20)), (1, range(10, 35)), (0, [3, 20, 21]),
               (1, range(35, 60))]
    for rid, idx in batches:
        t_ref = ref_gw.post(rid, ref_pairs, idx, ref_crowd,
                            cents_per_assignment=cents)
        t_got = gw.post(rid, pairs, idx, crowd, cents_per_assignment=cents)
        assert (t_got.tid, t_got.rid, t_got.indices) == \
            (t_ref.tid, t_ref.rid, t_ref.indices)
        assert gw.in_flight == ref_gw.in_flight
        a_ref, a_got = ref_gw.drain(), gw.drain()
        assert [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
                for a in a_got] == \
            [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
             for a in a_ref]
    for rid in (0, 1, 2):
        assert gw.spent_cents(rid) == ref_gw.spent_cents(rid)
        assert gw.assignments_posted(rid) == ref_gw.assignments_posted(rid)
        assert gw.cluster_pairs(rid) == 0
    assert gw.seen_workers(0, 3) == ref_gw.seen_workers(0, 3)
    assert len(gw.seen_workers(0, 3)) == 6
    assert (gw.n_posted, gw.n_answered, gw.n_votes, gw.n_minority_votes) == \
        (ref_gw.n_posted, ref_gw.n_answered, ref_gw.n_votes,
         ref_gw.n_minority_votes)
    assert gw.n_minority_votes > 0
    assert gw.measured_disagreement == ref_gw.measured_disagreement
    assert crowd.rng.random() == ref_crowd.rng.random()


@pytest.mark.parametrize("cents", [2.0, 0.1])
def test_gateway_one_vote_posts_match_reference(cents):
    """A deterministic crowd's posts take the gateway's one-vote path; the
    answers, worker ids, spend and seen workers must be the reference's,
    also when a pool crowd later routes around the workers seen on a pair
    (the one-vote log is folded into ``seen_workers`` on demand)."""
    ref_pairs, pairs = _pairs(6, p=50)
    ref_perfect, perfect = JaxPerfectCrowd(), PerfectCrowd()
    ref_noisy = JaxNoisyCrowd(**CROWDS["small-pool"])
    noisy = NoisyCrowd(**CROWDS["small-pool"])
    ref_gw, gw = JaxGateway(), CrowdGateway()
    batches = [(0, range(0, 20), 0), (1, range(5, 30), 0), (0, [2, 3], 0),
               (0, [1, 2, 3, 40], 1), (1, range(30, 50), 0)]
    for rid, idx, use_noisy in batches:
        ref_crowd, crowd = ((ref_noisy, noisy) if use_noisy
                            else (ref_perfect, perfect))
        ref_gw.post(rid, ref_pairs, idx, ref_crowd,
                    cents_per_assignment=cents)
        gw.post(rid, pairs, idx, crowd, cents_per_assignment=cents)
        a_ref, a_got = ref_gw.drain(), gw.drain()
        assert [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
                for a in a_got] == \
            [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
             for a in a_ref]
    for rid in (0, 1):
        assert gw.spent_cents(rid) == ref_gw.spent_cents(rid)
        assert gw.assignments_posted(rid) == ref_gw.assignments_posted(rid)
        for i in (0, 2, 3, 7, 40, 49):
            assert gw.seen_workers(rid, i) == ref_gw.seen_workers(rid, i)
    assert len(gw.seen_workers(0, 2)) == 5  # two one-vote posts, a ballot
    assert (gw.n_posted, gw.n_answered, gw.n_votes, gw.n_minority_votes) == \
        (ref_gw.n_posted, ref_gw.n_answered, ref_gw.n_votes,
         ref_gw.n_minority_votes)
    assert perfect.n_asked == ref_perfect.n_asked
    assert noisy.rng.random() == ref_noisy.rng.random()

