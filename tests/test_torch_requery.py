"""Requery escalation (ROADMAP A9.4): the port's ``CrowdGateway.requery``
and ``JoinService(conflict_policy="requery")`` against the JAX package's,
on the CPU, on the same seeds.

The gateway's escalation ladder (``n_assignments + 2 * (attempt + 1)``
ballots, routed around the workers seen on the pair, exhausted past
``max_requeries`` or an unaffordable budget) must draw the reference's
ballots draw for draw: labels, votes, workers, the crowd's next rng draw,
spend and counters.  The service's results must be identical field for
field under both disciplines, after the fused path's conflict exit too.
The reference's labels are paper strings, the port's engine codes."""
import dataclasses

import numpy as np
import pytest

from repro.core import CrowdGateway as JaxGateway
from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core.pairs import PairSet as JaxPairSet
from repro.data.entities import make_session_pairsets
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.crowd import (CrowdGateway, LatencyModel, NoisyCrowd,
                                    PerfectCrowd)
from repro_torch.core.metrics import transitively_consistent
from repro_torch.core.pairs import PairSet
from repro_torch.serve.join_service import JoinService


def _fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (val.dtype, val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.asdict(val)
        out[f.name] = val
    return out


def _both(ps):
    return ps, PairSet(ps.u, ps.v, ps.likelihood, ps.truth, ps.n_objects)


def _truth_pairs(m: int, seed: int = 0):
    """``m`` disjoint pairs, likelihood descending in index, truth at
    random (``tests/test_crowd.py``'s shape)."""
    rng = np.random.default_rng(seed)
    u = np.arange(m, dtype=np.int32)
    truth = rng.random(m) < 0.5
    lik = np.linspace(0.9, 0.1, m).astype(np.float32)
    return _both(JaxPairSet(u, u + m, lik, truth, n_objects=2 * m))


def _answers(got):
    return [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
            for a in got]


def _gateway_state(gw):
    return (gw.n_posted, gw.n_answered, gw.n_requeried, gw.n_votes,
            gw.n_minority_votes, gw.in_flight, gw.now_minutes)


def _crowds(**kw):
    return JaxNoisyCrowd(**kw), NoisyCrowd(**kw)


def test_gateway_requery_escalates_then_exhausts():
    """``tests/test_conflicts.py:207``: 3-way, then 5-way, then exhausted;
    every rid keeps its own ladder."""
    ref_pairs, pairs = _truth_pairs(4)
    ref_c, c = _crowds(error_rate=0.3, qualification=False, seed=1)
    ref_gw, gw = JaxGateway(), CrowdGateway()
    ref_gw.post(0, ref_pairs, [0, 1], ref_c)
    gw.post(0, pairs, [0, 1], c)
    assert _answers(gw.poll()) == _answers(ref_gw.poll())
    for rid, idx in ((0, [0, 1]), (0, [0, 1]), (7, [0])):
        t_ref, ex_ref = ref_gw.requery(rid, ref_pairs, idx, ref_c)
        t_got, ex_got = gw.requery(rid, pairs, idx, c)
        assert (t_got.tid, t_got.indices, ex_got) == \
            (t_ref.tid, t_ref.indices, ex_ref)
        got = gw.poll()
        assert _answers(got) == _answers(ref_gw.poll())
        assert all(a.n_assignments == 5 for a in got)
        assert _gateway_state(gw) == _gateway_state(ref_gw)
    assert gw.n_requeried == 3 and gw.in_flight == 0
    assert c.rng.random() == ref_c.rng.random()


@pytest.mark.parametrize("budget", [None, 0.0, 13.0, 25.0, 31.0])
@pytest.mark.parametrize("max_requeries", [1, 2])
def test_gateway_requery_ladder_and_budget(budget, max_requeries):
    """A ladder of ``max_requeries`` attempts over pairs at different
    attempts (escalations grouped by assignment count), capped by a budget
    the planned escalations exhaust in index order: tickets, exhausted
    lists, ballots and spend are the reference's."""
    ref_pairs, pairs = _truth_pairs(8, seed=2)
    ref_c, c = _crowds(error_rate=0.2, qualification=False, seed=5,
                       n_workers=12)
    ref_gw = JaxGateway(max_requeries=max_requeries)
    gw = CrowdGateway(max_requeries=max_requeries)
    ref_gw.post(0, ref_pairs, range(8), ref_c, cents_per_assignment=0.5)
    gw.post(0, pairs, range(8), c, cents_per_assignment=0.5)
    assert _answers(gw.drain()) == _answers(ref_gw.drain())
    for idx in ([1, 3, 5], [0, 1, 2, 3, 6], [3, 6, 7], [1, 3]):
        t_ref, ex_ref = ref_gw.requery(0, ref_pairs, idx, ref_c,
                                       cents_per_assignment=0.5,
                                       budget_cents=budget)
        t_got, ex_got = gw.requery(0, pairs, idx, c,
                                   cents_per_assignment=0.5,
                                   budget_cents=budget)
        assert (t_got.indices, ex_got) == (t_ref.indices, ex_ref)
        assert _answers(gw.drain()) == _answers(ref_gw.drain())
        assert gw.spent_cents(0) == ref_gw.spent_cents(0)
        assert gw.assignments_posted(0) == ref_gw.assignments_posted(0)
        assert _gateway_state(gw) == _gateway_state(ref_gw)
    if budget is not None:
        assert gw.spent_cents(0) <= 4.0 * 3 + budget
    assert c.rng.random() == ref_c.rng.random()


def test_requery_routes_to_fresh_workers():
    """``tests/test_crowd.py:212`` on an ``aggregation="em"`` gateway: the
    5-way escalation goes to 5 workers unseen on the pair, labelled by the
    worker model, draw for draw the reference's."""
    ref_pairs, pairs = _truth_pairs(2)
    ref_c, c = _crowds(error_rate=0.2, n_assignments=3, qualification=False,
                       seed=3, n_workers=20)
    ref_gw, gw = JaxGateway(aggregation="em"), CrowdGateway(aggregation="em")
    ref_gw.post(0, ref_pairs, [0], ref_c)
    gw.post(0, pairs, [0], c)
    (first,) = gw.poll()
    assert _answers([first]) == _answers(ref_gw.poll())
    seen = set(gw.seen_workers(0, 0))
    assert seen == set(first.workers) and len(seen) == 3
    t_ref, ex_ref = ref_gw.requery(0, ref_pairs, [0], ref_c)
    t_got, ex_got = gw.requery(0, pairs, [0], c)
    assert (t_got.indices, ex_got) == (t_ref.indices, ex_ref) == ((0,), [])
    (second,) = gw.poll()
    assert _answers([second]) == _answers(ref_gw.poll())
    assert second.n_assignments == 5 and not seen & set(second.workers)
    assert gw.seen_workers(0, 0) == ref_gw.seen_workers(0, 0)
    t2, ex2 = gw.requery(0, pairs, [0], c)
    assert t2.indices == () and ex2 == [0] and gw.in_flight == 0
    assert (gw.n_votes, gw.n_minority_votes) == (ref_gw.n_votes,
                                                 ref_gw.n_minority_votes)


def test_requery_small_pool_tops_up_without_deadlock():
    """``tests/test_crowd.py:235``: fewer unseen workers than the escalated
    ballot needs; the seen ones top it up, as the reference draws them."""
    ref_pairs, pairs = _truth_pairs(1)
    ref_c, c = _crowds(error_rate=0.2, n_assignments=3, qualification=False,
                       seed=4, n_workers=5)
    ref_gw, gw = JaxGateway(), CrowdGateway()
    ref_gw.post(0, ref_pairs, [0], ref_c)
    gw.post(0, pairs, [0], c)
    (first,) = gw.poll()
    assert _answers([first]) == _answers(ref_gw.poll())
    ref_gw.requery(0, ref_pairs, [0], ref_c)
    gw.requery(0, pairs, [0], c)
    (second,) = gw.poll()
    assert _answers([second]) == _answers(ref_gw.poll())
    assert second.n_assignments == 5
    assert set(range(5)) - set(first.workers) <= set(second.workers)


def test_requery_routes_around_one_vote_workers():
    """Pairs first answered on the one-vote path (a ``PerfectCrowd``), whose
    workers are logged lazily, then escalated under a worker pool: the
    exclusion must see them, as the reference's does."""
    ref_pairs, pairs = _truth_pairs(6, seed=1)
    ref_p, p = JaxPerfectCrowd(), PerfectCrowd()
    ref_c, c = _crowds(error_rate=0.2, n_assignments=3, qualification=False,
                       seed=6, n_workers=7)
    ref_gw, gw = JaxGateway(), CrowdGateway()
    ref_gw.post(0, ref_pairs, range(6), ref_p)
    gw.post(0, pairs, range(6), p)
    assert _answers(gw.drain()) == _answers(ref_gw.drain())
    ref_gw.requery(0, ref_pairs, [1, 4], ref_c, cents_per_assignment=2.0)
    gw.requery(0, pairs, [1, 4], c, cents_per_assignment=2.0)
    got = gw.drain()
    assert _answers(got) == _answers(ref_gw.drain())
    # the one-vote path minted worker i for pair i
    assert all(a.index not in a.workers for a in got)
    assert gw.spent_cents(0) == ref_gw.spent_cents(0)
    assert c.rng.random() == ref_c.rng.random()


@pytest.mark.parametrize("nf", [False, True])
def test_requery_on_the_latency_transport(nf):
    """Escalations become waiting tasks on the latency platform: picks,
    completion times and the NF order are the reference's."""
    ref_pairs, pairs = _truth_pairs(10, seed=3)
    lat = dict(n_workers=3, mean_minutes=10.0, sigma=0.7, seed=5)
    ref_gw = JaxGateway(latency=JaxLatencyModel(**lat), nf=nf)
    gw = CrowdGateway(latency=LatencyModel(**lat), nf=nf)
    ref_c, c = _crowds(error_rate=0.25, n_assignments=3, seed=9,
                       n_workers=9, qualification=False)
    ref_gw.post(0, ref_pairs, range(8), ref_c)
    gw.post(0, pairs, range(8), c)
    for step in range(6):
        assert _answers(gw.poll()) == _answers(ref_gw.poll())
        idx = [step, step + 2]
        t_ref, ex_ref = ref_gw.requery(0, ref_pairs, idx, ref_c)
        t_got, ex_got = gw.requery(0, pairs, idx, c)
        assert (t_got.indices, ex_got) == (t_ref.indices, ex_ref)
        assert _gateway_state(gw) == _gateway_state(ref_gw)
    assert _answers(gw.drain()) == _answers(ref_gw.drain())
    assert _gateway_state(gw) == _gateway_state(ref_gw)


def _serve_both(pairsets, crowds, latency=None, **svc_kwargs):
    ref_svc = JaxJoinService(
        latency=None if latency is None else JaxLatencyModel(**latency),
        **svc_kwargs)
    svc = JoinService(
        latency=None if latency is None else LatencyModel(**latency),
        device="cpu", **svc_kwargs)
    ref_rids, rids = [], []
    for k, ps in enumerate(pairsets):
        ref_crowd, crowd, extra = crowds(k)
        ref_rids.append(ref_svc.submit(ps, ref_crowd, **extra))
        rids.append(svc.submit(_both(ps)[1], crowd, **extra))
    ref, got = ref_svc.run(), svc.run()
    for r_ref, r_got in zip(ref_rids, rids):
        assert _fields(got[r_got]) == _fields(ref[r_ref]), f"rid {r_ref}"
    return [got[r] for r in rids]


def _noisy(seed0, **kw):
    kw.setdefault("qualification", False)
    return lambda k: (*_crowds(seed=seed0 + k, **kw), {})


@pytest.mark.parametrize("order", ["expected", "adaptive"])
@pytest.mark.parametrize("policy", ["drop", "requery"])
def test_noisy_round_barrier_conflicts_resolved(conflicting_pairsets,
                                                policy, order):
    """``tests/test_conflicts.py:296``: three noisy sessions through three
    lanes under both policies; rejected answers escalated (and the
    exhausted ones trusted to the graph) as the reference's."""
    pairsets = conflicting_pairsets()
    got = _serve_both(pairsets, _noisy(10, error_rate=0.35), lanes=3,
                      conflict_policy=policy, order=order)
    assert sum(r.n_conflicts for r in got) > 0
    for r, ps in zip(got, pairsets):
        assert r.n_crowdsourced + r.n_deduced == len(ps)
        assert transitively_consistent(_both(ps)[1], r.labels)
    if policy == "requery":
        assert sum(r.n_requeried for r in got) > 0
    else:
        assert all(r.n_requeried == 0 for r in got)


@pytest.mark.parametrize("policy", ["drop", "requery"])
def test_noisy_async_conflicts_resolved(conflicting_pairsets, policy):
    """``tests/test_conflicts.py:319``: async ID/NF on a latency-modelled
    crowd under both policies, ``sim_minutes`` equal as floats."""
    pairsets = conflicting_pairsets()
    got = _serve_both(pairsets, _noisy(20, error_rate=0.45), lanes=2,
                      latency=dict(n_workers=12, seed=3), async_mode=True,
                      nf=True, conflict_policy=policy)
    for r, ps in zip(got, pairsets):
        assert r.n_crowdsourced + r.n_deduced == len(ps)
        assert transitively_consistent(_both(ps)[1], r.labels)
        assert r.sim_minutes > 0
    assert sum(r.n_conflicts for r in got) > 0
    if policy == "requery":
        assert sum(r.n_requeried for r in got) > 0


def test_requery_round_barrier_on_a_latency_platform(conflicting_pairsets):
    """The barrier's drain-and-fold loop on the latency transport: each
    escalation pass runs the platform clock until its answers land."""
    pairsets = conflicting_pairsets(2, seed=4)
    got = _serve_both(pairsets, _noisy(30, error_rate=0.45), lanes=2,
                      latency=dict(n_workers=6, seed=1),
                      conflict_policy="requery")
    assert sum(r.n_requeried for r in got) > 0
    assert all(r.sim_minutes > 0 for r in got)


def test_fused_conflict_exit_hands_the_lane_to_step(monkeypatch):
    """A ``PerfectCrowd`` over self-contradicting truth under requery: the
    fused wave's screen fires, the lane leaves the fused path, and
    ``_step`` escalates its rejected answers (a one-vote crowd asked for 3
    assignments still casts one vote) until they are exhausted and trusted
    to the graph, as the reference does."""
    pairsets = make_session_pairsets(3, seed=5, n_objects=(20, 30),
                                     n_pairs=(80, 140))
    rng = np.random.default_rng(5)
    for ps in pairsets:
        ps.truth = rng.random(len(ps)) < 0.45
    steps = []
    step = JoinService._step
    monkeypatch.setattr(JoinService, "_step",
                        lambda self, *a: steps.append(1) or step(self, *a))
    got = _serve_both(pairsets,
                      lambda k: (JaxPerfectCrowd(), PerfectCrowd(), {}),
                      lanes=2, conflict_policy="requery")
    assert steps
    assert sum(r.n_conflicts for r in got) > 0
    assert sum(r.n_requeried for r in got) > 0


@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_requery_with_a_budget_async(conflicting_pairsets, order):
    """Requery and budgets together on the async discipline: an escalation
    the remaining budget cannot buy exhausts, and the lane stops on budget
    with nothing in flight."""
    pairsets = conflicting_pairsets(2, seed=2)

    def crowds(k):
        ref_c, c = _crowds(error_rate=0.4, qualification=False, seed=50 + k)
        return ref_c, c, dict(budget_cents=160.0, cost_per_assignment=1.3)

    got = _serve_both(pairsets, crowds, lanes=2, order=order,
                      latency=dict(n_workers=8, seed=4), async_mode=True,
                      nf=True, conflict_policy="requery")
    for r, ps in zip(got, pairsets):
        assert r.n_spent_cents <= 160.0
        assert transitively_consistent(_both(ps)[1], r.labels)
