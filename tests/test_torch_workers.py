"""EM worker reliability and cluster tasks (ROADMAP A9.8): the port's
``WorkerModel``, ``Crowd.ask_cluster`` / ``NoisyCrowd.ask_cluster``,
``CrowdGateway(aggregation="em")`` and ``post_cluster``, and
``JoinService(aggregation=, cluster_tasks=, cluster_size=,
cluster_assignments=)`` against the JAX package's, on the CPU, on the same
seeds.

Draws are compared draw for draw (labels, votes, workers, the crowd's next
rng draw), the worker model's estimates as floats with ``==``, and the
service's results field for field.  The reference's ballot labels are paper
strings, the port's engine codes: ``MATCH`` is ``POS``."""
import dataclasses

import numpy as np
import pytest

from repro.core import MATCH
from repro.core import CostModel as JaxCostModel
from repro.core import CrowdGateway as JaxGateway
from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import WorkerModel as JaxWorkerModel
from repro.core.pairs import PairSet as JaxPairSet
from repro.data.entities import make_paper_dataset
from repro.data.entities import make_session_pairsets
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN
from repro_torch.core.crowd import (CostModel, CrowdGateway, LatencyModel,
                                    NoisyCrowd, PerfectCrowd, WorkerModel)
from repro_torch.core.graph import make_session_state, session_fold_answers
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


def _code(label) -> int:
    return POS if label == MATCH else NEG


def _answers(got):
    return [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
            for a in got]


def _random_truth_pairs(m: int, seed: int):
    rng = np.random.default_rng(seed)
    u = np.arange(m, dtype=np.int32)
    truth = rng.random(m) < 0.5
    lik = np.linspace(0.9, 0.1, m).astype(np.float32)
    return _both(JaxPairSet(u, u + m, lik, truth, n_objects=2 * m))


def _cluster_world(seed: int, n_entities: int = 3):
    """One random world of entity-clustered objects and a random subset of
    their pairs (``tests/test_crowd.py``'s cluster-decode world)."""
    import itertools

    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 12))
    ent = rng.integers(0, n_entities, n)
    all_e = list(itertools.combinations(range(n), 2))
    m = int(rng.integers(3, min(20, len(all_e)) + 1))
    sel = rng.permutation(len(all_e))[:m]
    u = np.array([all_e[i][0] for i in sel], np.int32)
    v = np.array([all_e[i][1] for i in sel], np.int32)
    truth = ent[u] == ent[v]
    return _both(JaxPairSet(u, v, np.linspace(0.9, 0.1, m).astype(np.float32),
                            truth, n_objects=n))


# ---------------------------------------------------------------------------
# the worker model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_worker_model_matches_reference(seed):
    """``tests/test_crowd.py:164-190``: 400 ballots of a heterogeneous pool
    recorded online, then batch EM; every aggregated label, every estimate
    and the trusted-worker ranking equal the reference's, and the
    estimates recover the pool's error rates."""
    kw = dict(error_rate=0.2, n_assignments=3, qualification=False,
              seed=seed, n_workers=12, worker_concentration=3.0)
    ref_c, c = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
    ref_pairs, pairs = _random_truth_pairs(400, seed)
    ref_wm, wm = JaxWorkerModel(), WorkerModel()
    em_ok = maj_ok = 0
    for i in range(400):
        ref_b, b = ref_c.ask_ballot(ref_pairs, i), c.ask_ballot(pairs, i)
        assert (b.label, b.votes, b.workers) == \
            (_code(ref_b.label), ref_b.votes, ref_b.workers)
        label = wm.record(b.votes, b.workers)
        assert label == ref_wm.record(ref_b.votes, ref_b.workers)
        truth = POS if pairs.truth[i] else NEG
        em_ok += label == truth
        maj_ok += b.label == truth
    for w in range(12):
        assert wm.error_rate(w) == ref_wm.error_rate(w)
    wm.refit()
    ref_wm.refit()
    est = np.array([wm.error_rate(w) for w in range(12)])
    assert est.tolist() == [ref_wm.error_rate(w) for w in range(12)]
    assert wm.workers == ref_wm.workers
    assert [wm.n_votes(w) for w in range(12)] == \
        [ref_wm.n_votes(w) for w in range(12)]
    assert wm.best_workers(limit=5) == ref_wm.best_workers(limit=5)
    assert np.abs(est - c.worker_errors).mean() < 0.08
    assert em_ok >= maj_ok


def test_worker_model_uninformed_and_validation():
    """``tests/test_crowd.py:192-203``: with no history the weighted vote is
    the majority; an uninformative prior is refused."""
    wm = WorkerModel()
    assert wm.aggregate((POS, POS, NEG), (0, 1, 2)) == POS
    assert wm.aggregate((NEG, NEG, POS), (3, 4, 5)) == NEG
    assert wm.aggregate((POS, NEG), (6, 7)) == NEG  # a tie: NEG
    for prior in (0.5, 0.0, 0.7):
        with pytest.raises(ValueError, match="prior_error"):
            WorkerModel(prior_error=prior)
    with pytest.raises(ValueError, match="prior_error"):
        JaxWorkerModel(prior_error=0.5)


# ---------------------------------------------------------------------------
# cluster tasks on the crowds and the gateway
# ---------------------------------------------------------------------------
CLUSTER_CROWDS = {
    "homogeneous": dict(error_rate=0.3, seed=4),
    "pool": dict(error_rate=0.2, n_assignments=3, seed=7, n_workers=25,
                 worker_concentration=3.0, qualification=False),
    "small-pool": dict(error_rate=0.3, n_assignments=3, seed=2, n_workers=4),
}


@pytest.mark.parametrize("kind", sorted(CLUSTER_CROWDS))
def test_noisy_ask_cluster_draw_for_draw(kind):
    """``NoisyCrowd.ask_cluster`` over random worlds with preferred and
    excluded workers: verdicts, worker and the rng's next draw are the
    reference's."""
    ref_c = JaxNoisyCrowd(**CLUSTER_CROWDS[kind])
    c = NoisyCrowd(**CLUSTER_CROWDS[kind])
    rng = np.random.default_rng(1)
    for seed in range(12):
        ref_pairs, pairs = _cluster_world(seed)
        idx = list(range(len(pairs)))
        prefer = tuple(int(w) for w in rng.choice(30, 3, replace=False))
        exclude = tuple(int(w) for w in rng.choice(
            4, int(rng.integers(0, 3)), replace=False))
        assert c.ask_cluster(pairs, idx, prefer, exclude) == \
            ref_c.ask_cluster(ref_pairs, idx, prefer, exclude), seed
    assert c.n_asked == ref_c.n_asked
    assert c.rng.random() == ref_c.rng.random()


def test_perfect_ask_cluster_is_the_truth_partition():
    ref_pairs, pairs = _cluster_world(3)
    ref_c, c = JaxPerfectCrowd(), PerfectCrowd()
    idx = list(range(len(pairs)))
    assert c.ask_cluster(pairs, idx) == ref_c.ask_cluster(ref_pairs, idx)
    assert c.ask_cluster(pairs, idx[:2])[1] == 1  # a fresh worker each
    with pytest.raises(ValueError, match="ground truth"):
        c.ask_cluster(PairSet(pairs.u, pairs.v, pairs.likelihood), idx)


@pytest.mark.parametrize("seed", range(6))
def test_cluster_decode_matches_individual_pairs(seed):
    """``tests/test_crowd.py:312``: one cluster task and the same pairs
    posted one by one answer alike under a ``PerfectCrowd`` and fold to the
    same state; the gateway's answers and counters are the reference's."""
    ref_pairs, pairs = _cluster_world(seed)
    m = len(pairs)
    ref_gw, gw = JaxGateway(), CrowdGateway()
    ref_gw.post_cluster(0, ref_pairs, range(m), JaxPerfectCrowd(), cents=1.0,
                        n_assignments=2)
    gw.post_cluster(0, pairs, range(m), PerfectCrowd(), cents=1.0,
                    n_assignments=2)
    assert gw.in_flight == ref_gw.in_flight == 1
    cluster = gw.poll()
    assert _answers(cluster) == _answers(ref_gw.poll())
    singles = CrowdGateway()
    singles.post(0, pairs, range(m), PerfectCrowd())
    single = singles.poll()
    assert {(a.index, a.label) for a in cluster} == \
        {(a.index, a.label) for a in single}

    def fold(answers):
        state = make_session_state(pairs.u, pairs.v, pairs.n_objects,
                                   device="cpu")
        upd = np.full(m, UNKNOWN, np.int32)
        for a in answers:
            upd[a.index] = a.label
        state, _ = session_fold_answers(state, upd)
        return state.labels.numpy(), state.conflicts.numpy()

    for x, y in zip(fold(cluster), fold(single)):
        np.testing.assert_array_equal(x, y)
    assert gw.cluster_pairs(0) == ref_gw.cluster_pairs(0) == m
    assert (gw.n_posted, gw.n_cluster_tasks, gw.n_cluster_pairs,
            gw.spent_cents(0), gw.assignments_posted(0)) == \
        (ref_gw.n_posted, ref_gw.n_cluster_tasks, ref_gw.n_cluster_pairs,
         ref_gw.spent_cents(0), ref_gw.assignments_posted(0))


@pytest.mark.parametrize("aggregation", ["majority", "em"])
@pytest.mark.parametrize("transport", ["immediate", "random", "nf"])
def test_cluster_disagreement_escalates_to_pair_ballots(transport,
                                                        aggregation):
    """``tests/test_crowd.py:321`` on every transport, with and without EM:
    pair ballots first (EM's history picks the preferred partitioners),
    then cluster tasks whose disagreed verdicts escalate at once as pair
    ballots; answers, times, spend, assignments and counters are the
    reference's, and the crowd's next draw too."""
    kw = dict(error_rate=0.35, n_assignments=3, qualification=False,
              seed=2, n_workers=20)
    ref_c, c = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
    ref_pairs, pairs = _random_truth_pairs(24, seed=8)
    # chain pairs among 8 objects, the cluster tasks' worlds
    u = np.array([0, 1, 2, 3, 4, 5, 6, 0, 2, 4], np.int32)
    v = np.array([1, 2, 3, 4, 5, 6, 7, 7, 5, 7], np.int32)
    truth = np.array([1, 1, 0, 1, 1, 0, 1, 0, 0, 1], bool)
    lik = np.linspace(0.8, 0.2, 10).astype(np.float32)
    ref_w, w = _both(JaxPairSet(u, v, lik, truth, n_objects=8))
    lat = dict(n_workers=4, mean_minutes=10.0, sigma=0.7, seed=5)
    nf = transport == "nf"
    ref_gw = JaxGateway(
        latency=None if transport == "immediate" else JaxLatencyModel(**lat),
        nf=nf, aggregation=aggregation)
    gw = CrowdGateway(
        latency=None if transport == "immediate" else LatencyModel(**lat),
        nf=nf, aggregation=aggregation)
    ref_gw.post(0, ref_pairs, range(24), ref_c, cents_per_assignment=0.2)
    gw.post(0, pairs, range(24), c, cents_per_assignment=0.2)
    for rid in (1, 2, 3):
        ref_gw.post_cluster(rid, ref_w, range(10), ref_c, cents=2.0,
                            n_assignments=2, pair_cents_per_assignment=0.1)
        gw.post_cluster(rid, w, range(10), c, cents=2.0, n_assignments=2,
                        pair_cents_per_assignment=0.1)
        assert gw.in_flight == ref_gw.in_flight
    got = gw.drain()
    assert _answers(got) == _answers(ref_gw.drain())
    escalated = [a for a in got if a.rid and a.n_assignments == 3]
    assert escalated, "0.35-error partitions never disagreed"
    for rid in (0, 1, 2, 3):
        assert gw.spent_cents(rid) == ref_gw.spent_cents(rid)
        assert gw.assignments_posted(rid) == ref_gw.assignments_posted(rid)
        assert gw.cluster_pairs(rid) == ref_gw.cluster_pairs(rid)
        for i in range(10):
            assert gw.seen_workers(rid, i) == ref_gw.seen_workers(rid, i)
    assert (gw.n_posted, gw.n_answered, gw.n_votes, gw.n_minority_votes,
            gw.n_cluster_tasks, gw.n_cluster_pairs, gw.now_minutes) == \
        (ref_gw.n_posted, ref_gw.n_answered, ref_gw.n_votes,
         ref_gw.n_minority_votes, ref_gw.n_cluster_tasks,
         ref_gw.n_cluster_pairs, ref_gw.now_minutes)
    assert c.rng.random() == ref_c.rng.random()


@pytest.mark.parametrize("transport", ["immediate", "nf"])
def test_em_gateway_ballots_match_reference(transport):
    """``aggregation="em"``: every ballot's label is the worker model's at
    post time, in posting order, and minority votes count against it; a
    deterministic crowd's one-vote posts are recorded too."""
    kw = dict(error_rate=0.3, n_assignments=3, qualification=False,
              seed=11, n_workers=9, worker_concentration=3.0)
    ref_c, c = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
    ref_pairs, pairs = _random_truth_pairs(60, seed=3)
    lat = dict(n_workers=5, mean_minutes=10.0, sigma=0.7, seed=1)
    immediate = transport == "immediate"
    ref_gw = JaxGateway(
        latency=None if immediate else JaxLatencyModel(**lat),
        nf=not immediate, aggregation="em")
    gw = CrowdGateway(latency=None if immediate else LatencyModel(**lat),
                      nf=not immediate, aggregation="em")
    for rid, idx, perfect in ((0, range(30), False), (1, range(10), True),
                              (0, range(30, 60), False)):
        ref_gw.post(rid, ref_pairs, idx,
                    JaxPerfectCrowd() if perfect else ref_c,
                    cents_per_assignment=0.7)
        gw.post(rid, pairs, idx, PerfectCrowd() if perfect else c,
                cents_per_assignment=0.7)
    assert _answers(gw.drain()) == _answers(ref_gw.drain())
    assert (gw.n_votes, gw.n_minority_votes) == (ref_gw.n_votes,
                                                 ref_gw.n_minority_votes)
    assert gw.measured_disagreement == ref_gw.measured_disagreement
    wm, ref_wm = gw.worker_model, ref_gw.worker_model
    assert wm.workers == ref_wm.workers
    assert [wm.error_rate(x) for x in wm.workers] == \
        [ref_wm.error_rate(x) for x in ref_wm.workers]
    assert gw.spent_cents(0) == ref_gw.spent_cents(0)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
def _cluster_sessions():
    return make_session_pairsets(3, seed=21, n_objects=(25, 35),
                                 n_pairs=(120, 200), n_entities=4,
                                 likelihood=(0.7, 0.4, 0.25))


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


def _perfect(k):
    return JaxPerfectCrowd(), PerfectCrowd(), {}


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
def test_cluster_tasks_perfect_exact_and_cheaper(async_mode):
    """``tests/test_join_service.py:329``: mixed scheduling under a perfect
    crowd stays exact and spends less than pairs only, field for field the
    reference's (async on a latency platform, a cluster task one pickup)."""
    pairsets = _cluster_sessions()
    latency = dict(n_workers=6, seed=2) if async_mode else None
    kw = dict(async_mode=async_mode, nf=async_mode, latency=latency)
    pairs = _serve_both(pairsets, _perfect, lanes=2, **kw)
    mixed = _serve_both(pairsets, _perfect, lanes=2, cluster_tasks=True,
                        cluster_size=8, **kw)
    for r, ps in zip(mixed, pairsets):
        np.testing.assert_array_equal(r.labels, ps.truth)
    assert sum(r.n_cluster_tasks for r in mixed) > 0
    assert sum(r.n_cluster_pairs for r in mixed) > \
        sum(r.n_cluster_tasks for r in mixed)
    assert sum(r.n_cluster_cents for r in mixed) > 0
    assert all(r.n_cluster_tasks == r.n_cluster_pairs == 0 for r in pairs)
    assert sum(r.n_spent_cents for r in mixed) < \
        sum(r.n_spent_cents for r in pairs)


@pytest.mark.parametrize("cluster_assignments", [1, 2, 3])
def test_em_cluster_noisy_pool_quality_and_cost(cluster_assignments):
    """``tests/test_join_service.py:368``: EM plus cluster tasks over a
    heterogeneous pool against majority pairs only, field for field the
    reference's; consistent, no worse F, and cheaper."""
    pairsets = _cluster_sessions()

    def crowds(k):
        kw = dict(error_rate=0.15, n_assignments=3, seed=30 + k,
                  n_workers=25, worker_concentration=3.0,
                  qualification=False)
        return JaxNoisyCrowd(**kw), NoisyCrowd(**kw), {}

    majority = _serve_both(pairsets, crowds, lanes=2)
    mixed = _serve_both(pairsets, crowds, lanes=2, aggregation="em",
                        cluster_tasks=True,
                        cluster_assignments=cluster_assignments)
    for r, ps in zip(mixed, pairsets):
        assert r.n_crowdsourced + r.n_deduced == len(ps)
        assert transitively_consistent(_both(ps)[1], r.labels)
    if cluster_assignments == 2:
        assert np.mean([r.quality.f_measure for r in mixed]) >= \
            np.mean([r.quality.f_measure for r in majority])
        assert sum(r.n_spent_cents for r in mixed) < \
            sum(r.n_spent_cents for r in majority)


def test_cluster_tasks_with_budget_and_slots(conflicting_pairsets):
    """Cluster tasks compose with budgets (a task the remaining budget
    cannot buy is not planned) and the slot allocator."""
    pairsets = conflicting_pairsets(3, seed=6)

    def crowds(k):
        kw = dict(error_rate=0.2, n_assignments=3, seed=60 + k,
                  n_workers=20, qualification=False)
        return (JaxNoisyCrowd(**kw), NoisyCrowd(**kw),
                dict(budget_cents=[90.0, None, 40.0][k],
                     cost_per_assignment=1.1))

    got = _serve_both(pairsets, crowds, lanes=3, aggregation="em",
                      cluster_tasks=True, cluster_size=6,
                      slots_per_round=30, conflict_policy="requery")
    assert got[0].stopped_on_budget and got[2].stopped_on_budget
    assert got[0].n_spent_cents <= 90.0 and got[2].n_spent_cents <= 40.0
    assert sum(r.n_cluster_tasks for r in got) > 0


def test_cluster_tasks_disable_fused_path_cleanly(monkeypatch):
    """``tests/test_join_service.py:396``: with cluster tasks on, the fused
    path (``_drive_fused``) never runs, and the run is still exact; the
    default service on the same sessions does use it."""
    pairsets = _cluster_sessions()
    calls = []
    orig = JoinService._drive_fused
    monkeypatch.setattr(
        JoinService, "_drive_fused",
        lambda self, *a, **kw: calls.append(1) or orig(self, *a, **kw))
    got = _serve_both(pairsets, _perfect, lanes=2, cluster_tasks=True)
    assert not calls
    for r, ps in zip(got, pairsets):
        np.testing.assert_array_equal(r.labels, ps.truth)
    _serve_both(pairsets, _perfect, lanes=2)
    assert calls


BAD_OPTIONS = [
    (dict(cluster_size=2), "cluster_size"),
    (dict(cluster_assignments=0), "cluster_assignments"),
    (dict(aggregation="dawid"), "aggregation"),
    (dict(slots_per_round=0), "slots_per_round"),
    (dict(conflict_policy="retry"), "conflict_policy"),
]


@pytest.mark.parametrize("options,match", BAD_OPTIONS,
                         ids=[m for _, m in BAD_OPTIONS])
def test_constructor_validation_matches_reference(options, match):
    """``tests/test_join_service.py:412`` and the other ``ValueError``s of
    the reference's constructor, message for message."""
    with pytest.raises(ValueError, match=match) as ref:
        JaxJoinService(**options)
    with pytest.raises(ValueError, match=match) as got:
        JoinService(device="cpu", **options)
    assert str(got.value) == str(ref.value)
    if "aggregation" in options:
        with pytest.raises(ValueError, match="aggregation"):
            CrowdGateway(aggregation="dawid")


def test_cluster_task_price_matches_reference():
    ref, got = JaxCostModel(), CostModel()
    for n, rate in ((3, None), (5, 0.1), (8, 2.0), (13, 0.7)):
        assert got.cluster_task_cents(n, rate) == \
            ref.cluster_task_cents(n, rate)


@pytest.mark.parametrize("config", ["majority", "em", "mixed"])
def test_worker_quality_stage_matches_reference(config):
    """``benchmarks/noise_sweep.py::_worker_quality``'s three configs (one
    lane, the 30-worker pool, the HIT-amortized quantum price) on a 300-record
    paper dataset at 0.3: every field the reference's; mixed cheaper a
    resolved pair than majority."""
    ds = make_paper_dataset(seed=0, n_records=300)
    ref_pairs = ds.pairs.above(0.3)
    pairs = _both(ref_pairs)[1]
    cost = CostModel()
    quantum = cost.cents_per_assignment / cost.pairs_per_hit
    kw = dict(error_rate=0.1, n_assignments=3, seed=7, n_workers=30,
              worker_concentration=3.0, qualification=False)
    options = {"majority": {}, "em": {"aggregation": "em"},
               "mixed": {"aggregation": "em", "cluster_tasks": True,
                         "cluster_size": 8}}
    cpp = {}
    for name in dict.fromkeys(("majority", config)):
        ref_svc = JaxJoinService(lanes=1, **options[name])
        svc = JoinService(lanes=1, device="cpu", **options[name])
        extra = dict(cost_per_assignment=quantum,
                     total_true_matches=ds.total_true_matches)
        ref_rid = ref_svc.submit(ref_pairs, JaxNoisyCrowd(**kw), **extra)
        rid = svc.submit(pairs, NoisyCrowd(**kw), **extra)
        got = svc.run()[rid]
        assert _fields(got) == _fields(ref_svc.run()[ref_rid])
        cpp[name] = got.n_spent_cents / len(pairs)
    if config == "mixed":
        assert cpp["mixed"] < cpp["majority"]
