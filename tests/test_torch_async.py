"""Asynchronous ID/NF serving (ROADMAP A9.2): the port's latency transport,
its stream and wall-clock simulators and its ``JoinService(latency=,
async_mode=, nf=)`` against the JAX package's, on the CPU, on the same
seeds.

The gateway's rng draws (worker picks, then each pick's lognormal latency)
and every crowd's draws are the reference's draw for draw, so answer times,
the platform clock and ``sim_minutes`` are compared as floats with ``==``,
not within a tolerance; labels, counts and ``round_sizes`` exactly.  The
reference's labels are paper strings (``MATCH`` / ``NON_MATCH``), the
port's engine codes (``POS`` / ``NEG``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import MATCH, NON_MATCH
from repro.core import CostModel as JaxCostModel
from repro.core import CrowdGateway as JaxGateway
from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import parallel as jpar
from repro.core.pairs import PairSet as JaxPairSet
from repro.core.sorting import get_order as jax_get_order
from repro.data.entities import load_dataset, make_session_pairsets
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core import parallel as tpar
from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.crowd import (CostModel, CrowdGateway, LatencyModel,
                                    NoisyCrowd, PerfectCrowd)
from repro_torch.core.metrics import transitively_consistent
from repro_torch.core.pairs import PairSet
from repro_torch.core.sorting import get_order
from repro_torch.serve.join_service import JoinService


def _code(label) -> int:
    return POS if label == MATCH else NEG


def _both(ps):
    """The reference's PairSet and the port's copy."""
    return ps, PairSet(ps.u, ps.v, ps.likelihood, ps.truth, ps.n_objects)


def _pairs(seed: int, p: int = 40):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 30, p)
    v = (u + 1 + rng.integers(0, 29, p)) % 30
    truth = rng.random(p) < 0.4
    lik = rng.random(p).astype(np.float32)
    return _both(JaxPairSet(u, v, lik, truth, 30))


def _answers(got):
    return [(a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
            for a in got]


# ---------------------------------------------------------------------------
# the latency transport
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nf", [False, True])
@pytest.mark.parametrize("crowd", ["perfect", "noisy-pool"])
def test_gateway_latency_mode_matches_reference(nf, crowd):
    """Posts from two requests, interleaved with polls, through a
    three-worker platform: every answer (index, label, completion time,
    votes, workers), the clock after every poll, ``in_flight``, the spend
    and the tallies are the reference's."""
    ref_pairs, pairs = _pairs(3, p=60)
    lat = dict(n_workers=3, mean_minutes=10.0, sigma=0.7, seed=5)
    ref_gw = JaxGateway(latency=JaxLatencyModel(**lat), nf=nf)
    gw = CrowdGateway(latency=LatencyModel(**lat), nf=nf)
    if crowd == "perfect":
        ref_c, c = JaxPerfectCrowd(), PerfectCrowd()
    else:
        kw = dict(error_rate=0.2, n_assignments=3, seed=2, n_workers=6)
        ref_c, c = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
    posts = [(0, range(0, 12)), (1, range(12, 20)), (0, [25, 21, 30]),
             (1, range(40, 60))]
    for rid, idx in posts:
        ref_gw.post(rid, ref_pairs, idx, ref_c, cents_per_assignment=2.0)
        gw.post(rid, pairs, idx, c, cents_per_assignment=2.0)
        assert gw.in_flight == ref_gw.in_flight
        for _ in range(4):
            ref_got, got = ref_gw.poll(), gw.poll()
            assert _answers(got) == [
                (a.rid, a.index, a.label, a.minutes, a.votes, a.workers)
                for a in ref_got]
            assert gw.now_minutes == ref_gw.now_minutes
            assert gw.in_flight == ref_gw.in_flight
    assert _answers(gw.drain()) == _answers(ref_gw.drain())
    assert gw.in_flight == ref_gw.in_flight == 0
    assert gw.now_minutes == ref_gw.now_minutes > 0.0
    for rid in (0, 1):
        assert gw.spent_cents(rid) == ref_gw.spent_cents(rid)
        assert gw.assignments_posted(rid) == ref_gw.assignments_posted(rid)
    assert (gw.n_posted, gw.n_answered, gw.n_votes, gw.n_minority_votes) == \
        (ref_gw.n_posted, ref_gw.n_answered, ref_gw.n_votes,
         ref_gw.n_minority_votes)
    assert gw.n_posted == gw.n_answered == 43
    assert gw._rng.random() == ref_gw._rng.random()


def test_gateway_latency_mode_worker_pool_and_clock():
    """The reference's own check (``tests/test_crowd.py``): two workers,
    five pairs, answers on a monotone clock, everything answered once."""
    gw = CrowdGateway(latency=LatencyModel(n_workers=2, mean_minutes=10.0,
                                           sigma=0.5, seed=1))
    _, pairs = _pairs(0, p=5)
    gw.post(0, pairs, range(5), PerfectCrowd())
    assert gw.in_flight == 5
    got, last = [], 0.0
    while gw.in_flight:
        answers = gw.poll()
        assert answers
        for a in answers:
            assert a.minutes >= last
            last = a.minutes
            got.append(a.index)
    assert sorted(got) == list(range(5)) and gw.now_minutes > 0.0
    assert gw.n_posted == gw.n_answered == 5 and gw.poll() == []


def test_gateway_nf_takes_lowest_likelihood_first():
    """With one worker, ``nf`` answers in ascending likelihood whatever
    the posting order, as the reference picks."""
    ref_pairs, pairs = _pairs(8, p=12)
    lat = dict(n_workers=1, mean_minutes=5.0, sigma=0.1, seed=2)
    ref_gw = JaxGateway(latency=JaxLatencyModel(**lat), nf=True)
    gw = CrowdGateway(latency=LatencyModel(**lat), nf=True)
    idx = [5, 0, 11, 3, 7, 1, 9, 2, 10, 4, 8, 6]
    ref_gw.post(0, ref_pairs, idx, JaxPerfectCrowd())
    gw.post(0, pairs, idx, PerfectCrowd())
    seen = [a.index for a in gw.drain()]
    assert seen == [a.index for a in ref_gw.drain()]
    assert seen == sorted(idx, key=lambda i: pairs.likelihood[i])


def test_nf_without_latency_is_refused():
    """As in the reference (``tests/test_conflicts.py``): ``nf`` steers
    pickup order, which immediate mode does not have."""
    with pytest.raises(ValueError, match="nf"):
        CrowdGateway(nf=True)
    with pytest.raises(ValueError, match="nf"):
        JoinService(nf=True, device="cpu")
    with pytest.raises(ValueError, match="worker pool"):
        CrowdGateway(latency=LatencyModel(n_workers=0))
    CrowdGateway(nf=True, latency=LatencyModel(n_workers=2))


# ---------------------------------------------------------------------------
# the simulators
# ---------------------------------------------------------------------------
def _dense_session(seed: int):
    """One session dense in confusable structure (the configuration of
    ``tests/conftest.py``'s conflicting sessions), so noisy answers
    conflict with transitivity."""
    return make_session_pairsets(1, seed=seed, n_objects=(25, 35),
                                 n_pairs=(120, 200), n_entities=4,
                                 likelihood=(0.7, 0.4, 0.25))[0]


@pytest.mark.parametrize("mode", ["parallel", "id", "id+nf"])
@pytest.mark.parametrize("noisy", [False, True])
def test_simulate_stream_matches_reference(mode, noisy):
    ref_ps, ps = _both(_dense_session(21))
    order = jax_get_order(ref_ps, "expected")
    np.testing.assert_array_equal(order, get_order(ps, "expected"))
    if noisy:
        kw = dict(error_rate=0.4, qualification=False, seed=6)
        ref_c, c = JaxNoisyCrowd(**kw), NoisyCrowd(**kw)
    else:
        ref_c, c = JaxPerfectCrowd(), PerfectCrowd()
    exp = jpar.simulate_stream(ref_ps, order, ref_c, mode=mode, seed=4)
    got = tpar.simulate_stream(ps, order, c, mode=mode, seed=4)
    assert got.labeled_count == exp.labeled_count
    assert got.available_count == exp.available_count
    for f in ("labels", "crowdsourced"):
        np.testing.assert_array_equal(getattr(got.result, f),
                                      getattr(exp.result, f))
    assert got.result.batch_sizes == exp.result.batch_sizes
    assert got.result.n_conflicts == exp.result.n_conflicts
    if not noisy:
        np.testing.assert_array_equal(got.result.labels, ps.truth)
    else:   # the noise shows in the labels, which stay consistent
        assert (got.result.labels != ps.truth).any()
        assert transitively_consistent(ps, got.result.labels)


def test_wallclock_simulators_match_reference():
    """Parallel(ID) on the product dataset at 0.4 (the reference's own
    check) and the sequential baseline over its HITs: hours, HITs, cost,
    labels and conflicts equal; the parallel platform finishes first."""
    ref_ds = load_dataset("product")
    ref_cand = ref_ds.pairs.above(0.4)
    _, cand = _both(ref_cand)
    order = jax_get_order(ref_cand, "expected")
    lat = dict(n_workers=20, seed=7)
    exp = jpar.simulate_wallclock_parallel_id(
        ref_cand, order, JaxPerfectCrowd(), JaxCostModel(),
        JaxLatencyModel(**lat), seed=7)
    got = tpar.simulate_wallclock_parallel_id(
        cand, order, PerfectCrowd(), CostModel(), LatencyModel(**lat),
        seed=7)
    assert got.hours == exp.hours
    assert (got.n_hits, got.n_pairs_crowdsourced, got.cost_cents,
            got.n_conflicts) == (exp.n_hits, exp.n_pairs_crowdsourced,
                                 exp.cost_cents, exp.n_conflicts)
    assert got.hits == exp.hits
    assert got.labels == {i: _code(l) for i, l in exp.labels.items()}
    assert len(got.labels) == len(cand)
    seq = tpar.simulate_wallclock_sequential(got.hits, CostModel(),
                                             LatencyModel(**lat), seed=7)
    assert seq == jpar.simulate_wallclock_sequential(
        exp.hits, JaxCostModel(), JaxLatencyModel(**lat), seed=7)
    assert got.hours < seq


def test_wallclock_under_a_noisy_crowd_matches_reference():
    ref_ps, ps = _both(_dense_session(5))
    order = jax_get_order(ref_ps, "expected")
    kw = dict(error_rate=0.4, qualification=False, seed=9)
    lat = dict(n_workers=4, mean_minutes=20.0, seed=1)
    exp = jpar.simulate_wallclock_parallel_id(
        ref_ps, order, JaxNoisyCrowd(**kw), JaxCostModel(),
        JaxLatencyModel(**lat), seed=2)
    got = tpar.simulate_wallclock_parallel_id(
        ps, order, NoisyCrowd(**kw), CostModel(), LatencyModel(**lat),
        seed=2)
    assert got.hours == exp.hours and got.hits == exp.hits
    assert got.labels == {i: _code(l) for i, l in exp.labels.items()}
    assert got.n_conflicts == exp.n_conflicts
    assert any((lab == POS) != ps.truth[i] for i, lab in got.labels.items())


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
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


def _serve(pairsets, crowds, **kw):
    """The same sessions through the reference's service and the port's
    (CPU) with the same options; returns both result lists, in order."""
    ref_crowds, port_crowds = crowds
    lat = kw.pop("latency", None)
    ref_svc = JaxJoinService(
        **kw, latency=None if lat is None else JaxLatencyModel(**lat))
    svc = JoinService(**kw, latency=None if lat is None
                      else LatencyModel(**lat), device="cpu")
    ref_rids = [ref_svc.submit(ps, c) for ps, c in zip(pairsets, ref_crowds)]
    rids = [svc.submit(_both(ps)[1], c)
            for ps, c in zip(pairsets, port_crowds)]
    ref, got = ref_svc.run(), svc.run()
    return [ref[r] for r in ref_rids], [got[r] for r in rids]


def _perfect(k):
    return [JaxPerfectCrowd() for _ in range(k)], \
        [PerfectCrowd() for _ in range(k)]


LATENCY = dict(n_workers=6, mean_minutes=30.0, sigma=1.0, seed=7)


@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_async_beats_round_barrier_as_reference(order):
    """The reference's Figure 16 check in serving (``tests/
    test_join_service.py``), held field for field: under one latency
    model, the barrier and the async ID/NF discipline give the reference's
    labels, counts, ``round_sizes`` and ``sim_minutes`` (floats, equal),
    the truth as labels, and async finishes in fewer simulated minutes."""
    pairsets = make_session_pairsets(4, seed=0, n_objects=(12, 24),
                                     n_pairs=(20, 60))
    out = {}
    for async_mode in (False, True):
        ref, got = _serve(pairsets, _perfect(4), lanes=2, order=order,
                          latency=dict(LATENCY), async_mode=async_mode,
                          nf=async_mode)
        for r, g, ps in zip(ref, got, pairsets):
            assert _fields(g) == _fields(r)
            np.testing.assert_array_equal(g.labels, ps.truth)
            assert g.sim_minutes > 0
        out[async_mode] = max(g.sim_minutes for g in got)
    assert out[True] < out[False], out


@pytest.mark.parametrize("nf", [False, True])
def test_async_under_a_noisy_crowd_matches_reference(conflicting_pairsets,
                                                     nf):
    """The reference's noisy async drop-policy case (``tests/
    test_conflicts.py``): transitively consistent labels, rejected answers
    counted, every field the reference's."""
    pairsets = conflicting_pairsets()
    kws = [dict(error_rate=0.45, qualification=False, seed=20 + k)
           for k in range(len(pairsets))]
    ref, got = _serve(pairsets, ([JaxNoisyCrowd(**kw) for kw in kws],
                                 [NoisyCrowd(**kw) for kw in kws]),
                      lanes=2, latency=dict(n_workers=12, seed=3),
                      async_mode=True, nf=nf)
    for r, g, ps in zip(ref, got, pairsets):
        assert _fields(g) == _fields(r)
        assert g.n_crowdsourced + g.n_deduced == len(ps)
        assert transitively_consistent(_both(ps)[1], g.labels)
        assert g.sim_minutes is not None and g.sim_minutes > 0
    assert sum(g.n_conflicts for g in got) > 0


def test_round_barrier_under_a_noisy_crowd_and_latency_matches_reference(
        conflicting_pairsets):
    pairsets = conflicting_pairsets()
    kws = [dict(error_rate=0.35, qualification=False, seed=10 + k)
           for k in range(len(pairsets))]
    ref, got = _serve(pairsets, ([JaxNoisyCrowd(**kw) for kw in kws],
                                 [NoisyCrowd(**kw) for kw in kws]),
                      lanes=3, latency=dict(n_workers=5, seed=1))
    for r, g in zip(ref, got):
        assert _fields(g) == _fields(r)
    assert sum(g.n_conflicts for g in got) > 0


def _service_sessions(n_sessions: int, seed: int):
    """``tests/test_round_engine.py``'s sessions: random pairs, a truth from
    a random partition, descending likelihoods."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sessions):
        n = int(rng.integers(6, 12))
        p = int(rng.integers(6, 18))
        u = rng.integers(0, n, p).astype(np.int32)
        v = ((u + 1 + rng.integers(0, n - 1, p)) % n).astype(np.int32)
        cluster = rng.integers(0, max(2, n // 3), n)
        out.append(JaxPairSet(u=u, v=v, n_objects=n,
                              likelihood=np.linspace(0.9, 0.1, p),
                              truth=cluster[u] == cluster[v]))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_async_mode_on_an_immediate_gateway_matches_reference(order, fused):
    """``async_mode`` without a latency model (the ``async_mode`` cases of
    ``tests/test_round_engine.py``): with nothing in flight the loop takes
    the fused drive, and with ``fused_rounds=False`` the event loop; both
    give the reference's fields, and the two give the same labels,
    crowdsourced pairs, round sizes, conflicts and spend."""
    pairsets = _service_sessions(3, seed=7)
    ref, got = _serve(pairsets, _perfect(3), lanes=2, order=order,
                      async_mode=True, fused_rounds=fused)
    for r, g, ps in zip(ref, got, pairsets):
        assert _fields(g) == _fields(r)
        assert g.sim_minutes is None
        np.testing.assert_array_equal(g.labels, ps.truth)
    _, other = _serve(pairsets, _perfect(3), lanes=2, order=order,
                      async_mode=True, fused_rounds=not fused)
    for a, b in zip(got, other):
        np.testing.assert_array_equal(a.labels, b.labels)
        assert (a.n_crowdsourced, a.round_sizes, a.n_conflicts,
                a.n_spent_cents) == (b.n_crowdsourced, b.round_sizes,
                                     b.n_conflicts, b.n_spent_cents)


def test_core_reexports_the_reference_names():
    """``repro_torch.core`` re-exports what is ported under the names of
    ``repro.core``, the engine labelers as ``label_parallel_torch(_batch)``;
    what it leaves out is what is not ported (or, for the paper's label
    strings, has no counterpart in the port's engine codes)."""
    import repro.core as jcore
    import repro_torch.core as tcore

    renamed = {"label_parallel_torch": "label_parallel_jax",
               "label_parallel_torch_batch": "label_parallel_jax_batch"}
    names = {renamed.get(n, n) for n in tcore.__all__}
    assert len(names) == len(tcore.__all__) and names <= set(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None
    assert set(jcore.__all__) - names == {
        "MATCH", "NON_MATCH", "engine_dispatches"}
    assert tcore.LatencyModel is LatencyModel
    assert tcore.simulate_stream is tpar.simulate_stream
