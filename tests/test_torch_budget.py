"""Budgets and the slot allocator (ROADMAP A9.3): the port's ``JoinService``
with ``budget_cents`` / ``cost_per_assignment`` (on the service, on
``submit`` and on ``submit_embeddings``) and ``slots_per_round`` against the
JAX package's, on the CPU, on the same seeded sessions.

Every ``JoinSessionResult`` field must be identical (the wall clock aside):
labels, counts and round sizes exactly, cents and ``sim_minutes`` equal as
floats.  The allocator ranks frontier pairs by f32 expected-deduction gains,
which must be the reference's bit for bit or the cut differs; the port
counterparts of ``tests/test_ordering.py:232``, ``:250``, ``:273`` and
``:290`` hold the reference's own assertions too."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import make_session_state_batch as jax_state_batch
from repro.core import pack_sessions as jax_pack_sessions
from repro.core import session_gains_batch as jax_gains_batch
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.crowd import LatencyModel, NoisyCrowd, PerfectCrowd
from repro_torch.core.graph import make_session_state_batch, pack_sessions
from repro_torch.core.metrics import transitively_consistent
from repro_torch.core.ordering import session_gains_batch
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


def _port_pairs(ps) -> PairSet:
    return PairSet(ps.u, ps.v, ps.likelihood, ps.truth, ps.n_objects)


def _serve_both(pairsets, crowds, latency=None, **svc_kwargs):
    """The same sessions through the reference's and the port's service;
    ``crowds(k)`` gives session k's (reference crowd, port crowd, submit
    options).  Asserts every field equal; returns the port's results in
    submission order."""
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
        rids.append(svc.submit(_port_pairs(ps), crowd, **extra))
    ref, got = ref_svc.run(), svc.run()
    for r_ref, r_got in zip(ref_rids, rids):
        assert _fields(got[r_got]) == _fields(ref[r_ref]), f"rid {r_ref}"
    return [got[r] for r in rids]


def _perfect(**extra):
    return lambda k: (JaxPerfectCrowd(), PerfectCrowd(), extra)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
def test_budget_capped_session_stops_within_budget(session_pairsets,
                                                   async_mode):
    """``tests/test_ordering.py:232`` under both disciplines: every session
    stops on budget within 8 cents at 2 cents an assignment, its labels
    transitively consistent, and every field the reference's."""
    pairsets = session_pairsets()
    got = _serve_both(pairsets,
                      _perfect(budget_cents=8.0, cost_per_assignment=2.0),
                      lanes=2, async_mode=async_mode)
    for r, ps in zip(got, pairsets):
        assert r.stopped_on_budget
        assert 0 < r.n_spent_cents <= 8.0
        assert r.n_crowdsourced <= 4
        assert transitively_consistent(_port_pairs(ps), r.labels)


@pytest.mark.parametrize("budget", [20.0, 60.0, 174.0, 216.0])
@pytest.mark.parametrize("seed", [2, 5])
def test_requery_escalations_respect_budget(conflicting_pairsets, seed,
                                            budget):
    """``tests/test_ordering.py:250``'s seed x budget grid: a budgeted
    session under ``conflict_policy="requery"`` never overspends on
    escalations (an unaffordable requery exhausts), as the reference's."""
    pairsets = conflicting_pairsets(2, seed=seed)
    kw = dict(error_rate=0.45, qualification=False)
    got = _serve_both(
        pairsets,
        lambda k: (JaxNoisyCrowd(seed=seed + k, **kw),
                   NoisyCrowd(seed=seed + k, **kw),
                   dict(budget_cents=budget, cost_per_assignment=2.0)),
        lanes=2, conflict_policy="requery")
    for r, ps in zip(got, pairsets):
        assert r.n_spent_cents <= budget
        assert transitively_consistent(_port_pairs(ps), r.labels)


def test_unlimited_budget_matches_unbudgeted_run(session_pairsets):
    """``tests/test_ordering.py:273``: service-level defaults of an
    unlimited budget give the unbudgeted labels and counts (through the
    per-round path, since a budgeted lane never fuses)."""
    pairsets = session_pairsets()
    base = _serve_both(pairsets, _perfect(), lanes=2)
    capped = _serve_both(pairsets, _perfect(), lanes=2, budget_cents=1e9,
                         cost_per_assignment=2.0)
    for a, b in zip(base, capped):
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.n_crowdsourced == b.n_crowdsourced
        assert a.round_sizes == b.round_sizes
        assert not b.stopped_on_budget
        assert b.n_spent_cents == 2.0 * b.n_crowdsourced


@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_slots_per_round_caps_round_sizes_globally(session_pairsets, order):
    """``tests/test_ordering.py:290``: a global cap of 4 questions a round
    across three lanes, allocated by gain (adaptive groups read the
    refreshed priorities back); labels the truth, every round at most 4."""
    pairsets = session_pairsets(seed=13)
    got = _serve_both(pairsets, _perfect(), lanes=3, slots_per_round=4,
                      order=order)
    for r, ps in zip(got, pairsets):
        np.testing.assert_array_equal(r.labels, ps.truth)
        assert all(s <= 4 for s in r.round_sizes)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_budgets_mid_run_match_reference(conflicting_pairsets, order,
                                         async_mode):
    """Budgets that bind after several rounds, one lane unbudgeted, a rate
    that is not exact in binary, under a noisy crowd and a slot cap on the
    barrier: the affordable cut (floor division of the remaining cents, the
    highest gains kept by a stable sort) and the stop are the reference's."""
    pairsets = conflicting_pairsets(3, seed=3)
    kw = dict(error_rate=0.3, qualification=False)
    budgets = [(220.0, 1.7), (None, 0.3), (55.0, 0.7)]

    def crowds(k):
        budget, rate = budgets[k]
        return (JaxNoisyCrowd(seed=40 + k, **kw),
                NoisyCrowd(seed=40 + k, **kw),
                dict(budget_cents=budget, cost_per_assignment=rate))

    extra = {} if async_mode else {"slots_per_round": 24}
    latency = dict(n_workers=5, seed=2) if async_mode else None
    got = _serve_both(pairsets, crowds, lanes=2, order=order,
                      async_mode=async_mode, nf=async_mode, latency=latency,
                      **extra)
    assert got[0].stopped_on_budget and got[2].stopped_on_budget
    assert not got[1].stopped_on_budget
    assert got[0].n_rounds > 1 and got[2].n_rounds > 1


def test_budget_on_submit_embeddings_matches_reference():
    """``submit_embeddings(budget_cents=, cost_per_assignment=)``: the
    machine phase (the reference's kernel in interpret mode), then a
    budgeted session, every field the reference's."""
    rng = np.random.default_rng(4)
    n_ent, tau = 12, 0.8
    cents = rng.normal(size=(n_ent, 16))
    ia = rng.integers(0, n_ent, 40)
    ib = rng.integers(0, n_ent, 35)
    ea = (cents[ia] + 0.15 * rng.normal(size=(40, 16))).astype(np.float32)
    eb = (cents[ib] + 0.15 * rng.normal(size=(35, 16))).astype(np.float32)

    def truth(r, c):
        return ia[r] == ib[c]

    opts = dict(budget_cents=9.0, cost_per_assignment=1.5)
    ref_svc = JaxJoinService(lanes=2)
    ref_rid = ref_svc.submit_embeddings(
        jnp.asarray(ea), jnp.asarray(eb), tau, make_host_mesh(1, 1),
        crowd=JaxPerfectCrowd(), truth_fn=truth, impl="interpret", **opts)
    svc = JoinService(lanes=2, device="cpu")
    rid = svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                                tau, crowd=PerfectCrowd(), truth_fn=truth,
                                **opts)
    assert svc.queue[0].budget_cents == 9.0
    got, ref = svc.run()[rid], ref_svc.run()[ref_rid]
    assert _fields(got) == _fields(ref)
    assert got.stopped_on_budget and got.n_spent_cents <= 9.0


def test_request_budget_overrides_the_service_default(session_pairsets):
    """Service defaults apply to requests that leave them unset; a request's
    own budget and rate win."""
    pairsets = session_pairsets(seed=21)

    def crowds(k):
        extra = {} if k == 0 else dict(budget_cents=4.0 * k,
                                       cost_per_assignment=1.0)
        return JaxPerfectCrowd(), PerfectCrowd(), extra

    got = _serve_both(pairsets, crowds, lanes=3, budget_cents=6.0,
                      cost_per_assignment=2.0)
    assert got[0].n_spent_cents <= 6.0 and got[0].stopped_on_budget
    assert got[1].n_spent_cents <= 4.0 and got[2].n_spent_cents <= 8.0


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_gains_match_reference_bitwise(session_pairsets, seed):
    """The allocator's ranking key: stacked f32 gains of fresh sessions,
    bit for bit the reference's."""
    sessions = [(ps.u, ps.v, ps.n_objects)
                for ps in session_pairsets(3, seed=seed)]
    priors = np.zeros((3, 64), np.float32)
    for b, ps in enumerate(session_pairsets(3, seed=seed)):
        priors[b, :len(ps)] = ps.likelihood
    U, V, labels0, _, n = pack_sessions(sessions, pair_capacity=64)
    got = session_gains_batch(
        make_session_state_batch(U, V, labels0, n, "cpu"), priors).numpy()
    rU, rV, rl0, _, rn = jax_pack_sessions(sessions, pair_capacity=64)
    want = np.asarray(jax_gains_batch(jax_state_batch(rU, rV, rl0, rn),
                                      jnp.asarray(priors)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
